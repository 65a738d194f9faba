"""mcpt_tpu_torch/scene/parser.py (with ior_lut, medium_lut, spectrum,
hosek and sun_sky) against the reference's modules of the same names.

Every XML, mesh and image is written here (the reference's own tests
read scene files this container does not hold).  Each document parses in
both packages, and the port's RendererConfig must EQUAL
`to_torch_config(reference config)` field for field: numpy arrays exactly
(both parsers are the same numpy code on the host), the texture builder's
infos and atlas, enum members by name and value.  The documents together
reach every reader: camera transforms in document order, every
integrator, every BSDF with named IORs, checkerboard and bitmap textures
with uv transforms, named and HG media, every shape kind, every emitter
(area, point, spot, directional, sun, sky, sunsky, envmaps from EXR, HDR
and PNG, constant), `<default>` substitution and the mcpt.* tier.

The sun/sky functions are held equal on their own inputs.  The Cornell
scene file chip_smoke.py renders on the card is compiled by both
packages (every leaf equal, as tests/test_torch_scene.py compares them)
and rendered at 16x16 with direct light only (depth 2), per pixel at
rtol 1e-4, atol 1e-5 on 99% of pixels, tests/test_torch_render.py's rule
for the Cornell box's seams.
"""

import dataclasses
import textwrap

import numpy as np
import pytest

import chip_smoke
import mcpt_tpu.scene.hosek as jhosek
import mcpt_tpu.scene.ior_lut as jior
import mcpt_tpu.scene.medium_lut as jmed
import mcpt_tpu.scene.spectrum as jspec
import mcpt_tpu.scene.sun_sky as jsun
import mcpt_tpu_torch.scene.hosek as thosek
import mcpt_tpu_torch.scene.ior_lut as tior
import mcpt_tpu_torch.scene.medium_lut as tmed
import mcpt_tpu_torch.scene.spectrum as tspec
import mcpt_tpu_torch.scene.sun_sky as tsun
from mcpt_tpu.render.renderer import Renderer as JaxRenderer
from mcpt_tpu.scene.compile import compile_scene as jax_compile_scene
from mcpt_tpu.scene.parser import load_config as jax_load_config
from mcpt_tpu.scene.parser import load_config_string as jax_load_string
from mcpt_tpu.utils.image import write_exr, write_png
from mcpt_tpu_torch.models.texture import TextureBuilder
from mcpt_tpu_torch.render.renderer import Renderer
from mcpt_tpu_torch.scene.compile import compile_scene
from mcpt_tpu_torch.scene.parser import load_config, load_config_string
from tests.test_torch_image import write_hdr
from tests.test_torch_loaders import _ply_binary, write_obj, write_serialized
from tests.test_torch_scene import (KC_ATOL, STATIC_FACTS, jax_scene_arrays,
                                    reference_leaf, to_torch_config,
                                    torch_scene_arrays)


def isolate_env(monkeypatch, cfg):
    """The perf tier becomes MCPT_* variables of the process when a
    Renderer commits `cfg`: register each with monkeypatch so that the
    test's end restores it."""
    for key in cfg.perf:
        name = "MCPT_" + key.upper().replace(".", "_")
        monkeypatch.setenv(name, "")
        monkeypatch.delenv(name)


def assert_same(got, want, path="config"):
    """Field-for-field equality of a port object and a converted one."""
    assert type(got).__name__ == type(want).__name__, path
    if dataclasses.is_dataclass(got):
        for f in dataclasses.fields(got):
            assert_same(getattr(got, f.name), getattr(want, f.name),
                        f"{path}.{f.name}")
    elif isinstance(got, TextureBuilder):
        assert got.atlas_size == want.atlas_size, path
        assert len(got.infos) == len(want.infos), path
        for i, (a, b) in enumerate(zip(got.infos, want.infos)):
            assert sorted(a) == sorted(b), f"{path}.infos[{i}]"
            for k in a:
                assert_same(a[k], b[k], f"{path}.infos[{i}].{k}")
        for i, (a, b) in enumerate(zip(got.atlas_parts, want.atlas_parts)):
            assert_same(a, b, f"{path}.atlas_parts[{i}]")
    elif isinstance(got, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same(a, b, f"{path}[{i}]")
    elif isinstance(got, dict):
        assert sorted(got) == sorted(want), path
        for k in got:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(got, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif hasattr(got, "value") and hasattr(got, "name"):  # enum members
        assert (got.name, int(got)) == (want.name, int(want)), path
    else:
        assert got == want, path


def assert_parses_alike(got, ref):
    assert_same(got, to_torch_config(ref))


# ---------------------------------------------------------------- assets


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """Every file the documents name: meshes in each format, bitmaps in
    PNG, EXR and HDR, and envmaps of each."""
    d = tmp_path_factory.mktemp("assets")
    write_obj(d / "mesh.obj")
    _ply_binary(d / "quad.ply")
    rng = np.random.default_rng(9)
    write_serialized(d / "two.serialized", [
        (rng.normal(size=(4, 3)), [[0, 1, 2], [0, 2, 3]], None, None, False),
        (rng.normal(size=(3, 3)), [[0, 1, 2]], rng.normal(size=(3, 3)),
         rng.uniform(size=(3, 2)), False)])
    import json

    from tests.test_loaders import _gltf_dict

    g, _ = _gltf_dict("data:application/octet-stream;base64,{b64}")
    (d / "quad.gltf").write_text(json.dumps(g))
    img = rng.uniform(size=(6, 10, 3)).astype(np.float32)
    write_png(str(d / "tex.png"), img)
    write_exr(str(d / "tex.exr"), img * 3)
    rgbe = rng.integers(0, 256, size=(8, 16, 4), dtype=np.uint8)
    rgbe[..., 3] = 130
    write_hdr(d / "env.hdr", rgbe)
    # wider than the camera needs: the parser averages it down 2x
    write_exr(str(d / "env.exr"),
              rng.uniform(size=(96, 512, 3)).astype(np.float32) * 4)
    write_png(str(d / "env.png"), rng.uniform(size=(16, 32, 3)))
    return d


def parse_both(xml, directory):
    xml = textwrap.dedent(xml)
    path = directory / "scene.xml"
    path.write_text(xml)
    got, ref = load_config(str(path)), jax_load_config(str(path))
    assert_parses_alike(got, ref)
    # the string entry point too
    assert_same(load_config_string(xml, str(directory)), got)
    return got


SENSOR = """
<sensor type="perspective">
  <float name="fov" value="35"/>
  <transform name="toWorld"><lookat origin="0, 2, 8" target="0, 1, 0" up="0, 1, 0"/></transform>
  <sampler type="independent"><integer name="sampleCount" value="4"/></sampler>
  <film type="hdrfilm"><integer name="width" value="24"/><integer name="height" value="16"/></film>
</sensor>
"""

DOCUMENTS = {
    "camera-x-transforms": """
        <scene version="0.6.0">
          <sensor type="perspective">
            <string name="fovAxis" value="x"/><float name="fov" value="45"/>
            <transform name="toWorld">
              <scale x="2" y="1"/><rotate y="1" angle="30"/>
              <rotate x="1" z="1" angle="-12.5"/><translate value="1 2 3"/>
              <matrix value="1 0 0 0.5  0 1 0 0  0 0 1 -0.25  0 0 0 1"/>
              <matrix value="0 -1 0 1 0 0 0 0 1"/><scale value="1.5"/>
              <lookAt origin="1, 2, 3" target="0, 0, 0" up="0, 0, 1"/>
              <skew value="1"/>
            </transform>
            <sampler type="independent"><integer name="sample_count" value="3"/></sampler>
            <film type="hdrfilm"><integer name="width" value="40"/><integer name="height" value="30"/></film>
          </sensor>
        </scene>""",
    "camera-y-focal": """
        <scene version="0.6.0">
          <sensor type="perspective">
            <string name="fovAxis" value="y"/><string name="focalLength" value="35mm"/>
            <film type="hdrfilm"><integer name="width" value="64"/><integer name="height" value="48"/></film>
          </sensor>
        </scene>""",
    "camera-smaller": """
        <scene version="0.6.0">
          <sensor type="perspective"><string name="fovAxis" value="smaller"/>
            <float name="fov" value="30"/>
            <transform name="toWorld"><lookat origin="0 0 5" target="0 0 0"/></transform>
          </sensor>
        </scene>""",
    "integrator-path": """
        <scene version="0.6.0"><integrator type="path">
          <integer name="maxDepth" value="-1"/><integer name="rr_depth" value="3"/>
          <boolean name="hideEmitters" value="true"/><float name="rrPdf" value="0.8"/>
        </integrator></scene>""",
    "integrator-volpath": """
        <scene version="0.6.0"><integrator type="volpath">
          <integer name="max_depth" value="12"/></integrator></scene>""",
    "integrator-volpath-simple": """
        <scene version="0.6.0"><integrator type="volpath_simple">
          <integer name="maxDepth" value="5"/></integrator></scene>""",
    "integrator-bdpt": """
        <scene version="0.6.0"><integrator type="bdpt">
          <integer name="maxDepth" value="6"/></integrator></scene>""",
    "integrator-unknown": """
        <scene version="0.6.0"><integrator type="mlt"/></scene>""",
    "defaults-and-perf": """
        <scene version="0.6.0">
          <default name="spp" value="9"/><default name="res" value="20"/>
          <default name="depth" value="7"/><default name="albedo" value="0.3, 0.4, 0.5"/>
          <default name="mcpt.march_block" value="64"/>
          <default name="mcpt.traversal" value="pairs"/>
          <sensor type="perspective"><float name="fov" value="40"/>
            <sampler type="independent"><integer name="sampleCount" value="$spp"/></sampler>
            <film type="hdrfilm"><integer name="width" value="$res"/><integer name="height" value="$res"/></film>
          </sensor>
          <integrator type="path"><integer name="maxDepth" value="$depth"/></integrator>
          <bsdf type="diffuse" id="d"><rgb name="reflectance" value="$albedo"/></bsdf>
        </scene>""",
    "textures": """
        <scene version="0.6.0">
          <texture type="checkerboard" id="c1">
            <rgb name="color0" value="0.9, 0.1, 0.1"/><rgb name="color1" value="0.05"/>
            <float name="uscale" value="4"/><float name="vscale" value="2"/>
            <float name="uoffset" value="0.25"/><float name="voffset" value="0.5"/>
          </texture>
          <texture type="checkerboard" id="c2">
            <transform name="to_uv"><scale x="8" y="6"/><translate x="0.5" y="0.25"/></transform>
          </texture>
          <texture type="bitmap" id="png"><string name="filename" value="tex.png"/>
            <float name="gamma" value="2.0"/><transform name="uv"><scale value="3"/></transform>
          </texture>
          <texture type="bitmap" id="exr"><string name="filename" value="tex.exr"/></texture>
          <texture type="bitmap" id="hdr"><string name="filename" value="env.hdr"/></texture>
          <bsdf type="diffuse" id="a"><ref name="reflectance" id="c1"/></bsdf>
          <bsdf type="diffuse" id="b"><ref name="reflectance" id="png"/></bsdf>
          <bsdf type="diffuse" id="c"><texture type="bitmap" name="reflectance">
            <string name="filename" value="missing.png"/></texture></bsdf>
          <bsdf type="diffuse" id="e"><spectrum name="reflectance" value="0.2 0.3 0.4"/></bsdf>
          <bsdf type="diffuse" id="f"><float name="reflectance" value="0.7"/></bsdf>
          <bsdf type="diffuse" id="g"><scale name="reflectance"><float name="scale" value="2"/>
            <texture type="checkerboard"><rgb name="color0" value="0.1"/></texture></scale></bsdf>
        </scene>""",
    "bsdfs": """
        <scene version="0.6.0">
          <bsdf type="diffuse" id="plain"/>
          <bsdf type="roughdiffuse" id="oren"><float name="alpha" value="0.4"/>
            <boolean name="useFastApprox" value="true"/><rgb name="reflectance" value="0.5 0.4 0.3"/></bsdf>
          <bsdf type="dielectric" id="glass"><string name="intIOR" value="bk7"/>
            <string name="extIOR" value="water"/></bsdf>
          <bsdf type="roughdielectric" id="rglass"><float name="int_ior" value="1.33"/>
            <float name="alpha_u" value="0.1"/><float name="alpha_v" value="0.3"/>
            <string name="distribution" value="beckmann"/>
            <rgb name="specularTransmittance" value="0.9"/></bsdf>
          <bsdf type="roughdielectric" id="rglass2"><float name="alpha" value="0.2"/>
            <string name="intIOR" value="no such glass"/></bsdf>
          <bsdf type="thindielectric" id="pane"><string name="intIOR" value="acrylic glass"/></bsdf>
          <bsdf type="conductor" id="cu"/>
          <bsdf type="conductor" id="au"><string name="material" value="Au"/></bsdf>
          <bsdf type="roughconductor" id="al"><string name="material" value="Al"/>
            <float name="alpha" value="0.15"/><string name="distribution" value="phong"/></bsdf>
          <bsdf type="roughconductor" id="aniso"><rgb name="eta" value="0.2, 0.9, 1.1"/>
            <rgb name="k" value="3.9, 2.4, 2.2"/><float name="alphaU" value="0.05"/>
            <float name="alphaV" value="0.4"/><rgb name="specularReflectance" value="0.8"/></bsdf>
          <bsdf type="roughconductor" id="bogus"><string name="material" value="Unobtainium"/></bsdf>
          <bsdf type="clearcoatedconductor" id="coat"><string name="material" value="Cr"/>
            <float name="clearCoat" value="0.5"/><float name="coatAlpha" value="0.03"/>
            <float name="alpha" value="0.3"/></bsdf>
          <bsdf type="plastic" id="pl"><string name="intIOR" value="polypropylene"/>
            <rgb name="diffuseReflectance" value="0.1 0.2 0.6"/></bsdf>
          <bsdf type="roughplastic" id="rpl"><float name="alpha" value="0.25"/>
            <float name="intIOR" value="1.6"/><float name="extIOR" value="1.1"/></bsdf>
          <bsdf type="twosided" id="two"><bsdf type="diffuse"><rgb name="reflectance" value="0.3"/></bsdf></bsdf>
          <bsdf type="bumpmap" id="bump"><texture type="bitmap"><string name="filename" value="tex.png"/></texture>
            <bsdf type="twosided"><bsdf type="roughplastic"/></bsdf></bsdf>
          <bsdf type="mask" id="mask"><float name="opacity" value="0.4"/>
            <bsdf type="bumpmap"><texture type="checkerboard"/><bsdf type="conductor"/></bsdf></bsdf>
          <bsdf type="null" id="boundary"/>
          <bsdf type="hair" id="unknown"/>
        </scene>""",
    "media-and-shapes": """
        <scene version="0.6.0">
          <bsdf type="diffuse" id="white"/>
          <bsdf type="null" id="shell"/>
          <medium type="homogeneous" id="fog">
            <rgb name="sigma_t" value="0.5, 0.6, 0.7"/><rgb name="albedo" value="0.9"/>
            <float name="scale" value="2"/><phase type="hg"><float name="g" value="-0.4"/></phase>
          </medium>
          <medium type="homogeneous" id="smoke">
            <rgb name="sigmaA" value="0.1 0.2 0.3"/><rgb name="sigmaS" value="0.4"/>
            <phase type="rayleigh"/>
          </medium>
          <medium type="homogeneous" id="milk"><string name="material" value="Regular Milk"/>
            <float name="scale" value="0.01"/></medium>
          <medium type="homogeneous" id="skin"/>
          <medium type="homogeneous" id="ketchup"><string name="material" value="ketchup"/></medium>
          <shape type="cube" id="box"><transform name="toWorld"><scale value="0.5"/></transform>
            <ref id="shell"/><ref name="interior" id="fog"/></shape>
          <shape type="rectangle"><boolean name="flipNormals" value="true"/><ref id="white"/>
            <ref name="exterior" id="smoke"/></shape>
          <shape type="disk"><transform name="toWorld"><rotate x="1" angle="90"/></transform>
            <bsdf type="roughconductor"/></shape>
          <shape type="sphere"><float name="radius" value="0.3"/><point name="center" x="1" y="2" z="3"/>
            <ref id="white"/><medium type="homogeneous" name="interior" id="inline">
              <rgb name="sigma_t" value="1"/><rgb name="albedo" value="0.5"/></medium></shape>
          <shape type="sphere"><ref id="white"/><ref name="interior" id="milk"/>
            <ref name="exterior" id="skin"/></shape>
          <shape type="cylinder"><float name="radius" value="0.2"/><point name="p0" value="0 0 0"/>
            <point name="p1" value="0 2 0"/><ref id="white"/></shape>
          <shape type="obj"><string name="filename" value="mesh.obj"/>
            <boolean name="flipTexCoords" value="false"/><ref id="white"/></shape>
          <shape type="obj"><string name="filename" value="mesh.obj"/>
            <boolean name="faceNormals" value="true"/><ref id="white"/></shape>
          <shape type="ply"><string name="filename" value="quad.ply"/>
            <transform name="toWorld"><translate x="1"/></transform><ref id="white"/>
            <ref name="interior" id="ketchup"/></shape>
          <shape type="serialized"><string name="filename" value="two.serialized"/>
            <integer name="shapeIndex" value="1"/><ref id="white"/></shape>
          <shape type="serialized"><string name="filename" value="two.serialized"/><ref id="white"/></shape>
          <shape type="gltf"><string name="filename" value="quad.gltf"/><ref id="white"/></shape>
          <shape type="obj" id="gone"><string name="filename" value="absent.obj"/></shape>
          <shape type="hair"><ref id="white"/></shape>
          <shape type="rectangle" id="lamp"><emitter type="area">
            <rgb name="radiance" value="5, 4, 3"/></emitter></shape>
          <shape type="cube"><ref id="lamp"/></shape>
          <shape type="cube"/>
        </scene>""",
    "emitters": """
        <scene version="0.6.0">""" + SENSOR + """
          <texture type="bitmap" id="gobo"><string name="filename" value="tex.png"/></texture>
          <emitter type="area"/>
          <emitter type="point"><point name="position" value="1 2 3"/>
            <rgb name="intensity" value="10, 8, 6"/></emitter>
          <emitter type="point"><transform name="toWorld"><translate y="4"/></transform></emitter>
          <emitter type="spot"><transform name="toWorld"><lookat origin="0 4 0" target="0 0 0" up="1 0 0"/></transform>
            <rgb name="intensity" value="50"/><float name="cutoffAngle" value="30"/></emitter>
          <emitter type="spot"><float name="cutoff_angle" value="25"/><float name="beamWidth" value="10"/>
            <texture type="bitmap"><string name="filename" value="tex.png"/></texture></emitter>
          <emitter type="directional"><vector name="direction" value="0.2 -1 0.1"/>
            <rgb name="irradiance" value="3, 3, 2"/></emitter>
          <emitter type="directional"><vector name="direction" x="1" y="-1"/>
            <rgb name="radiance" value="1.5"/></emitter>
          <emitter type="constant"><rgb name="radiance" value="0.25, 0.3, 0.4"/></emitter>
          <emitter type="envmap"><string name="filename" value="env.exr"/>
            <float name="scale" value="2"/>
            <transform name="toWorld"><rotate y="1" angle="45"/></transform></emitter>
          <emitter type="envmap"><string name="filename" value="env.hdr"/></emitter>
          <emitter type="envmap"><string name="filename" value="env.png"/></emitter>
          <emitter type="sun"><vector name="sunDirection" x="0.2" y="0.8" z="0.1"/>
            <float name="turbidity" value="12"/><integer name="resolution" value="64"/>
            <float name="sunScale" value="0.5"/><float name="sunRadiusScale" value="4"/></emitter>
          <emitter type="sky"><integer name="year" value="2021"/><integer name="month" value="12"/>
            <integer name="day" value="21"/><float name="hour" value="9.5"/>
            <float name="minute" value="20"/><float name="latitude" value="-33.9"/>
            <float name="longitude" value="18.4"/><float name="timezone" value="2"/>
            <float name="turbidity" value="5.5"/><rgb name="albedo" value="0.1, 0.2, 0.3"/>
            <float name="stretch" value="3"/><float name="skyScale" value="2"/>
            <integer name="resolution" value="48"/></emitter>
          <emitter type="sunsky"><float name="hour" value="17"/>
            <boolean name="extend" value="false"/><integer name="resolution" value="32"/></emitter>
          <emitter type="sunsky"><vector name="sun_direction" value="0 1 1"/>
            <float name="turbidity" value="0.5"/><integer name="resolution" value="40"/></emitter>
          <emitter type="laser"/>
        </scene>""",
}


@pytest.mark.parametrize("name", sorted(DOCUMENTS))
def test_document_parses_as_the_reference(name, assets):
    cfg = parse_both(DOCUMENTS[name], assets)
    if name == "defaults-and-perf":
        assert cfg.perf == {"march_block": "64", "traversal": "pairs"}
        assert (cfg.camera.spp, cfg.camera.width, cfg.integrator.depth_max) == (9, 20, 7)
    if name == "media-and-shapes":
        kinds = [i.shape for i in cfg.instances]
        assert kinds.count("mesh") == 6 and "cylinder" in kinds and "disk" in kinds
        assert len(cfg.media) == 6
    if name == "emitters":
        assert len(cfg.emitters) == 16


def test_chip_scenes_parse_as_the_reference(tmp_path):
    """The two scene files chip_smoke.py renders on the card (the Cornell
    box with an OBJ, the matpreview scene with a 61,440-triangle binary
    PLY, an EXR bitmap and a sunsky), small: the same files at 32x32."""
    for write in (chip_smoke.write_cornell_scene,
                  chip_smoke.write_matpreview_scene):
        xml = write(str(tmp_path / write.__name__), res=32, spp=2)
        got = load_config(xml)
        assert_parses_alike(got, jax_load_config(xml))
        assert got.camera.width == 32 and got.camera.spp == 2


def test_unknown_default_and_sensor_raise():
    for parse in (load_config_string, jax_load_string):
        with pytest.raises(KeyError, match="nodef"):
            parse('<scene><integrator type="path"><integer name="maxDepth" '
                  'value="$nodef"/></integrator></scene>')
        with pytest.raises(ValueError, match="perspective"):
            parse('<scene><sensor type="orthographic"/></scene>')


def test_lookup_tables_equal():
    assert tior.DIELECTRIC_IOR == jior.DIELECTRIC_IOR
    assert tior.CONDUCTOR_IOR == jior.CONDUCTOR_IOR
    assert tmed.ISOTROPIC_MEDIA == jmed.ISOTROPIC_MEDIA
    assert tmed.ANISOTROPIC_MEDIA == jmed.ANISOTROPIC_MEDIA


# ---------------------------------------------------------------- sun and sky


@pytest.mark.parametrize("when", [
    (2010, 7, 10, 12, 0, 0, 35.69, 139.69, 9),
    (2010, 7, 10, 0, 0, 0, 35.69, 139.69, 9),
    (1999, 1, 31, 17, 45, 30, -41.3, 174.8, 13),
    (2024, 3, 20, 6, 5, 0, 0.0, 0.0, 0),
])
def test_sun_direction_from_time_equal(when):
    got = tsun.sun_direction_from_time(*when)
    want = jsun.sun_direction_from_time(*when)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(np.linalg.norm(got), 1.0, rtol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(turbidity=3.0, albedo=0.15),
    dict(turbidity=7.3, albedo=[0.1, 0.5, 0.9], stretch=1.5, extend=False),
    dict(turbidity=10.0, albedo=0.3, width=40, height=20, radiance_scale=2.0),
])
def test_sky_bitmap_equal(kw):
    for d in ([0.3, -0.8, 0.2], [0.0, -0.1, -1.0]):
        kw2 = dict(width=64, height=32)
        kw2.update(kw)
        got = thosek.sky_bitmap(np.array(d), **kw2)
        want = jhosek.sky_bitmap(np.array(d), **kw2)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        assert got.max() > 0


def test_sun_radiance_and_spectrum_equal():
    for zenith in (0.0, 0.6, 1.2, 1.5):
        for turbidity in (1.0, 3.0, 9.5):
            np.testing.assert_array_equal(
                tspec.sun_radiance_rgb(zenith, turbidity),
                jspec.sun_radiance_rgb(zenith, turbidity))
    wl = np.linspace(380, 780, 41)
    amp = np.exp(-((wl - 550) / 60) ** 2)
    np.testing.assert_array_equal(tspec.spectrum_to_rgb(wl, amp),
                                  jspec.spectrum_to_rgb(wl, amp))
    for a, b in zip(tspec._cie_bands(), jspec._cie_bands()):
        np.testing.assert_array_equal(a, b)
    for got, want in zip(thosek.cook_state(4.2, [0.1, 0.2, 0.3], 0.4),
                         jhosek.cook_state(4.2, [0.1, 0.2, 0.3], 0.4)):
        np.testing.assert_array_equal(got, want)


def test_splat_sun_bitmap_equal():
    d = np.array([0.3, -0.9, 0.1])
    d /= np.linalg.norm(d)
    np.testing.assert_array_equal(tsun.splat_sun_bitmap(d, 0.05, [3, 2, 1], 64, 32),
                                  jsun.splat_sun_bitmap(d, 0.05, [3, 2, 1], 64, 32))


# ---------------------------------------------------------------- cornell.xml


@pytest.fixture(scope="module")
def cornell_xml(tmp_path_factory):
    d = tmp_path_factory.mktemp("cornell")
    return chip_smoke.write_cornell_scene(str(d), res=16, spp=4)


def test_cornell_xml_compiles_to_the_reference_tables(cornell_xml, monkeypatch):
    cfg, ref_cfg = load_config(cornell_xml), jax_load_config(cornell_xml)
    assert_parses_alike(cfg, ref_cfg)
    isolate_env(monkeypatch, cfg)
    jscene = jax_compile_scene(ref_cfg)
    ref = jax_scene_arrays(jscene)
    scene = compile_scene(cfg, device="cpu")
    got = torch_scene_arrays(scene)
    assert len(got) == 108  # with the BVH's node_min and node_max
    for key, value in got.items():
        want = reference_leaf(ref, key)
        assert value.dtype == want.dtype, key
        if key in KC_ATOL and want.any():
            np.testing.assert_allclose(value, want, rtol=0, atol=KC_ATOL[key],
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(value, want, err_msg=key)
    assert scene.n_emissive == jscene.n_emissive == 2
    for fact in STATIC_FACTS:
        assert getattr(scene, fact) == getattr(jscene, fact), fact


def test_cornell_xml_renders_as_the_reference(cornell_xml, monkeypatch):
    cfg, ref_cfg = load_config(cornell_xml), jax_load_config(cornell_xml)
    cfg.integrator.depth_max = ref_cfg.integrator.depth_max = 2
    isolate_env(monkeypatch, cfg)
    ref = np.asarray(JaxRenderer(ref_cfg).render(tile=256))
    got = Renderer(cfg, device="cpu").render(tile=256)
    assert got.shape == ref.shape == (16, 16, 3)
    assert ref.mean() > 0.05
    close = np.isclose(got, ref, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99
