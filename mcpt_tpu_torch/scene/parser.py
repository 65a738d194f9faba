"""Mitsuba-XML scene compiler front-end: `load_config(xml) -> RendererConfig`
(counterpart of mcpt_tpu/scene/parser.py; csrt src/parser/parser.cpp
LoadConfig).  It builds the port's own IR (`scene/ir.py`) and
`TextureBuilder`, field for field the reference's; sphere and cylinder
shapes become the analytic rows `compile_scene` commits.

Walks the scene file in the reference's element order — defaults, camera,
integrator, textures, bsdfs, media, shapes, emitters — producing the same
RendererConfig IR.  String-keyed `$var` substitution from `<default>`,
`<ref id>` resolution via name maps, wrapper unwrapping for
bumpmap/mask/twosided, named IOR/medium LUTs, smooth-lobe roughness
fabrication, inline `<emitter type=area>` -> area-light BSDF fabrication
(parser.cpp:1068-1100) all match.

Deviations (documented):
  * `null` BSDFs are supported as medium boundaries (id_bsdf = -1; the
    reference errors on them, parser.cpp:819-832);
  * unknown emitters/sun/sky fall back with a warning instead of
    aborting when the procedural sky model is unavailable.
"""

from __future__ import annotations

import os
import sys
import warnings
import xml.etree.ElementTree as ET

import numpy as np

from mcpt_tpu_torch import trace
from mcpt_tpu_torch.models.texture import TextureBuilder
from mcpt_tpu_torch.scene import ior_lut, medium_lut
from mcpt_tpu_torch.scene.ir import (
    BsdfInfo,
    BsdfType,
    CameraInfo,
    EmitterInfo,
    EmitterType,
    InstanceInfo,
    IntegratorInfo,
    MediumInfo,
    RendererConfig,
)
from mcpt_tpu_torch.scene.loaders import load_mesh
from mcpt_tpu_torch.utils.image import read_image_linear


def _warn(msg):
    print(f"[warning] {msg}", file=sys.stderr)


class _Ctx:
    def __init__(self, directory):
        self.dir = directory
        self.defaults = {}
        self.tex = TextureBuilder()
        self.map_texture = {}
        self.map_bsdf = {}
        self.map_medium = {}
        self.config = RendererConfig(textures=self.tex)


def load_config(filename: str) -> RendererConfig:
    with trace.span("scene.parse"):
        tree = ET.parse(filename)
        return _load_root(
            tree.getroot(), os.path.dirname(os.path.abspath(filename))
        )


def load_config_string(xml: str, scene_dir: str = ".") -> RendererConfig:
    """Parse a scene from an XML string (tests / programmatic use)."""
    return _load_root(ET.fromstring(xml), scene_dir)


def _load_root(root, scene_dir: str) -> RendererConfig:
    ctx = _Ctx(scene_dir)

    for node in root.findall("default"):
        name = node.get("name", "")
        value = node.get("value", "")
        if name.startswith("mcpt."):
            # performance-knob tier (ir.RendererConfig.perf): `<default
            # name="mcpt.march_block" value="512"/>` — applied by the
            # Renderer as MCPT_MARCH_BLOCK unless the env already sets it
            ctx.config.perf[name[5:]] = value
        else:
            ctx.defaults["$" + name] = value

    sensor = root.find("sensor")
    if sensor is not None:
        _read_camera(ctx, sensor)
    integrator = root.find("integrator")
    if integrator is not None:
        _read_integrator(ctx, integrator)
    for node in root.findall("texture"):
        _read_texture(ctx, node, 1.0, 0.5)
    for node in root.findall("bsdf"):
        _read_bsdf(ctx, node)
    for node in root.findall("medium"):
        _read_medium(ctx, node)
    for node in root.findall("shape"):
        _read_shape(ctx, node)
    for node in root.findall("emitter"):
        _read_emitter(ctx, node)
    return ctx.config


# ---------------------------------------------------------------------------
# basic readers


def _sub(ctx, value: str) -> str:
    if value and value.startswith("$"):
        if value not in ctx.defaults:
            raise KeyError(f"cannot find default '{value}' in scene file")
        return ctx.defaults[value]
    return value


def _child_by_name(node, names):
    for child in node:
        if child.get("name") in names:
            return child
    return None


def _read_float(ctx, node, names, default):
    child = _child_by_name(node, names)
    if child is None:
        return default
    return float(_sub(ctx, child.get("value", str(default))))


def _read_int(ctx, node, names, default):
    child = _child_by_name(node, names)
    if child is None:
        return default
    return int(float(_sub(ctx, child.get("value", str(default)))))


def _read_bool(ctx, node, names, default):
    child = _child_by_name(node, names)
    if child is None:
        return default
    return _sub(ctx, child.get("value", "")).lower() == "true"


def _parse_vec3(text, default):
    if text is None:
        return np.array(default, np.float32)
    parts = text.replace(",", " ").split()
    if len(parts) == 1:
        return np.full(3, float(parts[0]), np.float32)
    return np.array([float(p) for p in parts[:3]], np.float32)


def _read_vec3_node(node, default):
    # no value attribute -> x/y/z attributes (any subset), matching csrt
    # ReadVec3 (parser.cpp:1490-1497): absent components use the default
    if node.get("value") is None:
        d = np.broadcast_to(np.asarray(default, np.float32), (3,))
        return np.array(
            [
                float(node.get("x", d[0])),
                float(node.get("y", d[1])),
                float(node.get("z", d[2])),
            ],
            np.float32,
        )
    return _parse_vec3(node.get("value"), np.broadcast_to(
        np.asarray(default, np.float32), (3,)))


def _read_vec3(ctx, node, names, default):
    child = _child_by_name(node, names)
    if child is None:
        return np.broadcast_to(np.asarray(default, np.float32), (3,)).copy()
    return _read_vec3_node(child, default)


def _translate(v):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = v
    return m


def _scale(v):
    return np.diag(np.array([v[0], v[1], v[2], 1.0], np.float32))


def _rotate(axis, angle_deg):
    a = np.asarray(axis, np.float64)
    a = a / max(np.linalg.norm(a), 1e-12)
    t = np.radians(angle_deg)
    c, s = np.cos(t), np.sin(t)
    x, y, z = a
    r = np.array(
        [
            [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
            [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
            [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
        ]
    )
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = r.astype(np.float32)
    return m


def _look_at(origin, target, up):
    """Camera-to-world (inverse LookAtLH, parser.cpp:1597-1603)."""
    front = np.asarray(target, np.float64) - np.asarray(origin, np.float64)
    front /= max(np.linalg.norm(front), 1e-12)
    right = np.cross(np.asarray(up, np.float64), front)
    right /= max(np.linalg.norm(right), 1e-12)
    up2 = np.cross(front, right)
    m = np.eye(4, dtype=np.float32)
    # camera-to-world: columns are (right, up, front), translation = origin.
    # NOTE csrt x-axis convention: TransformVector(to_world, (0,1,0)) = up
    # and TransformPoint(to_world, (0,0,1)) = front + origin.
    m[:3, 0] = right.astype(np.float32)
    m[:3, 1] = up2.astype(np.float32)
    m[:3, 2] = front.astype(np.float32)
    m[:3, 3] = np.asarray(origin, np.float32)
    return m


def _read_transform(ctx, node):
    """Compose child transforms; each LEFT-multiplies the accumulator
    (csrt ReadTransform4, parser.cpp:1565-1617)."""
    m = np.eye(4, dtype=np.float32)
    if node is None:
        return m
    for child in node:
        tag = child.tag
        if tag == "translate":
            m = _translate(_read_vec3_node(child, [0, 0, 0])) @ m
        elif tag == "scale":
            if child.get("value") is not None and child.get("x") is None:
                v = _parse_vec3(child.get("value"), [1, 1, 1])
            else:
                v = _read_vec3_node(child, [1, 1, 1])
            m = _scale(v) @ m
        elif tag == "rotate":
            axis = _read_vec3_node(child, [0, 0, 0])
            angle = float(child.get("angle", 0.0))
            m = _rotate(axis, angle) @ m
        elif tag == "matrix":
            vals = [float(x) for x in child.get("value", "").split()]
            if len(vals) == 16:
                mm = np.array(vals, np.float32).reshape(4, 4)
            elif len(vals) == 9:
                mm = np.eye(4, dtype=np.float32)
                mm[:3, :3] = np.array(vals, np.float32).reshape(3, 3)
            else:
                mm = np.eye(4, dtype=np.float32)
            m = mm @ m
        elif tag == "lookat" or tag == "lookAt":
            origin = _parse_vec3(child.get("origin"), [0, 0, 0])
            target = _parse_vec3(child.get("target"), [1, 0, 0])
            up = _parse_vec3(child.get("up"), [0, 1, 0])
            m = _look_at(origin, target, up) @ m
        else:
            _warn(f"unsupported transform '{tag}', ignored")
    return m


# ---------------------------------------------------------------------------
# camera + integrator


def _read_camera(ctx, sensor):
    cam = ctx.config.camera = CameraInfo()
    if sensor.get("type") != "perspective":
        raise ValueError("only 'perspective' sensors are supported")

    film = sensor.find("film")
    width, height = 768, 576
    if film is not None:
        width = _read_int(ctx, film, ("width",), width)
        height = _read_int(ctx, film, ("height",), height)
    cam.width, cam.height = width, height

    focal_length = 50.0
    fov_axis = "x"
    for node in sensor.findall("string"):
        if node.get("name") == "focalLength":
            focal_length = float(node.get("value", "50mm")[:-2])
        elif node.get("name") == "fovAxis":
            fov_axis = node.get("value", "x")
    fov = _read_float(ctx, sensor, ("fov",), -1.0)
    if fov_axis == "x":
        fov_x = fov if fov > 0 else np.degrees(2 * np.arctan(18.0 / focal_length))
    elif fov_axis == "y":
        fov_x = fov if fov > 0 else np.degrees(2 * np.arctan(12.0 / focal_length))
        fov_x = fov_x * width / height
    elif fov_axis == "smaller":
        fov_x = fov
        if width > height:
            if fov_x <= 0:
                fov_x = np.degrees(2 * np.arctan(12.0 / focal_length))
            fov_x = fov_x * width / height
    else:
        raise ValueError(f"unsupported fovAxis '{fov_axis}'")
    cam.fov_x = float(fov_x)

    sampler = sensor.find("sampler")
    cam.spp = _read_int(ctx, sampler, ("sampleCount", "sample_count"), 4) if sampler is not None else 4

    tf = sensor.find("transform")
    if tf is not None:
        m = _read_transform(ctx, tf)
        cam.eye = (m @ np.array([0, 0, 0, 1], np.float32))[:3]
        cam.look_at = (m @ np.array([0, 0, 1, 1], np.float32))[:3]
        up = m[:3, :3] @ np.array([0, 1, 0], np.float32)
        cam.up = up / max(np.linalg.norm(up), 1e-12)


def _read_integrator(ctx, node):
    integ = ctx.config.integrator = IntegratorInfo()
    itype = node.get("type", "path")
    if itype not in ("path", "volpath", "volpath_simple", "bdpt"):
        _warn(f"unsupported integrator '{itype}', using 'path'")
        itype = "path"
    if itype.startswith("volpath"):
        integ.itype = "volpath"
    else:
        integ.itype = itype
    integ.depth_max = _read_int(ctx, node, ("maxDepth", "max_depth"), 64)
    if integ.depth_max < 0:
        integ.depth_max = 64
    integ.depth_rr = _read_int(ctx, node, ("rrDepth", "rr_depth"), 5)
    integ.hide_emitters = _read_bool(
        ctx, node, ("hideEmitters", "hide_emitters"), False
    )
    integ.pdf_rr = _read_float(ctx, node, ("rrPdf", "rr_pdf"), 0.95)


# ---------------------------------------------------------------------------
# textures


def _register_constant(ctx, color) -> int:
    return ctx.tex.add_constant(color)


def _read_texture(ctx, node, scale, default) -> int:
    """csrt ReadTexture (parser.cpp:443-613)."""
    if node is None:
        return _register_constant(ctx, np.full(3, scale * default, np.float32))
    tag = node.tag
    if tag == "scale":
        local = _read_float(ctx, node, ("scale",), 1.0)
        return _read_texture(ctx, node.find("texture"), scale * local, default)
    if tag == "ref":
        tid = ctx.map_texture.get(node.get("id"))
        if tid is None:
            raise KeyError(f"cannot find texture '{node.get('id')}'")
        return tid
    if tag == "rgb" or tag == "spectrum":
        color = _parse_vec3(_sub(ctx, node.get("value")), [default] * 3)
        return _register_constant(ctx, scale * color)
    if tag == "float":
        v = float(_sub(ctx, node.get("value", str(default))))
        return _register_constant(ctx, np.full(3, scale * v, np.float32))
    if tag == "texture":
        ttype = node.get("type")
        tex_id = node.get("id")
        if ttype == "checkerboard":
            c0 = _read_vec3(ctx, node, ("color0",), [0.4] * 3)
            c1 = _read_vec3(ctx, node, ("color1",), [0.2] * 3)
            tf = _read_uv_transform(ctx, node)
            tid = ctx.tex.add_checkerboard(scale * c0, scale * c1, tf)
        elif ttype == "bitmap":
            fn = _child_by_name(node, ("filename",))
            if fn is None:
                raise ValueError("bitmap texture without filename")
            gamma = _read_float(ctx, node, ("gamma",), 0.0)
            path = os.path.join(ctx.dir, _sub(ctx, fn.get("value")))
            if not os.path.exists(path):
                # warn-skip like missing meshes: stand in a mid gray so
                # the rest of the scene still parses and renders
                warnings.warn(f"bitmap not found, using 0.5 gray: {path}")
                pixels = np.full((2, 2, 3), 0.5, np.float32)
            else:
                pixels = read_image_linear(path, gamma if gamma else 2.2)
            tf = _read_uv_transform(ctx, node)
            tid = ctx.tex.add_bitmap(pixels * scale, tf)
        else:
            raise ValueError(f"unsupported texture type '{ttype}'")
        if tex_id:
            ctx.map_texture[tex_id] = tid
        return tid
    raise ValueError(f"unsupported texture node '{tag}'")


def _read_uv_transform(ctx, node) -> np.ndarray:
    """Texture uv transform as a 2x3 affine row [a,b,c,d,e,f]:
    uv' = (a u + b v + c, d u + e v + f).  Accepts BOTH forms the scenes
    use: Mitsuba-0.5 uscale/vscale/uoffset/voffset floats (csrt
    parser.cpp texture path) and a Mitsuba-2/3 `<transform name="to_uv">`
    child with scale/translate nodes."""
    tf_node = None
    for child in node.findall("transform"):
        if child.get("name") in ("to_uv", "toUV", "uv"):
            tf_node = child
            break
    if tf_node is not None:
        m = _read_transform(ctx, tf_node)
        return np.array(
            [m[0, 0], m[0, 1], m[0, 3], m[1, 0], m[1, 1], m[1, 3]],
            np.float32,
        )
    uo = _read_float(ctx, node, ("uoffset",), 0.0)
    vo = _read_float(ctx, node, ("voffset",), 0.0)
    us = _read_float(ctx, node, ("uscale",), 1.0)
    vs = _read_float(ctx, node, ("vscale",), 1.0)
    return np.array([us, 0, uo * us, 0, vs, vo * vs], np.float32)


def _read_texture_param(ctx, node, names, default) -> int:
    child = _child_by_name(node, names) if names else None
    if child is None:
        return _register_constant(ctx, np.full(3, default, np.float32))
    return _read_texture(ctx, child, 1.0, default)


# ---------------------------------------------------------------------------
# bsdfs


def _read_dielectric_ior(ctx, node, names, default) -> float:
    child = _child_by_name(node, names)
    if child is None:
        return default
    if child.tag == "string":
        return ior_lut.lookup_dielectric_ior(child.get("value", ""), default)
    return float(_sub(ctx, child.get("value", str(default))))


def _read_conductor_ior(ctx, node):
    """eta/k from explicit rgb values or a named material ('Cu' default,
    parser.cpp:1041-1058)."""
    mat = None
    for child in node.findall("string"):
        if child.get("name") == "material":
            mat = child.get("value")
    eta_node = _child_by_name(node, ("eta",))
    k_node = _child_by_name(node, ("k",))
    if eta_node is not None and k_node is not None:
        return (
            _read_vec3_node(eta_node, [0.2] * 3),
            _read_vec3_node(k_node, [3.9] * 3),
        )
    entry = ior_lut.lookup_conductor_ior(mat or "Cu")
    if entry is None:
        _warn(f"unknown conductor material '{mat}', using Cu")
        entry = ior_lut.lookup_conductor_ior("Cu")
    return np.asarray(entry[0], np.float32), np.asarray(entry[1], np.float32)


def _read_bsdf(ctx, node, id_=None, id_opacity=-1, id_bump=-1,
               twosided=False) -> int:
    if id_ is None or id_ == "":
        id_ = node.get("id", "")
    btype = node.get("type", "diffuse")

    # wrappers (parser.cpp:800-818)
    if btype == "bumpmap":
        id_bump = _read_texture(ctx, node.find("texture"), 1.0, 1.0)
        return _read_bsdf(ctx, node.find("bsdf"), id_, id_opacity, id_bump, twosided)
    if btype == "mask":
        id_opacity = _read_texture_param(ctx, node, ("opacity",), 1.0)
        return _read_bsdf(ctx, node.find("bsdf"), id_, id_opacity, id_bump, twosided)
    if btype == "twosided":
        return _read_bsdf(ctx, node.find("bsdf"), id_, id_opacity, id_bump, True)
    if btype == "null":
        # medium boundary: instances referencing it get id_bsdf = -1
        if id_:
            ctx.map_bsdf[id_] = -1
        return -1

    info = BsdfInfo(twosided=twosided, id_opacity=id_opacity, id_bump_map=id_bump)
    for child in node.findall("string"):
        if child.get("name") == "distribution":
            dist = child.get("value", "ggx")
            if dist in ("ggx", "beckmann"):
                info.ndf = dist
            else:
                _warn(f"unsupported distribution '{dist}', using ggx")
    if btype == "diffuse":
        info.btype = BsdfType.DIFFUSE
        info.id_diffuse_reflectance = _read_texture_param(
            ctx, node, ("reflectance",), 0.5
        )
    elif btype == "roughdiffuse":
        info.btype = BsdfType.ROUGH_DIFFUSE
        info.use_fast_approx = _read_bool(
            ctx, node, ("useFastApprox", "use_fast_approx"), False
        )
        info.id_diffuse_reflectance = _read_texture_param(
            ctx, node, ("reflectance",), 0.5
        )
        info.id_roughness = _read_texture_param(ctx, node, ("alpha",), 0.2)
    elif btype in ("dielectric", "roughdielectric", "thindielectric"):
        info.btype = (
            BsdfType.THIN_DIELECTRIC
            if btype == "thindielectric"
            else BsdfType.DIELECTRIC
        )
        info.twosided = True
        int_ior = _read_dielectric_ior(ctx, node, ("int_ior", "intIOR"), 1.5046)
        ext_ior = _read_dielectric_ior(ctx, node, ("ext_ior", "extIOR"), 1.000277)
        info.eta = int_ior / ext_ior
        if btype == "roughdielectric":
            if _child_by_name(node, ("alpha",)) is not None:
                info.id_roughness_u = _read_texture_param(ctx, node, ("alpha",), 0.1)
                info.id_roughness_v = info.id_roughness_u
            else:
                info.id_roughness_u = _read_texture_param(
                    ctx, node, ("alpha_u", "alphaU"), 0.1
                )
                info.id_roughness_v = _read_texture_param(
                    ctx, node, ("alpha_v", "alphaV"), 0.1
                )
        else:
            info.id_roughness_u = _read_texture_param(ctx, node, (), 0.001)
            info.id_roughness_v = info.id_roughness_u
        info.id_specular_reflectance = _read_texture_param(
            ctx, node, ("specularReflectance", "specular_reflectance"), 1.0
        )
        info.id_specular_transmittance = _read_texture_param(
            ctx, node, ("specularTransmittance", "specular_transmittance"), 1.0
        )
    elif btype in ("conductor", "roughconductor", "clearcoatedconductor",
                   "clear_coated_conductor"):
        is_coated = btype.startswith("clear")
        info.btype = (
            BsdfType.CLEARCOAT_CONDUCTOR if is_coated else BsdfType.CONDUCTOR
        )
        if is_coated:
            info.clear_coat = _read_float(
                ctx, node, ("clearCoat", "clear_coat"), 1.0
            )
            info.id_coat_roughness = _read_texture_param(
                ctx, node, ("coatAlpha", "coat_alpha"), 0.01
            )
        if btype != "conductor":
            if _child_by_name(node, ("alpha",)) is not None:
                info.id_roughness_u = _read_texture_param(ctx, node, ("alpha",), 0.1)
                info.id_roughness_v = info.id_roughness_u
            else:
                info.id_roughness_u = _read_texture_param(
                    ctx, node, ("alpha_u", "alphaU"), 0.1
                )
                info.id_roughness_v = _read_texture_param(
                    ctx, node, ("alpha_v", "alphaV"), 0.1
                )
        else:
            info.id_roughness_u = _read_texture_param(ctx, node, (), 0.001)
            info.id_roughness_v = info.id_roughness_u
        info.id_specular_reflectance = _read_texture_param(
            ctx, node, ("specularReflectance", "specular_reflectance"), 1.0
        )
        eta, k = _read_conductor_ior(ctx, node)
        eta = np.asarray(eta, np.float64)
        k = np.asarray(k, np.float64)
        refl = ((eta - 1) ** 2 + k**2) / ((eta + 1) ** 2 + k**2)
        t1, t2 = 1 + np.sqrt(refl), 1 - np.sqrt(refl)
        t3 = (1 - refl) / (1 + refl)
        edgetint = (t1 - eta * t2) / (t1 - t3 * t2)
        info.reflectivity = refl.astype(np.float32)
        info.edgetint = edgetint.astype(np.float32)
    elif btype in ("plastic", "roughplastic"):
        info.btype = BsdfType.PLASTIC
        int_ior = _read_dielectric_ior(ctx, node, ("int_ior", "intIOR"), 1.5046)
        ext_ior = _read_dielectric_ior(ctx, node, ("ext_ior", "extIOR"), 1.000277)
        info.eta = int_ior / ext_ior
        if btype == "roughplastic":
            info.id_roughness = _read_texture_param(ctx, node, ("alpha",), 0.1)
        else:
            info.id_roughness = _read_texture_param(ctx, node, (), 0.001)
        info.id_diffuse_reflectance = _read_texture_param(
            ctx, node, ("diffuseReflectance", "diffuse_reflectance"), 0.5
        )
        info.id_specular_reflectance = _read_texture_param(
            ctx, node, ("specularReflectance", "specular_reflectance"), 1.0
        )
    else:
        _warn(f"unsupported bsdf '{btype}', using diffuse")
        info.btype = BsdfType.DIFFUSE
        info.id_diffuse_reflectance = _read_texture_param(ctx, node, (), 0.5)

    idx = len(ctx.config.bsdfs)
    ctx.config.bsdfs.append(info)
    if id_:
        ctx.map_bsdf[id_] = idx
    return idx


# ---------------------------------------------------------------------------
# media


def _read_medium(ctx, node) -> int:
    id_ = node.get("id", "")
    if id_ in ctx.map_medium:
        return ctx.map_medium[id_]
    idx = len(ctx.config.media)
    if id_:
        ctx.map_medium[id_] = idx
    if node.get("type") != "homogeneous":
        raise ValueError(f"unsupported medium '{node.get('type')}'")
    scale = _read_float(ctx, node, ("scale",), 1.0)

    info = MediumInfo()
    albedo_node = _child_by_name(node, ("albedo",))
    sa_node = _child_by_name(node, ("sigmaA", "sigma_a"))
    if albedo_node is not None:
        st = _read_vec3(ctx, node, ("sigma_t", "sigmaT"), [1.0] * 3)
        albedo = _read_vec3_node(albedo_node, [0.75] * 3)
        info.sigma_s = albedo * st
        info.sigma_a = st - info.sigma_s
    elif sa_node is not None:
        info.sigma_a = _read_vec3_node(sa_node, [1.0] * 3)
        info.sigma_s = _read_vec3(ctx, node, ("sigmaS", "sigma_s"), [1.0] * 3)
    else:
        name = "skin1"
        for child in node.findall("string"):
            name = child.get("value", name)
        entry = medium_lut.lookup_medium(name)
        if entry is None:
            raise ValueError(f"unknown medium material '{name}'")
        ss, sa, g, phase = entry
        info.sigma_s = np.asarray(ss, np.float32)
        info.sigma_a = np.asarray(sa, np.float32)
        info.g = np.asarray(g, np.float32)
        info.phase = phase
        info.sigma_a = info.sigma_a * scale
        info.sigma_s = info.sigma_s * scale
        ctx.config.media.append(info)
        return idx

    info.sigma_a = info.sigma_a * scale
    info.sigma_s = info.sigma_s * scale
    phase_node = node.find("phase")
    if phase_node is not None:
        ptype = phase_node.get("type", "isotropic")
        if ptype == "hg":
            info.phase = "hg"
            info.g = np.full(
                3, _read_float(ctx, phase_node, ("g",), 0.0), np.float32
            )
        elif ptype != "isotropic":
            _warn(f"unsupported phase '{ptype}', using isotropic")
    ctx.config.media.append(info)
    return idx


# ---------------------------------------------------------------------------
# shapes


def _read_shape(ctx, node):
    id_ = node.get("id", "")
    emitter_node = node.find("emitter")
    id_bsdf = -1
    if emitter_node is not None:
        radiance = _read_vec3(ctx, emitter_node, ("radiance",), [1.0] * 3)
        tid = ctx.tex.add_constant(radiance)
        id_bsdf = len(ctx.config.bsdfs)
        ctx.config.bsdfs.append(
            BsdfInfo(btype=BsdfType.AREA_LIGHT, id_radiance=tid, weight=1.0)
        )
        if id_:
            ctx.map_bsdf[id_] = id_bsdf
    elif node.find("bsdf") is not None:
        id_bsdf = _read_bsdf(ctx, node.find("bsdf"))
    else:
        for ref in node.findall("ref"):
            rid = ref.get("id")
            if rid in ctx.map_bsdf:
                id_bsdf = ctx.map_bsdf[rid]
                break

    info = InstanceInfo(shape="", id_bsdf=id_bsdf)
    info.flip_normals = _read_bool(
        ctx, node, ("flip_normals", "flipNormals"), False
    )
    info.to_world = _read_transform(ctx, node.find("transform"))

    stype = node.get("type")
    if stype in ("cube", "rectangle", "disk"):
        info.shape = stype
    elif stype == "sphere":
        info.shape = "sphere"
        f = node.find("float")
        info.radius = float(f.get("value", 1.0)) if f is not None else 1.0
        info.center = _read_vec3(ctx, node, ("center",), [0.0] * 3)
    elif stype == "cylinder":
        info.shape = "cylinder"
        f = node.find("float")
        info.radius = float(f.get("value", 1.0)) if f is not None else 1.0
        info.p0 = _read_vec3(ctx, node, ("p0",), [0.0, 0.0, 0.0])
        info.p1 = _read_vec3(ctx, node, ("p1",), [0.0, 0.0, 1.0])
    elif stype in ("obj", "serialized", "gltf", "ply"):
        info.shape = "mesh"
        fn = None
        for child in node.findall("string"):
            if child.get("name") == "filename":
                fn = _sub(ctx, child.get("value"))
        if fn is None:
            raise ValueError(f"shape '{id_}' missing filename")
        face_normals = _read_bool(
            ctx, node, ("face_normals", "faceNormals"), False
        )
        if not os.path.exists(os.path.join(ctx.dir, fn)):
            _warn(f"mesh file '{fn}' missing, shape '{id_}' skipped")
            return
        if stype == "obj":
            flip_uv = _read_bool(
                ctx, node, ("flip_tex_coords", "flipTexCoords"), True
            )
            info.mesh = load_mesh(
                os.path.join(ctx.dir, fn), flip_uv, face_normals
            )
        elif stype == "serialized":
            shape_idx = 0
            i_node = node.find("integer")
            if i_node is not None:
                shape_idx = int(_sub(ctx, i_node.get("value", "0")))
            info.mesh = load_mesh(
                os.path.join(ctx.dir, fn),
                False,
                face_normals,
                shape_index=shape_idx,
            )
        else:
            info.mesh = load_mesh(os.path.join(ctx.dir, fn), False, face_normals)
    else:
        _warn(f"unsupported shape '{stype}', ignored")
        return

    int_node = _child_by_name(node, ("interior",))
    if int_node is not None:
        info.id_medium_int = _read_medium(ctx, int_node)
    ext_node = _child_by_name(node, ("exterior",))
    if ext_node is not None:
        info.id_medium_ext = _read_medium(ctx, ext_node)

    ctx.config.instances.append(info)


# ---------------------------------------------------------------------------
# emitters


def _read_emitter(ctx, node):
    etype = node.get("type")
    if etype == "area":
        return  # inline area emitters are handled by _read_shape
    info = EmitterInfo()
    if etype == "point":
        info.etype = EmitterType.POINT
        info.position = _read_vec3(ctx, node, ("position",), [0.0] * 3)
        if node.find("transform") is not None:
            m = _read_transform(ctx, node.find("transform"))
            info.position = (m @ np.append(info.position, 1.0))[:3]
        info.intensity = _read_vec3(ctx, node, ("intensity",), [1.0] * 3)
    elif etype == "spot":
        info.etype = EmitterType.SPOT
        info.to_world = _read_transform(ctx, node.find("transform"))
        info.intensity = _read_vec3(ctx, node, ("intensity",), [1.0] * 3)
        info.cutoff_angle = _read_float(
            ctx, node, ("cutoffAngle", "cutoff_angle"), 20.0
        )
        info.beam_width = _read_float(
            ctx, node, ("beamWidth", "beam_width"), info.cutoff_angle * 0.75
        )
        tex_node = node.find("texture")
        if tex_node is not None:
            info.id_texture = _read_texture(ctx, tex_node, 1.0, 1.0)
    elif etype == "directional":
        info.etype = EmitterType.DIRECTIONAL
        info.direction = _read_vec3(ctx, node, ("direction",), [0.0, -1.0, 0.0])
        # `irradiance` E contributes L = (E/pi) * f * cos: both the
        # Tungsten ground truths and the reference's own committed
        # renders (dragon pedestal: albedo .456, E=10, cos .69 ->
        # linear .35) follow the E/pi convention; csrt's code returns E
        # directly (directional_light.cpp:21-25, parser.cpp:1274-1275),
        # which blows out its own golden — deviation documented.
        if node is not None and any(
            c.get("name") == "irradiance" for c in node
        ):
            info.radiance = _read_vec3(
                ctx, node, ("irradiance",), [1.0] * 3
            ) / np.float32(np.pi)
        else:
            info.radiance = _read_vec3(ctx, node, ("radiance",), [1.0] * 3)
    elif etype == "constant":
        info.etype = EmitterType.CONSTANT
        info.radiance = _read_vec3(ctx, node, ("radiance",), [1.0] * 3)
    elif etype == "envmap":
        fn = None
        for child in node.findall("string"):
            if child.get("name") == "filename":
                fn = _sub(ctx, child.get("value"))
        if fn is None:
            raise ValueError("envmap emitter without filename")
        pixels = read_image_linear(os.path.join(ctx.dir, fn))
        scale = _read_float(ctx, node, ("scale",), 1.0)
        # downscale to ~1 texel per output pixel at the camera fov, like
        # the reference (width_max = width * 360 / fov_x, parser.cpp:1402)
        cam = ctx.config.camera
        width_max = int(cam.width * 360.0 / max(cam.fov_x, 1.0))
        h, w = pixels.shape[:2]
        if w > width_max > 0:
            f = max(w // width_max, 1)
            pixels = pixels[: h // f * f, : w // f * f].reshape(
                h // f, f, w // f, f, -1
            ).mean((1, 3))
        info.etype = EmitterType.ENVMAP
        info.id_texture = ctx.tex.add_bitmap(pixels * scale)
        info.to_world = _read_transform(ctx, node.find("transform"))
    elif etype in ("sun", "sky", "sunsky"):
        from mcpt_tpu_torch.scene import sun_sky

        sun_sky.read_sun_sky(ctx, node, etype)
        return
    else:
        _warn(f"unsupported emitter '{etype}', ignored")
        return
    ctx.config.emitters.append(info)
