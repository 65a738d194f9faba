"""The port's microfacet library, Kulla-Conty tables and BSDFs against
mcpt_tpu, on the CPU.

* Microfacet functions: the same seeded inputs through both packages,
  rtol 1e-4, atol 1e-5: the rest is the same f32 arithmetic in the same
  order, but tan and atan of two libraries differ in their last ulps,
  and near tan's pole (phi = pi/2) the sampled h moves by a few 1e-6;
  Schlick's Fresnel, free of transcendentals, is held bit for bit.
* Kulla-Conty tables: the port's quadrature against the reference's
  get_tables() at atol 5e-4 on E(mu, alpha) and 1e-5 on E_avg(alpha).
  The reference's mean over 1024 f32 samples sums in another order, and
  in the smoothest row (alpha = 1/256) a quadrature node or two with
  grazing directions lands on the other side of the `ok` cut: 1/1024 of
  a contribution, 2.6e-4.  Every other row is within 5e-5.  The lookups
  are held to the reference's soft-one-hot contraction at atol 1e-6 on
  the same table.
* bsdf_sample / bsdf_evaluate, family by family, on 4096 seeded lanes:
  random frames, `inside` both ways, wo on both sides, alpha from 0.001
  to 0.8, GGX and Beckmann rows, the reference's Kulla-Conty tables for
  both packages.  Every output is held per lane at rtol 1e-4, atol 1e-5.
  A lane may differ only where a branch decision sits on a tie: the two
  packages' transcendentals (tan, atan, log1p, exp, acos) differ in the
  last ulps, and near-delta lobes (alpha 0.001) turn those ulps into
  large relative changes of pdf and attenuation, or flip `xi < F`, total
  internal reflection or a `valid` cutoff.  At most FLIP_SHARE (0.2%, 8
  lanes) may differ, and in `valid` at most a tenth of that (no lane at
  N = 4096).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcpt_tpu.models import bsdf as JB
from mcpt_tpu.models import kulla_conty as JK
from mcpt_tpu.ops import microfacet as JM
from mcpt_tpu_torch.models import bsdf as TB
from mcpt_tpu_torch.models import kulla_conty as TK
from mcpt_tpu_torch.models.texture import TextureBuilder
from mcpt_tpu_torch.ops import microfacet as TM
from mcpt_tpu_torch.scene.ir import BsdfInfo, BsdfType
from tests.test_torch_scene import to_jax_config

N = 4096
ALPHAS = (0.001, 0.01, 0.05, 0.1, 0.2, 0.35, 0.5, 0.8)
#: the share of lanes that may differ beyond rtol 1e-4 / atol 1e-5 (see
#: the module docstring)
FLIP_SHARE = 0.002


def _t(x):
    return torch.as_tensor(np.array(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


def _close(a, b, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


# ---------------------------------------------------------------- microfacet


def _mf_inputs(seed=0, n=N):
    r = np.random.default_rng(seed)
    f = np.float32
    xi0, xi1 = r.random(n, dtype=f), r.random(n, dtype=f)
    au = np.exp(r.uniform(np.log(1e-3), np.log(0.8), n)).astype(f)
    av = np.where(r.random(n) < 0.5, au,
                  np.exp(r.uniform(np.log(1e-3), np.log(0.8), n))).astype(f)
    v = r.normal(size=(n, 3)).astype(f)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    h = r.normal(size=(n, 3)).astype(f)
    h[:, 2] = np.abs(h[:, 2]) * np.where(r.random(n) < 0.9, 1, -1)
    h /= np.linalg.norm(h, axis=-1, keepdims=True)
    return xi0, xi1, au, av, v, h


@pytest.mark.parametrize("ndf", ["ggx", "beckmann"])
def test_ndf_sample_pdf_g1_match_reference(ndf):
    xi0, xi1, au, av, v, h = _mf_inputs()
    sample, pdf, g1 = {
        "ggx": ((TM.sample_ggx, JM.sample_ggx), (TM.pdf_ggx, JM.pdf_ggx),
                (TM.smith_g1, JM.smith_g1)),
        "beckmann": ((TM.sample_beckmann, JM.sample_beckmann),
                     (TM.pdf_beckmann, JM.pdf_beckmann),
                     (TM.smith_g1_beckmann, JM.smith_g1_beckmann)),
    }[ndf]
    for got, want in zip(sample[0](*map(_t, (xi0, xi1, au, av))),
                         sample[1](*map(_j, (xi0, xi1, au, av)))):
        _close(got, want)
    _close(pdf[0](*map(_t, (au, av, h))), pdf[1](*map(_j, (au, av, h))))
    _close(g1[0](*map(_t, (au, av, v, h))), g1[1](*map(_j, (au, av, v, h))))


def test_fresnel_terms_match_reference():
    r = np.random.default_rng(1)
    cos = r.uniform(-0.2, 1.2, N).astype(np.float32)
    refl = r.random(N, dtype=np.float32)
    rgb = r.random((N, 3), dtype=np.float32)
    for eta_inv in (1.0 / 1.5, 1.5, 2.4):
        _close(TM.fresnel_dielectric(_t(np.abs(cos)), eta_inv),
               JM.fresnel_dielectric(_j(np.abs(cos)), eta_inv))
    _close(TM.fresnel_schlick(_t(cos), _t(refl)),
           JM.fresnel_schlick(_j(cos), _j(refl)), rtol=0, atol=0)
    _close(TM.fresnel_schlick(_t(cos), _t(rgb)),
           JM.fresnel_schlick(_j(cos), _j(rgb)), rtol=0, atol=0)


def test_average_fresnel_fits_equal_reference():
    for eta in (0.5, 1.0 / 1.5, 1.0, 1.33, 1.5, 2.4):
        assert TM.average_fresnel_scalar(eta) == JM.average_fresnel_scalar(eta)
    r = np.random.default_rng(2)
    refl = r.random(3, dtype=np.float32)
    edge = r.random(3, dtype=np.float32)
    np.testing.assert_array_equal(TM.average_fresnel_rgb(refl, edge),
                                  JM.average_fresnel_rgb(refl, edge))


# ---------------------------------------------------------------- Kulla-Conty


def test_kulla_conty_tables_match_reference():
    brdf, albedo = TK.get_tables("cpu")
    assert TK.get_tables("cpu")[0] is brdf  # built once per device
    ref_brdf, ref_albedo = map(np.asarray, JK.get_tables())
    assert brdf.shape == (128, 128) and albedo.shape == (128,)
    diff = np.abs(brdf.numpy() - ref_brdf)
    assert diff.max() <= 5e-4, diff.max()
    assert diff[1:].max() <= 5e-5, diff[1:].max()
    np.testing.assert_allclose(albedo.numpy(), ref_albedo, rtol=0, atol=1e-5)


def test_kulla_conty_lookups_match_reference():
    """Bilinear gathers against the soft-one-hot contractions on the same
    table, clamped outside [0, 1) as the reference clamps."""
    ref_brdf, ref_albedo = map(np.asarray, JK.get_tables())
    r = np.random.default_rng(3)
    cos = r.uniform(-0.1, 1.1, N).astype(np.float32)
    alpha = r.uniform(-0.1, 1.1, N).astype(np.float32)
    alpha[::7] = np.round(alpha[::7] * 128) / 128  # on texel centres
    _close(TK.lookup_brdf_avg(_t(ref_brdf), _t(cos), _t(alpha)),
           JK.lookup_brdf_avg(_j(ref_brdf), _j(cos), _j(alpha)), 0, 1e-6)
    _close(TK.lookup_albedo_avg(_t(ref_albedo), _t(alpha)),
           JK.lookup_albedo_avg(_j(ref_albedo), _j(alpha)), 0, 1e-6)


# ---------------------------------------------------------------- BSDFs


FAMILIES = (BsdfType.DIFFUSE, BsdfType.ROUGH_DIFFUSE, BsdfType.CONDUCTOR,
            BsdfType.DIELECTRIC, BsdfType.THIN_DIELECTRIC, BsdfType.PLASTIC,
            BsdfType.CLEARCOAT_CONDUCTOR)


def family_rows(family, tex):
    """One row per (alpha, NDF) of `family`, with every parameter the
    family reads set, as constant textures in `tex`."""
    r = np.random.default_rng(int(family))
    rows = []
    for k, a in enumerate(ALPHAS):
        for ndf in ("ggx", "beckmann"):
            av = a if k % 2 == 0 else ALPHAS[(k + 3) % len(ALPHAS)]
            rows.append(BsdfInfo(
                btype=family, ndf=ndf, twosided=bool(k % 3 == 0),
                id_diffuse_reflectance=tex.add_constant(r.uniform(0.1, 0.9, 3)),
                id_roughness=tex.add_constant([a] * 3),
                id_roughness_u=tex.add_constant([a] * 3),
                id_roughness_v=tex.add_constant([av] * 3),
                id_specular_reflectance=(
                    tex.add_constant(r.uniform(0.5, 1.0, 3)) if k % 2 else -1),
                id_specular_transmittance=(
                    tex.add_constant(r.uniform(0.5, 1.0, 3)) if k % 3 else -1),
                reflectivity=r.uniform(0.3, 1.0, 3).astype(np.float32),
                edgetint=r.uniform(0.3, 1.0, 3).astype(np.float32),
                eta=float(r.choice([1.33, 1.5, 2.4])),
                use_fast_approx=bool(k % 2),
                clear_coat=float(r.uniform(0.3, 1.0)),
                id_coat_roughness=tex.add_constant([ALPHAS[-1 - k]] * 3),
            ))
    return rows


def lanes(n_rows, seed=11, n=N):
    """Random shading frames and directions: (bid, wo, wi, normal,
    tangent, bitangent, inside, uv, xi) as numpy arrays."""
    r = np.random.default_rng(seed)
    f = np.float32

    def unit(m):
        v = r.normal(size=(m, 3))
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    nrm = unit(n)
    helper = np.where(np.abs(nrm[:, :1]) > 0.9, [[0.0, 1.0, 0.0]],
                      [[1.0, 0.0, 0.0]])
    tan = np.cross(helper, nrm)
    tan /= np.linalg.norm(tan, axis=-1, keepdims=True)
    bit = np.cross(nrm, tan)
    return (r.integers(0, n_rows, n).astype(np.int32), unit(n).astype(f),
            unit(n).astype(f), nrm.astype(f), tan.astype(f), bit.astype(f),
            r.random(n) < 0.5, r.random((n, 2), dtype=f),
            r.random((TB.N_SAMPLE_DRAWS, n), dtype=f))


def both_tables(infos, tex):
    """The same BSDF rows and textures as both packages' tables."""
    jinfos, jtex = to_jax_config([infos, tex])
    return ((TB.build_bsdf_tables(infos, "cpu"), tex.build("cpu")),
            (JB.build_bsdf_tables(jinfos), jtex.build()))


def _kc_pair():
    brdf, albedo = map(np.asarray, JK.get_tables())
    return (_t(brdf), _t(albedo)), (_j(brdf), _j(albedo))


def _agree(got, want, label):
    """Per-lane agreement of one output; returns the lanes that differ."""
    got, want = np.asarray(got), np.asarray(want)
    if got.dtype == np.bool_:
        bad = got != want
    else:
        bad = ~np.isclose(got, want, rtol=1e-4, atol=1e-5)
        assert np.isfinite(got).all(), label
    return bad.reshape(N, -1).any(axis=-1)


def _hold(outs_t, outs_j, names, valid_index):
    bad = np.zeros(N, bool)
    for name, g, w in zip(names, outs_t, outs_j):
        b = _agree(g, w, name)
        if name == names[valid_index]:
            assert b.mean() <= FLIP_SHARE / 10, (name, b.mean())
        bad |= b
    assert bad.mean() <= FLIP_SHARE, bad.mean()
    return bad


@pytest.mark.parametrize("family", FAMILIES, ids=lambda f: f.name.lower())
def test_bsdf_sample_matches_reference(family):
    tex = TextureBuilder()
    infos = family_rows(family, tex)
    (tt, ttex), (jt, jtex) = both_tables(infos, tex)
    bid, wo, _, nrm, tan, bit, inside, uv, xi = lanes(len(infos))
    kc_t, kc_j = _kc_pair()
    got = TB.bsdf_sample(tt, ttex, (int(family),), _t(bid), _t(wo), _t(nrm),
                         _t(tan), _t(bit), _t(inside), _t(uv), _t(xi), kc=kc_t)
    want = JB.bsdf_sample(jt, jtex, (int(family),), _j(bid), _j(wo), _j(nrm),
                          _j(tan), _j(bit), _j(inside), _j(uv), _j(xi),
                          kc=kc_j)
    _hold(got, want, ("wi", "pdf", "atten", "valid"), 3)
    assert np.asarray(want[3]).mean() > 0.2  # the lanes do real work


@pytest.mark.parametrize("family", FAMILIES, ids=lambda f: f.name.lower())
def test_bsdf_evaluate_matches_reference(family):
    tex = TextureBuilder()
    infos = family_rows(family, tex)
    (tt, ttex), (jt, jtex) = both_tables(infos, tex)
    bid, wo, wi, nrm, tan, bit, inside, uv, _ = lanes(len(infos), seed=12)
    kc_t, kc_j = _kc_pair()
    got = TB.bsdf_evaluate(tt, ttex, (int(family),), _t(bid), _t(wi), _t(wo),
                           _t(nrm), _t(tan), _t(bit), _t(inside), _t(uv),
                           kc=kc_t)
    want = JB.bsdf_evaluate(jt, jtex, (int(family),), _j(bid), _j(wi),
                            _j(wo), _j(nrm), _j(tan), _j(bit), _j(inside),
                            _j(uv), kc=kc_j)
    _hold(got, want, ("pdf", "atten", "valid"), 2)
    assert np.asarray(want[2]).mean() > 0.05


def test_every_family_at_once_and_null_lanes():
    """All seven families in one table, with null-boundary lanes (bid < 0)
    passing straight through, as the integrator calls it."""
    tex = TextureBuilder()
    infos = [row for fam in FAMILIES for row in family_rows(fam, tex)[::5]]
    (tt, ttex), (jt, jtex) = both_tables(infos, tex)
    bid, wo, wi, nrm, tan, bit, inside, uv, xi = lanes(len(infos), seed=13)
    bid[::17] = -1
    present = tuple(int(f) for f in FAMILIES)
    kc_t, kc_j = _kc_pair()
    args = (bid, wo, nrm, tan, bit, inside, uv, xi)
    got = TB.bsdf_sample(tt, ttex, present, *map(_t, args), kc=kc_t)
    want = JB.bsdf_sample(jt, jtex, present, *map(_j, args), kc=kc_j)
    _hold(got, want, ("wi", "pdf", "atten", "valid"), 3)
    assert np.asarray(got[3])[::17].all()
    np.testing.assert_array_equal(got[0].numpy()[::17], wo[::17])
    args = (bid, wi, wo, nrm, tan, bit, inside, uv)
    got = TB.bsdf_evaluate(tt, ttex, present, *map(_t, args), kc=kc_t)
    want = JB.bsdf_evaluate(jt, jtex, present, *map(_j, args), kc=kc_j)
    _hold(got, want, ("pdf", "atten", "valid"), 2)
    assert not np.asarray(got[2])[::17].any()


@pytest.mark.parametrize("rough", [0.1, 0.3, 0.6])
def test_kulla_conty_conductor_white_furnace(rough):
    """A perfect mirror (F0 = 1) with Kulla-Conty compensation conserves
    energy, E[f cos / pdf] ~ 1 over its valid samples, as in
    tests/test_bsdf.py's furnace test."""
    tex = TextureBuilder()
    r = tex.add_constant([rough] * 3)
    tables = TB.build_bsdf_tables([BsdfInfo(
        btype=BsdfType.CONDUCTOR, id_roughness_u=r, id_roughness_v=r,
        reflectivity=np.ones(3, np.float32), edgetint=np.ones(3, np.float32))],
        "cpu")
    n = 200000
    g = np.random.default_rng(0)
    xi = torch.as_tensor(g.random((TB.N_SAMPLE_DRAWS, n), dtype=np.float32))

    def rep(v):
        return torch.tensor(v, dtype=torch.float32).expand(n, 3)

    wi, pdf, atten, valid = TB.bsdf_sample(
        tables, tex.build("cpu"), (int(BsdfType.CONDUCTOR),),
        torch.zeros(n, dtype=torch.int32), rep([0.714, 0.0, 0.7]),
        rep([0.0, 0.0, 1.0]), rep([1.0, 0.0, 0.0]), rep([0.0, 1.0, 0.0]),
        torch.zeros(n, dtype=torch.bool), torch.zeros(n, 2), xi,
        kc=TK.get_tables("cpu"))
    w = torch.where(valid, atten[:, 0] / torch.clamp(pdf, min=1e-12),
                    torch.zeros_like(pdf)).numpy()
    v = valid.numpy()
    assert v.mean() > 0.6
    assert 0.9 < w[v].mean() < 1.2, (rough, w[v].mean())
    assert w.mean() > 0.7


def test_is_connectible_matches_reference():
    tex = TextureBuilder()
    infos = [row for fam in FAMILIES for row in family_rows(fam, tex)]
    infos.append(BsdfInfo(btype=BsdfType.CONDUCTOR))  # unset alphas
    (tt, ttex), (jt, jtex) = both_tables(infos, tex)
    bid, *_, uv, _ = lanes(len(infos), seed=14)
    for min_alpha in (0.05, 0.2):
        got = TB.is_connectible(tt, ttex, _t(bid), _t(uv), min_alpha)
        want = JB.is_connectible(jt, jtex, _j(bid), _j(uv), min_alpha)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.float().mean() < 1


def test_orient_frame_flips_inside_on_back_faces():
    """A back-face hit on a dielectric: the stored normal faces away from
    wo, orient_frame flips it and toggles `inside`, and the sampled
    refraction bends by eta or 1/eta as the reference's does."""
    tex = TextureBuilder()
    a = tex.add_constant([0.001] * 3)
    infos = [BsdfInfo(btype=BsdfType.DIELECTRIC, eta=1.5, id_roughness_u=a,
                      id_roughness_v=a)]
    (tt, ttex), (jt, jtex) = both_tables(infos, tex)
    n = 8
    wo = np.tile(np.array([0.6, 0.0, 0.8], np.float32), (n, 1))
    up = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (n, 1))
    nrm = np.where((np.arange(n) % 2 == 0)[:, None], up, -up)
    inside = np.arange(n) % 4 >= 2
    tan = np.tile(np.array([1.0, 0.0, 0.0], np.float32), (n, 1))
    bit = np.tile(np.array([0.0, 1.0, 0.0], np.float32), (n, 1))
    uv = np.zeros((n, 2), np.float32)
    xi = np.full((TB.N_SAMPLE_DRAWS, n), 0.5, np.float32)
    xi[2] = 0.99  # refract wherever refraction exists
    n_t, in_t = TB.orient_frame(_t(nrm), _t(tan), _t(bit), _t(inside), _t(wo))
    n_j, in_j = JB.orient_frame(_j(nrm), _j(tan), _j(bit), _j(inside), _j(wo))
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    np.testing.assert_array_equal(in_t.numpy(), np.asarray(in_j))
    np.testing.assert_array_equal(in_t.numpy(), inside ^ (nrm[:, 2] < 0))
    bid = np.zeros(n, np.int32)
    args = (bid, wo, nrm, tan, bit, inside, uv, xi)
    kc_t, kc_j = _kc_pair()
    wi, pdf, atten, valid = TB.bsdf_sample(tt, ttex, (4,), *map(_t, args),
                                           kc=kc_t)
    want = JB.bsdf_sample(jt, jtex, (4,), *map(_j, args), kc=kc_j)
    for g, w in zip((wi, pdf, atten, valid), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    # sin(theta_t) = 0.6 * eta_inv: entering (inside False after the
    # flip) bends toward the normal, leaving (inside True) away from it
    sin_t = np.abs(wi.numpy()[:, 0])
    entering = ~in_t.numpy()
    np.testing.assert_allclose(sin_t[entering & valid.numpy()], 0.6 / 1.5,
                               rtol=1e-2)
    leaving = in_t.numpy() & valid.numpy()
    assert leaving.sum() == 0 or np.allclose(sin_t[leaving], 0.9, rtol=1e-2)
