"""The port's textures (models/texture.py) and the per-column texture
narrowing of its BSDF tables against mcpt_tpu, on the CPU.

* The tables and the RGBA atlas equal bit for bit: constant,
  checkerboard and bitmap textures; mono, RGB and RGBA sources (mono
  copied to RGB, alpha 1 where the source has none); uv transforms;
  bitmap_pixels returns the registered pixels.
* eval_color, eval_scalar and eval_opacity per lane on 4096 seeded uvs
  in [-2.5, 2.5)^2 (so that the bitmaps wrap around and the checker
  crosses zero), over tables of every kind and of each kind alone
  (`kinds` narrowed): rtol 1e-5, atol 1e-6, and at most TEXEL_SHARE
  (0.5%) of lanes beyond it.  x - floor(x / w) * w and the int casts of
  uv * size land on the other side of a texel edge when the reference's
  XLA contracts a multiply-add and torch does not, which moves a
  bilinear fetch by a texel and flips a checker cell.
* eval_gradient (the bump maps' forward difference at 1e-4) multiplies
  those ulps by 1e4: held at atol 2e-2 on lanes away from the edges,
  with the same share.
* Column kinds: the port's per-column kinds and surface kinds equal the
  reference's, and a BSDF evaluation with the narrowed kinds equals the
  same evaluation with every kind (the reference's TestColumnKinds).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcpt_tpu.models import bsdf as JB
from mcpt_tpu.models import texture as JT
from mcpt_tpu_torch.models import bsdf as TB
from mcpt_tpu_torch.models import texture as TT
from mcpt_tpu_torch.scene.ir import BsdfInfo, BsdfType
from tests.test_torch_scene import to_jax_config

N = 4096
TEXEL_SHARE = 0.005


def _builder(kinds=(1, 2, 3)):
    """A texture list of the given kinds: constants; checkerboards with
    and without a uv transform; mono, RGB and RGBA bitmaps of odd sizes,
    one with a rotating, offset uv transform."""
    r = np.random.default_rng(0)
    tb = TT.TextureBuilder()
    if 1 in kinds:
        tb.add_constant([0.3, 0.5, 0.7])
        tb.add_constant(0.25)
    if 2 in kinds:
        tb.add_checkerboard([0.9, 0.8, 0.1], [0.1, 0.2, 0.3])
        tb.add_checkerboard([1, 1, 1], [0, 0, 0],
                            uv_transform=[4, 1, 0.3, -1, 6, 0.1])
    if 3 in kinds:
        tb.add_bitmap(r.random((7, 5), dtype=np.float32))
        tb.add_bitmap(r.random((9, 13, 3), dtype=np.float32),
                      uv_transform=[0.8, 0.6, 0.25, -0.6, 0.8, 0.5])
        rgba = r.random((6, 11, 4), dtype=np.float32)
        rgba[..., 3] = (rgba[..., 3] > 0.5).astype(np.float32)
        tb.add_bitmap(rgba)
        tb.add_bitmap(r.random((4, 4, 1), dtype=np.float32) * 3.0)
    return tb


def _tables(kinds=(1, 2, 3)):
    tb = _builder(kinds)
    return tb, tb.build("cpu"), to_jax_config(tb).build()


def _lanes(n_tex, seed=1):
    r = np.random.default_rng(seed)
    tid = r.integers(0, n_tex, N).astype(np.int32)
    uv = r.uniform(-2.5, 2.5, (N, 2)).astype(np.float32)
    return tid, uv


def test_tables_and_atlas_equal_the_reference():
    tb, t, j = _tables()
    for f in TT.TextureTables._fields[:-1]:
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    assert t.kinds == j.kinds == (1, 2, 3)
    assert t.atlas.shape == (35 + 117 + 66 + 16, 4)
    # mono copied to RGB with alpha 1; RGB with alpha 1; RGBA kept
    mono = t.atlas[:35].numpy()
    assert (mono[:, 0] == mono[:, 1]).all() and (mono[:, 3] == 1).all()
    assert (t.atlas[35:152, 3] == 1).all()
    jb = to_jax_config(tb)
    for tid in (4, 5, 6, 7):
        np.testing.assert_array_equal(tb.bitmap_pixels(tid),
                                      jb.bitmap_pixels(tid))
    empty = TT.TextureBuilder().build("cpu")
    assert empty.kinds == () and empty.atlas.shape == (1, 4)


def _share_close(got, want, rtol=1e-5, atol=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all()
    if got.ndim == 1:
        got, want = got[:, None], want[:, None]
    bad = ~np.isclose(got, want, rtol=rtol, atol=atol).all(axis=-1)
    assert bad.mean() <= TEXEL_SHARE, bad.mean()
    return bad


@pytest.mark.parametrize("kinds", [(1,), (2,), (3,), (1, 2, 3)],
                         ids=["constant", "checker", "bitmap", "all"])
def test_eval_color_scalar_opacity_match_reference(kinds):
    _, t, j = _tables(kinds)
    assert t.kinds == kinds
    tid, uv = _lanes(t.ttype.shape[0])
    args_t = (torch.as_tensor(tid), torch.as_tensor(uv))
    args_j = (jnp.asarray(tid), jnp.asarray(uv))
    for fn in ("eval_color", "eval_scalar", "eval_opacity"):
        got = getattr(TT, fn)(t, *args_t)
        want = getattr(JT, fn)(j, *args_j)
        assert got.shape == want.shape, fn
        _share_close(got.numpy(), want)
    if 3 in kinds:  # an RGBA mask has both alphas; the rest alpha 1
        alpha = TT.eval_opacity(t, *args_t).numpy()
        assert (alpha < 0.5).any() and (alpha > 0.5).any()


def test_eval_gradient_matches_reference():
    _, t, j = _tables()
    tid, uv = _lanes(t.ttype.shape[0], seed=2)
    got = TT.eval_gradient(t, torch.as_tensor(tid), torch.as_tensor(uv))
    want = np.asarray(JT.eval_gradient(j, jnp.asarray(tid), jnp.asarray(uv)))
    assert got.shape == (N, 2)
    _share_close(got.numpy(), want, rtol=1e-3, atol=2e-2)
    # bitmaps have slopes; constants none
    assert np.abs(want[tid >= 4]).max() > 1.0
    assert not got.numpy()[tid < 2].any()


def test_column_kinds_narrow_without_changing_values():
    """tests/test_features.py::TestColumnKinds in the port, and the kinds
    equal to the reference's."""
    r = np.random.default_rng(5)
    tb = TT.TextureBuilder()
    t_rough = tb.add_constant([0.3, 0.3, 0.3])
    t_albedo = tb.add_bitmap((r.random((8, 8, 3)) * 0.8).astype(np.float32))
    t_bump = tb.add_checkerboard([1, 1, 1], [0.5, 0.5, 0.5])
    infos = [BsdfInfo(btype=BsdfType.ROUGH_DIFFUSE,
                      id_diffuse_reflectance=t_albedo, id_roughness=t_rough,
                      id_bump_map=t_bump)]
    tex = tb.build("cpu")
    tables = TB.build_bsdf_tables(infos, "cpu", tb.infos)
    jinfos, jtb = to_jax_config([infos, tb])
    assert tables.col_kinds == JB.build_bsdf_tables(jinfos, jtb.infos).col_kinds
    ck = dict(tables.col_kinds)
    assert ck["diffuse"] == (3,) and ck["roughness"] == (1,)
    assert ck["bump"] == (2,) and ck["opacity"] == ()

    n = 256
    bid = torch.zeros(n, dtype=torch.int32)
    nrm = torch.tensor([0.0, 0.0, 1.0]).expand(n, 3)
    tan = torch.tensor([1.0, 0.0, 0.0]).expand(n, 3)
    bit = torch.tensor([0.0, 1.0, 0.0]).expand(n, 3)
    inside = torch.zeros(n, dtype=torch.bool)
    uv = torch.as_tensor(r.random((n, 2), dtype=np.float32))
    wo = torch.tensor([0.0, 0.3, 0.954]).expand(n, 3)
    wi = -torch.tensor([0.3, 0.0, 0.954]).expand(n, 3)
    present = (int(BsdfType.ROUGH_DIFFUSE),)
    narrow = TB.bsdf_evaluate(tables, tex, present, bid, wi, wo, nrm, tan,
                              bit, inside, uv)
    full = TB.bsdf_evaluate(tables._replace(col_kinds=()), tex, present, bid,
                            wi, wo, nrm, tan, bit, inside, uv)
    for a, b in zip(narrow, full):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
