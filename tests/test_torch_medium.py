"""mcpt_tpu_torch/models/medium.py against mcpt_tpu/models/medium.py on the
CPU.

* build_medium_tables: every leaf equal (the same numpy host commit), for
  no medium, isotropic, Henyey-Greenstein, pure absorbers, channel-wise
  albedos below and above the 0.5 clamp.
* The stage math on the same seeded numpy inputs, 4096 lanes: a quarter
  of the lanes in vacuum (mid = -1), the rest over four media (isotropic,
  and HG with g = -0.5, 0, 1e-9 and 0.7 in the three channels, so that
  the |g| < EPSILON_FLOAT branch is taken per channel), distances from
  1e-3 up to MAX_FLOAT.  Every lane is compared:
  - the decisions (scattered, valid) equal;
  - distances, weights, pdfs and directions allclose at rtol 1e-5,
    atol 1e-6 (XLA contracts multiply-adds into FMAs, torch rounds each
    op; log1p, exp, sin and cos differ by ulps between the two).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcpt_tpu.models.medium as JM
import mcpt_tpu.scene.ir as jir
import mcpt_tpu_torch.models.medium as TM
import mcpt_tpu_torch.scene.ir as tir
from mcpt_tpu_torch.ops.math import MAX_FLOAT

RTOL, ATOL = 1e-5, 1e-6
N = 4096


def _infos(ir):
    m = ir.MediumInfo
    return {
        "none": [],
        "isotropic": [m(sigma_a=np.full(3, 0.05, np.float32),
                        sigma_s=np.full(3, 0.35, np.float32))],
        "hg": [m(sigma_a=np.array([0.1, 0.2, 0.3], np.float32),
                 sigma_s=np.array([0.9, 0.5, 0.2], np.float32), phase="hg",
                 g=np.array([-0.5, 0.0, 0.7], np.float32))],
        "mixed": [
            m(sigma_a=np.full(3, 0.05, np.float32),
              sigma_s=np.full(3, 0.35, np.float32)),
            m(sigma_a=np.array([0.1, 0.2, 0.3], np.float32),
              sigma_s=np.array([0.9, 0.5, 0.2], np.float32), phase="hg",
              g=np.array([-0.5, 0.0, 0.7], np.float32)),
            m(sigma_a=np.array([2.0, 0.5, 0.0], np.float32),
              sigma_s=np.array([0.0, 0.1, 0.0], np.float32), phase="hg",
              g=np.array([1e-9, -0.5, 0.7], np.float32)),
            m(sigma_a=np.array([0.0, 0.0, 1.0], np.float32),
              sigma_s=np.array([3.0, 0.2, 0.01], np.float32), phase="hg",
              g=np.array([0.7, 1e-9, 0.0], np.float32)),
        ],
        "absorber": [m(sigma_a=np.full(3, 1.5, np.float32))],
    }


def _tables(name):
    return (TM.build_medium_tables(_infos(tir)[name], "cpu"),
            JM.build_medium_tables(_infos(jir)[name]))


@pytest.mark.parametrize("name", ["none", "isotropic", "hg", "mixed",
                                  "absorber"])
def test_build_medium_tables_leaf_for_leaf(name):
    got, ref = _tables(name)
    for field in TM.MediumTables._fields:
        a, b = getattr(got, field).numpy(), np.asarray(getattr(ref, field))
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    if name == "mixed":  # albedo 0.857, 0.9, 0.167 clamped to 0.5, 3/3
        np.testing.assert_allclose(got.sampling_weight.numpy(),
                                   [0.875, 0.9, 0.5, 1.0], rtol=1e-6)


def _lanes(seed=3, rows=4):
    r = np.random.default_rng(seed)
    mid = r.integers(-1, rows, N).astype(np.int32)
    mid[: N // 4] = -1
    dist = np.exp(r.uniform(np.log(1e-3), np.log(50.0), N)).astype(np.float32)
    dist[r.random(N) < 0.1] = MAX_FLOAT
    xi = r.random((3, N)).astype(np.float32)
    xi[0, :8] = 0.0          # the largest flight the clamp allows
    xi[0, 8:16] = 0.9999999  # and a draw past 1 - 1e-7 once divided by sw
    w = r.normal(size=(2, N, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    return mid, dist, xi, w[0], w[1]


def _t(x):
    return torch.as_tensor(x)


def _close(got, ref, name):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL, err_msg=name)


def test_sample_flight_matches_reference():
    tt, jt = _tables("mixed")
    mid, dist, xi, _, _ = _lanes()
    got = TM.sample_flight(tt, _t(mid), _t(dist), _t(xi[0]), _t(xi[1]))
    ref = JM.sample_flight(jt, jnp.asarray(mid), jnp.asarray(dist),
                           jnp.asarray(xi[0]), jnp.asarray(xi[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    for i, name in ((1, "distance"), (2, "weight")):
        _close(got[i], ref[i], name)
    scattered, valid = got[0].numpy(), got[3].numpy()
    # both branches and the vacuum identity are exercised
    assert scattered.any() and (~scattered & (mid >= 0)).any()
    assert not valid.all()  # the absorber underflows far out
    np.testing.assert_array_equal(got[2].numpy()[mid < 0], 1.0)
    assert not scattered[mid < 0].any()


def test_eval_transmittance_matches_reference():
    tt, jt = _tables("mixed")
    mid, dist, _, _, _ = _lanes(4)
    got = TM.eval_transmittance(tt, _t(mid), _t(dist))
    ref = JM.eval_transmittance(jt, jnp.asarray(mid), jnp.asarray(dist))
    _close(got[0], ref[0], "weight")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert not got[1].numpy().all()


@pytest.mark.parametrize("tables", ["isotropic", "mixed"])
def test_sample_phase_matches_reference(tables):
    tt, jt = _tables(tables)
    mid, _, xi, wo, _ = _lanes(5, tt.g.shape[0])
    got = TM.sample_phase(tt, _t(mid), _t(wo), *(_t(x) for x in xi))
    ref = JM.sample_phase(jt, jnp.asarray(mid), jnp.asarray(wo),
                          *(jnp.asarray(x) for x in xi))
    for i, name in ((0, "wi"), (1, "pdf"), (2, "atten")):
        _close(got[i], ref[i], name)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    np.testing.assert_allclose(np.linalg.norm(got[0].numpy(), axis=-1), 1.0,
                               rtol=1e-5)


@pytest.mark.parametrize("tables", ["isotropic", "mixed"])
def test_eval_phase_matches_reference(tables):
    tt, jt = _tables(tables)
    mid, _, _, wo, wi = _lanes(6, tt.g.shape[0])
    got = TM.eval_phase(tt, _t(mid), _t(wi), _t(wo))
    ref = JM.eval_phase(jt, jnp.asarray(mid), jnp.asarray(wi),
                        jnp.asarray(wo))
    for i, name in ((0, "pdf"), (1, "atten")):
        _close(got[i], ref[i], name)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


def test_empty_tables_are_the_vacuum_row():
    got, ref = TM.empty_medium_tables("cpu"), JM.empty_medium_tables()
    for field in TM.MediumTables._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(ref, field)))
    assert TM.N_FLIGHT_DRAWS == JM.N_FLIGHT_DRAWS == 2
    assert TM.N_PHASE_DRAWS == JM.N_PHASE_DRAWS == 3
    assert (TM.PHASE_ISOTROPIC, TM.PHASE_HG) == (JM.PHASE_ISOTROPIC,
                                                  JM.PHASE_HG)
