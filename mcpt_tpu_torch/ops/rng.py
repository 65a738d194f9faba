"""Counter-based RNG, bit-equal to mcpt_tpu/ops/rng.py.

Per-pixel Tea<4>(3 * pixel, frame) seeding, then a 32-bit LCG (csrt
include/csrt/utils/math.hpp:43-63), so every ray's sample stream is a
pure function of (pixel, frame).

uint32 arithmetic is carried in int64 tensors masked to 32 bits: torch's
uint32 dtype lacks the CUDA shift/multiply kernels this needs, and every
intermediate here stays below 2^63.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_TEA_DELTA = 0x9E3779B9
_LCG_MUL = 1664525
_LCG_ADD = 1013904223


def as_u32(x, device=None) -> torch.Tensor:
    """int64 tensor holding `x` modulo 2^32; a Python int is filled on
    `device`, with no copy from the host (a CUDA graph's capture refuses
    one)."""
    if isinstance(x, int):
        return torch.full((), x & _MASK, dtype=torch.int64, device=device)
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _MASK


def tea(v0, v1, rounds: int = 4) -> torch.Tensor:
    """TEA-based hash of two uint32s (csrt math.hpp:43-54)."""
    v0 = as_u32(v0)
    v1 = as_u32(v1, v0.device)
    s0 = 0
    for _ in range(rounds):
        s0 = (s0 + _TEA_DELTA) & _MASK
        v0 = (v0 + (
            (((v1 << 4) + 0xA341316C) & _MASK)
            ^ ((v1 + s0) & _MASK)
            ^ (((v1 >> 5) + 0xC8013EA4) & _MASK)
        )) & _MASK
        v1 = (v1 + (
            (((v0 << 4) + 0xAD90777D) & _MASK)
            ^ ((v0 + s0) & _MASK)
            ^ (((v0 >> 5) + 0x7E95761E) & _MASK)
        )) & _MASK
    return v0


def random_float(state: torch.Tensor):
    """One LCG draw in [0, 1) (csrt math.hpp:58-63).

    Returns (new_state, sample); shapes follow `state`."""
    state = (state * _LCG_MUL + _LCG_ADD) & _MASK
    sample = (state & 0x00FFFFFF).to(torch.float32) * (1.0 / 16777216.0)
    return state, sample


def random_floats(state: torch.Tensor, n: int):
    """Draw `n` samples per lane; returns (state, [n, ...] tensor)."""
    outs = []
    for _ in range(n):
        state, x = random_float(state)
        outs.append(x)
    return state, torch.stack(outs, dim=0)


def van_der_corput_base2(index) -> torch.Tensor:
    """Radical inverse in base 2 of uint32 `index` (bit reversal / 2^32)."""
    i = as_u32(index)
    i = ((i & 0x55555555) << 1) | ((i & 0xAAAAAAAA) >> 1)
    i = ((i & 0x33333333) << 2) | ((i & 0xCCCCCCCC) >> 2)
    i = ((i & 0x0F0F0F0F) << 4) | ((i & 0xF0F0F0F0) >> 4)
    i = ((i & 0x00FF00FF) << 8) | ((i & 0xFF00FF00) >> 8)
    i = ((i << 16) | (i >> 16)) & _MASK
    # hi24 * 2^-24 and lo8 * 2^-32 are both exact in f32; one rounding
    # on the add, as in the reference
    hi = (i >> 8).to(torch.float32)
    lo = (i & 0xFF).to(torch.float32)
    return hi * 5.960464477539063e-08 + lo * 2.3283064365386963e-10


def pixel_seed(pixel_index, frame=0) -> torch.Tensor:
    """Tea<4>(3 * pixel_index, frame) (csrt renderer.cpp:65-66)."""
    p = as_u32(pixel_index)
    return tea((p * 3) & _MASK, as_u32(frame, p.device))
