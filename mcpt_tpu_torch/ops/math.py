"""Vector math kit (counterpart of mcpt_tpu/ops/math.py, the subset the
path integrator and the BSDFs use).

Points and vectors are `[..., 3]` tensors; every helper broadcasts over
leading batch dims so one call shades a whole wavefront.
"""

from __future__ import annotations

import torch

# Constants (csrt include/csrt/utils/math.hpp:15-22)
PI = 3.141592653589793
TWO_PI = 2.0 * PI
INV_PI = 1.0 / PI
INV_TWO_PI = 1.0 / TWO_PI
INV_FOUR_PI = 1.0 / (4.0 * PI)
MAX_FLOAT = 3.4028234663852886e38  # float32 max (the reference's 3.4028235e38)
EPSILON = 0.01            # csrt kEpsilon — pdf/throughput cutoff
EPSILON_FLOAT = 1.1920929e-7   # FLT_EPSILON
EPSILON_DISTANCE = 1e-4   # ray t_min / shadow offset


def to_radians(deg):
    return deg * (PI / 180.0)


def rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for an in-range integer index of any shape, by
    index_select: the same gather, whose backward accumulates with
    index_add (atomics) where advanced indexing's sorts the indices and
    adds each row's duplicates in turn — ~10 ms a call on the card when
    65536 lanes read a few rows of a parameter table."""
    out = table.index_select(0, idx.reshape(-1).long())
    return out.reshape(idx.shape + table.shape[1:])


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``; rows outside [0, T) read as zeros.

    The reference's one-hot contraction (mcpt_tpu/ops/math.py:37) exists
    because TPU gathers serialize; on a GPU a plain index gather is the
    cheap form."""
    t = table.shape[0]
    inside = (idx >= 0) & (idx < t)
    out = rows(table, idx.clamp(0, t - 1))
    mask = inside.reshape(inside.shape + (1,) * (table.dim() - 1))
    return torch.where(mask, out, torch.zeros((), dtype=out.dtype, device=out.device))


def channel_sum(x):
    """The sum over the (short) trailing axis, added in index order:
    x[..., 0] + x[..., 1] + ...  torch's sum over the last axis adds the
    terms in another order on the card than on the CPU (30% of 3-wide
    lanes differ, `tools/device_rounding.py`)."""
    first, *rest = x.unbind(-1)
    for term in rest:
        first = first + term
    return first


def dot(a, b, keepdim: bool = False):
    """Batched dot product over the trailing axis, in channel_sum's
    order."""
    s = channel_sum(a * b)
    return s[..., None] if keepdim else s


def _in_f64(fn):
    """`fn` evaluated in float64 and rounded to float32.  torch's float32
    exp, log1p, sin, cos, tan, atan, atan2 and acos give other bits on
    the card than on the CPU in 7-36% of lanes (an ulp each,
    `tools/device_rounding.py`); in float64 both land within rounding of
    the exact value, so the float32 results agree.  A glass sphere's
    chains of refractions and the fog's free flights turn one ulp into
    another path, so renders on the two devices agree only with this."""
    def stable(*args):
        return fn(*(a.double() for a in args)).float()

    stable.__name__ = fn.__name__
    stable.__doc__ = f"torch.{fn.__name__} in float64, rounded to float32."
    return stable


def _sqrt(x):
    return torch.sqrt(x) if x.is_cuda else torch.sqrt(x.double()).float()


class _Sqrt(torch.autograd.Function):
    """_sqrt with a gradient of 0 where the root is 0 (and not 1 / 0):
    the estimator takes roots of clamped expressions on lanes whose
    result a where() drops, and an infinite derivative there turns the
    dropped lane's zero gradient into NaN (0 x inf), which then spreads
    to every parameter the lane read (the reference's NaN gradients)."""

    @staticmethod
    def forward(ctx, x):
        y = _sqrt(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return torch.where(y > 0.0, g / (2.0 * y), torch.zeros_like(g))


def sqrt(x):
    """The correctly rounded float32 square root on either device: the
    card's own (IEEE), and on the CPU, whose vectorized float32 sqrt is
    an ulp off in ~0.7% of lanes, through float64 (a float64 root rounds
    to the correctly rounded float32 one).  Under autograd its derivative
    at 0 is 0 (_Sqrt)."""
    if x.requires_grad and torch.is_grad_enabled():
        return _Sqrt.apply(x)
    return _sqrt(x)


exp = _in_f64(torch.exp)
log1p = _in_f64(torch.log1p)
sin = _in_f64(torch.sin)
cos = _in_f64(torch.cos)
tan = _in_f64(torch.tan)
atan = _in_f64(torch.atan)
_atan2 = _in_f64(torch.atan2)
_arccos = _in_f64(torch.arccos)


class _Arccos(torch.autograd.Function):
    """_arccos with a gradient of 0 at |x| = 1, where the derivative is
    infinite: a direction exactly along an envmap's pole (a cosine sample
    with cos theta rounded to 1) otherwise turns a zero cotangent into
    NaN (see _Sqrt)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _arccos(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        s = 1.0 - x.double() * x.double()
        return torch.where(s > 0.0, -g.double() / torch.sqrt(
            torch.where(s > 0.0, s, torch.ones_like(s))),
            torch.zeros_like(s)).float()


class _Atan2(torch.autograd.Function):
    """_atan2 with a gradient of 0 at (0, 0), where it is 0 / 0."""

    @staticmethod
    def forward(ctx, y, x):
        ctx.save_for_backward(y, x)
        return _atan2(y, x)

    @staticmethod
    def backward(ctx, g):
        y, x = (a.double() for a in ctx.saved_tensors)
        r2 = x * x + y * y
        k = torch.where(r2 > 0.0, g.double() / torch.where(
            r2 > 0.0, r2, torch.ones_like(r2)), torch.zeros_like(r2))
        return (k * x).float(), (-k * y).float()


def arccos(x):
    """torch.arccos in float64, rounded to float32; under autograd its
    derivative at |x| = 1 is 0 (_Arccos)."""
    if x.requires_grad and torch.is_grad_enabled():
        return _Arccos.apply(x)
    return _arccos(x)


def atan2(y, x):
    """torch.atan2 in float64, rounded to float32; under autograd its
    derivative at (0, 0) is 0 (_Atan2)."""
    if (y.requires_grad or x.requires_grad) and torch.is_grad_enabled():
        return _Atan2.apply(y, x)
    return _atan2(y, x)


def cross(a, b):
    """a x b over the trailing axis, each product rounded on its own (a
    fused kernel may contract a1*b2 - a2*b1 into one multiply-add on the
    card, and not on the CPU)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def mat_vec(m, v):
    """The 3x3 part of m [..., 4 or 3, 4 or 3] applied to vectors
    v [..., 3], as x, y and z terms added in that order with each product
    rounded on its own: the same bits on the card and the CPU, which a
    matmul does not promise.  k stacked matrices [k, r, r] against
    v [N, 3] or [k, N, 3] give [k, N, 3]."""
    c = m[..., :3, :3]
    if c.dim() == 3:
        c = c[:, None]
    return (v[..., 0:1] * c[..., 0] + v[..., 1:2] * c[..., 1]
            + v[..., 2:3] * c[..., 2])


def length(v, keepdim: bool = False):
    return sqrt(torch.clamp(dot(v, v, keepdim=keepdim), min=1e-20))


def normalize(v):
    return v * (1.0 / length(v, keepdim=True))


def sqr(x):
    return x * x


def lerp(a, b, t):
    return (1.0 - t) * a + t * b


def reflect(wi, n):
    """Mirror `wi` about `n` (csrt src/rtcore/ray.cpp:49-52).  `wi` points
    into the surface; the result points away on the same side."""
    return normalize(wi - 2.0 * dot(wi, n, keepdim=True) * n)


def refract(wi, n, eta_inv):
    """Refract `wi` through the interface with normal `n` (csrt
    src/rtcore/ray.cpp:55-69); `eta_inv` ([...] or scalar) is the IOR of
    the incident side over the transmitted side.  Returns (ok, wt); ok is
    False on total internal reflection, where wt is unspecified."""
    eta_inv = torch.as_tensor(eta_inv, dtype=wi.dtype, device=wi.device)[..., None]
    cos_theta = torch.abs(dot(wi, n, keepdim=True))
    k = 1.0 - sqr(eta_inv) * (1.0 - sqr(cos_theta))
    ok = (k >= 0.0)[..., 0]
    k = torch.clamp(k, min=0.0)
    wt = normalize(eta_inv * wi + (eta_inv * cos_theta - sqrt(k)) * n)
    return ok, wt


def mis_weight(pdf1, pdf2):
    """Power-2 heuristic (csrt src/utils/math.cpp:8-13), in the
    reference's scale-normalized form: both pdfs divided by their max so
    huge pdfs on masked lanes cannot overflow f32 in the squares."""
    m = torch.clamp(torch.maximum(pdf1, pdf2), min=1e-15)
    a = sqr(pdf1 / m)
    b = sqr(pdf2 / m)
    return a / torch.clamp(a + b, min=1e-30)


def build_onb(n):
    """Orthonormal basis (t, b) around unit normal `n` matching the
    reference's local_to_world frame: to_world(v) = v.x*t + v.y*b + v.z*n."""
    ux, uy, uz = n[..., 0], n[..., 1], n[..., 2]
    len_xz = sqrt(sqr(ux) + sqr(uz))
    use_xz = len_xz > EPSILON_FLOAT
    inv_xz = 1.0 / torch.clamp(len_xz, min=1e-12)
    len_yz = sqrt(sqr(uy) + sqr(uz))
    inv_yz = 1.0 / torch.clamp(len_yz, min=1e-12)
    zero = torch.zeros_like(ux)
    b = torch.where(
        use_xz[..., None],
        torch.stack([uz * inv_xz, zero, -ux * inv_xz], dim=-1),
        torch.stack([zero, uz * inv_yz, -uy * inv_yz], dim=-1),
    )
    t = normalize(cross(b, n))
    return t, b


def to_local(v, t, b, n):
    """Project a world vector into the (t, b, n) frame, normalized
    (csrt BsdfSampleRec::ToLocal, bsdf.cpp:104-107)."""
    return normalize(torch.stack([dot(v, t), dot(v, b), dot(v, n)], dim=-1))


def to_world(v, t, b, n):
    """Inverse of :func:`to_local` (bsdf.cpp:109-112)."""
    return normalize(v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n)


def cartesian_to_spherical(v):
    """(theta, phi) in the reference's (right, up=y, front) convention:
    theta from +y, phi = atan2(z, x) in [0, 2pi) (csrt
    src/utils/math.cpp:100-118)."""
    v = normalize(v)
    theta = arccos(torch.clamp(v[..., 1], -1.0, 1.0))
    phi = atan2(v[..., 2], v[..., 0])
    phi = torch.where(phi < 0.0, phi + TWO_PI, phi)
    return theta, phi


def spherical_to_cartesian(theta, phi, r=1.0):
    """The exact inverse of :func:`cartesian_to_spherical` (the reference's
    consistent form, not csrt's x/z-swapped SphericalToCartesian)."""
    sin_t = sin(theta)
    return torch.stack([r * cos(phi) * sin_t, r * cos(theta),
                        r * sin(phi) * sin_t], dim=-1)


def local_to_world(local, up):
    """Rotate a z-up local vector into the frame whose +z is `up` (csrt
    src/utils/math.cpp:129-144)."""
    t, b = build_onb(up)
    # build_onb's (t, b) are local_to_world's (b, c)
    return normalize(local[..., 0:1] * t + local[..., 1:2] * b
                     + local[..., 2:3] * up)


def transform_point(m, p):
    """A 4x4 row-major transform [4, 4] applied to points [..., 3]."""
    ph = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)
    out = torch.einsum("ij,...j->...i", m, ph)
    return out[..., :3] / out[..., 3:4]


def transform_vector(m, v):
    """The linear part of a 4x4 transform applied to directions,
    normalized (csrt mat4 TransformVector)."""
    return normalize(mat_vec(m, v))
