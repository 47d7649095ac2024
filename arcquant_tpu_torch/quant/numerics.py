"""Golden NVFP4 numerics in PyTorch.

Counterpart of ``arcquant_tpu/quant/numerics.py`` for the formats the
serving path uses: e2m1 elements, ue4m3 group scales and the NVFP4
global scale. The functions are plain tensor code; the CUDA kernels in
``csrc/`` reproduce them bit for bit.

The JAX package's documented deviations from the upstream reference
hold here unchanged:
  1. e2m1 ties round toward the smaller magnitude (strict ``>`` against
     boundary * scale);
  2. ue4m3 scales round to nearest even after a clamp to [2^-9, 448];
  3. element rounding compares in product space, and scale divisions
     multiply by the f32-rounded reciprocal constants below.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# Positive representable magnitudes of FP4 E2M1 and the midpoints
# between consecutive magnitudes.
E2M1_MAGNITUDES = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0)
E2M1_BOUNDARIES = (0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0)
E2M1_MAX = 6.0

UE4M3_MAX = 448.0
UE4M3_MIN = 2.0 ** -9  # smallest e4m3fn subnormal

NVFP4_GLOBAL_DIV = UE4M3_MAX * E2M1_MAX  # 2688.0
NVFP4_GROUP = 16

# f32-rounded reciprocals: scale math multiplies by these, never
# divides, so every implementation lands on the same grid.
INV_E2M1_MAX = float(np.float32(1.0) / np.float32(E2M1_MAX))
INV_NVFP4_GLOBAL_DIV = float(
    np.float32(1.0) / np.float32(NVFP4_GLOBAL_DIV))


@functools.lru_cache(maxsize=None)
def _const(values: tuple, dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """A small constant table, made once per device."""
    return torch.tensor(values, dtype=dtype, device=device)


def _e2m1_index(mag: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Magnitude index: the number of boundaries b with mag > b * scale
    (strict, so ties go to the smaller magnitude). One broadcast compare
    over the 7 boundaries; scale broadcasts against mag."""
    b = _const(E2M1_BOUNDARIES, torch.float32, mag.device)
    return (mag.unsqueeze(-1) > scale.unsqueeze(-1) * b).sum(
        dim=-1, dtype=torch.uint8)


def e2m1_encode(x: torch.Tensor) -> torch.Tensor:
    """FP4 E2M1 codes (uint8 in [0, 15]): bit 3 = sign, bits 2:0 =
    index into E2M1_MAGNITUDES. Ties round toward smaller magnitude."""
    idx = _e2m1_index(x.abs().float(), torch.ones((), device=x.device))
    return ((x < 0).to(torch.uint8) << 3) | idx


def e2m1_encode_scaled(x: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """e2m1 codes of x/scale without dividing: |x| > boundary*scale.
    The products are exact in f32 (boundaries <= 3 significant bits,
    ue4m3 scales <= 4), so this equals the exact quotient comparison."""
    idx = _e2m1_index(x.abs().float(), scale.float())
    return ((x < 0).to(torch.uint8) << 3) | idx


def e2m1_decode(codes: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """E2M1 codes back to values. The sign applies to zero too (code 8
    decodes to -0.0), as in the JAX package."""
    table = _const(E2M1_MAGNITUDES, torch.float32, codes.device)
    c = codes.long()
    sgn = 1.0 - ((c >> 3) << 1).float()
    return (table[c & 7] * sgn).to(dtype)


def quantize_ue4m3(s: torch.Tensor) -> torch.Tensor:
    """Round positive scales to fp8 e4m3fn values (qdq), clamped to
    [2^-9, 448]: round to nearest even through torch's float8_e4m3fn
    cast (the CUDA kernels compute the same rounding with f32 bit
    arithmetic, csrc/common.cuh:ue4m3_qdq)."""
    s = s.float().clamp(UE4M3_MIN, UE4M3_MAX)
    return s.to(torch.float8_e4m3fn).float()


def ue4m3_to_bytes(s: torch.Tensor) -> torch.Tensor:
    """ue4m3 values (already on the grid, or 0) to their e4m3fn bytes."""
    return s.float().to(torch.float8_e4m3fn).view(torch.uint8)


def ue4m3_from_bytes(b: torch.Tensor) -> torch.Tensor:
    """e4m3fn bytes (uint8) to f32 values, subnormals included."""
    e = ((b.int() >> 3) & 0xF).float()
    m = (b.int() & 7).float()
    normal = (1.0 + m / 8.0) * torch.exp2(e - 7.0)
    return torch.where(e == 0, m * 2.0 ** -9, normal)


def nvfp4_global_scale(x: torch.Tensor,
                       per_row: bool = False) -> torch.Tensor:
    """Global f32 scale absmax/(448*6), floored at 1e-12: one per
    tensor, or one per row ([M, 1]) with per_row."""
    a = x.abs()
    a = a.amax(dim=-1, keepdim=True) if per_row else a.amax()
    return torch.clamp(a.float() * INV_NVFP4_GLOBAL_DIV, min=1e-12)


def nvfp4_qdq_scaled(xs: torch.Tensor) -> torch.Tensor:
    """Group qdq of values already divided by the global scale (f32 in,
    f32 out): per-16 absmax/6 scale rounded to ue4m3, elements rounded
    to e2m1 in product space. The last dim must be a multiple of 16."""
    shape = xs.shape
    g = xs.float().reshape(*shape[:-1], shape[-1] // NVFP4_GROUP,
                           NVFP4_GROUP)
    mag = g.abs()
    scale = quantize_ue4m3(mag.amax(dim=-1, keepdim=True) * INV_E2M1_MAX)
    val = _const(E2M1_MAGNITUDES, torch.float32, g.device)[
        _e2m1_index(mag, scale).long()]
    return (torch.where(g < 0, -val, val) * scale).reshape(shape)


# -- the other formats: MXFP4, MXFP6, INT4, the asym KV quantizers ------------

MXFP4_GROUP = 32
MXFP6_GROUP = 32
INT4_GROUP = 128
E3M2_MAX = 28.0


def _xla_log(y: torch.Tensor) -> torch.Tensor:
    """f32 natural log of positive normal y, as XLA computes it on the
    CPU (the Cephes logf polynomial, every step an f32 operation): the
    JAX package's ue8m0 rounding runs this log, which is not exact at
    powers of two, so an exact log2 would round some scales to the other
    power of two."""
    bits = y.float().view(torch.int32)
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    low = m < 0.707106781186547524
    x = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    e = e - low.float()
    z = x * x
    p = torch.full_like(x, 7.0376836292e-2)
    for c in (-1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
              1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1,
              -2.4999993993e-1, 3.3333331174e-1):
        p = p * x + c
    p = p * x * z + e * -2.12194440e-4
    return e * 0.693359375 + (x + (p - z * 0.5))


def _xla_exp2_table() -> np.ndarray:
    """2^e for the integers e in [-127, 127] as XLA computes jnp.exp2 on
    the CPU: exp(e * f32(ln 2)) by the Cephes expf (range reduction with
    fused multiply-adds, exact here in f64), results below the smallest
    normal flushed to 0. From 2^13 on (and below 2^-12) these are not
    powers of two (2^13 gives 8192.004); the JAX package's MX scales are
    these values."""
    f = np.float32
    x = np.arange(-127, 128, dtype=np.float32) * f(0.693147182)
    fx = np.floor(x * f(1.44269504088896341) + f(0.5)).astype(np.float32)
    r = (fx.astype(np.float64) * -0.693359375 + x).astype(np.float32)
    r = (fx.astype(np.float64) * np.float64(f(2.12194440e-4))
         + r).astype(np.float32)
    z = r * r
    y = np.full_like(r, f(1.9875691500e-4))
    for c in (1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
              1.6666665459e-1, 5.0000001201e-1):
        y = y * r + f(c)
    y = (y * z + r) + f(1.0)
    out = y * ((fx.astype(np.int32) + 127) << 23).view(np.float32)
    return np.where(out < f(2.0 ** -126), f(0.0), out).astype(np.float32)


_XLA_EXP2 = tuple(float(v) for v in _xla_exp2_table())
_INV_LN2 = float(np.float32(1.0) / np.float32(np.log(2.0)))


def quantize_ue8m0(s: torch.Tensor) -> torch.Tensor:
    """Round positive scales up to a power of two (qdq): 2^ceil(log2(s +
    1e-9)), the exponent clamped to [-127, 127], with the JAX package's
    f32 log2 (XLA's log times f32(1 / ln 2)) and exp2 (_XLA_EXP2)."""
    e = torch.ceil(_xla_log(s.float() + 1e-9) * _INV_LN2).clamp(-127, 127)
    table = _const(_XLA_EXP2, torch.float32, s.device)
    return table[e.long() + 127]


def _e3m2_values() -> tuple:
    """Positive representable values of FP6 E3M2, ascending: subnormals
    {1,2,3}/16 and (1 + m/4) 2^(e-3) for e in 1..7, m in 0..3."""
    vals = [0.0, 0.0625, 0.125, 0.1875]
    for e in range(1, 8):
        for m in (1.0, 1.25, 1.5, 1.75):
            vals.append(m * 2.0 ** (e - 3))
    return tuple(sorted(set(vals)))


_E3M2 = _e3m2_values()
_E3M2_MIDS = tuple(float((np.float32(a) + np.float32(b)) / np.float32(2.0))
                   for a, b in zip(_E3M2[:-1], _E3M2[1:]))


def quantize_e3m2(x: torch.Tensor) -> torch.Tensor:
    """Round to the nearest E3M2 value (qdq); ties go to the smaller
    magnitude: the index counts the midpoints strictly below |x|, which
    is torch.bucketize with right=False."""
    mids = _const(_E3M2_MIDS, torch.float32, x.device)
    table = _const(_E3M2, torch.float32, x.device)
    xf = x.float()
    val = table[torch.bucketize(xf.abs(), mids, right=False)]
    sign = torch.where(xf == 0, xf, torch.sign(xf))   # jnp.sign(-0.) = -0.
    return (sign * val).to(x.dtype)


def int4_encode(x: torch.Tensor) -> torch.Tensor:
    """Round to the nearest integer (half to even) in [-8, 7], int8."""
    return torch.clamp(torch.round(x.float()), -8, 7).to(torch.int8)


def _group_reshape(x: torch.Tensor, group: int):
    """Zero-pad the last dim to a multiple of `group`; (groups [-1,
    group], pad)."""
    pad = (-x.shape[-1]) % group
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x.reshape(-1, group), pad


def _group_unshape(g: torch.Tensor, shape, pad: int) -> torch.Tensor:
    out = g.reshape(*shape[:-1], shape[-1] + pad)
    return out[..., :shape[-1]] if pad else out


def _absmax(g: torch.Tensor) -> torch.Tensor:
    return g.abs().amax(dim=-1, keepdim=True).float()


def nvfp4_qdq(x: torch.Tensor, group: int = NVFP4_GROUP) -> torch.Tensor:
    """NVFP4 qdq without a global scale: per-`group` absmax/6 rounded to
    ue4m3, elements to e2m1 in product space; x's dtype out."""
    g, pad = _group_reshape(x, group)
    scale = quantize_ue4m3(_absmax(g) * INV_E2M1_MAX)
    q = e2m1_decode(e2m1_encode_scaled(g.float(), scale)) * scale
    return _group_unshape(q.to(x.dtype), x.shape, pad)


def _mx_qdq(x, group, elem_max_div, qdq_elem):
    g, pad = _group_reshape(x, group)
    a = _absmax(g)
    scale = quantize_ue8m0(torch.where(a == 0, torch.full_like(a, 1e-9),
                                       elem_max_div(a)))
    q = qdq_elem(g.float() / scale) * scale
    return _group_unshape(q.to(x.dtype), x.shape, pad)


def mxfp4_qdq(x: torch.Tensor, group: int = MXFP4_GROUP) -> torch.Tensor:
    """MXFP4 qdq: e2m1 elements, per-32 absmax/6 scale rounded up to
    ue8m0."""
    return _mx_qdq(x, group, lambda a: a * INV_E2M1_MAX,
                   lambda v: e2m1_decode(e2m1_encode(v)))


def mxfp6_qdq(x: torch.Tensor, group: int = MXFP6_GROUP) -> torch.Tensor:
    """MXFP6 qdq: e3m2 elements, per-32 absmax/28 scale rounded up to
    ue8m0 (a division, as in the JAX package)."""
    return _mx_qdq(x, group, lambda a: a / E3M2_MAX, quantize_e3m2)


def int4_group_qdq(x: torch.Tensor, group: int = INT4_GROUP) -> torch.Tensor:
    """Symmetric INT4 qdq with a per-`group` absmax/7 scale (divisions,
    as in the JAX package)."""
    g, pad = _group_reshape(x, group)
    a = _absmax(g)
    scale = torch.where(a == 0, torch.full_like(a, 1e-9), a / 7.0)
    q = int4_encode(g.float() / scale).float() * scale
    return _group_unshape(q.to(x.dtype), x.shape, pad)


def _asym_groups(x: torch.Tensor, group: int, qmax: float):
    g = x.reshape(-1, group).float()
    gmax = g.amax(dim=-1, keepdim=True)
    gmin = g.amin(dim=-1, keepdim=True)
    scale = torch.clamp(gmax - gmin, min=1e-5) / qmax
    zero = torch.clamp(torch.round(-gmin / scale), 0.0, qmax)
    q = torch.clamp(torch.round(g / scale) + zero, 0.0, qmax)
    return q, scale, zero


def asym_int_group_qdq(x: torch.Tensor, nbits: int = 4,
                       group: int = 64) -> torch.Tensor:
    """Asymmetric unsigned int-N group qdq (KV fake quant): scale =
    max(max - min, 1e-5) / (2^n - 1), zero = round(-min / scale)."""
    q, scale, zero = _asym_groups(x, group, float(2 ** nbits - 1))
    return ((q - zero) * scale).reshape(x.shape).to(x.dtype)


def asym_int4_encode(x: torch.Tensor, group: int = 64):
    """Asymmetric int4 encode: (codes uint8 in [0, 15] shaped like x,
    scale f32 and zero f32 [..., K / group])."""
    q, scale, zero = _asym_groups(x, group, 15.0)
    lead = (*x.shape[:-1], x.shape[-1] // group)
    return (q.to(torch.uint8).reshape(x.shape), scale.reshape(lead),
            zero.reshape(lead))


def quantize_tensor_qdq(x: torch.Tensor,
                        quant_type: str = "NVFP4") -> torch.Tensor:
    """Tensor-level qdq with the format's whole scaling scheme: NVFP4's
    global scale, a unit scale otherwise."""
    if quant_type == "NVFP4":
        s = nvfp4_global_scale(x)
        return (nvfp4_qdq(x.float() / s) * s).to(x.dtype)
    if quant_type not in _QDQ_FUNCS:
        raise ValueError(f"unknown quant_type {quant_type!r}")
    return _QDQ_FUNCS[quant_type](x)


_QDQ_FUNCS = {"NVFP4": nvfp4_qdq, "MXFP4": mxfp4_qdq, "MXFP6": mxfp6_qdq,
              "INT4": int4_group_qdq}


def group_qdq(x: torch.Tensor, quant_type: str) -> torch.Tensor:
    """Group-level qdq of the format, without a global scale."""
    return _QDQ_FUNCS[quant_type](x)
