"""#17 rope_kv's plain version (kernels/rope_kv.py rope_append_kv on CPU
tensors) held against the JAX package's llama.apply_rope followed by
paged.append_kv, bit for bit: q_rot and k_rot (bf16 compared as its
bits), and the pool's codes, scales and mins on pages >= 1 through the
layout adapter (JAX keeps tokens last, the port before the packed head
dim; page 0 is the sink). Both of JAX's append branches: T = 1 (the
per-row update) and T > 1 (the scatter), with positions that straddle
page boundaries, inactive rows (-1), the GQA group 7, Dh 128 and 64, in
bf16 and f32. q, k and v reach the port as the strided column views of
one qkv row, as the engine passes them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcquant_tpu.cache import paged as jpaged
from arcquant_tpu.config import get_model_config
from arcquant_tpu.models import llama as jllama
from arcquant_tpu_torch.cache import paged
from arcquant_tpu_torch.config import get_model_config as tget_model_config
from arcquant_tpu_torch.kernels import rope_kv as rk
from arcquant_tpu_torch.models import llama
from arcquant_tpu_torch.testing import to_numpy, to_torch

PAGE, LAYER = 16, 1
# (batch, starts, lens) a row: T = 1 rows are single positions (the
# first and last slots of a page, an inactive row); T = 20 chunks start
# mid-page and cross one or two page boundaries, their tails past lens
# masked to -1
CASES = {1: ((16, 3, 5, 47), (17, 4, 0, 48)),
         20: ((10, 0, 30), (30, 13, 45))}


def _cfg(pkg, dh):
    # Qwen2.5-7B's GQA group (7 query heads per kv head), narrow otherwise
    return pkg("test-tiny").replace(num_heads=14, num_kv_heads=2,
                                    head_dim=dh, num_layers=2)


def _bits(a) -> np.ndarray:
    """Exact bits: bf16 as uint16, f32 as uint32."""
    a = np.asarray(a)
    if a.dtype == np.float32:
        return a.view(np.uint32)
    return np.asarray(jnp.asarray(a).view(jnp.uint16))


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("dh", [128, 64])
@pytest.mark.parametrize("t", [1, 20])
def test_rope_append_kv_plain_matches_jax(t, dh, dtype):
    cfg, tcfg = _cfg(get_model_config, dh), _cfg(tget_model_config, dh)
    starts, lens = CASES[t]
    b = len(starts)
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    rng = np.random.default_rng(dh + t)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    qkv = np.asarray(jnp.asarray(
        rng.standard_normal((b * t, (hq + 2 * hkv) * dh)) * 2, jdt))
    pos = np.asarray(starts)[:, None] + np.arange(t)[None]
    append = np.where(pos < np.asarray(lens)[:, None], pos, -1)
    pps = -(-(max(starts) + t) // PAGE)
    pt = (1 + np.arange(b)[:, None] * pps
          + np.arange(pps)[None]).astype(np.int32)
    cos, sin = (to_numpy(x) for x in llama.rope_cos_sin(
        tcfg, torch.from_numpy(pos)))

    # the port: column views of one qkv row, as _attn_common returns them
    tq = to_torch(qkv)
    q = tq[:, :hq * dh].reshape(b, t, hq, dh)
    k = tq[:, hq * dh:(hq + hkv) * dh].reshape(b, t, hkv, dh)
    v = tq[:, (hq + hkv) * dh:].reshape(b, t, hkv, dh)
    npages = 1 + b * pps
    tc = paged.init_cache(tcfg, npages, PAGE)
    q_rot, k_rot = rk.rope_append_kv(
        q, k, v, torch.from_numpy(cos), torch.from_numpy(sin), tc, LAYER,
        torch.from_numpy(pt), torch.from_numpy(append))

    jq, jk, jv = (jnp.asarray(np.ascontiguousarray(to_numpy(x)), jdt)
                  for x in (q, k, v))
    jq_rot, jk_rot = jllama.apply_rope(jq, jk, jnp.asarray(cos),
                                       jnp.asarray(sin))
    jc = jpaged.init_cache(cfg, npages, PAGE)
    jc = jpaged.append_kv(jc, LAYER, jk_rot, jv, jnp.asarray(pt),
                          jnp.asarray(append.astype(np.int32)))

    for got, want in ((q_rot, jq_rot), (k_rot, jk_rot)):
        assert got.dtype == q.dtype
        np.testing.assert_array_equal(
            _bits(np.asarray(jnp.asarray(to_numpy(got), jdt))), _bits(want))
    np.testing.assert_array_equal(
        to_numpy(tc.codes[LAYER])[1:],
        np.asarray(jc.codes[LAYER]).transpose(0, 1, 2, 4, 3)[1:])
    np.testing.assert_array_equal(
        to_numpy(tc.params[LAYER])[1:].view(np.uint32),
        np.asarray(jc.params[LAYER]).transpose(0, 1, 3, 2)[1:]
        .view(np.uint32))
    # every live position was written, and the other layer untouched
    live = int((append >= 0).sum())
    assert int((to_numpy(tc.params[LAYER])[1:, :, :, 0] > 0).sum()) \
        == live * hkv
    assert int(tc.codes[0].abs().sum()) == 0


def test_rope_append_kv_plain_is_the_composite():
    """On CPU tensors rope_append_kv is apply_rope then append_kv, with
    cos/sin [T, Dh] broadcast over the batch."""
    tcfg = _cfg(tget_model_config, 64)
    rng = np.random.default_rng(7)
    b, t, hq, hkv, dh = 2, 5, 14, 2, 64
    q = to_torch(rng.standard_normal((b, t, hq, dh)).astype(np.float32))
    k = to_torch(rng.standard_normal((b, t, hkv, dh)).astype(np.float32))
    v = to_torch(rng.standard_normal((b, t, hkv, dh)).astype(np.float32))
    pos = torch.arange(t)
    cos, sin = llama.rope_cos_sin(tcfg, pos)
    pt = torch.tensor([[1], [2]], dtype=torch.int32)
    append = torch.stack([pos, torch.where(pos < 3, pos, -1)])
    got_c, want_c = (paged.init_cache(tcfg, 3, PAGE) for _ in range(2))
    got = rk.rope_append_kv(q, k, v, cos, sin, got_c, 0, pt, append)
    want = llama.apply_rope(q, k, cos, sin)
    paged.append_kv(want_c, 0, want[1], v, pt, append)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    for a, w in zip(got_c.codes + got_c.params, want_c.codes + want_c.params):
        assert torch.equal(a, w)


def test_quantize_kv_scale_divides_like_jax():
    """The scale is JAX's quotient, bit for bit, over rows where a
    multiply by f32(1/15) would give another f32 on most of them."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((20000, 2, 64)) * 3).astype(np.float32)
    x *= rng.uniform(0.01, 100, (20000, 1, 1)).astype(np.float32)
    codes, scale, minv = paged.quantize_kv(to_torch(x))
    jc, js, jm = jpaged.quantize_kv(jnp.asarray(x))
    np.testing.assert_array_equal(to_numpy(scale).view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    np.testing.assert_array_equal(to_numpy(codes), np.asarray(jc))
    np.testing.assert_array_equal(to_numpy(minv), np.asarray(jm))


def test_position_past_the_page_table_raises():
    """A position past a row's page table is an error, not a dropped
    write: on CPU tensors the plain version's gather raises (on the card
    the kernel and the plain version hit a device-side assert alike,
    tests/test_torch_kernels_gpu.py); the JAX package clamps instead."""
    tcfg = _cfg(tget_model_config, 64)
    b, t, dh = 2, 1, 64
    q = torch.zeros((b, t, 14, dh))
    k = torch.zeros((b, t, 2, dh))
    pos = torch.tensor([[5], [2 * PAGE]])           # row 1 past its 2 pages
    cos, sin = llama.rope_cos_sin(tcfg, pos)
    pt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    cache = paged.init_cache(tcfg, 5, PAGE)
    with pytest.raises((RuntimeError, IndexError)):
        rk.rope_append_kv(q, k, k, cos, sin, cache, 0, pt, pos)
