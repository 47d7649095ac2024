"""The w4 weight format and the large-M GEMM route of arcquant_tpu_torch
held against the JAX package on the CPU (its Pallas kernels in
interpret mode; the port's CPU tensors take its plain versions).

The bars:
  - the w4 pack: the same bytes (codes, ue4m3 scale bytes, global
    scales, bias) and the same golden decode;
  - the decodes (dequant_w8_plain, dequant_w4_plain, dequant_weight with
    and without the folded global scale) and the w4 route's activation
    operand (pin_rowmajor_plain): bit for bit;
  - the GEMM in w4, and the route in both formats: rtol = atol = 1e-4,
    the JAX package's own bound for an f32 sum order
    (tests/test_kernels.py test_xla_dispatch_matches_fused);
  - the w4 GEMM against the w8 GEMM on the same weight: bit for bit;
  - the w4 engine against the JAX w4 engine: logits cosine >= 0.999 and
    equal greedy tokens (tests/test_torch_engine.py's bar, f32 params),
    with the route off and engaged.
"""

import http.client
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcquant_tpu.config import QuantConfig as JQuantConfig
from arcquant_tpu.config import get_model_config as jax_model_config
from arcquant_tpu.engine import EngineConfig as JEngineConfig
from arcquant_tpu.engine import InferenceEngine as JEngine
from arcquant_tpu.kernels import gemm as jgemm
from arcquant_tpu.kernels import quantize as jqk
from arcquant_tpu.models import llama as jllama
from arcquant_tpu.models import quantized as jquantized
from arcquant_tpu.quant import packing as JP
from arcquant_tpu_torch import convert, serve
from arcquant_tpu_torch.config import QuantConfig, get_model_config
from arcquant_tpu_torch.engine import EngineConfig, InferenceEngine
from arcquant_tpu_torch.engine.server import make_server
from arcquant_tpu_torch.kernels import gemm as gk
from arcquant_tpu_torch.kernels import mlp_fused as mf
from arcquant_tpu_torch.models import quantized
from arcquant_tpu_torch.quant import packing
from arcquant_tpu_torch.testing import cosine, outlier_x, to_numpy, to_torch

QKW = dict(quant_type="NVFP4", use_kernels=True, weight_fmt="w4",
           act_scale="row", w_scale="channel", quantize_lm_head=True)
EKW = dict(max_batch=4, max_seq_len=64, page_size=16)
PROMPTS = [[5, 17, 301, 42, 8, 9, 10], [100, 200, 7], list(range(1, 40)),
           [3]]
STEPS = 3
ROUTE_M = 64     # both packages' route threshold when a test engages it


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16))


def _bits(a):
    """bf16 values (numpy, widened to f32 exactly) as their raw bits."""
    return np.asarray(a, np.float32).view(np.uint32)


def _jax_pack(rng, n, k, select, bias, fmt, w_scale="channel"):
    w = _bf16(outlier_x(rng, n, k) * 0.05)
    ridx = rng.permutation(k).astype(np.int32)
    b = _bf16(rng.standard_normal(n)) if bias else None
    jpw = JP.pack_weight_arc(jnp.asarray(w), jnp.asarray(ridx), select,
                             bias=None if b is None else jnp.asarray(b),
                             fmt=fmt, w_scale=w_scale)
    return w, ridx, b, jpw


@pytest.mark.parametrize("n,k,select", [(96, 448, 64), (64, 512, 0),
                                        (160, 960, 128)])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("w_scale", ["channel", "tensor"])
def test_pack_weight_arc_w4_bytes(n, k, select, bias, w_scale):
    """pack_weight_arc(fmt="w4"): the JAX package's nibble bytes, scale
    bytes (0 on the pad groups), global scales and bias, from the same
    bf16 weight and a random reorder index; the golden decode agrees."""
    rng = np.random.default_rng(n + k + select)
    w, ridx, b, jpw = _jax_pack(rng, n, k, select, bias, "w4", w_scale)
    tpw = packing.pack_weight_arc(to_torch(w), torch.from_numpy(ridx),
                                  select, bias=None if b is None
                                  else to_torch(b), fmt="w4",
                                  w_scale=w_scale)
    assert isinstance(tpw, packing.PackedWeight)
    assert tpw.kq == jpw.kq and tpw.n == jpw.n
    assert tpw.codes.dtype == torch.uint8
    np.testing.assert_array_equal(to_numpy(tpw.codes), np.asarray(jpw.codes))
    np.testing.assert_array_equal(to_numpy(tpw.scales),
                                  np.asarray(jpw.scales))
    assert (to_numpy(tpw.scales)[(k + select) // 16:] == 0).all()
    np.testing.assert_array_equal(to_numpy(tpw.global_scale),
                                  np.asarray(jpw.global_scale))
    if bias:
        np.testing.assert_array_equal(to_numpy(tpw.bias),
                                      np.asarray(jpw.bias, np.float32))
    full = to_numpy(packing.dequantize_weight(tpw)).T[:, :k + select]
    np.testing.assert_array_equal(
        full, np.asarray(JP.dequantize_weight(jpw, k, select)))
    # convert carries the JAX pack across as the same type and bytes
    cpw = convert.packed_from_numpy(jax.tree.map(np.asarray, jpw))
    assert isinstance(cpw, packing.PackedWeight)
    assert torch.equal(cpw.codes, tpw.codes)


def test_nibble_helpers_match_jax():
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 16, (6, 40)).astype(np.uint8)
    for axis in (0, 1, -1):
        got = packing.pack_nibbles(torch.from_numpy(codes), axis)
        want = JP.pack_nibbles(jnp.asarray(codes), axis)
        np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
        np.testing.assert_array_equal(
            to_numpy(packing.unpack_nibbles(got, axis)), codes)
    np.testing.assert_array_equal(
        to_numpy(packing.e2m1_to_e2m1x(torch.from_numpy(codes))),
        np.asarray(JP.e2m1_to_e2m1x(jnp.asarray(codes))))


@pytest.mark.parametrize("fmt", ["w8", "w4"])
@pytest.mark.parametrize("fold_global", [False, True])
@pytest.mark.parametrize("w_scale", ["channel", "tensor"])
def test_dequant_weight_bitwise(fmt, fold_global, w_scale):
    """dequant_weight and the format's plain decode give JAX's
    dequant_weight bits (w4: the split-half k order)."""
    rng = np.random.default_rng(11)
    _, _, _, jpw = _jax_pack(rng, 384, 448, 64, False, fmt, w_scale)
    want = np.asarray(jgemm.dequant_weight(jpw, fold_global=fold_global),
                      np.float32)
    pw = convert.packed_from_numpy(jax.tree.map(np.asarray, jpw))
    got = to_numpy(gk.dequant_weight(pw, fold_global=fold_global))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    gw = pw.global_scale.reshape(-1).expand(pw.n) if fold_global else None
    plain = (gk.dequant_w8_plain(pw.codes, pw.scales, gw) if fmt == "w8"
             else gk.dequant_w4_plain(pw.codes, pw.scales, gw))
    assert plain.dtype == torch.bfloat16
    assert plain.shape == ((pw.kq, pw.n) if fmt == "w8"
                           else (2, pw.kq // 2, pw.n))
    np.testing.assert_array_equal(_bits(to_numpy(plain).reshape(want.shape)),
                                  _bits(want))


@pytest.mark.parametrize("m,k", [(5, 512), (24, 1024)])
def test_pin_rowmajor_plain_bitwise(m, k):
    rng = np.random.default_rng(m)
    x = _bf16(rng.standard_normal((m, k)) * 3)
    want = jgemm._pin_rowmajor(
        jgemm.split_even_odd(jnp.asarray(x)).astype(jnp.bfloat16),
        interpret=True)
    got = gk.pin_rowmajor_plain(to_torch(x))
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    np.testing.assert_array_equal(_bits(to_numpy(got)),
                                  _bits(np.asarray(want, np.float32)))
    np.testing.assert_array_equal(
        to_numpy(gk.split_even_odd(to_torch(x))),
        np.asarray(jgemm.split_even_odd(jnp.asarray(x)), np.float32))


def _gemm_case(rng, m, n, k, select, bias, fmt):
    _, ridx, _, jpw = _jax_pack(rng, n, k, select, bias, fmt)
    x = _bf16(outlier_x(rng, m, k))
    jxa, jgx = jqk.quantize_x_arc(jnp.asarray(x), jnp.asarray(ridx), select,
                                  kq=jpw.kq, per_row=True)
    return jpw, jxa, jgx


@pytest.mark.parametrize("m", [4, 24, 128])
def test_gemm_w4_matches_jax(m):
    """w4 gemm_dequant (ARC columns, bias, per-channel scales) against
    JAX's w4 gemm_dequant (its fused w4 kernel) on the same bytes."""
    rng = np.random.default_rng(100 + m)
    jpw, jxa, jgx = _gemm_case(rng, m, 640, 960, 64, True, "w4")
    ref = jgemm.gemm_dequant(jxa, jpw, jgx, out_dtype=jnp.float32)
    pw = convert.packed_from_numpy(jax.tree.map(np.asarray, jpw))
    y = gk.gemm_dequant(to_torch(jxa), pw, to_torch(jgx),
                        out_dtype=torch.float32)
    assert y.shape == (m, 640) and y.dtype == torch.float32
    np.testing.assert_allclose(to_numpy(y), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("fmt", ["w8", "w4"])
@pytest.mark.parametrize("bias", [False, True])
def test_route_matches_jax(fmt, bias, monkeypatch):
    """Both packages' route thresholds lowered to 64: M 96, N 1024 >= Kq
    1024 takes dequant + the f32 matmul on both sides; M 96 at N 512 <
    Kq stays on the fused GEMM (the gate's N >= Kq half)."""
    rng = np.random.default_rng(7 + int(bias))
    monkeypatch.setattr(gk, "XLA_M", ROUTE_M)
    monkeypatch.setenv(jgemm._XLA_M_ENV, str(ROUTE_M))
    calls = []
    real = gk._gemm_route
    monkeypatch.setattr(gk, "_gemm_route",
                        lambda *a: calls.append(1) or real(*a))
    for n in (1024, 512):
        jpw, jxa, jgx = _gemm_case(rng, 96, n, 960, 64, bias, fmt)
        ref = jgemm.gemm_dequant(jxa, jpw, jgx, out_dtype=jnp.float32)
        pw = convert.packed_from_numpy(jax.tree.map(np.asarray, jpw))
        y = gk.gemm_dequant(to_torch(jxa), pw, to_torch(jgx),
                            out_dtype=torch.float32)
        np.testing.assert_allclose(to_numpy(y), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4)
        bf = gk.gemm_dequant(to_torch(jxa), pw, to_torch(jgx))
        np.testing.assert_allclose(
            to_numpy(bf), np.asarray(jgemm.gemm_dequant(jxa, jpw, jgx),
                                     np.float32), rtol=2.0 ** -7, atol=1e-4)
    assert calls == [1, 1]            # the n = 1024 calls only


@pytest.mark.parametrize("m", [4, 24, 70, 600])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_w4_gemm_bitwise_equals_w8(m, out_dtype, monkeypatch):
    """On the same weight the w4 GEMM gives the w8 GEMM's bits (the
    route off at M 600; its w4 operand is split even/odd)."""
    monkeypatch.setattr(gk, "XLA_M", 0)
    rng = np.random.default_rng(m)
    w = to_torch(_bf16(outlier_x(rng, 1040, 448) * 0.05))
    ridx = torch.from_numpy(rng.permutation(448))
    b = to_torch(_bf16(rng.standard_normal(1040)))
    pws = [packing.pack_weight_arc(w, ridx, 64, bias=b, fmt=f,
                                   w_scale="channel") for f in ("w8", "w4")]
    xa = to_torch(_bf16(rng.standard_normal((m, pws[0].kq))))
    gx = torch.from_numpy(rng.random((m, 1), np.float32) + 0.5)
    y8, y4 = (gk.gemm_dequant(xa, pw, gx, out_dtype) for pw in pws)
    assert torch.equal(y8.view(torch.int16 if y8.element_size() == 2
                               else torch.int32),
                       y4.view(torch.int16 if y4.element_size() == 2
                               else torch.int32))


# -- the w4 engine ---------------------------------------------------------------

def _route_env(monkeypatch, on: bool):
    limit = ROUTE_M if on else 0
    monkeypatch.setattr(gk, "XLA_M", limit)
    monkeypatch.setenv(jgemm._XLA_M_ENV, str(limit))


@pytest.mark.parametrize("name", ["test-tiny", "test-qwen-tiny"])
@pytest.mark.parametrize("route", ["off", "on"])
def test_w4_engine_matches_jax(name, route, monkeypatch):
    """The w4 engine from the raw f32 params (the port packs them) against
    the JAX w4 engine: prefill and STEPS greedy decode steps fed the same
    tokens. With the route on, prefill (M 4 x 64) takes it at qkv and
    gateup in both packages."""
    _route_env(monkeypatch, route == "on")
    cfg = jax_model_config(name)
    params = jllama.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    rng = np.random.default_rng(0)
    for layer in params["layers"]:     # non-zero qkv biases (Qwen2)
        for proj in ("q", "k", "v"):
            if "b" in layer[proj]:
                layer[proj]["b"] = jnp.asarray(
                    rng.standard_normal(layer[proj]["b"].shape) * 0.1,
                    jnp.float32)
    calib = jquantized.identity_calib(cfg, select_frac=0.125)
    jeng = JEngine(cfg, params, calib, JQuantConfig(**QKW),
                   JEngineConfig(**EKW))
    eng = InferenceEngine(get_model_config(name),
                          convert.params_from_numpy(
                              jax.tree.map(np.asarray, params)),
                          convert.calib_from_numpy(calib),
                          QuantConfig(**QKW), EngineConfig(**EKW),
                          device="cpu")
    head = eng.qparams["lm_head_packed"]
    assert isinstance(head, packing.PackedWeight)
    np.testing.assert_array_equal(
        to_numpy(head.codes), np.asarray(jeng.qparams["lm_head_packed"].codes))
    np.testing.assert_array_equal(
        to_numpy(eng.qparams["layers"][0]["gateup"].codes),
        np.asarray(jeng.qparams["layers"][0]["gateup"].codes))
    routed = []
    real = gk._gemm_route
    monkeypatch.setattr(gk, "_gemm_route",
                        lambda xa, *a: routed.append(xa.shape[0])
                        or real(xa, *a))
    toks, lens, _ = jeng._pad_prompts(PROMPTS)
    jl, jstate = jeng.prefill(jeng.new_state(), jnp.asarray(toks),
                              jnp.asarray(lens))
    tl, tstate = eng.prefill(eng.new_state(), toks, lens)
    assert routed == ([toks.size] * 2 * cfg.num_layers if route == "on"
                      else [])
    jactive, tactive = jnp.asarray(lens > 0), torch.as_tensor(lens > 0)
    for step in range(STEPS + 1):
        got, want = to_numpy(tl), np.asarray(jl)
        c = cosine(got, want)
        assert c >= 0.999, (step, c)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        if step == STEPS:
            break
        cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jstate = jeng.decode_step(jstate, jnp.asarray(cur), jactive)
        tl, tstate = eng.decode_step(tstate, torch.from_numpy(cur), tactive)


def test_w4_engine_makes_no_megakernel_call(monkeypatch):
    """A select-free decode at batch 4, where a w8 engine takes all three
    megakernel routes, runs the w4 chain (actq, then gemm_w4) instead."""
    calls = []
    for fn in ("gemm_w8_actq_fused", "gateup_silu_quantize",
               "mlp_w8_fused"):
        real = getattr(mf, fn)
        monkeypatch.setattr(mf, fn, lambda *a, _r=real, _f=fn, **k:
                            calls.append(_f) or _r(*a, **k))
    cfg = get_model_config("test-qwen-tiny").replace(num_layers=1)
    for fmt, sel in (("w4", 0.0), ("w4", 0.125), ("w8", 0.0)):
        eng = InferenceEngine.dummy(
            cfg, quantized.identity_calib(cfg, sel),
            QuantConfig(**{**QKW, "weight_fmt": fmt}), EngineConfig(**EKW),
            device="cpu")
        out = eng.generate([[1] * 9, [2], [3, 4], [5]], 2)
        assert [len(o) for o in out] == [2] * 4
        if fmt == "w4":
            assert calls == [], (sel, calls)
    assert set(calls) == {"gemm_w8_actq_fused", "mlp_w8_fused"}


def test_serve_w4_answers_a_request():
    """python -m arcquant_tpu_torch.serve --weight_fmt w4 --cpu: the
    engine holds w4 packs, and an HTTP completion request comes back."""
    args = serve.build_parser().parse_args(
        ["--model", "test-tiny", "--cpu", "--weight_fmt", "w4",
         "--max_batch", "2", "--max_seq_len", "64", "--prefill_chunk", "16",
         "--dynamic_pages", "--prefix_sharing"])
    loop = serve.build_loop(args)
    srv = make_server(loop, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        eng = loop.batcher.engine
        packs = [p for layer in eng.qparams["layers"] for n, p in
                 layer.items() if n in ("qkv", "o", "gateup", "down")]
        packs.append(eng.qparams["lm_head_packed"])
        assert all(isinstance(p, packing.PackedWeight) for p in packs)
        c = http.client.HTTPConnection("127.0.0.1", srv.server_address[1],
                                       timeout=300)
        c.request("POST", "/v1/completions",
                  json.dumps({"prompt": [1, 2, 3] * 7, "max_tokens": 4}))
        r = c.getresponse()
        out = json.loads(r.read())
        c.close()
        assert r.status == 200 and len(out["tokens"]) == 4, out
    finally:
        srv.shutdown()
        srv.server_close()
        loop.shutdown()
