"""Device times of the fused dequant GEMMs and the paged prefill at the
shapes of Qwen2.5-7B, each beside its bound and one PyTorch call
computing the same function:

  - the fused dequant GEMM (``gemm_w8`` and ``gemm_w4``) at the four
    linear sites (qkv, o, gateup, down) with ARC select_frac 0.125
    packing, A4 activations, at each M of ``--m`` (default 4096, the
    prefill). Each row names its tile: M <= 64 runs the small-M tile
    (``csrc/gemm_small_m.cuh``, the decode's), larger M the large-M
    tile (``csrc/gemm_wgmma.cuh``, the prefill's). The library call is
    ``torch.matmul`` of xa with the weight decoded to bf16 (exact), the
    plain version ``gemm_w8_plain``;
  - ``paged_prefill`` at the serving shape (B 8 rows of a 512-token
    chunk over 128-token pages, ragged origins, one idle row, chip_smoke's
    case); the library call is SDPA over the pool dequantized to bf16.

  python -m arcquant_tpu_torch.benchmarks.bench_prefill [--m 4 16 4096]
      [--sites qkv o gateup down] [--no-attention] [--a16]

``--a16`` adds the GEMMs' accuracy on W4A16 operands (bf16 activations,
unit scale, f32 output) at down's Kq: the mean relative error against
f64 of the fused GEMM and of its plain f32 version (the bar of
``test_gemm_w8_bf16_activations_accumulate_in_f32``: kernel <= 2x plain).

It imports the package by its absolute name, so it also times another
checkout of it: ``PYTHONPATH=<checkout> python <this file>``. One JSON
line per measurement (times in ms, CUDA events with L2 flushed,
``benchmarks/common.py``'s Timer), the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json

import torch

from arcquant_tpu_torch.benchmarks.common import (Timer, bound_ms, card,
                                                  nbytes, require_cuda)
from arcquant_tpu_torch.config import get_model_config
from arcquant_tpu_torch.kernels import gemm as gk
from arcquant_tpu_torch.kernels import quantize as qk
from arcquant_tpu_torch.quant import packing

MODEL = "qwen2.5-7b"
SELECT_FRAC = 0.125


def _randn(gen, shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(
        torch.bfloat16)


def site_shapes(cfg):
    """(name, N, K, bias) of the prefill's four linear sites."""
    h, f = cfg.hidden_size, cfg.intermediate_size
    return [("qkv", cfg.q_size + 2 * cfg.kv_size, h, True),
            ("o", h, cfg.q_size, False),
            ("gateup", 2 * f, h, False),
            ("down", h, f, False)]


def gemm_rows(cfg, ms, sites, timer, emit):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    for name, n, k, bias in site_shapes(cfg):
        if name not in sites:
            continue
        sel = int(round(SELECT_FRAC * k / 64)) * 64
        w = _randn(gen, (n, k), k ** -0.5)
        b = _randn(gen, (n,), 0.1) if bias else None
        ridx = torch.randperm(k, generator=gen, device="cuda")
        pws = {fmt: packing.pack_weight_arc(w, ridx, sel, bias=b, fmt=fmt,
                                            w_scale="channel")
               for fmt in ("w8", "w4")}
        del w
        kq = pws["w8"].kq
        wd = gk.dequant_weight(pws["w8"])   # bf16 [Kq, N], exact, untimed
        for m in ms:
            xa, gx = qk.quantize_x_arc(_randn(gen, (m, k)), ridx, sel)
            gs = gx.reshape(-1, 1)
            for fmt, pw in pws.items():
                fused = gk._gemm_w8_cuda if fmt == "w8" else gk._gemm_w4_cuda
                plain = gk.gemm_w8_plain if fmt == "w8" else gk.gemm_w4_plain
                gw = pw.global_scale.reshape(1, -1)
                args = (xa, pw.codes, pw.scales, gs, gw, pw.bias,
                        torch.bfloat16)
                y = fused(*args)
                t = timer(lambda: fused(*args))
                t_lib = timer(lambda: torch.matmul(xa, wd))
                t_plain = timer(lambda: plain(*args))
                b_ms, b_by = bound_ms(2.0 * m * kq * n,
                                      nbytes(xa, pw.codes, pw.scales, gs, gw,
                                             pw.bias, y))
                emit(dict(kernel=f"gemm_{fmt}", site=name, m=m, kq=kq, n=n,
                          tile="small_m" if m <= gk._SMALL_M else "large_m",
                          ms=t.median, lo=t.lo, hi=t.hi,
                          plain_ms=t_plain.median, library_ms=t_lib.median,
                          bound_ms=b_ms, bound_by=b_by,
                          tflops=2.0 * m * kq * n / t.median / 1e9))
                del y
        del pws, xa, wd
        torch.cuda.empty_cache()


def a16_rows(cfg, emit):
    """Mean relative error vs f64 of gemm_w8 and gemm_w8_plain on bf16
    activations over down's Kq, at N 1040 (the GPU test's) and 3584."""
    kq = packing.pad_kq(cfg.intermediate_size,
                        int(round(SELECT_FRAC * cfg.intermediate_size / 64))
                        * 64)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    for n in (1040, cfg.hidden_size):
        w = _randn(gen, (n, kq), kq ** -0.5)
        pw = packing.pack_weight_arc(w, torch.arange(kq, device="cuda"), 0,
                                     w_scale="channel")
        del w
        wd = gk.dequant_weight(pw).double()
        gw = pw.global_scale.reshape(1, -1)
        for m in (65, 1000, 4096):
            xa = _randn(gen, (m, kq))
            gs = torch.ones((m, 1), device="cuda")
            args = (xa, pw.codes, pw.scales, gs, gw, None, torch.float32)
            f64 = (xa.double() @ wd) * gw.double()
            err = [float((y.double() - f64).abs().mean() / f64.abs().mean())
                   for y in (gk._gemm_w8_cuda(*args), gk.gemm_w8_plain(*args))]
            emit(dict(a16=True, m=m, kq=kq, n=n, kernel_err=err[0],
                      plain_err=err[1], ratio=err[0] / err[1]))
            del f64, xa
        del wd, pw
        torch.cuda.empty_cache()


def paged_prefill_row(cfg, timer, emit):
    from arcquant_tpu_torch.cache import paged
    from arcquant_tpu_torch.kernels import paged_decode as pdk
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    bsz, tq, page, pps = 8, 512, 128, 16
    starts = [0, 512, 1024, 1536, 0, 1024, 0, 0]
    seqs = [512, 1024, 1536, 1900, 301, 1124, 64, 0]
    cache = paged.init_cache(cfg.replace(num_layers=1), 1 + bsz * pps, page,
                             "cuda")
    pt = (1 + torch.arange(pps)[None, :] * bsz
          + torch.arange(bsz)[:, None]).to(torch.int32).cuda()
    st = torch.tensor(starts, dtype=torch.int32, device="cuda")
    sl = torch.tensor(seqs, dtype=torch.int32, device="cuda")
    t = pps * page
    pos = torch.arange(t, device="cuda")[None].expand(bsz, t)
    pos = torch.where(pos < sl[:, None], pos, -1)
    paged.append_kv(cache, 0, _randn(gen, (bsz, t, hkv, dh), 2.0),
                    _randn(gen, (bsz, t, hkv, dh)), pt, pos)
    q = _randn(gen, (bsz, tq, hq, dh), 2.0)
    args = (q, cache.codes[0], cache.params[0], pt, st, sl)
    o = pdk._paged_prefill_cuda(*args)
    qpos = st[:, None] + torch.arange(tq, device="cuda")[None]
    live = qpos < sl[:, None]
    pairs = float(((qpos + 1) * live).sum())
    keys = sum(s for s, o_ in zip(seqs, starts) if o_ < s)
    kd, vd = (x.to(torch.bfloat16).transpose(1, 2).contiguous()
              for x in paged.gather_kv(cache, 0, pt, t))
    qd = q.transpose(1, 2).contiguous()
    kpos = torch.arange(t, device="cuda")
    mask = ((kpos[None, None] <= qpos[:, :, None])
            & (kpos[None, None] < sl[:, None, None]))[:, None]
    tk = timer(lambda: pdk._paged_prefill_cuda(*args))
    tp = timer(lambda: pdk.paged_prefill_plain(*args))
    tl = timer(lambda: sdpa(qd, kd, vd, attn_mask=mask, enable_gqa=True))
    b_ms, b_by = bound_ms(4.0 * pairs * hq * dh,
                          keys * hkv * (dh + 16) + nbytes(q, o))
    emit(dict(kernel="paged_prefill", shape="B=8 Tq=512 page=128 "
              f"H={hq}/{hkv} seq=512..1900", ms=tk.median, lo=tk.lo,
              hi=tk.hi, plain_ms=tp.median, library_ms=tl.median,
              bound_ms=b_ms, bound_by=b_by))


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m arcquant_tpu_torch.benchmarks.bench_prefill")
    ap.add_argument("--m", type=int, nargs="+", default=[4096])
    ap.add_argument("--sites", nargs="*",
                    default=["qkv", "o", "gateup", "down"])
    ap.add_argument("--no-attention", action="store_true")
    ap.add_argument("--a16", action="store_true")
    args = ap.parse_args(argv)
    require_cuda("bench_prefill")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_model_config(MODEL)
    timer = Timer()

    def emit(row):
        print(json.dumps(row), flush=True)
    emit(dict(card=card(), torch=torch.__version__, cuda=torch.version.cuda))
    if args.a16:
        a16_rows(cfg, emit)
    gemm_rows(cfg, args.m, args.sites, timer, emit)
    if not args.no_attention:
        paged_prefill_row(cfg, timer, emit)


if __name__ == "__main__":
    main()
