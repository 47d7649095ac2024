// w4 dequant GEMM: y = (xa @ dec(W)) * gs[m] * gw[n] (+ bias[n]).
//
// Replaces the TPU kernels arcquant_tpu/kernels/gemm.py:_gemm_w4_kernel
// (pallas_call in _gemm_call) and :_gemm_w4_dma_kernel (the same
// function with a hand-built weight stream, _gemm_dma_call). Plain
// PyTorch version: arcquant_tpu_torch/kernels/gemm.py:gemm_w4_plain.
//
// W is uint8 [Kq/2, N]: byte g of column n holds the e2m1x codes of
// k = 2g (low nibble) and k = 2g+1 (high nibble), with one ue4m3 scale
// byte per 16 k-rows ([Kq/16, N]); dec(W) = e2m1(code) * ue4m3(scale).
//
// The TPU kernel reads xa as two halves (even ks, then odd ks;
// split_even_odd) so that one stacked MXU dot covers both nibbles. That
// layout is not carried over: here xa is read in natural k order, as the
// w8 GEMM reads it, and the decode turns each code byte into the two k
// rows it holds (at M <= 64, gemm_small_m.cuh: the k rows 2t and 2t + 1
// of an mma B fragment are the two nibbles of one byte, packed in one
// conversion). The decoded values are the ones the w8 decode gives for
// the same weight, so the mainloop, the per-k-tile f32 promotion, the
// split-K plan (kernels/gemm.py:_split_plan) and the epilogue are the w8
// GEMM's, and the output is the w8 GEMM's bit for bit.
//
// Bound on the H100: at decode (M <= 64) the weight stream, 0.5625 bytes
// per weight (half the code bytes of w8, the same scale bytes): gateup
// at M 4 moves 87 MB, 0.026 ms at 3.35 TB/s. A 128-deep stage of the
// small-M ring holds 64 code rows, half of w8's; the decode (a bit map
// into the f32 exponent and mantissa, one select for the zero code, a
// multiply by the scale) runs on the CUDA cores beside the copies. At
// prefill the tensor cores bound it, as for w8; the large-M route
// (dequant.cu + torch.mm) takes the N >= Kq sites there.
#include "gemm_wgmma.cuh"

// As arc_gemm_w8, with codes: [Kq/2, N] uint8 e2m1x nibble pairs.
ARC_EXPORT int arc_gemm_w4(const void* xa, const void* codes, const void* scales,
                           const void* gs, const void* gw,
                           const void* bias, void* out, int out_f32, void* workspace,
                           int M, int N, int Kq, int small_m, int splits,
                           int tiles_per_split, void* stream) {
  return w8::launch_gemm<true>(xa, codes, scales, gs, gw, bias, out, out_f32, workspace, M, N,
                               Kq, small_m, splits, tiles_per_split, (cudaStream_t)stream);
}
