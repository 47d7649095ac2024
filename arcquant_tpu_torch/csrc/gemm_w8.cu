// w8 dequant GEMM: y = (xa @ dec(W)) * gs[m] * gw[n] (+ bias[n]).
//
// Replaces the TPU kernels arcquant_tpu/kernels/gemm.py:_gemm_w8_kernel
// (pallas_call in _gemm_call) and :_gemm_w8_dma_kernel (the same
// function with a hand-built weight stream, _gemm_dma_call). Plain
// PyTorch version: arcquant_tpu_torch/kernels/gemm.py:gemm_w8_plain.
//
// W is int8 [Kq, N] mag2 codes (2 x e2m1) with one ue4m3 scale byte per
// 16 k-rows and column ([Kq/16, N]); dec(W) = code * ue4m3(scale) / 2,
// which is exact in bf16. xa is bf16 [M, Kq]. Products run on the tensor
// cores (bf16 x bf16 -> f32). Each k-tile's MMAs start from zero and the
// tile's partial sum is added to the f32 total on the CUDA cores: the
// tensor cores align and truncate the sums they carry, which over a long
// chain of k-steps on bf16 activations (the A16 prefill sites) loses
// several times the error of an f32 sum. The epilogue applies the per-row
// activation scale, the per-channel (or scalar) weight scale and the
// bias in f32 in the JAX kernel's order (uncontracted: __fmul_rn and
// __fadd_rn, so no FMA changes the rounding), then casts to bf16 or f32.
//
// Bound on the H100: at decode (M <= 64) the weight stream (1.06 bytes
// per weight) bounds it: small M takes gemm_small_m.cuh's tile (a
// cp.async ring of 128-deep stages, the codes decoded straight into the
// MMAs' B fragments on the integer and bf16x2 pipes) and splits K across
// blocks until about two blocks per SM are in flight; partial sums go to
// an f32 workspace and a second kernel reduces them in a fixed order
// (deterministic). At prefill (M = 4096) the tensor cores bound it: M >
// 64 takes the warpgroup-MMA tile of gemm_wgmma.cuh (TMA ring, codes
// decoded once a block into a swizzled bf16 B tile, wgmma with each
// 128-deep partial promoted into the f32 total). The small-M mainloop
// (gemm_small_m.cuh) and gemm_w8_core.cuh's epilogue and split-K sum are
// shared with the w4 GEMM (gemm_w4.cu), gemm_batched (gemm_batched.cu)
// and the decode megakernels (mlp_fused.cu).
#include "gemm_wgmma.cuh"

// xa: [M, Kq] bf16; codes: [Kq, N] int8; scales: [Kq/16, N] uint8;
// gs: [M] f32; gw: [N] f32; bias: [N] bf16 or
// NULL; out: [M, N] bf16 or f32 (out_f32). small_m selects the small-M
// tile (else splits must be 1). With splits > 1, workspace holds
// splits * M * N floats. Requires Kq % 32 == 0; without small_m, also
// N % 16 == 0 and 16-byte aligned xa, codes and scales (TMA).
ARC_EXPORT int arc_gemm_w8(const void* xa, const void* codes, const void* scales,
                           const void* gs, const void* gw,
                           const void* bias, void* out, int out_f32, void* workspace,
                           int M, int N, int Kq, int small_m, int splits,
                           int tiles_per_split, void* stream) {
  return w8::launch_gemm<false>(xa, codes, scales, gs, gw, bias, out, out_f32, workspace, M, N,
                                Kq, small_m, splits, tiles_per_split, (cudaStream_t)stream);
}
