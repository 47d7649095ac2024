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
// cores (WMMA bf16 x bf16 -> f32). Each k-tile's MMAs start from zero and
// the tile's partial sum is added to the f32 total on the CUDA cores: the
// tensor cores align and truncate the sums they carry, which over a long
// chain of k-steps on bf16 activations (the A16 prefill sites) loses
// several times the error of an f32 sum. The epilogue applies the per-row
// activation scale, the per-channel (or scalar) weight scale and the
// bias in f32 in the JAX kernel's order (uncontracted: __fmul_rn and
// __fadd_rn, so no FMA changes the rounding), then casts to bf16 or f32.
//
// Bound on the H100: at decode (M <= 64) the weight stream (1.06 bytes
// per weight) bounds it, so small M uses a 32-row tile and splits K
// across blocks until about two blocks per SM are in flight; partial
// sums go to an f32 workspace and a second kernel reduces them in a
// fixed order (deterministic). At prefill (M = 4096) the tensor cores
// bound it, so large M uses 128x128 tiles with 8 warps. Each k-step
// decodes a 32 x 128 weight tile into shared memory once per block and
// prefetches the next tile's codes, scales and activations into
// registers while the current one multiplies. TMA, wgmma and a deeper
// pipeline are later work. The tile (mainloop, promotion, epilogue) and
// the split-K sum are gemm_w8_core.cuh, which the decode megakernels
// (mlp_fused.cu) run too, so that they give this chain's bits.
#include "gemm_w8_core.cuh"

namespace {

using w8::BK;

// Two resident blocks per SM: the 128x128 tile needs them to keep its
// weight and activation loads in flight (the cap is 128 registers).
template <int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(WM * WN * 32, 2)
gemm_w8_kernel(const bf16* __restrict__ xa, const int8_t* __restrict__ codes,
               const uint8_t* __restrict__ scales, const float* __restrict__ gs,
               const float* __restrict__ gw,
               const bf16* __restrict__ bias, void* __restrict__ out, int out_f32,
               float* __restrict__ partial, int M, int N, int Kq, int tiles_per_split) {
  using T = w8::Tile<BM, BN, WM, WN>;
  __shared__ typename T::Smem sm;
  const int kt0 = blockIdx.z * tiles_per_split;
  const int kt1 = min(kt0 + tiles_per_split, Kq / BK);
  w8::gemm_tile<T, false>(xa, codes, scales, gs, gw, bias, out, out_f32, partial, blockIdx.z, M,
                   N, Kq, blockIdx.y * BM, blockIdx.x * BN, kt0, kt1, sm);
}

// Sums the split-K partials in split order, then the same epilogue.
__global__ void splitk_reduce_kernel(const float* __restrict__ partial, int splits,
                                     const float* __restrict__ gs,
                                     const float* __restrict__ gw,
                                     const bf16* __restrict__ bias, void* __restrict__ out,
                                     int out_f32, int M, int N) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)M * N) return;
  const float v = w8::sum_splits(partial, splits, (int64_t)M * N, idx);
  w8::store_out(v, idx, (int)(idx / N), (int)(idx % N), gs, gw, bias, out, out_f32);
}

}  // namespace

// xa: [M, Kq] bf16; codes: [Kq, N] int8; scales: [Kq/16, N] uint8;
// gs: [M] f32; gw: [N] f32; bias: [N] bf16 or
// NULL; out: [M, N] bf16 or f32 (out_f32). small_m selects the 32-row
// tile. With splits > 1, workspace holds splits * M * N floats.
// Requires Kq % 32 == 0.
ARC_EXPORT int arc_gemm_w8(const void* xa, const void* codes, const void* scales,
                           const void* gs, const void* gw,
                           const void* bias, void* out, int out_f32, void* workspace,
                           int M, int N, int Kq, int small_m, int splits,
                           int tiles_per_split, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* part = splits > 1 ? (float*)workspace : nullptr;
  if (M > 0 && N > 0) {
    if (small_m) {
      dim3 grid((N + 127) / 128, (M + 31) / 32, splits);
      gemm_w8_kernel<32, 128, 1, 4><<<grid, 128, 0, st>>>(
          (const bf16*)xa, (const int8_t*)codes, (const uint8_t*)scales, (const float*)gs,
          (const float*)gw, (const bf16*)bias, out, out_f32, part, M, N, Kq,
          tiles_per_split);
    } else {
      dim3 grid((N + 127) / 128, (M + 127) / 128, splits);
      gemm_w8_kernel<128, 128, 2, 4><<<grid, 256, 0, st>>>(
          (const bf16*)xa, (const int8_t*)codes, (const uint8_t*)scales, (const float*)gs,
          (const float*)gw, (const bf16*)bias, out, out_f32, part, M, N, Kq,
          tiles_per_split);
    }
    if (splits > 1) {
      const int64_t total = (int64_t)M * N;
      splitk_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
          part, splits, (const float*)gs, (const float*)gw,
          (const bf16*)bias, out, out_f32, M, N);
    }
  }
  return (int)cudaGetLastError();
}
