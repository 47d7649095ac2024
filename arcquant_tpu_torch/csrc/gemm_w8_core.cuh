// What every small-M dequant GEMM of the library shares: the k-tile depth,
// the epilogue and the split-K sum.
//
// Included by gemm_small_m.cuh, whose mainloop (gemm_small_tile) the
// chain's gemm_w8 and gemm_w4 run at M <= 64, as do gemm_batched and the
// decode megakernels (mlp_fused.cu: gemm_actq, gu_actq, mlp_w8), and by
// gemm_lab.cu. The fused kernels must give the chain's bits exactly: all
// of them run that one mainloop, promote each 32-deep k-tile's partial
// into the f32 total in k order, and share the split-K sum and the
// epilogue below.
//
// What fixes an output element's value: each 32-deep k-tile's product
// starts from zero, runs the tile's two k = 16 MMAs in order and is
// added to the f32 total with __fadd_rn; a split's total covers its
// k-tiles in order from its first; the splits are then summed in split
// order from 0.0f (sum_splits). Which warp or block computes an element
// does not change its sums.
// The epilogue applies the per-row activation scale, the per-channel (or
// scalar) weight scale and the bias in f32 in the JAX kernel's order
// (uncontracted: __fmul_rn, __fadd_rn, so no FMA changes the rounding).
// The per-row scale is read with __ldcg (L2 only): in the fused kernels
// another block of the same launch wrote it, and an SM's L1 is not
// coherent with that block's stores.
#pragma once

#include "common.cuh"

namespace w8 {

constexpr int BK = 32;

// y = v * gs[gm] * gw[gn] (+ bias[gn]) stored at out[idx] as bf16 or f32.
__device__ __forceinline__ void store_out(float v, int64_t idx, int gm, int gn,
                                          const float* gs, const float* gw,
                                          const bf16* bias, void* out, int out_f32) {
  float y = __fmul_rn(__fmul_rn(v, __ldcg(gs + gm)), gw[gn]);
  if (bias != nullptr) y = __fadd_rn(y, bf2f(bias[gn]));
  if (out_f32) reinterpret_cast<float*>(out)[idx] = y;
  else reinterpret_cast<bf16*>(out)[idx] = f2bf(y);
}

// The split-K total of element idx of an [M, N] output: the splits'
// partials ([splits, M, N], mn = M * N) summed in split order from 0.0f.
__device__ __forceinline__ float sum_splits(const float* partial, int splits, int64_t mn,
                                            int64_t idx) {
  float v = 0.0f;
  for (int s = 0; s < splits; ++s) v += __ldcg(partial + s * mn + idx);
  return v;
}

// Sums the split-K partials in split order, then the same epilogue.
static __global__ void splitk_reduce_kernel(const float* __restrict__ partial, int splits,
                                            const float* __restrict__ gs,
                                            const float* __restrict__ gw,
                                            const bf16* __restrict__ bias,
                                            void* __restrict__ out, int out_f32, int M, int N) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)M * N) return;
  const float v = sum_splits(partial, splits, (int64_t)M * N, idx);
  store_out(v, idx, (int)(idx / N), (int)(idx % N), gs, gw, bias, out, out_f32);
}

}  // namespace w8
