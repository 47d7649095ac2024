// The per-row NVFP4 activation quantize, as device functions.
//
// Included by actq.cu (the actq kernel of the unfused chain) and by
// mlp_fused.cu (the decode megakernels gemm_actq, gu_actq and mlp_w8).
// The fused kernels must give the chain's bits exactly, so both run this
// one copy of the pre-op, the row reductions and the group quantize:
// the rmsnorm sum of squares is a 256-thread strided sum followed by
// block_reduce, and a fused kernel reproduces it only by calling
// actq_row with a block of the same 256 threads.
#pragma once

#include "common.cuh"

enum { kModePlain = 0, kModeRmsnorm = 1, kModeSiluMul = 2 };

// Threads of every block that runs actq_row (its reduction order).
constexpr int kActqThreads = 256;

// silu(g) * u in f32 with the full-precision expf, rounded to bf16 (the
// engine's rounding point before the down_in quantize).
__device__ __forceinline__ bf16 silu_mul_bf16(bf16 g, bf16 u) {
  const float gf = bf2f(g), uf = bf2f(u);
  return f2bf((gf * (1.0f / (1.0f + expf(-gf)))) * uf);
}

// Per-row global scale from the row's |x| max.
__device__ __forceinline__ float row_scale(float amax) {
  return fmaxf(amax * kInvNvfp4GlobalDiv, 1e-12f);
}

// One 16-group: xs = v / g (the one true division, IEEE), group scale
// ue4m3(absmax(xs) * f32(1/6)), e2m1 qdq in product space, written as
// 16 bf16 (exact: <= 7 significant bits) to 16-byte aligned dst.
__device__ __forceinline__ void quantize_group16(const float (&v)[16], float g,
                                                 bf16* dst) {
  float xs[16];
  float gmax = 0.0f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    xs[j] = v[j] / g;
    gmax = fmaxf(gmax, fabsf(xs[j]));
  }
  const float sc = ue4m3_qdq(gmax * kInvE2m1Max);
  __align__(16) bf16 outv[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) outv[j] = f2bf(e2m1_qdq(xs[j], sc));
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  d4[0] = reinterpret_cast<const uint4*>(outv)[0];
  d4[1] = reinterpret_cast<const uint4*>(outv)[1];
}

// Quantizes one row with the calling block of kActqThreads threads.
// Pass 1 applies the pre-op (plain x, rmsnorm(x)*w, or silu(gate)*up over
// src[0, k) and src[k, 2k)), keeps the bf16 row in `row` (k bf16 of
// shared memory) and reduces |x|max to the row scale; pass 2 quantizes
// one 16-group per thread into dst[0, k) and zero-fills dst[k, kq).
// `red` is >= 32 floats of shared memory. Writes *gx_out = the scale.
static __device__ void actq_row(const bf16* __restrict__ src, const bf16* __restrict__ w,
                                bf16* __restrict__ dst, float* __restrict__ gx_out, int k,
                                int kq, int mode, float eps, bf16* row, float* red) {
  const int tid = threadIdx.x, nt = blockDim.x;

  float inv_rms = 0.0f;
  if (mode == kModeRmsnorm) {
    float ss = 0.0f;
    for (int i = tid; i < k; i += nt) {
      const float v = bf2f(src[i]);
      ss += v * v;
    }
    ss = block_reduce(ss, red, SumOp(), 0.0f);
    inv_rms = 1.0f / sqrtf(ss / (float)k + eps);
  }

  float amax = 0.0f;
  for (int i = tid; i < k; i += nt) {
    bf16 v;
    if (mode == kModeRmsnorm) {
      v = __hmul(f2bf(bf2f(src[i]) * inv_rms), w[i]);
    } else if (mode == kModeSiluMul) {
      v = silu_mul_bf16(src[i], src[i + k]);
    } else {
      v = src[i];
    }
    row[i] = v;
    amax = fmaxf(amax, fabsf(bf2f(v)));
  }
  amax = block_reduce(amax, red, MaxOp(), 0.0f);
  const float g = row_scale(amax);

  for (int grp = tid; grp < k / 16; grp += nt) {
    float v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = bf2f(row[grp * 16 + j]);
    quantize_group16(v, g, dst + grp * 16);
  }
  const bf16 zero = f2bf(0.0f);
  for (int i = k + tid; i < kq; i += nt) dst[i] = zero;
  if (tid == 0) *gx_out = g;
}
