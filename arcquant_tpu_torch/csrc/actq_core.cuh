// The per-row NVFP4 activation quantize, as device functions.
//
// Included by actq.cu (the actq kernel of the unfused chain) and by
// mlp_fused.cu (phase A of the decode megakernels gemm_actq and mlp_w8;
// their phase C2 runs quantize_group16). Both walk an [M, K] activation
// the same way (actq_walk): the flattened (row, 16-group) space is cut
// into one contiguous range per block, so a row may be split over many
// blocks, and every block that quantizes part of a row computes that
// row's reductions itself, over the whole row (actq_row_range). No
// block waits for another, nothing goes through atomics, and the chain
// and the megakernels give the same bits whatever their block counts.
//
// A row of K bf16 (K % 16 == 0) is C = K / 8 chunks of 8 values (one
// 16-byte load or store). Thread t of a block's kActqThreads owns chunks
// t, t + 256, t + 512, ... (its passes 0, 1, 2, ...). The two chunks of
// a 16-group are on neighbouring lanes of one warp, so the group's max is
// one __shfl_xor_sync, and each lane runs 8 of the group's 16 divides. A
// thread keeps the pre-op values of its first kKeep passes in registers
// (a whole row of K <= 4096); the chunks beyond them that the block
// quantizes go to shared memory (`spill`), each written and read back as
// one 16-byte vector by the thread that owns it (no bank conflict, no
// barrier).
//
// The rmsnorm sum of squares is taken in an order that is a function of
// K alone (not of M, of the block count or of which block computes it):
//   1. thread t (0..255) starts from 0.0f and adds x^2 of the 8 elements
//      of each of its chunks, chunk by chunk in pass order and in element
//      order within a chunk (fmaf(x, x, s): the square of a bf16 is exact
//      in f32, so each step is one rounded f32 add);
//   2. each warp sums its 32 lanes' totals by a butterfly: s += s of lane
//      (lane ^ o) for o = 16, 8, 4, 2, 1;
//   3. the 8 warp totals, in lanes 0..7 of a warp whose lanes 8..31 hold
//      0.0f, are summed by the same butterfly.
// Then inv_rms = 1.0f / sqrtf(ss / K + eps) (correctly rounded, not
// rsqrtf). kernels/quantize.py:rms_norm_kernel_order emulates this order
// in plain torch; tests/test_torch_actq_order.py holds the emulation
// against the JAX package, and tests/test_torch_kernels_gpu.py the
// kernel's bits against the emulation on the card.
#pragma once

#include "common.cuh"

enum { kModePlain = 0, kModeRmsnorm = 1, kModeSiluMul = 2 };

// Threads of every block that runs the row routine (its sum order).
constexpr int kActqThreads = 256;
// Passes of a row a thread keeps in registers: rows of K <= 4096 whole.
constexpr int kKeep = 2;
constexpr int kKeepChunks = kKeep * kActqThreads;

// Shared memory (bytes) a block needs for the chunks of a K-column row
// beyond the kept passes.
__host__ __device__ constexpr size_t actq_spill_bytes(int k) {
  return k / 8 > kKeepChunks ? (size_t)(k / 8 - kKeepChunks) * 16 : 0;
}

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

// -- chunks of 8 bf16 ---------------------------------------------------------

__device__ __forceinline__ uint4 ld_chunk(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const float2 a = __bfloat1622float2(as_bf162(u.x)), b = __bfloat1622float2(as_bf162(u.y));
  const float2 c = __bfloat1622float2(as_bf162(u.z)), d = __bfloat1622float2(as_bf162(u.w));
  f[0] = a.x, f[1] = a.y, f[2] = b.x, f[3] = b.y;
  f[4] = c.x, f[5] = c.y, f[6] = d.x, f[7] = d.y;
}

// 8 floats rounded to bf16 (to nearest even), packed.
__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                    pack2(f[6], f[7]));
}

__device__ __forceinline__ float sumsq8(const uint4& x, float s) {
  float f[8];
  unpack8(x, f);
#pragma unroll
  for (int j = 0; j < 8; ++j) s = fmaf(f[j], f[j], s);
  return s;
}

__device__ __forceinline__ float absmax8(const uint4& v, float m) {
  float f[8];
  unpack8(v, f);
#pragma unroll
  for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(f[j]));
  return m;
}

// rmsnorm(x) * w of a chunk: f32 normalise, round to bf16, bf16 multiply
// (one rounding of the exact product, as __hmul).
__device__ __forceinline__ uint32_t rms_pair(uint32_t x, uint32_t w, float inv_rms) {
  const float2 xf = __bfloat1622float2(as_bf162(x));
  return bits(__hmul2(__floats2bfloat162_rn(xf.x * inv_rms, xf.y * inv_rms), as_bf162(w)));
}

__device__ __forceinline__ uint4 rms_chunk(const uint4& x, const uint4& w, float inv_rms) {
  return make_uint4(rms_pair(x.x, w.x, inv_rms), rms_pair(x.y, w.y, inv_rms),
                    rms_pair(x.z, w.z, inv_rms), rms_pair(x.w, w.w, inv_rms));
}

__device__ __forceinline__ uint32_t silu_pair(uint32_t g, uint32_t u) {
  const __nv_bfloat162 gv = as_bf162(g), uv = as_bf162(u);
  return bits(__halves2bfloat162(silu_mul_bf16(__low2bfloat16(gv), __low2bfloat16(uv)),
                                 silu_mul_bf16(__high2bfloat16(gv), __high2bfloat16(uv))));
}

__device__ __forceinline__ uint4 silu_chunk(const uint4& g, const uint4& u) {
  return make_uint4(silu_pair(g.x, u.x), silu_pair(g.y, u.y), silu_pair(g.z, u.z),
                    silu_pair(g.w, u.w));
}

// The second input of chunk c: w (rmsnorm) or up (silu_mul), else zeros.
template <int MODE>
__device__ __forceinline__ uint4 ld_second(const bf16* src, const bf16* w, int c, int k) {
  if (MODE == kModeRmsnorm) return ld_chunk(w + 8 * c);
  if (MODE == kModeSiluMul) return ld_chunk(src + k + 8 * c);
  return make_uint4(0u, 0u, 0u, 0u);
}

// MODE's pre-op of a chunk from its inputs x (or gate) and y (w or up).
template <int MODE>
__device__ __forceinline__ uint4 preop(const uint4& x, const uint4& y, float inv_rms) {
  if (MODE == kModeRmsnorm) return rms_chunk(x, y, inv_rms);
  if (MODE == kModeSiluMul) return silu_chunk(x, y);
  return x;
}

// Quantizes chunk v, one half of a 16-group whose other half the
// partner lane (lane ^ 1) holds, with the row scale g, into dst when
// `store`. Every lane of the warp calls it together.
__device__ __forceinline__ void quantize_chunk(const uint4& v, float g, bool store, bf16* dst) {
  float f[8], xs[8];
  unpack8(v, f);
  float gmax = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    xs[j] = f[j] / g;
    gmax = fmaxf(gmax, fabsf(xs[j]));
  }
  gmax = fmaxf(gmax, __shfl_xor_sync(0xffffffffu, gmax, 1));
  const float sc = ue4m3_qdq(gmax * kInvE2m1Max);
#pragma unroll
  for (int j = 0; j < 8; ++j) xs[j] = e2m1_qdq(xs[j], sc);
  if (store) *reinterpret_cast<uint4*>(dst) = pack8(xs);
}

// Quantizes the 16-groups [g0, g1) (g0 < g1) of one row with the calling
// block of kActqThreads threads: the pre-op (plain x, rmsnorm(x)*w, or
// silu(gate)*up over src[0, k) and src[k, 2k)), the row scale from the
// |max| of the whole row, and the groups into dst; also zeros into
// dst[k, kq) when g1 is the row's last group, and *gx_out = the scale
// when g0 == 0. src, w and dst 16-byte aligned; `spill` holds
// actq_spill_bytes(k) of shared memory, `red` >= 32 floats.
template <int MODE>
__device__ void actq_row_range(const bf16* __restrict__ src, const bf16* __restrict__ w,
                               bf16* __restrict__ dst, float* __restrict__ gx_out, int k,
                               int kq, float eps, int g0, int g1, uint4* spill, float* red) {
  const int tid = threadIdx.x, nc = k / 8, c0 = 2 * g0, c1 = 2 * g1;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // the kept passes' inputs, all loads in flight before any arithmetic
  uint4 keep[kKeep], second[kKeep];
#pragma unroll
  for (int p = 0; p < kKeep; ++p) {
    const int c = tid + p * kActqThreads;
    keep[p] = zero;
    second[p] = zero;
    if (c < nc) {
      keep[p] = ld_chunk(src + 8 * c);
      second[p] = ld_second<MODE>(src, w, c, k);
    }
  }

  float inv_rms = 0.0f;
  if (MODE == kModeRmsnorm) {  // the sum order of the header
    float ss = 0.0f;
#pragma unroll
    for (int p = 0; p < kKeep; ++p)
      if (tid + p * kActqThreads < nc) ss = sumsq8(keep[p], ss);
    for (int c = tid + kKeepChunks; c < nc; c += kActqThreads)
      ss = sumsq8(ld_chunk(src + 8 * c), ss);
    ss = block_reduce(ss, red, SumOp(), 0.0f);
    inv_rms = 1.0f / sqrtf(ss / (float)k + eps);
  }

  float amax = 0.0f;
#pragma unroll
  for (int p = 0; p < kKeep; ++p) {
    if (tid + p * kActqThreads < nc) {
      keep[p] = preop<MODE>(keep[p], second[p], inv_rms);
      amax = absmax8(keep[p], amax);
    }
  }
  for (int c = tid + kKeepChunks; c < nc; c += kActqThreads) {
    const uint4 v = preop<MODE>(ld_chunk(src + 8 * c), ld_second<MODE>(src, w, c, k), inv_rms);
    amax = absmax8(v, amax);
    if (c >= c0 && c < c1) spill[c - kKeepChunks] = v;
  }
  const float g = row_scale(block_reduce(amax, red, MaxOp(), 0.0f));

  // the block's groups; the pass loops are uniform over the block, so
  // every lane reaches each shuffle (a group's lanes agree on `mine`:
  // c0, c1 and nc are even)
#pragma unroll
  for (int p = 0; p < kKeep; ++p) {
    const int c = tid + p * kActqThreads;
    if (p * kActqThreads < c1 && (p + 1) * kActqThreads > c0)
      quantize_chunk(keep[p], g, c >= c0 && c < c1, dst + 8 * c);
  }
  for (int p = max(kKeep, c0 / kActqThreads); p * kActqThreads < c1; ++p) {
    const int c = tid + p * kActqThreads;
    const bool mine = c >= c0 && c < c1;
    quantize_chunk(mine ? spill[c - kKeepChunks] : zero, g, mine, dst + 8 * c);
  }

  if (g1 == k / 16)
    for (int c = nc + tid; c < kq / 8; c += kActqThreads)
      *reinterpret_cast<uint4*>(dst + 8 * c) = zero;
  if (g0 == 0 && tid == 0) *gx_out = g;
}

// Block b of nb quantizes the range [M G b / nb, M G (b + 1) / nb) of the
// flattened (row, group) space of src [M, k] (row stride lda), G = k / 16,
// into dst [M, kq] and gx [M]: each row it meets, from the row's
// reductions on.
template <int MODE>
__device__ void actq_walk(const bf16* src, int64_t lda, const bf16* w, bf16* dst, int kq,
                          float* gx, int M, int k, float eps, int b, int nb, uint4* spill,
                          float* red) {
  const int64_t groups = k / 16, total = (int64_t)M * groups;
  const int64_t f0 = total * b / nb, f1 = total * (b + 1) / nb;
  for (int64_t r = f0 / groups; f0 < f1 && r * groups < f1; ++r) {
    const int64_t lo = f0 - r * groups, hi = f1 - r * groups;
    const int g0 = lo > 0 ? (int)lo : 0, g1 = hi < groups ? (int)hi : (int)groups;
    actq_row_range<MODE>(src + r * lda, w, dst + r * kq, gx + r, k, kq, eps, g0, g1, spill,
                         red);
  }
}
