// Shared device helpers for the arcquant_tpu_torch kernels.
//
// The NVFP4 helpers reproduce arcquant_tpu_torch/quant/numerics.py bit
// for bit. They rely on IEEE f32 arithmetic: the library is built
// without --use_fast_math, so `/` is the correctly rounded divide,
// sqrtf is correctly rounded, and expf is the full-precision libdevice
// function (not __expf).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define ARC_EXPORT extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16_rn(v); }

constexpr float kInvE2m1Max = 0x1.555556p-3f;         // f32(1/6)
constexpr float kInvNvfp4GlobalDiv = 0x1.861862p-12f;  // f32(1/2688)
constexpr float kUe4m3Min = 0.001953125f;  // 2^-9
constexpr float kUe4m3Max = 448.0f;
constexpr float kNegInf = -1e30f;          // the JAX kernels' mask value

// quantize_ue4m3: clamp to [2^-9, 448], then round to the e4m3fn grid
// with ties to even. Subnormals (< 2^-6) take a fixed 2^-9 step
// (rintf rounds half to even; roundf would not); normals round the f32
// mantissa to 3 bits with the RNE bit trick.
__device__ __forceinline__ float ue4m3_qdq(float s) {
  s = fminf(fmaxf(s, kUe4m3Min), kUe4m3Max);
  if (s < 0.015625f) return rintf(s * 512.0f) * (1.0f / 512.0f);
  uint32_t b = __float_as_uint(s);
  uint32_t rb = (b + 0x7FFFFu + ((b >> 20) & 1u)) & ~0xFFFFFu;
  return fminf(__uint_as_float(rb), kUe4m3Max);
}

// ue4m3 byte -> f32 value (e == 0 is the subnormal m * 2^-9).
__device__ __forceinline__ float ue4m3_decode(uint32_t byte) {
  uint32_t e = (byte >> 3) & 0xFu, m = byte & 7u;
  if (e == 0) return (float)m * 0.001953125f;
  return __uint_as_float(((e + 120u) << 23) | (m << 20));
}

// e2m1x nibble (the w4 storage order: e2m1 with magnitude codes 0 and 1
// swapped) -> f32 value: the magnitude bits land in the exponent and
// mantissa fields, the sign bit in place; mag 1 is zero (+0).
__device__ __forceinline__ float e2m1x_decode(uint32_t nib) {
  const uint32_t mag = nib & 7u;
  const float f = __uint_as_float(((mag << 22) | ((nib & 8u) << 28)) + 0x3F000000u);
  return mag == 1u ? 0.0f : f;
}

// e2m1 quantize-dequantize of x in units of `scale`: boundary compares
// run in product space (|x| > b*scale, exact f32 products), strict `>`
// so ties go to the smaller magnitude; returns +-value * scale.
__device__ __forceinline__ float e2m1_qdq(float x, float scale) {
  const float mag = fabsf(x);
  int idx = (mag > 0.25f * scale) + (mag > 0.75f * scale) +
            (mag > 1.25f * scale) + (mag > 1.75f * scale) +
            (mag > 2.5f * scale) + (mag > 3.5f * scale) +
            (mag > 5.0f * scale);
  // E2M1 magnitudes {0, .5, 1, 1.5, 2, 3, 4, 6}
  const float val = idx < 4 ? 0.5f * (float)idx
                  : idx == 4 ? 2.0f : idx == 5 ? 3.0f : idx == 6 ? 4.0f : 6.0f;
  return (x < 0.0f ? -val : val) * scale;
}

template <typename Op>
__device__ __forceinline__ float warp_reduce(float v, Op op) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

struct MaxOp { __device__ float operator()(float a, float b) const { return fmaxf(a, b); } };
struct SumOp { __device__ float operator()(float a, float b) const { return a + b; } };

// Block-wide reduction; `scratch` holds >= 32 floats. All threads get
// the result.
template <typename Op>
__device__ float block_reduce(float v, float* scratch, Op op, float init) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = warp_reduce(v, op);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < nwarps ? scratch[lane] : init;
  return warp_reduce(v, op);
}

// 16-byte cp.async from global to shared memory; !pred fills the 16
// bytes with zeros (src-size 0) and reads nothing. Both addresses must
// be 16-byte aligned.
__device__ __forceinline__ void cp16(void* smem, const void* gmem, bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// bf16 tensor-core helpers (mma.sync m16n8k16 with f32 accumulators, and
// ldmatrix), shared by flash_attn.cu and paged_prefill.cu.

// d += a * b over one m16n8k16 tile; a holds the A fragment, b0 and b1
// the B fragment (PTX's register layouts).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t v) {
  return *reinterpret_cast<const __nv_bfloat162*>(&v);
}

// bf16 pair (lo, hi) rounded to nearest, lo in the low 16 bits.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return bits(__floats2bfloat162_rn(lo, hi));
}

// Two bf16 halves of the f32 pair (x, y): hi = bf16(x, y), lo = bf16 of
// the remainders (exact in f32), x in the low 16 bits as mma expects.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}
