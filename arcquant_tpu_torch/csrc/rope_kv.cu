// RoPE on q and k, then the int4 K/V quantize and append into the paged
// pool, in one launch a layer (#17 rope_kv).
//
// Replaces no pallas_call. In the JAX package these are three functions
// inside the one jitted step, arcquant_tpu/models/llama.py apply_rope
// and arcquant_tpu/cache/paged.py quantize_kv and append_kv, which XLA
// fuses into a few elementwise fusions; run eagerly in PyTorch they
// were some 50 small launches a layer. This kernel is the port's
// counterpart of that fusion. Plain PyTorch version:
// arcquant_tpu_torch/kernels/rope_kv.py rope_append_kv_plain
// (llama.apply_rope, then paged.append_kv).
//
// Numerics, bit for bit the plain version's:
//   RoPE, rotate-half in f32: out[d] = x[d] * cos[d] + r[d] * sin[d] with
//   r = (-x[d + Dh/2] | x[d - Dh/2]), three roundings (__fmul_rn,
//   __fadd_rn: nvcc would otherwise contract to an FMA), then one to
//   bf16.
//   quantize (K from the rounded k_rot, V from v), a (token, kv head)
//   row of Dh values: scale = max(max - min, 1e-5) / 15, code =
//   clamp(rint((x - min) / scale), 0, 15) (ties to even), IEEE divides
//   (__fdiv_rn); split-half packing, byte d = code[d] | code[d + Dh/2]
//   << 4.
//   the write: codes[pidx, 0|1, h, off, :] and (scale_k, min_k, scale_v,
//   min_v) at params[pidx, h, off, :], pidx = page_table[b, pos / page],
//   off = pos % page. A position < 0 writes nothing (the plain version
//   sends it to the sink page 0, which nothing reads); one past the page
//   table is a device-side assert, as the plain version's gather is.
//
// Layout: q, k, v are read in place as the strided column views of the
// fused qkv GEMM's output (a row stride per batch row and per token, the
// heads contiguous at Dh); q_out [B, T, Hq, Dh] and k_out [B, T, Hkv, Dh]
// are dense; cos, sin f32 [B, T, Dh].
//
// Design: one block per (token, kv head) over the group's g query heads,
// then K, then V, each head row on L = next_pow2(Dh / 16) lanes. Lane c
// of a row loads 8 elements of each half with one 16-byte load apiece,
// chunks [8c, 8c + 8) and [Dh/2 + 8c, Dh/2 + 8c + 8), so the rotate-half
// partner and the nibble partner of an element sit in the same lane and
// the lane packs its 8 code bytes into one 8-byte store; max and min go
// by shuffles within the row's L lanes. Bound on the H100: bytes (about
// 80 KB a Qwen2.5-7B decode call at batch 4, where the launch sets the
// pace; 78 MB at a 4 x 1024 prefill, 0.023 ms at 3.35 TB/s).
#include <cassert>

#include "common.cuh"

namespace {

constexpr int kMaxHeadDim = 256;

struct Args {
  const bf16 *q, *k, *v;
  const float *cos, *sin;
  bf16 *q_out, *k_out;
  uint8_t* codes;
  float* params;
  const int* page_table;
  const int64_t* positions;
  int T, hq, hkv, dh, page, pps, lanes;
  int64_t q_sb, q_st, k_sb, k_st, v_sb, v_st;
};

__device__ __forceinline__ float code_of(float x, float mn, float scale) {
  const float c = rintf(__fdiv_rn(__fsub_rn(x, mn), scale));
  return fminf(fmaxf(c, 0.0f), 15.0f);
}

__device__ __forceinline__ void load8(const bf16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8f(const float* p, float* out) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// Rounds 8 f32 values to bf16, stores them with one 16-byte store and
// keeps the rounded values.
__device__ __forceinline__ void store8(bf16* p, float* x) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
  *reinterpret_cast<uint4*>(p) = raw;
}

__global__ void rope_kv_kernel(Args a) {
  const int row = blockIdx.x;  // b * T + t
  const int b = row / a.T, t = row % a.T;
  const int hk = blockIdx.y;
  const int g = a.hq / a.hkv, half = a.dh / 2;
  const int c = threadIdx.x % a.lanes;      // this lane's chunk of each half
  const int slot = threadIdx.x / a.lanes;   // this lane's head row in a pass
  const int slots = blockDim.x / a.lanes;
  const bool chunk = 8 * c < half;          // Dh / 16 of the L lanes hold one

  const int64_t pos = a.positions[row];
  int64_t pidx = -1, off = 0;
  if (pos >= 0) {
    assert(pos / a.page < a.pps);
    pidx = a.page_table[(int64_t)b * a.pps + pos / a.page];
    off = pos % a.page;
  }
  float cs_lo[8], cs_hi[8], sn_lo[8], sn_hi[8];
  if (chunk) {
    const float* cs = a.cos + (int64_t)row * a.dh + 8 * c;
    const float* sn = a.sin + (int64_t)row * a.dh + 8 * c;
    load8f(cs, cs_lo);
    load8f(cs + half, cs_hi);
    load8f(sn, sn_lo);
    load8f(sn + half, sn_hi);
  }

  // every lane runs every pass (the shuffles need the whole warp); a lane
  // past the group's rows, or past Dh / 16, computes on zeros and stores
  // nothing
  for (int r0 = 0; r0 < g + 2; r0 += slots) {
    const int r = r0 + slot;
    const bool live = chunk && r < g + 2;
    const bf16* src = nullptr;
    bf16* dst = nullptr;
    int kv = -1;
    if (r < g) {
      const int h = hk * g + r;
      src = a.q + b * a.q_sb + t * a.q_st + (int64_t)h * a.dh;
      dst = a.q_out + ((int64_t)row * a.hq + h) * a.dh;
    } else if (r == g) {
      src = a.k + b * a.k_sb + t * a.k_st + (int64_t)hk * a.dh;
      dst = a.k_out + ((int64_t)row * a.hkv + hk) * a.dh;
      kv = 0;
    } else if (r == g + 1) {
      src = a.v + b * a.v_sb + t * a.v_st + (int64_t)hk * a.dh;
      kv = 1;
    }
    float lo[8], hi[8];
    if (live) {
      load8(src + 8 * c, lo);
      load8(src + half + 8 * c, hi);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) lo[j] = hi[j] = 0.0f;
    }
    if (live && dst != nullptr) {  // RoPE, rounded to bf16; K keeps the rounded values
      float ol[8], oh[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ol[j] = __fadd_rn(__fmul_rn(lo[j], cs_lo[j]), __fmul_rn(-hi[j], sn_lo[j]));
        oh[j] = __fadd_rn(__fmul_rn(hi[j], cs_hi[j]), __fmul_rn(lo[j], sn_hi[j]));
      }
      store8(dst + 8 * c, ol);
      store8(dst + half + 8 * c, oh);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        lo[j] = ol[j];
        hi[j] = oh[j];
      }
    }
    float mx = -INFINITY, mn = INFINITY;
    if (live) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx = fmaxf(mx, fmaxf(lo[j], hi[j]));
        mn = fminf(mn, fminf(lo[j], hi[j]));
      }
    }
    for (int o = a.lanes / 2; o > 0; o >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    }
    if (!live || kv < 0 || pidx < 0) continue;
    const float scale = __fdiv_rn(fmaxf(__fsub_rn(mx, mn), 1e-5f), 15.0f);
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t byte = (uint32_t)code_of(lo[j], mn, scale) |
                            ((uint32_t)code_of(hi[j], mn, scale) << 4);
      packed[j / 4] |= byte << (8 * (j % 4));
    }
    uint8_t* crow = a.codes + (((pidx * 2 + kv) * a.hkv + hk) * a.page + off) * half;
    *reinterpret_cast<uint2*>(crow + 8 * c) = make_uint2(packed[0], packed[1]);
    if (c == 0) {
      float* prow = a.params + ((pidx * a.hkv + hk) * a.page + off) * 4 + 2 * kv;
      *reinterpret_cast<float2*>(prow) = make_float2(scale, mn);
    }
  }
}

}  // namespace

// q, k, v: bf16 [B, T, H, Dh] views with unit element stride and head
// stride Dh (row strides q_sb, q_st, ...; elements, multiples of 8, the
// base 16-byte aligned). cos, sin: f32 [B, T, Dh] dense. q_out, k_out:
// dense bf16 [B, T, Hq, Dh], [B, T, Hkv, Dh]. codes: uint8 [P, 2, Hkv,
// page, Dh/2]; params: f32 [P, Hkv, page, 4] (one layer, 16-byte
// aligned). page_table: int32 [B, pps]; positions: int64 [B, T]. Needs
// Hq % Hkv == 0, Dh a multiple of 16 and <= 256.
ARC_EXPORT int arc_rope_kv(const void* q, const void* k, const void* v, const void* cos,
                           const void* sin, void* q_out, void* k_out, void* codes, void* params,
                           const void* page_table, const void* positions, int B, int T, int hq, int hkv, int dh, int page, int pps,
                           int64_t q_sb, int64_t q_st, int64_t k_sb, int64_t k_st,
                           int64_t v_sb, int64_t v_st, void* stream) {
  if (dh % 16 || dh > kMaxHeadDim || hkv <= 0 || hq % hkv) return (int)cudaErrorInvalidValue;
  if (B * T == 0) return (int)cudaGetLastError();
  int lanes = 1;
  while (lanes < dh / 16) lanes *= 2;
  Args a{(const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)cos, (const float*)sin,
         (bf16*)q_out, (bf16*)k_out, (uint8_t*)codes, (float*)params, (const int*)page_table,
         (const int64_t*)positions, T, hq, hkv, dh, page, pps, lanes,
         q_sb, q_st, k_sb, k_st, v_sb, v_st};
  // one pass over the group's rows where 512 threads hold them
  const int rows = hq / hkv + 2;
  const int threads = min((rows * lanes + 31) / 32 * 32, 512);
  const dim3 grid((unsigned)(B * T), (unsigned)hkv);
  rope_kv_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
