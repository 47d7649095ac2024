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
// pipeline are later work.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BK = 32;

template <int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(WM * WN * 32)
gemm_w8_kernel(const bf16* __restrict__ xa, const int8_t* __restrict__ codes,
               const uint8_t* __restrict__ scales, const float* __restrict__ gs,
               const float* __restrict__ gw,
               const bf16* __restrict__ bias, void* __restrict__ out, int out_f32,
               float* __restrict__ partial, int M, int N, int Kq, int tiles_per_split) {
  constexpr int NT = WM * WN * 32;
  constexpr int WTM = BM / WM, WTN = BN / WN;
  constexpr int FM = WTM / 16, FN = WTN / 16;
  constexpr int LDA = BK + 8, LDB = BN + 8;
  constexpr int A_CHUNKS = BM * BK / 8;   // 8 bf16 per 16-byte chunk
  constexpr int B_CHUNKS = BK * BN / 16;  // 16 codes per 16-byte chunk
  constexpr int A_PER_T = (A_CHUNKS + NT - 1) / NT;
  constexpr int B_PER_T = (B_CHUNKS + NT - 1) / NT;

  __shared__ __align__(128) bf16 As[BM * LDA];
  __shared__ __align__(128) bf16 Bs[BK * LDB];
  __shared__ __align__(128) float Cs[WM * WN][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kt0 = blockIdx.z * tiles_per_split;
  const int kt1 = min(kt0 + tiles_per_split, Kq / BK);
  const bool vec_n = (N % 16) == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  uint4 a_reg[A_PER_T], c_reg[B_PER_T], s_reg[B_PER_T];

  auto load_tile = [&](int kt) {
#pragma unroll
    for (int i = 0; i < A_PER_T; ++i) {
      const int c = tid + i * NT;
      a_reg[i] = make_uint4(0, 0, 0, 0);
      if (c < A_CHUNKS) {
        const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
        if (m0 + r < M)
          a_reg[i] = *reinterpret_cast<const uint4*>(xa + (int64_t)(m0 + r) * Kq + kt * BK + kc);
      }
    }
#pragma unroll
    for (int i = 0; i < B_PER_T; ++i) {
      const int c = tid + i * NT;
      c_reg[i] = make_uint4(0, 0, 0, 0);
      s_reg[i] = make_uint4(0, 0, 0, 0);
      if (c < B_CHUNKS) {
        const int r = c / (BN / 16), nc = (c % (BN / 16)) * 16;
        const int gk = kt * BK + r, gn = n0 + nc;
        const int8_t* cp = codes + (int64_t)gk * N + gn;
        const uint8_t* sp = scales + (int64_t)(gk / 16) * N + gn;
        if (vec_n && gn + 16 <= N) {
          c_reg[i] = *reinterpret_cast<const uint4*>(cp);
          s_reg[i] = *reinterpret_cast<const uint4*>(sp);
        } else {
          uint8_t* cb = reinterpret_cast<uint8_t*>(&c_reg[i]);
          uint8_t* sb = reinterpret_cast<uint8_t*>(&s_reg[i]);
          for (int j = 0; j < 16 && gn + j < N; ++j) {
            cb[j] = (uint8_t)cp[j];
            sb[j] = sp[j];
          }
        }
      }
    }
  };

  auto store_tile = [&]() {
#pragma unroll
    for (int i = 0; i < A_PER_T; ++i) {
      const int c = tid + i * NT;
      if (c < A_CHUNKS) {
        const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
        *reinterpret_cast<uint4*>(As + r * LDA + kc) = a_reg[i];
      }
    }
#pragma unroll
    for (int i = 0; i < B_PER_T; ++i) {
      const int c = tid + i * NT;
      if (c < B_CHUNKS) {
        const int r = c / (BN / 16), nc = (c % (BN / 16)) * 16;
        const int8_t* cb = reinterpret_cast<const int8_t*>(&c_reg[i]);
        const uint8_t* sb = reinterpret_cast<const uint8_t*>(&s_reg[i]);
        __align__(16) bf16 wv[16];
#pragma unroll
        for (int j = 0; j < 16; ++j)
          wv[j] = f2bf((float)cb[j] * (ue4m3_decode(sb[j]) * 0.5f));
        uint4* dst = reinterpret_cast<uint4*>(Bs + r * LDB + nc);
        dst[0] = reinterpret_cast<const uint4*>(wv)[0];
        dst[1] = reinterpret_cast<const uint4*>(wv)[1];
      }
    }
  };

  if (kt0 < kt1) load_tile(kt0);
  for (int kt = kt0; kt < kt1; ++kt) {
    store_tile();
    __syncthreads();
    if (kt + 1 < kt1) load_tile(kt + 1);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> part[FM][FN];
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(part[i][j], 0.0f);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(af[i], As + (wm * WTM + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(bfr[j], Bs + kk * LDB + wn * WTN + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(part[i][j], af[i], bfr[j], part[i][j]);
    }
    // promote: accumulator fragments of one shape share their layout
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int e = 0; e < part[i][j].num_elements; ++e)
          acc[i][j].x[e] = __fadd_rn(acc[i][j].x[e], part[i][j].x[e]);
    __syncthreads();
  }

  float* cs = Cs[warp];
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gm = m0 + wm * WTM + i * 16 + e / 16;
        const int gn = n0 + wn * WTN + j * 16 + e % 16;
        if (gm < M && gn < N) {
          const float v = cs[e];
          if (partial != nullptr) {
            partial[((int64_t)blockIdx.z * M + gm) * N + gn] = v;
          } else {
            float y = __fmul_rn(__fmul_rn(v, gs[gm]), gw[gn]);
            if (bias != nullptr) y = __fadd_rn(y, bf2f(bias[gn]));
            if (out_f32) reinterpret_cast<float*>(out)[(int64_t)gm * N + gn] = y;
            else reinterpret_cast<bf16*>(out)[(int64_t)gm * N + gn] = f2bf(y);
          }
        }
      }
      __syncwarp();
    }
  }
}

// Sums the split-K partials in split order, then the same epilogue.
__global__ void splitk_reduce_kernel(const float* __restrict__ partial, int splits,
                                     const float* __restrict__ gs,
                                     const float* __restrict__ gw,
                                     const bf16* __restrict__ bias, void* __restrict__ out,
                                     int out_f32, int M, int N) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)M * N) return;
  const int gm = (int)(idx / N), gn = (int)(idx % N);
  float v = 0.0f;
  for (int s = 0; s < splits; ++s) v += partial[(int64_t)s * M * N + idx];
  float y = __fmul_rn(__fmul_rn(v, gs[gm]), gw[gn]);
  if (bias != nullptr) y = __fadd_rn(y, bf2f(bias[gn]));
  if (out_f32) reinterpret_cast<float*>(out)[idx] = y;
  else reinterpret_cast<bf16*>(out)[idx] = f2bf(y);
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
