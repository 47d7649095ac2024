// The dequant GEMM's WMMA small-M tile (gemm_tile), as device functions,
// with the split-K sum and the epilogue that every small-M GEMM shares.
//
// Included by gemm_small_m.cuh (the chain's GEMM at M <= 64 runs its own
// mainloop, but this file's epilogue, split-K reduce and k order), by
// mlp_fused.cu (the decode megakernels gemm_actq, gu_actq and mlp_w8),
// gemm_batched.cu and gemm_lab.cu, which run gemm_tile. The fused kernels
// must give the chain's bits exactly: both keep the k order below, the
// promotion of each k-tile's partial into the f32 total, the split-K sum
// and the epilogue.
//
// The weight format is the tile's B loader (kW4): w8 reads int8 codes
// [Kq, N], one code row per k row; w4 reads uint8 codes [Kq/2, N], one
// code row per two k rows (low nibble k = 2g, high nibble k = 2g+1), and
// writes the same two bf16 rows into the shared B tile that w8 writes
// for the same weight. Both decodes are exact in bf16 (an e2m1 value
// times a ue4m3 scale has at most 6 significant bits), so the w4 GEMM
// equals the w8 GEMM bit for bit at every M; it only moves half the code
// bytes.
//
// What fixes an output element's value: its 16x16 WMMA fragment starts
// each 32-deep k-tile from zero, runs the tile's two k = 16 MMAs in order
// and adds the tile's partial to the f32 total with __fadd_rn; a split's
// total covers its k-tiles in order from its first; the splits are then
// summed in split order from 0.0f. A tile of another height or warp
// layout (the fused kernels' 16 rows x 8 warps, the chain's mma.sync
// tile of gemm_small_m.cuh) changes which warp computes an element, not
// that element's sums.
// The epilogue applies the per-row activation scale, the per-channel (or
// scalar) weight scale and the bias in f32 in the JAX kernel's order
// (uncontracted: __fmul_rn, __fadd_rn, so no FMA changes the rounding).
//
// In the fused kernels other blocks of the same launch wrote the
// activations and the per-row scales, and an SM's L1 is not coherent
// with their stores, so those read them with __ldcg (L2 only;
// kFromL2); gemm_batched reads them through the cached read-only path.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace w8 {

using namespace nvcuda;

constexpr int BK = 32;

template <int BM_, int BN_, int WM_, int WN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int NT = WM * WN * 32;
  static constexpr int WTM = BM / WM, WTN = BN / WN;
  static constexpr int FM = WTM / 16, FN = WTN / 16;
  static constexpr int LDA = BK + 8, LDB = BN + 8;
  static constexpr int A_CHUNKS = BM * BK / 8;   // 8 bf16 per 16-byte chunk
  static constexpr int A_PER_T = (A_CHUNKS + NT - 1) / NT;
  struct Smem {
    alignas(128) bf16 As[BM * LDA];
    alignas(128) bf16 Bs[BK * LDB];
    alignas(128) float Cs[WM * WN][16 * 16];
  };
};

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

// One BM x BN output tile at (m0, n0) over k-tiles [kt0, kt1), run by
// the block's T::NT threads. xa: [M, Kq] bf16; codes: [Kq, N] int8 (w8)
// or [Kq/2, N] bytes of e2m1x nibble pairs (kW4); scales: [Kq/16, N]
// uint8. With `partial` set, writes the tile's f32
// totals to partial[split] ([splits, M, N]); otherwise the epilogue into
// out. Each k-step decodes a 32 x BN weight tile into shared memory once
// and prefetches the next tile's codes, scales and activations into
// registers while the current one multiplies. Inlined, so that `sm`'s
// tiles are addressed as shared memory (a call would pass them as
// generic pointers).
template <class T, bool kFromL2, bool kW4 = false>
__device__ __forceinline__ void gemm_tile(
    const bf16* __restrict__ xa, const int8_t* __restrict__ codes,
    const uint8_t* __restrict__ scales, const float* gs, const float* __restrict__ gw,
    const bf16* __restrict__ bias, void* out, int out_f32, float* partial, int split, int M,
    int N, int Kq, int m0, int n0, int kt0, int kt1, typename T::Smem& sm) {
  constexpr int BN = T::BN, NT = T::NT;
  constexpr int LDA = T::LDA, LDB = T::LDB, FM = T::FM, FN = T::FN;
  constexpr int WTM = T::WTM, WTN = T::WTN, WN = T::WN;
  constexpr int A_CHUNKS = T::A_CHUNKS, A_PER_T = T::A_PER_T;
  // code rows per k-tile and per scale row; 16 codes per 16-byte chunk
  constexpr int CODE_ROWS = kW4 ? BK / 2 : BK, GROUP_ROWS = kW4 ? 8 : 16;
  constexpr int B_CHUNKS = CODE_ROWS * BN / 16;
  constexpr int B_PER_T = (B_CHUNKS + NT - 1) / NT;
  bf16* As = sm.As;
  bf16* Bs = sm.Bs;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WN, wn = warp % WN;
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
        if (m0 + r < M) {
          const uint4* src = reinterpret_cast<const uint4*>(
              xa + (int64_t)(m0 + r) * Kq + kt * BK + kc);
          a_reg[i] = kFromL2 ? __ldcg(src) : *src;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < B_PER_T; ++i) {
      const int c = tid + i * NT;
      c_reg[i] = make_uint4(0, 0, 0, 0);
      s_reg[i] = make_uint4(0, 0, 0, 0);
      if (c < B_CHUNKS) {
        const int r = c / (BN / 16), nc = (c % (BN / 16)) * 16;
        const int gk = kt * CODE_ROWS + r, gn = n0 + nc;
        const int8_t* cp = codes + (int64_t)gk * N + gn;
        const uint8_t* sp = scales + (int64_t)(gk / GROUP_ROWS) * N + gn;
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
        if constexpr (kW4) {
          // code row r is k rows 2r (low nibbles) and 2r + 1 (high)
          __align__(16) bf16 lo[16], hi[16];
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const float sc = ue4m3_decode(sb[j]);
            const uint32_t b = (uint8_t)cb[j];
            lo[j] = f2bf(e2m1x_decode(b & 15u) * sc);
            hi[j] = f2bf(e2m1x_decode(b >> 4) * sc);
          }
          uint4* d0 = reinterpret_cast<uint4*>(Bs + (2 * r) * LDB + nc);
          uint4* d1 = reinterpret_cast<uint4*>(Bs + (2 * r + 1) * LDB + nc);
          d0[0] = reinterpret_cast<const uint4*>(lo)[0];
          d0[1] = reinterpret_cast<const uint4*>(lo)[1];
          d1[0] = reinterpret_cast<const uint4*>(hi)[0];
          d1[1] = reinterpret_cast<const uint4*>(hi)[1];
        } else {
          __align__(16) bf16 wv[16];
#pragma unroll
          for (int j = 0; j < 16; ++j)
            wv[j] = f2bf((float)cb[j] * (ue4m3_decode(sb[j]) * 0.5f));
          uint4* dst = reinterpret_cast<uint4*>(Bs + r * LDB + nc);
          dst[0] = reinterpret_cast<const uint4*>(wv)[0];
          dst[1] = reinterpret_cast<const uint4*>(wv)[1];
        }
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

  float* cs = sm.Cs[warp];
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
          const int64_t idx = (int64_t)gm * N + gn;
          if (partial != nullptr) partial[(int64_t)split * M * N + idx] = v;
          else store_out(v, idx, gm, gn, gs, gw, bias, out, out_f32);
        }
      }
      __syncwarp();
    }
  }
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
