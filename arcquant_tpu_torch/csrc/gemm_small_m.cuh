// The dequant GEMM's small-M mainloop (M <= 64, the decode) for Hopper:
// a cp.async ring of deep k stages, the weight decoded straight into the
// tensor cores' B fragments.
//
// Included by gemm_wgmma.cuh, whose launch_gemm runs it for gemm_w8 and
// gemm_w4 at M <= 64 and whose header gemm_batched.cu includes, and by
// mlp_fused.cu. The tile is a device function over a shared-memory
// buffer its caller passes in (gemm_small_tile), so a fused kernel runs
// it inside its own launch: gemm_batched offsets the operands by its
// block's expert, and the decode megakernels walk (n-tile, split) items
// with 256-thread blocks whose eight warps all issue the copies and
// whose first four compute.
//
// Bound on the H100: the weight stream, 1.06 bytes a weight in w8 and
// 0.5625 in w4 (gateup at M 4: 161 MB and 87 MB, 0.048 and 0.026 ms at
// 3.35 TB/s). The design keeps the copies in flight and the decode off
// the conversion unit:
// - a block of 4 warps computes a BM x 128 output tile (BM = 16 FM rows,
//   the smallest of 16, 32 and 64 that holds M, so the weight is read
//   once) over its split's 32-deep k-tiles; each warp owns 32 columns;
// - STAGES = 2 shared-memory stages of BKS = 128 k rows, each filled by
//   16-byte cp.async copies: the codes (128 code rows in w8, 64 in w4,
//   rows padded so the fragment loads below hit 32 distinct banks), their
//   8 scale rows and the BM x 128 activations (zero rows past M, zero
//   columns past N). One stage lands while the other is consumed; three
//   blocks fit an SM, so the plan's 224-296 blocks run in one wave (a
//   third stage, as in the lab's fastest configuration, measured no
//   faster at M <= 16 and left two blocks an SM at M 17-64);
// - no decoded B tile in shared memory: each thread loads, per k = 16
//   step, one 32-bit word of four columns' codes from each code row its
//   mma B fragments need, and decodes them into the fragments of the
//   warp's four n = 8 MMAs (fragment column j of MMA i is column 4 j + i
//   of the warp's 32, so one word serves all four MMAs). w8: code c
//   becomes the bf16 192 + c (0x4300 | (c + 64), the +64 added to four
//   bytes at once) and one bf16x2 FMA with s = ue4m3 / 2 gives (192 + c)
//   s - 192 s = c s, exact (gemm_wgmma.cuh's decode_stage); w4: the four
//   nibbles of a byte in each of two code rows looked up as bf16 halves
//   by byte permutes, and one bf16x2 multiply by the scale a pair, exact.
//   Each thread builds a column's scale once per 16 k rows from its bits.
//   Nothing runs on the conversion unit (16 results a clock an SM);
// - mma.sync m16n8k16 (bf16 x bf16 -> f32) in the small-M k order of
//   gemm_w8_core.cuh: each 32-deep k-tile's two k = 16 MMAs start from
//   zero, the tile's partial is added to the f32 total with __fadd_rn, a
//   split covers its k-tiles in order, and the splits are summed in split
//   order by splitk_reduce_kernel; the epilogue is store_out's. Every
//   small-M GEMM of the library (gemm_w8, gemm_w4, gemm_batched and the
//   megakernels) runs this tile at the split plan of kernels/gemm.py, so
//   they agree bit for bit, and gemm_w4 equals gemm_w8 (both decodes are
//   exact).
// Ragged shapes: a split whose k-tiles are not a whole number of stages
// ends on a partial stage; when N is not a multiple of 16 or an operand
// is not 16-byte aligned, the launch loads the stages with plain loads
// (decided once a launch; no operand is copied).
#pragma once

#include "gemm_w8_core.cuh"

namespace w8 {
namespace small {

constexpr int BN = 128, BKS = 128, STAGES = 2;
constexpr int NJ = 4;             // n = 8 MMAs a warp runs a k step (its 8 NJ columns)
constexpr int NT = 32 * BN / (8 * NJ);  // 4 warps
constexpr int SUB = BKS / BK;     // 32-deep k-tiles a stage
constexpr int LDA = BKS + 8;      // activation row, bf16 (ldmatrix rows on distinct banks)

#define ARC_SMALL_AL(x) ((((x) + 127) / 128) * 128)

// A stage's layout: [codes CR x LDC][scales SR x BN][activations BM x LDA].
// Code rows are padded so that the four k rows a fragment load reads
// (2t in w8, t in w4, t = lane % 4) start 8 banks apart.
template <int FM, bool kW4>
struct Cfg {
  static constexpr int BM = 16 * FM;
  static constexpr int CR = kW4 ? BKS / 2 : BKS;   // code rows a stage
  static constexpr int LDC = kW4 ? BN + 32 : BN + 16;
  static constexpr int SR = BKS / 16;              // scale rows a stage
  static constexpr int CODE_B = ARC_SMALL_AL(CR * LDC);
  static constexpr int SCALE_B = ARC_SMALL_AL(SR * BN);
  static constexpr int A_B = ARC_SMALL_AL(BM * LDA * 2);
  static constexpr int STAGE_B = CODE_B + SCALE_B + A_B;
  static constexpr int SMEM = STAGES * STAGE_B;
};

#undef ARC_SMALL_AL

// Copies k rows [k0, k0 + 32 nsub) of the (m0, n0) tile into `stage`,
// with the block's first NTH threads: by cp.async when `vec` (N % 16 ==
// 0, 16-byte aligned operands), else by plain loads, which read xa
// through L2 only when kFromL2 (activations another block of the same
// launch wrote: an SM's L1 is not coherent with their stores; cp.async.cg
// reads through L2 already). Rows past nsub k-tiles are left alone.
template <int FM, bool kW4, int NTH, bool kFromL2>
__device__ __forceinline__ void load_stage(uint8_t* stage, const bf16* xa, const int8_t* codes,
                                           const uint8_t* scales, int M, int N, int Kq, int m0,
                                           int n0, int k0, int nsub, bool vec) {
  using C = Cfg<FM, kW4>;
  uint8_t* cs = stage;
  uint8_t* ss = stage + C::CODE_B;
  bf16* as = reinterpret_cast<bf16*>(stage + C::CODE_B + C::SCALE_B);
  const int tid = threadIdx.x;
  const int crows = kW4 ? nsub * (BK / 2) : nsub * BK, crow0 = kW4 ? k0 / 2 : k0;
  const int srows = nsub * (BK / 16), kcols = nsub * BK;
  const uint8_t* cg = reinterpret_cast<const uint8_t*>(codes);
  if (vec) {
    constexpr int CPR = BN / 16;  // 16-byte chunks of a code or scale row
    for (int c = tid; c < crows * CPR; c += NTH) {
      const int r = c / CPR, nc = (c % CPR) * 16;
      const bool ok = n0 + nc < N;
      cp16(cs + r * C::LDC + nc, cg + (int64_t)(crow0 + r) * N + (ok ? n0 + nc : 0), ok);
    }
    for (int c = tid; c < srows * CPR; c += NTH) {
      const int r = c / CPR, nc = (c % CPR) * 16;
      const bool ok = n0 + nc < N;
      cp16(ss + r * BN + nc, scales + (int64_t)(k0 / 16 + r) * N + (ok ? n0 + nc : 0), ok);
    }
    const int apr = kcols / 8;  // 16-byte chunks of an activation row
    for (int c = tid; c < C::BM * apr; c += NTH) {
      const int r = c / apr, kc = (c % apr) * 8;
      const bool ok = m0 + r < M;
      cp16(as + r * LDA + kc, xa + (int64_t)(ok ? m0 + r : 0) * Kq + k0 + kc, ok);
    }
  } else {
    for (int c = tid; c < crows * BN; c += NTH) {
      const int r = c / BN, n = c % BN;
      cs[r * C::LDC + n] = n0 + n < N ? cg[(int64_t)(crow0 + r) * N + n0 + n] : 0;
    }
    for (int c = tid; c < srows * BN; c += NTH) {
      const int r = c / BN, n = c % BN;
      ss[r * BN + n] = n0 + n < N ? scales[(int64_t)(k0 / 16 + r) * N + n0 + n] : 0;
    }
    for (int c = tid; c < C::BM * kcols; c += NTH) {
      const int r = c / kcols, kc = c % kcols;
      if (m0 + r >= M) {
        as[r * LDA + kc] = f2bf(0.0f);
      } else {
        const bf16* src = xa + (int64_t)(m0 + r) * Kq + k0 + kc;
        as[r * LDA + kc] =
            kFromL2 ? __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(src)))
                    : *src;
      }
    }
  }
}

// The 32-bit word at p in shared memory: a thread's NJ = 4 columns of a
// code or scale row.
__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The bf16 pair (v, v) of a ue4m3 scale byte times 2^-D (D = 1: w8's s
// = ue4m3 / 2; D = 0: w4's), from its bits, off the conversion unit: a
// normal exponent e lands at the bf16 exponent e + 120 - D with the 3
// mantissa bits on top; e == 0 (m 2^-9) decodes as e = 1 less the
// hidden bit, (2^-6 (1 + m / 8) - 2^-6) 2^-D, exact. Equals
// ue4m3_decode(byte) * 2^-D rounded to bf16 (exact: 4 significant bits).
template <int D>
__device__ __forceinline__ __nv_bfloat162 ue4m3_pair(uint32_t byte) {
  const uint32_t em = byte & 0x7Fu;
  const bool sub = (em & 0x78u) == 0;
  const uint32_t h = ((em | (sub ? 8u : 0u)) << 4) + ((120u - D) << 7);
  const __nv_bfloat162 v = as_bf162(h * 0x10001u);
  return sub ? __hsub2(v, as_bf162(((121u - D) << 7) * 0x10001u)) : v;
}

// The B fragments (b0: k rows 2t, 2t + 1; b1: 2t + 8, 2t + 9; t = lane
// % 4) of the warp's NJ n = 8 MMAs at one k = 16 step: MMA i's fragment
// column g = lane / 4 is the warp's column NJ g + i, so one load of a row
// serves all of them. cs points at the step's first code row and the
// warp's columns, ss at the step's scale row and the warp's columns.
template <bool kW4, int LDC>
__device__ __forceinline__ void decode_step(const uint8_t* cs, const uint8_t* ss, int lane,
                                            uint32_t (&b0)[NJ], uint32_t (&b1)[NJ]) {
  const int g = lane >> 2, t = lane & 3;
  const uint32_t sw = lds32(ss + NJ * g);  // the scales of the thread's columns
  __nv_bfloat162 s[NJ];
#pragma unroll
  for (int i = 0; i < NJ; ++i) s[i] = ue4m3_pair<kW4 ? 0 : 1>((sw >> (8 * i)) & 0xFFu);
  if constexpr (kW4) {
    // code row t holds k rows 2t (low nibbles) and 2t + 1 (high), row t +
    // 4 rows 2t + 8 and 2t + 9. The four nibbles of byte i of both rows
    // are looked up at once as bf16 halves in byte-permute tables (e2m1x
    // magnitudes 0..7: 0.5, 0, 1, 1.5, 2, 3, 4, 6; low bytes, then high
    // bytes), the signs moved to bits 15 and 31, and each pair times the
    // scale in one bf16x2 multiply, exact. A zero code with its sign bit
    // set gives -0 where e2m1x_decode gives +0: a zero product's sign,
    // which the zero-started partials and promotions absorb.
    const uint32_t q0 = lds32(cs + t * LDC + NJ * g), q1 = lds32(cs + (t + 4) * LDC + NJ * g);
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      // p = byte i of q0, of q1, of q1, of q0
      const uint32_t p =
          __byte_perm(q0, q1, (uint32_t)i | ((4u + i) << 4) | ((4u + i) << 8) | ((uint32_t)i << 12));
      const uint32_t sel = p & 0x7777u;  // the magnitudes of k rows 2t, 2t + 1, 2t + 8, 2t + 9
      const uint32_t lo = __byte_perm(0xC0800000u, 0xC0804000u, sel);
      const uint32_t hi = __byte_perm(0x3F3F003Fu, 0x40404040u, sel);
      const uint32_t x0 = __byte_perm(lo, hi, 0x5140u) | ((p << 12) & 0x8000u) | (p & 0x80000000u);
      const uint32_t x1 =
          __byte_perm(lo, hi, 0x7362u) | ((p << 4) & 0x8000u) | ((p << 8) & 0x80000000u);
      b0[i] = bits(__hmul2(as_bf162(x0), s[i]));
      b1[i] = bits(__hmul2(as_bf162(x1), s[i]));
    }
  } else {
    // c + 64 in each byte (mod 256, no carry between bytes): |c| < 64
    // lands in 0..127, the mantissa of the bf16 192 + c
    uint32_t w[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint32_t v = lds32(cs + (2 * t + (r & 1) + 8 * (r >> 1)) * LDC + NJ * g);
      w[r] = ((v & 0x7F7F7F7Fu) + 0x40404040u) ^ (v & 0x80808080u);
    }
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      const __nv_bfloat162 b = __hmul2(s[i], as_bf162(0xC340C340u));  // -192 s, exact
      // byte i of the two k rows into bytes 0 and 2
      const uint32_t sel = (uint32_t)i | ((uint32_t)i << 4) | ((4u + i) << 8) | ((4u + i) << 12);
      const uint32_t x0 = (__byte_perm(w[0], w[1], sel) & 0x00FF00FFu) | 0x43004300u;
      const uint32_t x1 = (__byte_perm(w[2], w[3], sel) & 0x00FF00FFu) | 0x43004300u;
      b0[i] = bits(__hfma2(as_bf162(x0), s[i], b));
      b1[i] = bits(__hfma2(as_bf162(x1), s[i], b));
    }
  }
}

// The nsub 32-deep k-tiles of a loaded stage into acc: per k-tile, two k
// = 16 MMAs from zero, then the partial promoted with __fadd_rn.
template <int FM, bool kW4>
__device__ __forceinline__ void compute_stage(const uint8_t* stage, int nsub, int warp, int lane,
                                              float (&acc)[FM][NJ][4]) {
  using C = Cfg<FM, kW4>;
  const uint8_t* cs = stage + warp * 8 * NJ;
  const uint8_t* ss = stage + C::CODE_B + warp * 8 * NJ;
  const bf16* as = reinterpret_cast<const bf16*>(stage + C::CODE_B + C::SCALE_B);
  constexpr int CRT = kW4 ? BK / 2 : BK;  // code rows a k-tile
  for (int u = 0; u < nsub; ++u) {
    float part[FM][NJ][4];
#pragma unroll
    for (int f = 0; f < FM; ++f)
#pragma unroll
      for (int i = 0; i < NJ; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[f][i][e] = 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t b0[NJ], b1[NJ];
      decode_step<kW4, C::LDC>(cs + (u * CRT + h * (CRT / 2)) * C::LDC, ss + (2 * u + h) * BN,
                               lane, b0, b1);
      uint32_t a[FM][4];
#pragma unroll
      for (int f = 0; f < FM; ++f)
        ldsm_x4(a[f], as + (f * 16 + (lane & 15)) * LDA + u * BK + h * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int f = 0; f < FM; ++f)
#pragma unroll
        for (int i = 0; i < NJ; ++i) mma_bf16(part[f][i], a[f], b0[i], b1[i]);
    }
#pragma unroll
    for (int f = 0; f < FM; ++f)
#pragma unroll
      for (int i = 0; i < NJ; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[f][i][e] = __fadd_rn(acc[f][i][e], part[f][i][e]);
  }
}

// One BM x 128 output tile at (m0, n0) over k-tiles [kt0, kt1), in
// `smem` (Cfg<FM, kW4>::SMEM bytes, 16-byte aligned). The block's first
// NTH threads (a multiple of NT) issue the copies and meet at its
// barriers; warps 0-3 compute and store. xa: [M, Kq] bf16; codes: [Kq, N]
// int8 (w8) or [Kq/2, N] e2m1x nibble pairs (kW4); scales: [Kq/16, N].
// With `partial` set, writes the tile's f32 totals to partial[split]
// ([splits, M, N]); otherwise store_out's epilogue into out. kFromL2: as
// load_stage. A caller that runs a second tile in the same `smem` syncs
// the block first, so that no warp still reads the last stage.
template <int FM, bool kW4, int NTH = NT, bool kFromL2 = false>
__device__ __forceinline__ void gemm_small_tile(
    const bf16* __restrict__ xa, const int8_t* __restrict__ codes,
    const uint8_t* __restrict__ scales, const float* gs, const float* __restrict__ gw,
    const bf16* __restrict__ bias, void* out, int out_f32, float* partial, int split, int M,
    int N, int Kq, int m0, int n0, int kt0, int kt1, bool vec, uint8_t* smem) {
  static_assert(NTH % NT == 0, "every warp of the tile must issue copies");
  using C = Cfg<FM, kW4>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool computes = NTH == NT || warp < NT / 32;
  const int ntl = kt1 - kt0, nst = (ntl + SUB - 1) / SUB;
  float acc[FM][NJ][4];
#pragma unroll
  for (int f = 0; f < FM; ++f)
#pragma unroll
    for (int i = 0; i < NJ; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][i][e] = 0.0f;

  auto load = [&](int q) {
    load_stage<FM, kW4, NTH, kFromL2>(smem + (q % STAGES) * C::STAGE_B, xa, codes, scales, M, N,
                                      Kq, m0, n0, (kt0 + q * SUB) * BK, min(SUB, ntl - q * SUB),
                                      vec);
  };
#pragma unroll
  for (int q = 0; q < STAGES - 1; ++q) {
    if (q < nst) load(q);
    cp_commit();
  }
  for (int q = 0; q < nst; ++q) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // stage q has landed; every warp is done with stage q - 1's slot
    if (q + STAGES - 1 < nst) load(q + STAGES - 1);
    cp_commit();
    if (computes)
      compute_stage<FM, kW4>(smem + (q % STAGES) * C::STAGE_B, min(SUB, ntl - q * SUB), warp,
                             lane, acc);
  }
  cp_wait<0>();
  if (!computes) return;

  // acc[f][i]: rows 16 f + g (+ 8 for e >= 2), fragment columns 2t + (e
  // & 1), which are the warp's columns NJ (2t + (e & 1)) + i
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int f = 0; f < FM; ++f)
#pragma unroll
    for (int i = 0; i < NJ; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gm = m0 + 16 * f + g + 8 * (e >> 1);
        const int gn = n0 + warp * 8 * NJ + NJ * (2 * t + (e & 1)) + i;
        if (gm < M && gn < N) {
          const int64_t idx = (int64_t)gm * N + gn;
          if (partial != nullptr) partial[(int64_t)split * M * N + idx] = acc[f][i][e];
          else store_out(acc[f][i][e], idx, gm, gn, gs, gw, bias, out, out_f32);
        }
      }
}

// The chain's GEMM at M <= 64: grid (n-tiles, m-tiles, splits), one tile
// a block, split z over k-tiles [z tiles_per_split, (z + 1)
// tiles_per_split).
template <int FM, bool kW4>
__global__ void __launch_bounds__(NT, 3)
gemm_small_kernel(const bf16* __restrict__ xa, const int8_t* __restrict__ codes,
                  const uint8_t* __restrict__ scales, const float* __restrict__ gs,
                  const float* __restrict__ gw, const bf16* __restrict__ bias,
                  void* __restrict__ out, int out_f32, float* __restrict__ partial, int M, int N,
                  int Kq, int tiles_per_split, int vec) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int kt0 = blockIdx.z * tiles_per_split;
  const int kt1 = min(kt0 + tiles_per_split, Kq / BK);
  gemm_small_tile<FM, kW4>(xa, codes, scales, gs, gw, bias, out, out_f32, partial, blockIdx.z, M,
                           N, Kq, blockIdx.y * Cfg<FM, kW4>::BM, blockIdx.x * BN, kt0, kt1,
                           vec != 0, smem);
}

template <int FM, bool kW4>
int launch_fm(const void* xa, const void* codes, const void* scales, const void* gs,
              const void* gw, const void* bias, void* out, int out_f32, float* partial, int M,
              int N, int Kq, int splits, int tiles_per_split, int vec, cudaStream_t st) {
  using C = Cfg<FM, kW4>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_small_kernel<FM, kW4>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((N + BN - 1) / BN, (M + C::BM - 1) / C::BM, splits);
  gemm_small_kernel<FM, kW4><<<grid, NT, C::SMEM, st>>>(
      (const bf16*)xa, (const int8_t*)codes, (const uint8_t*)scales, (const float*)gs,
      (const float*)gw, (const bf16*)bias, out, out_f32, partial, M, N, Kq, tiles_per_split, vec);
  return (int)cudaGetLastError();
}

// Launches the small-M tile of the chain's GEMM (M <= 64): BM 16, 32 or
// 64, the smallest that holds M.
template <bool kW4>
int launch(const void* xa, const void* codes, const void* scales, const void* gs, const void* gw,
           const void* bias, void* out, int out_f32, float* partial, int M, int N, int Kq,
           int splits, int tiles_per_split, cudaStream_t st) {
  const int vec = N % 16 == 0 && (((uintptr_t)xa | (uintptr_t)codes | (uintptr_t)scales) & 15) == 0;
  if (M <= 16)
    return launch_fm<1, kW4>(xa, codes, scales, gs, gw, bias, out, out_f32, partial, M, N, Kq,
                             splits, tiles_per_split, vec, st);
  if (M <= 32)
    return launch_fm<2, kW4>(xa, codes, scales, gs, gw, bias, out, out_f32, partial, M, N, Kq,
                             splits, tiles_per_split, vec, st);
  return launch_fm<4, kW4>(xa, codes, scales, gs, gw, bias, out, out_f32, partial, M, N, Kq,
                           splits, tiles_per_split, vec, st);
}

}  // namespace small
}  // namespace w8
