// The GEMM lab: variants of the dequant GEMM's mainloop, tile and decode,
// y = bf16((xa @ dec(W)) * gs[m] * gw[n]) with f32 accumulation.
//
// Replaces the TPU kernels of benchmarks/gemm_lab.py, the GEMM lab's
// Pallas variants (each a function reaching pl.pallas_call):
//   w8_variant      (:48)   -> arc_lab_w8       decode modes base, mul3d,
//                                               bf16, noscale
//   w8_dma_variant  (:231)  -> arc_lab_w8_ring  a warp-specialised TMA +
//                                               mbarrier persistent ring
//   w8_dma_nblock   (:300)  -> arc_lab_w8_ring_n one thread-block cluster
//                                               per n tile, split-K
//                                               reduced in distributed
//                                               shared memory
//   w4_variant      (:429)  -> arc_lab_w4       nibble decodes f32, i16,
//                                               nodec
// Plain PyTorch versions: arcquant_tpu_torch/kernels/gemm_lab.py
// (lab_w8_plain, lab_w4_plain). The lab measures alternatives to the
// production mainloop at M <= 64 (gemm_small_m.cuh's ring, which
// gemm_w8, gemm_w4, gemm_batched and the megakernels run) against the
// same bits; it is not on a serving path.
//
// lab_w8 and lab_w4 (lab_kernel) run production's small-M mainloop
// (gemm_small_m.cuh) with its tile, depth and decode varied:
//   - a ring of STAGES shared-memory stages, filled with 16-byte
//     cp.async copies (zero fill past M and N; one __syncthreads a
//     stage), each holding BKS k rows of the weight (BKS code rows in w8,
//     BKS/2 in w4, padded as production pads them: LDC = BN + 16 bytes in
//     w8, BN + 32 in w4, so the four code rows a fragment load reads start
//     8 banks apart at BN 64, 128 and 256), their BKS/16 scale rows and
//     the 16 x BKS activations (rows of BKS + 8 bf16); BN columns a block,
//     BN / 32 warps, each owning 32 columns;
//   - no decoded B tile in shared memory: at each k = 16 step a thread
//     loads one 32-bit word of its four columns from each code row its
//     mma.sync m16n8k16 B fragments need and decodes it in registers into
//     the fragments of the warp's four n = 8 MMAs (fragment column g of
//     MMA i is the warp's column 4 g + i); activations come by ldmatrix;
//   - the decode mode (each computes what its plain version in
//     kernels/gemm_lab.py computes):
//       base    production's decode_step: the bf16 192 + c and one
//               bf16x2 FMA with the scale built from its bits;
//       mul3d   a stage's [BKS/16, BN] scales decoded once into a shared
//               tile of bf16 pairs (the mode's second barrier a stage),
//               read per group; the code as below (noscale), one __hmul2;
//       bf16    code and scale converted to bf16 on the conversion unit,
//               one __hmul2 (the A/B against base);
//       noscale bf16(c) on the ALU: the byte's low 7 bits m in the bf16
//               128 + m, less 128 (c >= 0) or 256 (c < 0), one exact
//               bf16x2 subtraction (a probe of the ALU floor);
//       f32     (w4) production's decode_step: byte-permute nibble tables
//               and one bf16x2 multiply by the scale;
//       i16     (w4) w4_variant's 16-bit map on the two halves of a word
//               (the magnitude << 6, the sign bit into bit 15, plus
//               0x3F00; mag 1 gives 0), one __hmul2 by the scale pair;
//       nodec   (w4) the byte's bits c << 6 as bf16 for both k rows (a
//               probe of the stream floor);
//   - the product is the production one: each 32-deep k-tile's two k =
//     16 MMAs start from zero and the partial is promoted into the f32
//     total with __fadd_rn in k order; the split-K partials are summed in
//     split order (w8::splitk_reduce_kernel); the epilogue is
//     w8::store_out's, from registers. So with production's split plan
//     (kernels/gemm.py:_split_plan) every mode whose decode is exact
//     (base, mul3d, bf16; w4 f32 and i16: an e2m1 value times a ue4m3
//     scale has at most 6 significant bits) gives gemm_w8's bits, on bf16
//     activations too. The probes (noscale, nodec) compute other
//     functions on purpose.
//
// The two copy-ring kernels try Hopper's own ways of streaming the
// weight (namespace lab::ring). Both keep production's arithmetic: a
// stage is gemm_small_m.cuh's 128-deep w8 stage (Cfg<1, false>: codes in
// rows padded to 144 bytes, 8 scale rows, 16 x 136 bf16 activations),
// and each consumer warp runs production's compute_stage on it (the
// codes decoded by decode_step straight into mma.sync m16n8k16 B
// fragments as the bf16 192 + c and one bf16x2 FMA, no conversion unit,
// no bf16 tile in shared memory; each 32-deep partial promoted with
// __fadd_rn in k order). So at production's split plan both give
// gemm_w8's bits.
//   - The stage is filled by TMA (cp.async.bulk.tensor into an mbarrier
//     with expect_tx), three boxes per 128 columns: codes [128 k x 144
//     n], scales [8 x 128], activations [16 m x 136 k] bf16. The boxes
//     are 16 and 8 elements wider than the tile, so they land as the
//     padded rows decode_step and ldmatrix read without bank conflicts;
//     the extra 16 code columns are the next tile's (read again by it,
//     mostly from L2: 12.5% more L2 traffic, no more HBM traffic), the
//     8 activation columns the next stage's; past N, Kq and M the boxes
//     fill zeros.
//   - One producer warp (its lane 0) keeps the STAGES-slot ring full:
//     it waits on the slot's `empty` mbarrier, arms `full` with the
//     stage's bytes and issues its boxes. Consumer warps (4 per 128
//     columns, each owning 32 columns) wait on `full`, compute, and
//     arrive on `empty` (one arrival a warp). The mainloop has no
//     __syncthreads.
// arc_lab_w8_ring: w8_dma_variant's grid=(1,) would fill one SM of 132,
// so it is a persistent grid (`blocks`, one or more an SM) that walks the
// weight's (split, m-tile, n-tile) work items in the order of the
// weight's bytes, each block a contiguous run of items through one ring
// that does not drain between items: the producer runs up to STAGES
// stages ahead across item boundaries, so an item's epilogue (registers
// to global, or to the split-K workspace) overlaps the next item's
// loads. BN is 128 or 256 (4 or 8 consumer warps). Splits are
// production's plan and are summed by w8::splitk_reduce_kernel.
// arc_lab_w8_ring_n: w8_dma_nblock's one program streaming the whole K
// of an n block becomes one cluster of c CTAs per (n tile, m tile); CTA
// rank r streams k-tiles [r per, min((r + 1) per, Kq / 32)) (the split
// plan of kernels/gemm.py:_split_plan at c = its split count) through its
// own ring. With c > 1 each CTA leaves its f32 partial tile in its shared
// memory; after a cluster barrier the CTAs read the c partials through
// distributed shared memory (each CTA a share of the tile's elements),
// sum them in rank order from 0.0f with __fadd_rn (w8::sum_splits'
// order) and apply store_out's epilogue; a last cluster barrier keeps
// every CTA's shared memory alive until it has been read. c = 1 stores
// the accumulator directly, as production's one-split path does. One
// launch, no workspace, no second kernel. The cluster size is a launch
// attribute (up to 8 portable, 16 with the non-portable attribute); a
// size the card cannot schedule (cudaOccupancyMaxActiveClusters 0) is
// refused, never run another way.
//
// The other TPU forms that do not carry over: w4_variant reads the
// activations split into even and odd k halves (the TPU's lane layout);
// here xa is read in natural k order as gemm_w4 reads it, and each code
// byte decodes into its two k rows (nodec's function is unchanged: both
// rows of a byte get the same value). The TPU's block sizes (bk up to
// 2048, bn up to 4096, 12 MiB of VMEM) do not fit an SM's 227 KB; the
// configurations below are Hopper's, a fixed list instantiated here.
//
// Bound on the H100: at decode (M 4) the weight stream, 1.06 bytes a
// weight in w8 and 0.5625 in w4 (gateup 37888 x 3584: 43.2 and 22.9 us
// at 3.35 TB/s).
#include <cooperative_groups.h>

#include "gemm_wgmma.cuh"

namespace lab {

namespace sm = w8::small;

enum Mode { BASE = 0, MUL3D = 1, BF16 = 2, NOSCALE = 3, W4_F32 = 4, W4_I16 = 5, W4_NODEC = 6 };

constexpr int BM = 16;    // activation rows a block (decode M <= 16)
constexpr int SUBK = 32;  // the production k-tile: what one promotion covers
constexpr int NJ = sm::NJ;  // n = 8 MMAs a warp runs a k step (its 32 columns)

#define LAB_AL(x) ((((x) + 127) / 128) * 128)

// The layout of a configuration's dynamic shared memory: STAGES stages
// of [codes CR x LDC | scales SR x BN | activations BM x LDA bf16], then,
// for mul3d, the stage's decoded scale tile (SR x BN bf16 pairs).
// Mirrored by kernels/gemm_lab.py:smem_bytes.
template <int BN_, int BKS_, int STAGES_, int MODE_>
struct Cfg {
  static constexpr int BN = BN_, BKS = BKS_, STAGES = STAGES_, MODE = MODE_;
  static constexpr bool W4 = MODE >= W4_F32;
  static constexpr int NW = BN / 32;  // warps; each owns 32 columns
  static constexpr int NT = NW * 32;
  static constexpr int SUB = BKS / SUBK;           // k-tiles a stage
  static constexpr int CRT = W4 ? SUBK / 2 : SUBK;  // code rows a k-tile
  static constexpr int CR = SUB * CRT;              // code rows a stage
  static constexpr int SR = BKS / 16;               // scale rows a stage
  static constexpr int CPR = BN / 16;               // 16-byte chunks a code row
  static constexpr int LDA = BKS + 8;
  static constexpr int LDC = W4 ? BN + 32 : BN + 16;  // gemm_small_m.cuh's padding
  static constexpr int CODE_B = LAB_AL(CR * LDC), SCALE_B = LAB_AL(SR * BN);
  static constexpr int A_B = LAB_AL(BM * LDA * 2);
  static constexpr int STAGE_B = CODE_B + SCALE_B + A_B;
  static constexpr int S3_B = MODE == MUL3D ? LAB_AL(SR * BN * 4) : 0;
  static constexpr int SMEM = STAGES * STAGE_B + S3_B;
  // blocks an SM for __launch_bounds__: as many as the SM's 228 KB of
  // shared memory holds (1 KB reserved a block), at most as many as
  // leave 128 registers a thread
  static constexpr int FIT = 233472 / (SMEM + 1024), REG_FIT = 65536 / (NT * 128);
  static constexpr int MIN_BLOCKS = FIT < 1 ? 1 : (FIT < REG_FIT ? FIT : REG_FIT);
  static_assert(BKS % SUBK == 0 && BN % 32 == 0 && LDC % 16 == 0, "tile");
};

// Copies the stage of 32-tiles [t0, t0 + nsub) of the (m0, n0) tile into
// `stage` (rows past nsub are left alone; activation rows past M and
// weight columns past N are zero-filled).
template <class C>
__device__ __forceinline__ void load_stage(uint8_t* stage, const bf16* xa, const int8_t* codes,
                                           const uint8_t* scales, int M, int N, int Kq, int m0,
                                           int n0, int t0, int nsub) {
  uint8_t* cs = stage;
  uint8_t* ss = stage + C::CODE_B;
  bf16* as = reinterpret_cast<bf16*>(stage + C::CODE_B + C::SCALE_B);
  const int tid = threadIdx.x;
  const int crows = nsub * C::CRT, srows = nsub * 2;
  for (int c = tid; c < crows * C::CPR; c += C::NT) {
    const int r = c / C::CPR, nc = (c % C::CPR) * 16;
    const bool ok = n0 + nc < N;
    cp16(cs + r * C::LDC + nc, codes + (int64_t)(t0 * C::CRT + r) * N + (ok ? n0 + nc : 0), ok);
  }
  for (int c = tid; c < srows * C::CPR; c += C::NT) {
    const int r = c / C::CPR, nc = (c % C::CPR) * 16;
    const bool ok = n0 + nc < N;
    cp16(ss + r * C::BN + nc, scales + (int64_t)(t0 * 2 + r) * N + (ok ? n0 + nc : 0), ok);
  }
  const int apr = nsub * SUBK / 8;  // 16-byte chunks of an activation row
  for (int c = tid; c < BM * apr; c += C::NT) {
    const int r = c / apr, kc = (c % apr) * 8;
    const bool ok = m0 + r < M;
    cp16(as + r * C::LDA + kc, xa + (int64_t)(ok ? m0 + r : 0) * Kq + t0 * SUBK + kc, ok);
  }
}

// bf16(c) of the int8 codes in bytes 0 and 2 of p, off the conversion
// unit: the low 7 bits m land in the bf16 128 + m (0x4300 | m), and one
// bf16x2 subtraction takes 128 (c >= 0) or 256 (0x4380, c < 0) off,
// exact for every byte.
__device__ __forceinline__ __nv_bfloat162 code_pair(uint32_t p) {
  return __hsub2(as_bf162((p & 0x007F007Fu) | 0x43004300u),
                 as_bf162((p & 0x00800080u) | 0x43004300u));
}

// w4_variant's 16-bit map of a byte's two nibbles into the two halves
// of a word (low nibble low): the magnitude into bits 6-8, the sign into
// bit 15, plus 0x3F00 (the e2m1x values as bf16); mag 1 gives +0.
__device__ __forceinline__ uint32_t i16_pair(uint32_t byte) {
  const uint32_t w = (byte & 0xFu) | ((byte & 0xF0u) << 12);
  const uint32_t mag = w & 0x00070007u;
  const uint32_t h = ((mag << 6) | ((w & 0x00080008u) << 12)) + 0x3F003F00u;
  return h & ~__vcmpeq2(mag, 0x00010001u);
}

// The B fragments of the warp's NJ n = 8 MMAs at one k = 16 step, by the
// configuration's decode mode (b0: k rows 2t, 2t + 1; b1: 2t + 8, 2t + 9;
// t = lane % 4; fragment column g = lane / 4 of MMA i is the warp's
// column NJ g + i). cs points at the step's first code row and the warp's
// columns, ss at the step's scale row and the warp's columns, s3 at the
// same place of the decoded scale tile (mul3d).
template <class C>
__device__ __forceinline__ void frag_decode(const uint8_t* cs, const uint8_t* ss,
                                            const uint32_t* s3, int lane, uint32_t (&b0)[NJ],
                                            uint32_t (&b1)[NJ]) {
  const int g = lane >> 2, t = lane & 3;
  if constexpr (C::MODE == BASE || C::MODE == W4_F32) {
    sm::decode_step<C::W4, C::LDC>(cs, ss, lane, b0, b1);
  } else if constexpr (!C::W4) {
    uint32_t w[4];  // k rows 2t, 2t + 1, 2t + 8, 2t + 9 of the thread's columns
#pragma unroll
    for (int r = 0; r < 4; ++r)
      w[r] = sm::lds32(cs + (2 * t + (r & 1) + 8 * (r >> 1)) * C::LDC + NJ * g);
    if constexpr (C::MODE == BF16) {
      const uint32_t sw = sm::lds32(ss + NJ * g);
#pragma unroll
      for (int i = 0; i < NJ; ++i) {
        const __nv_bfloat162 s =
            __float2bfloat162_rn(ue4m3_decode((sw >> (8 * i)) & 0xFFu) * 0.5f);
        auto c = [&](int r) { return (float)(int8_t)(w[r] >> (8 * i)); };
        b0[i] = bits(__hmul2(__floats2bfloat162_rn(c(0), c(1)), s));
        b1[i] = bits(__hmul2(__floats2bfloat162_rn(c(2), c(3)), s));
      }
    } else {
      uint32_t sv[NJ];
      if constexpr (C::MODE == MUL3D) {
        const uint4 v = *reinterpret_cast<const uint4*>(s3 + NJ * g);
        sv[0] = v.x, sv[1] = v.y, sv[2] = v.z, sv[3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < NJ; ++i) {
        // byte i of the two k rows into bytes 0 and 2
        const uint32_t sel = (uint32_t)i | ((uint32_t)i << 4) | ((4u + i) << 8) | ((4u + i) << 12);
        __nv_bfloat162 x0 = code_pair(__byte_perm(w[0], w[1], sel));
        __nv_bfloat162 x1 = code_pair(__byte_perm(w[2], w[3], sel));
        if constexpr (C::MODE == MUL3D) {
          x0 = __hmul2(x0, as_bf162(sv[i]));
          x1 = __hmul2(x1, as_bf162(sv[i]));
        }
        b0[i] = bits(x0);
        b1[i] = bits(x1);
      }
    }
  } else {
    // code row t holds k rows 2t (low nibbles) and 2t + 1 (high), row
    // t + 4 rows 2t + 8 and 2t + 9
    const uint32_t q0 = sm::lds32(cs + t * C::LDC + NJ * g);
    const uint32_t q1 = sm::lds32(cs + (t + 4) * C::LDC + NJ * g);
    if constexpr (C::MODE == W4_I16) {
      const uint32_t sw = sm::lds32(ss + NJ * g);
#pragma unroll
      for (int i = 0; i < NJ; ++i) {
        const __nv_bfloat162 s = sm::ue4m3_pair<0>((sw >> (8 * i)) & 0xFFu);
        b0[i] = bits(__hmul2(as_bf162(i16_pair(q0 >> (8 * i))), s));
        b1[i] = bits(__hmul2(as_bf162(i16_pair(q1 >> (8 * i))), s));
      }
    } else {  // W4_NODEC: c << 6 for both k rows of byte c
#pragma unroll
      for (int i = 0; i < NJ; ++i) {
        b0[i] = (((q0 >> (8 * i)) & 0xFFu) << 6) * 0x10001u;
        b1[i] = (((q1 >> (8 * i)) & 0xFFu) << 6) * 0x10001u;
      }
    }
  }
}

// The nsub 32-deep k-tiles of a loaded stage into acc (the warp's NJ
// 16 x 8 accumulators of columns warp * 32 + [0, 32)): per k-tile, two
// k = 16 MMAs from zero, then the partial promoted with __fadd_rn.
template <class C>
__device__ __forceinline__ void compute_stage(const uint8_t* stage, int nsub, const uint32_t* s3,
                                              float (&acc)[NJ][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint8_t* cs = stage + warp * 8 * NJ;
  const uint8_t* ss = stage + C::CODE_B + warp * 8 * NJ;
  const bf16* as = reinterpret_cast<const bf16*>(stage + C::CODE_B + C::SCALE_B);
  s3 += warp * 8 * NJ;
  for (int u = 0; u < nsub; ++u) {
    float part[NJ][4];
#pragma unroll
    for (int i = 0; i < NJ; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[i][e] = 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t b0[NJ], b1[NJ], a[4];
      frag_decode<C>(cs + (u * C::CRT + h * (C::CRT / 2)) * C::LDC, ss + (2 * u + h) * C::BN,
                     s3 + (2 * u + h) * C::BN, lane, b0, b1);
      ldsm_x4(a, as + (lane & 15) * C::LDA + u * SUBK + h * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < NJ; ++i) mma_bf16(part[i], a, b0[i], b1[i]);
    }
#pragma unroll
    for (int i = 0; i < NJ; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = __fadd_rn(acc[i][e], part[i][e]);
  }
}

// lab_w8 / lab_w4: grid (n-tiles, m-tiles, splits); each block runs its
// split's 32-tiles [kt0, kt1) through the STAGES ring, then stores its
// accumulators from registers: to partial[split] ([splits, M, N]) when
// `partial` is set, else store_out's epilogue into out (bf16).
template <int BN, int BKS, int STAGES, int MODE>
__global__ void __launch_bounds__(BN, (Cfg<BN, BKS, STAGES, MODE>::MIN_BLOCKS))
lab_kernel(const bf16* __restrict__ xa, const int8_t* __restrict__ codes,
           const uint8_t* __restrict__ scales, const float* __restrict__ gs,
           const float* __restrict__ gw, bf16* __restrict__ out, float* __restrict__ partial,
           int M, int N, int Kq, int tiles_per_split) {
  using C = Cfg<BN, BKS, STAGES, MODE>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint32_t* s3 = reinterpret_cast<uint32_t*>(smem + STAGES * C::STAGE_B);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, split = blockIdx.z;
  const int kt0 = split * tiles_per_split;
  const int ntl = min(kt0 + tiles_per_split, Kq / SUBK) - kt0;
  const int nst = (ntl + C::SUB - 1) / C::SUB;
  float acc[NJ][4];
#pragma unroll
  for (int i = 0; i < NJ; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst)
      load_stage<C>(smem + s * C::STAGE_B, xa, codes, scales, M, N, Kq, m0, n0,
                    kt0 + s * C::SUB, min(C::SUB, ntl - s * C::SUB));
    cp_commit();
  }
  for (int q = 0; q < nst; ++q) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // stage q has landed; every warp is done with stage q - 1
    const int p = q + STAGES - 1;
    if (p < nst)
      load_stage<C>(smem + (p % STAGES) * C::STAGE_B, xa, codes, scales, M, N, Kq, m0, n0,
                    kt0 + p * C::SUB, min(C::SUB, ntl - p * C::SUB));
    cp_commit();
    const uint8_t* stage = smem + (q % STAGES) * C::STAGE_B;
    const int nsub = min(C::SUB, ntl - q * C::SUB);
    if constexpr (C::MODE == MUL3D) {
      // the stage's scale tile, decoded once and indexed per group
      const uint8_t* ss = stage + C::CODE_B;
      for (int i = threadIdx.x; i < nsub * 2 * BN; i += C::NT)
        s3[i] = bits(sm::ue4m3_pair<1>(ss[i]));
      __syncthreads();
    }
    compute_stage<C>(stage, nsub, s3, acc);
  }
  cp_wait<0>();

  // acc[i]: rows g (+ 8 for e >= 2), fragment columns 2t + (e & 1),
  // which are the warp's columns NJ (2t + (e & 1)) + i
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < NJ; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int gm = m0 + g + 8 * (e >> 1), gn = n0 + warp * 8 * NJ + NJ * (2 * t + (e & 1)) + i;
      if (gm < M && gn < N) {
        const int64_t idx = (int64_t)gm * N + gn;
        if (partial != nullptr) partial[(int64_t)split * M * N + idx] = acc[i][e];
        else w8::store_out(acc[i][e], idx, gm, gn, gs, gw, nullptr, out, 0);
      }
    }
}

template <int BN, int BKS, int STAGES, int MODE>
int launch(const void* xa, const void* codes, const void* scales, const void* gs, const void* gw,
           void* out, void* ws, int M, int N, int Kq, int splits, int tps, cudaStream_t st) {
  using C = Cfg<BN, BKS, STAGES, MODE>;
  cudaError_t e = cudaFuncSetAttribute(lab_kernel<BN, BKS, STAGES, MODE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  lab_kernel<BN, BKS, STAGES, MODE><<<grid, C::NT, C::SMEM, st>>>(
      (const bf16*)xa, (const int8_t*)codes, (const uint8_t*)scales, (const float*)gs,
      (const float*)gw, (bf16*)out, splits > 1 ? (float*)ws : nullptr, M, N, Kq, tps);
  return (int)cudaGetLastError();
}

// The instantiated configurations (BN, BKS, STAGES, MODE); the same list
// is kernels/gemm_lab.py:LAB_CONFIGS.
#define LAB_CONFIG_LIST(X)                                                                    \
  X(64, 32, 3, BASE) X(64, 64, 3, BASE) X(64, 128, 3, BASE) X(64, 256, 3, BASE)               \
  X(128, 32, 3, BASE) X(128, 64, 3, BASE) X(128, 128, 3, BASE) X(128, 256, 3, BASE)           \
  X(256, 32, 3, BASE) X(256, 64, 3, BASE) X(256, 128, 3, BASE)                                \
  X(128, 128, 2, BASE) X(128, 128, 4, BASE) X(128, 128, 6, BASE)                              \
  X(128, 128, 3, MUL3D) X(128, 128, 3, BF16) X(128, 128, 3, NOSCALE)                          \
  X(64, 256, 3, W4_F32) X(128, 128, 3, W4_F32) X(128, 256, 3, W4_F32) X(256, 128, 3, W4_F32)  \
  X(128, 128, 3, W4_I16) X(128, 128, 3, W4_NODEC)

// cudaErrorInvalidValue for a configuration that is not instantiated
// (the wrapper checks the list first).
int dispatch(int bn, int bks, int stages, int mode, const void* xa, const void* codes,
             const void* scales, const void* gs, const void* gw, void* out, void* ws, int M,
             int N, int Kq, int splits, int tps, cudaStream_t st) {
#define LAB_TRY(BN_, BKS_, ST_, MODE_)                                                    \
  if (bn == BN_ && bks == BKS_ && stages == ST_ && mode == MODE_)                         \
    return launch<BN_, BKS_, ST_, MODE_>(xa, codes, scales, gs, gw, out, ws, M, N, Kq, splits, \
                                         tps, st);
  LAB_CONFIG_LIST(LAB_TRY)
#undef LAB_TRY
  return (int)cudaErrorInvalidValue;
}

int reduce(int splits, const void* ws, const void* gs, const void* gw, void* out, int M, int N,
           cudaStream_t st) {
  if (splits > 1) {
    const int64_t total = (int64_t)M * N;
    w8::splitk_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        (const float*)ws, splits, (const float*)gs, (const float*)gw, nullptr, out, 0, M, N);
  }
  return (int)cudaGetLastError();
}


// -- the copy-ring kernels (lab_w8_ring, lab_w8_ring_n) -------------------------

namespace ring {

namespace cg = cooperative_groups;
namespace sm = w8::small;
using w8::big::mbar_expect_tx;
using w8::big::mbar_init;
using w8::big::mbar_wait;
using w8::big::saddr;
using w8::big::tma_load;

using SC = sm::Cfg<1, false>;  // a 128-column stage of production's tile (BM 16, w8)
constexpr int HALF = sm::BN;   // columns a stage: 4 consumer warps of 32
constexpr int KROWS = sm::BKS;  // k rows a stage
constexpr int NJ = sm::NJ;
// TMA boxes, {inner, outer} in elements: they land as SC's padded rows
constexpr int CODE_BOX_N = SC::LDC, CODE_BOX_K = KROWS;       // bytes
constexpr int SCALE_BOX_N = HALF, SCALE_BOX_K = SC::SR;       // bytes
constexpr int A_BOX_K = sm::LDA, A_BOX_M = SC::BM;            // bf16
static_assert(SC::CODE_B == CODE_BOX_K * CODE_BOX_N && SC::SCALE_B == SCALE_BOX_K * SCALE_BOX_N &&
                  SC::A_B == A_BOX_M * A_BOX_K * 2,
              "each box fills its region of the stage exactly");
static_assert(SC::CODE_B % 128 == 0 && SC::SCALE_B % 128 == 0 && SC::STAGE_B % 128 == 0,
              "TMA destinations are 128-byte aligned");

// NH 128-column halves a tile (BN = 128 NH, 4 NH consumer warps and one
// producer warp); STAGES ring slots of NH stages each. Mirrored by
// kernels/gemm_lab.py:ring_smem_bytes.
template <int NH, int STAGES>
struct Ring {
  static constexpr int BN = NH * HALF, SLOTS = STAGES;
  static constexpr int CW = 4 * NH;
  static constexpr int NT = 32 * (CW + 1);
  static constexpr int SLOT_B = NH * SC::STAGE_B;  // a slot's boxes bring STAGE_B a half
  static constexpr int SMEM = 128 + STAGES * SLOT_B + 2 * STAGES * 8;
};

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(saddr(bar)) : "memory");
}

typedef float Acc16[1][NJ][4];  // a consumer warp's 16 x 32 accumulators

// The slots (128-byte aligned) and the barriers of a block's ring;
// thread 0 initializes the barriers, then the block meets once.
template <class R>
__device__ __forceinline__ uint8_t* ring_smem(uint8_t* raw, uint64_t*& full, uint64_t*& empty) {
  uint8_t* slots = raw + ((128 - (saddr(raw) & 127)) & 127);
  full = reinterpret_cast<uint64_t*>(slots + R::SLOTS * R::SLOT_B);
  empty = full + R::SLOTS;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < R::SLOTS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], R::CW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return slots;
}

// Runs the block's work items [i0, i1) through the ring. item(i, m0, n0,
// split, kt0, ntl) gives item i's tile origin and k-tiles [kt0, kt0 +
// ntl); after an item's last stage each consumer warp calls done(acc,
// m0, n0 of its 128 columns, split, warp within them, lane). Stage q of
// the walk (counted over all items) lives in slot q % STAGES; its full
// barrier completes phase q / STAGES when its boxes land, its empty
// barrier when the consumer warps have read it.
template <int NH, int STAGES, class Item, class Done>
__device__ __forceinline__ void walk(uint8_t* slots, uint64_t* full, uint64_t* empty,
                                     const CUtensorMap* ta, const CUtensorMap* tc,
                                     const CUtensorMap* ts, int N, int i0, int i1, Item item,
                                     Done done) {
  using R = Ring<NH, STAGES>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == R::CW) {  // the producer
    if (lane != 0) return;
    int q = 0;
    for (int i = i0; i < i1; ++i) {
      int m0, n0, split, kt0, ntl;
      item(i, m0, n0, split, kt0, ntl);
      for (int s = 0; s * sm::SUB < ntl; ++s, ++q) {
        const int slot = q % STAGES;
        mbar_wait(&empty[slot], ((uint32_t)(q / STAGES) & 1u) ^ 1u);
        // a half wholly past N is not loaded: its warps' columns are not stored
        const int live = min(NH, (N - n0 + HALF - 1) / HALF);
        mbar_expect_tx(&full[slot], live * SC::STAGE_B);
        const int k0 = (kt0 + s * sm::SUB) * w8::BK;
        uint8_t* st = slots + slot * R::SLOT_B;
        for (int h = 0; h < live; ++h, st += SC::STAGE_B) {
          tma_load(st, tc, &full[slot], n0 + h * HALF, k0, 0);
          tma_load(st + SC::CODE_B, ts, &full[slot], n0 + h * HALF, k0 / 16, 0);
          tma_load(st + SC::CODE_B + SC::SCALE_B, ta, &full[slot], k0, m0, 0);
        }
      }
    }
    return;
  }
  const int half = warp >> 2, cw = warp & 3;
  int q = 0;
  for (int i = i0; i < i1; ++i) {
    int m0, n0, split, kt0, ntl;
    item(i, m0, n0, split, kt0, ntl);
    Acc16 acc;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][j][e] = 0.0f;
    for (int s = 0; s * sm::SUB < ntl; ++s, ++q) {
      const int slot = q % STAGES;
      mbar_wait(&full[slot], (uint32_t)(q / STAGES) & 1u);
      sm::compute_stage<1, false>(slots + slot * R::SLOT_B + half * SC::STAGE_B,
                                  min(sm::SUB, ntl - s * sm::SUB), cw, lane, acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
    }
    done(acc, m0, n0 + half * HALF, split, cw, lane);
  }
}

// Element (f, j, e) of a consumer warp's accumulators: its row and its
// column within the warp's 128-column stage (fragment column 2t + (e &
// 1) of MMA j is the warp's column NJ (2t + (e & 1)) + j).
__device__ __forceinline__ int acc_row(int lane, int e) { return (lane >> 2) + 8 * (e >> 1); }
__device__ __forceinline__ int acc_col(int cw, int lane, int j, int e) {
  return cw * 8 * NJ + NJ * (2 * (lane & 3) + (e & 1)) + j;
}

// lab_w8_ring: items (split, m-tile, n-tile), n-tile fastest; block b
// takes items [b I / G, (b + 1) I / G). With splits > 1 each item's f32
// totals go to partial[split] ([splits, M, N]), else store_out's bf16.
template <int NH, int STAGES>
__global__ void __launch_bounds__(Ring<NH, STAGES>::NT)
ring_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tc,
            const __grid_constant__ CUtensorMap ts, const float* __restrict__ gs,
            const float* __restrict__ gw, bf16* __restrict__ out, float* __restrict__ partial,
            int M, int N, int Kq, int tiles_per_split, int splits) {
  using R = Ring<NH, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  uint64_t *full, *empty;
  uint8_t* slots = ring_smem<R>(smem_raw, full, empty);
  const int ntn = (N + R::BN - 1) / R::BN, ntm = (M + BM - 1) / BM, ktiles = Kq / w8::BK;
  const int items = splits * ntm * ntn;
  const int i0 = (int)((int64_t)blockIdx.x * items / gridDim.x);
  const int i1 = (int)((int64_t)(blockIdx.x + 1) * items / gridDim.x);
  walk<NH, STAGES>(
      slots, full, empty, &ta, &tc, &ts, N, i0, i1,
      [&](int i, int& m0, int& n0, int& split, int& kt0, int& ntl) {
        split = i / (ntm * ntn);
        m0 = (i / ntn) % ntm * BM;
        n0 = i % ntn * R::BN;
        kt0 = split * tiles_per_split;
        ntl = min(kt0 + tiles_per_split, ktiles) - kt0;
      },
      [&](Acc16& acc, int m0, int n0, int split, int cw, int lane) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int gm = m0 + acc_row(lane, e), gn = n0 + acc_col(cw, lane, j, e);
            if (gm < M && gn < N) {
              const int64_t idx = (int64_t)gm * N + gn;
              if (splits > 1) partial[(int64_t)split * M * N + idx] = acc[0][j][e];
              else w8::store_out(acc[0][j][e], idx, gm, gn, gs, gw, nullptr, out, 0);
            }
          }
      });
}

// lab_w8_ring_n: grid (n-tiles x c, m-tiles) in clusters of (c, 1, 1);
// cluster x / c is the n tile, CTA rank r its k range.
template <int STAGES>
__global__ void __launch_bounds__(Ring<1, STAGES>::NT)
cluster_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tc,
               const __grid_constant__ CUtensorMap ts, const float* __restrict__ gs,
               const float* __restrict__ gw, bf16* __restrict__ out, int M, int N, int Kq,
               int tiles_per_split) {
  using R = Ring<1, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  cg::cluster_group cl = cg::this_cluster();
  const int c = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  uint64_t *full, *empty;
  uint8_t* slots = ring_smem<R>(smem_raw, full, empty);
  const int n0 = (int)(blockIdx.x / c) * HALF, m0 = blockIdx.y * BM;
  const int kt0 = rank * tiles_per_split;
  const int ntl = min(kt0 + tiles_per_split, Kq / w8::BK) - kt0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Acc16 res;
  walk<1, STAGES>(
      slots, full, empty, &ta, &tc, &ts, N, 0, 1,
      [&](int, int& a, int& b, int& sp, int& k, int& n) {
        a = m0;
        b = n0;
        sp = rank;
        k = kt0;
        n = ntl;
      },
      [&](Acc16& acc, int, int, int, int, int) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) res[0][j][e] = acc[0][j][e];
      });
  if (c == 1) {  // one split: the accumulator is the total
    if (warp < R::CW) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int gm = m0 + acc_row(lane, e), gn = n0 + acc_col(warp, lane, j, e);
          if (gm < M && gn < N)
            w8::store_out(res[0][j][e], (int64_t)gm * N + gn, gm, gn, gs, gw, nullptr, out, 0);
        }
    }
    return;
  }
  // the CTA's partial [16 x 128] f32 over slot 0, once every consumer
  // warp is past its last stage (the producer has no copy in flight)
  float* red = reinterpret_cast<float*>(slots);
  if (warp < R::CW) {
    asm volatile("bar.sync 1, %0;\n" ::"n"(32 * R::CW) : "memory");
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[acc_row(lane, e) * HALF + acc_col(warp, lane, j, e)] = res[0][j][e];
  }
  __syncwarp();
  cl.sync();  // every partial is written (release / acquire over the cluster)
  for (int e = rank * R::NT + (int)threadIdx.x; e < SC::BM * HALF; e += c * R::NT) {
    const int gm = m0 + e / HALF, gn = n0 + e % HALF;
    if (gm < M && gn < N) {
      float v = 0.0f;  // w8::sum_splits' order
      for (int s = 0; s < c; ++s) v = __fadd_rn(v, cl.map_shared_rank(red, s)[e]);
      w8::store_out(v, (int64_t)gm * N + gn, gm, gn, gs, gw, nullptr, out, 0);
    }
  }
  cl.sync();  // no CTA leaves while another reads its partial
}

// The three tensor maps of a call (3-d maps with one plane, as
// gemm_wgmma.cuh encodes them). TMA needs 16-byte aligned operands and
// rows of a multiple of 16 bytes (N % 16 == 0; Kq % 32 == 0 is the
// k-tile's own requirement).
struct Maps {
  CUtensorMap ta, tc, ts;
};

inline bool make_maps(Maps& mp, const void* xa, const void* codes, const void* scales, int M,
                      int N, int Kq) {
  using w8::big::make_map;
  if (M <= 0 || N % 16 != 0 || Kq % w8::BK != 0 ||
      ((uintptr_t)xa | (uintptr_t)codes | (uintptr_t)scales) & 15)
    return false;
  const uint64_t m = M, n = N, kq = Kq;
  return make_map(&mp.ta, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, xa, kq, m, 1, kq * 2, m * kq * 2,
                  A_BOX_K, A_BOX_M, CU_TENSOR_MAP_SWIZZLE_NONE) &&
         make_map(&mp.tc, CU_TENSOR_MAP_DATA_TYPE_UINT8, codes, n, kq, 1, n, kq * n, CODE_BOX_N,
                  CODE_BOX_K, CU_TENSOR_MAP_SWIZZLE_NONE) &&
         make_map(&mp.ts, CU_TENSOR_MAP_DATA_TYPE_UINT8, scales, n, kq / 16, 1, n, kq / 16 * n,
                  SCALE_BOX_N, SCALE_BOX_K, CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <int NH, int STAGES>
int launch_ring(const Maps& mp, const void* gs, const void* gw, void* out, void* ws, int M, int N,
                int Kq, int splits, int tps, int blocks, cudaStream_t st) {
  using R = Ring<NH, STAGES>;
  const cudaError_t e = cudaFuncSetAttribute(
      ring_kernel<NH, STAGES>, cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM);
  if (e != cudaSuccess) return (int)e;
  ring_kernel<NH, STAGES><<<blocks, R::NT, R::SMEM, st>>>(
      mp.ta, mp.tc, mp.ts, (const float*)gs, (const float*)gw, (bf16*)out, (float*)ws, M, N, Kq,
      tps, splits);
  return (int)cudaGetLastError();
}

// The launch configuration of cluster_kernel<STAGES> at cluster size c
// (the kernel's attributes set first); `active` receives how many such
// clusters the card can hold at once (0: it cannot schedule one).
template <int STAGES>
int cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int c, dim3 grid,
                   cudaStream_t st, int* active) {
  using R = Ring<1, STAGES>;
  auto kernel = cluster_kernel<STAGES>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM);
  if (e == cudaSuccess && c > 8)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(R::NT, 1, 1);
  cfg.dynamicSmemBytes = R::SMEM;
  cfg.stream = st;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = c;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  *active = 0;
  return (int)cudaOccupancyMaxActiveClusters(active, (const void*)kernel, &cfg);
}

template <int STAGES>
int launch_cluster(const Maps& mp, const void* gs, const void* gw, void* out, int M, int N,
                   int Kq, int c, int tps, cudaStream_t st) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int active = 0;
  const dim3 grid((unsigned)(((N + HALF - 1) / HALF) * c), (unsigned)((M + BM - 1) / BM), 1);
  const int rc = cluster_config<STAGES>(cfg, attr, c, grid, st, &active);
  if (rc != 0) return rc;
  if (active < 1) return (int)cudaErrorInvalidConfiguration;
  cudaError_t e = cudaLaunchKernelEx(&cfg, cluster_kernel<STAGES>, mp.ta, mp.tc, mp.ts,
                                     (const float*)gs, (const float*)gw, (bf16*)out, M, N, Kq, tps);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace ring

// The copy-ring kernels' instantiations: lab_w8_ring (BN, BKS, STAGES)
// and lab_w8_ring_n (BN, BKS, STAGES), each at cluster sizes 1 ..
// MAX_CLUSTER; the same lists are kernels/gemm_lab.py:RING_CONFIGS and
// RING_N_CONFIGS.
#define RING_CONFIG_LIST(X) \
  X(128, 128, 2) X(128, 128, 4) X(128, 128, 6) X(128, 128, 8) X(256, 128, 2) X(256, 128, 4)
#define RING_N_CONFIG_LIST(X) X(128, 128, 2) X(128, 128, 3) X(128, 128, 4)
constexpr int MAX_CLUSTER = 16;

}  // namespace lab

// xa: [M, Kq] bf16; codes: [Kq, N] int8 (w8) or [Kq/2, N] uint8 (w4);
// scales: [Kq/16, N] uint8; gs: [M] f32; gw: [N] f32; out: [M, N] bf16;
// workspace: splits * M * N floats when splits > 1. The k range of
// split s is 32-tiles [s * tiles_per_split, (s + 1) * tiles_per_split).
// Requires Kq % 32 == 0 and N % 16 == 0.
ARC_EXPORT int arc_lab_w8(const void* xa, const void* codes, const void* scales, const void* gs,
                          const void* gw, void* out, void* workspace, int M, int N, int Kq,
                          int bn, int bks, int stages, int mode, int splits,
                          int tiles_per_split, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (mode < lab::BASE || mode > lab::NOSCALE) return (int)cudaErrorInvalidValue;
  const int rc = lab::dispatch(bn, bks, stages, mode, xa, codes, scales, gs, gw, out, workspace,
                               M, N, Kq, splits, tiles_per_split, st);
  if (rc != 0) return rc;
  return lab::reduce(splits, workspace, gs, gw, out, M, N, st);
}

// As arc_lab_w8 with mode base, as one cluster of `cluster` CTAs per
// 128-wide n tile (and 16-row m tile): CTA r takes 32-tiles [r
// tiles_per_split, (r + 1) tiles_per_split), and the cluster sums the
// partials in distributed shared memory (no workspace, one launch).
// cudaErrorInvalidConfiguration when the card cannot schedule such a
// cluster. Also needs 16-byte aligned xa, codes and scales (TMA).
ARC_EXPORT int arc_lab_w8_ring_n(const void* xa, const void* codes, const void* scales,
                                 const void* gs, const void* gw, void* out, int M, int N,
                                 int Kq, int bn, int bks, int stages, int cluster,
                                 int tiles_per_split, void* stream) {
  lab::ring::Maps mp;
  if (cluster < 1 || cluster > lab::MAX_CLUSTER ||
      !lab::ring::make_maps(mp, xa, codes, scales, M, N, Kq))
    return (int)cudaErrorInvalidValue;
#define RING_N_TRY(BN_, BKS_, ST_)                                                       \
  if (bn == BN_ && bks == BKS_ && stages == ST_)                                         \
    return lab::ring::launch_cluster<ST_>(mp, gs, gw, out, M, N, Kq, cluster, tiles_per_split, \
                                          (cudaStream_t)stream);
  RING_N_CONFIG_LIST(RING_N_TRY)
#undef RING_N_TRY
  return (int)cudaErrorInvalidValue;
}

// How many clusters of lab_w8_ring_n's configuration (bn, bks, stages) at
// cluster size `cluster` the card can hold at once, into *active (0: it
// cannot schedule one). Launches nothing.
ARC_EXPORT int arc_lab_cluster_fit(int bn, int bks, int stages, int cluster, int* active) {
  *active = 0;
  if (cluster < 1 || cluster > lab::MAX_CLUSTER) return 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
#define RING_N_FIT(BN_, BKS_, ST_)            \
  if (bn == BN_ && bks == BKS_ && stages == ST_) \
    return lab::ring::cluster_config<ST_>(cfg, attr, cluster, dim3(cluster, 1, 1), 0, active);
  RING_N_CONFIG_LIST(RING_N_FIT)
#undef RING_N_FIT
  return (int)cudaErrorInvalidValue;
}

// As arc_lab_w8 (mode base) on a persistent grid of `blocks` blocks,
// each driving one TMA ring over its run of work items; the split-K
// partials (splits > 1) are summed by w8::splitk_reduce_kernel. Also
// needs 16-byte aligned xa, codes and scales (TMA).
ARC_EXPORT int arc_lab_w8_ring(const void* xa, const void* codes, const void* scales,
                               const void* gs, const void* gw, void* out, void* workspace,
                               int M, int N, int Kq, int bn, int bks, int stages, int splits,
                               int tiles_per_split, int blocks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  lab::ring::Maps mp;
  if (blocks < 1 || !lab::ring::make_maps(mp, xa, codes, scales, M, N, Kq))
    return (int)cudaErrorInvalidValue;
  int rc = (int)cudaErrorInvalidValue;
#define RING_TRY(BN_, BKS_, ST_)                                                          \
  if (bn == BN_ && bks == BKS_ && stages == ST_)                                          \
    rc = lab::ring::launch_ring<BN_ / lab::ring::HALF, ST_>(mp, gs, gw, out, workspace, M, N, Kq, \
                                                            splits, tiles_per_split, blocks, st);
  RING_CONFIG_LIST(RING_TRY)
#undef RING_TRY
  if (rc != 0) return rc;
  return lab::reduce(splits, workspace, gs, gw, out, M, N, st);
}

// As arc_lab_w8 with codes: [Kq/2, N] uint8 e2m1x nibble pairs and the
// w4 modes (f32, i16, nodec).
ARC_EXPORT int arc_lab_w4(const void* xa, const void* codes, const void* scales, const void* gs,
                          const void* gw, void* out, void* workspace, int M, int N, int Kq,
                          int bn, int bks, int stages, int mode, int splits,
                          int tiles_per_split, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (mode < lab::W4_F32 || mode > lab::W4_NODEC) return (int)cudaErrorInvalidValue;
  const int rc = lab::dispatch(bn, bks, stages, mode, xa, codes, scales, gs, gw, out, workspace,
                               M, N, Kq, splits, tiles_per_split, st);
  if (rc != 0) return rc;
  return lab::reduce(splits, workspace, gs, gw, out, M, N, st);
}
