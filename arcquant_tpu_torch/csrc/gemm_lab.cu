// The GEMM lab: variants of the dequant GEMM's mainloop, tile and decode,
// y = bf16((xa @ dec(W)) * gs[m] * gw[n]) with f32 accumulation.
//
// Replaces the TPU kernels of benchmarks/gemm_lab.py, the GEMM lab's
// Pallas variants (each a function reaching pl.pallas_call):
//   w8_variant      (:48)   -> arc_lab_w8       decode modes base, mul3d,
//                                               bf16, noscale
//   w8_dma_variant  (:231)  -> arc_lab_w8_ring  a hand-driven copy ring
//   w8_dma_nblock   (:300)  -> arc_lab_w8_ring_n one block per n tile
//   w4_variant      (:429)  -> arc_lab_w4       nibble decodes f32, i16,
//                                               nodec
// Plain PyTorch versions: arcquant_tpu_torch/kernels/gemm_lab.py
// (lab_w8_plain, lab_w4_plain). The lab measures alternatives to the
// production mainloop (gemm_w8_core.cuh: a register-staged,
// single-buffered 32-deep k-tile) against the same bits; it is not on a
// serving path.
//
// What the lab varies, and what it keeps:
//   - a ring of STAGES shared-memory stages, filled with 16-byte
//     cp.async copies (commit_group / wait_group), each holding BKS k
//     rows of the weight (BKS code rows in w8, BKS/2 in w4), their
//     BKS/16 scale rows and the 16 x BKS activations; BN columns a block;
//   - the decode mode, which turns a stage's codes into a bf16 32 x BN
//     tile in shared memory, 32 k rows at a time;
//   - the product is the production one: each 32-deep sub-tile runs its
//     two k = 16 WMMA MMAs from a zeroed fragment and is promoted into
//     the f32 total with __fadd_rn; the split-K partials are summed in
//     split order (w8::splitk_reduce_kernel); the epilogue is
//     w8::store_out's. So with production's split plan
//     (kernels/gemm.py:_split_plan) every mode whose decode is exact
//     (base, mul3d, bf16; w4 f32 and i16: an e2m1 value times a ue4m3
//     scale has at most 6 significant bits) gives gemm_w8's bits. The
//     probes (noscale, nodec) compute other functions on purpose.
//
// The TPU forms that do not carry over: w8_dma_variant's grid=(1,) would
// fill one SM of 132, so arc_lab_w8_ring is a persistent grid (a block or
// two an SM) that walks the weight's (split, m-tile, n-tile) work items in
// the order of the weight's bytes, each block a contiguous run of items
// driven through one copy ring that does not drain between items.
// w8_dma_nblock's one program per n block over the whole K is lab_w8's
// kernel with a single split (arc_lab_w8_ring_n). w4_variant reads the
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
#include "gemm_w8_core.cuh"

namespace lab {

using namespace nvcuda;

enum Mode { BASE = 0, MUL3D = 1, BF16 = 2, NOSCALE = 3, W4_F32 = 4, W4_I16 = 5, W4_NODEC = 6 };

constexpr int BM = 16;    // activation rows a block (decode M <= 16)
constexpr int SUBK = 32;  // the production k-tile: what one promotion covers

#define LAB_AL(x) ((((x) + 127) / 128) * 128)

// The layout of a configuration's dynamic shared memory: STAGES stages
// of [codes CR x BN | scales SR x BN | activations BM x LDA bf16], then
// the decoded B tile, the epilogue's per-warp staging and, for mul3d, the
// stage's decoded scale tile. Mirrored by kernels/gemm_lab.py:smem_bytes.
template <int BN_, int BKS_, int STAGES_, int MODE_>
struct Cfg {
  static constexpr int BN = BN_, BKS = BKS_, STAGES = STAGES_, MODE = MODE_;
  static constexpr bool W4 = MODE >= W4_F32;
  static constexpr int NW = BN / 32;  // warps; each owns 32 columns
  static constexpr int NT = NW * 32;
  static constexpr int SUB = BKS / SUBK;           // sub-tiles a stage
  static constexpr int CRT = W4 ? SUBK / 2 : SUBK;  // code rows a sub-tile
  static constexpr int CR = SUB * CRT;              // code rows a stage
  static constexpr int SR = BKS / 16;               // scale rows a stage
  static constexpr int CPR = BN / 16;               // 16-byte chunks a code row
  static constexpr int LDA = BKS + 8, LDB = BN + 8;
  static constexpr int CODE_B = LAB_AL(CR * BN), SCALE_B = LAB_AL(SR * BN);
  static constexpr int A_B = LAB_AL(BM * LDA * 2);
  static constexpr int STAGE_B = CODE_B + SCALE_B + A_B;
  static constexpr int BS_B = LAB_AL(SUBK * LDB * 2);
  static constexpr int CS_B = LAB_AL(NW * 256 * 4);
  static constexpr int S3_B = MODE == MUL3D ? LAB_AL(SR * BN * 4) : 0;
  static constexpr int SMEM = STAGES * STAGE_B + BS_B + CS_B + S3_B;
  static_assert(BKS % SUBK == 0 && BN % 32 == 0, "tile");
};

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

__device__ __forceinline__ void cp16(void* smem, const void* gmem, bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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
  for (int c = tid; c < C::CR * C::CPR; c += C::NT) {
    const int r = c / C::CPR, nc = (c % C::CPR) * 16;
    if (r < crows) {
      const bool ok = n0 + nc < N;
      cp16(cs + r * C::BN + nc, codes + (int64_t)(t0 * C::CRT + r) * N + (ok ? n0 + nc : 0), ok);
    }
  }
  for (int c = tid; c < C::SR * C::CPR; c += C::NT) {
    const int r = c / C::CPR, nc = (c % C::CPR) * 16;
    if (r < srows) {
      const bool ok = n0 + nc < N;
      cp16(ss + r * C::BN + nc, scales + (int64_t)(t0 * 2 + r) * N + (ok ? n0 + nc : 0), ok);
    }
  }
  constexpr int APR = C::BKS / 8;  // 16-byte chunks of an activation row
  for (int c = tid; c < BM * APR; c += C::NT) {
    const int r = c / APR, kc = (c % APR) * 8;
    if (kc < nsub * SUBK) {
      const bool ok = m0 + r < M;
      cp16(as + r * C::LDA + kc, xa + (int64_t)(ok ? m0 + r : 0) * Kq + t0 * SUBK + kc, ok);
    }
  }
}

// Decodes code rows of sub-tile u into the bf16 [32, BN] tile Bs.
template <class C>
__device__ __forceinline__ void decode_sub(const uint8_t* stage, const float* s3, bf16* Bs,
                                           int u) {
  const uint8_t* cs = stage;
  const uint8_t* ss = stage + C::CODE_B;
  const int tid = threadIdx.x;
  for (int c = tid; c < C::CRT * C::CPR; c += C::NT) {
    const int r = c / C::CPR, nc = (c % C::CPR) * 16;
    const uint4 cv = *reinterpret_cast<const uint4*>(cs + (u * C::CRT + r) * C::BN + nc);
    const uint8_t* cb = reinterpret_cast<const uint8_t*>(&cv);
    if constexpr (!C::W4) {
      const int srow = u * 2 + r / 16;
      const uint4 sv = *reinterpret_cast<const uint4*>(ss + srow * C::BN + nc);
      const uint8_t* sb = reinterpret_cast<const uint8_t*>(&sv);
      __align__(16) bf16 wv[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float code = (float)(int8_t)cb[j];
        if constexpr (C::MODE == BASE) {
          wv[j] = f2bf(code * (ue4m3_decode(sb[j]) * 0.5f));
        } else if constexpr (C::MODE == MUL3D) {
          wv[j] = f2bf(code * s3[srow * C::BN + nc + j]);
        } else if constexpr (C::MODE == BF16) {
          wv[j] = __hmul(f2bf(code), f2bf(ue4m3_decode(sb[j]) * 0.5f));
        } else {  // NOSCALE
          wv[j] = f2bf(code);
        }
      }
      uint4* dst = reinterpret_cast<uint4*>(Bs + r * C::LDB + nc);
      dst[0] = reinterpret_cast<const uint4*>(wv)[0];
      dst[1] = reinterpret_cast<const uint4*>(wv)[1];
    } else {
      // code row r holds k rows 2r (low nibbles) and 2r + 1 (high)
      const int srow = u * 2 + r / 8;
      const uint4 sv = *reinterpret_cast<const uint4*>(ss + srow * C::BN + nc);
      const uint8_t* sb = reinterpret_cast<const uint8_t*>(&sv);
      __align__(16) bf16 lo[16], hi[16];
      if constexpr (C::MODE == W4_F32) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float sc = ue4m3_decode(sb[j]);
          lo[j] = f2bf(e2m1x_decode(cb[j] & 15u) * sc);
          hi[j] = f2bf(e2m1x_decode(cb[j] >> 4) * sc);
        }
      } else if constexpr (C::MODE == W4_I16) {
        // nibble -> bf16 bits (the f32 map's top half), bf16 scales, and
        // the products of neighbouring columns in one __hmul2
        auto dec = [](uint32_t nib) -> bf16 {
          const uint32_t mag = nib & 7u;
          const uint32_t bits = ((mag << 6) | ((nib & 8u) << 12)) + 0x3F00u;
          return __ushort_as_bfloat16((unsigned short)(mag == 1u ? 0u : bits));
        };
#pragma unroll
        for (int j = 0; j < 16; j += 2) {
          const __nv_bfloat162 s2 =
              __halves2bfloat162(f2bf(ue4m3_decode(sb[j])), f2bf(ue4m3_decode(sb[j + 1])));
          const __nv_bfloat162 l2 =
              __hmul2(__halves2bfloat162(dec(cb[j] & 15u), dec(cb[j + 1] & 15u)), s2);
          const __nv_bfloat162 h2 =
              __hmul2(__halves2bfloat162(dec(cb[j] >> 4), dec(cb[j + 1] >> 4)), s2);
          lo[j] = __low2bfloat16(l2);
          lo[j + 1] = __high2bfloat16(l2);
          hi[j] = __low2bfloat16(h2);
          hi[j + 1] = __high2bfloat16(h2);
        }
      } else {  // W4_NODEC: the byte's bits c << 22 as f32, rounded (exact) to bf16
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          lo[j] = __ushort_as_bfloat16((unsigned short)((uint32_t)cb[j] << 6));
          hi[j] = lo[j];
        }
      }
      uint4* d0 = reinterpret_cast<uint4*>(Bs + (2 * r) * C::LDB + nc);
      uint4* d1 = reinterpret_cast<uint4*>(Bs + (2 * r + 1) * C::LDB + nc);
      d0[0] = reinterpret_cast<const uint4*>(lo)[0];
      d0[1] = reinterpret_cast<const uint4*>(lo)[1];
      d1[0] = reinterpret_cast<const uint4*>(hi)[0];
      d1[1] = reinterpret_cast<const uint4*>(hi)[1];
    }
  }
}

// The nsub 32-deep sub-tiles of a loaded stage into acc (the warp's two
// 16 x 16 fragments of columns warp * 32 + [0, 32)).
template <class C>
__device__ __forceinline__ void compute_stage(const uint8_t* stage, int nsub, bf16* Bs, float* s3,
                                              Acc (&acc)[2]) {
  const bf16* as = reinterpret_cast<const bf16*>(stage + C::CODE_B + C::SCALE_B);
  const int warp = threadIdx.x >> 5;
  if constexpr (C::MODE == MUL3D) {
    // the stage's scale tile, decoded once and indexed per group
    const uint8_t* ss = stage + C::CODE_B;
    for (int i = threadIdx.x; i < nsub * 2 * C::BN; i += C::NT) s3[i] = ue4m3_decode(ss[i]) * 0.5f;
    __syncthreads();
  }
  for (int u = 0; u < nsub; ++u) {
    decode_sub<C>(stage, s3, Bs, u);
    __syncthreads();
    Acc part[2];
    wmma::fill_fragment(part[0], 0.0f);
    wmma::fill_fragment(part[1], 0.0f);
#pragma unroll
    for (int kk = 0; kk < SUBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::load_matrix_sync(af, as + u * SUBK + kk, C::LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(bfr, Bs + kk * C::LDB + warp * 32 + j * 16, C::LDB);
        wmma::mma_sync(part[j], af, bfr, part[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < part[j].num_elements; ++e)
        acc[j].x[e] = __fadd_rn(acc[j].x[e], part[j].x[e]);
    __syncthreads();
  }
}

// acc of the (m0, n0) tile: to partial[split] ([splits, M, N]) when
// `partial` is set, else the epilogue into out (bf16).
template <class C>
__device__ __forceinline__ void store_tile(Acc (&acc)[2], float* cs_all, const float* gs,
                                           const float* gw, bf16* out, float* partial, int split,
                                           int M, int N, int m0, int n0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* cs = cs_all + warp * 256;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    wmma::store_matrix_sync(cs, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int gm = m0 + e / 16, gn = n0 + warp * 32 + j * 16 + e % 16;
      if (gm < M && gn < N) {
        const int64_t idx = (int64_t)gm * N + gn;
        if (partial != nullptr) partial[(int64_t)split * M * N + idx] = cs[e];
        else w8::store_out(cs[e], idx, gm, gn, gs, gw, nullptr, out, 0);
      }
    }
    __syncwarp();
  }
}

// lab_w8 / lab_w8_ring_n / lab_w4: grid (n-tiles, m-tiles, splits); each
// block runs its split's 32-tiles [kt0, kt1) through the STAGES ring.
template <int BN, int BKS, int STAGES, int MODE>
__global__ void __launch_bounds__(BN) lab_kernel(const bf16* __restrict__ xa,
                                                 const int8_t* __restrict__ codes,
                                                 const uint8_t* __restrict__ scales,
                                                 const float* __restrict__ gs,
                                                 const float* __restrict__ gw,
                                                 bf16* __restrict__ out, float* __restrict__ partial,
                                                 int M, int N, int Kq, int tiles_per_split) {
  using C = Cfg<BN, BKS, STAGES, MODE>;
  extern __shared__ __align__(128) uint8_t smem[];
  bf16* Bs = reinterpret_cast<bf16*>(smem + STAGES * C::STAGE_B);
  float* Cs = reinterpret_cast<float*>(smem + STAGES * C::STAGE_B + C::BS_B);
  float* s3 = reinterpret_cast<float*>(smem + STAGES * C::STAGE_B + C::BS_B + C::CS_B);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, split = blockIdx.z;
  const int kt0 = split * tiles_per_split;
  const int ntl = min(kt0 + tiles_per_split, Kq / SUBK) - kt0;
  const int nst = (ntl + C::SUB - 1) / C::SUB;
  Acc acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst)
      load_stage<C>(smem + s * C::STAGE_B, xa, codes, scales, M, N, Kq, m0, n0,
                    kt0 + s * C::SUB, min(C::SUB, ntl - s * C::SUB));
    cp_commit();
  }
  for (int q = 0; q < nst; ++q) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    const int p = q + STAGES - 1;
    if (p < nst)
      load_stage<C>(smem + (p % STAGES) * C::STAGE_B, xa, codes, scales, M, N, Kq, m0, n0,
                    kt0 + p * C::SUB, min(C::SUB, ntl - p * C::SUB));
    cp_commit();
    compute_stage<C>(smem + (q % STAGES) * C::STAGE_B, min(C::SUB, ntl - q * C::SUB), Bs, s3,
                     acc);
  }
  cp_wait<0>();
  store_tile<C>(acc, Cs, gs, gw, out, partial, split, M, N, m0, n0);
}

// lab_w8_ring: a persistent grid. The work items (split, m-tile, n-tile),
// n-tile fastest, follow the weight's bytes (a split's k rows span every
// n-tile); block b takes items [b * I / G, (b + 1) * I / G) and drives one
// copy ring over all their stages: the producer runs STAGES - 1 stages
// ahead of the consumer across item boundaries.
template <int BN, int BKS, int STAGES>
__global__ void __launch_bounds__(BN) ring_kernel(const bf16* __restrict__ xa,
                                                  const int8_t* __restrict__ codes,
                                                  const uint8_t* __restrict__ scales,
                                                  const float* __restrict__ gs,
                                                  const float* __restrict__ gw,
                                                  bf16* __restrict__ out,
                                                  float* __restrict__ partial, int M, int N,
                                                  int Kq, int tiles_per_split, int splits) {
  using C = Cfg<BN, BKS, STAGES, BASE>;
  extern __shared__ __align__(128) uint8_t smem[];
  bf16* Bs = reinterpret_cast<bf16*>(smem + STAGES * C::STAGE_B);
  float* Cs = reinterpret_cast<float*>(smem + STAGES * C::STAGE_B + C::BS_B);
  const int ntn = (N + BN - 1) / BN, ntm = (M + BM - 1) / BM, ktiles = Kq / SUBK;
  const int items = splits * ntm * ntn;
  const int i0 = (int)((int64_t)blockIdx.x * items / gridDim.x);
  const int i1 = (int)((int64_t)(blockIdx.x + 1) * items / gridDim.x);
  // an item's tile origin, first 32-tile and 32-tile count
  auto item = [&](int i, int& m0, int& n0, int& split, int& kt0, int& ntl) {
    split = i / (ntm * ntn);
    m0 = (i / ntn) % ntm * BM;
    n0 = i % ntn * BN;
    kt0 = split * tiles_per_split;
    ntl = min(kt0 + tiles_per_split, ktiles) - kt0;
  };
  int total = 0;
  for (int i = i0; i < i1; ++i) {
    int m0, n0, split, kt0, ntl;
    item(i, m0, n0, split, kt0, ntl);
    total += (ntl + C::SUB - 1) / C::SUB;
  }
  int pi = i0, ps = 0;  // the producer's item and stage within it
  auto produce = [&](int slot) {
    int m0, n0, split, kt0, ntl;
    item(pi, m0, n0, split, kt0, ntl);
    load_stage<C>(smem + slot * C::STAGE_B, xa, codes, scales, M, N, Kq, m0, n0,
                  kt0 + ps * C::SUB, min(C::SUB, ntl - ps * C::SUB));
    if (++ps * C::SUB >= ntl) {
      ++pi;
      ps = 0;
    }
  };
  Acc acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) produce(s);
    cp_commit();
  }
  int ci = i0, cst = 0;  // the consumer's item and stage within it
  for (int q = 0; q < total; ++q) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    if (q + STAGES - 1 < total) produce((q + STAGES - 1) % STAGES);
    cp_commit();
    int m0, n0, split, kt0, ntl;
    item(ci, m0, n0, split, kt0, ntl);
    compute_stage<C>(smem + (q % STAGES) * C::STAGE_B, min(C::SUB, ntl - cst * C::SUB), Bs,
                     nullptr, acc);
    if (++cst * C::SUB >= ntl) {
      store_tile<C>(acc, Cs, gs, gw, out, splits > 1 ? partial : nullptr, split, M, N, m0, n0);
      wmma::fill_fragment(acc[0], 0.0f);
      wmma::fill_fragment(acc[1], 0.0f);
      ++ci;
      cst = 0;
    }
  }
  cp_wait<0>();
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
  return 0;
}

template <int BN, int BKS, int STAGES>
int launch_ring(const void* xa, const void* codes, const void* scales, const void* gs,
                const void* gw, void* out, void* ws, int M, int N, int Kq, int splits, int tps,
                int blocks, cudaStream_t st) {
  using C = Cfg<BN, BKS, STAGES, BASE>;
  cudaError_t e = cudaFuncSetAttribute(ring_kernel<BN, BKS, STAGES>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  ring_kernel<BN, BKS, STAGES><<<blocks, C::NT, C::SMEM, st>>>(
      (const bf16*)xa, (const int8_t*)codes, (const uint8_t*)scales, (const float*)gs,
      (const float*)gw, (bf16*)out, (float*)ws, M, N, Kq, tps, splits);
  return 0;
}

// The instantiated configurations (BN, BKS, STAGES, MODE); the same list
// is kernels/gemm_lab.py:LAB_CONFIGS and RING_CONFIGS.
#define LAB_CONFIG_LIST(X)                                                                    \
  X(64, 32, 3, BASE) X(64, 64, 3, BASE) X(64, 128, 3, BASE) X(64, 256, 3, BASE)               \
  X(128, 32, 3, BASE) X(128, 64, 3, BASE) X(128, 128, 3, BASE) X(128, 256, 3, BASE)           \
  X(256, 32, 3, BASE) X(256, 64, 3, BASE) X(256, 128, 3, BASE)                                \
  X(128, 128, 2, BASE) X(128, 128, 4, BASE) X(128, 128, 6, BASE)                              \
  X(128, 128, 3, MUL3D) X(128, 128, 3, BF16) X(128, 128, 3, NOSCALE)                          \
  X(64, 256, 3, W4_F32) X(128, 128, 3, W4_F32) X(128, 256, 3, W4_F32) X(256, 128, 3, W4_F32)  \
  X(128, 128, 3, W4_I16) X(128, 128, 3, W4_NODEC)
#define RING_CONFIG_LIST(X) X(128, 128, 2) X(128, 128, 3) X(128, 128, 4) X(128, 128, 6)

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

// As arc_lab_w8 with mode base and a single split: one block per BN-wide
// n tile (and 16-row m tile) over the whole K.
ARC_EXPORT int arc_lab_w8_ring_n(const void* xa, const void* codes, const void* scales,
                                 const void* gs, const void* gw, void* out, int M, int N,
                                 int Kq, int bn, int bks, int stages, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int rc = lab::dispatch(bn, bks, stages, lab::BASE, xa, codes, scales, gs, gw, out,
                               nullptr, M, N, Kq, 1, Kq / lab::SUBK, st);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// As arc_lab_w8 (mode base) on a persistent grid of `blocks` blocks.
ARC_EXPORT int arc_lab_w8_ring(const void* xa, const void* codes, const void* scales,
                               const void* gs, const void* gw, void* out, void* workspace,
                               int M, int N, int Kq, int bn, int bks, int stages, int splits,
                               int tiles_per_split, int blocks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int rc = (int)cudaErrorInvalidValue;
#define RING_TRY(BN_, BKS_, ST_)                                                             \
  if (bn == BN_ && bks == BKS_ && stages == ST_)                                             \
    rc = lab::launch_ring<BN_, BKS_, ST_>(xa, codes, scales, gs, gw, out, workspace, M, N, Kq, \
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
