// The dequant GEMM's large-M tile (M > 64, the prefill) on Hopper's
// warpgroup MMA, and the chain GEMM's launcher for both tiles.
//
// Included by gemm_w8.cu and gemm_w4.cu (one entry point per weight
// format) and gemm_batched.cu (the same kernel over a stack of experts,
// blockIdx.z). The small-M tile of the chain's GEMM (M <= 64, the
// decode, with split-K) is gemm_small_m.cuh's.
//
// Bound on the H100: the tensor cores. down at M 4096 (Kq 21504, N
// 3584) is 6.31e11 FLOPs, 0.638 ms at 989 TFLOP/s; its bytes (0.26 GB)
// take 0.08 ms. The design:
// - a block computes a 128 x 128 output tile with two consumer
//   warpgroups of 64 rows each (256 threads, one block an SM);
// - 64-deep k stages stream through a 6-slot ring by TMA
//   (cp.async.bulk.tensor with an mbarrier a slot): the bf16 activation
//   tile (128 x 64, 128-byte swizzle, as wgmma reads it), the raw weight
//   codes (64 x 128 bytes in w8, 32 x 128 in w4) and their ue4m3 scale
//   rows (4 x 128). Thread 0 issues the copies four stages ahead; rows
//   and columns past M, N and Kq arrive as zeros;
// - each stage's codes are decoded once a block into a bf16 B tile in
//   the K-major 128-byte-swizzled layout wgmma reads (three B slots, so
//   a stage's decode overlaps the previous stage's MMAs). A thread takes
//   two columns by 16 k rows, so it decodes each scale once per 16 k
//   rows of a column; the decode is exact (code x ue4m3 / 2, or e2m1 x
//   ue4m3, has at most 6 significant bits), so the B tile holds the
//   small-M tile's values and w4 gives w8's bits;
// - wgmma.mma_async m64n128k16 (bf16 x bf16 -> f32, A and B from shared
//   memory). Each KP = 128 k rows go into a partial accumulator that
//   starts from zero (scale-d 0 on its first MMA), chained across the
//   partial's two stages, and the partial is added into the f32 total
//   with __fadd_rn once its MMAs retire. The two warpgroups' partials are
//   offset by a stage, so one promotes while the other's MMAs run;
// - the epilogue is w8::store_out's: y = v * gs[m] * gw[n] (+ bias[n])
//   in f32, uncontracted, then bf16 or f32. No split-K.
// Accuracy (W4A16: bf16 activations over down's Kq 21504): the f32
// promotions are sequential round-to-nearest adds, whose error grows
// with their number; a 32-deep promotion (672 adds) gave 2.9x the plain
// f32 version's mean error against f64 there, 64 gave 2.4x, 128 gives
// 1.4-1.8x (the bar is 2x; benchmarks/bench_prefill.py --a16). The
// tensor cores' own carry over a 128-deep partial adds little.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "gemm_small_m.cuh"

namespace w8 {
namespace big {

constexpr int BM = 128, BN = 128, BKS = 64;  // output tile, k rows a stage
constexpr int KP = 128;                      // k rows a partial (promotion interval)
constexpr int SPP = KP / BKS;                // stages a partial
static_assert(KP % BKS == 0, "a partial is whole stages");
constexpr int STAGES = 6;                    // TMA ring slots
constexpr int AHEAD = STAGES - 2;            // stages loaded ahead of the one decoded
constexpr int BSLOTS = 3;                    // decoded B tiles
constexpr int THREADS = 256;                 // two consumer warpgroups
constexpr int A_BYTES = BM * BKS * 2;
constexpr int B_BYTES = BN * BKS * 2;
constexpr int S_BYTES = (BKS / 16) * BN;
template <bool kW4>
__host__ __device__ constexpr int code_rows() { return kW4 ? BKS / 2 : BKS; }
template <bool kW4>
constexpr int smem_bytes() {
  return 1024 + STAGES * (A_BYTES + code_rows<kW4>() * BN + S_BYTES) + BSLOTS * B_BYTES +
         STAGES * 8;
}

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(saddr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of parity `phase` to complete; traps (rather than
// hangs the card) if a copy never lands, after about 20 s.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  const uint32_t a = saddr(bar);
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(phase)
        : "memory");
    if (done) return;
    if (clock64() - t0 > 40000000000LL) __trap();
  }
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(saddr(bar))
      : "memory");
}

// Shared-memory matrix descriptor of a K-major tile of 128-byte rows in
// the 128-byte swizzle (8-row groups 1024 bytes apart).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins the accumulators in place around the asynchronous MMAs: no read
// or write of them moves across this point.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A[64 x 16] * B[16 x 128]; scale_d 0 starts d from zero.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void promote(float (&acc)[64], float (&part)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
}

// Decodes one stage's codes (cs) and scale rows (ss) into the bf16 B
// tile bs: [BN rows n][64 k] in the 128-byte swizzle. Warp w takes k rows
// 16 (w / 2) .. + 15, lane l the columns 2 c and 2 c + 1 with c = 32 (w %
// 2) + l; of each pair, the column whose 16-byte chunks land on distinct
// banks across a quarter-warp is stored first (na, then nb).
//
// w8's codes decode on the integer and bf16x2 pipes, not the conversion
// unit (16 results a clock an SM): a code pair c0, c1 of k rows 2j,
// 2j + 1 becomes the bf16
// pair 192 + c (0x4300 | (c + 64): exact for |c| < 64; the mag2 codes
// are within 12), and one bf16x2 FMA gives (192 + c) * s - 192 * s = c *
// s with s = ue4m3 / 2: exact, as each operand has at most 8 significant
// bits and the result at most 6, so the B tile holds f2bf(c * s), the
// small-M tile's value, bit for bit (+0 for c = 0).
template <bool kW4>
__device__ __forceinline__ void decode_stage(const uint8_t* cs, const uint8_t* ss, uint8_t* bs,
                                             int warp, int lane) {
  const int kb = warp >> 1, c = (warp & 1) * 32 + lane;
  const uint32_t swap = (c >> 2) & 1;
  const uint32_t sel = swap ? 0x3201u : 0x3210u;  // byte 0 <-> byte 1
  const uint32_t sw = __byte_perm(*reinterpret_cast<const uint16_t*>(ss + kb * BN + 2 * c), 0, sel);
  uint32_t oa[8], ob[8];  // bf16 pairs (k rows 2j, 2j + 1) of columns na and nb
  if constexpr (kW4) {
    const float sa = ue4m3_decode(sw & 0xFFu), sb = ue4m3_decode((sw >> 8) & 0xFFu);
#pragma unroll
    for (int i = 0; i < 8; ++i) {  // code row 8 kb + i holds k rows 2i, 2i + 1
      const uint32_t w =
          __byte_perm(*reinterpret_cast<const uint16_t*>(cs + (8 * kb + i) * BN + 2 * c), 0, sel);
      oa[i] = pack2(e2m1x_decode(w & 15u) * sa, e2m1x_decode((w >> 4) & 15u) * sa);
      ob[i] = pack2(e2m1x_decode((w >> 8) & 15u) * sb, e2m1x_decode((w >> 12) & 15u) * sb);
    }
  } else {
    const float sa = ue4m3_decode(sw & 0xFFu) * 0.5f, sb = ue4m3_decode((sw >> 8) & 0xFFu) * 0.5f;
    const __nv_bfloat162 ma = __float2bfloat162_rn(sa), ba = __float2bfloat162_rn(-192.0f * sa);
    const __nv_bfloat162 mb = __float2bfloat162_rn(sb), bb = __float2bfloat162_rn(-192.0f * sb);
    // bytes 0 and 2 of the pair from byte `swap` (na) or `swap ^ 1` (nb) of
    // rows 2j and 2j + 1; bytes 1 and 3 zero (byte 2 of a u16 load)
    const uint32_t sel_a = swap ? 0x2521u : 0x2420u, sel_b = swap ? 0x2420u : 0x2521u;
    uint32_t w[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = *reinterpret_cast<const uint16_t*>(cs + (16 * kb + i) * BN + 2 * c);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t xa = ((__byte_perm(w[2 * j], w[2 * j + 1], sel_a) + 0x00400040u) & 0x00FF00FFu) |
                          0x43004300u;
      const uint32_t xb = ((__byte_perm(w[2 * j], w[2 * j + 1], sel_b) + 0x00400040u) & 0x00FF00FFu) |
                          0x43004300u;
      oa[j] = bits(__hfma2(as_bf162(xa), ma, ba));
      ob[j] = bits(__hfma2(as_bf162(xb), mb, bb));
    }
  }
  const int na = 2 * c + (int)swap, nb = 2 * c + (int)(swap ^ 1);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int chunk = 2 * kb + h;
    *reinterpret_cast<uint4*>(bs + na * 128 + ((chunk ^ (na & 7)) << 4)) =
        make_uint4(oa[4 * h], oa[4 * h + 1], oa[4 * h + 2], oa[4 * h + 3]);
    *reinterpret_cast<uint4*>(bs + nb * 128 + ((chunk ^ (nb & 7)) << 4)) =
        make_uint4(ob[4 * h], ob[4 * h + 1], ob[4 * h + 2], ob[4 * h + 3]);
  }
}

// One 128 x 128 tile of expert blockIdx.z. ta: xa [E, M, Kq] bf16 (box
// 64 x 128, 128-byte swizzle); tc: codes [E, Kq(/2), N] bytes (box 128 x
// code rows); ts: scales [E, Kq/16, N] (box 128 x 4). gs: [E, M]; gw:
// [E, N]; out: [E, M, N].
template <bool kW4>
__global__ void __launch_bounds__(THREADS, 1)
gemm_big_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tc,
                const __grid_constant__ CUtensorMap ts, const float* __restrict__ gs,
                const float* __restrict__ gw, const bf16* __restrict__ bias,
                void* __restrict__ out, int out_f32, int M, int N, int Kq) {
  constexpr int CROWS = code_rows<kW4>(), C_BYTES = CROWS * BN;
  constexpr uint32_t TX = A_BYTES + C_BYTES + S_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  uint8_t* As = base;                       // [STAGES][BM rows][128 B], swizzled
  uint8_t* Bs = As + STAGES * A_BYTES;      // [BSLOTS][BN rows][128 B], swizzled
  uint8_t* Cs = Bs + BSLOTS * B_BYTES;      // [STAGES][CROWS][BN] codes
  uint8_t* Ss = Cs + STAGES * C_BYTES;      // [STAGES][4][BN] scales
  uint64_t* full = reinterpret_cast<uint64_t*>(Ss + STAGES * S_BYTES);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = tid >> 7;
  const int e = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int T = (Kq + BKS - 1) / BKS;

  auto issue = [&](int t) {
    const int s = t % STAGES;
    mbar_expect_tx(&full[s], TX);
    tma_load(As + s * A_BYTES, &ta, &full[s], t * BKS, m0, e);
    tma_load(Cs + s * C_BYTES, &tc, &full[s], n0, t * CROWS, e);
    tma_load(Ss + s * S_BYTES, &ts, &full[s], n0, t * (BKS / 16), e);
  };
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int t = 0; t < T && t < AHEAD; ++t) issue(t);

  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  // Waits for stage t, decodes its B tile, frees stage t - 2's slot for
  // stage t + AHEAD; returns the stage's A and B tile addresses.
  auto stage_in = [&](int t, uint32_t& a_addr, uint32_t& b_addr) {
    const int s = t % STAGES, bslot = t % BSLOTS;
    mbar_wait(&full[s], (uint32_t)(t / STAGES) & 1u);
    decode_stage<kW4>(Cs + s * C_BYTES, Ss + s * S_BYTES, Bs + bslot * B_BYTES, warp, lane);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // the B tile is whole; both warpgroups are past stage t - 2
    if (tid == 0 && t + AHEAD < T) issue(t + AHEAD);
    a_addr = saddr(As + s * A_BYTES + wg * 64 * 128);
    b_addr = saddr(Bs + bslot * B_BYTES);
  };
  // The next stage's decode runs while this stage's MMAs are in flight;
  // then each warpgroup waits for its MMAs before it reads `part` (ptxas
  // serializes every wgmma if a register of an MMA in flight is read)
  // and before the slots of this stage are reused (a wait for all but
  // the last stage's MMAs, with a fourth B slot, measured slower).
  // Warpgroup wg's partials cover stages [SPP u - wg, SPP (u + 1) - wg)
  // (from 0): the two promote on alternate stages, so one's MMAs keep the
  // tensor cores busy while the other promotes.
  uint32_t a_addr, b_addr;
  stage_in(0, a_addr, b_addr);
  for (int t = 0; t < T; ++t) {
    const bool first = t == 0 || (t + wg) % SPP == 0;
    const bool last = (t + 1 + wg) % SPP == 0 || t + 1 == T;
    fence_acc(part);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BKS / 16; ++j)
      wgmma_m64n128k16(part, desc_sw128(a_addr + j * 32), desc_sw128(b_addr + j * 32),
                       j > 0 || !first);
    wgmma_commit();
    if (t + 1 < T) stage_in(t + 1, a_addr, b_addr);
    wgmma_wait<0>();
    fence_acc(part);
    if (last) promote(acc, part);
  }

  // accumulator element 4i + j: row 16 (warp % 4) + lane / 4 (+ 8 for j
  // >= 2), column 8i + 2 (lane % 4) + j % 2 of the warpgroup's 64 x 128
  const int64_t mn = (int64_t)M * N;
  void* out_e = out_f32 ? (void*)(reinterpret_cast<float*>(out) + e * mn)
                        : (void*)(reinterpret_cast<bf16*>(out) + e * mn);
  const float* gs_e = gs + (int64_t)e * M;
  const float* gw_e = gw + (int64_t)e * N;
  const int r0 = m0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int gn = n0 + 8 * i + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gm = r0 + (j >> 1) * 8, n = gn + (j & 1);
      if (gm < M && n < N)
        store_out(acc[4 * i + j], (int64_t)gm * N + n, gm, n, gs_e, gw_e, bias, out_e, out_f32);
    }
  }
}

using EncodeFn = PFN_cuTensorMapEncodeTiled_v12000;

inline EncodeFn encode_fn() {
  static EncodeFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeFn>(p);
  }
  return fn;
}

// A 3-d tiled map over bytes or bf16: dims {d0, d1, d2} with d0
// contiguous, row strides s1 and s2 in bytes, box {b0, b1, 1}.
inline bool make_map(CUtensorMap* map, CUtensorMapDataType dt, const void* base, uint64_t d0,
                     uint64_t d1, uint64_t d2, uint64_t s1, uint64_t s2, uint32_t b0, uint32_t b1,
                     CUtensorMapSwizzle swizzle) {
  EncodeFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {s1, s2};
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, dt, 3, const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launches the large-M tile over E experts (E = 1: the single GEMM).
// Requires N % 16 == 0, Kq % 16 == 0 and 16-byte aligned xa, codes and
// scales (TMA's global strides and addresses).
template <bool kW4>
int launch_big(const void* xa, const void* codes, const void* scales, const void* gs,
               const void* gw, const void* bias, void* out, int out_f32, int E, int M, int N,
               int Kq, cudaStream_t st) {
  if (N % 16 != 0 || Kq % 16 != 0 || ((uintptr_t)xa | (uintptr_t)codes | (uintptr_t)scales) & 15)
    return (int)cudaErrorInvalidValue;
  const uint64_t crows = kW4 ? Kq / 2 : Kq;
  CUtensorMap ta, tc, ts;
  if (!make_map(&ta, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, xa, Kq, M, E, (uint64_t)Kq * 2,
                (uint64_t)M * Kq * 2, BKS, BM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&tc, CU_TENSOR_MAP_DATA_TYPE_UINT8, codes, N, crows, E, N, crows * N, BN,
                code_rows<kW4>(), CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_map(&ts, CU_TENSOR_MAP_DATA_TYPE_UINT8, scales, N, Kq / 16, E, N,
                (uint64_t)(Kq / 16) * N, BN, BKS / 16, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<kW4>();
  cudaFuncSetAttribute(gemm_big_kernel<kW4>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, E);
  gemm_big_kernel<kW4><<<grid, THREADS, smem, st>>>(ta, tc, ts, (const float*)gs,
                                                   (const float*)gw, (const bf16*)bias, out,
                                                   out_f32, M, N, Kq);
  return (int)cudaGetLastError();
}

}  // namespace big

// Launches the chain's GEMM on `st` (see arc_gemm_w8 / arc_gemm_w4 for
// the arguments); returns cudaGetLastError(). M <= 64 (small_m) takes
// gemm_small_m.cuh's tile with split-K, larger M the warpgroup-MMA tile.
template <bool kW4>
int launch_gemm(const void* xa, const void* codes, const void* scales, const void* gs,
                const void* gw, const void* bias, void* out, int out_f32, void* workspace,
                int M, int N, int Kq, int small_m, int splits, int tiles_per_split,
                cudaStream_t st) {
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  if (!small_m) {
    if (splits != 1) return (int)cudaErrorInvalidValue;
    return big::launch_big<kW4>(xa, codes, scales, gs, gw, bias, out, out_f32, 1, M, N, Kq, st);
  }
  float* part = splits > 1 ? (float*)workspace : nullptr;
  const int rc = small::launch<kW4>(xa, codes, scales, gs, gw, bias, out, out_f32, part, M, N, Kq,
                                    splits, tiles_per_split, st);
  if (rc != 0) return rc;
  if (splits > 1) {
    const int64_t total = (int64_t)M * N;
    splitk_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        part, splits, (const float*)gs, (const float*)gw, (const bf16*)bias, out, out_f32, M, N);
  }
  return (int)cudaGetLastError();
}

}  // namespace w8
