// Decode megakernels: [rmsnorm +] quantize + one w8 GEMM; gateup GEMM +
// silu*mul + quantize; and the whole MLP, each in one launch.
//
// Replace the TPU kernels of arcquant_tpu/kernels/mlp_fused.py:
//   _gemm_actq_kernel (pallas_call in _gemm_actq_call) -> arc_gemm_actq
//   _gu_actq_kernel   (pallas_call in _gu_actq_call)   -> arc_gu_actq
//   _mlp_w8_kernel    (pallas_call in _mlp_call)       -> arc_mlp_w8
// Plain PyTorch versions: arcquant_tpu_torch/kernels/mlp_fused.py
// (gemm_actq_plain, gu_actq_plain, mlp_w8_plain).
//
// On the TPU each is one program (grid=(1,)) that streams the weights in
// order and keeps x, gu and xa2 in VMEM. On the H100 one block cannot
// stream 144 MB of gateup codes at a useful rate, and each row's scale
// needs its max over every column before any column is quantized. So
// each kernel is a persistent grid of 256-thread blocks, every block
// resident (cudaLaunchCooperativeKernel at the occupancy limit; a grid
// the card cannot hold is refused and the wrapper raises), that walks
// phases separated by grid-wide barriers:
//   A   [rmsnorm +] quantize -> xa, gx: the first a_blocks blocks (a
//       count the wrapper plans from the shapes) each take a contiguous
//       range of the (row, 16-group) space and compute the reductions of
//       the rows they meet themselves (actq_core.cuh:actq_walk, the actq
//       kernel's own walk), so no barrier beyond the one before B
//   B   the w8 GEMM over (n-tile, k-split) items (gemm_small_tile); with splits
//       > 1 the partials go to an f32 workspace and, after a barrier,
//       each element sums them in split order and runs the epilogue
//   C1  silu(g)*u of each 16-group, rounded to bf16, into xa2; each
//       row's |max| is reduced in shared memory, then folded into a
//       global atomicMax (a max is exact in any order)
//   C2  the row scale from that max, and the group quantize in place
//   D   the down GEMM over xa2, as B
// gemm_actq runs A, B; gu_actq runs B, C1, C2; mlp_w8 runs [A,] B, C1,
// C2, D. Every phase runs the unfused chain's own device code
// (actq_core.cuh; gemm_small_m.cuh's mainloop, which gemm_w8 runs at M
// <= 64) at the chain's k split (passed in from
// kernels/gemm.py:_split_plan), so the outputs equal the chain's bit for
// bit. Blocks have 256 threads, the count actq_core.cuh's sum order is
// stated for. The GEMM item is the chain's 16-row (M <= 16) by 128-column
// tile of four computing warps: all eight warps issue its stages'
// cp.async copies (or plain loads, which read the activations through L2
// only) and meet at its barriers, and warps 0-3 run its MMAs and its
// epilogue. Its two stages (46.5 KiB) live in dynamic shared memory,
// which phase A reuses for the chunks of a row beyond K 4096 (none at
// Qwen2.5-7B's hidden 3584: its rows stay in registers).
// __launch_bounds__(256, 3) keeps three blocks resident per SM (396 on
// an H100), so Qwen2.5-7B's 296 gateup tiles and 280 down items run in
// one wave.
//
// xa, gu and xa2 go through device memory (L2-resident at these sizes)
// between phases: producer and consumer are different blocks, and xa2
// alone (16 x 19456 bf16, 608 KB at Qwen2.5-7B) is larger than the
// 227 KB of shared memory a Hopper block has. What another block of the
// same launch wrote is read through L2 (__ldcg, or cp.async.cg), never
// through L1 or the read-only path.
//
// Bound on the H100: the weight stream (about 1.06 bytes per weight; at
// M <= 16 a weight byte carries at most 32 FLOPs). The items spread the
// stream over every SM as the chain's GEMM does, and each barrier costs
// a few microseconds. A deeper weight pipeline and fewer barriers are
// later work.
//
// The grid barrier is hand-rolled on a device-global counter, so the
// build needs no -rdc (cooperative_groups' grid sync is not used), in
// cooperative_groups' scheme: one thread a block fences and arrives,
// the arrivals of a generation add up to 2^31 so that bit 31 flips when
// the last block arrives, and the counter needs no reset. It spins, and
// traps after seconds without progress instead of hanging. It assumes
// one megakernel at a time per device, which the engine's single stream
// gives.
#include <algorithm>

#include "actq_core.cuh"
#include "gemm_small_m.cuh"

namespace {

constexpr int kThreads = kActqThreads;
constexpr int kMaxRows = 16;
// The GEMM item: the chain's tile at M <= 16 (one 16-row m-tile, w8).
using GCfg = w8::small::Cfg<1, false>;
constexpr int kBN = w8::small::BN;
static_assert(kThreads % w8::small::NT == 0, "every warp of the block issues the tile's copies");

__device__ unsigned int g_bar;  // arrivals; bit 31 flips once a generation

// Every thread's writes before the barrier are seen by every thread of
// the grid after it: the block barrier orders them before thread 0's
// fence, which publishes them with its arrival; after the flip, thread
// 0's second fence and the block barrier order the reads that follow.
__device__ __forceinline__ void grid_sync() {
  __syncthreads();
  if (threadIdx.x == 0) {
    // block 0 adds 2^31 - (G - 1), every other block 1: 2^31 in all
    const unsigned int nb = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    volatile unsigned int* bar = &g_bar;
    __threadfence();
    const unsigned int old = atomicAdd(&g_bar, nb);
    unsigned int spins = 0;
    while (((old ^ *bar) & 0x80000000u) == 0)
      if (++spins == (1u << 24)) __trap();
    __threadfence();
  }
  __syncthreads();
}

// One w8 GEMM of a fused kernel: out[M, N] = xa[M, Kq] @ dec(W) * gs * gw
// (+ bias), at the chain's k split (splits, per k-tiles each). vec: the
// stages load by cp.async (N % 16 == 0, 16-byte aligned xa, codes and
// scales), else by plain loads; decided on the host for each GEMM.
struct Gemm {
  const bf16* xa;
  const int8_t* codes;
  const uint8_t* scales;
  const float* gs;
  const float* gw;
  const bf16* bias;
  void* out;
  int out_f32, N, Kq, splits, per, vec;
};

// smem: GCfg::SMEM bytes of dynamic shared memory.
__device__ void gemm_phase(const Gemm& g, int M, float* partial, uint8_t* smem) {
  const int n_tiles = (g.N + kBN - 1) / kBN;
  const int items = n_tiles * g.splits;
  float* part = g.splits > 1 ? partial : nullptr;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int nt = it % n_tiles, s = it / n_tiles;
    const int kt0 = s * g.per, kt1 = min(kt0 + g.per, g.Kq / w8::BK);
    w8::small::gemm_small_tile<1, false, kThreads, true>(
        g.xa, g.codes, g.scales, g.gs, g.gw, g.bias, g.out, g.out_f32, part, s, M, g.N, g.Kq, 0,
        nt * kBN, kt0, kt1, g.vec != 0, smem);
    __syncthreads();  // no warp still reads a stage the next item's prologue fills
  }
  if (g.splits > 1) {
    grid_sync();
    const int64_t mn = (int64_t)M * g.N;
    for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < mn;
         i += (int64_t)gridDim.x * kThreads)
      w8::store_out(w8::sum_splits(partial, g.splits, mn, i), i, (int)(i / g.N),
                    (int)(i % g.N), g.gs, g.gw, g.bias, g.out, g.out_f32);
  }
}

// Phase A: rows of x [M, d] (row stride ldx) -> xa [M, kq], gx [M], on
// the first min(a_blocks, grid) blocks. smem: actq_spill_bytes(d).
template <int MODE>
__device__ void rows_phase(const bf16* x, int64_t ldx, const bf16* normw, float eps, int d,
                           bf16* xa, float* gx, int M, int kq, int a_blocks, uint8_t* smem,
                           float* red) {
  const int nb = min(a_blocks, (int)gridDim.x);
  if ((int)blockIdx.x < nb)
    actq_walk<MODE>(x, ldx, normw, xa, kq, gx, M, d, eps, blockIdx.x, nb,
                    reinterpret_cast<uint4*>(smem), red);
}

// This block's share [g0, g1) of a row's groups (the same in C1 and C2).
__device__ __forceinline__ void group_range(int groups, int& g0, int& g1) {
  g0 = (int)((int64_t)groups * blockIdx.x / gridDim.x);
  g1 = (int)((int64_t)groups * (blockIdx.x + 1) / gridDim.x);
}

__device__ __forceinline__ void load16(const bf16* p, bf16 (&v)[16]) {
  reinterpret_cast<uint4*>(v)[0] = __ldcg(reinterpret_cast<const uint4*>(p));
  reinterpret_cast<uint4*>(v)[1] = __ldcg(reinterpret_cast<const uint4*>(p) + 1);
}

// Phase C1: gu [M, 2F] -> silu(gate)*up in bf16 into xa2[:, :F], zeros
// into xa2[:, F:kq2], each row's |max| into amax (f32 bits as unsigned:
// the order of non-negative floats). smax: kMaxRows of shared memory.
__device__ void silu_phase(const bf16* gu, int M, int F, bf16* xa2, int kq2,
                           unsigned int* amax, unsigned int* smax) {
  int g0, g1;
  group_range(F / 16, g0, g1);
  const int cnt = g1 - g0;
  if (threadIdx.x < kMaxRows) smax[threadIdx.x] = 0u;
  __syncthreads();
  for (int i = threadIdx.x; i < M * cnt; i += kThreads) {
    const int r = i / cnt, c = (g0 + i % cnt) * 16;
    const bf16* gp = gu + (int64_t)r * 2 * F + c;
    __align__(16) bf16 gv[16], uv[16], pv[16];
    load16(gp, gv);
    load16(gp + F, uv);
    float mx = 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      pv[j] = silu_mul_bf16(gv[j], uv[j]);
      mx = fmaxf(mx, fabsf(bf2f(pv[j])));
    }
    uint4* d4 = reinterpret_cast<uint4*>(xa2 + (int64_t)r * kq2 + c);
    d4[0] = reinterpret_cast<const uint4*>(pv)[0];
    d4[1] = reinterpret_cast<const uint4*>(pv)[1];
    atomicMax(&smax[r], __float_as_uint(mx));
  }
  const int pad = (kq2 - F) / 16;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < M * pad; i += gridDim.x * kThreads) {
    uint4* d4 = reinterpret_cast<uint4*>(xa2 + (int64_t)(i / pad) * kq2 + F + (i % pad) * 16);
    d4[0] = make_uint4(0, 0, 0, 0);
    d4[1] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  if (threadIdx.x < M && cnt > 0) atomicMax(&amax[threadIdx.x], smax[threadIdx.x]);
}

// Phase C2: quantize xa2[:, :F] in place with each row's scale; gx2 [M].
__device__ void quant_phase(int M, int F, bf16* xa2, int kq2, const unsigned int* amax,
                            float* gx2) {
  int g0, g1;
  group_range(F / 16, g0, g1);
  const int cnt = g1 - g0;
  for (int i = threadIdx.x; i < M * cnt; i += kThreads) {
    const int r = i / cnt, c = (g0 + i % cnt) * 16;
    const float g = row_scale(__uint_as_float(__ldcg(amax + r)));
    bf16* p = xa2 + (int64_t)r * kq2 + c;
    __align__(16) bf16 pv[16];
    load16(p, pv);
    float v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = bf2f(pv[j]);
    quantize_group16(v, g, p);
  }
  if (blockIdx.x == 0 && threadIdx.x < M)
    gx2[threadIdx.x] = row_scale(__uint_as_float(__ldcg(amax + threadIdx.x)));
}

struct GemmActqArgs {
  const bf16* x;
  int64_t ldx;
  const bf16* normw;
  int mode;
  float eps;
  int M, d, a_blocks;
  Gemm g;  // g.xa = the xa workspace, g.gs = gx
  bf16* xa;
  float* gx;
  float* partial;
};

// Dynamic shared memory of each kernel: the GEMM's stages, which phase
// A's spill reuses; launch() passes the larger size.
__global__ void __launch_bounds__(kThreads, 3) gemm_actq_kernel(GemmActqArgs a) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  __shared__ float red[32];
  if (a.mode == kModeRmsnorm)
    rows_phase<kModeRmsnorm>(a.x, a.ldx, a.normw, a.eps, a.d, a.xa, a.gx, a.M, a.g.Kq,
                             a.a_blocks, smem_raw, red);
  else
    rows_phase<kModePlain>(a.x, a.ldx, a.normw, a.eps, a.d, a.xa, a.gx, a.M, a.g.Kq,
                           a.a_blocks, smem_raw, red);
  grid_sync();
  gemm_phase(a.g, a.M, a.partial, smem_raw);
}

struct GuActqArgs {
  Gemm g;  // the gateup GEMM, g.out = gu
  int M, F, kq2;
  bf16* xa2;
  float* gx2;
  unsigned int* amax;
  float* partial;
};

__global__ void __launch_bounds__(kThreads, 3) gu_actq_kernel(GuActqArgs a) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  __shared__ unsigned int smax[kMaxRows];
  if (blockIdx.x == 0 && threadIdx.x < kMaxRows) a.amax[threadIdx.x] = 0u;
  gemm_phase(a.g, a.M, a.partial, smem_raw);
  grid_sync();
  silu_phase((const bf16*)a.g.out, a.M, a.F, a.xa2, a.kq2, a.amax, smax);
  grid_sync();
  quant_phase(a.M, a.F, a.xa2, a.kq2, a.amax, a.gx2);
}

struct MlpArgs {
  const bf16* x;  // norm mode: the residual stream [M, d]; else null
  int64_t ldx;
  const bf16* normw;
  float eps;
  int d, a_blocks;
  Gemm g1;  // gateup: g1.xa = xa1 (input or workspace), g1.out = gu
  Gemm g2;  // down: g2.xa = xa2, g2.gs = gx2
  int M, F;
  bf16* xa1;   // norm mode: the xa1 workspace [M, g1.Kq]
  float* gx1;  // norm mode: the gx1 workspace [M]
  bf16* xa2;
  float* gx2;
  unsigned int* amax;
  float* partial;
};

__global__ void __launch_bounds__(kThreads, 3) mlp_w8_kernel(MlpArgs a) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  __shared__ float red[32];
  __shared__ unsigned int smax[kMaxRows];
  if (blockIdx.x == 0 && threadIdx.x < kMaxRows) a.amax[threadIdx.x] = 0u;
  if (a.x != nullptr) {
    rows_phase<kModeRmsnorm>(a.x, a.ldx, a.normw, a.eps, a.d, a.xa1, a.gx1, a.M, a.g1.Kq,
                             a.a_blocks, smem_raw, red);
    grid_sync();
  }
  gemm_phase(a.g1, a.M, a.partial, smem_raw);
  grid_sync();
  silu_phase((const bf16*)a.g1.out, a.M, a.F, a.xa2, a.g2.Kq, a.amax, smax);
  grid_sync();
  quant_phase(a.M, a.F, a.xa2, a.g2.Kq, a.amax, a.gx2);
  grid_sync();
  gemm_phase(a.g2, a.M, a.partial, smem_raw);
}

int items(const Gemm& g) { return (g.N + kBN - 1) / kBN * g.splits; }

// Cooperative launch of `kernel` with as many resident blocks as the card
// holds, at most `want`, and the larger of the GEMM's stages and
// `row_bytes` of dynamic shared memory (phase A's spill). Returns a
// cudaError_t value (0 = launched).
template <class Args>
int launch(void (*kernel)(Args), Args args, int want, size_t row_bytes, void* stream) {
  const size_t smem = std::max(row_bytes, (size_t)GCfg::SMEM);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = std::min(std::max(want, 1), per_sm * sms);
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(kThreads), params, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

Gemm make_gemm(const void* xa, const void* codes, const void* scales, const void* gs,
               const void* gw, const void* bias, void* out, int out_f32, int N, int Kq,
               int splits, int per) {
  const int vec =
      N % 16 == 0 && (((uintptr_t)xa | (uintptr_t)codes | (uintptr_t)scales) & 15) == 0;
  return Gemm{(const bf16*)xa, (const int8_t*)codes, (const uint8_t*)scales,
              (const float*)gs, (const float*)gw, (const bf16*)bias, out, out_f32, N, Kq,
              splits, per, vec};
}

}  // namespace

// x: [M, >= D] bf16 rows (stride ldx % 8 == 0, 16-byte aligned); normw:
// [D] bf16 (mode 1, rmsnorm, 16-byte aligned) or NULL (mode 0, plain);
// codes [Kq, N] int8, scales [Kq/16, N] uint8, gw [N] f32, bias [N] bf16
// or NULL; y [M, N] bf16 or f32 (y_f32); gx [M] f32; workspaces xa [M,
// Kq] bf16 and, with splits > 1, partial [splits, M, N] f32; phase A on
// a_blocks blocks. Requires 1 <= M <= 16, D % 16 == 0, Kq % 32 == 0,
// Kq >= D.
ARC_EXPORT int arc_gemm_actq(const void* x, int64_t ldx, const void* normw, int mode,
                             float eps, const void* codes, const void* scales, const void* gw,
                             const void* bias, void* y, int y_f32, void* gx, void* xa_ws,
                             void* partial_ws, int M, int N, int D, int Kq, int splits,
                             int per, int a_blocks, void* stream) {
  GemmActqArgs a{(const bf16*)x, ldx, (const bf16*)normw, mode, eps, M, D, a_blocks,
                 make_gemm(xa_ws, codes, scales, gx, gw, bias, y, y_f32, N, Kq, splits, per),
                 (bf16*)xa_ws, (float*)gx, (float*)partial_ws};
  return launch(gemm_actq_kernel, a, std::max(items(a.g), a_blocks), actq_spill_bytes(D),
                stream);
}

// xa1: [M, Kq1] bf16; gs1: [M] f32; gateup codes [Kq1, 2F], scales,
// gw [2F], bias [2F] or NULL; gu [M, 2F] bf16; xa2 [M, Kq2] bf16; gx2 [M]
// f32; workspaces amax [16] u32 and, with splits > 1, partial
// [splits, M, 2F] f32. Requires 1 <= M <= 16, F % 16 == 0, Kq2 >= F,
// Kq2 % 16 == 0.
ARC_EXPORT int arc_gu_actq(const void* xa1, const void* gs1, const void* codes,
                           const void* scales, const void* gw, const void* bias, void* gu,
                           void* xa2, void* gx2, void* amax_ws, void* partial_ws, int M, int F,
                           int Kq1, int Kq2, int splits, int per, void* stream) {
  GuActqArgs a{make_gemm(xa1, codes, scales, gs1, gw, bias, gu, 0, 2 * F, Kq1, splits, per),
               M, F, Kq2, (bf16*)xa2, (float*)gx2, (unsigned int*)amax_ws,
               (float*)partial_ws};
  return launch(gu_actq_kernel, a, items(a.g), 0, stream);
}

// Norm mode: x [M, >= d] bf16 (stride ldx) and normw [d] bf16, aligned
// as arc_gemm_actq's, with the workspaces xa1 [M, Kq1] bf16 and gx1 [M]
// f32, phase A on a_blocks blocks; quantized mode: x and
// normw NULL, xa1_in [M, Kq1] bf16 and gs1_in [M] f32. Gateup codes1
// [Kq1, 2F] (scales1, gw1 [2F], bias1), down codes2 [Kq2, N2] (scales2,
// gw2 [N2], bias2); out [M, N2] bf16 and gu [M, 2F] bf16 (the activation
// dtype, as in the chain);
// gx2 [M] f32; workspaces xa2 [M, Kq2] bf16, amax [16] u32 and, with
// either GEMM split, partial [max splits * M * N] f32.
ARC_EXPORT int arc_mlp_w8(const void* x, int64_t ldx, const void* normw, float eps, int d,
                          int a_blocks, const void* xa1_in, const void* gs1_in, const void* codes1,
                          const void* scales1, const void* gw1, const void* bias1,
                          const void* codes2, const void* scales2, const void* gw2,
                          const void* bias2, void* out, void* gu, void* gx2,
                          void* xa1_ws, void* gx1_ws, void* xa2_ws, void* amax_ws,
                          void* partial_ws, int M, int F, int Kq1, int Kq2, int N2,
                          int splits1, int per1, int splits2, int per2, void* stream) {
  const bool norm = x != nullptr;
  const void* xa1 = norm ? (const void*)xa1_ws : xa1_in;
  const void* gs1 = norm ? (const void*)gx1_ws : gs1_in;
  MlpArgs a{(const bf16*)x, ldx, (const bf16*)normw, eps, d, a_blocks,
            make_gemm(xa1, codes1, scales1, gs1, gw1, bias1, gu, 0, 2 * F, Kq1, splits1, per1),
            make_gemm(xa2_ws, codes2, scales2, gx2, gw2, bias2, out, 0, N2, Kq2, splits2, per2),
            M, F, (bf16*)xa1_ws, (float*)gx1_ws, (bf16*)xa2_ws, (float*)gx2,
            (unsigned int*)amax_ws, (float*)partial_ws};
  return launch(mlp_w8_kernel, a,
                std::max(std::max(items(a.g1), items(a.g2)), norm ? a_blocks : 1),
                norm ? actq_spill_bytes(d) : 0, stream);
}
