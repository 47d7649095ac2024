// Batched dequant GEMM over a stack of experts' weights:
// y[e] = (xa[e] @ dec(W[e])) * gs[e, m] * gw[e, n], w8 or w4 codes.
//
// Replaces the TPU kernel arcquant_tpu/kernels/gemm.py:gemm_dequant_batched
// (a jax.vmap of _gemm_call, whose pallas_call lifts the expert axis to a
// leading parallel grid dimension). Plain PyTorch version:
// arcquant_tpu_torch/kernels/gemm.py:gemm_batched_plain. It runs the MoE
// down projection in dense mode (models/moe.py:_ffn_dense_packed): every
// expert on every token of a decode step or a short prefill, E 60, M the
// tokens, Kq 2048 (ARC) or 1536, N 2048 on Qwen1.5-MoE-A2.7B.
//
// One launch for all experts. At M <= 64 the grid is (n-tiles, m-tiles x
// splits, E) of 128-thread blocks; each block offsets xa, codes, scales,
// gs, gw, out and the split-K workspace by its expert and runs the
// small-M mainloop of gemm_small_m.cuh (gemm_small_tile: BM 16, 32 or
// 64 rows, the smallest that holds M; the w8 decode, or the w4 one with
// kW4) over its split's k-tiles. The split plan is the single GEMM's for
// (M, N, Kq) (kernels/gemm.py:_split_plan), and the reduce sums an
// expert's splits in split order from 0.0f. At M > 64 it launches the
// single GEMM's warpgroup-MMA kernel (gemm_wgmma.cuh) with the expert as
// the tensor maps' third coordinate (grid z). Either way each expert's
// slice equals a gemm_w8 (or gemm_w4) launch on that expert bit for bit:
// both run the same mainloop at the same plan.
//
// Bound on the H100: the weight stream at decode (1.06 bytes a weight in
// w8, 0.5625 in w4): 267 MB and 142 MB at E 60, Kq 2048, N 2048, so
// 0.080 and 0.042 ms at 3.35 TB/s. With the single GEMM's plan a decode
// step launches 16 n-tiles x 4 splits x 60 experts = 3840 blocks, about
// ten waves of three blocks an SM, each block's cp.async ring keeping
// its weight loads in flight as the single GEMM's does; a plan tuned
// across experts is later work.
#include "gemm_wgmma.cuh"

namespace {

template <int FM, bool kW4>
__global__ void __launch_bounds__(w8::small::NT, 3)
gemm_batched_kernel(const bf16* __restrict__ xa, const int8_t* __restrict__ codes,
                    const uint8_t* __restrict__ scales, const float* __restrict__ gs,
                    const float* __restrict__ gw, void* __restrict__ out, int out_f32,
                    float* __restrict__ partial, int M, int N, int Kq, int splits,
                    int tiles_per_split, int vec) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int64_t e = blockIdx.z;
  const int m_tile = blockIdx.y / splits, split = blockIdx.y % splits;
  const int64_t mn = (int64_t)M * N;
  const int64_t code_rows = kW4 ? Kq / 2 : Kq;
  const int kt0 = split * tiles_per_split;
  const int kt1 = min(kt0 + tiles_per_split, Kq / w8::BK);
  void* out_e = out_f32 ? (void*)(reinterpret_cast<float*>(out) + e * mn)
                        : (void*)(reinterpret_cast<bf16*>(out) + e * mn);
  w8::small::gemm_small_tile<FM, kW4>(
      xa + e * M * Kq, codes + e * code_rows * N, scales + e * (Kq / 16) * N, gs + e * M,
      gw + e * N, nullptr, out_e, out_f32, partial != nullptr ? partial + e * splits * mn : nullptr,
      split, M, N, Kq, m_tile * w8::small::Cfg<FM, kW4>::BM, blockIdx.x * w8::small::BN, kt0, kt1,
      vec != 0, smem);
}

template <int FM, bool kW4>
int launch_small(const void* xa, const void* codes, const void* scales, const void* gs,
                 const void* gw, void* out, int out_f32, float* part, int E, int M, int N, int Kq,
                 int splits, int tiles_per_split, int vec, cudaStream_t st) {
  using C = w8::small::Cfg<FM, kW4>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_batched_kernel<FM, kW4>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((N + w8::small::BN - 1) / w8::small::BN, ((M + C::BM - 1) / C::BM) * splits, E);
  gemm_batched_kernel<FM, kW4><<<grid, w8::small::NT, C::SMEM, st>>>(
      (const bf16*)xa, (const int8_t*)codes, (const uint8_t*)scales, (const float*)gs,
      (const float*)gw, out, out_f32, part, M, N, Kq, splits, tiles_per_split, vec);
  return (int)cudaGetLastError();
}

// Sums each expert's split-K partials ([E, splits, M, N]) in split order,
// then the single GEMM's epilogue with the expert's gs row and gw row.
__global__ void batched_reduce_kernel(const float* __restrict__ partial, int splits,
                                      const float* __restrict__ gs,
                                      const float* __restrict__ gw, void* __restrict__ out,
                                      int out_f32, int E, int M, int N) {
  const int64_t mn = (int64_t)M * N;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= E * mn) return;
  const int64_t e = idx / mn, r = idx % mn;
  const float v = w8::sum_splits(partial + e * splits * mn, splits, mn, r);
  w8::store_out(v, idx, (int)(e * M + r / N), (int)(e * N + r % N), gs, gw, nullptr, out,
                out_f32);
}

template <bool kW4>
int launch_batched(const void* xa, const void* codes, const void* scales, const void* gs,
                   const void* gw, void* out, int out_f32, void* workspace, int E, int M, int N,
                   int Kq, int small_m, int splits, int tiles_per_split, cudaStream_t st) {
  float* part = splits > 1 ? (float*)workspace : nullptr;
  if (E > 0 && M > 0 && N > 0) {
    if (!small_m) {
      if (splits != 1) return (int)cudaErrorInvalidValue;
      return w8::big::launch_big<kW4>(xa, codes, scales, gs, gw, nullptr, out, out_f32, E, M, N,
                                      Kq, st);
    }
    // With N % 16 == 0 and Kq % 32 == 0, an expert's slice of xa (M Kq
    // bf16), of codes (Kq N or Kq N / 2 bytes) and of scales (Kq N / 16
    // bytes) is a whole number of 16-byte chunks long, and so is each of
    // their rows: every expert's slice stays 16-byte aligned when the
    // bases are, so one decision holds for every block.
    const int vec =
        N % 16 == 0 && (((uintptr_t)xa | (uintptr_t)codes | (uintptr_t)scales) & 15) == 0;
    const int rc =
        M <= 16 ? launch_small<1, kW4>(xa, codes, scales, gs, gw, out, out_f32, part, E, M, N,
                                       Kq, splits, tiles_per_split, vec, st)
        : M <= 32 ? launch_small<2, kW4>(xa, codes, scales, gs, gw, out, out_f32, part, E, M, N,
                                         Kq, splits, tiles_per_split, vec, st)
                  : launch_small<4, kW4>(xa, codes, scales, gs, gw, out, out_f32, part, E, M, N,
                                         Kq, splits, tiles_per_split, vec, st);
    if (rc != 0) return rc;
    if (splits > 1) {
      const int64_t total = (int64_t)E * M * N;
      batched_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
          part, splits, (const float*)gs, (const float*)gw, out, out_f32, E, M, N);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// w4: codes are uint8 [E, Kq/2, N] e2m1x nibble pairs, else int8 [E, Kq,
// N]; xa: [E, M, Kq] bf16; scales: [E, Kq/16, N] uint8; gs: [E, M] f32;
// gw: [E, N] f32; out: [E, M, N] bf16 or f32 (out_f32). small_m (M <=
// 64) selects the small-M mainloop. With splits > 1, workspace holds E *
// splits * M * N floats. Requires Kq % 32 == 0; without small_m, also N %
// 16 == 0 and 16-byte aligned xa, codes and scales.
ARC_EXPORT int arc_gemm_batched(int w4, const void* xa, const void* codes, const void* scales,
                                const void* gs, const void* gw, void* out, int out_f32,
                                void* workspace, int E, int M, int N, int Kq, int small_m,
                                int splits, int tiles_per_split, void* stream) {
  if (w4)
    return launch_batched<true>(xa, codes, scales, gs, gw, out, out_f32, workspace, E, M, N, Kq,
                                small_m, splits, tiles_per_split, (cudaStream_t)stream);
  return launch_batched<false>(xa, codes, scales, gs, gw, out, out_f32, workspace, E, M, N, Kq,
                               small_m, splits, tiles_per_split, (cudaStream_t)stream);
}
