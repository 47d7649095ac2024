// The ARC residual of the selected columns: qdq(v / gx - q(x)) written
// into xa[:, k:k+KE] in one launch (#18 arc_residual).
//
// Replaces no pallas_call. In the JAX package this is
// arcquant_tpu/kernels/quantize.py _arc_residual_into (with the column
// take before it, and for the down_in site the silu(g)*u recompute of
// the selected columns), which XLA fuses inside the jitted step; run
// eagerly in PyTorch it was some 35 small launches a site. This kernel
// is the port's counterpart of that fusion. Plain PyTorch version:
// arcquant_tpu_torch/kernels/quantize.py arc_residual_plain (_top, the
// column take or _silu_mul, then _arc_residual_into).
//
// Numerics, bit for bit the plain version's. For row m and residual
// column j < KE, c = idx[j] (idx = the last KE entries of reorder_index,
// int32 or int64, read in place):
//   v = src[m, c] (plain), or bf16(silu(g) * u) with g = src[m, c] and
//   u = src[m, c + k] (silu_mul: the unsliced gate-up output), the
//   product rounded as actq_core.cuh's silu_mul_bf16 rounds it;
//   err = v / gx[m] - f32(xa[m, c]) (IEEE divide and subtract; the
//   library builds without fast math);
//   each 16 consecutive j form one group: scale = ue4m3(amax|err| *
//   f32(1/6)) (2^-9 for an all-zero group), each element e2m1-rounded in
//   product space with ties to the smaller magnitude (-0.0 gives +0);
//   xa[m, k + j] = that value, exact in bf16.
// The columns read (< k) and written ([k, k + KE)) never overlap, so the
// kernel runs in place after the row quantize (#1 or #13) on the same
// stream.
//
// Design: a block is 16 groups of 16 lanes (256 columns of the residual),
// grid.x over the KE / 256 column ranges and grid.y over the rows (a
// block loops over rows past kMaxRowBlocks); a lane reads its column's
// index once, then per row one element of src (two in silu_mul) and one
// of xa, and the group's max goes by __shfl_xor_sync within its 16
// lanes. A decode step's call moves a few KB, so the launch sets its
// pace; at a prefill the scattered column reads touch most of the 32-byte
// sectors of x and of xa's first k columns.
#include <cassert>

#include "actq_core.cuh"

namespace {

constexpr int kThreads = 256;        // 16 groups of 16 lanes
constexpr int kMaxRowBlocks = 1024;  // grid.y; a block loops past it

template <int MODE, bool IDX64>
__global__ void __launch_bounds__(kThreads)
    arc_residual_kernel(const bf16* __restrict__ src, int64_t lds, bf16* xa, int64_t ldx,
                        const float* __restrict__ gx, int64_t ldg, const void* __restrict__ idx,
                        int m_rows, int k, int ke) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  // KE % 16 == 0: a group's 16 lanes are all live or all past KE
  const bool live = j < ke;
  int c = 0;
  if (live) {
    const int64_t ci = IDX64 ? static_cast<const int64_t*>(idx)[j]
                             : (int64_t) static_cast<const int32_t*>(idx)[j];
    assert(ci >= 0 && ci < k);
    c = (int)ci;
  }
  for (int m = blockIdx.y; m < m_rows; m += gridDim.y) {
    const bf16* row = src + m * lds;
    bf16* xrow = xa + m * ldx;
    float err = 0.0f;
    if (live) {
      const float v = MODE == kModeSiluMul ? bf2f(silu_mul_bf16(row[c], row[c + k]))
                                           : bf2f(row[c]);
      err = __fsub_rn(__fdiv_rn(v, gx[m * ldg]), bf2f(xrow[c]));
    }
    float gmax = fabsf(err);
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) gmax = fmaxf(gmax, __shfl_xor_sync(0xffffffffu, gmax, o));
    const float sc = ue4m3_qdq(gmax * kInvE2m1Max);
    if (live) xrow[k + j] = f2bf(e2m1_qdq(err, sc));
  }
}

template <int MODE>
void launch(bool idx64, dim3 grid, cudaStream_t st, const bf16* src, int64_t lds, bf16* xa,
            int64_t ldx, const float* gx, int64_t ldg, const void* idx, int m, int k, int ke) {
  if (idx64)
    arc_residual_kernel<MODE, true><<<grid, kThreads, 0, st>>>(src, lds, xa, ldx, gx, ldg, idx, m,
                                                              k, ke);
  else
    arc_residual_kernel<MODE, false><<<grid, kThreads, 0, st>>>(src, lds, xa, ldx, gx, ldg, idx,
                                                               m, k, ke);
}

}  // namespace

// src: bf16 rows [M, >= k] (plain) or [M, >= 2k] (silu_mul: gate then up),
// unit column stride, row stride lds elements. xa: bf16 [M, >= k + ke],
// unit column stride, row stride ldx; read at columns < k, written at
// [k, k + ke). gx: f32 per-row scales at gx[m * ldg]. idx: ke column
// indices in [0, k), int64 if idx64 else int32, contiguous. mode:
// actq_core.cuh's kModePlain or kModeSiluMul. Needs ke % 16 == 0.
ARC_EXPORT int arc_residual(const void* src, int64_t lds, void* xa, int64_t ldx, const void* gx,
                            int64_t ldg, const void* idx, int idx64, int m, int k, int ke,
                            int mode, void* stream) {
  if (ke % 16 || ke < 0 || m < 0 || (mode != kModePlain && mode != kModeSiluMul))
    return (int)cudaErrorInvalidValue;
  if (m == 0 || ke == 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((ke + kThreads - 1) / kThreads),
                  (unsigned)(m < kMaxRowBlocks ? m : kMaxRowBlocks));
  const cudaStream_t st = (cudaStream_t)stream;
  if (mode == kModeSiluMul)
    launch<kModeSiluMul>(idx64 != 0, grid, st, (const bf16*)src, lds, (bf16*)xa, ldx,
                         (const float*)gx, ldg, idx, m, k, ke);
  else
    launch<kModePlain>(idx64 != 0, grid, st, (const bf16*)src, lds, (bf16*)xa, ldx,
                       (const float*)gx, ldg, idx, m, k, ke);
  return (int)cudaGetLastError();
}
