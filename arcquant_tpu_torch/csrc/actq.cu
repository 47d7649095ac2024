// Per-row NVFP4 activation quantize, one pass, three pre-op modes.
//
// Replaces the TPU kernel arcquant_tpu/kernels/quantize.py:_actq_kernel
// (pallas_call in _actq_call). Plain PyTorch version:
// arcquant_tpu_torch/kernels/quantize.py:actq_plain.
//
// One block per row. Pass 1 applies the pre-op (plain x, rmsnorm(x)*w,
// or silu(gate)*up over the two halves of a fused [M, 2F] gate-up
// output), keeps the bf16 row in shared memory and reduces |x|max to the
// row scale gx = max(absmax * f32(1/2688), 1e-12). Pass 2 takes one
// 16-group per thread: xs = x / gx (the one true division, IEEE), group
// scale ue4m3(absmax(xs) * f32(1/6)), e2m1 qdq in product space, and
// writes xa = value * scale as bf16 (exact: <= 7 significant bits),
// zero-filling [k, kq). The two passes are actq_core.cuh:actq_row, which
// the decode megakernels (mlp_fused.cu) run too.
//
// Bound on the H100: device-memory bytes (2 bytes read per input
// element, 2 written per output element, about 4 flops each). The row
// is read from HBM once (the second pass reads shared memory); stores
// are 16-byte vectors. Rows are independent, so M = 4096 fills the card;
// at decode (M = 4) the launch is latency-bound, which the megakernels
// address by folding the quantize into the GEMM's launch.
//
// Rounding points follow the JAX kernel exactly: rmsnorm normalises in
// f32 with 1/sqrtf (correctly rounded, not rsqrtf), rounds to bf16,
// then multiplies by w in bf16; silu(g)*u is computed in f32 with expf
// and rounded to bf16 before quantizing.
#include "actq_core.cuh"

__global__ void __launch_bounds__(kActqThreads)
actq_kernel(const bf16* __restrict__ a, int64_t lda, const bf16* __restrict__ w,
            bf16* __restrict__ xa, float* __restrict__ gx, int k, int kq, int mode,
            float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[32];
  const int64_t m = blockIdx.x;
  actq_row(a + m * lda, w, xa + m * (int64_t)kq, gx + m, k, kq, mode, eps,
           reinterpret_cast<bf16*>(smem_raw), red);
}

// a: [M, lda] bf16 rows (the first k columns are x; silu_mul reads gate
// [0, k) and up [k, 2k)); w: [k] bf16 norm weight (rmsnorm) or NULL;
// xa: [M, kq] bf16; gx: [M] f32. Requires k % 16 == 0, kq % 8 == 0.
ARC_EXPORT int arc_actq(const void* a, int64_t lda, const void* w, void* xa, void* gx,
                        int m, int k, int kq, int mode, float eps, void* stream) {
  const size_t smem = (size_t)k * sizeof(bf16);
  cudaFuncSetAttribute(actq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  if (m > 0)
    actq_kernel<<<m, kActqThreads, smem, (cudaStream_t)stream>>>(
        (const bf16*)a, lda, (const bf16*)w, (bf16*)xa, (float*)gx, k, kq, mode, eps);
  return (int)cudaGetLastError();
}
