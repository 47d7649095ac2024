// Causal GQA flash attention over bf16 q/k/v (prefill), on bf16 tensor
// cores (mma.sync m16n8k16, f32 accumulators).
//
// Replaces the TPU kernel arcquant_tpu/kernels/attention.py:_flash_kernel
// (pallas_call in _flash_call). Plain PyTorch version:
// arcquant_tpu_torch/kernels/attention.py:flash_attention_plain.
//
// The function: the JAX kernel's mask (q_id >= k_id && k_id < Tk, q_id
// counted from q_offset, masked scores -1e30), online softmax in f32,
// final divide by max(l, 1e-30). The kv head of query head hq is
// hq / (Hq / Hkv), so no repeat_kv copy.
//
// Bound on the H100: at prefill T = 1024 the tensor-core operations
// (4 * T^2 * Dh / 2 a head). The design, FA2-style:
// - a block holds 64 query rows, 4 warps of 16, two blocks an SM; a
//   warp's q fragments live in registers for the whole kernel. Grid (Hq,
//   B, q tiles) with the q tiles reversed, so the heaviest causal tiles
//   start first. (128-row blocks of 8 warps, or of 4 warps with two
//   m-tiles each and q in shared memory, measured slower; the latter
//   spills at 255 registers);
// - 64-key K/V tiles stream through a 3-stage cp.async ring of padded
//   rows (Dh + 8 bf16: ldmatrix rows fall on distinct banks), one
//   __syncthreads a tile; tiles wholly above the diagonal are never
//   loaded, a warp skips those above its own rows, and the mask is
//   built only on tiles that cross the diagonal or Tk;
// - S = q k^T: raw bf16 q times k, exact products summed in f32, then
//   multiplied by 1/sqrt(Dh) (bf16 cannot hold q * scale exactly, the
//   reference holds it in f32). Row max and sum stay in registers,
//   reduced across the lane quad; expf, not __expf;
// - O += P V: P goes from the score accumulators straight into A
//   fragments as two bf16 halves, p_hi = bf16(p), p_lo = bf16(p - p_hi),
//   and two MMAs against V (ldmatrix.trans): the reference's PV is f32 p
//   times bf16 v, and the split keeps p to about 2^-16 relative where one
//   bf16 p would add 2^-9 at every element (a single-bf16 p, tried, fell
//   outside one bf16 ulp + 2e-3 of the plain version).
#include "common.cuh"

namespace {

constexpr int kWarps = 4;          // 16 query rows each
constexpr int BQ = 16 * kWarps;    // query rows a block
constexpr int BKV = 64;            // keys a tile
constexpr int kStages = 3;         // K/V tiles in flight
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 2;      // blocks an SM (210 registers a thread at Dh 128)

template <int DH>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int Tq, int Tk,
                  int Hq, int Hkv, int64_t q_sb, int64_t q_st, int64_t k_sb, int64_t k_st,
                  int64_t v_sb, int64_t v_st, int64_t o_sb, int64_t o_st, int q_offset,
                  float scale) {
  constexpr int LD = DH + 8;         // padded bf16 row of a staged K/V tile
  constexpr int KSTEPS = DH / 16;    // k-steps of q k^T
  constexpr int NT = BKV / 8;        // 8-key score tiles
  constexpr int DT = DH / 8;         // 8-dim output tiles
  constexpr int CPR = DH / 8;        // 16-byte chunks a K/V row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [kStages][BKV][LD]
  bf16* Vs = Ks + kStages * BKV * LD;            // [kStages][BKV][LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row group, lane in quad
  const int hq = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // heaviest causal tiles first
  const int hk = hq / (Hq / Hkv);
  const bf16* kb = k + b * k_sb + (int64_t)hk * DH;
  const bf16* vb = v + b * v_sb + (int64_t)hk * DH;

  // this thread's rows: r0 (fragment elements 0, 1) and r1 = r0 + 8 (2, 3)
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const int qlo = q0 + warp * 16 + q_offset;  // the warp's first query id
  uint32_t qf[KSTEPS][4];
  {
    const bf16* qb = q + b * q_sb + (int64_t)hq * DH + 2 * t4;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int c = ks * 16;
      qf[ks][0] = r0 < Tq ? *reinterpret_cast<const uint32_t*>(qb + r0 * q_st + c) : 0u;
      qf[ks][1] = r1 < Tq ? *reinterpret_cast<const uint32_t*>(qb + r1 * q_st + c) : 0u;
      qf[ks][2] = r0 < Tq ? *reinterpret_cast<const uint32_t*>(qb + r0 * q_st + c + 8) : 0u;
      qf[ks][3] = r1 < Tq ? *reinterpret_cast<const uint32_t*>(qb + r1 * q_st + c + 8) : 0u;
    }
  }

  float oacc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[d][e] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf;  // running row max of r0, r1
  float l0 = 0.0f, l1 = 0.0f;        // running row sum over this thread's columns

  const int kv_end = min(Tk, min(q0 + BQ, Tq) + q_offset);  // exclusive causal limit
  const int ntiles = kv_end > 0 ? (kv_end + BKV - 1) / BKV : 0;

  auto load_tile = [&](int tile) {
    const int kv0 = tile * BKV;
    bf16* ks = Ks + (tile % kStages) * BKV * LD;
    bf16* vs = Vs + (tile % kStages) * BKV * LD;
    for (int c = tid; c < BKV * CPR; c += kThreads) {
      const int r = c / CPR, d = (c % CPR) * 8;
      const bool ok = kv0 + r < Tk;  // rows past Tk are zero-filled
      const int64_t rr = ok ? kv0 + r : 0;
      cp16(ks + r * LD + d, kb + rr * k_st + d, ok);
      cp16(vs + r * LD + d, vb + rr * v_st + d, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) load_tile(s);
    cp_commit();
  }
  for (int j = 0; j < ntiles; ++j) {
    cp_wait<kStages - 2>();  // tile j has landed (this thread's copies)
    __syncthreads();            // ... everyone's; and tile j - 1's stage is free
    if (j + kStages - 1 < ntiles) load_tile(j + kStages - 1);
    cp_commit();
    const int kv0 = j * BKV;
    if (kv0 > qlo + 15) continue;  // the whole tile lies above this warp's rows
    const bf16* ks = Ks + (j % kStages) * BKV * LD;
    const bf16* vs = Vs + (j % kStages) * BKV * LD;
    const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix and row this lane addresses

    // S = q k^T: ldmatrix x4 gives the B fragments of two 8-key tiles
    float sacc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = 0.0f;
#pragma unroll
    for (int ks_ = 0; ks_ < KSTEPS; ++ks_) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bfr[4];
        ldsm_x4(bfr, ks + (np * 16 + (mi >> 1) * 8 + mr) * LD + ks_ * 16 + (mi & 1) * 8);
        mma_bf16(sacc[2 * np], qf[ks_], bfr[0], bfr[1]);
        mma_bf16(sacc[2 * np + 1], qf[ks_], bfr[2], bfr[3]);
      }
    }

    const bool need_mask = kv0 + BKV - 1 > qlo || kv0 + BKV > Tk;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = sacc[n][e] * scale;
        if (need_mask) {
          const int kid = kv0 + n * 8 + 2 * t4 + (e & 1);
          const int qid = (e < 2 ? r0 : r1) + q_offset;
          if (!(qid >= kid && kid < Tk)) s = kNegInf;
        }
        sacc[n][e] = s;
      }
      mx0 = fmaxf(mx0, fmaxf(sacc[n][0], sacc[n][1]));
      mx1 = fmaxf(mx1, fmaxf(sacc[n][2], sacc[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      oacc[d][0] *= a0;
      oacc[d][1] *= a0;
      oacc[d][2] *= a1;
      oacc[d][3] *= a1;
    }

    // O += P V over four 16-key steps; the A fragment of step kk is score
    // tiles 2kk (keys +0..7) and 2kk + 1 (keys +8..15)
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const int na = 2 * kk, nb = 2 * kk + 1;
      const float p00 = expf(sacc[na][0] - mn0), p01 = expf(sacc[na][1] - mn0);
      const float p10 = expf(sacc[na][2] - mn1), p11 = expf(sacc[na][3] - mn1);
      const float p20 = expf(sacc[nb][0] - mn0), p21 = expf(sacc[nb][1] - mn0);
      const float p30 = expf(sacc[nb][2] - mn1), p31 = expf(sacc[nb][3] - mn1);
      l0 += (p00 + p01) + (p20 + p21);
      l1 += (p10 + p11) + (p30 + p31);
      uint32_t ph[4], pl[4];
      split_bf16(p00, p01, ph[0], pl[0]);
      split_bf16(p10, p11, ph[1], pl[1]);
      split_bf16(p20, p21, ph[2], pl[2]);
      split_bf16(p30, p31, ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t bfr[4];
        ldsm_x4_trans(bfr, vs + (kk * 16 + (mi & 1) * 8 + mr) * LD + dp * 16 + (mi >> 1) * 8);
        mma_bf16(oacc[2 * dp], ph, bfr[0], bfr[1]);
        mma_bf16(oacc[2 * dp], pl, bfr[0], bfr[1]);
        mma_bf16(oacc[2 * dp + 1], ph, bfr[2], bfr[3]);
        mma_bf16(oacc[2 * dp + 1], pl, bfr[2], bfr[3]);
      }
    }
  }
  cp_wait<0>();

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float L0 = fmaxf(l0, 1e-30f), L1 = fmaxf(l1, 1e-30f);
  bf16* ob = o + b * o_sb + (int64_t)hq * DH + 2 * t4;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    if (r0 < Tq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * o_st + d * 8) =
          __floats2bfloat162_rn(oacc[d][0] / L0, oacc[d][1] / L0);
    if (r1 < Tq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r1 * o_st + d * 8) =
          __floats2bfloat162_rn(oacc[d][2] / L1, oacc[d][3] / L1);
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Tq, int Tk,
           int Hq, int Hkv, const int64_t* st, int q_offset, float scale, cudaStream_t s) {
  const size_t smem = (size_t)kStages * 2 * BKV * (DH + 8) * sizeof(bf16);
  cudaFuncSetAttribute(flash_attn_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid(Hq, B, (Tq + BQ - 1) / BQ);
  flash_attn_kernel<DH><<<grid, kThreads, smem, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, Tq, Tk, Hq, Hkv, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: [B, Tq, Hq, Dh], k/v: [B, Tk, Hkv, Dh], o: [B, Tq, Hq, Dh], all
// bf16 with the head and dim axes contiguous; strides[8] = batch and
// token strides (in elements) of q, k, v, o, multiples of 8, and q, k, v
// 16-byte aligned (cp.async). Dh is 64 or 128.
ARC_EXPORT int arc_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   int B, int Tq, int Tk, int Hq, int Hkv, int Dh,
                                   const int64_t* strides, int q_offset, float scale,
                                   void* stream) {
  if (B == 0 || Tq == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (Dh == 128) return launch<128>(q, k, v, o, B, Tq, Tk, Hq, Hkv, strides, q_offset, scale, s);
  if (Dh == 64) return launch<64>(q, k, v, o, B, Tq, Tk, Hq, Hkv, strides, q_offset, scale, s);
  return (int)cudaErrorInvalidValue;
}
