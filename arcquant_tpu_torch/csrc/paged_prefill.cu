// Causal GQA attention of a prefill chunk straight over the paged int4 KV
// pool, with a per-row origin.
//
// Replaces the TPU kernel arcquant_tpu/kernels/paged_decode.py:_prefill_kernel
// (pallas_call in _prefill_call). Plain PyTorch version:
// arcquant_tpu_torch/kernels/paged_decode.py:paged_prefill_plain.
//
// Pool layout (cache/paged.py): codes u8 [P, 2, Hkv, page, Dh/2] with
// split-half nibbles (low nibble = dim d, high = d + Dh/2), params f32
// [P, Hkv, page, 4] = (scale_k, min_k, scale_v, min_v) per token.
//
// One block per (q tile, kv head, batch row). A q tile holds bq = 64 / G
// chunk tokens times the G query heads of the kv head (bq = 9 for
// Qwen2.5-7B's G = 7: 63 score rows, the group is not padded to 8); rows
// are token-major, r = i * G + j, as in the JAX kernel. Row r sits at the
// absolute position qpos = q_starts[b] + tile * bq + r / G. The block
// walks the keys [0, min(seq, q_hi + 1)) in steps of 64, which reads
// exactly the pages ceil(min(seq, q_hi + 1) / page) of its row of the
// page table and nothing past them; a row with seq = 0, and a tile whose
// first token already lies at or past seq, walks none and writes exact
// zeros. Per step it stages 64 tokens' K and V codes
// (unpacked to f32) and params in shared memory, then:
//   scores  s = (q . codes_k) * scale_k + (sum q) * min_k, sm_scale folded
//           into q in f32, masked to kpos <= qpos && kpos < seq (-1e30);
//   softmax online per row, masked p = 0;
//   values  pv = (p * scale_v) . codes_v + sum(p * min_v),
// the same score-space dequantization as the JAX kernel; the output is
// acc / max(l, 1e-30). Padded query rows past seq in a tile that starts
// before seq attend to keys < seq, as in the JAX kernel; the engine
// discards every padded row. The pool is only read.
//
// Bound on the H100: at the serving shapes (chunks of 512 tokens over up
// to 2048 cached tokens) the f32 FMAs of QK^T and PV on the CUDA cores
// bound it; the pool bytes (4.5 bits per K/V element) are small beside
// them and are re-read by each q tile from L2. The design keeps q, one
// step of unpacked K/V and the score tile in shared memory, with 4x4
// score and 8 x Dh/32 output register tiles per thread. Tensor cores
// (wgmma over bf16-exact codes) and split-K over pages are later work.
#include "common.cuh"

namespace {

constexpr int kRows = 64;     // score rows of a block: bq tokens x G heads
constexpr int kKeys = 64;     // keys staged per step
constexpr int kThreads = 256;

template <int DH>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const bf16* __restrict__ q, const uint8_t* __restrict__ codes,
                     const float* __restrict__ params, const int* __restrict__ page_table,
                     const int* __restrict__ q_starts, const int* __restrict__ seq_lens,
                     bf16* __restrict__ out, int Tq, int Hkv, int G, int page, int pps, int bq,
                     float sm_scale) {
  constexpr int D2 = DH / 2;
  constexpr int LDQ = DH + 2;   // f32 row strides padded for bank spread
  constexpr int LDK = DH + 2;
  constexpr int LDS = kKeys + 1;
  constexpr int CPT = DH / 32;  // output dims per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [kRows][LDQ]
  float* Ks = Qs + kRows * LDQ;                    // [kKeys][LDK] K codes
  float* Vs = Ks + kKeys * LDK;                    // [kKeys][DH]  V codes
  float* Ss = Vs + kKeys * DH;                     // [kRows][LDS]
  float* prm = Ss + kRows * LDS;                   // [kKeys][4]
  float* qsum = prm + kKeys * 4;                   // [kRows]
  float* m_s = qsum + kRows;
  float* l_s = m_s + kRows;
  float* a_s = l_s + kRows;
  float* pvm_s = a_s + kRows;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.y, b = blockIdx.z;
  const int t0 = blockIdx.x * bq;  // first chunk token of the tile
  const int Hq = Hkv * G;
  const int nrows = bq * G;
  const int seq = seq_lens[b];
  const int qpos0 = q_starts[b] + t0;  // absolute position of token t0
  // keys [0, kv_limit); a tile wholly past seq is padding: no keys, zeros
  const int kv_limit = qpos0 >= seq ? 0 : min(seq, qpos0 + bq);

  for (int e = tid; e < kRows * DH; e += kThreads) {
    const int r = e / DH, d = e % DH;
    const int tok = t0 + r / G;
    float v = 0.0f;
    if (r < nrows && tok < Tq)
      v = bf2f(q[(((int64_t)b * Tq + tok) * Hq + h * G + r % G) * DH + d]) * sm_scale;
    Qs[r * LDQ + d] = v;
  }
  __syncthreads();
  for (int r = warp; r < kRows; r += kThreads / 32) {
    float s = 0.0f;
    for (int d = lane; d < DH; d += 32) s += Qs[r * LDQ + d];
    s = warp_reduce(s, SumOp());
    if (lane == 0) {
      qsum[r] = s;
      m_s[r] = kNegInf;
      l_s[r] = 0.0f;
    }
  }

  const int srow = (tid / 16) * 4, scol = tid % 16;       // score micro-tile
  const int orow = (tid / 32) * 8, ocol = (tid % 32) * CPT;  // output micro-tile
  float acc[8][CPT];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < kv_limit; k0 += kKeys) {
    __syncthreads();
    // stage the K/V codes of keys k0 .. k0 + 63 (zeros past kv_limit)
    for (int e = tid; e < kKeys * (D2 / 4); e += kThreads) {
      const int t = e / (D2 / 4), j = (e % (D2 / 4)) * 4;
      const int kpos = k0 + t;
      uint32_t wk = 0, wv = 0;
      if (kpos < kv_limit) {
        const int64_t pid = page_table[(int64_t)b * pps + kpos / page];
        const int off = kpos % page;
        const uint8_t* kp = codes + (((pid * 2 + 0) * Hkv + h) * (int64_t)page + off) * D2 + j;
        const uint8_t* vp = codes + (((pid * 2 + 1) * Hkv + h) * (int64_t)page + off) * D2 + j;
        wk = *reinterpret_cast<const uint32_t*>(kp);
        wv = *reinterpret_cast<const uint32_t*>(vp);
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        Ks[t * LDK + j + x] = (float)((wk >> (8 * x)) & 0xFu);
        Ks[t * LDK + D2 + j + x] = (float)((wk >> (8 * x + 4)) & 0xFu);
        Vs[t * DH + j + x] = (float)((wv >> (8 * x)) & 0xFu);
        Vs[t * DH + D2 + j + x] = (float)((wv >> (8 * x + 4)) & 0xFu);
      }
    }
    if (tid < kKeys) {
      const int kpos = k0 + tid;
      float4 p4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (kpos < kv_limit) {
        const int64_t pid = page_table[(int64_t)b * pps + kpos / page];
        p4 = reinterpret_cast<const float4*>(params)[(pid * Hkv + h) * (int64_t)page + kpos % page];
      }
      reinterpret_cast<float4*>(prm)[tid] = p4;
    }
    __syncthreads();

    // scores: 4 rows x 4 strided keys per thread
    {
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
      for (int d = 0; d < DH; d += 2) {
        float2 qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float2*>(Qs + (srow + i) * LDQ + d);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kv[j] = *reinterpret_cast<const float2*>(Ks + (scol + 16 * j) * LDK + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = srow + i;
        const int qpos = qpos0 + r / G;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = scol + 16 * j, kpos = k0 + c;
          const float v = __fadd_rn(__fmul_rn(s[i][j], prm[c * 4 + 0]),
                                    __fmul_rn(qsum[r], prm[c * 4 + 1]));
          Ss[r * LDS + c] = (kpos <= qpos && kpos < seq) ? v : kNegInf;
        }
      }
    }
    __syncthreads();

    // online softmax: 4 threads per row, 16 keys each
    {
      const int r = tid / 4, part = tid % 4;
      const int qpos = qpos0 + r / G;
      float* sp = Ss + r * LDS + part * 16;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, sp[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f, svm = 0.0f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int cc = part * 16 + c, kpos = k0 + cc;
        const float p = (kpos <= qpos && kpos < seq) ? expf(sp[c] - m_new) : 0.0f;
        sum += p;
        svm += p * prm[cc * 4 + 3];
        sp[c] = p * prm[cc * 4 + 2];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      svm += __shfl_xor_sync(0xffffffffu, svm, 1);
      svm += __shfl_xor_sync(0xffffffffu, svm, 2);
      __syncwarp();
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
        pvm_s[r] = svm;
      }
    }
    __syncthreads();

    // values: 8 rows x CPT dims per thread
    {
      const int nk = min(kKeys, kv_limit - k0);
      float pv[8][CPT];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) pv[i][j] = 0.0f;
      for (int c = 0; c < nk; ++c) {
        float vv[CPT];
#pragma unroll
        for (int j = 0; j < CPT; ++j) vv[j] = Vs[c * DH + ocol + j];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float p = Ss[(orow + i) * LDS + c];
#pragma unroll
          for (int j = 0; j < CPT; ++j) pv[i][j] += p * vv[j];
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float alpha = a_s[orow + i], pm = pvm_s[orow + i];
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = acc[i][j] * alpha + (pv[i][j] + pm);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = orow + i;
    const int tok = t0 + r / G;
    if (r >= nrows || tok >= Tq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    bf16* dst = out + (((int64_t)b * Tq + tok) * Hq + h * G + r % G) * DH + ocol;
#pragma unroll
    for (int j = 0; j < CPT; ++j) dst[j] = f2bf(acc[i][j] / l);
  }
}

template <int DH>
size_t prefill_smem() {
  return (size_t)(kRows * (DH + 2) + kKeys * (DH + 2) + kKeys * DH + kRows * (kKeys + 1) +
                  kKeys * 4 + 5 * kRows) *
         sizeof(float);
}

template <int DH>
int launch(const void* q, const void* codes, const void* params, const void* page_table,
           const void* q_starts, const void* seq_lens, void* out, int B, int Tq, int Hkv, int G,
           int page, int pps, float sm_scale, cudaStream_t s) {
  const int bq = kRows / G;
  const size_t smem = prefill_smem<DH>();
  cudaFuncSetAttribute(paged_prefill_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((Tq + bq - 1) / bq, Hkv, B);
  paged_prefill_kernel<DH><<<grid, kThreads, smem, s>>>(
      (const bf16*)q, (const uint8_t*)codes, (const float*)params, (const int*)page_table,
      (const int*)q_starts, (const int*)seq_lens, (bf16*)out, Tq, Hkv, G, page, pps, bq,
      sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: [B, Tq, Hq, Dh] bf16 post-RoPE, contiguous; codes/params: one layer's
// pool; page_table: [B, pps] i32; q_starts: [B] i32 (absolute position of
// q[:, 0]); seq_lens: [B] i32 (tokens in cache including this chunk's);
// out: [B, Tq, Hq, Dh] bf16. Requires G = Hq / Hkv <= 64 and Dh of 64 or
// 128.
ARC_EXPORT int arc_paged_prefill(const void* q, const void* codes, const void* params,
                                 const void* page_table, const void* q_starts,
                                 const void* seq_lens, void* out, int B, int Tq, int Hkv, int G,
                                 int Dh, int page, int pps, float sm_scale, void* stream) {
  if (G < 1 || G > kRows || page < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || Tq == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (Dh == 128)
    return launch<128>(q, codes, params, page_table, q_starts, seq_lens, out, B, Tq, Hkv, G, page,
                       pps, sm_scale, s);
  if (Dh == 64)
    return launch<64>(q, codes, params, page_table, q_starts, seq_lens, out, B, Tq, Hkv, G, page,
                      pps, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
