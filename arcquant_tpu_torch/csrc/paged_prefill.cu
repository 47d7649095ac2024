// Causal GQA attention of a prefill chunk straight over the paged int4 KV
// pool, with a per-row origin, on bf16 tensor cores (mma.sync m16n8k16,
// f32 accumulators).
//
// Replaces the TPU kernel arcquant_tpu/kernels/paged_decode.py:_prefill_kernel
// (pallas_call in _prefill_call). Plain PyTorch version:
// arcquant_tpu_torch/kernels/paged_decode.py:paged_prefill_plain.
//
// Pool layout (cache/paged.py): codes u8 [P, 2, Hkv, page, Dh/2] with
// split-half nibbles (low nibble = dim d, high = d + Dh/2), params f32
// [P, Hkv, page, 4] = (scale_k, min_k, scale_v, min_v) per token.
//
// The function: one block per (q tile, kv head, batch row). A q tile
// holds bq = 64 / G chunk tokens times the G query heads of the kv head
// (bq = 9 for Qwen2.5-7B's G = 7: 63 score rows); rows are token-major,
// r = i * G + j, as in the JAX kernel. Row r sits at the absolute
// position qpos = q_starts[b] + tile * bq + r / G. The block walks the
// keys [0, kv_limit), kv_limit = min(seq, qpos of its last token + 1), in
// steps of 64, which reads exactly the pages ceil(kv_limit / page) of its
// row of the page table; a row with seq = 0, and a tile whose first token
// already lies at or past seq, walks none and writes exact zeros. Scores
// and values are dequantized in score space, as in the JAX kernel:
//   s  = (q . codes_k) * sm_scale * scale_k + qsum * min_k, masked to
//        kpos <= qpos && kpos < seq (-1e30), qsum = sum(q * sm_scale);
//   pv = (p * scale_v) . codes_v + sum(p * min_v);
// online softmax in f32, output pv / max(l, 1e-30). Padded query rows
// past seq in a tile that starts before seq attend to keys < seq, as in
// the JAX kernel; the engine discards every padded row. The pool is only
// read.
//
// Bound on the H100: at the serving shape (chunks of 512 tokens over up
// to 1900 cached tokens, H 28/4) the tensor-core operations of QK^T and
// PV. The design carries flash_attn.cu's over the int4 pool:
// - 4 warps of 16 score rows; a warp's q rows live in registers as raw
//   bf16 A fragments for the whole kernel. Grid (q tiles, kv heads, B)
//   with the q tiles reversed, so the longest causal rows start first;
// - 64-key tiles of K codes, V codes (64 x Dh/2 bytes each) and params
//   (64 x 16 bytes) stream through a 3-stage cp.async ring, each 16-byte
//   chunk looked up through the page table (a 64-key tile spans four
//   pages of 16). Each tile is decoded once a block into bf16 K and V
//   tiles with padded rows for ldmatrix (the codes 0..15 are exact in
//   bf16); tiles wholly past kv_limit are never loaded, a warp skips
//   those above its own rows, and the mask is built only on tiles that
//   cross its diagonal or seq;
// - S = q . codes_k: exact bf16 products summed in f32; the scales go on
//   after the product in f32, as above. Row max and sum stay in
//   registers, reduced across the lane quad; expf, not __expf;
// - O += (p * scale_v) . codes_v with p * scale_v split into two bf16
//   halves (hi, lo) against ldmatrix.trans of the V tile, so the product
//   keeps p * scale_v to about 2^-16 relative; sum(p * min_v) runs
//   beside it per row in f32.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;          // 16 score rows each
constexpr int kRows = 16 * kWarps; // score rows of a block: bq tokens x G heads
constexpr int kKeys = 64;          // keys a tile
constexpr int kStages = 3;         // raw tiles in flight
constexpr int kThreads = 32 * kWarps;

// Two bf16 values 0..15 from two nibbles at bits 0..3 and 16..19 of x:
// bf16 128 + n (exact), less 128.
__device__ __forceinline__ uint32_t nib2bf(uint32_t x) {
  __nv_bfloat162 v;
  *reinterpret_cast<uint32_t*>(&v) = (x & 0x000F000Fu) | 0x43004300u;
  return bits(__hsub2(v, __floats2bfloat162_rn(128.0f, 128.0f)));
}

// Decodes 16 code bytes (dims d0 .. d0 + 15 low, + Dh/2 high) of one key
// into its padded bf16 row.
template <int DH>
__device__ __forceinline__ void decode16(uint4 raw, bf16* row, int d0) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t lo[8], hi[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t a = __byte_perm(w[i], 0, 0x4140), b = __byte_perm(w[i], 0, 0x4342);
    lo[2 * i] = nib2bf(a);
    lo[2 * i + 1] = nib2bf(b);
    hi[2 * i] = nib2bf(a >> 4);
    hi[2 * i + 1] = nib2bf(b >> 4);
  }
  uint4* l = reinterpret_cast<uint4*>(row + d0);
  uint4* h = reinterpret_cast<uint4*>(row + DH / 2 + d0);
  l[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  l[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
  h[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  h[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 2)
paged_prefill_kernel(const bf16* __restrict__ q, const uint8_t* __restrict__ codes,
                     const float* __restrict__ params, const int* __restrict__ page_table,
                     const int* __restrict__ q_starts, const int* __restrict__ seq_lens,
                     bf16* __restrict__ out, int Tq, int Hkv, int G, int page, int pps, int bq,
                     float sm_scale) {
  constexpr int D2 = DH / 2;
  constexpr int LD = DH + 8;         // padded bf16 row of a decoded K/V tile
  constexpr int KSTEPS = DH / 16;    // k-steps of q k^T
  constexpr int NT = kKeys / 8;      // 8-key score tiles
  constexpr int DT = DH / 8;         // 8-dim output tiles
  constexpr int CPK = D2 / 16;       // 16-byte code chunks a key
  constexpr int RAW = 2 * kKeys * D2 + kKeys * 16;  // bytes of a raw stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* raw = smem_raw;                          // [kStages][K | V | params]
  bf16* Kd = reinterpret_cast<bf16*>(smem_raw + kStages * RAW);  // [kKeys][LD]
  bf16* Vd = Kd + kKeys * LD;                                    // [kKeys][LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row group, lane in quad
  const int h = blockIdx.y, b = blockIdx.z;
  const int t0 = (gridDim.x - 1 - blockIdx.x) * bq;  // first chunk token of the tile
  const int Hq = Hkv * G;
  const int nrows = bq * G;
  const int seq = seq_lens[b];
  const int qpos0 = q_starts[b] + t0;  // absolute position of token t0
  // keys [0, kv_limit); a tile wholly past seq is padding: no keys, zeros
  const int kv_limit = qpos0 >= seq ? 0 : min(seq, qpos0 + bq);
  const int ntiles = (kv_limit + kKeys - 1) / kKeys;

  // this thread's rows r0 (fragment elements 0, 1) and r1 = r0 + 8 (2, 3)
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const int qp0 = qpos0 + r0 / G, qp1 = qpos0 + r1 / G;
  const bool live_warp = warp * 16 < nrows;
  const int warp_lo = qpos0 + (warp * 16) / G;                   // least qpos of the warp
  const int warp_hi = qpos0 + min(warp * 16 + 15, nrows - 1) / G;  // greatest
  uint32_t qf[KSTEPS][4];
  float qs0 = 0.0f, qs1 = 0.0f;  // sum(q * sm_scale) over this thread's dims
  {
    const int tok0 = t0 + r0 / G, tok1 = t0 + r1 / G;
    const bool ok0 = r0 < nrows && tok0 < Tq, ok1 = r1 < nrows && tok1 < Tq;
    const bf16* q0 = q + (((int64_t)b * Tq + tok0) * Hq + h * G + r0 % G) * DH + 2 * t4;
    const bf16* q1 = q + (((int64_t)b * Tq + tok1) * Hq + h * G + r1 % G) * DH + 2 * t4;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int c = ks * 16;
      qf[ks][0] = ok0 ? *reinterpret_cast<const uint32_t*>(q0 + c) : 0u;
      qf[ks][1] = ok1 ? *reinterpret_cast<const uint32_t*>(q1 + c) : 0u;
      qf[ks][2] = ok0 ? *reinterpret_cast<const uint32_t*>(q0 + c + 8) : 0u;
      qf[ks][3] = ok1 ? *reinterpret_cast<const uint32_t*>(q1 + c + 8) : 0u;
#pragma unroll
      for (int x = 0; x < 4; x += 2) {
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qf[ks][x]));
        const float2 c1 =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qf[ks][x + 1]));
        qs0 += a.x * sm_scale + a.y * sm_scale;
        qs1 += c1.x * sm_scale + c1.y * sm_scale;
      }
    }
    qs0 += __shfl_xor_sync(0xffffffffu, qs0, 1);
    qs0 += __shfl_xor_sync(0xffffffffu, qs0, 2);
    qs1 += __shfl_xor_sync(0xffffffffu, qs1, 1);
    qs1 += __shfl_xor_sync(0xffffffffu, qs1, 2);
  }

  float oacc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[d][e] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf;  // running row max of r0, r1
  float l0 = 0.0f, l1 = 0.0f;        // running row sum over this thread's keys
  float v0 = 0.0f, v1 = 0.0f;        // running sum(p * min_v) over this thread's keys

  const int* pt = page_table + (int64_t)b * pps;
  // key kpos's page and offset; keys past kv_limit read nothing (zeros)
  auto locate = [&](int kpos, int64_t& pid, int& off) {
    pid = kpos < kv_limit ? pt[kpos / page] : 0;
    off = kpos < kv_limit ? kpos % page : 0;
  };
  auto load_tile = [&](int tile) {
    unsigned char* st = raw + (tile % kStages) * RAW;
    const int kv0 = tile * kKeys;
    for (int c = tid; c < 2 * kKeys * CPK; c += kThreads) {  // K, then V code chunks
      const int kv = c / (kKeys * CPK), key = (c / CPK) % kKeys, ch = c % CPK;
      int64_t pid;
      int off;
      locate(kv0 + key, pid, off);
      cp16(st + kv * kKeys * D2 + key * D2 + ch * 16,
           codes + (((pid * 2 + kv) * Hkv + h) * (int64_t)page + off) * D2 + ch * 16,
           kv0 + key < kv_limit);
    }
    if (tid < kKeys) {
      int64_t pid;
      int off;
      locate(kv0 + tid, pid, off);
      cp16(st + 2 * kKeys * D2 + tid * 16, params + ((pid * Hkv + h) * (int64_t)page + off) * 4,
           kv0 + tid < kv_limit);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) load_tile(s);
    cp_commit();
  }
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix and row this lane addresses
  for (int j = 0; j < ntiles; ++j) {
    cp_wait<kStages - 2>();  // tile j has landed (this thread's copies)
    __syncthreads();            // ... everyone's; and every warp is done with tile j - 1
    if (j + kStages - 1 < ntiles) load_tile(j + kStages - 1);
    cp_commit();
    const unsigned char* st = raw + (j % kStages) * RAW;
    for (int c = tid; c < 2 * kKeys * CPK; c += kThreads) {
      const int kv = c / (kKeys * CPK), key = (c / CPK) % kKeys, ch = c % CPK;
      const uint4 w = *reinterpret_cast<const uint4*>(st + kv * kKeys * D2 + key * D2 + ch * 16);
      decode16<DH>(w, (kv ? Vd : Kd) + key * LD, ch * 16);
    }
    __syncthreads();
    const int kv0 = j * kKeys;
    if (!live_warp || kv0 > warp_hi) continue;  // the tile lies above all of this warp's rows
    const float* prm = reinterpret_cast<const float*>(st + 2 * kKeys * D2);

    // S = q . codes_k: ldmatrix x4 gives the B fragments of two 8-key tiles
    float sacc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bfr[4];
        ldsm_x4(bfr, Kd + (np * 16 + (mi >> 1) * 8 + mr) * LD + ks * 16 + (mi & 1) * 8);
        mma_bf16(sacc[2 * np], qf[ks], bfr[0], bfr[1]);
        mma_bf16(sacc[2 * np + 1], qf[ks], bfr[2], bfr[3]);
      }
    }

    const bool need_mask = kv0 + kKeys - 1 > warp_lo || kv0 + kKeys > seq;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n * 8 + 2 * t4 + (e & 1);
        const float2 km = *reinterpret_cast<const float2*>(prm + key * 4);  // scale_k, min_k
        float s = __fadd_rn(__fmul_rn(__fmul_rn(sacc[n][e], sm_scale), km.x),
                            __fmul_rn(e < 2 ? qs0 : qs1, km.y));
        if (need_mask) {
          const int kid = kv0 + key;
          if (!(kid <= (e < 2 ? qp0 : qp1) && kid < seq)) s = kNegInf;
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
    v0 *= a0;
    v1 *= a1;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      oacc[d][0] *= a0;
      oacc[d][1] *= a0;
      oacc[d][2] *= a1;
      oacc[d][3] *= a1;
    }

    // O += (P * scale_v) . codes_v over four 16-key steps; the A fragment
    // of step kk is score tiles 2kk (keys +0..7) and 2kk + 1 (keys +8..15)
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      float p[2][4], ps[2][4];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int n = 2 * kk + x;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = n * 8 + 2 * t4 + (e & 1);
          const float2 vm = *reinterpret_cast<const float2*>(prm + key * 4 + 2);  // scale_v, min_v
          p[x][e] = expf(sacc[n][e] - (e < 2 ? mn0 : mn1));
          ps[x][e] = p[x][e] * vm.x;
          if (e < 2) v0 += p[x][e] * vm.y;
          else v1 += p[x][e] * vm.y;
        }
      }
      l0 += (p[0][0] + p[0][1]) + (p[1][0] + p[1][1]);
      l1 += (p[0][2] + p[0][3]) + (p[1][2] + p[1][3]);
      uint32_t ph[4], pl[4];
      split_bf16(ps[0][0], ps[0][1], ph[0], pl[0]);
      split_bf16(ps[0][2], ps[0][3], ph[1], pl[1]);
      split_bf16(ps[1][0], ps[1][1], ph[2], pl[2]);
      split_bf16(ps[1][2], ps[1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t bfr[4];
        ldsm_x4_trans(bfr, Vd + (kk * 16 + (mi & 1) * 8 + mr) * LD + dp * 16 + (mi >> 1) * 8);
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
  v0 += __shfl_xor_sync(0xffffffffu, v0, 1);
  v0 += __shfl_xor_sync(0xffffffffu, v0, 2);
  v1 += __shfl_xor_sync(0xffffffffu, v1, 1);
  v1 += __shfl_xor_sync(0xffffffffu, v1, 2);
  const float L0 = fmaxf(l0, 1e-30f), L1 = fmaxf(l1, 1e-30f);
  const int tok0 = t0 + r0 / G, tok1 = t0 + r1 / G;
  bf16* o0 = out + (((int64_t)b * Tq + tok0) * Hq + h * G + r0 % G) * DH + 2 * t4;
  bf16* o1 = out + (((int64_t)b * Tq + tok1) * Hq + h * G + r1 % G) * DH + 2 * t4;
  const bool ok0 = r0 < nrows && tok0 < Tq, ok1 = r1 < nrows && tok1 < Tq;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    if (ok0)
      *reinterpret_cast<__nv_bfloat162*>(o0 + d * 8) =
          __floats2bfloat162_rn((oacc[d][0] + v0) / L0, (oacc[d][1] + v0) / L0);
    if (ok1)
      *reinterpret_cast<__nv_bfloat162*>(o1 + d * 8) =
          __floats2bfloat162_rn((oacc[d][2] + v1) / L1, (oacc[d][3] + v1) / L1);
  }
}

template <int DH>
int launch(const void* q, const void* codes, const void* params, const void* page_table,
           const void* q_starts, const void* seq_lens, void* out, int B, int Tq, int Hkv, int G,
           int page, int pps, float sm_scale, cudaStream_t s) {
  const int bq = kRows / G;
  const size_t smem = (size_t)kStages * (2 * kKeys * (DH / 2) + kKeys * 16) +
                      (size_t)2 * kKeys * (DH + 8) * sizeof(bf16);
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
// pool, 16-byte aligned; page_table: [B, pps] i32; q_starts: [B] i32
// (absolute position of q[:, 0]); seq_lens: [B] i32 (tokens in cache
// including this chunk's); out: [B, Tq, Hq, Dh] bf16. Requires G = Hq /
// Hkv <= 64 and Dh of 64 or 128.
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
