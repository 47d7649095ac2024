// One decode token of GQA attention over the paged int4 KV pool,
// flash-decoding: the page loop is split across blocks, then merged.
//
// Replaces the TPU kernel arcquant_tpu/kernels/paged_decode.py:_decode_kernel
// (pallas_call in _decode_call). Plain PyTorch version:
// arcquant_tpu_torch/kernels/paged_decode.py:paged_decode_state_plain.
//
// Pool layout (cache/paged.py): codes u8 [P, 2, Hkv, page, Dh/2] with
// split-half nibbles (low nibble = dim d, high = d + Dh/2), params f32
// [P, Hkv, page, 4] = (scale_k, min_k, scale_v, min_v) per token. The
// same score-space dequantization as the JAX kernel:
//   s  = (q . codes_k) * scale_k + (sum q) * min_k   (sm_scale folded into q, f32)
//   pv = (p * scale_v) . codes_v + sum(p * min_v)
//
// Bound on the H100: device-memory bytes of the pool (4.5 bits per K/V
// element plus 16 bytes per token), and at decode batch sizes the
// latency of walking the pages: a block's scores and values loops are
// latency-bound chains at 8 warps an SM, so a page costs far more than
// its bytes, and splitting the walk is what fills the card. The design:
// - split kernel, grid (Hkv, B, S): split s of row b takes pages
//   [s * pages_per_split, (s + 1) * pages_per_split) of the page table,
//   and a block covers the g query heads of one kv head. S comes from
//   host-known shapes only (kernels/paged_decode.py:decode_split_plan,
//   about two waves of 132 SMs); a block whose pages lie at or past its
//   row's seq_len writes the empty state (m -1e30, l 0, acc 0) and
//   returns. 256 threads; a cp.async double buffer brings the next
//   page's K codes, V codes and params while the current one computes;
// - scores: the warps split the page's tokens, Dh/32 lanes a token, each
//   with one 16-byte load of K codes, two tokens for each q value read
//   from shared memory; online softmax, one warp per head;
// - values: the warps split the tokens too; a lane holds up to four dims
//   of all g heads and the warps reduce once, at the end of the split;
// - merge kernel, grid B * Hq: m = max m_s, w_s = l_s * exp(m_s - m)
//   (exactly 0 for an empty split), l = sum w_s, out = sum exp(m_s - m)
//   acc_s / max(l, 1e-30), the rule of arcquant_tpu/parallel/ring.py. At
//   S = 1 the split kernel writes the final outputs and no merge runs.
// A row with seq_len 0 gives out 0, m -1e30 and l 0.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;
constexpr int kQPitch = 36;  // floats a 16-byte K chunk's 32 q values take (padded)

struct SplitArgs {
  const bf16* q;
  const uint8_t* codes;
  const float* params;
  const int* page_table;
  const int* seq_lens;
  bf16* out;  // S == 1: the final outputs
  float* m_out;
  float* l_out;
  float* acc_part;  // S > 1: [B, Hq, S, Dh], [B, Hq, S], [B, Hq, S]
  float* m_part;
  float* l_part;
  int Hkv, G, Dh, page, pps, pages_per_split;
  float sm_scale;
};

// The 4-bit code at bit `shift` of w as an exact f32: the code goes into
// the mantissa of 2^23, which is then subtracted (two full-rate ops where
// an int-to-float conversion runs at a quarter of the rate).
__device__ __forceinline__ float nibble(uint32_t w, int shift) {
  return __uint_as_float(((w >> shift) & 0xFu) | 0x4B000000u) - 8388608.0f;
}

// Writes element d of query head `row`'s state in split s: the final
// output acc / max(l, 1e-30) at S = 1, else the unnormalized acc.
__device__ __forceinline__ void write_state(const SplitArgs& a, int64_t row, int s, int S, int d,
                                            float acc, float l) {
  if (S == 1)
    a.out[row * a.Dh + d] = f2bf(acc / fmaxf(l, 1e-30f));
  else
    a.acc_part[(row * S + s) * a.Dh + d] = acc;
}

__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(SplitArgs a) {
  const int Dh = a.Dh, D2 = Dh / 2, page = a.page, G = a.G;
  const int cpt = D2 / 16;  // lanes a token in the scores (16-byte chunks of its K codes)
  const int S = gridDim.z;
  const int h = blockIdx.x, b = blockIdx.y, s = blockIdx.z;
  const int Hq = a.Hkv * G;
  const int64_t row0 = (int64_t)b * Hq + h * G;  // first query head of this block
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int seq = a.seq_lens[b];
  const int npages = min((seq + page - 1) / page, a.pps);
  const int p_begin = s * a.pages_per_split;
  const int p_end = min(p_begin + a.pages_per_split, npages);
  if (p_begin >= p_end) {  // no token of this row in this split: the empty state
    for (int e = tid; e < G * Dh; e += kThreads)
      write_state(a, row0 + e / Dh, s, S, e % Dh, 0.0f, 0.0f);
    if (tid < G) {
      float* m = S == 1 ? a.m_out + row0 : a.m_part + row0 * S + s;
      float* l = S == 1 ? a.l_out + row0 : a.l_part + row0 * S + s;
      m[(int64_t)tid * S] = kNegInf;
      l[(int64_t)tid * S] = 0.0f;
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int buf_bytes = 2 * page * D2 + page * 16;  // K codes, V codes, params
  float* qk = reinterpret_cast<float*>(smem_raw + 2 * buf_bytes);  // [kMaxG][cpt][kQPitch]
  float* ps = qk + kMaxG * cpt * kQPitch;   // [kMaxG][page]
  float* red = ps + kMaxG * page;           // [kWarps][kMaxG][Dh]
  float* qsum = red + kWarps * kMaxG * Dh;  // [kMaxG] each:
  float* m_s = qsum + kMaxG;
  float* l_s = m_s + kMaxG;
  float* a_s = l_s + kMaxG;
  float* vm_s = a_s + kMaxG;

  auto stage = [&](int pi) {
    const int64_t pid = a.page_table[(int64_t)b * a.pps + pi];
    uint8_t* dst = smem_raw + ((pi - p_begin) & 1) * buf_bytes;
    const int64_t plane = (int64_t)page * D2;
    const uint8_t* ksrc = a.codes + ((pid * 2 + 0) * a.Hkv + h) * plane;
    const uint8_t* vsrc = a.codes + ((pid * 2 + 1) * a.Hkv + h) * plane;
    const uint8_t* psrc =
        reinterpret_cast<const uint8_t*>(a.params + (pid * a.Hkv + h) * (int64_t)page * 4);
    for (int c = tid; c < page * D2 / 16; c += kThreads) {
      cp16(dst + 16 * c, ksrc + 16 * c, true);
      cp16(dst + page * D2 + 16 * c, vsrc + 16 * c, true);
    }
    for (int c = tid; c < page; c += kThreads)
      cp16(dst + 2 * page * D2 + 16 * c, psrc + 16 * c, true);
  };
  stage(p_begin);
  cp_commit();

  // q * sm_scale in f32: chunk c of a token's K codes (bytes 16c..16c+15)
  // holds dims 16c + i (low nibbles) and D2 + 16c + i (high), i < 16;
  // its 32 q values sit at qk[(g * cpt + c) * kQPitch + {i, 16 + i}]
  for (int e = tid; e < G * Dh; e += kThreads) {
    const int g = e / Dh, d = e % Dh;
    const int hi = d >= D2, j = hi ? d - D2 : d;
    qk[(g * cpt + j / 16) * kQPitch + hi * 16 + j % 16] =
        bf2f(a.q[row0 * Dh + e]) * a.sm_scale;
  }
  __syncthreads();
  for (int g = warp; g < G; g += kWarps) {
    float sacc = 0.0f;
    for (int d = lane; d < Dh; d += 32) {
      const int hi = d >= D2, j = hi ? d - D2 : d;
      sacc += qk[(g * cpt + j / 16) * kQPitch + hi * 16 + j % 16];
    }
    sacc = warp_reduce(sacc, SumOp());
    if (lane == 0) {
      qsum[g] = sacc;
      m_s[g] = kNegInf;
      l_s[g] = 0.0f;
      vm_s[g] = 0.0f;
    }
  }

  // values: this lane's dims j and j + D2 for j = lane, lane + 32 (< D2)
  float acc[2][2][kMaxG];
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int y = 0; y < 2; ++y)
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) acc[x][y][g] = 0.0f;

  for (int pi = p_begin; pi < p_end; ++pi) {
    cp_wait<0>();     // page pi has landed (this thread's copies)
    __syncthreads();  // ... everyone's; page pi - 1's buffer and ps are free
    if (pi + 1 < p_end) stage(pi + 1);
    cp_commit();
    const uint8_t* kc = smem_raw + ((pi - p_begin) & 1) * buf_bytes;
    const uint8_t* vc = kc + page * D2;
    const float* prm = reinterpret_cast<const float*>(kc + 2 * page * D2);
    const int ntok = min(page, seq - pi * page);

    // scores: cpt lanes a token, one 16-byte K chunk each, two tokens a
    // lane (t and t + tpp) for each q value read
    const int c = tid % cpt, tpp = kThreads / cpt;
    for (int base = 0; base < page; base += 2 * tpp) {
      const int t0 = base + tid / cpt;
      // the two tokens' 32 codes each, decoded once for all g heads:
      // kv[u][i] = dim 16c + i (low nibble), kv[u][16 + i] = D2 + 16c + i
      float kv[2][32];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int t = t0 + u * tpp;
        uint4 w = make_uint4(0u, 0u, 0u, 0u);  // past ntok: zeros, masked below
        if (t < ntok) w = *reinterpret_cast<const uint4*>(kc + t * D2 + 16 * c);
        const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) {
            kv[u][4 * x + y] = nibble(ws[x], 8 * y);
            kv[u][16 + 4 * x + y] = nibble(ws[x], 8 * y + 4);
          }
      }
      float dot[2][kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        dot[0][g] = dot[1][g] = 0.0f;
        if (g < G) {
          const float* qg = qk + (g * cpt + c) * kQPitch;
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            const float4 qv = *reinterpret_cast<const float4*>(qg + 4 * x);
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              float d = dot[u][g];
              d += qv.x * kv[u][4 * x] + qv.y * kv[u][4 * x + 1];
              d += qv.z * kv[u][4 * x + 2] + qv.w * kv[u][4 * x + 3];
              dot[u][g] = d;
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          for (int o = 1; o < cpt; o <<= 1) dot[u][g] += __shfl_xor_sync(0xffffffffu, dot[u][g], o);
        const int t = t0 + u * tpp;
        if (c == 0 && t < page) {
          const float sk = t < ntok ? prm[t * 4 + 0] : 0.0f;
          const float mk = t < ntok ? prm[t * 4 + 1] : 0.0f;
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < G)
              ps[g * page + t] = t < ntok ? __fadd_rn(__fmul_rn(dot[u][g], sk),
                                                      __fmul_rn(qsum[g], mk))
                                          : kNegInf;
        }
      }
    }
    __syncthreads();

    // online softmax: one warp per head; ps becomes p * scale_v
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int t = lane; t < ntok; t += 32) mx = fmaxf(mx, ps[g * page + t]);
      mx = warp_reduce(mx, MaxOp());
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f, svm = 0.0f;
      for (int t = lane; t < ntok; t += 32) {
        const float p = expf(ps[g * page + t] - m_new);
        sum += p;
        svm += p * prm[t * 4 + 3];
        ps[g * page + t] = p * prm[t * 4 + 2];
      }
      sum = warp_reduce(sum, SumOp());
      svm = warp_reduce(svm, SumOp());
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        vm_s[g] = alpha * vm_s[g] + svm;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // values: warp w takes tokens w, w + 8, ...
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        const float al = a_s[g];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          acc[x][0][g] *= al;
          acc[x][1][g] *= al;
        }
      }
    }
    for (int t = warp; t < ntok; t += kWarps) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int j = lane + 32 * x;
        if (j < D2) {
          const uint32_t cv = vc[t * D2 + j];
          const float lo = nibble(cv, 0), hi = nibble(cv, 4);
#pragma unroll
          for (int g = 0; g < kMaxG; ++g) {
            if (g < G) {
              const float p = ps[g * page + t];
              acc[x][0][g] += p * lo;
              acc[x][1][g] += p * hi;
            }
          }
        }
      }
    }
  }

  // the warps' partial sums, reduced once
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int j = lane + 32 * x;
    if (j < D2) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          red[(warp * kMaxG + g) * Dh + j] = acc[x][0][g];
          red[(warp * kMaxG + g) * Dh + D2 + j] = acc[x][1][g];
        }
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < G * Dh; e += kThreads) {
    const int g = e / Dh, d = e % Dh;
    float v = vm_s[g];
    for (int w = 0; w < kWarps; ++w) v += red[(w * kMaxG + g) * Dh + d];
    write_state(a, row0 + g, s, S, d, v, l_s[g]);
  }
  if (tid < G) {
    if (S == 1) {
      a.m_out[row0 + tid] = m_s[tid];
      a.l_out[row0 + tid] = l_s[tid];
    } else {
      a.m_part[(row0 + tid) * S + s] = m_s[tid];
      a.l_part[(row0 + tid) * S + s] = l_s[tid];
    }
  }
}

// One block per (b, query head): merges the S split states.
__global__ void __launch_bounds__(128)
paged_decode_merge_kernel(const float* __restrict__ acc_part, const float* __restrict__ m_part,
                          const float* __restrict__ l_part, bf16* __restrict__ out,
                          float* __restrict__ m_out, float* __restrict__ l_out, int S, int Dh) {
  const int64_t row = blockIdx.x;
  const float* mp = m_part + row * S;
  const float* lp = l_part + row * S;
  float m = kNegInf;
  for (int s = 0; s < S; ++s) m = fmaxf(m, mp[s]);
  float l = 0.0f;
  for (int s = 0; s < S; ++s) l += lp[s] * expf(mp[s] - m);
  const float den = fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < Dh; d += blockDim.x) {
    float v = 0.0f;
    for (int s = 0; s < S; ++s) v += expf(mp[s] - m) * acc_part[(row * S + s) * Dh + d];
    out[row * Dh + d] = f2bf(v / den);
  }
  if (threadIdx.x == 0) {
    m_out[row] = m;
    l_out[row] = l;
  }
}

}  // namespace

// q: [B, Hq, Dh] bf16; codes/params: one layer's pool (16-byte aligned);
// page_table: [B, pps] i32; seq_lens: [B] i32 (tokens in cache including
// the current one); out: [B, Hq, Dh] bf16; m_out/l_out: [B, Hq] f32.
// splits * pages_per_split >= pps; at splits > 1 acc_part [B, Hq, splits,
// Dh] and m_part/l_part [B, Hq, splits] f32 are the caller's scratch.
// Requires G = Hq / Hkv <= 8, Dh in {32, 64, 128}, page * Dh / 2 a
// multiple of 16.
ARC_EXPORT int arc_paged_decode(const void* q, const void* codes, const void* params,
                                const void* page_table, const void* seq_lens, void* out,
                                void* m_out, void* l_out, void* acc_part, void* m_part,
                                void* l_part, int B, int Hkv, int G, int Dh, int page, int pps,
                                int splits, int pages_per_split, float sm_scale, void* stream) {
  if (G < 1 || G > kMaxG || (Dh != 32 && Dh != 64 && Dh != 128) || (page * Dh / 2) % 16 ||
      splits < 1 || pages_per_split < 1 || (int64_t)splits * pages_per_split < pps ||
      (splits > 1 && (!acc_part || !m_part || !l_part)))
    return (int)cudaErrorInvalidValue;
  const int cpt = Dh / 32;
  const size_t smem = (size_t)2 * (2 * page * (Dh / 2) + page * 16) +
                      (size_t)(kMaxG * cpt * kQPitch + kMaxG * page + kWarps * kMaxG * Dh +
                               5 * kMaxG) * sizeof(float);
  cudaFuncSetAttribute(paged_decode_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  if (B > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    SplitArgs a{(const bf16*)q, (const uint8_t*)codes, (const float*)params,
                (const int*)page_table, (const int*)seq_lens, (bf16*)out, (float*)m_out,
                (float*)l_out, (float*)acc_part, (float*)m_part, (float*)l_part,
                Hkv, G, Dh, page, pps, pages_per_split, sm_scale};
    paged_decode_split_kernel<<<dim3(Hkv, B, splits), kThreads, smem, s>>>(a);
    if (splits > 1)
      paged_decode_merge_kernel<<<B * Hkv * G, 128, 0, s>>>(
          (const float*)acc_part, (const float*)m_part, (const float*)l_part, (bf16*)out,
          (float*)m_out, (float*)l_out, splits, Dh);
  }
  return (int)cudaGetLastError();
}
