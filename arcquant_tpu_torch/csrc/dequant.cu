// The large-M GEMM route's passes: the one-pass weight decode in both
// formats, and the w4 route's activation operand.
//
// Replace the TPU kernels of arcquant_tpu/kernels/gemm.py:
//   _dequant_w8_kernel (pallas_call in _dequant_call) -> arc_dequant_w8
//   _dequant_w4_kernel (pallas_call in _dequant_call) -> arc_dequant_w4
//   _copy_kernel       (pallas_call in _pin_rowmajor) -> arc_pin_rowmajor
// Plain PyTorch versions: arcquant_tpu_torch/kernels/gemm.py
// dequant_w8_plain, dequant_w4_plain, pin_rowmajor_plain.
//
// dequant_w8: int8 codes [Kq, N] + ue4m3 bytes [Kq/16, N] -> bf16 [Kq, N]
// = code * ue4m3 / 2. dequant_w4: e2m1x nibble pairs [Kq/2, N] -> bf16
// [2, Kq/2, N], plane 0 the even ks (low nibbles) and plane 1 the odd ks
// (JAX's split-half layout). With gw set, the f32 value is multiplied by
// gw[n] before the bf16 round (JAX's fold_global). Every product is a
// single correctly rounded f32 multiply, so the outputs equal the plain
// versions' bit for bit. A stack of experts' packs (the MoE dispatch
// path: codes [E, rows, N], gw [E, N]) decodes in one launch, blockIdx.y
// the expert, each expert's output in the layout above.
//
// pin_rowmajor: on the TPU an identity copy that pins the activations
// row-major for XLA's matmul; a torch tensor already is row-major, so on
// the w4 route this pass does the one layout change the route needs:
// bf16 [M, K] -> [M, K] with the even-k columns first, then the odd-k
// ones (split_even_odd), the operand that pairs with the split-half
// decoded weight. The w8 route needs no pass.
//
// Bound on the H100: bytes. Each thread of the decodes takes 16 columns
// of one code row (one 16-byte load of codes, one of scale bytes; a
// scale row is reread by the 8 or 16 code rows it covers, from L1/L2)
// and writes 32 bytes a plane, neighbouring threads on neighbouring
// columns. At gateup (Kq 4096, N 37888) the w8 decode moves 165 MB in
// and 310 MB out (0.142 ms at 3.35 TB/s), the w4 decode 87 MB in and the
// same out (0.119 ms). Each pin thread loads 8 bf16 (4 even/odd pairs)
// in 16 bytes and stores 8 bytes to each half: 67 MB at M 4096, K 4096
// (0.020 ms).
#include "common.cuh"

namespace {

template <bool kW4>
__global__ void dequant_kernel(const uint8_t* __restrict__ codes,
                               const uint8_t* __restrict__ scales,
                               const float* __restrict__ gw, bf16* __restrict__ out, int rows,
                               int N) {
  const int chunks = (N + 15) / 16;
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= (int64_t)rows * chunks) return;
  const int64_t e = blockIdx.y;  // the expert of a stack
  codes += e * rows * N;
  scales += e * (rows / (kW4 ? 8 : 16)) * N;
  out += e * (kW4 ? 2 : 1) * (int64_t)rows * N;
  if (gw != nullptr) gw += e * N;
  const int r = (int)(c / chunks), n0 = (int)(c % chunks) * 16;
  const int cnt = min(16, N - n0);
  const bool full = cnt == 16 && (N % 16) == 0;
  const uint8_t* cp = codes + (int64_t)r * N + n0;
  const uint8_t* sp = scales + (int64_t)(r / (kW4 ? 8 : 16)) * N + n0;
  __align__(16) uint8_t cb[16], sb[16];
  if (full) {
    *reinterpret_cast<uint4*>(cb) = *reinterpret_cast<const uint4*>(cp);
    *reinterpret_cast<uint4*>(sb) = *reinterpret_cast<const uint4*>(sp);
  } else {
    for (int j = 0; j < 16; ++j) {
      cb[j] = j < cnt ? cp[j] : 0;
      sb[j] = j < cnt ? sp[j] : 0;
    }
  }
  __align__(16) bf16 v0[16], v1[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float sc = ue4m3_decode(sb[j]);
    const float g = (gw != nullptr && j < cnt) ? gw[n0 + j] : 1.0f;
    if constexpr (kW4) {
      float a = e2m1x_decode(cb[j] & 15u) * sc, b = e2m1x_decode(cb[j] >> 4) * sc;
      if (gw != nullptr) {
        a = __fmul_rn(a, g);
        b = __fmul_rn(b, g);
      }
      v0[j] = f2bf(a);
      v1[j] = f2bf(b);
    } else {
      float a = (float)(int8_t)cb[j] * (sc * 0.5f);
      if (gw != nullptr) a = __fmul_rn(a, g);
      v0[j] = f2bf(a);
    }
  }
  bf16* o0 = out + (int64_t)r * N + n0;
  bf16* o1 = o0 + (int64_t)rows * N;  // w4: the odd-k plane
  if (full) {
    reinterpret_cast<uint4*>(o0)[0] = reinterpret_cast<const uint4*>(v0)[0];
    reinterpret_cast<uint4*>(o0)[1] = reinterpret_cast<const uint4*>(v0)[1];
    if constexpr (kW4) {
      reinterpret_cast<uint4*>(o1)[0] = reinterpret_cast<const uint4*>(v1)[0];
      reinterpret_cast<uint4*>(o1)[1] = reinterpret_cast<const uint4*>(v1)[1];
    }
  } else {
    for (int j = 0; j < cnt; ++j) {
      o0[j] = v0[j];
      if constexpr (kW4) o1[j] = v1[j];
    }
  }
}

// One thread per 8 bf16 of a row: evens to the first half, odds to the
// second. K % 8 == 0.
__global__ void pin_rowmajor_kernel(const bf16* __restrict__ x, bf16* __restrict__ out, int M,
                                    int K) {
  const int per_row = K / 8;
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= (int64_t)M * per_row) return;
  const int64_t r = c / per_row;
  const int j = (int)(c % per_row);
  const uint4 v = *reinterpret_cast<const uint4*>(x + r * K + j * 8);
  // element 2i is the low half of word i, element 2i + 1 the high half
  const uint2 even = make_uint2((v.x & 0xFFFFu) | (v.y << 16), (v.z & 0xFFFFu) | (v.w << 16));
  const uint2 odd = make_uint2((v.x >> 16) | (v.y & 0xFFFF0000u),
                               (v.z >> 16) | (v.w & 0xFFFF0000u));
  *reinterpret_cast<uint2*>(out + r * K + j * 4) = even;
  *reinterpret_cast<uint2*>(out + r * K + K / 2 + j * 4) = odd;
}

template <bool kW4>
int launch_dequant(const void* codes, const void* scales, const void* gw, void* out,
                   int experts, int rows, int N, cudaStream_t st) {
  const int64_t threads = (int64_t)rows * ((N + 15) / 16);
  if (threads > 0 && experts > 0)
    dequant_kernel<kW4><<<dim3((unsigned)((threads + 255) / 256), experts), 256, 0, st>>>(
        (const uint8_t*)codes, (const uint8_t*)scales, (const float*)gw, (bf16*)out, rows, N);
  return (int)cudaGetLastError();
}

}  // namespace

// codes: [E, Kq, N] int8; scales: [E, Kq/16, N] uint8; gw: [E, N] f32 or
// NULL; out: [E, Kq, N] bf16. rows = Kq; E = experts (1 for one pack).
ARC_EXPORT int arc_dequant_w8(const void* codes, const void* scales, const void* gw, void* out,
                              int experts, int rows, int N, void* stream) {
  return launch_dequant<false>(codes, scales, gw, out, experts, rows, N, (cudaStream_t)stream);
}

// codes: [E, Kq/2, N] uint8; scales: [E, Kq/16, N] uint8; gw: [E, N] f32
// or NULL; out: [E, 2, Kq/2, N] bf16. rows = Kq/2.
ARC_EXPORT int arc_dequant_w4(const void* codes, const void* scales, const void* gw, void* out,
                              int experts, int rows, int N, void* stream) {
  return launch_dequant<true>(codes, scales, gw, out, experts, rows, N, (cudaStream_t)stream);
}

// x, out: [M, K] bf16, K % 8 == 0.
ARC_EXPORT int arc_pin_rowmajor(const void* x, void* out, int M, int K, void* stream) {
  const int64_t threads = (int64_t)M * (K / 8);
  if (threads > 0)
    pin_rowmajor_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
        (const bf16*)x, (bf16*)out, M, K);
  return (int)cudaGetLastError();
}
