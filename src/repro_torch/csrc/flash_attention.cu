// Banded-causal flash attention (CUDA, sm_90a; kernels/flash_attention.py).
//
//   q (BH, Sq, hd), k/v (BH, Sk, hd) float32 -> out (BH, Sq, hd) float32
//
// Key k_pos is live for query q_pos iff k_pos <= q_pos, q_pos - k_pos <
// window (window < 0: full causal) and k_pos < sk_real.  Masked scores are
// -1e30 and add exactly 0; out = acc / max(l, 1e-30), so a row with no live
// key gives 0.  hd is a template parameter: 16, 32, 64, 128 or 256.
//
// One block of 8 warps owns kBQ = 32 query rows of one (batch, head) row
// bh; warp w owns rows 4w..4w+3.  The block stages its Q tile once, then
// walks the key tiles of kBK = 32 keys that hold a live key for any of its
// rows: tiles wholly above the diagonal, wholly outside the window or at or
// past sk_real are never read (the Pallas kernel streams them all and
// masks).  Per tile:
//   * K and V are staged in shared memory (K rows padded by 4 floats, so
//     the float4 reads of 8 lanes' rows fall in distinct banks);
//   * scores: lane c owns key k0 + c and computes its dot with the warp's
//     4 rows (Q read as float4 broadcasts), fp32 FMAs on the CUDA cores;
//   * online softmax per row: max and sum by a warp butterfly (every lane
//     ends with the same value), expf (not __expf), no fast math;
//   * P V: each lane owns output columns lane + 32j; p is passed from the
//     lane that owns the key by shuffle, V read from shared memory.
// Grid: one block per (q tile, bh), the q tiles of most keys first, so the
// long causal rows start early.  Nothing is padded in device memory: rows
// past Sq or Sk are zero-filled in shared memory and never stored.
//
// Shared memory: 4 (32·hd + 32·(hd+4) + 32·hd) bytes, 98,816 at hd 256,
// above the 48 KB default: the launch opts in with cudaFuncSetAttribute.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;             // query rows per warp
constexpr int kBQ = kWarps * kRows;  // query rows per block
constexpr int kBK = 32;              // keys per tile: one per lane
constexpr float kMasked = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * HD + kBK * (HD + 4) + kBK * HD);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int BH,
             int Sq, int Sk, int sk_real, int window, float scale) {
  static_assert(HD % 16 == 0 && HD <= 256, "hd must be a multiple of 16");
  constexpr int kV4 = HD / 4;             // float4 per row
  constexpr int kSK = HD + 4;             // padded K row
  constexpr int kCols = (HD + 31) / 32;   // output columns per lane
  extern __shared__ float4 smem4[];
  float* s_q = reinterpret_cast<float*>(smem4);
  float* s_k = s_q + kBQ * HD;
  float* s_v = s_k + kBK * kSK;

  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % BH;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / BH);
  const int q0 = qt * kBQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = warp * kRows;

  const float* qb = q + static_cast<size_t>(bh) * Sq * HD;
  const float* kb = k + static_cast<size_t>(bh) * Sk * HD;
  const float* vb = v + static_cast<size_t>(bh) * Sk * HD;

  for (int i = threadIdx.x; i < kBQ * kV4; i += kThreads) {
    const int r = i / kV4, c = i - r * kV4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Sq)
      x = reinterpret_cast<const float4*>(qb + static_cast<size_t>(q0 + r) * HD)[c];
    reinterpret_cast<float4*>(s_q + r * HD)[c] = x;
  }

  // Keys any row of the tile can see: [k_lo, k_hi].
  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int k_hi = min(q_last, sk_real - 1);
  const int k_lo = window >= 0 ? max(0, q0 - window + 1) : 0;

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = (k_lo / kBK) * kBK; k0 <= k_hi; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < kBK * kV4; i += kThreads) {
      const int r = i / kV4, c = i - r * kV4;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
      if (k0 + r < Sk) {
        const size_t off = static_cast<size_t>(k0 + r) * HD;
        a = reinterpret_cast<const float4*>(kb + off)[c];
        b = reinterpret_cast<const float4*>(vb + off)[c];
      }
      reinterpret_cast<float4*>(s_k + r * kSK)[c] = a;
      reinterpret_cast<float4*>(s_v + r * HD)[c] = b;
    }
    __syncthreads();

    float s[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i] = 0.f;
    const float4* kr = reinterpret_cast<const float4*>(s_k + lane * kSK);
#pragma unroll 8
    for (int c = 0; c < kV4; ++c) {
      const float4 kk = kr[c];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 qq = reinterpret_cast<const float4*>(s_q + (row0 + i) * HD)[c];
        s[i] = fmaf(qq.x, kk.x, s[i]);
        s[i] = fmaf(qq.y, kk.y, s[i]);
        s[i] = fmaf(qq.z, kk.z, s[i]);
        s[i] = fmaf(qq.w, kk.w, s[i]);
      }
    }

    const int kp = k0 + lane;
    float p[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = q0 + row0 + i;
      const bool live = kp <= qp && kp < sk_real && (window < 0 || qp - kp < window);
      const float si = live ? s[i] * scale : kMasked;
      const float m_new = fmaxf(m[i], warp_max(si));
      const float alpha = expf(m[i] - m_new);
      p[i] = live ? expf(si - m_new) : 0.f;
      l[i] = l[i] * alpha + warp_sum(p[i]);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
    }

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pc[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pc[i] = __shfl_sync(kFull, p[i], c);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = lane + 32 * j;
        if (col < HD) {
          const float vv = s_v[c * HD + col];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pc[i], vv, acc[i][j]);
        }
      }
    }
  }

  float* ob = out + static_cast<size_t>(bh) * Sq * HD;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + row0 + i;
    if (qp >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = lane + 32 * j;
      if (col < HD) ob[static_cast<size_t>(qp) * HD + col] = acc[i][j] / den;
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int Sq, int Sk, int sk_real, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>((Sq + kBQ - 1) / kBQ) * BH;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_kernel<HD><<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), BH, Sq, Sk,
      sk_real, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int BH, int Sq,
                                      int Sk, int hd, int sk_real, int window,
                                      float scale, void* stream) {
  if (BH < 1 || Sq < 1 || Sk < 1 || sk_real < 0 || sk_real > Sk)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(q, k, v, out, BH, Sq, Sk, sk_real, window, scale, s);
    case 32: return launch<32>(q, k, v, out, BH, Sq, Sk, sk_real, window, scale, s);
    case 64: return launch<64>(q, k, v, out, BH, Sq, Sk, sk_real, window, scale, s);
    case 128: return launch<128>(q, k, v, out, BH, Sq, Sk, sk_real, window, scale, s);
    case 256: return launch<256>(q, k, v, out, BH, Sq, Sk, sk_real, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
