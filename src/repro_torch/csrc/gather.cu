// Gather-form similarity kernels over the mean-inverted index (CUDA, sm_90a).
//
// One template, four modes (kernels/esicp_gather.py, kernels/sparse_sim.py):
//   kSims    per (b, k): sims [, counts]
//   kSquare  per (b, k): Σ v·m² — sparse_sim over the squared matrix, which is
//            never built (CS-ICP's tail sum of squares)
//   kEsicp   per (b, k): rho12, y, sims [, counts over the exact region]
//   kTa      as kEsicp, with the threshold v_ta[b] of each document in place
//            of the shared v_th (TA-ICP), read once per document
//
// Grid: blockIdx.x = a tile of kTileK centroid columns, blockIdx.y = a tile
// of kDocsPerBlock documents.  Thread t owns the columns k0 + t + j*kThreads
// (j < kColsPerThread), so a warp reads 128 contiguous bytes of a means row.
// The block stages a document's (id, v) tuples in shared memory; for every
// live tuple each thread reads its columns of the contiguous row
// means_t[id, :] and folds them into per-thread registers.  The thresholds
// (t_th, and v_th or the document's v_ta) are the same for every thread of
// a block while it works on one document, and `tail` depends on the tuple
// alone, so every thread of a block takes the same path through the tuple
// loop; only the per-column `m >= threshold` test differs, and it is a
// select.
//
// Every accumulator walks the tuple slots in order and adds the rounded
// product (no fused multiply-add), which is the order and rounding of the
// plain version in kernels/ref.py: kernel and plain version agree bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColsPerThread = 4;
constexpr int kTileK = kThreads * kColsPerThread;
constexpr int kDocsPerBlock = 8;
constexpr int kSlots = 512;

enum Mode { kSims, kSquare, kEsicp, kTa };

template <int kMode, bool kCounts>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const int* __restrict__ ids, const float* __restrict__ vals,
              const float* __restrict__ means_t, int B, int P, int D, int K,
              float t_th, float v_th, const float* __restrict__ v_ta,
              float* __restrict__ sims, float* __restrict__ rho12,
              float* __restrict__ y, int* __restrict__ counts) {
  constexpr bool kRegions = kMode == kEsicp || kMode == kTa;
  __shared__ int s_id[kSlots];
  __shared__ float s_v[kSlots];
  const int k_base = blockIdx.x * kTileK + threadIdx.x;
  const int b0 = blockIdx.y * kDocsPerBlock;

  for (int bi = 0; bi < kDocsPerBlock; ++bi) {
    const int b = b0 + bi;
    if (b >= B) break;  // the same for every thread of the block
    const float thr = kMode == kTa ? v_ta[b] : v_th;
    float a_sim[kColsPerThread], a_rho[kColsPerThread], a_y[kColsPerThread];
    int a_cnt[kColsPerThread];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      a_sim[j] = 0.0f; a_rho[j] = 0.0f; a_y[j] = 0.0f; a_cnt[j] = 0;
    }
    const size_t row = static_cast<size_t>(b) * P;
    for (int p0 = 0; p0 < P; p0 += kSlots) {
      const int n = min(kSlots, P - p0);
      __syncthreads();  // the previous pass has finished reading s_id/s_v
      for (int i = threadIdx.x; i < n; i += kThreads) {
        s_id[i] = ids[row + p0 + i];
        s_v[i] = vals[row + p0 + i];
      }
      __syncthreads();
      for (int i = 0; i < n; ++i) {
        const float v = s_v[i];
        const int id = s_id[i];
        if (v == 0.0f || id < 0 || id >= D) continue;  // dead slot
        const float* mrow = means_t + static_cast<size_t>(id) * K;
        const bool tail = static_cast<float>(id) >= t_th;
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) {
          const int k = k_base + j * kThreads;
          if (k < K) {
            const float m = __ldg(mrow + k);
            const float c =
                __fmul_rn(v, kMode == kSquare ? __fmul_rn(m, m) : m);
            a_sim[j] = __fadd_rn(a_sim[j], c);
            if (kRegions) {
              const bool exact = !tail || m >= thr;
              a_rho[j] = exact ? __fadd_rn(a_rho[j], c) : a_rho[j];
              a_y[j] = exact ? a_y[j] : __fadd_rn(a_y[j], v);
              if (kCounts) a_cnt[j] += (exact && m > 0.0f) ? 1 : 0;
            } else if (kCounts) {
              a_cnt[j] += (m > 0.0f) ? 1 : 0;
            }
          }
        }
      }
    }
    const size_t out = static_cast<size_t>(b) * K;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int k = k_base + j * kThreads;
      if (k < K) {
        sims[out + k] = a_sim[j];
        if (kRegions) { rho12[out + k] = a_rho[j]; y[out + k] = a_y[j]; }
        if (kCounts) counts[out + k] = a_cnt[j];
      }
    }
  }
}

dim3 grid_for(int B, int K) {
  return dim3((K + kTileK - 1) / kTileK, (B + kDocsPerBlock - 1) / kDocsPerBlock);
}

template <int kMode>
int launch(const void* ids, const void* vals, const void* means_t, int B,
           int P, int D, int K, float t_th, float v_th, const void* v_ta,
           void* rho12, void* y, void* sims, void* counts, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* i = static_cast<const int*>(ids);
  const auto* v = static_cast<const float*>(vals);
  const auto* m = static_cast<const float*>(means_t);
  const auto* ta = static_cast<const float*>(v_ta);
  auto* o_sims = static_cast<float*>(sims);
  auto* o_rho = static_cast<float*>(rho12);
  auto* o_y = static_cast<float*>(y);
  if (counts) {
    gather_kernel<kMode, true><<<grid_for(B, K), kThreads, 0, s>>>(
        i, v, m, B, P, D, K, t_th, v_th, ta, o_sims, o_rho, o_y,
        static_cast<int*>(counts));
  } else {
    gather_kernel<kMode, false><<<grid_for(B, K), kThreads, 0, s>>>(
        i, v, m, B, P, D, K, t_th, v_th, ta, o_sims, o_rho, o_y, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gather_max_rows() { return 65535 * kDocsPerBlock; }

extern "C" int esicp_gather_launch(const void* ids, const void* vals,
                                   const void* means_t, int B, int P, int D,
                                   int K, float t_th, float v_th, void* rho12,
                                   void* y, void* sims, void* counts,
                                   void* stream) {
  return launch<kEsicp>(ids, vals, means_t, B, P, D, K, t_th, v_th, nullptr,
                        rho12, y, sims, counts, stream);
}

extern "C" int esicp_gather_ta_launch(const void* ids, const void* vals,
                                      const void* means_t, int B, int P,
                                      int D, int K, float t_th,
                                      const void* v_ta, void* rho12, void* y,
                                      void* sims, void* counts,
                                      void* stream) {
  return launch<kTa>(ids, vals, means_t, B, P, D, K, t_th, 0.0f, v_ta, rho12,
                     y, sims, counts, stream);
}

extern "C" int sparse_sim_launch(const void* ids, const void* vals,
                                 const void* means_t, int B, int P, int D,
                                 int K, int square, void* sims, void* counts,
                                 void* stream) {
  if (square) {
    if (counts) return static_cast<int>(cudaErrorInvalidValue);
    return launch<kSquare>(ids, vals, means_t, B, P, D, K, 0.0f, 0.0f,
                           nullptr, nullptr, nullptr, sims, nullptr, stream);
  }
  return launch<kSims>(ids, vals, means_t, B, P, D, K, 0.0f, 0.0f, nullptr,
                       nullptr, nullptr, sims, counts, stream);
}

extern "C" const char* gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
