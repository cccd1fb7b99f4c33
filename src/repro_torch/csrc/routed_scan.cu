// Routed scan of a two-level model: per document, the exact similarities
// to the fine centroids of its probed coarse cells, and their first maximum
// (CUDA, sm_90a; kernels/routed_scan.py).
//
// Candidate j of document b is probe rank r = j / cmax, slot s = j mod
// cmax: the centroid column starts[c] + s of cell c = cells[b, r] when
// s < min(sizes[c], cmax); other slots are dead and never scored.
//
// The batch is grouped by cell on the device.  Three launches, one count
// of the wrapper:
//
// 1. routed_scan_plan (one block): counting sort of the B * n_probe
//    (document, probe rank) pairs by cell (sub-histograms and the order in
//    shared memory); per cell its pairs' offset and its work items, each
//    pair times the cell's column strips of kStrip columns (from the
//    multiple of kAlign at or below its first column); the items' map; the
//    keys reset.
// 2. routed_scan_tile: a block per work item, the grid the bound B *
//    n_probe * ceil((cmax + kAlign - 1) / kStrip) (surplus blocks exit), a
//    cell's items neighbouring blocks.  kStrip / V threads over the strip's
//    columns, V consecutive columns a thread (V = 4, one 16-byte gather,
//    when K is a multiple of 4 and means_t 16-byte aligned; else V = 1), no
//    dead candidate slot and no cmax rounds.  The document's tuples are
//    staged in shared memory (the whole row, up to kStage slots a chunk)
//    and walked in slot order with the gathers of the next kSteps steps in
//    flight.  A slot with v != 0 adds the rounded product v * means_t[id,
//    col] with a rounded add, from +0: the document's slots [0, nnz) in
//    their order, the flat sparse_sim's arithmetic for that column, so the
//    winning similarity equals the flat classify's bit for bit.  Each warp
//    reduces its lanes' keys and adds one 64-bit atomicMax.
// 3. routed_scan_finish: per document, the winner from its key; scored
//    from sizes.
//
// The key of (similarity f, candidate j) is the order-preserving map of
// f's bits (with -0.0 folded into +0.0) in the high half and INT_MAX - j in
// the low half: the largest key is the largest value and, among equal
// values, the lowest j (probe rank major, then slot), jnp.argmax's first
// maximum.  No key is 0, and a max is order-free, so the result does not
// depend on the order of the atomics.  A dead row (nnz 0) scores +0
// everywhere and takes candidate 0; a row whose probed cells are all empty
// keeps the key 0 and takes column 0 at -inf, as the plain version.
//
// CUDA-graph safe: the grids depend on B, n_probe, K_c and cmax only, the
// scratch comes from the caller, and nothing waits on the host.
#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPlanThreads = 1024;
constexpr int kPlanWarps = kPlanThreads / 32;
constexpr int kPlanUnroll = 8;  // pairs a plan thread loads at once
// The plan's shared memory: its order (when B * n_probe ints fit in
// kPlanOrderBytes) and its sub-histograms.
constexpr int kPlanSharedBytes = 200 * 1024;
constexpr int kPlanOrderBytes = 128 * 1024;
constexpr int kStrip = 128;  // columns a tile block covers
// Strips start at a multiple of kAlign columns: a warp's 32 floats then
// lie in 4 sectors of 32 bytes when K is a multiple of 8.
constexpr int kAlign = 8;
constexpr int kSteps = 8;    // slot steps whose gathers are in flight
constexpr int kStage = 512;  // most slots of a document staged at once
constexpr int kFinishThreads = 256;

using u64 = unsigned long long;

struct Layout {
  size_t keys, pbase, tbase, order, items, counters, bytes;
};

// Work items of the tile grid: each pair times the most strips a cell
// can have.
long long grid_bound(int B, int n_probe, int cmax) {
  return static_cast<long long>(B) * n_probe *
         ((cmax + kAlign - 1 + kStrip - 1) / kStrip);
}

// Ints of the plan's order kept in shared memory (all or none).
int plan_order_ints(int B, int n_probe) {
  const long long pairs = static_cast<long long>(B) * n_probe;
  return pairs * 4 <= kPlanOrderBytes ? static_cast<int>(pairs) : 0;
}

// Sub-histograms of the plan's counting sort in shared memory, or 0 when
// even one does not fit (then one in global scratch).
int plan_histograms(int B, int n_probe, int k_c) {
  const int free_ints = kPlanSharedBytes / 4 - plan_order_ints(B, n_probe);
  return std::min(kPlanWarps, free_ints / k_c);
}

size_t align256(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }

// Scratch: keys (B u64) | pbase (K_c + 1) | tbase (K_c + 1) | order
// (B * n_probe) | items (grid int2) | counters (K_c, when no sub-histogram
// fits in shared memory).
Layout layout(int B, int n_probe, int k_c, int cmax) {
  Layout l{};
  size_t at = 0;
  l.keys = at;
  at = align256(at + sizeof(u64) * B);
  l.pbase = at;
  at = align256(at + sizeof(int) * (k_c + 1));
  l.tbase = at;
  at = align256(at + sizeof(int) * (k_c + 1));
  l.order = at;
  at = align256(at + sizeof(int) * static_cast<size_t>(B) * n_probe);
  l.items = at;
  at = align256(at + sizeof(int2) * static_cast<size_t>(
                         grid_bound(B, n_probe, cmax)));
  l.counters = at;
  at = align256(at + (plan_histograms(B, n_probe, k_c) == 0
                          ? sizeof(int) * k_c : 0));
  l.bytes = at;
  return l;
}

__device__ __forceinline__ u64 make_key(float f, int j) {
  unsigned u = __float_as_uint(f);
  if (f == 0.0f) u = 0u;  // -0.0 ranks as +0.0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<u64>(u) << 32) | static_cast<unsigned>(INT_MAX - j);
}

// Live candidate slots of a cell of `size` centroids: none past cmax.
__device__ __forceinline__ int live_size(int size, int cmax) {
  return min(max(size, 0), cmax);
}

// Column strips of a cell's `size` live columns from the multiple of
// kAlign at or below `start`; none for an empty cell.
__device__ __forceinline__ int strips_of(int start, int size) {
  return size > 0 ? (size + (start & (kAlign - 1)) + kStrip - 1) / kStrip
                  : 0;
}

// Exclusive block-wide scan of (a, t) over kPlanThreads threads; the
// block's totals land in *total.  Every thread must call it.
__device__ int2 block_scan(int a, int t, int2* warp_sums, int2* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int ia = a, it = t;
  for (int off = 1; off < 32; off <<= 1) {
    const int a2 = __shfl_up_sync(0xffffffffu, ia, off);
    const int t2 = __shfl_up_sync(0xffffffffu, it, off);
    if (lane >= off) {
      ia += a2;
      it += t2;
    }
  }
  if (lane == 31) warp_sums[w] = make_int2(ia, it);
  __syncthreads();
  if (w == 0) {
    int2 s = lane < kPlanWarps ? warp_sums[lane] : make_int2(0, 0);
    for (int off = 1; off < 32; off <<= 1) {
      const int a2 = __shfl_up_sync(0xffffffffu, s.x, off);
      const int t2 = __shfl_up_sync(0xffffffffu, s.y, off);
      if (lane >= off) {
        s.x += a2;
        s.y += t2;
      }
    }
    if (lane < kPlanWarps) warp_sums[lane] = s;
  }
  __syncthreads();
  const int2 before = w > 0 ? warp_sums[w - 1] : make_int2(0, 0);
  if (threadIdx.x == 0) *total = warp_sums[kPlanWarps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return make_int2(before.x + ia - a, before.y + it - t);
}

// H sub-histograms (warp w counts into w mod H), so that the warps of the
// block rarely contend for one counter; the order is built in shared
// memory when it fits (n_order == pairs) and copied out in one pass.
__global__ void __launch_bounds__(kPlanThreads)
routed_scan_plan(const int* __restrict__ cells,
                 const int* __restrict__ starts,
                 const int* __restrict__ sizes, int B, int n_probe, int k_c,
                 int cmax, int n_order, int H, int* __restrict__ counters,
                 int* __restrict__ pbase, int* __restrict__ tbase,
                 int* __restrict__ order, int2* __restrict__ items,
                 u64* __restrict__ keys) {
  extern __shared__ int s_plan[];
  __shared__ int2 warp_sums[kPlanWarps];
  __shared__ int2 total;
  const int tid = threadIdx.x, lane = tid & 31;
  const int pairs = B * n_probe;
  int* ord = n_order > 0 ? s_plan : order;
  int* hist = counters == nullptr ? s_plan + n_order : counters;
  int* mine = hist + ((tid >> 5) % H) * k_c;
  for (int i = tid; i < H * k_c; i += kPlanThreads) hist[i] = 0;
  for (int b = tid; b < B; b += kPlanThreads) keys[b] = 0ull;
  __syncthreads();
  // kPlanUnroll pairs a thread at a time, their cells loaded together.
  for (int i0 = tid; i0 < pairs; i0 += kPlanThreads * kPlanUnroll) {
    int cell[kPlanUnroll];
#pragma unroll
    for (int u = 0; u < kPlanUnroll; ++u) {
      const int i = i0 + u * kPlanThreads;
      cell[u] = i < pairs ? cells[i] : -1;
    }
#pragma unroll
    for (int u = 0; u < kPlanUnroll; ++u)
      if (cell[u] >= 0) atomicAdd(&mine[cell[u]], 1);
  }
  __syncthreads();
  int2 carry = make_int2(0, 0);
  for (int c0 = 0; c0 < k_c; c0 += kPlanThreads) {
    const int c = c0 + tid;
    int n = 0, work = 0;
    if (c < k_c) {
      for (int h = 0; h < H; ++h) n += hist[h * k_c + c];
      work = n * strips_of(starts[c], live_size(sizes[c], cmax));
    }
    const int2 ex = block_scan(n, work, warp_sums, &total);
    if (c < k_c) {
      pbase[c] = carry.x + ex.x;
      tbase[c] = carry.y + ex.y;
      // Each sub-histogram's count becomes its first position.
      for (int h = 0, at = carry.x + ex.x; h < H; ++h) {
        const int m = hist[h * k_c + c];
        hist[h * k_c + c] = at;
        at += m;
      }
    }
    carry.x += total.x;
    carry.y += total.y;
  }
  // At most the grid bound: a cell's strips never exceed cmax's.
  if (tid == 0) {
    pbase[k_c] = carry.x;
    tbase[k_c] = carry.y;
  }
  __syncthreads();
  for (int i0 = tid; i0 < pairs; i0 += kPlanThreads * kPlanUnroll) {
    int cell[kPlanUnroll], at[kPlanUnroll];
#pragma unroll
    for (int u = 0; u < kPlanUnroll; ++u) {
      const int i = i0 + u * kPlanThreads;
      cell[u] = i < pairs ? cells[i] : -1;
    }
#pragma unroll
    for (int u = 0; u < kPlanUnroll; ++u)
      at[u] = cell[u] >= 0 ? atomicAdd(&mine[cell[u]], 1) : -1;
#pragma unroll
    for (int u = 0; u < kPlanUnroll; ++u)
      if (at[u] >= 0) ord[at[u]] = i0 + u * kPlanThreads;
  }
  // A warp a cell writes the cell's items.
  for (int c = tid >> 5; c < k_c; c += kPlanWarps) {
    const int t0 = tbase[c];
    const int n = (c + 1 < k_c ? tbase[c + 1] : carry.y) - t0;
    for (int t = lane; t < n; t += 32) items[t0 + t] = make_int2(c, t);
  }
  if (n_order == 0) return;
  __syncthreads();
  for (int i = tid; i < pairs; i += kPlanThreads) order[i] = ord[i];
}

// V consecutive floats of means from p (one 16-byte load when V is 4),
// or zeros when the slot adds nothing (v == 0).
template <int V>
__device__ __forceinline__ void gather(bool live, const float* p,
                                       float (&x)[V]) {
  if (!live) {
#pragma unroll
    for (int k = 0; k < V; ++k) x[k] = 0.0f;
  } else if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = t.x;
    x[1] = t.y;
    x[2] = t.z;
    x[3] = t.w;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) x[k] = __ldg(p + k);
  }
}

// A block: kStrip / V threads over a strip of kStrip columns of one
// (document, probe rank) pair's cell, V consecutive columns a thread.
template <int V>
__global__ void __launch_bounds__(kStrip / V)
routed_scan_tile(const int* __restrict__ ids, const float* __restrict__ vals,
                 const int* __restrict__ nnz,
                 const float* __restrict__ means_t,
                 const int* __restrict__ starts,
                 const int* __restrict__ sizes, int P, int K, int n_probe,
                 int cmax, int k_c, int S, const int* __restrict__ pbase,
                 const int* __restrict__ tbase,
                 const int* __restrict__ order,
                 const int2* __restrict__ items, u64* __restrict__ keys) {
  constexpr int T = kStrip / V, U = kSteps;
  // (id, bits of v) of the document's slots: S + U of them.
  extern __shared__ int2 s_t[];
  const int tid = threadIdx.x;
  if (static_cast<int>(blockIdx.x) >= tbase[k_c]) return;
  const int2 item = items[blockIdx.x];
  const int c = item.x, start = starts[c];
  const int size = live_size(sizes[c], cmax);
  const int off = start & (kAlign - 1);  // strip columns before the first
  const int strips = strips_of(start, size);
  const int pair = item.y / strips, col0 = (item.y - pair * strips) * kStrip;
  const int pr = order[pbase[c] + pair];
  const int b = pr / n_probe, r = pr - b * n_probe;
  const int n = min(max(nnz[b], 0), P);
  // This thread's first slot of the cell; columns outside the cell are
  // read from the cell's last V-aligned group (the same lines as its
  // warp's) and score nothing.
  const int s0 = col0 + tid * V - off;
  const bool warp_live = col0 + (tid & ~31) * V - off < size;
  const int last = ((start + size - 1) & ~(V - 1)) - start;
  const float* mc = means_t + start + min(s0, last);
  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.0f;
  for (int p0 = 0; p0 < n; p0 += S) {
    // Slots [0, m) of the chunk, then zeros (v = 0, id = 0) to a multiple
    // of U plus U more, which the prefetch reads past the last step.
    const int m = min(S, n - p0), steps = (m + U - 1) / U * U;
    __syncthreads();  // the previous chunk's readers are done
    for (int q = tid; q < steps + U; q += T) {
      int id = 0;
      float v = 0.0f;
      if (q < m) {
        const size_t o = static_cast<size_t>(b) * P + p0 + q;
        v = vals[o];
        id = v != 0.0f ? ids[o] : 0;
      }
      s_t[q] = make_int2(id, __float_as_int(v));
    }
    __syncthreads();
    if (!warp_live) continue;
    // The gathers of steps q0 + U .. q0 + 2U - 1 are issued while steps
    // q0 .. q0 + U - 1 add.  Only the gathered values stay in registers;
    // v is read again.
    float x[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int2 t = s_t[u];
      gather<V>(__int_as_float(t.y) != 0.0f,
                mc + static_cast<size_t>(t.x) * K, x[u]);
    }
    for (int q0 = 0; q0 < steps; q0 += U) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float v = __int_as_float(s_t[q0 + u].y);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float a = __fadd_rn(acc[k], __fmul_rn(v, x[u][k]));
          acc[k] = v != 0.0f ? a : acc[k];
        }
        const int2 t = s_t[q0 + U + u];
        gather<V>(__int_as_float(t.y) != 0.0f,
                  mc + static_cast<size_t>(t.x) * K, x[u]);
      }
    }
  }
  if (!warp_live) return;
  u64 key = 0ull;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int s = s0 + k;
    if (s >= 0 && s < size) {
      const u64 mine = make_key(acc[k], r * cmax + s);
      key = mine > key ? mine : key;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const u64 other = __shfl_xor_sync(0xffffffffu, key, o);
    key = other > key ? other : key;
  }
  if ((tid & 31) == 0 && key != 0ull) atomicMax(&keys[b], key);
}

__global__ void __launch_bounds__(kFinishThreads)
routed_scan_finish(const u64* __restrict__ keys,
                   const int* __restrict__ cells,
                   const int* __restrict__ starts,
                   const int* __restrict__ sizes, int B, int n_probe,
                   int cmax, int k_c, int* __restrict__ assign,
                   float* __restrict__ best, int* __restrict__ scored) {
  const int b = blockIdx.x * kFinishThreads + threadIdx.x;
  if (b >= B) return;
  const int* my_cells = cells + static_cast<size_t>(b) * n_probe;
  int total = k_c;
  for (int q = 0; q < n_probe; ++q) total += sizes[my_cells[q]];
  scored[b] = total;
  const u64 key = keys[b];
  if (key == 0ull) {  // no live candidate: column 0 at -inf
    assign[b] = 0;
    best[b] = __int_as_float(0xff800000);
    return;
  }
  const unsigned hi = static_cast<unsigned>(key >> 32);
  const unsigned u = (hi & 0x80000000u) ? (hi & 0x7fffffffu) : ~hi;
  const int j = INT_MAX - static_cast<int>(key & 0xffffffffu);
  const int r = j / cmax;
  assign[b] = starts[my_cells[r]] + (j - r * cmax);
  best[b] = __uint_as_float(u);
}

struct Args {
  const int* ids;
  const float* vals;
  const int* nnz;
  const float* means_t;
  const int* cells;
  const int* starts;
  const int* sizes;
  int B, P, K, n_probe, cmax, k_c;
  char* scratch;
  int* assign;
  float* best;
  int* scored;
  cudaStream_t stream;
};

// V columns a tile thread: 4 needs K a multiple of 4 and means_t 16-byte
// aligned (the caller checks).
template <int V>
int launch_grouped(const Args& a) {
  const long long grid = grid_bound(a.B, a.n_probe, a.cmax);
  if (grid > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(a.B, a.n_probe, a.k_c, a.cmax);
  u64* keys = reinterpret_cast<u64*>(a.scratch + l.keys);
  int* pbase = reinterpret_cast<int*>(a.scratch + l.pbase);
  int* tbase = reinterpret_cast<int*>(a.scratch + l.tbase);
  int* order = reinterpret_cast<int*>(a.scratch + l.order);
  int2* items = reinterpret_cast<int2*>(a.scratch + l.items);
  const int n_order = plan_order_ints(a.B, a.n_probe);
  const int H = plan_histograms(a.B, a.n_probe, a.k_c);
  int* counters =
      H == 0 ? reinterpret_cast<int*>(a.scratch + l.counters) : nullptr;
  const size_t plan_shared = sizeof(int) * (n_order + H * a.k_c);
  cudaError_t err = cudaFuncSetAttribute(
      routed_scan_plan, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kPlanSharedBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  routed_scan_plan<<<1, kPlanThreads, plan_shared, a.stream>>>(
      a.cells, a.starts, a.sizes, a.B, a.n_probe, a.k_c, a.cmax, n_order,
      std::max(H, 1), counters, pbase, tbase, order, items, keys);
  // A chunk of S slots (a multiple of kSteps): the whole row when it fits.
  const int S =
      (std::min(std::max(a.P, 1), kStage) + kSteps - 1) / kSteps * kSteps;
  const size_t staged = sizeof(int2) * (S + kSteps);
  routed_scan_tile<V>
      <<<static_cast<int>(grid), kStrip / V, staged, a.stream>>>(
          a.ids, a.vals, a.nnz, a.means_t, a.starts, a.sizes, a.P, a.K,
          a.n_probe, a.cmax, a.k_c, S, pbase, tbase, order, items, keys);
  routed_scan_finish<<<(a.B + kFinishThreads - 1) / kFinishThreads,
                       kFinishThreads, 0, a.stream>>>(
      keys, a.cells, a.starts, a.sizes, a.B, a.n_probe, a.cmax, a.k_c,
      a.assign, a.best, a.scored);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int B, int P, int K, int n_probe, int cmax, int k_c) {
  return B < 0 || P < 0 || K < 1 || n_probe < 1 || cmax < 1 || k_c < 1 ||
         static_cast<long long>(n_probe) * cmax > INT_MAX / 2 ||
         static_cast<long long>(B) * n_probe > INT_MAX / 2;
}

}  // namespace

// Bytes of scratch the launch needs, or -1 for shapes it refuses.
extern "C" long long routed_scan_scratch_bytes(int B, int n_probe, int k_c,
                                               int cmax) {
  if (bad_shape(B, 0, 1, n_probe, cmax, k_c)) return -1;
  return static_cast<long long>(layout(B, n_probe, k_c, cmax).bytes);
}

extern "C" int routed_scan_launch(
    const void* ids, const void* vals, const void* nnz, const void* means_t,
    const void* cells, const void* starts, const void* sizes, int B, int P,
    int K, int n_probe, int cmax, int k_c, void* scratch, void* assign,
    void* best, void* scored, void* stream) {
  if (B == 0) return 0;
  if (bad_shape(B, P, K, n_probe, cmax, k_c))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int*>(ids),
               static_cast<const float*>(vals),
               static_cast<const int*>(nnz),
               static_cast<const float*>(means_t),
               static_cast<const int*>(cells),
               static_cast<const int*>(starts),
               static_cast<const int*>(sizes),
               B, P, K, n_probe, cmax, k_c,
               static_cast<char*>(scratch),
               static_cast<int*>(assign),
               static_cast<float*>(best),
               static_cast<int*>(scored),
               static_cast<cudaStream_t>(stream)};
  const bool four =
      K % 4 == 0 && reinterpret_cast<uintptr_t>(means_t) % 16 == 0;
  return four ? launch_grouped<4>(a) : launch_grouped<1>(a);
}

extern "C" const char* routed_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
