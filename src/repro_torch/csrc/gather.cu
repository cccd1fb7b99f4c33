// Gather-form similarity kernels over the mean-inverted index (CUDA, sm_90a).
//
// Four modes (kernels/esicp_gather.py, kernels/sparse_sim.py):
//   kSims    per (b, k): sims [, counts]
//   kSquare  per (b, k): Σ v·m², sparse_sim over the squared matrix, which
//            is never built (CS-ICP's tail sum of squares)
//   kEsicp   per (b, k): rho12, y, sims [, counts over the exact region]
//   kTa      as kEsicp, with the threshold v_ta[b] of each document in place
//            of the shared v_th (TA-ICP)
//
// All four run the document tile (gather_tiled).  What bounds a gather is
// moving means rows to the SMs.  A row segment is 4·Kt bytes, and a batch
// names each of its distinct rows in several documents.  Walking the tuples
// one by one re-reads a segment for every tuple: 36 GB for a 4096-document
// NYT batch, of which 7.3 GB are distinct.  So each launch runs
//   1. a plan over the batch (plan_mark, plan_rank, plan_slots; scratch from
//      the caller, nothing kept between calls): per tile of kBt documents a
//      bitmap of its live ids, their ascending list (uid) and, for every
//      live slot, its index u into that list, compacted in slot order per
//      document (rec);
//   2. one block per (document tile, column slab of Kt = 32·kCpl columns),
//      tiles fastest, so the blocks in flight share a few slabs and the
//      other tiles find a (row, slab) segment in L2.  A producer warp copies
//      the tile's distinct segments in ascending id order, kRows at a time,
//      into a ring of kStages shared-memory buffers: one bulk copy (the TMA)
//      per segment, completion and release on mbarriers, so the copies run
//      kStages chunks ahead of the arithmetic without a block barrier.
//      Every document of the tile that names a row reads the staged copy:
//      L2->SM traffic falls from one segment per tuple to one per distinct
//      row of the tile (25 GB at 28 documents, 27 GB at 14).
// Each consumer warp owns kDocs fixed documents and all Kt columns (lane l:
// four columns of every 128, so a warp's shared-memory reads meet no bank
// conflict).  Per chunk it runs an unrolled loop over its documents, each
// walking its own records that fall in the chunk.  The current record sits
// in registers, the rest of a 32-record window across the lanes (read by
// shuffle), the next window in flight, so no register array is indexed at
// run time.
// Order: a document's live ids ascend (SparseDocs), so visiting the tile's
// distinct ids in ascending order visits its slots in slot order, duplicate
// ids included: the order of the plain version.  kSquare at t_th 0 makes a
// row's dead id-0 slots live (CS-ICP), so the plan takes a row's head, its
// live slots up to the last with an id other than 0, into the tile, and the
// id-0 slots after it are added after the chunks, slot by slot.  A row
// whose head's ids do not ascend is walked slot by slot from global memory
// after the chunks, so the order holds for any input.
// ES regions: `tail` (float(id) >= t_th) is a suffix of the tile's distinct
// ids, from uth[tile] on.  Over the head, rho12 receives exactly the adds of
// sims, so one accumulator (plus counts) serves both and is copied into
// rho12 where the chunks cross uth; only tail tuples pay for the `exact`
// select and y.
// What is left (scripts/gather_probe.py, H100 80GB HBM3, 700 W): sims takes
// 5.5 ms on a 4096-document NYT batch and 2.1 ms when every row it names is
// L2-resident (shared-memory reads and issue); the rest is rows that miss
// L2.  With the slabs fastest in the grid instead it takes 8.5 ms.
//
// Every accumulator adds the rounded product (no fused multiply-add) in
// slot order, which is the order and rounding of the plain version in
// kernels/ref.py: kernel and plain version agree bit for bit.  kSquare adds
// v·(m·m), each product rounded, as the plain version does.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

enum Mode { kSims = 0, kSquare = 1, kEsicp = 2, kTa = 3 };

constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// The plan: per document tile, its distinct live ids and every live slot's
// index into them.
constexpr int kPlanWarps = 8;       // documents per plan_mark/plan_slots block
constexpr int kRankThreads = 1024;  // one plan_rank block per tile
constexpr int kBufFloats = 8192;    // one staged chunk of row segments: 32 KB
constexpr int kEnd = INT_MAX;       // record index past a document's last

struct Plan {
  unsigned* bits;  // (tiles, W) bitmap of the tile's live ids
  int* wbase;      // (tiles, W) the tile's distinct ids below word w
  int* uid;        // (tiles, cap) the tile's distinct ids, ascending
  int* ucount;     // (tiles,) how many
  int* uth;        // (tiles,) how many have float(id) < t_th
  int2* rec;       // (B, P) live slots in order: (u, value bits), then kEnd
  int* walk;       // (B,) the slot from which the row is walked slot by slot
};

struct Layout {
  size_t tiles, words, cap;
  size_t bits, wbase, uid, ucount, uth, rec, walk, total;  // byte offsets
};

size_t align256(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }

Layout plan_layout(int B, int P, int D, int bt) {
  Layout L;
  L.tiles = (static_cast<size_t>(B) + bt - 1) / bt;
  L.words = (static_cast<size_t>(D) + 31) / 32;
  L.cap = static_cast<size_t>(bt) * P;
  if (L.cap > static_cast<size_t>(D)) L.cap = D;
  size_t off = 0;
  L.bits = off;    off += align256(L.tiles * L.words * 4);
  L.wbase = off;   off += align256(L.tiles * L.words * 4);
  L.uid = off;     off += align256(L.tiles * L.cap * 4);
  L.ucount = off;  off += align256(L.tiles * 4);
  L.uth = off;     off += align256(L.tiles * 4);
  L.rec = off;     off += align256(static_cast<size_t>(B) * P * 8);
  L.walk = off;    off += align256(static_cast<size_t>(B) * 4);
  L.total = off;
  return L;
}

__device__ __forceinline__ bool live_slot(int id, float v, int D) {
  return v != 0.0f && id >= 0 && id < D;
}

// One warp per document: set the tile's bits of its live ids.
__global__ void __launch_bounds__(kPlanWarps * 32)
plan_mark(const int* __restrict__ ids, const float* __restrict__ vals, int B,
          int P, int D, int bt, int W, unsigned* __restrict__ bits) {
  const int b = blockIdx.x * kPlanWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  unsigned* tb = bits + static_cast<size_t>(b / bt) * W;
  const size_t row = static_cast<size_t>(b) * P;
  for (int p = threadIdx.x & 31; p < P; p += 32) {
    const int id = ids[row + p];
    if (!live_slot(id, vals[row + p], D)) continue;
    const unsigned bit = 1u << (id & 31);
    if (!(tb[id >> 5] & bit)) atomicOr(tb + (id >> 5), bit);
  }
}

// One block per tile: exclusive scan of the bitmap's popcounts (wbase), the
// ascending distinct ids (uid), their count and the head's length (uth).
__global__ void __launch_bounds__(kRankThreads)
plan_rank(const unsigned* __restrict__ bits, int W, int cap, float t_th,
          int* __restrict__ wbase, int* __restrict__ uid,
          int* __restrict__ ucount, int* __restrict__ uth) {
  __shared__ int s_warp[kRankThreads / 32];
  __shared__ int s_below;
  const int t = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned* tb = bits + static_cast<size_t>(t) * W;
  int* tw = wbase + static_cast<size_t>(t) * W;
  int* tu = uid + static_cast<size_t>(t) * cap;
  if (threadIdx.x == 0) s_below = 0;
  __syncthreads();
  int running = 0, below = 0;
  for (int w0 = 0; w0 < W; w0 += kRankThreads) {
    const int w = w0 + threadIdx.x;
    unsigned word = w < W ? tb[w] : 0u;
    const int c = __popc(word);
    int x = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int s = s_warp[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, s, o);
        if (lane >= o) s += y;
      }
      s_warp[lane] = s;
    }
    __syncthreads();
    int r = running + (warp ? s_warp[warp - 1] : 0) + x - c;
    if (w < W) {
      tw[w] = r;
      while (word) {
        const int id = w * 32 + __ffs(word) - 1;
        tu[r++] = id;
        below += static_cast<float>(id) < t_th ? 1 : 0;
        word &= word - 1;
      }
    }
    running += s_warp[kRankThreads / 32 - 1];
    __syncthreads();  // s_warp is rewritten by the next round
  }
  atomicAdd(&s_below, below);
  __syncthreads();
  if (threadIdx.x == 0) {
    ucount[t] = running;
    uth[t] = s_below;
  }
}

// One warp per document.  Its head: the live slots up to the last with an
// id other than 0; the rest of its live slots have id 0 (CS-ICP's dead
// slots made live at t_th 0, or none).  When the head's ids ascend, its
// records in slot order, compacted, kEnd after them, and walk[b] the first
// slot after the head (P when no live slot follows); else all kEnd and
// walk[b] = 0: the whole row is walked slot by slot.
__global__ void __launch_bounds__(kPlanWarps * 32)
plan_slots(const int* __restrict__ ids, const float* __restrict__ vals, int B,
           int P, int D, int bt, int W, const unsigned* __restrict__ bits,
           const int* __restrict__ wbase, int2* __restrict__ rec,
           int* __restrict__ walk) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kPlanWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  const size_t row = static_cast<size_t>(b) * P;
  int last = -1;  // the head's last slot
  for (int p0 = 0; p0 < P; p0 += 32) {
    const int p = p0 + lane;
    const int id = p < P ? ids[row + p] : 0;
    const bool nz = p < P && id != 0 && live_slot(id, vals[row + p], D);
    const unsigned mask = __ballot_sync(kFull, nz);
    if (mask) last = p0 + 31 - __clz(mask);
  }
  int run_max = INT_MIN;
  bool down = false, after = false;
  for (int p0 = 0; p0 < P; p0 += 32) {
    const int p = p0 + lane;
    const int id = p < P ? ids[row + p] : 0;
    const bool live = p < P && live_slot(id, vals[row + p], D);
    after |= live && p > last;
    const bool head = live && p <= last;
    int x = head ? id : INT_MIN;  // inclusive prefix max of the head's ids
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x = max(x, y);
    }
    int before = __shfl_up_sync(kFull, x, 1);
    before = lane == 0 ? run_max : max(before, run_max);
    down |= head && id < before;
    run_max = max(run_max, __shfl_sync(kFull, x, 31));
  }
  const bool ok = !__any_sync(kFull, down);
  const bool tail_walk = __any_sync(kFull, after);
  const unsigned* tb = bits + static_cast<size_t>(b / bt) * W;
  const int* tw = wbase + static_cast<size_t>(b / bt) * W;
  int n = 0;
  if (ok) {
    for (int p0 = 0; p0 <= last; p0 += 32) {
      const int p = p0 + lane;
      const int id = p <= last ? ids[row + p] : 0;
      const float v = p <= last ? vals[row + p] : 0.0f;
      const bool live = p <= last && live_slot(id, v, D);
      const unsigned mask = __ballot_sync(kFull, live);
      if (live) {
        const int w = id >> 5;
        const int u = tw[w] + __popc(tb[w] & ((1u << (id & 31)) - 1u));
        rec[row + n + __popc(mask & ((1u << lane) - 1u))] =
            make_int2(u, __float_as_int(v));
      }
      n += __popc(mask);
    }
  }
  for (int q = n + lane; q < P; q += 32) rec[row + q] = make_int2(kEnd, 0);
  if (lane == 0) walk[b] = !ok ? 0 : (tail_walk ? last + 1 : P);
}

// ---------------------------------------------------------------------------
// The tiled gather.

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, int n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(n) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          int parity) {
  const unsigned a = smem_addr(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  }
}

// A bulk copy (the TMA, no tensor map) of `bytes` contiguous bytes from
// global to shared memory, completing on `bar`'s transaction count.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}

// Lane l's columns of a slab: groups of four, 128 columns apart (lane l
// reads floats 4l..4l+3 of each group, so a quarter-warp's 16-byte reads
// are consecutive and meet no bank conflict); fewer than four: kCpl·l ...
template <int kCpl>
__device__ __forceinline__ int lane_col(int lane, int j) {
  if constexpr (kCpl % 4 == 0) return (j / 4) * 128 + 4 * lane + j % 4;
  else return kCpl * lane + j;
}

// This lane's kCpl values of the staged row segment `row`.
template <int kCpl>
__device__ __forceinline__ void load_cols(const float* row, int lane,
                                          float (&m)[kCpl]) {
  if constexpr (kCpl % 4 == 0) {
#pragma unroll
    for (int j = 0; j < kCpl; j += 4) {
      const float4 t =
          *reinterpret_cast<const float4*>(row + lane_col<kCpl>(lane, j));
      m[j] = t.x; m[j + 1] = t.y; m[j + 2] = t.z; m[j + 3] = t.w;
    }
  } else if constexpr (kCpl == 2) {
    const float2 t = *reinterpret_cast<const float2*>(row + 2 * lane);
    m[0] = t.x; m[1] = t.y;
  } else {
    m[0] = row[lane];
  }
}

// Records p0 + lane of document b (kEnd past the row or the batch).
__device__ __forceinline__ void load_window(const int2* __restrict__ rec,
                                            int b, int B, int P, int p0,
                                            int lane, int& wu, float& wv) {
  const int p = p0 + lane;
  const int2 r = (b < B && p < P) ? rec[static_cast<size_t>(b) * P + p]
                                  : make_int2(kEnd, 0);
  wu = r.x;
  wv = __int_as_float(r.y);
}

// A warp's documents: their current record (u, v) in registers (the same in
// every lane), the rest of its 32-record window across the lanes, and the
// next window already in flight.
template <int kDocs>
struct Cursor {
  int pos[kDocs], u[kDocs], wu[kDocs], nu[kDocs];
  float v[kDocs], wv[kDocs], nv[kDocs];

  __device__ __forceinline__ void start(const int2* __restrict__ rec, int b0,
                                        int B, int P, int lane) {
#pragma unroll
    for (int d = 0; d < kDocs; ++d) {
      pos[d] = 0;
      load_window(rec, b0 + d, B, P, 0, lane, wu[d], wv[d]);
      load_window(rec, b0 + d, B, P, 32, lane, nu[d], nv[d]);
      u[d] = __shfl_sync(kFull, wu[d], 0);
      v[d] = __shfl_sync(kFull, wv[d], 0);
    }
  }

  template <int d>
  __device__ __forceinline__ void advance(const int2* __restrict__ rec,
                                          int b0, int B, int P, int lane) {
    const int i = ++pos[d] & 31;
    if (i == 0) {
      wu[d] = nu[d];
      wv[d] = nv[d];
      load_window(rec, b0 + d, B, P, pos[d] + 32, lane, nu[d], nv[d]);
    }
    u[d] = __shfl_sync(kFull, wu[d], i);
    v[d] = __shfl_sync(kFull, wv[d], i);
  }
};

// The product a slot adds: v·m, or v·m² for kSquare.
template <bool kSq>
__device__ __forceinline__ float product(float v, float m) {
  return kSq ? __fmul_rn(v, __fmul_rn(m, m)) : __fmul_rn(v, m);
}

// Document d of the warp adds its records with u < hi, read from the staged
// chunk `buf` (rows c0..).  kTail: the records lie
// at or past uth (ES Region 2/3 split); else the head, where sims and rho12
// coincide and only sims (and counts) accumulate.
template <bool kCounts, bool kTail, bool kSq, int d, int kDocs, int kCpl>
__device__ __forceinline__ void walk_doc(
    const float* buf, int c0, int hi, const int2* __restrict__ rec, int b0,
    int B, int P, int lane, Cursor<kDocs>& cur, float thr,
    float (&acc)[kDocs][kCpl], float (&rho)[kDocs][kCpl],
    float (&yv)[kDocs][kCpl], int (&cnt)[kDocs][kCpl]) {
  constexpr int kKt = 32 * kCpl;
  while (cur.u[d] < hi) {
    float m[kCpl];
    load_cols<kCpl>(buf + (cur.u[d] - c0) * kKt, lane, m);
    const float v = cur.v[d];
    cur.template advance<d>(rec, b0, B, P, lane);
#pragma unroll
    for (int j = 0; j < kCpl; ++j) {
      const float c = product<kSq>(v, m[j]);
      acc[d][j] = __fadd_rn(acc[d][j], c);
      if constexpr (kTail) {
        const bool exact = m[j] >= thr;
        rho[d][j] = exact ? __fadd_rn(rho[d][j], c) : rho[d][j];
        yv[d][j] = exact ? yv[d][j] : __fadd_rn(yv[d][j], v);
        if (kCounts) cnt[d][j] += (exact && m[j] > 0.0f) ? 1 : 0;
      } else if (kCounts) {
        cnt[d][j] += m[j] > 0.0f ? 1 : 0;
      }
    }
  }
}

template <bool kCounts, bool kTail, bool kSq, int kDocs, int kCpl,
          int d = 0>
__device__ __forceinline__ void walk_chunk(
    const float* buf, int c0, int hi, const int2* __restrict__ rec, int b0,
    int B, int P, int lane, Cursor<kDocs>& cur,
    const float (&thr)[kDocs],
    float (&acc)[kDocs][kCpl], float (&rho)[kDocs][kCpl],
    float (&yv)[kDocs][kCpl], int (&cnt)[kDocs][kCpl]) {
  if constexpr (d < kDocs) {
    walk_doc<kCounts, kTail, kSq, d>(buf, c0, hi, rec, b0, B, P, lane, cur,
                                     thr[d], acc, rho, yv, cnt);
    walk_chunk<kCounts, kTail, kSq, kDocs, kCpl, d + 1>(
        buf, c0, hi, rec, b0, B, P, lane, cur, thr, acc, rho, yv, cnt);
  }
}

constexpr int kStages = 3;  // staged chunks in flight per block

// One block per (document tile, column slab): kWarps consumer warps (each
// kBt / kWarps documents) and one producer warp that stages the tile's
// distinct row segments, chunk by chunk, into a ring of kStages buffers.
template <int kMode, bool kCounts, int kBt, int kCpl, int kWarps>
__global__ void __launch_bounds__((kWarps + 1) * 32, kWarps <= 8 ? 2 : 1)
gather_tiled(const int* __restrict__ ids, const float* __restrict__ vals,
             const float* __restrict__ means_t, int B, int P, int D, int K,
             float t_th, float v_th, const float* __restrict__ v_ta,
             const int* __restrict__ uid, const int* __restrict__ ucount,
             const int* __restrict__ uth, const int2* __restrict__ rec,
             const int* __restrict__ walk, int cap, int vec,
             int slab_fastest,
             float* __restrict__ sims, float* __restrict__ rho12,
             float* __restrict__ y, int* __restrict__ counts) {
  constexpr bool kRegions = kMode == kEsicp || kMode == kTa;
  constexpr bool kSq = kMode == kSquare;
  static_assert(!(kSq && kCounts), "kSquare takes no counts");
  constexpr int kDocs = kBt / kWarps;
  constexpr int kKt = 32 * kCpl;
  constexpr int kRows = kBufFloats / kKt;
  static_assert(kBt % kWarps == 0 && kRows % 32 == 0, "tile shape");
  extern __shared__ __align__(128) float s_buf[];  // kStages x kBufFloats
  __shared__ unsigned long long s_full[kStages], s_empty[kStages];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = slab_fastest ? blockIdx.y : blockIdx.x;
  const int k0 = (slab_fastest ? blockIdx.x : blockIdx.y) * kKt;
  const int n_u = ucount[tile];
  const int n_chunks = (n_u + kRows - 1) / kRows;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&s_full[s], 1);
      mbar_init(&s_empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kWarps) {
    // The producer: chunk c's rows into buffer c % kStages once every
    // consumer warp has released it.
    const int* tuid = uid + static_cast<size_t>(tile) * cap;
    const int cols = min(kKt, K - k0);
    int next[kRows / 32];
#pragma unroll
    for (int i = 0; i < kRows / 32; ++i)
      next[i] = lane + 32 * i < n_u ? tuid[lane + 32 * i] : 0;
    for (int c = 0; c < n_chunks; ++c) {
      const int s = c % kStages;
      int id[kRows / 32];
#pragma unroll
      for (int i = 0; i < kRows / 32; ++i) {
        id[i] = next[i];
        const int u = (c + 1) * kRows + lane + 32 * i;
        next[i] = u < n_u ? tuid[u] : 0;  // the next chunk's, in flight
      }
      const int rows = min(kRows, n_u - c * kRows);
      mbar_wait(&s_empty[s], ((c / kStages) & 1) ^ 1);
      float* dst = s_buf + s * kBufFloats;
      if (vec) {
        if (lane == 0) mbar_arrive_tx(&s_full[s], rows * cols * 4);
        __syncwarp();
#pragma unroll
        for (int i = 0; i < kRows / 32; ++i) {
          const int r = lane + 32 * i;
          if (r < rows)
            bulk_copy(dst + r * kKt,
                      means_t + static_cast<size_t>(id[i]) * K + k0,
                      cols * 4, &s_full[s]);
        }
      } else {
        // Rows not 16-byte aligned: the warp copies them, then arrives.
#pragma unroll
        for (int i = 0; i < kRows / 32; ++i)
          for (int rr = 0; rr < 32; ++rr) {
            const int r = 32 * i + rr;
            const int row_id = __shfl_sync(kFull, id[i], rr);
            if (r >= rows) continue;
            const float* src = means_t + static_cast<size_t>(row_id) * K + k0;
            for (int j = lane; j < cols; j += 32) dst[r * kKt + j] = src[j];
          }
        __syncwarp();
        if (lane == 0) mbar_arrive(&s_full[s]);
      }
    }
    return;
  }

  const int u_th = kRegions ? uth[tile] : n_u;
  const int b0 = tile * kBt + warp * kDocs;  // the warp's first document
  float acc[kDocs][kCpl], rho[kDocs][kCpl], yv[kDocs][kCpl], thr[kDocs];
  int cnt[kDocs][kCpl];
  Cursor<kDocs> cur;
  cur.start(rec, b0, B, P, lane);
#pragma unroll
  for (int d = 0; d < kDocs; ++d) {
    thr[d] = kMode == kTa ? (b0 + d < B ? v_ta[b0 + d] : 0.0f) : v_th;
#pragma unroll
    for (int j = 0; j < kCpl; ++j) {
      acc[d][j] = 0.0f; rho[d][j] = 0.0f; yv[d][j] = 0.0f; cnt[d][j] = 0;
    }
  }

  bool crossed = false;
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % kStages;
    mbar_wait(&s_full[s], (c / kStages) & 1);
    const float* buf = s_buf + s * kBufFloats;
    const int c0 = c * kRows, c_end = min(n_u, c0 + kRows);
    if constexpr (kRegions) {
      const int h = min(c_end, u_th);
      if (h > c0)
        walk_chunk<kCounts, false, kSq>(buf, c0, h, rec, b0, B, P, lane,
                                        cur, thr, acc, rho, yv, cnt);
      if (c_end > u_th) {
        if (!crossed) {
#pragma unroll
          for (int d = 0; d < kDocs; ++d)
#pragma unroll
            for (int j = 0; j < kCpl; ++j) rho[d][j] = acc[d][j];
          crossed = true;
        }
        walk_chunk<kCounts, true, kSq>(buf, c0, c_end, rec, b0, B, P, lane,
                                       cur, thr, acc, rho, yv, cnt);
      }
    } else {
      walk_chunk<kCounts, false, kSq>(buf, c0, c_end, rec, b0, B, P, lane,
                                      cur, thr, acc, rho, yv, cnt);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&s_empty[s]);
  }
  if (kRegions && !crossed) {
#pragma unroll
    for (int d = 0; d < kDocs; ++d)
#pragma unroll
      for (int j = 0; j < kCpl; ++j) rho[d][j] = acc[d][j];
  }

  // The slots of a document from walk[b] on, slot by slot from L2: all of
  // them when its live ids do not ascend, else its trailing live id-0 slots.
#pragma unroll
  for (int d = 0; d < kDocs; ++d) {
    const int b = b0 + d;
    if (b >= B) continue;  // the same for the whole warp
    const size_t row = static_cast<size_t>(b) * P;
    for (int p = walk[b]; p < P; ++p) {
      const int id = ids[row + p];
      const float v = vals[row + p];
      if (!live_slot(id, v, D)) continue;
      const bool tail = static_cast<float>(id) >= t_th;
      const float* mrow = means_t + static_cast<size_t>(id) * K;
#pragma unroll
      for (int j = 0; j < kCpl; ++j) {
        const int k = k0 + lane_col<kCpl>(lane, j);
        if (k >= K) continue;
        const float m = __ldg(mrow + k);
        const float c = product<kSq>(v, m);
        acc[d][j] = __fadd_rn(acc[d][j], c);
        if constexpr (kRegions) {
          const bool exact = !tail || m >= thr[d];
          rho[d][j] = exact ? __fadd_rn(rho[d][j], c) : rho[d][j];
          yv[d][j] = exact ? yv[d][j] : __fadd_rn(yv[d][j], v);
          if (kCounts) cnt[d][j] += (exact && m > 0.0f) ? 1 : 0;
        } else if (kCounts) {
          cnt[d][j] += m > 0.0f ? 1 : 0;
        }
      }
    }
  }

#pragma unroll
  for (int d = 0; d < kDocs; ++d) {
    const int b = b0 + d;
    if (b >= B) continue;
    const size_t out = static_cast<size_t>(b) * K;
#pragma unroll
    for (int j = 0; j < kCpl; ++j) {
      const int k = k0 + lane_col<kCpl>(lane, j);
      if (k >= K) continue;
      sims[out + k] = acc[d][j];
      if (kRegions) { rho12[out + k] = rho[d][j]; y[out + k] = yv[d][j]; }
      if (kCounts) counts[out + k] = cnt[d][j];
    }
  }
}

struct Args {
  const int* ids;
  const float* vals;
  const float* means_t;
  int B, P, D, K;
  float t_th, v_th;
  const float* v_ta;
  float *sims, *rho12, *y;
  int* counts;
  void* scratch;
  cudaStream_t stream;
  int* blocks_per_sm;  // when set: the kernel's occupancy, and no launch
  int slab_fastest;    // grid order for the probe: slabs fastest, not tiles
};

template <int kMode, bool kCounts, int kBt, int kCpl, int kWarps>
int launch_tiled(const Args& a) {
  constexpr bool kRegions = kMode == kEsicp || kMode == kTa;
  constexpr int kKt = 32 * kCpl;
  constexpr int kSmem = kStages * kBufFloats * 4;
  auto kern = gather_tiled<kMode, kCounts, kBt, kCpl, kWarps>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  // The largest carveout, so two blocks' rings fit on an SM.
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && a.blocks_per_sm)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        a.blocks_per_sm, kern, (kWarps + 1) * 32, kSmem);
  if (err != cudaSuccess || a.blocks_per_sm) return static_cast<int>(err);
  const Layout L = plan_layout(a.B, a.P, a.D, kBt);
  const size_t slabs = (static_cast<size_t>(a.K) + kKt - 1) / kKt;
  if (slabs > 65535 || L.tiles > 0x7fffffffu || L.cap > 0x7fffffffu)
    return static_cast<int>(cudaErrorInvalidValue);
  char* base = static_cast<char*>(a.scratch);
  Plan p{reinterpret_cast<unsigned*>(base + L.bits),
         reinterpret_cast<int*>(base + L.wbase),
         reinterpret_cast<int*>(base + L.uid),
         reinterpret_cast<int*>(base + L.ucount),
         reinterpret_cast<int*>(base + L.uth),
         reinterpret_cast<int2*>(base + L.rec),
         reinterpret_cast<int*>(base + L.walk)};
  const int W = static_cast<int>(L.words);
  const int cap = static_cast<int>(L.cap);
  const int tiles = static_cast<int>(L.tiles);
  const float t_th = kRegions ? a.t_th : INFINITY;
  if (L.tiles * L.words)
    err = cudaMemsetAsync(p.bits, 0, L.tiles * L.words * 4, a.stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int plan_blocks = (a.B + kPlanWarps - 1) / kPlanWarps;
  plan_mark<<<plan_blocks, kPlanWarps * 32, 0, a.stream>>>(
      a.ids, a.vals, a.B, a.P, a.D, kBt, W, p.bits);
  plan_rank<<<tiles, kRankThreads, 0, a.stream>>>(p.bits, W, cap, t_th,
                                                  p.wbase, p.uid, p.ucount,
                                                  p.uth);
  plan_slots<<<plan_blocks, kPlanWarps * 32, 0, a.stream>>>(
      a.ids, a.vals, a.B, a.P, a.D, kBt, W, p.bits, p.wbase, p.rec,
      p.walk);
  const int vec = (a.K % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(a.means_t) % 16 == 0) ? 1 : 0;
  const dim3 grid = a.slab_fastest
                        ? dim3(static_cast<unsigned>(slabs), tiles)
                        : dim3(tiles, static_cast<unsigned>(slabs));
  if (a.slab_fastest && tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  kern<<<grid, (kWarps + 1) * 32, kSmem,
         a.stream>>>(a.ids, a.vals, a.means_t, a.B, a.P, a.D, a.K, t_th,
                     a.v_th, a.v_ta, p.uid, p.ucount, p.uth, p.rec,
                     p.walk, cap, vec, a.slab_fastest, a.sims, a.rho12,
                     a.y, a.counts);
  return static_cast<int>(cudaGetLastError());
}

// Tile settings: documents per tile kBt, columns per lane kCpl (slab
// Kt = 32·kCpl), consumer warps.  Seven consumer warps and the producer
// make 8 warps a block, two blocks an SM, and leave ptxas 128 registers a
// thread (nine warps would leave 96, and the ES modes spill).  Setting 0 is
// what the entry points launch untuned; the autotuner (repro_torch/tune)
// and scripts/gather_probe.py reach the others for sims, with counts (as
// the fits launch it) and without (as classify does), and for esicp with
// counts, the only way the fits launch it.  kSquare keeps no counts or
// regions, so its warps have registers for more documents: six a warp (42
// a tile) measured fastest against 28 × 256, 56 × 128 and 64 with 16
// warps (scripts/gather_probe.py), so it has setting 0 only.
template <int kMode, bool kCounts>
int launch_setting(int setting, const Args& a) {
  constexpr bool kRegions = kMode == kEsicp || kMode == kTa;
  if constexpr (kMode == kSquare) {
    if (setting == 0 && !kCounts)
      return launch_tiled<kMode, false, 42, 8, 7>(a);
  } else {
    if (setting == 0) {
      if constexpr (kRegions) return launch_tiled<kMode, kCounts, 14, 8, 7>(a);
      else return launch_tiled<kMode, kCounts, 28, 8, 7>(a);
    }
    if constexpr (kMode == kSims) {
      if (setting == 1) return launch_tiled<kMode, kCounts, 32, 8, 8>(a);
      if (setting == 2) return launch_tiled<kMode, kCounts, 64, 8, 16>(a);
      if (setting == 3) return launch_tiled<kMode, kCounts, 28, 4, 7>(a);
    }
    if constexpr (kMode == kEsicp && kCounts) {
      if (setting == 1) return launch_tiled<kMode, kCounts, 7, 8, 7>(a);
      if (setting == 2) return launch_tiled<kMode, kCounts, 16, 8, 8>(a);
      if (setting == 3) return launch_tiled<kMode, kCounts, 28, 4, 7>(a);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// kBt of launch_setting's instantiations.
int tile_docs(int mode, int setting) {
  static const int sims[] = {28, 32, 64, 28}, square[] = {42, -1, -1, -1},
                   es[] = {14, 7, 16, 28};
  if (setting < 0 || setting > 7) return -1;
  setting %= 4;
  if (mode == kSims) return sims[setting];
  if (mode == kSquare) return square[setting];
  if (mode == kEsicp || mode == kTa) return es[setting];
  return -1;
}

// Setting s + 4: tile setting s with the slabs fastest in the grid.
int dispatch(int mode, int setting, Args a) {
  const bool c = a.counts != nullptr;
  a.slab_fastest = setting >= 4;
  setting %= 4;
  switch (mode) {
    case kSims:
      return c ? launch_setting<kSims, true>(setting, a)
               : launch_setting<kSims, false>(setting, a);
    case kSquare:
      return c ? static_cast<int>(cudaErrorInvalidValue)
               : launch_setting<kSquare, false>(setting, a);
    case kEsicp:
      return c ? launch_setting<kEsicp, true>(setting, a)
               : launch_setting<kEsicp, false>(setting, a);
    case kTa:
      return c ? launch_setting<kTa, true>(setting, a)
               : launch_setting<kTa, false>(setting, a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Rows one launch of `mode` takes at tile setting `setting` in either grid
// order: with the slabs fastest the tiles lie on gridDim.y, at most 65,535
// of them.  -1 for an unknown setting.
extern "C" int gather_max_rows(int mode, int setting) {
  const int bt = tile_docs(mode, setting);
  return bt < 0 ? -1 : 65535 * bt;
}

// Documents per tile of `mode` (0 sims, 1 square, 2 esicp, 3 ta) at tile
// setting `setting`; -1 for an unknown setting.
extern "C" int gather_tile_docs(int mode, int setting) {
  return tile_docs(mode, setting);
}

// Bytes of scratch one launch of `mode` (0 sims, 1 square, 2 esicp, 3 ta)
// at tile setting `setting` needs for its plan; -1 for an unknown setting.
extern "C" long long gather_scratch_bytes(int B, int P, int D, int mode,
                                          int setting) {
  const int bt = tile_docs(mode, setting);
  if (bt < 0) return -1;
  return static_cast<long long>(plan_layout(B, P, D, bt).total);
}

// One launch of `mode` at tile setting `setting` (0 to 3, as above; 4 to 7:
// the same with the slabs fastest in the grid).  The entry points below
// launch setting 0; kernels/ops.py launches this one.
extern "C" int gather_setting_launch(int mode, int setting, const void* ids,
                                     const void* vals, const void* means_t,
                                     int B, int P, int D, int K, float t_th,
                                     float v_th, const void* v_ta,
                                     void* rho12, void* y, void* sims,
                                     void* counts, void* scratch,
                                     void* stream) {
  const Args a{static_cast<const int*>(ids), static_cast<const float*>(vals),
               static_cast<const float*>(means_t), B, P, D, K, t_th, v_th,
               static_cast<const float*>(v_ta), static_cast<float*>(sims),
               static_cast<float*>(rho12), static_cast<float*>(y),
               static_cast<int*>(counts), scratch,
               static_cast<cudaStream_t>(stream), nullptr};
  return dispatch(mode, setting, a);
}

// Blocks of the tiled kernel an SM holds at once for `mode` (with counts
// when `counts`) at tile setting `setting`; -1 on error.
extern "C" int gather_blocks_per_sm(int mode, int setting, int counts) {
  int n = 0;
  int one = 1;
  Args a{};
  a.counts = counts ? &one : nullptr;
  a.blocks_per_sm = &n;
  return dispatch(mode, setting, a) == 0 ? n : -1;
}

extern "C" int esicp_gather_launch(const void* ids, const void* vals,
                                   const void* means_t, int B, int P, int D,
                                   int K, float t_th, float v_th, void* rho12,
                                   void* y, void* sims, void* counts,
                                   void* scratch, void* stream) {
  return gather_setting_launch(kEsicp, 0, ids, vals, means_t, B, P, D, K,
                               t_th, v_th, nullptr, rho12, y, sims, counts,
                               scratch, stream);
}

extern "C" int esicp_gather_ta_launch(const void* ids, const void* vals,
                                      const void* means_t, int B, int P,
                                      int D, int K, float t_th,
                                      const void* v_ta, void* rho12, void* y,
                                      void* sims, void* counts, void* scratch,
                                      void* stream) {
  return gather_setting_launch(kTa, 0, ids, vals, means_t, B, P, D, K, t_th,
                               0.0f, v_ta, rho12, y, sims, counts, scratch,
                               stream);
}

extern "C" int sparse_sim_launch(const void* ids, const void* vals,
                                 const void* means_t, int B, int P, int D,
                                 int K, int square, void* sims, void* counts,
                                 void* scratch, void* stream) {
  return gather_setting_launch(square ? kSquare : kSims, 0, ids, vals,
                               means_t, B, P, D, K,
                               0.0f, 0.0f, nullptr, nullptr, nullptr, sims,
                               counts, scratch, stream);
}

extern "C" const char* gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
