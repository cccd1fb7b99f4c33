// sLSTM scan over time: the exponentially gated scalar LSTM of an xLSTM
// sLSTM layer (CUDA, sm_90a; kernels/slstm_scan.py).
//
// gates (B, S, 4D) float32 hold z | i | f | o along the last axis; the
// state (c, n, m) starts from c0, n0, m0 (B, D).  Per step, as the plain
// version (kernels/ref.py:slstm_scan) writes it:
//
//   m' = max(f + m, i)
//   c  = exp(f + m - m')·c + exp(i - m')·tanh(z)
//   n  = exp(f + m - m')·n + exp(i - m')
//   h  = (1 / (1 + exp(-o)))·c / max(n, 1)
//
// What bounded a thread a channel.  Each step depends on the one before
// only through three short chains: m' = max(f + m, i) (an add and a max)
// and c, n (a product and a sum each).  Everything else a step computes
// (tanh(z), three exponentials, i_e·tanh(z), two IEEE quotients: some 75
// instructions, the quotients with slow-path branches) feeds no later
// step, yet one thread a channel issued all of it in step order on one
// warp: 205 ns a step at xlstm-125m's prefill on an H100.
//
// The design.  A block holds the kChannels channels d0.. of one row b and
// splits the roles: warp 0 runs pass m and warp 1 pass c, n (the carried
// chains and nothing else, each on a scheduler of its own); the kWorkers
// other warps run everything else.  Time runs in tiles of kTile steps
// through rings of shared-memory slots, one block barrier a phase.  In
// phase p:
//
//   workers:  copy z, i, f of tile p + kAhead and o of tile p + kAhead - 3
//             (cp.async, kAhead phases before their first reader);
//             tile p - 1: i_e = exp(i - m'), f_e = exp(fm - m'),
//                         u = i_e·tanh(z)                   (stage ex)
//             tile p - 3: h = sig(o)·c / max(n, 1) -> hs    (stage out)
//   warp 0:   tile p:     fm = f + m, m = max(fm, i)        (pass m)
//   warp 1:   tile p - 2: c = f_e·c + u, n = f_e·n + i_e    (pass c, n)
//
// A chain reads its operands of a step in one or two shared loads (f, i;
// the packed (f_e, u, i_e)) and writes one packed store ((fm, m); (c, n)),
// its loads issued a block of steps ahead, so no load latency lies on the
// chain.  Twelve channels a block make 128 blocks of xlstm-125m's prefill
// (B 2, D 768) on the 132 SMs, where 32 made 48 and 16 made 96: the
// workers' arithmetic spreads over the most SMs.
//
// What bounds it now, read from cuts of this source (scripts/
// slstm_probe.py): the worker warps.  Their arithmetic alone and their
// gate copies alone each take about two thirds of the whole and overlap
// only in part; the chains alone take less, though still a few times the
// floor of their dependent operations alone.
//
// Scans of fewer than kWalkBelow steps, a decode step among them, launch
// a walk of a thread a channel instead (slstm_walk_kernel, below): the
// ring's prologue and epilogue cost more than such a walk.
//
// The backward (slstm_scan_bwd.cu, which includes this file) runs the
// same tiles once more in states mode (slstm_states_kernel): no o copies
// and no output quotient, the workers store the state after every step
// (m in stage ex, c and n in stage out) into c, n, m planes of B·S·D
// floats instead of hs.  The serving launch (slstm_scan_kernel) is the
// same code with that mode compiled out.
//
// Why one launch, and sequential.  A decode step is a launch of S = 1
// from the cached state, so a split into passes would triple its launches
// and send five (B, S, D) intermediates through device memory.  A parallel
// prefix over the chains would reassociate rounded sums.  Every product,
// sum, difference and quotient here is a rounded intrinsic (no contracted
// multiply-add) and exp/tanh are expf/tanhf, the functions torch's CUDA
// ops call, each in the plain version's order; only which thread computes
// a value, and when, differs from the plain loop, so the two agree bit for
// bit and a state carried across two launches equals one launch.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// kernels/slstm_scan.py holds these three numbers and kWalkBelow (below)
// as CHANNELS, WARPS, TILE and WALK_BELOW; a CPU test compares them.
constexpr int kChannels = 12;  // a block's channels, all of one row b
constexpr int kWarps = 12;     // warps 0 and 1 the chains, the rest workers
constexpr int kTile = 80;      // steps a tile

constexpr int kWorkers = kWarps - 2;
constexpr int kThreads = 32 * kWarps;
constexpr int kTC = kTile * kChannels;  // floats of one (step, channel) array
constexpr int kRows = kTC / 32;         // warp-wide rows of one array
constexpr int kUnroll = 8;              // a chain's steps a register block
static_assert(kChannels % 4 == 0 && kChannels <= 32, "channels a block");
static_assert(kWorkers > 0, "no worker warp");
static_assert(kTC % 32 == 0 && kTile % kUnroll == 0, "tile shape");

// The gates' copies are issued kAhead phases before their first reader
// (scripts/slstm_probe.py times 3 and 4 too).
constexpr int kAhead = 2;

// The rings, in floats, each slot [step][channel], the chains' operands
// packed so each is one shared load or store a step: z | i | f of
// kAhead + 2 tiles (copied in phase k - kAhead, read in k and k + 1), o of
// kAhead + 1 (copied in k + 3 - kAhead, read in k + 3), (fm, m) pairs of
// 2, (f_e, u, i_e, -) quads of 2, (c, n) pairs of 2.
constexpr int kZifSlots = kAhead + 2, kOSlots = kAhead + 1;
constexpr int kZif = 0;
constexpr int kO = kZif + kZifSlots * 3 * kTC;
constexpr int kFmM = kO + kOSlots * kTC;
constexpr int kEx = kFmM + 2 * 2 * kTC;
constexpr int kCn = kEx + 2 * 4 * kTC;
constexpr int kFloats = kCn + 2 * 2 * kTC;
constexpr size_t kSmemBytes = sizeof(float) * kFloats;
static_assert(kSmemBytes <= 232448, "above a block's shared memory");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 or 4 bytes global -> shared, zero-filled when !in.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(in ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(in ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Every group but the kAhead - 1 committed last has landed.
__device__ __forceinline__ void cp_async_wait_ahead() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 1) : "memory");
}

struct Tile {
  const float* g;  // gates of row b, channel d0
  float* h;        // hs (states mode: the c plane) of row b, channel d0
  size_t plane;    // states mode: floats from the c plane to the n plane
  int S, D, d0, n_tiles;
  bool vec;        // 16-byte copies: D % 4 == 0 and gates 16-byte aligned

  // Steps of tile k (0 outside the scan).
  __device__ __forceinline__ int steps(int k) const {
    return k < 0 || k >= n_tiles ? 0 : min(kTile, S - k * kTile);
  }
};

// Gates q0 .. q0 + nq - 1 of tile k into dst[q - q0][step][channel], 4
// bytes at a time, by the worker thread wt (D % 4 != 0 or gates off
// 16-byte alignment); steps past S and channels past D are zero-filled.
__device__ __forceinline__ void copy_gates4(const Tile& a, float* dst, int k,
                                            int q0, int nq, int wt) {
  const int t0 = k * kTile;
  const size_t row = static_cast<size_t>(4) * a.D;
  for (int e = wt; e < nq * kTC; e += kWorkers * 32) {
    const int q = e / kTC, r = e - q * kTC, t = r / kChannels,
              ch = r - t * kChannels;
    const bool in = t0 + t < a.S && a.d0 + ch < a.D;
    cp_async4(dst + e,
              in ? a.g + (t0 + t) * row + static_cast<size_t>(q0 + q) * a.D +
                       ch
                 : a.g,
              in);
  }
}

// The 16-byte copies of gates q0 .. q0 + kQ - 1 that worker thread wt
// issues for every tile, into [q - q0][step][channel] of a slot: the same
// offsets in each tile, so they are worked out once.
template <int kQ>
struct Copies16 {
  static constexpr int kChunks = kChannels / 4;  // of a (step, gate) row
  static constexpr int kItems = kQ * kTile * kChunks;
  static constexpr int kN = (kItems + kWorkers * 32 - 1) / (kWorkers * 32);
  int dst[kN];     // floats into the slot; -1: no item
  int step[kN];    // step within the tile; S for a chunk past D
  size_t src[kN];  // floats from the tile's first row of gates

  __device__ __forceinline__ Copies16(const Tile& a, int q0, int wt) {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const int e = wt + j * kWorkers * 32, per = kTile * kChunks;
      const int q = e / per, r = e - q * per, t = r / kChunks,
                c4 = r - t * kChunks;
      dst[j] = e < kItems ? q * kTC + t * kChannels + 4 * c4 : -1;
      step[j] = a.d0 + 4 * c4 < a.D ? t : a.S;
      src[j] = static_cast<size_t>(t) * 4 * a.D +
               static_cast<size_t>(q0 + q) * a.D + 4 * c4;
    }
  }

  __device__ __forceinline__ void issue(const Tile& a, float* slot,
                                        int k) const {
    const int t0 = k * kTile;
    const float* g = a.g + static_cast<size_t>(t0) * 4 * a.D;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      if (dst[j] < 0) continue;
      const bool in = t0 + step[j] < a.S;
      cp_async16(slot + dst[j], in ? g + src[j] : a.g, in);
    }
  }
};

// Rows of a tile a worker takes: w, w + kWorkers, ...  Its operands for
// all of them load first, so no load waits behind a store or a quotient's
// slow-path branch, and the rows' arithmetic can interleave.
constexpr int kPer = (kRows + kWorkers - 1) / kWorkers;

template <bool kFull>
__device__ __forceinline__ bool row_in(int r, int x, int n) {
  return (kRows % kWorkers == 0 || r < kRows) &&
         (kFull || x < n * kChannels);
}

__device__ __forceinline__ float2* pairs(float* smem, int base, int k) {
  return reinterpret_cast<float2*>(smem + base + (k & 1) * 2 * kTC);
}

__device__ __forceinline__ float4* quads(float* smem, int k) {
  return reinterpret_cast<float4*>(smem + kEx + (k & 1) * 4 * kTC);
}

// Where worker w's rows of a tile land in hs, the same in every tile:
// row j's offset from the tile's first step, or -1 past the rows or
// past D.
struct OutRows {
  int off[kPer];

  __device__ __forceinline__ OutRows(const Tile& a, int w, int lane) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int r = w + j * kWorkers, x = r * 32 + lane;
      const int t = x / kChannels, ch = x - t * kChannels;
      off[j] = r < kRows && a.d0 + ch < a.D ? t * a.D + ch : -1;
    }
  }
};

// Stage ex of tile k (steps < n), by worker w; in states mode it also
// stores m.
template <bool kFull, bool kStates>
__device__ __forceinline__ void stage_ex(const Tile& a, const OutRows& rows,
                                         float* smem, int k, int n, int w,
                                         int lane) {
  const float* z = smem + kZif + (k % kZifSlots) * 3 * kTC;
  const float* iv = z + kTC;
  const float2* fmm = pairs(smem, kFmM, k);
  float4* ex = quads(smem, k);
  float vz[kPer], vi[kPer];
  float2 vfm[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int r = w + j * kWorkers, x = r * 32 + lane;
    if (row_in<kFull>(r, x, n)) vz[j] = z[x], vi[j] = iv[x], vfm[j] = fmm[x];
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int r = w + j * kWorkers, x = r * 32 + lane;
    if (row_in<kFull>(r, x, n)) {
      const float m_new = vfm[j].y;
      const float i_e = expf(__fsub_rn(vi[j], m_new));
      const float f_e = expf(__fsub_rn(vfm[j].x, m_new));
      ex[x] = make_float4(f_e, __fmul_rn(i_e, tanhf(vz[j])), i_e, 0.0f);
      if (kStates && rows.off[j] >= 0)
        a.h[2 * a.plane + static_cast<size_t>(k) * kTile * a.D +
            rows.off[j]] = m_new;
    }
  }
}

// Stage out of tile k (steps < n), by worker w: h into hs.  Every row's
// exponential first, then its quotients, then the stores: the quotients'
// slow-path branches then split no exponential from the next, and no
// quotient sinks into a store's branch.  In states mode: c and n into
// their planes instead.
template <bool kFull, bool kStates>
__device__ __forceinline__ void stage_out(const Tile& a, const OutRows& rows,
                                          float* smem, int k, int n, int w,
                                          int lane) {
  const float2* cn = pairs(smem, kCn, k);
  if (kStates) {
    float* st = a.h + static_cast<size_t>(k) * kTile * a.D;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int r = w + j * kWorkers, x = r * 32 + lane;
      if (row_in<kFull>(r, x, n) && rows.off[j] >= 0) {
        const float2 v = cn[x];
        st[rows.off[j]] = v.x;
        st[a.plane + rows.off[j]] = v.y;
      }
    }
    return;
  }
  const float* o = smem + kO + (k % kOSlots) * kTC;
  float e[kPer], hv[kPer];
  float2 vcn[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int r = w + j * kWorkers, x = r * 32 + lane;
    e[j] = 0.0f, vcn[j] = make_float2(0.0f, 1.0f);
    if (row_in<kFull>(r, x, n)) e[j] = -o[x], vcn[j] = cn[x];
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) e[j] = expf(e[j]);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, e[j]));
    hv[j] = __fdiv_rn(__fmul_rn(sig, vcn[j].x), fmaxf(vcn[j].y, 1.0f));
    asm volatile("" ::"f"(hv[j]));
  }
  float* h = a.h + static_cast<size_t>(k) * kTile * a.D;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int r = w + j * kWorkers, x = r * 32 + lane;
    if (row_in<kFull>(r, x, n) && rows.off[j] >= 0) h[rows.off[j]] = hv[j];
  }
}

// step(t, load(t)) for t < kTile, each load issued a block of kUnroll
// steps before its step runs: the compiler cannot move a shared load
// above the chain's last store, so the block ahead keeps its latency off
// the chain.
template <typename Load, typename Step>
__device__ __forceinline__ void pipelined(Load load, Step step) {
  using V = decltype(load(0));
  V cur[kUnroll];
#pragma unroll
  for (int s = 0; s < kUnroll; ++s) cur[s] = load(s);
#pragma unroll
  for (int t0 = 0; t0 < kTile; t0 += kUnroll) {
    V nxt[kUnroll];
    if (t0 + kUnroll < kTile) {
#pragma unroll
      for (int s = 0; s < kUnroll; ++s) nxt[s] = load(t0 + kUnroll + s);
    }
#pragma unroll
    for (int s = 0; s < kUnroll; ++s) step(t0 + s, cur[s]);
    if (t0 + kUnroll < kTile) {
#pragma unroll
      for (int s = 0; s < kUnroll; ++s) cur[s] = nxt[s];
    }
  }
}

// Chain warp 0, pass m over tile k (n steps): fm = f + m, m = max(fm, i);
// lane ch's m carried in m.
template <bool kFull>
__device__ __forceinline__ void pass_m(float* smem, int k, int n, int ch,
                                       float& m) {
  const float* iv = smem + kZif + (k % kZifSlots) * 3 * kTC + kTC + ch;
  const float* fv = iv + kTC;
  float2* out = pairs(smem, kFmM, k) + ch;
  auto step = [&](int t, float2 fi) {
    const float fm = __fadd_rn(fi.x, m);
    m = fmaxf(fm, fi.y);
    out[t * kChannels] = make_float2(fm, m);
  };
  if (kFull) {
    pipelined([&](int t) {
      return make_float2(fv[t * kChannels], iv[t * kChannels]);
    }, step);
  } else {
    for (int t = 0; t < n; ++t)
      step(t, make_float2(fv[t * kChannels], iv[t * kChannels]));
  }
}

// Chain warp 1, pass c, n over tile k (n steps): c = f_e·c + u,
// n = f_e·n + i_e; lane ch's c and n carried in c, nn.
template <bool kFull>
__device__ __forceinline__ void pass_cn(float* smem, int k, int n, int ch,
                                        float& c, float& nn) {
  const float4* ex = quads(smem, k) + ch;
  float2* out = pairs(smem, kCn, k) + ch;
  auto step = [&](int t, float4 e) {
    c = __fadd_rn(__fmul_rn(e.x, c), e.y);
    nn = __fadd_rn(__fmul_rn(e.x, nn), e.z);
    out[t * kChannels] = make_float2(c, nn);
  };
  if (kFull) {
    pipelined([&](int t) { return ex[t * kChannels]; }, step);
  } else {
    for (int t = 0; t < n; ++t) step(t, ex[t * kChannels]);
  }
}

// The tiles of one block; in states mode hs is the (3, B, S, D) states
// scratch and the final state is not written.
template <bool kStates>
__device__ __forceinline__ void scan_tiles(
    const float* __restrict__ gates, const float* __restrict__ c0,
    const float* __restrict__ n0, const float* __restrict__ m0, int S, int D,
    int vec, float* __restrict__ hs, float* __restrict__ c_out,
    float* __restrict__ n_out, float* __restrict__ m_out) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y, d0 = blockIdx.x * kChannels;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Tile a;
  a.g = gates + static_cast<size_t>(b) * S * 4 * D + d0;
  a.h = hs + static_cast<size_t>(b) * S * D + d0;
  a.plane = static_cast<size_t>(gridDim.y) * S * D;
  a.S = S, a.D = D, a.d0 = d0, a.vec = vec != 0;
  a.n_tiles = (S + kTile - 1) / kTile;

  // A chain warp's lane ch < kChannels holds channel d0 + ch; its other
  // lanes only keep it company at the barriers.
  const int ch = lane;
  const bool live = ch < kChannels && d0 + ch < D;
  const size_t s_idx = static_cast<size_t>(b) * D + d0 + ch;
  float m = 0.0f, c = 0.0f, n = 0.0f;
  if (warp == 0 && live) m = m0[s_idx];
  if (warp == 1 && live) c = c0[s_idx], n = n0[s_idx];
  // A worker's index w and thread index wt among the workers, where its
  // rows land in hs and the gate copies it issues (unused by the chain
  // warps).
  const int w = warp - 2, wt = threadIdx.x - 64;
  const OutRows rows(a, w, lane);
  const Copies16<3> zif_copies(a, 0, wt);
  const Copies16<1> o_copies(a, 3, wt);

  for (int p = -kAhead; p <= a.n_tiles + 2; ++p) {
    // A chain warp's lanes past kChannels hold no channel: they only meet
    // the barriers.
    if (warp == 0 && lane < kChannels) {
      const int n_m = a.steps(p);
      if (n_m == kTile)
        pass_m<true>(smem, p, n_m, ch, m);
      else if (n_m)
        pass_m<false>(smem, p, n_m, ch, m);
    } else if (warp == 1 && lane < kChannels) {
      const int n_cn = a.steps(p - 2);
      if (n_cn == kTile)
        pass_cn<true>(smem, p - 2, n_cn, ch, c, n);
      else if (n_cn)
        pass_cn<false>(smem, p - 2, n_cn, ch, c, n);
    } else if (warp >= 2) {
      // states mode copies no o: tile -1 is empty
      const int kz = p + kAhead, ko = kStates ? -1 : p + kAhead - 3;
      float* zif = smem + kZif + (kz % kZifSlots) * 3 * kTC;
      float* o = smem + kO + (ko % kOSlots) * kTC;
      if (a.steps(kz)) {
        if (a.vec)
          zif_copies.issue(a, zif, kz);
        else
          copy_gates4(a, zif, kz, 0, 3, wt);
      }
      if (a.steps(ko)) {
        if (a.vec)
          o_copies.issue(a, o, ko);
        else
          copy_gates4(a, o, ko, 3, 1, wt);
      }
      cp_async_commit();
      const int ne = a.steps(p - 1), no = a.steps(p - 3);
      if (ne == kTile)
        stage_ex<true, kStates>(a, rows, smem, p - 1, ne, w, lane);
      else if (ne)
        stage_ex<false, kStates>(a, rows, smem, p - 1, ne, w, lane);
      if (no == kTile)
        stage_out<true, kStates>(a, rows, smem, p - 3, no, w, lane);
      else if (no)
        stage_out<false, kStates>(a, rows, smem, p - 3, no, w, lane);
      cp_async_wait_ahead();
    }
    __syncthreads();
  }
  if (!kStates && live) {
    if (warp == 0) m_out[s_idx] = m;
    if (warp == 1) c_out[s_idx] = c, n_out[s_idx] = n;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
slstm_scan_kernel(const float* __restrict__ gates,
                  const float* __restrict__ c0, const float* __restrict__ n0,
                  const float* __restrict__ m0, int S, int D, int vec,
                  float* __restrict__ hs, float* __restrict__ c_out,
                  float* __restrict__ n_out, float* __restrict__ m_out) {
  scan_tiles<false>(gates, c0, n0, m0, S, D, vec, hs, c_out, n_out, m_out);
}

// The backward's forward again: the state after every step into states
// (3, B, S, D) float32.
__global__ void __launch_bounds__(kThreads, 1)
slstm_states_kernel(const float* __restrict__ gates,
                    const float* __restrict__ c0,
                    const float* __restrict__ n0,
                    const float* __restrict__ m0, int S, int D, int vec,
                    float* __restrict__ states) {
  scan_tiles<true>(gates, c0, n0, m0, S, D, vec, states, nullptr, nullptr,
                   nullptr);
}

// Scans of fewer than kWalkBelow steps (a decode step is S = 1) skip the
// tiles, whose ring costs kAhead + 3 barriers and a copy's round trip
// before and after the first step: one thread per (b, d) channel walks t
// with its state in registers, a block one warp of 32 channels of a row,
// the gates of the next kWalkAhead steps loaded while the current ones
// compute.  The same operations in the same order as the tiles.
constexpr int kWalkBelow = 64;
constexpr int kWalkAhead = 16;

__device__ __forceinline__ void walk_load(const float* __restrict__ g,
                                          size_t row, int t0, int S, int D,
                                          float (&buf)[kWalkAhead][4]) {
#pragma unroll
  for (int u = 0; u < kWalkAhead; ++u) {
    if (t0 + u < S) {
      const float* p = g + static_cast<size_t>(t0 + u) * row;
#pragma unroll
      for (int q = 0; q < 4; ++q) buf[u][q] = p[static_cast<size_t>(q) * D];
    }
  }
}

__global__ void __launch_bounds__(32)
slstm_walk_kernel(const float* __restrict__ gates,
                  const float* __restrict__ c0, const float* __restrict__ n0,
                  const float* __restrict__ m0, int S, int D,
                  float* __restrict__ hs, float* __restrict__ c_out,
                  float* __restrict__ n_out, float* __restrict__ m_out) {
  const int d = blockIdx.x * 32 + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= D) return;
  const size_t row = static_cast<size_t>(4) * D;
  const float* g = gates + static_cast<size_t>(b) * S * row + d;
  float* h = hs + static_cast<size_t>(b) * S * D + d;
  const size_t s_idx = static_cast<size_t>(b) * D + d;
  float c = c0[s_idx], n = n0[s_idx], m = m0[s_idx];
  float cur[kWalkAhead][4], nxt[kWalkAhead][4];
  walk_load(g, row, 0, S, D, cur);
  for (int t0 = 0; t0 < S; t0 += kWalkAhead) {
    if (t0 + kWalkAhead < S) walk_load(g, row, t0 + kWalkAhead, S, D, nxt);
#pragma unroll
    for (int u = 0; u < kWalkAhead; ++u) {
      if (t0 + u < S) {
        const float z = cur[u][0], i = cur[u][1], f = cur[u][2],
                    o = cur[u][3];
        const float fm = __fadd_rn(f, m);
        const float m_new = fmaxf(fm, i);
        const float i_e = expf(__fsub_rn(i, m_new));
        const float f_e = expf(__fsub_rn(fm, m_new));
        c = __fadd_rn(__fmul_rn(f_e, c), __fmul_rn(i_e, tanhf(z)));
        n = __fadd_rn(__fmul_rn(f_e, n), i_e);
        const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-o)));
        h[static_cast<size_t>(t0 + u) * D] =
            __fdiv_rn(__fmul_rn(sig, c), fmaxf(n, 1.0f));
        m = m_new;
      }
    }
#pragma unroll
    for (int u = 0; u < kWalkAhead; ++u)
#pragma unroll
      for (int q = 0; q < 4; ++q) cur[u][q] = nxt[u][q];
  }
  c_out[s_idx] = c;
  n_out[s_idx] = n;
  m_out[s_idx] = m;
}

cudaError_t configure() {
  cudaError_t err = cudaFuncSetAttribute(
      slstm_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(slstm_states_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kSmemBytes));
}

}  // namespace

extern "C" int slstm_scan_launch(const void* gates, const void* c0,
                                 const void* n0, const void* m0, int B, int S,
                                 int D, void* hs, void* c, void* n, void* m,
                                 void* stream) {
  if (B > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S < kWalkBelow) {
    slstm_walk_kernel<<<dim3((D + 31) / 32, B), 32, 0, st>>>(
        static_cast<const float*>(gates), static_cast<const float*>(c0),
        static_cast<const float*>(n0), static_cast<const float*>(m0), S, D,
        static_cast<float*>(hs), static_cast<float*>(c),
        static_cast<float*>(n), static_cast<float*>(m));
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err = configure();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec =
      D % 4 == 0 && reinterpret_cast<std::uintptr_t>(gates) % 16 == 0;
  const dim3 grid((D + kChannels - 1) / kChannels, B);
  slstm_scan_kernel<<<grid, kThreads, kSmemBytes, st>>>(
      static_cast<const float*>(gates), static_cast<const float*>(c0),
      static_cast<const float*>(n0), static_cast<const float*>(m0), S, D, vec,
      static_cast<float*>(hs), static_cast<float*>(c), static_cast<float*>(n),
      static_cast<float*>(m));
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared bytes a block and blocks an SM.
extern "C" int slstm_scan_resources(int* smem_bytes, int* blocks_per_sm) {
  cudaError_t err = configure();
  *smem_bytes = static_cast<int>(kSmemBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, slstm_scan_kernel, kThreads, kSmemBytes);
  return static_cast<int>(err);
}

extern "C" const char* slstm_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
