// Backward of the sLSTM scan over time (CUDA, sm_90a;
// kernels/slstm_scan.py).
//
//   gates (B, S, 4D) z | i | f | o, the initial state c0, n0, m0 (B, D),
//   the output's adjoints dhs (B, S, D) and the final state's dc, dn, dm
//   (B, D), all float32
//     -> dgates (B, S, 4D), dc0, dn0, dm0 (B, D) float32
//
// The forward step (slstm_scan.cu, kernels/ref.py:slstm_scan) and, per
// step in reverse, its adjoints as the plain version
// (kernels/ref.py:slstm_scan_bwd) writes them, with w(a, b) = 1 if a > b,
// 1/2 if a == b, else 0 (JAX's rule for max, which repro differentiates):
//
//   fm = f + m;  m' = max(fm, i);  ie = exp(i - m');  fe = exp(fm - m')
//   u = tanh(z);  c' = fe·c + ie·u;  n' = fe·n + ie
//   sig = 1 / (1 + exp(-o));  den = max(n', 1);  h = sig·c' / den
//
//   gq = gh / den;  go = (gq·c')·sig·(1 - sig)
//   gc' += gq·sig;  gn' -= (gq·h)·w(n', 1)
//   gfe = gc'·c + gn'·n;  gie = gc'·u + gn';  gu = gc'·ie
//   gz = (gu + gu·u)·(1 - u);  ga = gfe·fe;  gb = gie·ie
//   gm' = gm' - ga - gb
//   gi = gb + gm'·w(i, fm);  gf = gm = ga + gm'·w(fm, i)
//   gc = gc'·fe;  gn = gn'·fe
//
// The n' == 1 tie is at step 0 of every prefill (from c = n = 0, m =
// -1e30: m' = i, n' = exp(0) = 1), so the half weight matters.
//
// What bounds it.  Its bytes: gates and dhs read, dgates written, 36·B·S·D
// (226 MB at B 2, S 4096, D 768: 0.068 ms at 3.35 TB/s), and the state
// after every step, 12·B·S·D bytes, written by the forward again and read
// back.  And 2·S dependent steps: S of the forward's chains, S of the
// adjoints'.  Those chains are short.  gc and gn: an add and a product
// each, independent of each other; gm: two differences, a product and a
// sum, fed by that step's gc' and gn' but feeding neither.  Everything
// else (tanh, three exponentials, three IEEE quotients, some 45 rounded
// operations a step) feeds no later step, yet a thread a channel (the
// first design, kept below as the walk for short scans) issued all of it
// in step order on 48 warps: 224 ns a step at xlstm-125m's shape.
//
// The design: two launches.
//
// 1. The forward again, slstm_scan.cu's tiles (chain warps for m and for
//    c, n, worker warps for the rest) in states mode: the state after
//    every step into the (3, B, S, D) scratch.
// 2. The adjoints (slstm_bwd_tiles_kernel): a block holds the kChannels
//    channels d0.. of one row b and walks tiles of kTile steps from the
//    last back to the first, through rings of shared-memory slots, one
//    block barrier a phase.  Warp 0 carries gc, gn, warp 1 gm, the
//    kWorkers other warps everything else.  In phase p (q counts the
//    tiles in the order they are taken, from the end of the scan):
//
//    copies:   gates, dhs, the states after each step and the state
//              before the tile, of tile p + kAhead: eleven tensor copies
//              (TMA) issued by one worker thread, landing on the slot's
//              mbarrier, which the workers wait on before stage 1
//    workers:  tile p:     fm, ie, fe, u, sig, den, h, gq, go (-> dgates),
//                          the chain operands gq·sig, (gq·h)·w(n', 1)
//                                                          (stage 1)
//              tile p - 2: gfe, gie, gu, gz (-> dgates), ga, gb (stage 2)
//              tile p - 4: gi, gf (-> dgates)              (stage 3)
//    warp 0:   tile p - 1: gc' = gc + gq·sig, gn' = gn - (gq·h)·w,
//                          gc = gc'·fe, gn = gn'·fe        (chain A)
//    warp 1:   tile p - 3: gm' = (gm - ga) - gb,
//                          gm = ga + gm'·w(fm, i)          (chain B)
//
//    A chain reads its operands of a step in one packed shared load, its
//    loads issued a block of steps ahead, and writes one packed store.
//    Twelve channels a block make 128 blocks of xlstm-125m's training
//    shape (B 2, D 768) on the 132 SMs, as in the forward; six workers
//    (four rows of a tile each) timed faster than four, eight, ten or
//    twelve, tiles of 64 steps faster than 32 or 48
//    (scripts/slstm_probe.py).  Issued by the workers as 16-byte
//    cp.async, the copies cost them two thirds of their arithmetic's time
//    even when they read nothing; the tensor copies cost them one thread's
//    eleven instructions.  Where D % 4 != 0 or an operand lies off
//    16-byte alignment the workers still copy, 4 bytes at a time.
//
// What bounds it, from cuts of this source (scripts/slstm_probe.py): the
// forward again (a third of the whole) and the adjoints' workers, whose
// arithmetic and the copies' memory traffic each take about half of the
// adjoints' launch alone and overlap little; the chains alone take about
// a third of it.
//
// Scans of fewer than kWalkBelow steps launch the walk of a thread a
// channel (slstm_bwd_walk_kernel): the forward into the scratch and back
// in one launch, cheaper there than two launches and their rings.
//
// Every product, sum, difference and quotient is a rounded intrinsic (no
// contracted multiply-add) and exp/tanh are expf/tanhf, in the plain
// version's order; only which thread computes a value, and when, differs
// from the plain loop, so the two agree bit for bit on the card, and
// adjoints carried across two launches equal one launch.
#include "slstm_scan.cu"

#include <cuda.h>

#include <cstddef>

namespace {
namespace bwd {

// kernels/slstm_scan.py holds these four numbers as BWD_CHANNELS,
// BWD_WARPS, BWD_TILE and BWD_WALK_BELOW; a CPU test compares them.
constexpr int kChannels = 12;  // a block's channels, all of one row b
constexpr int kWarps = 8;      // warps 0 and 1 the chains, the rest workers
constexpr int kTile = 64;      // steps a tile
constexpr int kWalkBelow = 64;

constexpr int kWorkers = kWarps - 2;
constexpr int kThreads = 32 * kWarps;
constexpr int kTC = kTile * kChannels;  // floats of one (step, channel) array
constexpr int kRows = kTC / 32;         // warp-wide rows of one array
constexpr int kPer = (kRows + kWorkers - 1) / kWorkers;  // rows a worker
constexpr int kUnroll = 8;              // a chain's steps a register block
constexpr int kAhead = 2;               // phases a tile's copy is issued ahead
static_assert(kChannels % 4 == 0 && kChannels <= 32, "channels a block");
static_assert(kWorkers > 0, "no worker warp");
static_assert(kTC % 32 == 0 && kTile % kUnroll == 0, "tile shape");

// The rings, in floats, each array [step][channel].  A copy slot holds
// z, i, f, o and dhs of the tile's steps, the c, n, m planes of the states
// after them and, in rows of 32 floats, the state before the tile's first
// step (kAhead + 1 slots: copied in phase q - kAhead, read by stage 1 in
// q).  Every array starts 128-byte aligned, as the tensor copies want
// (a tile of gates is 3,072 bytes at kTile 64, kChannels 12).  Then the
// quads (gq·sig, (gq·h)·w(n', 1), fe, w(fm, i)) of stage 1 (read by chain
// A in q + 1, stage 2 in q + 2: 3 slots), its quads (u, ie, c, n) (read
// by stage 2: 3 slots), chain A's (gc', gn') pairs (2 slots), stage 2's
// quads (ga, gb, w(fm, i), -) (read by chain B in q + 3, stage 3 in q + 4:
// 3 slots) and chain B's gm' (2 slots).
constexpr int kBefore = 8 * kTC;  // the state before, in a copy slot
constexpr int kCopySlot = kBefore + 3 * 32;
constexpr int kCopySlots = kAhead + 1;
constexpr int kCopy = 0;
constexpr int kQa = kCopy + kCopySlots * kCopySlot;
constexpr int kQu = kQa + 3 * 4 * kTC;
constexpr int kGa = kQu + 3 * 4 * kTC;
constexpr int kQb = kGa + 2 * 2 * kTC;
constexpr int kGm = kQb + 3 * 4 * kTC;
constexpr int kFloats = kGm + 2 * kTC;
// then one mbarrier (8 bytes) a copy slot
constexpr size_t kSmemBytes = sizeof(float) * kFloats + 8 * kCopySlots;
static_assert(kTC % 32 == 0 && kCopySlot % 32 == 0 && kQa % 32 == 0,
              "128-byte arrays");
static_assert(kSmemBytes <= 232448, "above a block's shared memory");
// Bytes of a tile's tensor copies: eight (step, channel) arrays and three
// rows of the state before.
constexpr unsigned kTileBytes = 4 * (8 * kTC + 3 * kChannels);

// The tensor maps of the 16-byte path (D % 4 == 0, operands 16-byte
// aligned): 2-D views (channels fastest, rows) of gates (4·D, B·S), dhs
// (D, B·S), the states (D, 3·B·S) in boxes of kChannels × kTile and in
// rows (the state before a tile), and the initial c0, n0, m0 (D, B) in
// rows.
struct Maps {
  CUtensorMap gates, dhs, after, before, c0, n0, m0;
};

__device__ __forceinline__ float wmax(float a, float b) {
  return a > b ? 1.0f : (a == b ? 0.5f : 0.0f);
}

// cp.async.wait_group for this kernel's kAhead.
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 1) : "memory");
}

// One arrival a phase: the copying thread's arrive.expect_tx.
__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(1u)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_done(unsigned bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Until the phase of parity `parity` of the mbarrier at bar completes: a
// copy that never lands stops the kernel with a trap, not a hang.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  for (int spins = 0; !mbar_done(bar, parity); ++spins) {
    if (spins > (1 << 24)) __trap();
    __nanosleep(32);
  }
}

// A box of the 2-D tensor map at (x, y) into dst, landing on bar.
__device__ __forceinline__ void tma_2d(float* dst, const CUtensorMap& map,
                                       int x, int y, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<unsigned long long>(&map)), "r"(x), "r"(y),
      "r"(bar)
      : "memory");
}

struct Tiles {
  const float* g;      // gates of row b, channel d0
  const float* gh;     // dhs of row b, channel d0
  const float* st;     // the c plane of states, row b, channel d0
  const float *c0, *n0, *m0;  // the initial state of row b, channel d0
  float* dg;           // dgates of row b, channel d0
  size_t plane;        // floats from one state plane to the next
  int S, D, d0, n_tiles;

  // Tile q in the order taken (q = 0 the scan's last) starts at step
  // t0(q) and holds steps(q) steps (0 outside the scan).
  __device__ __forceinline__ int t0(int q) const {
    return (n_tiles - 1 - q) * kTile;
  }
  __device__ __forceinline__ int steps(int q) const {
    return q < 0 || q >= n_tiles ? 0 : min(kTile, S - t0(q));
  }
};

// Tile q's copies into its slot, 4 bytes at a time by copying thread wt
// (the path for D % 4 != 0 or an operand off 16-byte alignment); steps
// past S and channels past D are zero-filled.  The items: the four gate
// planes and dhs over kTile rows, then the three state planes over kTile
// + 1 rows (row r the state after step t0 - 1 + r, row 0 of the first
// tile the initial state), row 0 into the state before.
__device__ __forceinline__ void copy_tile4(const Tiles& a, float* slot, int q,
                                           int wt) {
  constexpr int K = kChannels;  // copies of a (step, plane) row
  constexpr int kG = 5 * kTile * K, kSt = (kTile + 1) * K;
  constexpr int kItems = kG + 3 * kSt;
  const int t0 = a.t0(q);
  for (int e = wt; e < kItems; e += kWorkers * 32) {
    int dst, step, c;
    const float* src;
    if (e < kG) {
      const int pl = e / (kTile * K), r = e - pl * kTile * K, t = r / K;
      c = r - t * K;
      step = t0 + t;
      dst = pl * kTC + t * kChannels + c;
      src = pl < 4 ? a.g + static_cast<size_t>(step) * 4 * a.D +
                         static_cast<size_t>(pl) * a.D + c
                   : a.gh + static_cast<size_t>(step) * a.D + c;
    } else {
      const int e2 = e - kG, pl = e2 / kSt, r = e2 - pl * kSt, t = r / K;
      c = r - t * K;
      step = t0 - 1 + t;
      dst = t ? (5 + pl) * kTC + (t - 1) * kChannels + c
              : kBefore + 32 * pl + c;
      src = step < 0 ? (pl == 0 ? a.c0 : pl == 1 ? a.n0 : a.m0) + c
                     : a.st + pl * a.plane + static_cast<size_t>(step) * a.D +
                           c;
    }
    const bool in = step < a.S && a.d0 + c < a.D;
    cp_async4(slot + dst, in ? src : a.g, in);
  }
}

// Tile q's tensor copies into its slot, landing on the slot's mbarrier
// bar, issued by one thread: eight boxes of kChannels × kTile (rows past
// B·S and channels past the view zero-filled; a partial tile's rows past
// S and a partial group's channels past D are never read) and three rows
// of the state before.
__device__ __forceinline__ void tma_tile(const Tiles& a, const Maps& maps,
                                         float* slot, int q, int b, int B,
                                         unsigned bar) {
  const int t0 = a.t0(q), row = b * a.S + t0, rows = B * a.S;
  mbar_expect(bar, kTileBytes);
#pragma unroll
  for (int pl = 0; pl < 4; ++pl)
    tma_2d(slot + pl * kTC, maps.gates, pl * a.D + a.d0, row, bar);
  tma_2d(slot + 4 * kTC, maps.dhs, a.d0, row, bar);
#pragma unroll
  for (int pl = 0; pl < 3; ++pl) {
    tma_2d(slot + (5 + pl) * kTC, maps.after, a.d0, pl * rows + row, bar);
    if (t0)
      tma_2d(slot + kBefore + 32 * pl, maps.before, a.d0,
             pl * rows + row - 1, bar);
    else
      tma_2d(slot + kBefore + 32 * pl,
             pl == 0 ? maps.c0 : pl == 1 ? maps.n0 : maps.m0, a.d0, b, bar);
  }
}

template <bool kFull>
__device__ __forceinline__ bool row_in(int r, int x, int n) {
  return (kRows % kWorkers == 0 || r < kRows) &&
         (kFull || x < n * kChannels);
}

// Where worker w's rows of a tile land in dgates, the same in every tile:
// row j's offset from the tile's first step's z, or -1 past the rows or
// past D.
struct Rows {
  int off[kPer];

  __device__ __forceinline__ Rows(const Tiles& a, int w, int lane) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int r = w + j * kWorkers, x = r * 32 + lane;
      const int t = x / kChannels, ch = x - t * kChannels;
      off[j] = r < kRows && a.d0 + ch < a.D ? t * 4 * a.D + ch : -1;
    }
  }
};

__device__ __forceinline__ float4* quads(float* smem, int base, int q) {
  return reinterpret_cast<float4*>(smem + base + (q % 3) * 4 * kTC);
}

__device__ __forceinline__ float2* pairs(float* smem, int base, int q) {
  return reinterpret_cast<float2*>(smem + base + (q & 1) * 2 * kTC);
}

// Stage 1 of tile q (steps < n), by worker w: every row's loads, then its
// exponentials and tanh, then its quotients, then the rest and the
// stores, so the quotients' slow-path branches split no exponential from
// the next.
template <bool kFull>
__device__ __forceinline__ void stage1(const Tiles& a, const Rows& rows,
                                       float* smem, int q, int n, int w,
                                       int lane) {
  const float* slot = smem + kCopy + (q % kCopySlots) * kCopySlot;
  const float* st = slot + 5 * kTC;  // the states after, c | n | m
  const float* before = slot + kBefore;
  float4* qa = quads(smem, kQa, q);
  float4* qu = quads(smem, kQu, q);
  float vz[kPer], vi[kPer], vf[kPer], vo[kPer], vg[kPer], cp[kPer],
      np[kPer], mp[kPer], c1[kPer], n1[kPer], m1[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int r = w + j * kWorkers, x = r * 32 + lane;
    if (row_in<kFull>(r, x, n)) {
      vz[j] = slot[x], vi[j] = slot[kTC + x], vf[j] = slot[2 * kTC + x];
      vo[j] = slot[3 * kTC + x], vg[j] = slot[4 * kTC + x];
      // the state before step t: row t - 1 of the states after, or the
      // state before the tile
      const float* sp = x >= kChannels ? st + x - kChannels : before + x;
      const int pp = x >= kChannels ? kTC : 32;
      cp[j] = sp[0], np[j] = sp[pp], mp[j] = sp[2 * pp];
      c1[j] = st[x], n1[j] = st[kTC + x], m1[j] = st[2 * kTC + x];
    } else {
      vz[j] = vi[j] = vf[j] = vo[j] = vg[j] = cp[j] = np[j] = mp[j] = 0.0f;
      c1[j] = m1[j] = 0.0f, n1[j] = 1.0f;
    }
  }
  float fm[kPer], ie[kPer], fe[kPer], u[kPer], e[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    fm[j] = __fadd_rn(vf[j], mp[j]);
    ie[j] = expf(__fsub_rn(vi[j], m1[j]));
    fe[j] = expf(__fsub_rn(fm[j], m1[j]));
    u[j] = tanhf(vz[j]);
    e[j] = expf(-vo[j]);
  }
  float sig[kPer], h[kPer], gq[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const float den = fmaxf(n1[j], 1.0f);
    sig[j] = __fdiv_rn(1.0f, __fadd_rn(1.0f, e[j]));
    h[j] = __fdiv_rn(__fmul_rn(sig[j], c1[j]), den);
    gq[j] = __fdiv_rn(vg[j], den);
    asm volatile("" ::"f"(h[j]), "f"(gq[j]));
  }
  float* dg = a.dg + static_cast<size_t>(a.t0(q)) * 4 * a.D + 3 * a.D;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int r = w + j * kWorkers, x = r * 32 + lane;
    if (!row_in<kFull>(r, x, n)) continue;
    const float go = __fmul_rn(__fmul_rn(__fmul_rn(gq[j], c1[j]), sig[j]),
                               __fsub_rn(1.0f, sig[j]));
    qa[x] = make_float4(__fmul_rn(gq[j], sig[j]),
                        __fmul_rn(__fmul_rn(gq[j], h[j]), wmax(n1[j], 1.0f)),
                        fe[j], wmax(fm[j], vi[j]));
    qu[x] = make_float4(u[j], ie[j], cp[j], np[j]);
    if (rows.off[j] >= 0) dg[rows.off[j]] = go;
  }
}

// Stage 2 of tile q (steps < n), by worker w: gz into dgates, (ga, gb,
// w(fm, i)) for chain B.
template <bool kFull>
__device__ __forceinline__ void stage2(const Tiles& a, const Rows& rows,
                                       float* smem, int q, int n, int w,
                                       int lane) {
  const float4* qa = quads(smem, kQa, q);
  const float4* qu = quads(smem, kQu, q);
  const float2* ga = pairs(smem, kGa, q);
  float4* qb = quads(smem, kQb, q);
  float4 va[kPer], vu[kPer];
  float2 vg[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int r = w + j * kWorkers, x = r * 32 + lane;
    if (row_in<kFull>(r, x, n)) va[j] = qa[x], vu[j] = qu[x], vg[j] = ga[x];
  }
  float* dg = a.dg + static_cast<size_t>(a.t0(q)) * 4 * a.D;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int r = w + j * kWorkers, x = r * 32 + lane;
    if (!row_in<kFull>(r, x, n)) continue;
    const float gc1 = vg[j].x, gn1 = vg[j].y, fe = va[j].z, u = vu[j].x,
                ie = vu[j].y;
    const float gfe = __fadd_rn(__fmul_rn(gc1, vu[j].z),
                                __fmul_rn(gn1, vu[j].w));
    const float gie = __fadd_rn(__fmul_rn(gc1, u), gn1);
    const float gu = __fmul_rn(gc1, ie);
    const float gz = __fmul_rn(__fadd_rn(gu, __fmul_rn(gu, u)),
                               __fsub_rn(1.0f, u));
    qb[x] = make_float4(__fmul_rn(gfe, fe), __fmul_rn(gie, ie), va[j].w,
                        0.0f);
    if (rows.off[j] >= 0) dg[rows.off[j]] = gz;
  }
}

// Stage 3 of tile q (steps < n), by worker w: gi and gf into dgates.
// w(i, fm) = 1 - w(fm, i), exactly, for any fm and i but NaN.
template <bool kFull>
__device__ __forceinline__ void stage3(const Tiles& a, const Rows& rows,
                                       float* smem, int q, int n, int w,
                                       int lane) {
  const float4* qb = quads(smem, kQb, q);
  const float* gm = smem + kGm + (q & 1) * kTC;
  float4 vb[kPer];
  float vm[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int r = w + j * kWorkers, x = r * 32 + lane;
    if (row_in<kFull>(r, x, n)) vb[j] = qb[x], vm[j] = gm[x];
  }
  float* dg = a.dg + static_cast<size_t>(a.t0(q)) * 4 * a.D + a.D;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int r = w + j * kWorkers, x = r * 32 + lane;
    if (!row_in<kFull>(r, x, n) || rows.off[j] < 0) continue;
    const float wi = __fsub_rn(1.0f, vb[j].z);
    dg[rows.off[j]] = __fadd_rn(vb[j].y, __fmul_rn(vm[j], wi));
    dg[a.D + rows.off[j]] = __fadd_rn(vb[j].x, __fmul_rn(vm[j], vb[j].z));
  }
}

// step(t, load(t)) for t = kTile - 1 down to 0, each load issued a block
// of kUnroll steps before its step runs: the compiler cannot move a
// shared load above the chain's last store, so the block ahead keeps its
// latency off the chain.
template <typename Load, typename Step>
__device__ __forceinline__ void pipelined_back(Load load, Step step) {
  using V = decltype(load(0));
  V cur[kUnroll];
#pragma unroll
  for (int s = 0; s < kUnroll; ++s) cur[s] = load(kTile - 1 - s);
#pragma unroll
  for (int t0 = 0; t0 < kTile; t0 += kUnroll) {
    V nxt[kUnroll];
    if (t0 + kUnroll < kTile) {
#pragma unroll
      for (int s = 0; s < kUnroll; ++s)
        nxt[s] = load(kTile - 1 - (t0 + kUnroll + s));
    }
#pragma unroll
    for (int s = 0; s < kUnroll; ++s) step(kTile - 1 - (t0 + s), cur[s]);
    if (t0 + kUnroll < kTile) {
#pragma unroll
      for (int s = 0; s < kUnroll; ++s) cur[s] = nxt[s];
    }
  }
}

// Chain warp 0 over tile q (n steps), lane ch's gc and gn carried:
// gc' = gc + gq·sig, gn' = gn - (gq·h)·w(n', 1) -> (gc', gn');
// gc = gc'·fe, gn = gn'·fe.
template <bool kFull>
__device__ __forceinline__ void chain_a(float* smem, int q, int n, int ch,
                                        float& gc, float& gn) {
  const float4* in = quads(smem, kQa, q) + ch;
  float2* out = pairs(smem, kGa, q) + ch;
  auto step = [&](int t, float4 v) {
    const float gc1 = __fadd_rn(gc, v.x), gn1 = __fsub_rn(gn, v.y);
    out[t * kChannels] = make_float2(gc1, gn1);
    gc = __fmul_rn(gc1, v.z);
    gn = __fmul_rn(gn1, v.z);
  };
  if (kFull) {
    pipelined_back([&](int t) { return in[t * kChannels]; }, step);
  } else {
    for (int t = n - 1; t >= 0; --t) step(t, in[t * kChannels]);
  }
}

// Chain warp 1 over tile q (n steps), lane ch's gm carried:
// gm' = (gm - ga) - gb -> gm'; gm = ga + gm'·w(fm, i).
template <bool kFull>
__device__ __forceinline__ void chain_b(float* smem, int q, int n, int ch,
                                        float& gm) {
  const float4* in = quads(smem, kQb, q) + ch;
  float* out = smem + kGm + (q & 1) * kTC + ch;
  auto step = [&](int t, float4 v) {
    const float gm1 = __fsub_rn(__fsub_rn(gm, v.x), v.y);
    out[t * kChannels] = gm1;
    gm = __fadd_rn(v.x, __fmul_rn(gm1, v.z));
  };
  if (kFull) {
    pipelined_back([&](int t) { return in[t * kChannels]; }, step);
  } else {
    for (int t = n - 1; t >= 0; --t) step(t, in[t * kChannels]);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
slstm_bwd_tiles_kernel(const float* __restrict__ gates,
                       const float* __restrict__ c0,
                       const float* __restrict__ n0,
                       const float* __restrict__ m0,
                       const float* __restrict__ dhs,
                       const float* __restrict__ dc,
                       const float* __restrict__ dn,
                       const float* __restrict__ dm, int S, int D, int vec,
                       const float* __restrict__ states,
                       float* __restrict__ dgates, float* __restrict__ dc0,
                       float* __restrict__ dn0, float* __restrict__ dm0,
                       const __grid_constant__ Maps maps) {
  extern __shared__ __align__(128) float smem[];
  const int b = blockIdx.y, d0 = blockIdx.x * kChannels;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row = static_cast<size_t>(b) * D + d0;
  Tiles a;
  a.g = gates + static_cast<size_t>(b) * S * 4 * D + d0;
  a.gh = dhs + static_cast<size_t>(b) * S * D + d0;
  a.st = states + static_cast<size_t>(b) * S * D + d0;
  a.c0 = c0 + row, a.n0 = n0 + row, a.m0 = m0 + row;
  a.dg = dgates + static_cast<size_t>(b) * S * 4 * D + d0;
  a.plane = static_cast<size_t>(gridDim.y) * S * D;
  a.S = S, a.D = D, a.d0 = d0, a.n_tiles = (S + kTile - 1) / kTile;

  // A chain warp's lane ch < kChannels holds channel d0 + ch; its other
  // lanes only keep it company at the barriers.
  const int ch = lane;
  const bool live = ch < kChannels && d0 + ch < D;
  float gc = 0.0f, gn = 0.0f, gm = 0.0f;
  if (warp == 0 && live) gc = dc[row + ch], gn = dn[row + ch];
  if (warp == 1 && live) gm = dm[row + ch];
  // Warp 2 + w is worker w, its thread wt among the workers; worker
  // thread 0 issues the tensor copies.
  const int w = warp - 2, wt = threadIdx.x - 64;
  const Rows rows(a, w, lane);
  const unsigned bars = smem_addr(smem + kFloats);
  if (threadIdx.x == 0) {
    for (int k = 0; k < kCopySlots; ++k) mbar_init(bars + 8 * k);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  for (int p = -kAhead; p <= a.n_tiles + 3; ++p) {
    if (warp == 0 && lane < kChannels) {
      const int n_a = a.steps(p - 1);
      if (n_a == kTile)
        chain_a<true>(smem, p - 1, n_a, ch, gc, gn);
      else if (n_a)
        chain_a<false>(smem, p - 1, n_a, ch, gc, gn);
    } else if (warp == 1 && lane < kChannels) {
      const int n_b = a.steps(p - 3);
      if (n_b == kTile)
        chain_b<true>(smem, p - 3, n_b, ch, gm);
      else if (n_b)
        chain_b<false>(smem, p - 3, n_b, ch, gm);
    } else if (warp >= 2) {
      const int kq = p + kAhead;
      if (a.steps(kq)) {
        float* slot = smem + kCopy + (kq % kCopySlots) * kCopySlot;
        if (!vec)
          copy_tile4(a, slot, kq, wt);
        else if (wt == 0)
          tma_tile(a, maps, slot, kq, b, gridDim.y,
                   bars + 8 * (kq % kCopySlots));
      }
      cp_async_commit();
      const int n1 = a.steps(p), n2 = a.steps(p - 2), n3 = a.steps(p - 4);
      // tile p's tensor copies landed: its slot's use p / kCopySlots
      if (vec && a.steps(p))
        mbar_wait(bars + 8 * (p % kCopySlots), (p / kCopySlots) & 1);
      if (n1 == kTile)
        stage1<true>(a, rows, smem, p, n1, w, lane);
      else if (n1)
        stage1<false>(a, rows, smem, p, n1, w, lane);
      if (n2 == kTile)
        stage2<true>(a, rows, smem, p - 2, n2, w, lane);
      else if (n2)
        stage2<false>(a, rows, smem, p - 2, n2, w, lane);
      if (n3 == kTile)
        stage3<true>(a, rows, smem, p - 4, n3, w, lane);
      else if (n3)
        stage3<false>(a, rows, smem, p - 4, n3, w, lane);
      cp_async_wait();
    }
    __syncthreads();
  }
  if (live) {
    if (warp == 0) dc0[row + ch] = gc, dn0[row + ch] = gn;
    if (warp == 1) dm0[row + ch] = gm;
  }
}

// Scans of fewer than kWalkBelow steps: one thread a (b, d) channel, a
// block one warp of 32 channels of a row, walks forward, writing the
// state after every step to the scratch, then back in time, reading each
// step's gates, adjoint and the state before it (the state after it is
// the previous iteration's).  Neither pass's loads depend on its chains,
// so they are issued kWalkFwd (forward) or kWalkBack (backward) steps
// before their use, into registers (the scratch, which this kernel
// writes and then reads, is no __restrict__ pointer: no read of it may
// take the read-only path).
constexpr int kWalkFwd = 16;
constexpr int kWalkBack = 8;

// z, i, f of steps t0 .. t0 + kWalkFwd - 1 (those below S).
__device__ __forceinline__ void load_fwd(const float* __restrict__ g,
                                         size_t row, int D, int t0, int S,
                                         float (&buf)[kWalkFwd][3]) {
#pragma unroll
  for (int u = 0; u < kWalkFwd; ++u)
    if (t0 + u < S) {
      const float* gt = g + static_cast<size_t>(t0 + u) * row;
#pragma unroll
      for (int q = 0; q < 3; ++q) buf[u][q] = gt[static_cast<size_t>(q) * D];
    }
}

// Step t = base - u (u < kWalkBack, t >= 0): its gates z, i, f, o, its hs
// adjoint and the state (c, n, m) before it.
struct Back {
  float x[kWalkBack][8];
};

__device__ __forceinline__ void load_back(
    const float* __restrict__ g, const float* __restrict__ gh,
    const float* cs, const float* ns, const float* ms, float c0, float n0,
    float m0, size_t row,
    int D, int base, Back& buf) {
#pragma unroll
  for (int u = 0; u < kWalkBack; ++u) {
    const int t = base - u;
    if (t < 0) continue;
    const float* gt = g + static_cast<size_t>(t) * row;
#pragma unroll
    for (int q = 0; q < 4; ++q) buf.x[u][q] = gt[static_cast<size_t>(q) * D];
    buf.x[u][4] = gh[static_cast<size_t>(t) * D];
    if (t > 0) {
      const size_t at = static_cast<size_t>(t - 1) * D;
      buf.x[u][5] = cs[at];
      buf.x[u][6] = ns[at];
      buf.x[u][7] = ms[at];
    } else {
      buf.x[u][5] = c0;
      buf.x[u][6] = n0;
      buf.x[u][7] = m0;
    }
  }
}

__global__ void __launch_bounds__(32)
slstm_bwd_walk_kernel(const float* __restrict__ gates,
                      const float* __restrict__ c0,
                      const float* __restrict__ n0,
                      const float* __restrict__ m0,
                      const float* __restrict__ dhs,
                      const float* __restrict__ dc,
                      const float* __restrict__ dn,
                      const float* __restrict__ dm, int B, int S, int D,
                      float* states, float* __restrict__ dgates,
                      float* __restrict__ dc0, float* __restrict__ dn0,
                      float* __restrict__ dm0) {
  const int d = blockIdx.x * 32 + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= D) return;
  const size_t row = static_cast<size_t>(4) * D;
  const size_t plane = static_cast<size_t>(B) * S * D;
  const float* g = gates + static_cast<size_t>(b) * S * row + d;
  float* dg = dgates + static_cast<size_t>(b) * S * row + d;
  const float* gh = dhs + static_cast<size_t>(b) * S * D + d;
  float* cs = states + static_cast<size_t>(b) * S * D + d;
  float* ns = cs + plane;
  float* ms = ns + plane;
  const size_t s_idx = static_cast<size_t>(b) * D + d;
  const float c_0 = c0[s_idx], n_0 = n0[s_idx], m_0 = m0[s_idx];

  // Forward again: the state after every step.
  float c = c_0, n = n_0, m = m_0;
  float cur[kWalkFwd][3], nxt[kWalkFwd][3];
  load_fwd(g, row, D, 0, S, cur);
  for (int t0 = 0; t0 < S; t0 += kWalkFwd) {
    if (t0 + kWalkFwd < S) load_fwd(g, row, D, t0 + kWalkFwd, S, nxt);
#pragma unroll
    for (int u = 0; u < kWalkFwd; ++u) {
      if (t0 + u < S) {
        const float z = cur[u][0], i = cur[u][1], f = cur[u][2];
        const float fm = __fadd_rn(f, m);
        m = fmaxf(fm, i);
        const float ie = expf(__fsub_rn(i, m));
        const float fe = expf(__fsub_rn(fm, m));
        c = __fadd_rn(__fmul_rn(fe, c), __fmul_rn(ie, tanhf(z)));
        n = __fadd_rn(__fmul_rn(fe, n), ie);
        const size_t at = static_cast<size_t>(t0 + u) * D;
        cs[at] = c;
        ns[at] = n;
        ms[at] = m;
      }
    }
#pragma unroll
    for (int u = 0; u < kWalkFwd; ++u)
#pragma unroll
      for (int q = 0; q < 3; ++q) cur[u][q] = nxt[u][q];
  }

  // Backward in time; (c1, n1, m1) the state after step t.
  float gc = dc[s_idx], gn = dn[s_idx], gm = dm[s_idx];
  float c1 = c, n1 = n, m1 = m;
  Back bc, bn;
  load_back(g, gh, cs, ns, ms, c_0, n_0, m_0, row, D, S - 1, bc);
  for (int base = S - 1; base >= 0; base -= kWalkBack) {
    if (base - kWalkBack >= 0)
      load_back(g, gh, cs, ns, ms, c_0, n_0, m_0, row, D, base - kWalkBack,
                bn);
#pragma unroll
    for (int u = 0; u < kWalkBack; ++u) {
      const int t = base - u;
      if (t < 0) continue;
      const float z = bc.x[u][0], i = bc.x[u][1], f = bc.x[u][2],
                  o = bc.x[u][3], ght = bc.x[u][4], cp = bc.x[u][5],
                  np = bc.x[u][6], mp = bc.x[u][7];
      const float fm = __fadd_rn(f, mp);
      const float ie = expf(__fsub_rn(i, m1));
      const float fe = expf(__fsub_rn(fm, m1));
      const float uz = tanhf(z);
      const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-o)));
      const float den = fmaxf(n1, 1.0f);
      const float h = __fdiv_rn(__fmul_rn(sig, c1), den);

      const float gq = __fdiv_rn(ght, den);
      const float go = __fmul_rn(__fmul_rn(__fmul_rn(gq, c1), sig),
                                 __fsub_rn(1.0f, sig));
      const float gc1 = __fadd_rn(gc, __fmul_rn(gq, sig));
      const float gn1 = __fsub_rn(gn, __fmul_rn(__fmul_rn(gq, h),
                                                wmax(n1, 1.0f)));
      const float gfe = __fadd_rn(__fmul_rn(gc1, cp), __fmul_rn(gn1, np));
      const float gie = __fadd_rn(__fmul_rn(gc1, uz), gn1);
      const float gu = __fmul_rn(gc1, ie);
      const float gz = __fmul_rn(__fadd_rn(gu, __fmul_rn(gu, uz)),
                                 __fsub_rn(1.0f, uz));
      const float ga = __fmul_rn(gfe, fe);
      const float gb = __fmul_rn(gie, ie);
      const float gm1 = __fsub_rn(__fsub_rn(gm, ga), gb);
      const float gi = __fadd_rn(gb, __fmul_rn(gm1, wmax(i, fm)));
      const float gfm = __fadd_rn(ga, __fmul_rn(gm1, wmax(fm, i)));

      float* dgt = dg + static_cast<size_t>(t) * row;
      dgt[0] = gz;
      dgt[D] = gi;
      dgt[2 * D] = gfm;
      dgt[3 * D] = go;
      gc = __fmul_rn(gc1, fe);
      gn = __fmul_rn(gn1, fe);
      gm = gfm;
      c1 = cp;
      n1 = np;
      m1 = mp;
    }
    bc = bn;
  }
  dc0[s_idx] = gc;
  dn0[s_idx] = gn;
  dm0[s_idx] = gm;
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link to
// libcuda); null where the driver has none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// A float32 view of `rows` rows of `width` floats at base, in boxes of
// kChannels × box_rows.
bool tensor_map(EncodeTiled encode, CUtensorMap* map, const void* base,
                unsigned long long width, unsigned long long rows,
                unsigned box_rows) {
  const cuuint64_t dims[2] = {width, rows};
  const cuuint64_t strides[1] = {width * sizeof(float)};
  const cuuint32_t box[2] = {kChannels, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t configure() {
  return cudaFuncSetAttribute(slstm_bwd_tiles_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kSmemBytes));
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

}  // namespace bwd
}  // namespace

// states: 3·B·S·D float32 scratch, the state after every step (the
// forward's second launch, or the walk, writes it).
extern "C" int slstm_scan_bwd_launch(const void* gates, const void* c0,
                                     const void* n0, const void* m0,
                                     const void* dhs, const void* dc,
                                     const void* dn, const void* dm, int B,
                                     int S, int D, void* states, void* dgates,
                                     void* dc0, void* dn0, void* dm0,
                                     void* stream) {
  if (B < 1 || B > 65535 || S < 1 || D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *g = static_cast<const float*>(gates),
              *c = static_cast<const float*>(c0),
              *n = static_cast<const float*>(n0),
              *m = static_cast<const float*>(m0),
              *gh = static_cast<const float*>(dhs);
  float* sc = static_cast<float*>(states);
  if (S < bwd::kWalkBelow) {
    bwd::slstm_bwd_walk_kernel<<<dim3((D + 31) / 32, B), 32, 0, st>>>(
        g, c, n, m, gh, static_cast<const float*>(dc),
        static_cast<const float*>(dn), static_cast<const float*>(dm), B, S,
        D, sc, static_cast<float*>(dgates), static_cast<float*>(dc0),
        static_cast<float*>(dn0), static_cast<float*>(dm0));
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err = configure();
  if (err == cudaSuccess) err = bwd::configure();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int fvec = D % 4 == 0 && bwd::aligned16(gates);
  slstm_states_kernel<<<dim3((D + kChannels - 1) / kChannels, B), kThreads,
                        kSmemBytes, st>>>(g, c, n, m, S, D, fvec, sc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the tensor copies where D % 4 == 0 and every operand is 16-byte
  // aligned (a map's rows must be); else 4-byte copies
  int vec = D % 4 == 0 && bwd::aligned16(gates) && bwd::aligned16(dhs) &&
            bwd::aligned16(states) && bwd::aligned16(c0) &&
            bwd::aligned16(n0) && bwd::aligned16(m0);
  bwd::Maps maps = {};
  const bwd::EncodeTiled encode = vec ? bwd::encode_tiled() : nullptr;
  const unsigned long long rows = static_cast<unsigned long long>(B) * S;
  vec = encode && 3 * rows < (1ull << 31) &&
        bwd::tensor_map(encode, &maps.gates, gates, 4ull * D, rows,
                        bwd::kTile) &&
        bwd::tensor_map(encode, &maps.dhs, dhs, D, rows, bwd::kTile) &&
        bwd::tensor_map(encode, &maps.after, states, D, 3 * rows,
                        bwd::kTile) &&
        bwd::tensor_map(encode, &maps.before, states, D, 3 * rows, 1) &&
        bwd::tensor_map(encode, &maps.c0, c0, D, B, 1) &&
        bwd::tensor_map(encode, &maps.n0, n0, D, B, 1) &&
        bwd::tensor_map(encode, &maps.m0, m0, D, B, 1);
  bwd::slstm_bwd_tiles_kernel<<<
      dim3((D + bwd::kChannels - 1) / bwd::kChannels, B), bwd::kThreads,
      bwd::kSmemBytes, st>>>(
      g, c, n, m, gh, static_cast<const float*>(dc),
      static_cast<const float*>(dn), static_cast<const float*>(dm), S, D, vec,
      sc, static_cast<float*>(dgates), static_cast<float*>(dc0),
      static_cast<float*>(dn0), static_cast<float*>(dm0), maps);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared bytes a block and blocks an SM of the adjoints' tiles.
extern "C" int slstm_scan_bwd_resources(int* smem_bytes, int* blocks_per_sm) {
  cudaError_t err = bwd::configure();
  *smem_bytes = static_cast<int>(bwd::kSmemBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, bwd::slstm_bwd_tiles_kernel, bwd::kThreads,
        bwd::kSmemBytes);
  return static_cast<int>(err);
}

extern "C" const char* slstm_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
