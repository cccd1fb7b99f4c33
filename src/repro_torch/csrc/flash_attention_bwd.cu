// Backward of banded-causal flash attention on the tensor cores (CUDA,
// sm_90a; kernels/flash_attention.py).
//
//   q, dO (BH, Sq, hd), k, v (BH, Sk, hd), lse (BH, Sq) float32
//     -> dq (BH, Sq, hd), dk, dv (BH, Sk, hd) float32
//
// The gradient of the forward (flash_attention.cu) under its mask: key
// k_pos is live for query q_pos iff k_pos <= q_pos, q_pos - k_pos < window
// (window < 0: full causal) and k_pos < sk_real.  With s = q·kᵀ·scale and
// the forward's lse (+inf on a row with no live key), over the live pairs
//
//   P~ = exp(s - lse),  Z = rowsum(P~),  P = P~ / Z,  dP = dO·vᵀ
//   D = rowsum(P ∘ dP),  dS = P ∘ (dP - D)
//   dv = Pᵀ·dO,  dk = dSᵀ·q·scale,  dq = dS·k·scale
//
// and a pair that is not live adds nothing, so a row with no live key and
// a key at or past sk_real get zero gradient.  repro differentiates the
// jnp attention (models/layers.py:_attn_core) and has no backward Pallas
// kernel; this computes that function's gradient.  Z is 1 but for the
// rounding of the forward's lse, and D equals rowsum(dO ∘ o); taken from
// the forward, either carries the forward's rounding into every P and dS
// of the row (dq then came out 2.7× autograd's own float32 error).  Summed
// here from the same P~ and dP as dS (in double, each P~·dP exact there),
// they cancel as the softmax's own backward does: a row with one live key
// gets P = 1 and dS = 0 exactly.
//
// What bounds it.  10·hd operations a live pair (the two score products
// again, dv, dk, dq): at BH 8, S 4096, hd 256 full causal 1.72·10^11, 2.56
// ms in fp32 on the CUDA cores, 1.04 ms as split-TF32 on the tensor cores
// (three TF32 products for one fp32 one, 495 TFLOP/s), 0.24 ms at window
// 512; q, k, v, dO, lse read and dq, dk, dv written take 0.08 ms.  So
// operations.  Z and D need every score and dP of a row before any dS, so
// a design that keeps nothing of a pair in device memory computes the
// scores and dP two or three times (three: 18·hd a live pair).  This one
// computes them once and keeps P~ and dP of every live tile in a scratch:
// 8 bytes a pair written and read twice, 1.6 GB at gemma3's full causal
// shape (0.48 ms at 3.35 TB/s), against 4·hd·3 TF32 operations a pair
// saved (≈ 1.9 ms at the forward's rate).  Three launches, no atomics, so
// two runs give the same bits; their device ms on an H100 80GB HBM3 at
// 700 W (scripts/flash_bwd_probe.py, one profiled run) at (8, 4096, 256):
// full causal 2.22 + 2.58 + 1.02 of 5.83, 18% of the split-TF32 bound;
// window 512 0.65 + 0.71 + 0.32 of 1.71, 14%:
//
//   flash_bwd_scores: a block per (bh, 64 queries) walks the key tiles its
//     rows see: S = q·kᵀ (warps 0-3) and dP = dO·vᵀ (warps 4-7), a row
//     group of 16 each; P~ and dP of each (64 × 32) storage block to the
//     scratch, each row's Z and D~ = Σ P~·dP in double, then D = D~ / Z;
//   flash_bwd_kv: a block per (bh, 32 keys) walks the query tiles of 32
//     rows that see any of its keys, P~ and dP read back: dv += Pᵀ·dO
//     (warps of role 0), dk += dSᵀ·q (role 1);
//   flash_bwd_q: a block per (bh, 64 queries) walks its storage blocks:
//     dq += dS·k.
//
// 4·hd + 4·hd + 2·hd = 10·hd operations a live pair.  Every product runs
// as split-TF32 mma.sync m16n8k8, as the forward: each operand x is split
// into hi = rna_tf32(x) and lo = rna_tf32(x - hi), each product is lo·hi +
// hi·lo + hi·hi, small terms first.  The tensor cores add into their fp32
// accumulator with truncation, so no chain runs long: the scores' hi·hi
// terms per 16-dim chunk from zero, joined by compensated addition (the
// forward's code); dv, dk, dq in chains of 2 k-steps (16 rows) from zero,
// each added to the running sums with round-to-nearest (one chain over a
// tile of 4 k-steps left dv at 2.1× autograd's error on (2, 139, 64); a
// chain a k-step was 4% slower; chains summed a tile at a time before
// joining spilled at hd 128 and 256).  Held to autograd's float32 error
// (chip_smoke.py, tests/test_torch_cuda.py), three more things:
//   * dv splits dO in three TF32 parts, x = x1 + x2 + x3 exactly (one
//     product more): at window 1 every P is 1 and autograd's dv is dO
//     exactly, where hi + lo misses dO by up to 2^-22 of it;
//   * at hd 64 every operand is split in three parts (six products): two
//     left dq, dk at 1.5× autograd's error on (2, 200, 64) window 5, three
//     0.7–0.8×, for 24% more time at (48, 4096, 64);
//   * at hd 16 and 32 the sums are too short for the split to beat fp32:
//     the tensor cores' truncating adds left 2.0–3.6× autograd's error on
//     (1, 37, 16) window 8 whatever the split, and zero-padded to the
//     hd-64 instantiation 2.9–4.0×, so there every product runs in fp32
//     fused multiply-adds on the CUDA cores (no model of the registry has
//     such heads; the tests do).  A thread's 16 scores read its 2 rows and
//     8 keys once a 4-dim step (key rows hd + 4 apart, so the keys 2t
//     apart fall in different banks), and the kv and q launches form each
//     staged tile's P and dS once in shared memory before the products:
//     at (32, 4096, 32) full causal 2.17 + 2.26 + 1.50 of 5.96 ms (one
//     thread a score out of shared memory and P, dS formed at every use
//     took 17.3).
// P and dS come from P~, dP, Z and D by the same operations in both
// launches that need them, so they are the same numbers.
//
// Fragment layouts (g = lane / 4, t = lane % 4), as the forward's: the
// scores read q, dO, k, v rows as float4s (dims 4t..4t+3 of a 16-dim chunk
// serve two k-steps), row stride hd + 16; an A fragment over keys or
// queries takes columns 2t and 2t + 1 of an 8-wide k-step as its columns t
// and t + 4, so its B operand's rows are 2t and 2t + 1 (dO, q, k rows of
// stride hd + 4, float4 reads over four n-tiles whose output columns are
// permuted within groups of 32).  No bank conflict in any of them.
//
// The scratch: the storage blocks of each (bh, 64-query tile) over the
// 32-key tiles its rows see, in order, P~ (64 × 32) then dP; then D and Z
// of every row (flash_attention_bwd_scratch_floats).  A block's dead pairs
// (masked, rows past Sq, keys past Sk) hold P~ = 0.  A head takes 8 bytes
// a live pair and some, so under full causal attention its scratch grows
// as Sq²: 65 MB at S 4096, 1.08 GB at 16,384, 4.3 GB at 32,768.  The
// launches run over slices of as many heads as fit in 1 GiB
// (kScratchFloats), one head a slice where one alone needs more, so the
// scratch does not grow with the batch; a head's arithmetic is the same
// in any slice, so the results are the same bits.
//
// Shared memory at hd 256: scores 212,992 bytes (16-key tiles, q and dO
// staged), kv 152,064, q 108,032; at hd 256 the kv and q launches split the
// head dims over two warps a row group so an accumulator is 64 registers.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBQ = 64;               // queries of a storage block
constexpr int kGroups = kBQ / 16;     // its row groups of 16
constexpr int kBK = 32;               // keys of a storage block
constexpr int kBlock = kBQ * kBK;     // floats of P~ (and of dP) in a block
constexpr int kKvRows = 32;           // queries of a flash_bwd_kv tile
constexpr int kScoresThreads = 2 * 32 * kGroups;
constexpr unsigned kFull = 0xffffffffu;
// The most scratch the launches take unless one head needs more: 1 GiB.
constexpr long long kScratchFloats = 1LL << 28;

// Warps splitting the head dims in the kv and q launches: no accumulator
// wider than 128 columns (64 registers a thread).
template <int HD>
constexpr int kCS = HD > 128 ? HD / 128 : 1;

template <int HD>
constexpr int kKvThreads = 32 * 2 * 2 * kCS<HD>;   // roles × key groups

template <int HD>
constexpr int kQThreads = 32 * kGroups * kCS<HD>;

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// The 32-key storage blocks of query tile qt: [lo, lo + n).
struct Band {
  int lo, n;
};

__host__ __device__ inline Band key_blocks(int qt, int Sq, int sk_real,
                                           int window) {
  const int q0 = qt * kBQ;
  const int q_last = imin(q0 + kBQ, Sq) - 1;
  const int k_hi = imin(q_last, sk_real - 1);
  const int k_lo = window >= 0 ? imax(0, q0 - window + 1) : 0;
  if (k_hi < k_lo) return {0, 0};
  return {k_lo / kBK, k_hi / kBK - k_lo / kBK + 1};
}

__host__ __device__ inline long long blocks_before(int qt, int Sq,
                                                   int sk_real, int window) {
  long long n = 0;
  for (int t = 0; t < qt; ++t) n += key_blocks(t, Sq, sk_real, window).n;
  return n;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !full.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(full ? 16 : 0) : "memory");
}

// 4 bytes global -> shared, zero-filled when !full.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(full ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// x rounded to TF32, to nearest, ties away from zero (cvt.rna.tf32.f32).
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// c += a·b, one m16n8k8 TF32 product with fp32 accumulation.
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int N>
__device__ __forceinline__ void lds(const float* p, float (&x)[N]) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x; x[1] = v.y;
  }
}

// Barrier `id` (1..15) for `n` threads.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ bool live(int qp, int kp, int Sq, int sk_real,
                                     int window) {
  return qp < Sq && kp < sk_real && kp <= qp &&
         (window < 0 || qp - kp < window);
}

// P and dS of a pair from its P~, dP and its row's Z and D; the kv and q
// launches both call these, so both see the same numbers.
__device__ __forceinline__ float prob(float pt, float z) {
  return z > 0.f ? pt / z : 0.f;
}

__device__ __forceinline__ float dscore(float pt, float dp, float z,
                                        float d) {
  return prob(pt, z) * (dp - d);
}

// At hd 16 and 32 the tensor cores' truncating sums left dq, dk, dv
// 2.0-3.6× autograd's float32 error (1 × 37 × 16, window 8), so there
// every product runs in fp32 fused multiply-adds on the CUDA cores; at
// hd 64 every operand is split exactly in three TF32 parts; at 128 and
// 256 in two, dO in three for dv.
template <int HD>
constexpr bool kFma = HD <= 32;

template <int HD>
constexpr int kParts = HD <= 64 ? 3 : 2;

// k-steps of 8 rows in one tensor-core chain of dv, dk, dq.
constexpr int kChain = 2;

// x as kP TF32 parts: 2, x = hi + lo + O(2^-22 |x|); 3, x = x1 + x2 + x3
// exactly (x - x1 has at most 13 significant bits, x - x1 - x2 at most 2).
template <int kP>
__device__ __forceinline__ void split_n(float x, unsigned (&p)[kP]) {
  p[0] = tf32_rna(x);
  const float r = x - __uint_as_float(p[0]);
  p[1] = tf32_rna(r);
  if constexpr (kP == 3) p[2] = __float_as_uint(r - __uint_as_float(p[1]));
}

// c += a·b as TF32 products of the parts, small terms first: the terms
// down to 2^-22 of |a·b| (a kPA-part A fragment, B's two rows as kPB
// parts each).
template <int kPA, int kPB>
__device__ __forceinline__ void mma_parts(float (&c)[4],
                                          const unsigned (&a)[kPA][4],
                                          const unsigned (&b0)[kPB],
                                          const unsigned (&b1)[kPB]) {
  if constexpr (kPA == 3) mma(c, a[2], b0[0], b1[0]);
  if constexpr (kPB == 3) mma(c, a[0], b0[2], b1[2]);
  if constexpr (kPA == 3 && kPB == 3) mma(c, a[1], b0[1], b1[1]);
  mma(c, a[1], b0[0], b1[0]);
  mma(c, a[0], b0[1], b1[1]);
  mma(c, a[0], b0[0], b1[0]);
}

// The forward's score product: rows a (16 of them, a = row g, a + 8·kS row
// g + 8) times kNT·8 keys from b (key g of n-tile j at b + 8j·kS), both at
// dims 4t..: sb[j][e] = row g + 8(e / 2) · key 8j + 2t + e % 2, operands
// in kP parts, the leading terms per 16-dim chunk joined by compensated
// addition.
template <int HD, int kS, int kNT, int kP>
__device__ __forceinline__ void scores(const float* a, const float* b,
                                       float (&sb)[kNT][4]) {
  float ss[kNT][4], sc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sb[j][e] = ss[j][e] = sc[j][e] = 0.f;
#pragma unroll 2
  for (int c = 0; c < HD; c += 16) {
    float x0[4], x1[4];
    lds(a + c, x0);
    lds(a + 8 * kS + c, x1);
    // k-step s reads dims 4t + 2s and 4t + 2s + 1 of the chunk.
    unsigned af[2][kP][4];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float xs[4] = {x0[2 * s], x1[2 * s], x0[2 * s + 1],
                           x1[2 * s + 1]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        unsigned p[kP];
        split_n<kP>(xs[i], p);
#pragma unroll
        for (int m = 0; m < kP; ++m) af[s][m][i] = p[m];
      }
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      float y[4];
      lds(b + j * 8 * kS + c, y);
      unsigned bp[4][kP];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_n<kP>(y[e], bp[e]);
      float big[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const unsigned (&a)[kP][4] = af[s];
        const unsigned (&b0)[kP] = bp[2 * s];
        const unsigned (&b1)[kP] = bp[2 * s + 1];
        if constexpr (kP == 3) {
          mma(ss[j], a[2], b0[0], b1[0]);
          mma(ss[j], a[0], b0[2], b1[2]);
          mma(ss[j], a[1], b0[1], b1[1]);
        }
        mma(ss[j], a[1], b0[0], b1[0]);
        mma(ss[j], a[0], b0[1], b1[1]);
        mma(big, a[0], b0[0], b1[0]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float y2 = big[e] - sc[j][e];
        const float z = sb[j][e] + y2;
        sc[j][e] = (z - sb[j][e]) - y2;
        sb[j][e] = z;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sb[j][e] += ss[j][e] - sc[j][e];
}

// The same scores in fp32 on the CUDA cores, one fused multiply-add chain
// a score in dim order: a = row g (row g + 8 at a + 8·kS), b = key 0 of
// the tile.  A step of 4 dims reads the thread's 2 rows and 2·kNT keys
// once for its 4·kNT scores.
template <int HD, int kS, int kNT>
__device__ __forceinline__ void scores_fma(const float* a, const float* b,
                                           int t, float (&sb)[kNT][4]) {
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sb[j][e] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float x[2][4];
    lds(a + d, x[0]);
    lds(a + 8 * kS + d, x[1]);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      float y[2][4];
      lds(b + (8 * j + 2 * t) * kS + d, y[0]);
      lds(b + (8 * j + 2 * t + 1) * kS + d, y[1]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sb[j][e] = fmaf(x[e >> 1][i], y[e & 1][i], sb[j][e]);
    }
  }
}

// acc (C fragment layout of chain_product) += Σ_r A(r, row) · B[r][col]
// over r < 32 in fp32 fused multiply-adds, a tile's sums from zero: rows
// g and g + 8 (e / 2), columns of chain_product's permutation; a(r, m)
// gives A at reduction row r for the thread's row m.
template <int kW, int kSB, typename AFn>
__device__ __forceinline__ void tile_product_fma(float (&acc)[kW / 8][4],
                                                 AFn a, const float* b,
                                                 int t, int d0) {
  constexpr int kVN = kW >= 32 ? 4 : 2;
  float part[kW / 8][4];
#pragma unroll
  for (int n = 0; n < kW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll 2
  for (int r = 0; r < 32; ++r) {
    const float a0 = a(r, 0), a1 = a(r, 1);
#pragma unroll
    for (int grp = 0; grp < kW / 8 / kVN; ++grp) {
      float y[2][kVN];
      const float* row = b + r * kSB + d0 + grp * 8 * kVN + 2 * kVN * t;
      lds(row, y[0]);
      lds(row + kVN, y[1]);
#pragma unroll
      for (int x = 0; x < kVN; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          part[grp * kVN + x][e] =
              fmaf(e >> 1 ? a1 : a0, y[e & 1][x], part[grp * kVN + x][e]);
    }
  }
#pragma unroll
  for (int n = 0; n < kW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
}

// acc (16 rows × kW columns from d0, n-tiles of 8) += A · B over kChain
// k-steps of 8 reduction rows: A as kPA-part fragments a[kk], B rows 8kk +
// 2t and 8kk + 2t + 1 at br + 8kk·kSB (br = B + 2t·kSB + d0 + kVN·g),
// split in kPB parts.  The k-steps' products run from zero in one
// tensor-core chain and join acc by one rounded add.
template <int kW, int kSB, int kPA, int kPB>
__device__ __forceinline__ void chain_product(
    float (&acc)[kW / 8][4], const unsigned (&a)[kChain][kPA][4],
    const float* br) {
  constexpr int kVN = kW >= 32 ? 4 : 2;
#pragma unroll
  for (int grp = 0; grp < kW / 8 / kVN; ++grp) {
    float c[kVN][4];
#pragma unroll
    for (int x = 0; x < kVN; ++x)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[x][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kChain; ++kk) {
      float y0[kVN], y1[kVN];
      lds(br + 8 * kk * kSB + grp * 8 * kVN, y0);
      lds(br + (8 * kk + 1) * kSB + grp * 8 * kVN, y1);
#pragma unroll
      for (int x = 0; x < kVN; ++x) {
        unsigned b0[kPB], b1[kPB];
        split_n<kPB>(y0[x], b0);
        split_n<kPB>(y1[x], b1);
        mma_parts<kPA, kPB>(c[x], a[kk], b0, b1);
      }
    }
#pragma unroll
    for (int x = 0; x < kVN; ++x)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[grp * kVN + x][e] += c[x][e];
  }
}

// Rows g and g + 8 of acc (C fragments, the column permutation of
// chain_product) times `mul` to out rows r0 and r0 + 8 (skipped at or past
// n), columns from d0.
template <int HD, int kW>
__device__ __forceinline__ void store_rows(const float (&acc)[kW / 8][4],
                                           float* out, int r0, int n,
                                           int d0, int t, float mul) {
  constexpr int kVN = kW >= 32 ? 4 : 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= n) continue;
    float* orow = out + static_cast<size_t>(row) * HD + d0 + 2 * kVN * t;
#pragma unroll
    for (int grp = 0; grp < kW / 8 / kVN; ++grp) {
      float y[2 * kVN];
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int x = 0; x < kVN; ++x)
          y[kVN * e + x] = acc[grp * kVN + x][2 * r + e] * mul;
#pragma unroll
      for (int i = 0; i < 2 * kVN; i += 4)
        *reinterpret_cast<float4*>(orow + grp * 8 * kVN + i) =
            make_float4(y[i], y[i + 1], y[i + 2], y[i + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// flash_bwd_scores
// ---------------------------------------------------------------------------

template <int HD>
struct ScoresLayout {
  static constexpr int kKT = HD >= 256 ? 16 : 32;  // keys a tile
  static constexpr int kNT = kKT / 8;
  // The FMA path's keys 2t apart then fall in different banks.
  static constexpr int kS = kFma<HD> ? HD + 4 : HD % 32 == 0 ? HD + 16 : HD;
  static constexpr size_t kBytes =
      sizeof(float) * (2 * kBQ * kS + 4 * kKT * kS + kGroups * 16 * kKT);
};

template <int HD>
__global__ void __launch_bounds__(kScoresThreads, 1)
flash_bwd_scores(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, float* __restrict__ blocks,
                 float* __restrict__ delta, float* __restrict__ zsum,
                 int BH, int Sq, int Sk, int sk_real, int window, float scale,
                 long long per_bh) {
  static_assert(HD % 16 == 0 && HD <= 256, "hd must be a multiple of 16");
  using L = ScoresLayout<HD>;
  constexpr int kS = L::kS, kKT = L::kKT, kNT = L::kNT, kC4 = HD / 4;
  constexpr int kT = kScoresThreads;
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;                  // kBQ × kS
  float* s_do = s_q + kBQ * kS;       // kBQ × kS
  float* s_k = s_do + kBQ * kS;       // 2 stages of kKT × kS
  float* s_v = s_k + 2 * kKT * kS;    // 2 stages of kKT × kS
  float* s_x = s_v + 2 * kKT * kS;    // a row group's dP fragments

  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % BH;
  // The tiles of most keys first, so the long causal rows start early.
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / BH);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp % kGroups;
  const int role = warp / kGroups;  // 0: S = q·kᵀ, 1: dP = dO·vᵀ
  const size_t qoff = static_cast<size_t>(bh) * Sq;
  const size_t koff = static_cast<size_t>(bh) * Sk;
  const float* qb = q + qoff * HD;
  const float* dob = dout + qoff * HD;
  const float* kb = k + koff * HD;
  const float* vb = v + koff * HD;

  const Band band = key_blocks(qt, Sq, sk_real, window);
  float* blk0 = blocks + (static_cast<size_t>(bh) * per_bh +
                          blocks_before(qt, Sq, sk_real, window)) *
                             (2 * kBlock);
  const int key0 = band.lo * kBK;
  const int n_tiles = band.n * (kBK / kKT);

  for (int i = tid; i < kBQ * kC4; i += kT) {
    const int r = i / kC4, c = i - r * kC4;
    const bool in = q0 + r < Sq;
    const size_t off = in ? static_cast<size_t>(q0 + r) * HD + 4 * c : 0;
    cp_async16(s_q + r * kS + 4 * c, qb + off, in);
    cp_async16(s_do + r * kS + 4 * c, dob + off, in);
  }
  auto stage = [&](int it, int s) {
    const int k0 = key0 + it * kKT;
    for (int i = tid; i < kKT * kC4; i += kT) {
      const int r = i / kC4, c = i - r * kC4;
      const bool in = k0 + r < Sk;
      const size_t off = in ? static_cast<size_t>(k0 + r) * HD + 4 * c : 0;
      cp_async16(s_k + (s * kKT + r) * kS + 4 * c, kb + off, in);
      cp_async16(s_v + (s * kKT + r) * kS + 4 * c, vb + off, in);
    }
  };
  if (n_tiles > 0) stage(0, 0);
  cp_async_commit();

  // This thread's rows: qr and qr + 8 (C fragment rows g, g + 8).
  const int w0 = q0 + 16 * rg;
  const int qr = w0 + g;
  float lse_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    lse_r[r] = qr + 8 * r < Sq ? lse[qoff + qr + 8 * r] : 0.f;
  double z[2] = {0.0, 0.0}, dd[2] = {0.0, 0.0};
  const float* sa = (role == 0 ? s_q : s_do) + (16 * rg + g) * kS + 4 * t;
  float* xch = s_x + rg * 16 * kKT + lane;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile it visible; tile it - 1's readers are done
    if (it + 1 < n_tiles) stage(it + 1, (it + 1) & 1);
    cp_async_commit();
    const int k0 = key0 + it * kKT;
    // Rows g and g + 8 of this warp's half of the storage block.
    float* out = blk0 + static_cast<size_t>(it / (kBK / kKT)) * (2 * kBlock) +
                 role * kBlock + (16 * rg + g) * kBK + k0 % kBK + 2 * t;
    // No row of the row group sees a key of this tile: zeros.
    if (w0 >= Sq || k0 > imin(w0 + 15, sk_real - 1) ||
        (window >= 0 && w0 - (k0 + kKT - 1) >= window)) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        *reinterpret_cast<float2*>(out + 8 * j) = make_float2(0.f, 0.f);
        *reinterpret_cast<float2*>(out + 8 * kBK + 8 * j) =
            make_float2(0.f, 0.f);
      }
      continue;
    }
    const float* sb_tile = (role == 0 ? s_k : s_v) + (it & 1) * kKT * kS;
    float sb[kNT][4];
    if constexpr (kFma<HD>)
      scores_fma<HD, kS, kNT>(sa - 4 * t, sb_tile, t, sb);
    else
      scores<HD, kS, kNT, kParts<HD>>(sa, sb_tile + g * kS + 4 * t, sb);
    if (role == 1) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) xch[(4 * j + e) * 32] = sb[j][e];
        *reinterpret_cast<float2*>(out + 8 * j) =
            make_float2(sb[j][0], sb[j][1]);
        *reinterpret_cast<float2*>(out + 8 * kBK + 8 * j) =
            make_float2(sb[j][2], sb[j][3]);
      }
      bar_sync(1 + rg, 64);
      continue;
    }
    bar_sync(1 + rg, 64);
    // Element e of n-tile j: row qr + 8 (e / 2), key k0 + 8j + 2t + e % 2.
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = qr + 8 * (e >> 1);
        const int kp = k0 + 8 * j + 2 * t + (e & 1);
        const float dp = xch[(4 * j + e) * 32];
        const float p = live(qp, kp, Sq, sk_real, window)
                            ? expf(sb[j][e] * scale - lse_r[e >> 1]) : 0.f;
        z[e >> 1] += p;
        dd[e >> 1] += static_cast<double>(p) * static_cast<double>(dp);
        sb[j][e] = p;
      }
      *reinterpret_cast<float2*>(out + 8 * j) =
          make_float2(sb[j][0], sb[j][1]);
      *reinterpret_cast<float2*>(out + 8 * kBK + 8 * j) =
          make_float2(sb[j][2], sb[j][3]);
    }
  }
  cp_async_wait_all();  // a block with no tile never waited for its copies

  if (role == 0) {
    // The quad's 4 lanes hold a row's sums: a fixed shuffle tree.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      z[r] += __shfl_xor_sync(kFull, z[r], 1);
      z[r] += __shfl_xor_sync(kFull, z[r], 2);
      dd[r] += __shfl_xor_sync(kFull, dd[r], 1);
      dd[r] += __shfl_xor_sync(kFull, dd[r], 2);
      const int qp = qr + 8 * r;
      if (t == 0 && qp < Sq) {
        zsum[qoff + qp] = static_cast<float>(z[r]);
        delta[qoff + qp] = z[r] > 0.0 ? static_cast<float>(dd[r] / z[r]) : 0.f;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// flash_bwd_kv
// ---------------------------------------------------------------------------

template <int HD>
struct KvLayout {
  static constexpr int kS = HD + 4;     // q and dO rows
  static constexpr int kSP = kBK + 4;   // P~ and dP rows
  // q, dO, P~, dP, Z, D of kKvRows queries
  static constexpr int kStage = 2 * kKvRows * kS + 2 * kKvRows * kSP +
                                2 * kKvRows;
  static constexpr size_t kBytes = sizeof(float) * 2 * kStage;
};

// dk, dv of keys k0 .. k0 + 31 of row bh.
template <int HD>
__global__ void __launch_bounds__(kKvThreads<HD>, 1)
flash_bwd_kv(const float* __restrict__ q, const float* __restrict__ dout,
             const float* __restrict__ blocks,
             const float* __restrict__ delta, const float* __restrict__ zsum,
             float* __restrict__ dk, float* __restrict__ dv, int BH, int Sq,
             int Sk, int sk_real, int window, float scale,
             long long per_bh) {
  using L = KvLayout<HD>;
  constexpr int kS = L::kS, kSP = L::kSP, kStage = L::kStage;
  constexpr int kW = HD / kCS<HD>, kVN = kW >= 32 ? 4 : 2, kC4 = HD / 4;
  constexpr int kT = kKvThreads<HD>, kPA = kParts<HD>;
  extern __shared__ __align__(16) float smem[];

  const int bh = blockIdx.x % BH;
  // Ascending: the key tiles that most queries see first.
  const int kt = static_cast<int>(blockIdx.x / BH);
  const int k0 = kt * kBK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int cs = warp % kCS<HD>;
  const int kg = (warp / kCS<HD>) % 2;
  const int role = warp / (2 * kCS<HD>);  // 0: dv = Pᵀ·dO, 1: dk = dSᵀ·q
  const int d0 = cs * kW;
  const int kbase = k0 + 16 * kg;         // the warp's first key
  const size_t qoff = static_cast<size_t>(bh) * Sq;
  const float* qb = q + qoff * HD;
  const float* dob = dout + qoff * HD;

  // Query rows that see a key of the tile: [k0, q_hi], in tiles of kKvRows.
  const int k_last = imin(k0 + kBK, sk_real) - 1;
  const int q_hi = window == 0 ? -1
                   : window > 0 ? imin(Sq - 1, k_last + window - 1)
                                : Sq - 1;
  const int s_lo = k0 / kKvRows;
  const int n_tiles = k_last >= k0 && q_hi >= k0 ? q_hi / kKvRows - s_lo + 1
                                                 : 0;

  // The storage block of the staged tile: its query tile's first block.
  int st_qt = s_lo * kKvRows / kBQ;
  long long st_off =
      n_tiles > 0 ? blocks_before(st_qt, Sq, sk_real, window) : 0;
  auto stage = [&](int it, int s) {
    const int row0 = (s_lo + it) * kKvRows;
    const int qt = row0 / kBQ;
    for (; st_qt < qt; ++st_qt)
      st_off += key_blocks(st_qt, Sq, sk_real, window).n;
    const int lo = key_blocks(qt, Sq, sk_real, window).lo;
    const float* blk =
        blocks + (static_cast<size_t>(bh) * per_bh + st_off + (kt - lo)) *
                     (2 * kBlock) + (row0 - qt * kBQ) * kBK;
    float* dst = smem + s * kStage;
    for (int i = tid; i < kKvRows * kC4; i += kT) {
      const int r = i / kC4, c = i - r * kC4;
      const bool in = row0 + r < Sq;
      const size_t off = in ? static_cast<size_t>(row0 + r) * HD + 4 * c : 0;
      cp_async16(dst + r * kS + 4 * c, qb + off, in);
      cp_async16(dst + (kKvRows + r) * kS + 4 * c, dob + off, in);
    }
    float* dp_ = dst + 2 * kKvRows * kS;
    for (int i = tid; i < 2 * kKvRows * (kBK / 4); i += kT) {
      const int m = i / (kKvRows * (kBK / 4));
      const int rem = i - m * (kKvRows * (kBK / 4));
      const int r = rem / (kBK / 4), c = rem % (kBK / 4);
      cp_async16(dp_ + (m * kKvRows + r) * kSP + 4 * c,
                 blk + m * kBlock + r * kBK + 4 * c, true);
    }
    float* zd = dp_ + 2 * kKvRows * kSP;
    for (int i = tid; i < 2 * kKvRows; i += kT) {
      const int r = i % kKvRows;
      const bool in = row0 + r < Sq;
      const float* src = i < kKvRows ? zsum : delta;
      cp_async4(zd + i, src + qoff + (in ? row0 + r : 0), in);
    }
  };
  if (n_tiles > 0) stage(0, 0);
  cp_async_commit();

  float acc[kW / 8][4];
#pragma unroll
  for (int n = 0; n < kW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile it visible; tile it - 1's readers are done
    if (it + 1 < n_tiles) stage(it + 1, (it + 1) & 1);
    cp_async_commit();
    const int row0 = (s_lo + it) * kKvRows;
    float* st = smem + (it & 1) * kStage;
    float* pt = st + 2 * kKvRows * kS;
    float* dp = pt + kKvRows * kSP;
    const float* zz = dp + kKvRows * kSP;
    const float* dd = zz + kKvRows;
    if constexpr (kFma<HD>) {
      // P and dS of the tile in place, each once.
      for (int i = tid; i < kKvRows * kBK; i += kT) {
        const int r = i / kBK, c = r * kSP + i % kBK;
        const float p = prob(pt[c], zz[r]);
        dp[c] = p * (dp[c] - dd[r]);
        pt[c] = p;
      }
      __syncthreads();
    }
    // No query of the tile sees a key of the warp's 16.
    if (row0 >= Sq || kbase >= sk_real || kbase > row0 + kKvRows - 1 ||
        (window >= 0 && row0 - (kbase + 15) >= window))
      continue;
    // A = Pᵀ or dSᵀ: k-step kk takes queries 8kk + 2t (cols t) and 8kk +
    // 2t + 1 (cols t + 4), keys 16kg + g and + 8 (rows g, g + 8); B = dO
    // or q.
    const int key = 16 * kg + g;
    const float* b = st + (role == 0 ? kKvRows * kS : 0);
    if constexpr (kFma<HD>) {
      const float* pa = role == 0 ? pt : dp;
      auto afn = [&](int r, int m) { return pa[r * kSP + key + 8 * m]; };
      tile_product_fma<kW, kS>(acc, afn, b, t, d0);
    } else {
      const float* br = b + 2 * t * kS + d0 + kVN * g;
#pragma unroll 1
      for (int ks = 0; ks < 4; ks += kChain) {
        unsigned a[kChain][kPA][4];
#pragma unroll
        for (int kk = 0; kk < kChain; ++kk)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 8 * (ks + kk) + 2 * t + h;
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              const int c = r * kSP + key + 8 * m;
              unsigned p[kPA];
              split_n<kPA>(role == 0 ? prob(pt[c], zz[r])
                                     : dscore(pt[c], dp[c], zz[r], dd[r]),
                           p);
#pragma unroll
              for (int i = 0; i < kPA; ++i) a[kk][i][2 * h + m] = p[i];
            }
          }
        // dO in 3 parts, exactly: a key whose one query has P = 1 gets dv
        // = that query's dO, as autograd's.
        if (role == 0)
          chain_product<kW, kS, kPA, 3>(acc, a, br + 8 * ks * kS);
        else
          chain_product<kW, kS, kPA, kPA>(acc, a, br + 8 * ks * kS);
      }
    }
  }
  cp_async_wait_all();  // a block with no tile never waited for its copies

  float* out = (role == 0 ? dv : dk) + static_cast<size_t>(bh) * Sk * HD;
  store_rows<HD, kW>(acc, out, kbase + g, Sk, d0, t, role == 0 ? 1.f : scale);
}

// ---------------------------------------------------------------------------
// flash_bwd_q
// ---------------------------------------------------------------------------

template <int HD>
struct QLayout {
  static constexpr int kS = HD + 4;     // k rows
  static constexpr int kSP = kBK + 8;   // P~ and dP rows
  static constexpr int kStage = kBK * kS + 2 * kBQ * kSP;
  static constexpr size_t kBytes = sizeof(float) * (2 * kStage + 2 * kBQ);
};

// dq of queries q0 .. q0 + 63 of row bh.
template <int HD>
__global__ void __launch_bounds__(kQThreads<HD>, 1)
flash_bwd_q(const float* __restrict__ k, const float* __restrict__ blocks,
            const float* __restrict__ delta, const float* __restrict__ zsum,
            float* __restrict__ dq, int BH, int Sq, int Sk, int sk_real,
            int window, float scale, long long per_bh) {
  using L = QLayout<HD>;
  constexpr int kS = L::kS, kSP = L::kSP, kStage = L::kStage;
  constexpr int kW = HD / kCS<HD>, kVN = kW >= 32 ? 4 : 2, kC4 = HD / 4;
  constexpr int kT = kQThreads<HD>, kPA = kParts<HD>;
  extern __shared__ __align__(16) float smem[];
  float* s_z = smem + 2 * kStage;
  float* s_d = s_z + kBQ;

  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % BH;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / BH);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp % kGroups, cs = warp / kGroups;
  const int d0 = cs * kW;
  const size_t qoff = static_cast<size_t>(bh) * Sq;
  const float* kb = k + static_cast<size_t>(bh) * Sk * HD;

  const Band band = key_blocks(qt, Sq, sk_real, window);
  const float* blk0 = blocks + (static_cast<size_t>(bh) * per_bh +
                                blocks_before(qt, Sq, sk_real, window)) *
                                   (2 * kBlock);
  for (int i = tid; i < kBQ; i += kT) {
    const bool in = q0 + i < Sq;
    s_z[i] = in ? zsum[qoff + q0 + i] : 0.f;
    s_d[i] = in ? delta[qoff + q0 + i] : 0.f;
  }
  auto stage = [&](int it, int s) {
    const int k0 = (band.lo + it) * kBK;
    float* dst = smem + s * kStage;
    for (int i = tid; i < kBK * kC4; i += kT) {
      const int r = i / kC4, c = i - r * kC4;
      const bool in = k0 + r < Sk;
      cp_async16(dst + r * kS + 4 * c,
                 kb + (in ? static_cast<size_t>(k0 + r) * HD + 4 * c : 0), in);
    }
    const float* blk = blk0 + static_cast<size_t>(it) * (2 * kBlock);
    float* dp_ = dst + kBK * kS;
    for (int i = tid; i < 2 * kBQ * (kBK / 4); i += kT) {
      const int r = i / (kBK / 4), c = i % (kBK / 4);  // r: 0..2·kBQ-1
      cp_async16(dp_ + r * kSP + 4 * c, blk + r * kBK + 4 * c, true);
    }
  };
  if (band.n > 0) stage(0, 0);
  cp_async_commit();

  const int w0 = q0 + 16 * rg;
  const int r0 = 16 * rg + g;
  float acc[kW / 8][4];
#pragma unroll
  for (int n = 0; n < kW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < band.n; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile it visible; tile it - 1's readers are done
    if (it + 1 < band.n) stage(it + 1, (it + 1) & 1);
    cp_async_commit();
    const int k0 = (band.lo + it) * kBK;
    float* st = smem + (it & 1) * kStage;
    float* pt = st + kBK * kS;
    float* dp = pt + kBQ * kSP;
    if constexpr (kFma<HD>) {
      // dS of the tile in place of dP, each once.
      for (int i = tid; i < kBQ * kBK; i += kT) {
        const int row = i / kBK, c = row * kSP + i % kBK;
        dp[c] = dscore(pt[c], dp[c], s_z[row], s_d[row]);
      }
      __syncthreads();
    }
    // No row of the row group sees a key of this tile.
    if (w0 >= Sq || k0 > imin(w0 + 15, sk_real - 1) ||
        (window >= 0 && w0 - (k0 + kBK - 1) >= window))
      continue;
    // A = dS: k-step kk takes keys 8kk + 2t (cols t) and 8kk + 2t + 1
    // (cols t + 4) of rows r0 and r0 + 8 (rows g, g + 8); B = k.
    if constexpr (kFma<HD>) {
      auto afn = [&](int r, int m) { return dp[(r0 + 8 * m) * kSP + r]; };
      tile_product_fma<kW, kS>(acc, afn, st, t, d0);
    } else {
      const float* br = st + 2 * t * kS + d0 + kVN * g;
#pragma unroll 1
      for (int ks = 0; ks < 4; ks += kChain) {
        unsigned a[kChain][kPA][4];
#pragma unroll
        for (int kk = 0; kk < kChain; ++kk)
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const int r = r0 + 8 * m;
            float x[2], y[2];
            lds(pt + r * kSP + 8 * (ks + kk) + 2 * t, x);
            lds(dp + r * kSP + 8 * (ks + kk) + 2 * t, y);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              unsigned p[kPA];
              split_n<kPA>(dscore(x[h], y[h], s_z[r], s_d[r]), p);
#pragma unroll
              for (int i = 0; i < kPA; ++i) a[kk][i][2 * h + m] = p[i];
            }
          }
        chain_product<kW, kS, kPA, kPA>(acc, a, br + 8 * ks * kS);
      }
    }
  }
  cp_async_wait_all();  // a block with no tile never waited for its copies

  store_rows<HD, kW>(acc, dq + qoff * HD, q0 + r0, Sq, d0, t, scale);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

template <int HD>
cudaError_t configure() {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_scores<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(ScoresLayout<HD>::kBytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        flash_bwd_kv<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(KvLayout<HD>::kBytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        flash_bwd_q<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(QLayout<HD>::kBytes));
  return err;
}

long long blocks_per_bh(int Sq, int sk_real, int window) {
  return blocks_before((Sq + kBQ - 1) / kBQ, Sq, sk_real, window);
}

// Float32s of scratch a head takes: P~ and dP of its storage blocks, then
// D and Z of its rows.
long long head_floats(int Sq, int sk_real, int window) {
  return blocks_per_bh(Sq, sk_real, window) * (2 * kBlock) + 2LL * Sq;
}

// The launches run over slices of this many heads, so the scratch holds
// at most kScratchFloats unless one head alone needs more.
int heads_per_slice(int BH, int Sq, int sk_real, int window) {
  const long long fit = kScratchFloats / head_floats(Sq, sk_real, window);
  return static_cast<int>(fit < 1 ? 1 : (fit < BH ? fit : BH));
}

// The three launches over heads [0, BH) of the operands given.
template <int HD>
int launch_slice(const float* q, const float* k, const float* v,
                 const float* lse, const float* dout, float* dq, float* dk,
                 float* dv, float* scratch, int BH, int Sq, int Sk,
                 int sk_real, int window, float scale, cudaStream_t stream) {
  const long long per_bh = blocks_per_bh(Sq, sk_real, window);
  float* blocks = scratch;
  float* delta = scratch + static_cast<size_t>(BH) * per_bh * (2 * kBlock);
  float* zsum = delta + static_cast<size_t>(BH) * Sq;
  const long long q_blocks = static_cast<long long>((Sq + kBQ - 1) / kBQ) * BH;
  const long long kv_blocks = static_cast<long long>((Sk + kBK - 1) / kBK) * BH;
  if (kv_blocks > 0x7fffffffLL || q_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_scores<HD><<<static_cast<unsigned>(q_blocks), kScoresThreads,
                         ScoresLayout<HD>::kBytes, stream>>>(
      q, k, v, dout, lse, blocks, delta, zsum, BH, Sq, Sk, sk_real, window,
      scale, per_bh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_kv<HD><<<static_cast<unsigned>(kv_blocks), kKvThreads<HD>,
                     KvLayout<HD>::kBytes, stream>>>(
      q, dout, blocks, delta, zsum, dk, dv, BH, Sq, Sk, sk_real, window,
      scale, per_bh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_q<HD><<<static_cast<unsigned>(q_blocks), kQThreads<HD>,
                    QLayout<HD>::kBytes, stream>>>(
      k, blocks, delta, zsum, dq, BH, Sq, Sk, sk_real, window, scale, per_bh);
  return static_cast<int>(cudaGetLastError());
}

// Each head's arithmetic is the same in any slice, so the slicing changes
// no bit of the result.
template <int HD>
int launch(const float* q, const float* k, const float* v, const float* lse,
           const float* dout, float* dq, float* dk, float* dv, float* scratch,
           int BH, int Sq, int Sk, int sk_real, int window, float scale,
           cudaStream_t stream) {
  cudaError_t err = configure<HD>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hs = heads_per_slice(BH, Sq, sk_real, window);
  for (int b0 = 0; b0 < BH; b0 += hs) {
    const size_t oq = static_cast<size_t>(b0) * Sq * HD;
    const size_t ok = static_cast<size_t>(b0) * Sk * HD;
    const int rc = launch_slice<HD>(
        q + oq, k + ok, v + ok, lse + static_cast<size_t>(b0) * Sq, dout + oq,
        dq + oq, dk + ok, dv + ok, scratch, imin(hs, BH - b0), Sq, Sk,
        sk_real, window, scale, stream);
    if (rc) return rc;
  }
  return static_cast<int>(cudaSuccess);
}

template <int HD>
int resources(int which, int* smem_bytes, int* blocks_per_sm) {
  cudaError_t err = configure<HD>();
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (which) {
    case 0:
      *smem_bytes = static_cast<int>(ScoresLayout<HD>::kBytes);
      return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, flash_bwd_scores<HD>, kScoresThreads,
          ScoresLayout<HD>::kBytes));
    case 1:
      *smem_bytes = static_cast<int>(KvLayout<HD>::kBytes);
      return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, flash_bwd_kv<HD>, kKvThreads<HD>,
          KvLayout<HD>::kBytes));
    case 2:
      *smem_bytes = static_cast<int>(QLayout<HD>::kBytes);
      return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, flash_bwd_q<HD>, kQThreads<HD>,
          QLayout<HD>::kBytes));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Float32s of scratch flash_attention_bwd_launch needs: P~ and dP of every
// storage block of a slice of heads, then D and Z of its rows.
extern "C" long long flash_attention_bwd_scratch_floats(int BH, int Sq,
                                                        int sk_real,
                                                        int window) {
  return heads_per_slice(BH, Sq, sk_real, window) *
         head_floats(Sq, sk_real, window);
}

// scratch: flash_attention_bwd_scratch_floats(BH, Sq, sk_real, window)
// float32.  Returns cudaGetLastError() after the three launches (or the
// first that failed).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* lse,
    const void* dout, void* dq, void* dk, void* dv, void* scratch, int BH,
    int Sq, int Sk, int hd, int sk_real, int window, float scale,
    void* stream) {
  if (BH < 1 || Sq < 1 || Sk < 1 || sk_real < 0 || sk_real > Sk)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_BWD_CASE(H)                                                     \
  case H:                                                                     \
    return launch<H>(                                                         \
        static_cast<const float*>(q), static_cast<const float*>(k),           \
        static_cast<const float*>(v), static_cast<const float*>(lse),         \
        static_cast<const float*>(dout), static_cast<float*>(dq),             \
        static_cast<float*>(dk), static_cast<float*>(dv),                     \
        static_cast<float*>(scratch), BH, Sq, Sk, sk_real, window, scale, s);
  switch (hd) {
    FLASH_BWD_CASE(16)
    FLASH_BWD_CASE(32)
    FLASH_BWD_CASE(64)
    FLASH_BWD_CASE(128)
    FLASH_BWD_CASE(256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_BWD_CASE
}

// Dynamic shared bytes and blocks an SM at head dim hd of launch `which`:
// 0 flash_bwd_scores, 1 flash_bwd_kv, 2 flash_bwd_q.
extern "C" int flash_attention_bwd_resources(int hd, int which,
                                             int* smem_bytes,
                                             int* blocks_per_sm) {
  switch (hd) {
    case 16: return resources<16>(which, smem_bytes, blocks_per_sm);
    case 32: return resources<32>(which, smem_bytes, blocks_per_sm);
    case 64: return resources<64>(which, smem_bytes, blocks_per_sm);
    case 128: return resources<128>(which, smem_bytes, blocks_per_sm);
    case 256: return resources<256>(which, smem_bytes, blocks_per_sm);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
