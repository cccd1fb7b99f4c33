// Banded-causal flash attention on the tensor cores (CUDA, sm_90a;
// kernels/flash_attention.py).
//
//   q (BH, Sq, hd), k/v (BH, Sk, hd) float32 -> out (BH, Sq, hd) float32
//   and, for training, lse (BH, Sq) float32 (nullptr: not written)
//
// Key k_pos is live for query q_pos iff k_pos <= q_pos, q_pos - k_pos <
// window (window < 0: full causal) and k_pos < sk_real.  Masked scores are
// -1e30 and add exactly 0; out = acc / max(l, 1e-30), so a row with no live
// key gives 0.  hd is a template parameter: 16, 32, 64, 128 or 256.
// lse is each row's log-sum-exp of its live scaled scores, m + log(l) of
// the online softmax, +inf for a row with no live key; the backward
// (flash_attention_bwd.cu) recomputes P = exp(s·scale - lse) from it.
// Serving passes nullptr and the kernel writes nothing more.
//
// Both products, S = Q·Kᵀ and O += P·V, run as split-TF32 mma.sync
// (m16n8k8, fp32 accumulation).  Each operand x is split on load into
// hi = rna_tf32(x) and lo = rna_tf32(x - hi); each product is lo·hi +
// hi·lo + hi·hi, small terms first, which drops only lo·lo (about 2^-22 of
// |x·y|), where one TF32 pass keeps 11 significant bits and would miss the
// 2e-5 tolerance.  The tensor cores add into their fp32 accumulator with
// truncation, not rounding, so no chain runs long: a tile's P·V runs from
// zero and joins O by one fmaf (alpha·O + P·V), so O's tiles add
// round-to-nearest, and the scores' hi·hi terms run per 16-dim chunk from
// zero, joined by compensated addition.  With q, k scaled by 6 (scores
// ≈ 30), plain adds there left up to 3e-5 of error against float64 and
// this leaves up to 2e-5, where the float32 plain version is at 4e-5 to
// 1.2e-4; a fourth product (lo·lo) did not lower that worst case
// (scripts/flash_probe.py).
//
// One block owns kBQ = 64 query rows of one (batch, head) row bh, in four
// row groups of 16, the mma's M.  A row group is one warp, or at hd 256 two,
// each with half the head dims: each computes its share of the scores, the
// two add them through shared memory, and each keeps half of O (64
// accumulator registers a thread, not 128, so nothing spills and 8 warps
// share an SM, not 4).  Q is staged once.  Key tiles of kBK = 32 keys come
// in by cp.async into two stages, the next tile's copies in flight during
// this tile's arithmetic: at hd 256 only two stages fit, so freeing a
// stage takes a block barrier either way (one per tile), and cp.async
// zero-fills the rows past Sk.  Tiles wholly above the diagonal, wholly
// outside the window or at or past sk_real are never read by the block; a
// row group skips the arithmetic of a tile none of its 16 rows sees, and
// masks none in a tile all of its rows see whole.
// Fragment layouts (g = lane / 4, t = lane % 4):
//   * the reduction index of a fragment may be permuted as long as both
//     operands share the permutation, so S reads Q and K rows as float4s
//     (dims 4t..4t+3 of a 16-dim chunk serve two k-steps), row stride
//     hd + 16 floats: no bank conflict;
//   * P's A fragment is S's C fragment as it lies (keys 2t, 2t+1 of each
//     8-key step), so V is read at rows 2t, 2t+1; output columns are
//     permuted within groups of 32 so one float4 of V feeds four n-tiles;
//     V's row stride is hd + 4 floats: no bank conflict;
//   * softmax per row: max over the quad's 4 lanes (shfl_xor 1, 2), expf
//     (not __expf), no fast math; the running sum stays per lane until the
//     end.
// Grid: one block per (q tile, bh), the q tiles of most keys first, so the
// long causal rows start early.  Nothing is padded in device memory: rows
// past Sq or Sk are zero-filled in shared memory and never stored.
//
// Shared memory: 4·(64·sQ + 2·32·(sQ + sV)) bytes, sQ = hd + 16 (hd 16:
// 16), sV = hd + 4, and at hd 256 16 KB for the score exchange: 222,208
// bytes, one block an SM.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kGroups = 4;          // row groups of 16 per block
constexpr int kBQ = kGroups * 16;   // query rows per block
constexpr int kBK = 32;             // keys per tile
constexpr int kNT = kBK / 8;        // score n-tiles (and P·V k-steps) per tile
constexpr float kMasked = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// Warps per row group: at hd 256 two, each with half the head dims (its
// share of the score, exchanged through shared memory, and half of O), so
// the accumulator is 64 registers a thread and no register spills.
template <int HD>
constexpr int kSplit = HD >= 256 ? 2 : 1;

template <int HD>
constexpr int kThreads = 32 * kGroups * kSplit<HD>;

template <int HD>
struct Layout {
  static constexpr int kSQ = HD % 32 == 0 ? HD + 16 : HD;  // Q and K rows
  static constexpr int kSV = HD + 4;                       // V rows
  static constexpr int kX =  // the score exchange
      (kSplit<HD> > 1) ? kGroups * kSplit<HD> * kNT * 128 : 0;
  static constexpr size_t kBytes =
      sizeof(float) * (kBQ * kSQ + 2 * kBK * (kSQ + kSV) + kX);
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !full.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(full ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero:
// cvt.rna.tf32.f32's result, in two integer operations (the conversion
// instruction runs at a fraction of their rate; scripts/flash_probe.py).
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + O(2^-22 |x|), both TF32.
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
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

// Barrier `id` (1..15) for `n` threads, warps of a row group here.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

template <int HD>
__global__ void __launch_bounds__(kThreads<HD>, 1)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out,
             float* __restrict__ lse, int BH, int Sq, int Sk, int sk_real,
             int window, float scale) {
  static_assert(HD % 16 == 0 && HD <= 256, "hd must be a multiple of 16");
  constexpr int kSQ = Layout<HD>::kSQ, kSV = Layout<HD>::kSV;
  constexpr int kT = kThreads<HD>;
  constexpr int kW = HD / kSplit<HD>;     // head dims of a warp
  constexpr int kC4 = HD / 4;             // 16-byte chunks per row
  constexpr int kOT = kW / 8;             // output n-tiles of a warp
  constexpr int kVN = kW >= 32 ? 4 : 2;   // output n-tiles per V load
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;
  float* s_k = s_q + kBQ * kSQ;       // 2 stages of kBK x kSQ
  float* s_v = s_k + 2 * kBK * kSQ;   // 2 stages of kBK x kSV
  float* s_x = s_v + 2 * kBK * kSV;   // per warp: its share of the scores

  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % BH;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / BH);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp % kGroups;          // row group
  const int d0 = (warp / kGroups) * kW;   // the warp's first head dim

  const float* qb = q + static_cast<size_t>(bh) * Sq * HD;
  const float* kb = k + static_cast<size_t>(bh) * Sk * HD;
  const float* vb = v + static_cast<size_t>(bh) * Sk * HD;

  // Keys any row of the block can see: [k_lo, k_hi].
  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int k_hi = min(q_last, sk_real - 1);
  const int k_lo = window >= 0 ? max(0, q0 - window + 1) : 0;
  const int tile0 = k_lo / kBK;
  const int n_tiles = k_hi >= k_lo ? k_hi / kBK - tile0 + 1 : 0;

  for (int i = tid; i < kBQ * kC4; i += kT) {
    const int r = i / kC4, c = i - r * kC4;
    const bool in = q0 + r < Sq;
    cp_async16(s_q + r * kSQ + 4 * c,
               in ? qb + static_cast<size_t>(q0 + r) * HD + 4 * c : qb, in);
  }
  auto stage = [&](int tile, int s) {
    const int k0 = tile * kBK;
    float* dk = s_k + s * kBK * kSQ;
    float* dv = s_v + s * kBK * kSV;
    for (int i = tid; i < kBK * kC4; i += kT) {
      const int r = i / kC4, c = i - r * kC4;
      const bool in = k0 + r < Sk;
      const size_t off = in ? static_cast<size_t>(k0 + r) * HD + 4 * c : 0;
      cp_async16(dk + r * kSQ + 4 * c, kb + off, in);
      cp_async16(dv + r * kSV + 4 * c, vb + off, in);
    }
  };
  if (n_tiles > 0) stage(tile0, 0);
  cp_async_commit();

  // This thread's rows: qr and qr + 8 (C fragment rows g, g + 8).
  const int w0 = q0 + 16 * rg;
  const int qr = w0 + g;
  float o[kOT][4];
#pragma unroll
  for (int n = 0; n < kOT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_run[2] = {kMasked, kMasked}, l_run[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile it visible; tile it - 1's readers are done
    if (it + 1 < n_tiles) stage(tile0 + it + 1, (it + 1) & 1);
    cp_async_commit();
    const int k0 = (tile0 + it) * kBK;
    // No row of the warp sees a key of this tile (the same for the warp).
    if (k0 > min(w0 + 15, sk_real - 1) ||
        (window >= 0 && w0 - (k0 + kBK - 1) >= window))
      continue;
    const float* sk = s_k + (it & 1) * kBK * kSQ;
    const float* sv = s_v + (it & 1) * kBK * kSV;

    // Scores: sb the hi·hi products, ss the small ones.
    // The tensor cores add into their accumulator with truncation, so
    // hi·hi (the large terms) runs per 16-dim chunk from zero and joins sb
    // by compensated (Kahan) addition, sc its running error.
    float sb[kNT][4], ss[kNT][4], sc[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sb[j][e] = ss[j][e] = sc[j][e] = 0.f;
    const float* qa = s_q + (16 * rg + g) * kSQ + 4 * t;
    const float* kr = sk + g * kSQ + 4 * t;
#pragma unroll 2
    for (int c = d0; c < d0 + kW; c += 16) {
      float x0[4], x1[4];
      lds(qa + c, x0);
      lds(qa + 8 * kSQ + c, x1);
      // k-step 0 reads dims 4t, 4t+1 of the chunk, k-step 1 4t+2, 4t+3.
      unsigned ah[2][4], al[2][4];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        split(x0[2 * s], ah[s][0], al[s][0]);
        split(x1[2 * s], ah[s][1], al[s][1]);
        split(x0[2 * s + 1], ah[s][2], al[s][2]);
        split(x1[2 * s + 1], ah[s][3], al[s][3]);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        float y[4];
        lds(kr + j * 8 * kSQ + c, y);
        unsigned bh[4], bl[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split(y[e], bh[e], bl[e]);
        float big[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          mma(ss[j], al[s], bh[2 * s], bh[2 * s + 1]);
          mma(ss[j], ah[s], bl[2 * s], bl[2 * s + 1]);
          mma(big, ah[s], bh[2 * s], bh[2 * s + 1]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float y = big[e] - sc[j][e];
          const float z = sb[j][e] + y;
          sc[j][e] = (z - sb[j][e]) - y;
          sb[j][e] = z;
        }
      }
    }

#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sb[j][e] += ss[j][e] - sc[j][e];
    if constexpr ((kSplit<HD> > 1)) {
      // Both warps of the row group add the two shares (a + b == b + a).
      float* mine = s_x + warp * kNT * 128 + lane;
      const float* other = s_x + (warp ^ kGroups) * kNT * 128 + lane;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(4 * j + e) * 32] = sb[j][e];
      bar_sync(1 + rg, 64);
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sb[j][e] += other[(4 * j + e) * 32];
    }

    // Online softmax.  Element e of n-tile j: row qr + 8 (e / 2), key
    // k0 + 8j + 2t + e % 2.  A tile whose every key every row of the warp
    // sees needs no mask (the same for the warp).
    unsigned live = (1u << (4 * kNT)) - 1u;
    if (k0 + kBK - 1 > w0 || k0 + kBK > sk_real ||
        (window >= 0 && w0 + 15 - k0 >= window)) {
      live = 0u;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qp = qr + 8 * (e >> 1);
          const int kp = k0 + 8 * j + 2 * t + (e & 1);
          const bool ok = kp <= qp && kp < sk_real &&
                          (window < 0 || qp - kp < window);
          live |= ok ? 1u << (4 * j + e) : 0u;
        }
    }
    float mx[2] = {kMasked, kMasked};
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float s = (live >> (4 * j + e)) & 1u ? sb[j][e] * scale
                                                   : kMasked;
        sb[j][e] = s;
        mx[e >> 1] = fmaxf(mx[e >> 1], s);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (live >> (4 * j + e)) & 1u
                            ? expf(sb[j][e] - m_run[e >> 1]) : 0.f;
        sb[j][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];

    // O = alpha·O + P·V.  The tile's P·V runs on the tensor cores from zero
    // and joins O by one rounded fused multiply-add, so O's many tiles add
    // with round-to-nearest.  k-step kk: A = P's keys 8kk + 2t (cols t) and
    // 8kk + 2t + 1 (cols t + 4); B = V rows 8kk + 2t, 8kk + 2t + 1, n-tile x
    // of column group grp at column grp·8·kVN + kVN·g + x.
    unsigned ph[kNT][4], pl[kNT][4];
#pragma unroll
    for (int kk = 0; kk < kNT; ++kk) {
      split(sb[kk][0], ph[kk][0], pl[kk][0]);
      split(sb[kk][2], ph[kk][1], pl[kk][1]);
      split(sb[kk][1], ph[kk][2], pl[kk][2]);
      split(sb[kk][3], ph[kk][3], pl[kk][3]);
    }
    const float* vr = sv + 2 * t * kSV + d0 + kVN * g;
#pragma unroll
    for (int grp = 0; grp < kOT / kVN; ++grp) {
      float pv[kVN][4];
#pragma unroll
      for (int x = 0; x < kVN; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[x][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kNT; ++kk) {
        float b0[kVN], b1[kVN];
        lds(vr + 8 * kk * kSV + grp * 8 * kVN, b0);
        lds(vr + (8 * kk + 1) * kSV + grp * 8 * kVN, b1);
#pragma unroll
        for (int x = 0; x < kVN; ++x) {
          unsigned h0, l0, h1, l1;
          split(b0[x], h0, l0);
          split(b1[x], h1, l1);
          mma(pv[x], pl[kk], h0, h1);
          mma(pv[x], ph[kk], l0, l1);
          mma(pv[x], ph[kk], h0, h1);
        }
      }
#pragma unroll
      for (int x = 0; x < kVN; ++x) {
        float (&c)[4] = o[grp * kVN + x];
        c[0] = fmaf(c[0], alpha[0], pv[x][0]);
        c[1] = fmaf(c[1], alpha[0], pv[x][1]);
        c[2] = fmaf(c[2], alpha[1], pv[x][2]);
        c[3] = fmaf(c[3], alpha[1], pv[x][3]);
      }
    }
  }

  // Row r's columns of group grp: grp·8·kVN + 2·kVN·t + (kVN·e + x), from
  // element (r, e) of n-tile grp·kVN + x.
  float* ob = out + static_cast<size_t>(bh) * Sq * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(kFull, l, 1);
    l += __shfl_xor_sync(kFull, l, 2);
    const int qp = qr + 8 * r;
    if (qp >= Sq) continue;
    if (lse != nullptr && d0 == 0 && t == 0)
      lse[static_cast<size_t>(bh) * Sq + qp] =
          l > 0.f ? m_run[r] + logf(l) : __int_as_float(0x7f800000);
    const float den = fmaxf(l, 1e-30f);
    float* orow = ob + static_cast<size_t>(qp) * HD + d0 + 2 * kVN * t;
#pragma unroll
    for (int grp = 0; grp < kOT / kVN; ++grp) {
      float y[2 * kVN];
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int x = 0; x < kVN; ++x)
          y[kVN * e + x] = o[grp * kVN + x][2 * r + e] / den;
#pragma unroll
      for (int i = 0; i < 2 * kVN; i += 4)
        *reinterpret_cast<float4*>(orow + grp * 8 * kVN + i) =
            make_float4(y[i], y[i + 1], y[i + 2], y[i + 3]);
    }
  }
}

template <int HD>
cudaError_t configure() {
  return cudaFuncSetAttribute(flash_kernel<HD>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(Layout<HD>::kBytes));
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int BH, int Sq, int Sk, int sk_real, int window, float scale,
           cudaStream_t stream) {
  cudaError_t err = configure<HD>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>((Sq + kBQ - 1) / kBQ) * BH;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_kernel<HD><<<static_cast<unsigned>(blocks), kThreads<HD>,
                     Layout<HD>::kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), BH, Sq, Sk, sk_real, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared bytes and blocks an SM of the instantiation for hd.
template <int HD>
int resources(int* smem_bytes, int* blocks_per_sm) {
  cudaError_t err = configure<HD>();
  *smem_bytes = static_cast<int>(Layout<HD>::kBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, flash_kernel<HD>, kThreads<HD>, Layout<HD>::kBytes);
  return static_cast<int>(err);
}

}  // namespace

// lse: nullptr (serving) or (BH, Sq) float32 (training's forward).
extern "C" int flash_attention_lse_launch(const void* q, const void* k,
                                          const void* v, void* out, void* lse,
                                          int BH, int Sq, int Sk, int hd,
                                          int sk_real, int window, float scale,
                                          void* stream) {
  if (BH < 1 || Sq < 1 || Sk < 1 || sk_real < 0 || sk_real > Sk)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(q, k, v, out, lse, BH, Sq, Sk, sk_real, window, scale, s);
    case 32: return launch<32>(q, k, v, out, lse, BH, Sq, Sk, sk_real, window, scale, s);
    case 64: return launch<64>(q, k, v, out, lse, BH, Sq, Sk, sk_real, window, scale, s);
    case 128: return launch<128>(q, k, v, out, lse, BH, Sq, Sk, sk_real, window, scale, s);
    case 256: return launch<256>(q, k, v, out, lse, BH, Sq, Sk, sk_real, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The kernel's dynamic shared memory and blocks an SM at head dim hd.
extern "C" int flash_attention_resources(int hd, int* smem_bytes,
                                         int* blocks_per_sm) {
  switch (hd) {
    case 16: return resources<16>(smem_bytes, blocks_per_sm);
    case 32: return resources<32>(smem_bytes, blocks_per_sm);
    case 64: return resources<64>(smem_bytes, blocks_per_sm);
    case 128: return resources<128>(smem_bytes, blocks_per_sm);
    case 256: return resources<256>(smem_bytes, blocks_per_sm);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
