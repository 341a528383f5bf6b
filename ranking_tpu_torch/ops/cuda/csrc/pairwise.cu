// Fused pairwise ranking-loss sums for Hopper (sm_90a), forward and backward.
//
// Replaces the Pallas TPU kernels `_fwd_kernel` and `_bwd_kernel` behind
// `_pairwise_sums_fwd` and `_pairwise_sums_bwd` in
// ranking_tpu/ops/pallas/pairwise.py. Same function. For each list b and each
// ordered pair (i, j) of its L items:
//   pref  = l_i - l_j > 0,            valid = m_i * m_j,
//   pw    = pref * valid * lambda(i, j) * w_i,          d = s_i - s_j,
// with lambda by the static mode:
//   none        1
//   labeldiff   |l_i - l_j|
//   dcg_v2      |g_i - g_j| * |D(k) - D(k + 1)| * mult * scale_b, k = |r_i - r_j|,
//               mult = 1 / (1 - D(max(r_i, r_j))) where that rank is above topn,
//               else 1; 0 where k == 0
//   dcg_v1      |g_i - g_j| * ((1 - f) u + f v) * scale_b for pairs with
//               min(r_i, r_j) <= topn, else 0; u = |D(k) - D(k + 1)| (0 where
//               k == 0), v = |cap(r_i) - cap(r_j)|, cap(r) = D(r) for r <= topn,
//               else 0; f = smooth_fraction
//   dcg_v2_neighbor   dcg_v2 restricted to k == 1
// and D(r) = log(2)/log1p(r), 1/r or 1/log1p(r). The loss of a pair is
// logistic, hinge (gradient -0.5 at d == 1, as autograd splits the tie of a
// maximum) or soft zero-one.
//   forward:  out[b] = (sum loss(d) * pw, sum pw, #{pw != 0})      [B, 3]
//   backward: dlogits[b, i] = ct[b, 0] * (sum_j pw_ij l'(s_i - s_j)
//                                         - sum_j pw_ji l'(s_j - s_i))
// The [B, L, L] pair matrices exist nowhere in memory.
//
// Design. A block of 8 warps owns one tile of one list's rows; the host
// picks the tiles a list (`tiles`) so that B * tiles fills the card in one
// wave without re-staging a list in many blocks (4 at B = 128, L = 200;
// 32 at B = 16, L = 1024). Staging copies the
// list's unmasked items, in order, into shared memory (4 arrays for the
// first two modes, 6 for the DCG modes, and each item's position as 16
// bits): a pair with a masked item weighs 0 and adds 0 to every sum for
// finite logits, so neither loop ever meets one (in a ragged batch about
// half the items are padding). The block's warps count their segment's
// unmasked items with one ballot a 32 items, a barrier publishes the
// counts, and each warp writes its items at its offset. The tile's share
// of the n unmasked rows is ceil(n / tiles). A warp takes 4 rows at a time
// and its lanes stride over j: a step reads 32 neighbouring words of each
// array without bank conflicts, a column's values serve 4 rows, and the 4
// rows' dependent chains (table reads, exp, reciprocal) overlap.
//
// Discount tables. Ranks from `compute_ranks` are whole numbers in [1, L].
// For lists of up to kMaxTableListSize items the DCG modes build, while
// the items are staged, two (L + 1)-entry tables with the same `discount`
// call and the same float operations as the pair formula:
//   gap[k]  = |D(k) - D(k + 1)| (0 at k = 0),
//   V2:  mult[r] = 1 / (1 - D(r)) where r > topn, else 1;
//   V1:  cap[r]  = D(r) where r <= topn, else 0,
// so every entry is bitwise the value the pair formula gives, and the
// inner loop runs no log1p and no division but the loss's own. Staging
// tests each unmasked item's rank for being whole and in [1, L] (one
// `__syncthreads_and`). A list that fails, and every list longer than
// kMaxTableListSize (whose tables would not fit beside its items), runs
// the per-pair formula: the kernel's second instantiation of the loop,
// which evaluates D per pair.
//
// Sums. A row's sums are reduced over the warp by shuffles and over the
// block's warps in a fixed order; the forward writes one partial per block
// and a second small kernel adds a list's partials in ascending order. No
// atomics: results repeat bit for bit. The count of non-zero pair weights
// is kept in integers from the lane to the last sum (a float32 count stops
// being exact at 2^24 pairs) and is converted once, at the output.
//
// Backward without a transposed pass. lambda(i, j) = lambda(j, i) bit for
// bit (every factor is a symmetric product, absolute difference, maximum
// or "either rank within topn"), and at most one of (i, j), (j, i) is a
// preference pair. So the warp that owns row i evaluates the symmetric
// weight once for each j, then selects by the sign of l_i - l_j the item
// weight (w_i or w_j), the argument of the loss derivative (s_i - s_j or
// s_j - s_i) and whether to add, subtract or add nothing: one weight and
// one derivative a pair, with no branch, so that neither the two
// directions nor the 4 rows diverge. The warp writes dlogits_i itself: no
// column reduction, no cross-block sum. Masked rows get a 0 gradient from
// the block whose share of positions holds them. (The forward keeps its
// branch on the preference: it evaluates the loss, log1p and all, only for
// preference pairs.)
//
// Arithmetic. The pair weight is multiplied up in the order of the plain
// PyTorch version (valid, gain, discount, scale, item weight) with IEEE
// division and without flush-to-zero or fast-math, so that a weight is zero
// here exactly where it is zero there: the count is a denominator of the
// loss and must agree exactly.
//
// Bound. Inputs are 7 * B * L words and the output B * 3 or B * L (0.7 MB
// at B=128, L=200). The function needs a label compare for each of the
// B * L^2 ordered pairs and, for each preference pair of unmasked items, a
// handful of float operations and the loss's own special-function results
// (exp and log, or exp and a reciprocal; none for the hinge), the discount
// terms being table reads. This kernel spends more: the backward weighs
// every pair of unmasked items, those of equal labels too, and meets each
// preference pair from both of its rows. At the flagship size the time
// goes to the heaviest blocks' serial row loops, not to the card's rates.
//
// List size domain. kMaxListSize = 8192: 6.5 words an item (the DCG
// modes' arrays and positions) take 208 KiB of the 227 KiB a block may use
// on sm_90; with the tables, 8.5 words an item and 2 more fit up to
// kMaxTableListSize = 6144. Above 48 KiB the launch raises the kernel's
// dynamic shared memory limit first.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMaxListSize = 8192;
constexpr int kMaxTableListSize = 6144;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kDefaultDynamicSmem = 48 * 1024;
constexpr float kLn2 = 0.6931471805599453f;

enum Loss { kLogistic = 0, kHinge = 1, kSoftZeroOne = 2 };
enum Lambda {
  kNone = 0,
  kLabelDiff = 1,
  kDcgV2 = 2,
  kDcgV1 = 3,
  kDcgV2Neighbor = 4
};
enum Discount { kLog2Inverse = 0, kInverse = 1, kLog1pInverse = 2 };

struct Params {
  const float* labels;   // [B, L]
  const float* logits;   // [B, L]
  const float* mask;     // [B, L], 0 or 1
  const float* weights;  // [B, L] left-item weights
  const float* gain;     // [B, L] (DCG modes)
  const float* ranks;    // [B, L] 1-based, whole numbers (DCG modes)
  const float* scale;    // [B]    (DCG modes)
  int B;
  int L;
  int tiles;  // row tiles (blocks) per list, chosen by the host
  int discount_kind;
  float topn;
  float smooth;
  float one_minus_smooth;
};

__host__ __device__ constexpr bool is_dcg(int mode) { return mode >= kDcgV2; }

__host__ __device__ inline bool has_tables(int mode, int L) {
  return is_dcg(mode) && L <= kMaxTableListSize;
}

// Words of dynamic shared memory: the item arrays, the 16-bit positions
// and, where the mode has them, the two tables.
__host__ __device__ inline int smem_words(int mode, int L) {
  return (is_dcg(mode) ? 6 : 4) * L + (L + 1) / 2 +
         (has_tables(mode, L) ? 2 * (L + 1) : 0);
}

// The staged list in shared memory: n unmasked items in their order.
// `r` holds float ranks, or in table mode the ranks as ints.
struct List {
  const float *lab, *s, *m, *w, *g, *r;
  const uint16_t* pos;
  const float* gap;   // table mode: gap[k]
  const float* tab;   // table mode: mult[r] (V2 modes) or cap[r] (V1)
  int n;
  bool tables;
};

// What a pair's weight reads besides the two items.
struct Ctx {
  float scale;
  float topn;
  int topn_i;  // table mode: r <= topn iff r <= topn_i, for r in [1, L]
  int discount_kind;
  float smooth;
  float one_minus_smooth;
};

struct Item {
  float lab, s, m, w, g, r, d;  // d = D(r): the per-pair formula's row item
  int ri;                       // table mode: the rank as an int
};

__device__ __forceinline__ float discount(int kind, float r) {
  if (kind == kInverse) return 1.0f / r;
  const float lg = log1pf(r);
  return kind == kLog2Inverse ? kLn2 / lg : 1.0f / lg;
}

// Copies list b's unmasked items to shared memory in order, with their
// positions, and builds the discount tables where the mode has them. Ends
// in a barrier; `tables` is true where the tables hold for this list.
template <int kMode>
__device__ List stage(const Params& p, int b, float* sh) {
  __shared__ int counts[kWarps];
  const int L = p.L;
  const size_t base = static_cast<size_t>(b) * L;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* lab = sh;
  float* s = sh + L;
  float* m = sh + 2 * L;
  float* w = sh + 3 * L;
  float* g = sh + 4 * L;
  float* r = sh + 5 * L;
  uint16_t* pos =
      reinterpret_cast<uint16_t*>(sh + (is_dcg(kMode) ? 6 : 4) * L);
  float* gap = sh + (is_dcg(kMode) ? 6 : 4) * L + (L + 1) / 2;
  float* tab = gap + L + 1;
  const bool tables = has_tables(kMode, L);

  // Each warp's segment of positions, a multiple of 32 long.
  const int seg = (L + kThreads - 1) / kThreads * 32;
  const int first = warp * seg;
  const int last = min(L, first + seg);
  int count = 0;
  for (int i0 = first; i0 < last; i0 += 32) {
    const int i = i0 + lane;
    count += __popc(__ballot_sync(0xffffffffu,
                                  i < last && p.mask[base + i] != 0.0f));
  }
  if (lane == 0) counts[warp] = count;
  if constexpr (is_dcg(kMode)) {
    if (tables) {
      for (int k = threadIdx.x; k <= L; k += kThreads) {
        const float x = static_cast<float>(k);
        gap[k] = k > 0 ? fabsf(discount(p.discount_kind, x) -
                               discount(p.discount_kind, x + 1.0f))
                       : 0.0f;
        if constexpr (kMode == kDcgV1) {
          tab[k] = x > p.topn ? 0.0f : discount(p.discount_kind, x);
        } else {
          tab[k] = x > p.topn ? 1.0f / (1.0f - discount(p.discount_kind, x))
                              : 1.0f;
        }
      }
    }
  }
  __syncthreads();

  int at = 0;
  int n = 0;
  for (int k = 0; k < kWarps; ++k) {
    at += k < warp ? counts[k] : 0;
    n += counts[k];
  }
  bool whole = true;
  for (int i0 = first; i0 < last; i0 += 32) {
    const int i = i0 + lane;
    const float mv = i < last ? p.mask[base + i] : 0.0f;
    const unsigned keep = __ballot_sync(0xffffffffu, mv != 0.0f);
    if (mv != 0.0f) {
      const int c = at + __popc(keep & ((1u << lane) - 1u));
      lab[c] = p.labels[base + i];
      s[c] = p.logits[base + i];
      m[c] = mv;
      w[c] = p.weights[base + i];
      pos[c] = static_cast<uint16_t>(i);
      if constexpr (is_dcg(kMode)) {
        const float rank = p.ranks[base + i];
        g[c] = p.gain[base + i];
        if (tables) {
          const bool ok = rank >= 1.0f && rank <= static_cast<float>(L) &&
                          rank == floorf(rank);
          whole = whole && ok;
          r[c] = __int_as_float(ok ? static_cast<int>(rank) : 0);
        } else {
          r[c] = rank;
        }
      }
    }
    at += __popc(keep);
  }
  bool use_tables = false;
  if (tables) {
    use_tables = __syncthreads_and(whole);
    if (!use_tables) {  // the per-pair formula reads float ranks
      for (int c = threadIdx.x; c < n; c += kThreads) {
        r[c] = p.ranks[base + pos[c]];
      }
      __syncthreads();
    }
  } else {
    __syncthreads();
  }
  return List{lab, s, m, w, g, r, pos, gap, tab, n, use_tables};
}

template <int kMode>
__device__ __forceinline__ Ctx make_ctx(const Params& p, int b) {
  Ctx c;
  c.scale = is_dcg(kMode) ? p.scale[b] : 1.0f;
  c.topn = p.topn;
  c.topn_i = !(p.topn >= 1.0f) ? 0
             : p.topn >= static_cast<float>(p.L) ? p.L
                                                  : static_cast<int>(p.topn);
  c.discount_kind = p.discount_kind;
  c.smooth = p.smooth;
  c.one_minus_smooth = p.one_minus_smooth;
  return c;
}

template <int kMode, bool kTables>
__device__ __forceinline__ Item load_item(const List& a, int i,
                                          const Ctx& c, bool row) {
  Item x;
  x.lab = a.lab[i];
  x.s = a.s[i];
  x.m = a.m[i];
  x.w = a.w[i];
  x.g = x.r = x.d = 0.0f;
  x.ri = 0;
  if constexpr (is_dcg(kMode)) {
    x.g = a.g[i];
    if constexpr (kTables) {
      x.ri = __float_as_int(a.r[i]);
    } else {
      x.r = a.r[i];
      if (row) x.d = discount(c.discount_kind, x.r);
    }
  }
  return x;
}

// valid * lambda(i, j): the part of the pair weight that (i, j) and (j, i)
// share, bitwise the same either way round. Multiplied up in the plain
// version's order. x is the row item (its D(r) computed), y the column's.
template <int kMode, bool kTables>
__device__ __forceinline__ float symmetric_weight(const Item& x, const Item& y,
                                                  const List& a,
                                                  const Ctx& c) {
  float pw = x.m * y.m;
  if constexpr (kMode == kLabelDiff) {
    pw = pw * fabsf(x.lab - y.lab);
  } else if constexpr (is_dcg(kMode)) {
    const float pair_gain = fabsf(x.g - y.g);
    float pair_disc;
    if constexpr (kTables) {
      const int k = abs(x.ri - y.ri);
      const float gap = a.gap[k];  // 0 where k == 0
      if constexpr (kMode == kDcgV1) {
        const bool in_topn = x.ri <= c.topn_i || y.ri <= c.topn_i;
        const float u = in_topn ? gap : 0.0f;
        const float v = fabsf(a.tab[x.ri] - a.tab[y.ri]);
        pair_disc = __fadd_rn(__fmul_rn(c.one_minus_smooth, u),
                              __fmul_rn(c.smooth, v));
        pair_disc = pair_disc * (in_topn ? 1.0f : 0.0f);
      } else {
        // Selected, not multiplied: mult may be infinite where k == 0.
        pair_disc = k > 0 ? gap * a.tab[max(x.ri, y.ri)] : 0.0f;
        if constexpr (kMode == kDcgV2Neighbor) {
          pair_disc = pair_disc * (k == 1 ? 1.0f : 0.0f);
        }
      }
    } else {
      const int kind = c.discount_kind;
      const float rank_diff = fabsf(x.r - y.r);
      // Selected, not multiplied: D(0) is infinite.
      const float gap = rank_diff > 0.0f
                            ? fabsf(discount(kind, rank_diff) -
                                    discount(kind, rank_diff + 1.0f))
                            : 0.0f;
      if constexpr (kMode == kDcgV1) {
        const bool in_topn = x.r <= c.topn || y.r <= c.topn;
        const float u = in_topn ? gap : 0.0f;
        const float cap_x = x.r > c.topn ? 0.0f : x.d;
        const float cap_y = y.r > c.topn ? 0.0f : discount(kind, y.r);
        const float v = fabsf(cap_x - cap_y);
        // A multiply, a multiply and an add, each rounded, as the plain
        // version computes it.
        pair_disc = __fadd_rn(__fmul_rn(c.one_minus_smooth, u),
                              __fmul_rn(c.smooth, v));
        pair_disc = pair_disc * (in_topn ? 1.0f : 0.0f);
      } else {
        pair_disc = 0.0f;
        if (rank_diff > 0.0f) {
          const float max_rank = fmaxf(x.r, y.r);
          // Selected as well: 1 / (1 - D) is infinite where D == 1.
          if (max_rank > c.topn) {
            const float d_max = x.r >= y.r ? x.d : discount(kind, y.r);
            pair_disc = gap * (1.0f / (1.0f - d_max));
          } else {
            pair_disc = gap * 1.0f;
          }
          if constexpr (kMode == kDcgV2Neighbor) {
            pair_disc = pair_disc * (rank_diff == 1.0f ? 1.0f : 0.0f);
          }
        }
      }
    }
    pw = pw * pair_gain;
    pw = pw * pair_disc;
    pw = pw * c.scale;
  }
  return pw;
}

// sigmoid(-d); __frcp_rn is the IEEE quotient 1 / x without a division.
__device__ __forceinline__ float sigmoid_neg(float d) {
  return __frcp_rn(1.0f + expf(d));
}

template <int kLoss>
__device__ __forceinline__ float pair_loss(float d) {
  if constexpr (kLoss == kLogistic) {
    return fmaxf(-d, 0.0f) + log1pf(expf(-fabsf(d)));
  } else if constexpr (kLoss == kHinge) {
    return fmaxf(1.0f - d, 0.0f);
  } else {
    return sigmoid_neg(d);
  }
}

template <int kLoss>
__device__ __forceinline__ float pair_grad(float d) {
  if constexpr (kLoss == kLogistic) {
    return -sigmoid_neg(d);
  } else if constexpr (kLoss == kHinge) {
    return d < 1.0f ? -1.0f : (d == 1.0f ? -0.5f : 0.0f);
  } else {
    const float s = sigmoid_neg(d);
    return -s * (1.0f - s);
  }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  }
  return v;
}

// The tile's rows [first, last) of the staged list, of n unmasked rows.
__device__ __forceinline__ void tile_rows(int n, int tiles, int tile,
                                          int* first, int* last) {
  const int per = (n + tiles - 1) / tiles;
  *first = min(n, tile * per);
  *last = min(n, *first + per);
}

// Row item r of a warp's group: row i0 + r, or a row of no pair (its label
// NaN, so that no comparison holds) past the tile's last row.
template <int kMode, bool kTables>
__device__ __forceinline__ void load_rows(const List& a, const Ctx& c, int i0,
                                          int last, Item (&x)[kRowsPerWarp]) {
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const bool live = i0 + r < last;
    x[r] = load_item<kMode, kTables>(a, live ? i0 + r : i0, c, true);
    if (!live) x[r].lab = __int_as_float(0x7fffffff);
  }
}

template <int kLoss, int kMode, bool kTables>
__device__ __forceinline__ void forward_rows(const List& a, const Ctx& c,
                                             int first, int last,
                                             float* loss_sum,
                                             float* weight_sum,
                                             int* nonzero) {
  const int lane = threadIdx.x & 31;
  for (int i0 = first + (threadIdx.x >> 5) * kRowsPerWarp; i0 < last;
       i0 += kWarps * kRowsPerWarp) {
    Item x[kRowsPerWarp];
    load_rows<kMode, kTables>(a, c, i0, last, x);
    for (int j = lane; j < a.n; j += 32) {
      const Item y = load_item<kMode, kTables>(a, j, c, false);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        if (x[r].lab - y.lab > 0.0f) {
          const float pw =
              symmetric_weight<kMode, kTables>(x[r], y, a, c) * x[r].w;
          *loss_sum += pair_loss<kLoss>(x[r].s - y.s) * pw;
          *weight_sum += pw;
          *nonzero += pw != 0.0f;
        }
      }
    }
  }
}

// One block: its tile of list b's unmasked rows against all of them.
// partial_f [B * tiles, 2] (loss sum, weight sum), partial_n [B * tiles].
template <int kLoss, int kMode>
__global__ void __launch_bounds__(kThreads)
    pairwise_fwd_kernel(Params p, float* __restrict__ partial_f,
                        int* __restrict__ partial_n) {
  extern __shared__ float sh[];
  __shared__ float red_f[2][kWarps];
  __shared__ int red_n[kWarps];
  const int b = blockIdx.x / p.tiles;
  const int tile = blockIdx.x % p.tiles;
  const List a = stage<kMode>(p, b, sh);
  const Ctx c = make_ctx<kMode>(p, b);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int first, last;
  tile_rows(a.n, p.tiles, tile, &first, &last);

  float loss_sum = 0.0f;
  float weight_sum = 0.0f;
  int nonzero = 0;
  if (is_dcg(kMode) && a.tables) {
    forward_rows<kLoss, kMode, is_dcg(kMode)>(a, c, first, last, &loss_sum,
                                              &weight_sum, &nonzero);
  } else {
    forward_rows<kLoss, kMode, false>(a, c, first, last, &loss_sum,
                                      &weight_sum, &nonzero);
  }
  loss_sum = warp_sum(loss_sum);
  weight_sum = warp_sum(weight_sum);
  nonzero = warp_sum(nonzero);
  if (lane == 0) {
    red_f[0][warp] = loss_sum;
    red_f[1][warp] = weight_sum;
    red_n[warp] = nonzero;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ls = 0.0f, ws = 0.0f;
    int n = 0;
    for (int k = 0; k < kWarps; ++k) {
      ls += red_f[0][k];
      ws += red_f[1][k];
      n += red_n[k];
    }
    partial_f[static_cast<size_t>(blockIdx.x) * 2] = ls;
    partial_f[static_cast<size_t>(blockIdx.x) * 2 + 1] = ws;
    partial_n[blockIdx.x] = n;
  }
}

// out[b] = the list's partials added in ascending tile order.
__global__ void pairwise_finalize_kernel(const float* __restrict__ partial_f,
                                         const int* __restrict__ partial_n,
                                         int B, int tiles,
                                         float* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float ls = 0.0f, ws = 0.0f;
  long long n = 0;
  for (int t = 0; t < tiles; ++t) {
    const size_t k = static_cast<size_t>(b) * tiles + t;
    ls += partial_f[k * 2];
    ws += partial_f[k * 2 + 1];
    n += partial_n[k];
  }
  out[static_cast<size_t>(b) * 3] = ls;
  out[static_cast<size_t>(b) * 3 + 1] = ws;
  out[static_cast<size_t>(b) * 3 + 2] = static_cast<float>(n);
}

template <int kLoss, int kMode, bool kTables>
__device__ __forceinline__ void backward_rows(const List& a, const Ctx& c,
                                              int first, int last, float cot,
                                              float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  for (int i0 = first + (threadIdx.x >> 5) * kRowsPerWarp; i0 < last;
       i0 += kWarps * kRowsPerWarp) {
    Item x[kRowsPerWarp];
    load_rows<kMode, kTables>(a, c, i0, last, x);
    float acc[kRowsPerWarp] = {};
    for (int j = lane; j < a.n; j += 32) {
      const Item y = load_item<kMode, kTables>(a, j, c, false);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        // (i, j) is the preference pair where l_i > l_j, (j, i) where
        // l_j > l_i, neither where they are equal. Branch-free, so that
        // the rows' dependent chains overlap.
        const float label_diff = x[r].lab - y.lab;
        const bool ij = label_diff > 0.0f;
        const float pw = symmetric_weight<kMode, kTables>(x[r], y, a, c) *
                         (ij ? x[r].w : y.w);
        const float term =
            pw * pair_grad<kLoss>(ij ? x[r].s - y.s : y.s - x[r].s);
        acc[r] += ij ? term : (label_diff < 0.0f ? -term : 0.0f);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      acc[r] = warp_sum(acc[r]);
      if (lane == 0 && i0 + r < last) out[a.pos[i0 + r]] = cot * acc[r];
    }
  }
}

// ct [B, ct_stride] (column 0 is read), dlogits [B, L].
template <int kLoss, int kMode>
__global__ void __launch_bounds__(kThreads)
    pairwise_bwd_kernel(Params p, const float* __restrict__ ct, int ct_stride,
                        float* __restrict__ dlogits) {
  extern __shared__ float sh[];
  const int L = p.L;
  const int b = blockIdx.x / p.tiles;
  const int tile = blockIdx.x % p.tiles;
  const List a = stage<kMode>(p, b, sh);
  const Ctx c = make_ctx<kMode>(p, b);
  const float cot = ct[static_cast<size_t>(b) * ct_stride];
  float* out = dlogits + static_cast<size_t>(b) * L;

  // A masked row's pairs all weigh 0: its gradient is written as 0, by the
  // block whose share of positions holds it.
  const int span = (L + p.tiles - 1) / p.tiles;
  const int pos_end = min(L, (tile + 1) * span);
  for (int i = tile * span + threadIdx.x; i < pos_end; i += kThreads) {
    if (p.mask[static_cast<size_t>(b) * L + i] == 0.0f) out[i] = cot * 0.0f;
  }
  int first, last;
  tile_rows(a.n, p.tiles, tile, &first, &last);
  if (is_dcg(kMode) && a.tables) {
    backward_rows<kLoss, kMode, is_dcg(kMode)>(a, c, first, last, cot, out);
  } else {
    backward_rows<kLoss, kMode, false>(a, c, first, last, cot, out);
  }
}

template <typename Kernel>
cudaError_t raise_smem_limit(Kernel kernel, size_t smem) {
  if (smem <= kDefaultDynamicSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int kLoss, int kMode>
cudaError_t launch_fwd(const Params& p, float* partial_f, int* partial_n,
                       float* out, cudaStream_t stream) {
  const size_t smem = smem_words(kMode, p.L) * sizeof(float);
  auto kernel = pairwise_fwd_kernel<kLoss, kMode>;
  cudaError_t err = raise_smem_limit(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<p.B * p.tiles, kThreads, smem, stream>>>(p, partial_f, partial_n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pairwise_finalize_kernel<<<(p.B + 127) / 128, 128, 0, stream>>>(
      partial_f, partial_n, p.B, p.tiles, out);
  return cudaGetLastError();
}

template <int kLoss, int kMode>
cudaError_t launch_bwd(const Params& p, const float* ct, int ct_stride,
                       float* dlogits, cudaStream_t stream) {
  const size_t smem = smem_words(kMode, p.L) * sizeof(float);
  auto kernel = pairwise_bwd_kernel<kLoss, kMode>;
  cudaError_t err = raise_smem_limit(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<p.B * p.tiles, kThreads, smem, stream>>>(p, ct, ct_stride, dlogits);
  return cudaGetLastError();
}

// Calls `fn.template operator()<kLoss, kMode>()` for the run-time pair.
template <typename Fn>
cudaError_t dispatch(int loss, int mode, Fn fn) {
#define PAIRWISE_MODES(LOSS)                                            \
  switch (mode) {                                                       \
    case kNone: return fn.template operator()<LOSS, kNone>();           \
    case kLabelDiff: return fn.template operator()<LOSS, kLabelDiff>(); \
    case kDcgV2: return fn.template operator()<LOSS, kDcgV2>();         \
    case kDcgV1: return fn.template operator()<LOSS, kDcgV1>();         \
    case kDcgV2Neighbor:                                                \
      return fn.template operator()<LOSS, kDcgV2Neighbor>();            \
    default: return cudaErrorInvalidValue;                              \
  }
  switch (loss) {
    case kLogistic: PAIRWISE_MODES(kLogistic)
    case kHinge: PAIRWISE_MODES(kHinge)
    case kSoftZeroOne: PAIRWISE_MODES(kSoftZeroOne)
    default: return cudaErrorInvalidValue;
  }
#undef PAIRWISE_MODES
}

struct ForwardCall {
  Params p;
  float* partial_f;
  int* partial_n;
  float* out;
  cudaStream_t stream;
  template <int kLoss, int kMode>
  cudaError_t operator()() const {
    return launch_fwd<kLoss, kMode>(p, partial_f, partial_n, out, stream);
  }
};

struct BackwardCall {
  Params p;
  const float* ct;
  int ct_stride;
  float* dlogits;
  cudaStream_t stream;
  template <int kLoss, int kMode>
  cudaError_t operator()() const {
    return launch_bwd<kLoss, kMode>(p, ct, ct_stride, dlogits, stream);
  }
};

bool params_ok(const Params& p) {
  return p.L <= kMaxListSize && p.tiles >= 1 &&
         p.discount_kind >= kLog2Inverse &&
         p.discount_kind <= kLog1pInverse;
}

Params make_params(const float* labels, const float* logits,
                   const float* mask, const float* weights, const float* gain,
                   const float* ranks, const float* scale, int B, int L,
                   int tiles, int discount_kind, float topn, float smooth,
                   float one_minus_smooth) {
  Params p;
  p.labels = labels;
  p.logits = logits;
  p.mask = mask;
  p.weights = weights;
  p.gain = gain;
  p.ranks = ranks;
  p.scale = scale;
  p.B = B;
  p.L = L;
  p.tiles = tiles;
  p.discount_kind = discount_kind;
  p.topn = topn;
  p.smooth = smooth;
  p.one_minus_smooth = one_minus_smooth;
  return p;
}

}  // namespace

extern "C" {

int pairwise_max_list_size() { return kMaxListSize; }
int pairwise_max_table_list_size() { return kMaxTableListSize; }

// The six per-item arrays [B, L] and scale [B], all float32 and contiguous
// on the device (gain, ranks and scale are read in the DCG modes only).
// `tiles` (>= 1) blocks share a list's rows. partial_f [B * tiles, 2] and
// partial_n [B * tiles] are scratch; out [B, 3]. Runs on `stream`; returns
// the CUDA error code of the launch (0 on success).
int pairwise_sums_forward(const float* labels, const float* logits,
                          const float* mask, const float* weights,
                          const float* gain, const float* ranks,
                          const float* scale, float* partial_f, int* partial_n,
                          float* out, int B, int L, int tiles, int loss_type,
                          int lambda_mode, int discount_kind, float topn,
                          float smooth, float one_minus_smooth,
                          cudaStream_t stream) {
  if (B <= 0 || L <= 0) return cudaSuccess;
  const Params p =
      make_params(labels, logits, mask, weights, gain, ranks, scale, B, L,
                  tiles, discount_kind, topn, smooth, one_minus_smooth);
  if (!params_ok(p)) return cudaErrorInvalidValue;
  return dispatch(loss_type, lambda_mode,
                  ForwardCall{p, partial_f, partial_n, out, stream});
}

// ct [B, ct_stride] float32 (column 0 is the cotangent of the loss sums),
// dlogits [B, L] out.
int pairwise_sums_backward(const float* labels, const float* logits,
                           const float* mask, const float* weights,
                           const float* gain, const float* ranks,
                           const float* scale, const float* ct, int ct_stride,
                           float* dlogits, int B, int L, int tiles,
                           int loss_type,
                           int lambda_mode, int discount_kind, float topn,
                           float smooth, float one_minus_smooth,
                           cudaStream_t stream) {
  if (B <= 0 || L <= 0) return cudaSuccess;
  const Params p =
      make_params(labels, logits, mask, weights, gain, ranks, scale, B, L,
                  tiles, discount_kind, topn, smooth, one_minus_smooth);
  if (!params_ok(p)) return cudaErrorInvalidValue;
  return dispatch(loss_type, lambda_mode,
                  BackwardCall{p, ct, ct_stride, dlogits, stream});
}

}  // extern "C"
