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
// Design. The list's per-item arrays are staged in shared memory (4 arrays
// for the first two modes, 7 for the DCG modes, the 7th being D(r_i), so
// that the inner loop calls log1p only for rank distances). A block of 8
// warps owns 32 rows i of one list; a warp takes one row at a time and
// its lanes stride over j, so a step reads 32 neighbouring words of each
// array without bank conflicts and the row's own values are registers.
// Only preference pairs of two unmasked items do any arithmetic: a pair
// with a masked item weighs 0 and adds 0 to every sum for finite logits, so
// it is skipped (in a ragged batch most pairs against padding are such).
// Lists split over L/32 blocks,
// which fills the card at B=128, L=200 (896 blocks) as at B=4, L=2048.
// Edges are masked by the loop bounds: no input is padded.
//
// Sums. A row's sums are reduced over the warp by shuffles and over the
// block's warps in a fixed order; the forward writes one partial per block
// and a second small kernel adds a list's partials in ascending order. No
// atomics: results repeat bit for bit. The count of non-zero pair weights
// is kept in integers from the lane to the last sum (a float32 count stops
// being exact at 2^24 pairs) and is converted once, at the output.
//
// Backward without a transposed pass. lambda(i, j) = lambda(j, i) and at
// most one of (i, j), (j, i) is a preference pair, so the warp that owns
// row i adds pw_ij l'(s_i - s_j) where l_i > l_j and subtracts
// pw_ji l'(s_j - s_i) where l_j > l_i in one loop over j, and writes
// dlogits_i itself: no column reduction, no cross-block sum.
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
// (exp and log, or exp and a reciprocal; none for the hinge): ranks are
// whole numbers, so every discount term of the weight could be read from
// an L-entry table. This kernel spends more than that. It evaluates
// |D(k) - D(k + 1)| and 1 / (1 - D) per pair (two log1p and up to three
// divisions), and the backward visits a preference pair from both of its
// rows.
//
// List size domain. 7 * L * 4 bytes of shared memory: kMaxListSize = 8192
// takes 224 KiB of the 227 KiB a block may use on sm_90. Above 48 KiB the
// launch raises the kernel's dynamic shared memory limit first.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMaxListSize = 8192;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = 32;
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
  int tiles;  // row tiles (blocks) per list
  int discount_kind;
  float topn;
  float smooth;
  float one_minus_smooth;
};

struct Item {
  float lab, s, m, w, g, r, d;
};

struct List {
  const float *lab, *s, *m, *w, *g, *r, *d;
};

__host__ __device__ constexpr bool is_dcg(int mode) { return mode >= kDcgV2; }

inline size_t smem_bytes(int mode, int L) {
  return static_cast<size_t>(is_dcg(mode) ? 7 : 4) * L * sizeof(float);
}

__device__ __forceinline__ float discount(int kind, float r) {
  if (kind == kInverse) return 1.0f / r;
  const float lg = log1pf(r);
  return kind == kLog2Inverse ? kLn2 / lg : 1.0f / lg;
}

// Copies list b's per-item arrays to shared memory (and D(r) for the DCG
// modes). Ends in a barrier.
template <int kMode>
__device__ __forceinline__ List stage(const Params& p, int b, float* sh) {
  const int L = p.L;
  const size_t base = static_cast<size_t>(b) * L;
  float* lab = sh;
  float* s = sh + L;
  float* m = sh + 2 * L;
  float* w = sh + 3 * L;
  float* g = sh + 4 * L;
  float* r = sh + 5 * L;
  float* d = sh + 6 * L;
  for (int i = threadIdx.x; i < L; i += kThreads) {
    lab[i] = p.labels[base + i];
    s[i] = p.logits[base + i];
    m[i] = p.mask[base + i];
    w[i] = p.weights[base + i];
    if constexpr (is_dcg(kMode)) {
      const float rank = p.ranks[base + i];
      g[i] = p.gain[base + i];
      r[i] = rank;
      d[i] = discount(p.discount_kind, rank);
    }
  }
  __syncthreads();
  return List{lab, s, m, w, g, r, d};
}

template <int kMode>
__device__ __forceinline__ Item load_item(const List& a, int i) {
  Item x;
  x.lab = a.lab[i];
  x.s = a.s[i];
  x.m = a.m[i];
  x.w = a.w[i];
  if constexpr (is_dcg(kMode)) {
    x.g = a.g[i];
    x.r = a.r[i];
    x.d = a.d[i];
  } else {
    x.g = x.r = x.d = 0.0f;
  }
  return x;
}

// valid * lambda(i, j): the part of the pair weight that (i, j) and (j, i)
// share. Multiplied up in the plain version's order.
template <int kMode>
__device__ __forceinline__ float symmetric_weight(const Item& x, const Item& y,
                                                  float scale,
                                                  const Params& p) {
  float pw = x.m * y.m;
  if constexpr (kMode == kLabelDiff) {
    pw = pw * fabsf(x.lab - y.lab);
  } else if constexpr (is_dcg(kMode)) {
    const float pair_gain = fabsf(x.g - y.g);
    const float rank_diff = fabsf(x.r - y.r);
    // Selected, not multiplied: D(0) is infinite.
    const float gap =
        rank_diff > 0.0f
            ? fabsf(discount(p.discount_kind, rank_diff) -
                    discount(p.discount_kind, rank_diff + 1.0f))
            : 0.0f;
    float pair_disc;
    if constexpr (kMode == kDcgV1) {
      const bool in_topn = x.r <= p.topn || y.r <= p.topn;
      const float u = in_topn ? gap : 0.0f;
      const float cap_x = x.r > p.topn ? 0.0f : x.d;
      const float cap_y = y.r > p.topn ? 0.0f : y.d;
      const float v = fabsf(cap_x - cap_y);
      // A multiply, a multiply and an add, each rounded, as the plain
      // version computes it.
      pair_disc = __fadd_rn(__fmul_rn(p.one_minus_smooth, u),
                            __fmul_rn(p.smooth, v));
      pair_disc = pair_disc * (in_topn ? 1.0f : 0.0f);
    } else {
      pair_disc = 0.0f;
      if (rank_diff > 0.0f) {
        const float max_rank = fmaxf(x.r, y.r);
        const float d_max = x.r >= y.r ? x.d : y.d;
        // Selected as well: 1 / (1 - D) is infinite where D == 1.
        const float mult =
            max_rank > p.topn ? 1.0f / (1.0f - d_max) : 1.0f;
        pair_disc = gap * mult;
        if constexpr (kMode == kDcgV2Neighbor) {
          pair_disc = pair_disc * (rank_diff == 1.0f ? 1.0f : 0.0f);
        }
      }
    }
    pw = pw * pair_gain;
    pw = pw * pair_disc;
    pw = pw * scale;
  }
  return pw;
}

__device__ __forceinline__ float sigmoid_neg(float d) {  // sigmoid(-d)
  return 1.0f / (1.0f + expf(d));
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

// One block: rows [tile * 32, tile * 32 + 32) of list b against all j.
// partial_f [B * tiles, 2] (loss sum, weight sum), partial_n [B * tiles].
template <int kLoss, int kMode>
__global__ void __launch_bounds__(kThreads)
    pairwise_fwd_kernel(Params p, float* __restrict__ partial_f,
                        int* __restrict__ partial_n) {
  extern __shared__ float sh[];
  __shared__ float red_f[2][kWarps];
  __shared__ int red_n[kWarps];
  const int L = p.L;
  const int b = blockIdx.x / p.tiles;
  const int tile = blockIdx.x % p.tiles;
  const List a = stage<kMode>(p, b, sh);
  const float scale = is_dcg(kMode) ? p.scale[b] : 1.0f;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float loss_sum = 0.0f;
  float weight_sum = 0.0f;
  int nonzero = 0;
  const int row_end = min(L, (tile + 1) * kRowsPerBlock);
  for (int i = tile * kRowsPerBlock + warp; i < row_end; i += kWarps) {
    const Item x = load_item<kMode>(a, i);
    if (x.m == 0.0f) continue;  // every pair of a masked row weighs 0
    for (int j = lane; j < L; j += 32) {
      const Item y = load_item<kMode>(a, j);
      if (x.lab - y.lab > 0.0f && y.m != 0.0f) {
        const float pw = symmetric_weight<kMode>(x, y, scale, p) * x.w;
        loss_sum += pair_loss<kLoss>(x.s - y.s) * pw;
        weight_sum += pw;
        nonzero += pw != 0.0f;
      }
    }
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
  const float scale = is_dcg(kMode) ? p.scale[b] : 1.0f;
  const float cot = ct[static_cast<size_t>(b) * ct_stride];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const int row_end = min(L, (tile + 1) * kRowsPerBlock);
  for (int i = tile * kRowsPerBlock + warp; i < row_end; i += kWarps) {
    const Item x = load_item<kMode>(a, i);
    float acc = 0.0f;
    // A masked row's pairs all weigh 0: its gradient is written as 0.
    for (int j = lane; j < L && x.m != 0.0f; j += 32) {
      const Item y = load_item<kMode>(a, j);
      if (y.m == 0.0f) continue;
      const float label_diff = x.lab - y.lab;
      if (label_diff > 0.0f) {
        const float pw = symmetric_weight<kMode>(x, y, scale, p) * x.w;
        acc += pw * pair_grad<kLoss>(x.s - y.s);
      } else if (label_diff < 0.0f) {
        const float pw = symmetric_weight<kMode>(y, x, scale, p) * y.w;
        acc -= pw * pair_grad<kLoss>(y.s - x.s);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) dlogits[static_cast<size_t>(b) * L + i] = cot * acc;
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
  const size_t smem = smem_bytes(kMode, p.L);
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
  const size_t smem = smem_bytes(kMode, p.L);
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
  return p.L <= kMaxListSize && p.discount_kind >= kLog2Inverse &&
         p.discount_kind <= kLog1pInverse;
}

Params make_params(const float* labels, const float* logits,
                   const float* mask, const float* weights, const float* gain,
                   const float* ranks, const float* scale, int B, int L,
                   int discount_kind, float topn, float smooth,
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
  p.tiles = (L + kRowsPerBlock - 1) / kRowsPerBlock;
  p.discount_kind = discount_kind;
  p.topn = topn;
  p.smooth = smooth;
  p.one_minus_smooth = one_minus_smooth;
  return p;
}

}  // namespace

extern "C" {

int pairwise_max_list_size() { return kMaxListSize; }
int pairwise_rows_per_block() { return kRowsPerBlock; }

// The six per-item arrays [B, L] and scale [B], all float32 and contiguous
// on the device (gain, ranks and scale are read in the DCG modes only).
// partial_f [B * tiles, 2] and partial_n [B * tiles] are scratch, with
// tiles = ceil(L / pairwise_rows_per_block()); out [B, 3]. Runs on `stream`;
// returns the CUDA error code of the launch (0 on success).
int pairwise_sums_forward(const float* labels, const float* logits,
                          const float* mask, const float* weights,
                          const float* gain, const float* ranks,
                          const float* scale, float* partial_f, int* partial_n,
                          float* out, int B, int L, int loss_type,
                          int lambda_mode, int discount_kind, float topn,
                          float smooth, float one_minus_smooth,
                          cudaStream_t stream) {
  if (B <= 0 || L <= 0) return cudaSuccess;
  const Params p =
      make_params(labels, logits, mask, weights, gain, ranks, scale, B, L,
                  discount_kind, topn, smooth, one_minus_smooth);
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
                           float* dlogits, int B, int L, int loss_type,
                           int lambda_mode, int discount_kind, float topn,
                           float smooth, float one_minus_smooth,
                           cudaStream_t stream) {
  if (B <= 0 || L <= 0) return cudaSuccess;
  const Params p =
      make_params(labels, logits, mask, weights, gain, ranks, scale, B, L,
                  discount_kind, topn, smooth, one_minus_smooth);
  if (!params_ok(p)) return cudaErrorInvalidValue;
  return dispatch(loss_type, lambda_mode,
                  BackwardCall{p, ct, ct_stride, dlogits, stream});
}

}  // extern "C"
