// Per-list rank-and-scatter sort for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_rank_kernel` behind
// `sorted_values_and_ranks` in ranking_tpu/ops/pallas/sort.py. Same
// function, per list b:
//   s_i    = score_i if valid_i else the row's valid minimum (0.0 when the
//            row has no valid item; a -inf minimum stays -inf),
//   j beats i  iff  s_j > s_i, or s_j == s_i and valid_j > valid_i, or both
//            equal and j < i (stable descending order, invalid items last),
//   rank_i = 1 + #{j : j beats i}              (1-based, as float),
//   sorted[b, rank_i - 1, :] = vals[b, i, :]   for rank_i - 1 < topn.
//
// Design. One CTA per list. Staging turns every item into one unique key
// whose unsigned order is the order above:
//   bits 47..16  the order-preserving bits of s_i (-0.0 folded into +0.0:
//                the sign bit set on a positive float, all bits flipped on
//                a negative one), as `_ordered_keys` in sort.py computes
//                them,
//   bit  15      valid_i,
//   bits 14..0   32767 - i, so that the earlier item wins a tie.
// The rank is then 1 + #{j : key_j > key_i}: one 64-bit integer compare a
// pair, with no compound branch. A key is kept as a 32-bit high word and a
// 16-bit low word (6 B an item), because 8-byte keys of the largest list
// (256 KiB) would not fit a block's shared memory. The list is padded to a
// multiple of 4 with key 0, which beats no item.
//
// kT threads share an item (kT = 8, 4, 2 or 1, the largest that keeps
// L * kT within one block of 1024 threads: 4 at L = 200, so that a list's
// block has 25 warps to hide shared-memory latency, where one thread an
// item would give it 7). Each counts a strided share of the keys, 4 a
// step from one 16-byte load of the high words and one 8-byte load of the
// low words; the kT lanes of an item read neighbouring chunks, which other
// items' lanes share as broadcasts, so a warp's loads meet no bank
// conflict. The partial counts add up by shuffles. The row minimum takes
// one warp-shuffle pass and one barrier; the keys are rewritten in place by
// the thread that staged them, and a second barrier publishes them. The
// rank is a permutation, so the item's first lane scatters its K channels
// straight to its sorted slot (one 8-byte load and store where K == 2);
// this scatter replaces the TPU kernel's one-hot permutation matmul.
//
// Bound. At ranking list sizes the work is tiny: B*L*L compares and
// B*L*(3 + K) + B*topn*K words of traffic (about 0.7 MB at B=128, L=200,
// K=2, topn=200), so the function is bound by bytes and, at these sizes,
// the kernel by launch latency and the dependent chain load -> minimum ->
// keys -> count -> scatter. The O(L^2) count is the price of a sort with no
// global memory scratch; it is cheap below a few thousand items per list.
//
// List size domain. kMaxListSize = 32768 items: positions fit the key's 15
// low bits, and 6 B an item take 192 KiB of the 227 KiB a block may use on
// sm_90. Above 48 KiB the launch raises the kernel's dynamic shared memory
// limit first.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxListSize = 32768;
constexpr int kMaxThreads = 1024;
constexpr int kDefaultDynamicSmem = 48 * 1024;

__device__ __forceinline__ float warp_min(float v) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, offset));
  }
  return v;
}

// Bits of x whose unsigned order is the float order, -0.0 equal to +0.0.
__device__ __forceinline__ uint32_t ordered_bits(float x) {
  if (x == 0.0f) x = 0.0f;
  const uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ uint64_t make_key(uint32_t hi, uint32_t lo) {
  return (static_cast<uint64_t>(hi) << 16) | lo;
}

__host__ __device__ inline int padded(int L) { return (L + 3) & ~3; }

// 1 + the number of keys in [0, Lp) above k, counted by the kT lanes of
// one item (lane t of them takes chunks t, t + kT, ...); every one of the
// kT lanes returns the total.
template <int kT>
__device__ __forceinline__ int rank_of(const uint4* hi4, const uint2* lo4,
                                       int chunks, uint64_t k, int t) {
  int count = 0;
  for (int q = t; q < chunks; q += kT) {
    const uint4 h = hi4[q];
    const uint2 l = lo4[q];
    count += make_key(h.x, l.x & 0xffffu) > k;
    count += make_key(h.y, l.x >> 16) > k;
    count += make_key(h.z, l.y & 0xffffu) > k;
    count += make_key(h.w, l.y >> 16) > k;
  }
  if constexpr (kT > 1) {
    const int lane = threadIdx.x & 31;
    const unsigned group = ((1u << kT) - 1u) << (lane & ~(kT - 1));
    for (int offset = kT / 2; offset > 0; offset >>= 1) {
      count += __shfl_xor_sync(group, count, offset);
    }
  }
  return count + 1;
}

template <int kT>
__global__ void rank_sort_kernel(const float* __restrict__ scores,
                                 const uint8_t* __restrict__ mask,
                                 const float* __restrict__ vals,
                                 float* __restrict__ ranks,
                                 float* __restrict__ sorted,
                                 int L, int K, int topn, bool pairs) {
  extern __shared__ uint4 smem[];
  const int Lp = padded(L);
  uint32_t* hi = reinterpret_cast<uint32_t*>(smem);
  uint16_t* lo = reinterpret_cast<uint16_t*>(hi + Lp);
  __shared__ float warp_mins[kMaxThreads / 32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const float* row_scores = scores + static_cast<size_t>(b) * L;
  const uint8_t* row_mask =
      mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * L;

  // Stage raw bits and validity, and take the minimum over valid scores.
  float local_min = CUDART_INF_F;
  for (int i = tid; i < Lp; i += nthreads) {
    uint32_t bits = 0;
    uint16_t v = 0;
    if (i < L) {
      const float x = row_scores[i];
      v = row_mask == nullptr ? 1 : (row_mask[i] != 0);
      bits = __float_as_uint(x);
      if (v) local_min = fminf(local_min, x);
    }
    hi[i] = bits;
    lo[i] = v;
  }
  local_min = warp_min(local_min);
  if ((tid & 31) == 0) warp_mins[tid >> 5] = local_min;
  __syncthreads();
  float row_min = CUDART_INF_F;
  for (int w = 0; w < (nthreads + 31) >> 5; ++w) {
    row_min = fminf(row_min, warp_mins[w]);
  }
  if (row_min == CUDART_INF_F) row_min = 0.0f;  // no valid item in the row

  // Each thread turns the items it staged into keys (padding stays 0).
  for (int i = tid; i < L; i += nthreads) {
    const uint32_t v = lo[i];
    const float x = v ? __uint_as_float(hi[i]) : row_min;
    hi[i] = ordered_bits(x);
    lo[i] = static_cast<uint16_t>((v << 15) | (kMaxListSize - 1 - i));
  }
  __syncthreads();

  const uint4* hi4 = reinterpret_cast<const uint4*>(hi);
  const uint2* lo4 = reinterpret_cast<const uint2*>(lo);
  const int t = tid % kT;
  const int groups = nthreads / kT;
  const size_t val_base = static_cast<size_t>(b) * L * K;
  const size_t out_base = static_cast<size_t>(b) * topn * K;
  for (int i = tid / kT; i < L; i += groups) {
    const uint64_t key = make_key(hi[i], lo[i]);
    const int rank = rank_of<kT>(hi4, lo4, Lp / 4, key, t);
    if (t != 0) continue;
    ranks[static_cast<size_t>(b) * L + i] = static_cast<float>(rank);
    if (rank <= topn) {
      const float* src = vals + val_base + static_cast<size_t>(i) * K;
      float* dst = sorted + out_base + static_cast<size_t>(rank - 1) * K;
      if (pairs) {
        *reinterpret_cast<float2*>(dst) =
            *reinterpret_cast<const float2*>(src);
      } else {
        for (int k = 0; k < K; ++k) dst[k] = src[k];
      }
    }
  }
}

// Threads that share one item at list size L.
int threads_per_item(int L) {
  int t = 8;
  while (t > 1 && static_cast<long long>(L) * t > kMaxThreads) t >>= 1;
  return t;
}

template <int kT>
cudaError_t launch(const float* scores, const uint8_t* mask,
                   const float* vals, float* ranks, float* sorted, int B,
                   int L, int K, int topn, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(padded(L)) * 6;
  if (smem > kDefaultDynamicSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        rank_sort_kernel<kT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int threads = ((L * kT + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  // K == 2 moves as one 8-byte load and store where both rows allow it.
  const bool pairs = K == 2 && (reinterpret_cast<uintptr_t>(vals) & 7) == 0 &&
                     (reinterpret_cast<uintptr_t>(sorted) & 7) == 0;
  rank_sort_kernel<kT><<<B, threads, smem, stream>>>(
      scores, mask, vals, ranks, sorted, L, K, topn, pairs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int rank_sort_max_list_size() { return kMaxListSize; }

// scores [B, L] f32, mask [B, L] bool bytes or null (all valid),
// vals [B, L, K] f32, ranks [B, L] f32 out, sorted [B, topn, K] f32 out;
// all contiguous on the device. Runs on `stream`; returns the CUDA error
// code of the launch (0 on success).
int rank_sort_f32(const float* scores, const uint8_t* mask, const float* vals,
                  float* ranks, float* sorted, int B, int L, int K, int topn,
                  cudaStream_t stream) {
  if (B <= 0 || L <= 0) return cudaSuccess;
  if (L > kMaxListSize || K <= 0 || topn <= 0 || topn > L) {
    return cudaErrorInvalidValue;
  }
  switch (threads_per_item(L)) {
    case 8: return launch<8>(scores, mask, vals, ranks, sorted, B, L, K,
                             topn, stream);
    case 4: return launch<4>(scores, mask, vals, ranks, sorted, B, L, K,
                             topn, stream);
    case 2: return launch<2>(scores, mask, vals, ranks, sorted, B, L, K,
                             topn, stream);
    default: return launch<1>(scores, mask, vals, ranks, sorted, B, L, K,
                              topn, stream);
  }
}

}  // extern "C"
