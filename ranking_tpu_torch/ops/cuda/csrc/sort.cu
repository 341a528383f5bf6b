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
// Design. One CTA per list. The scores and validity of the list are staged
// in dynamic shared memory (5 bytes per item); a block reduction gives the
// row minimum. Each thread then counts, for each of its items, how many
// items beat it: every thread of a warp reads the same s_j in the same
// step, so the loop is a shared-memory broadcast without bank conflicts.
// The rank is a permutation, so each thread scatters its item's K channels
// straight to its sorted slot; this scatter replaces the TPU kernel's
// one-hot permutation matmul (a gather the TPU has to run on its MXU).
//
// Bound. At ranking list sizes the work is tiny: B*L*L compares and
// B*L*(3 + K) + B*topn*K words of traffic (about 0.7 MB at B=128, L=200,
// K=2, topn=200), so the kernel is bound by bytes and, at these sizes, by
// launch latency. The O(L^2) count is the price of a sort with no global
// memory scratch; it is cheap below a few thousand items per list.
//
// List size domain. Scores (4 B) and validity (1 B) of one list live in
// shared memory: kMaxListSize = 32768 items take 160 KiB of the 227 KiB a
// block may use on sm_90. Above 48 KiB the launch raises the kernel's
// dynamic shared memory limit first.

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

__global__ void rank_sort_kernel(const float* __restrict__ scores,
                                 const uint8_t* __restrict__ mask,
                                 const float* __restrict__ vals,
                                 float* __restrict__ ranks,
                                 float* __restrict__ sorted,
                                 int L, int K, int topn) {
  extern __shared__ unsigned char smem[];
  float* s = reinterpret_cast<float*>(smem);
  uint8_t* valid = smem + static_cast<size_t>(L) * sizeof(float);
  __shared__ float warp_mins[kMaxThreads / 32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const float* row_scores = scores + static_cast<size_t>(b) * L;
  const uint8_t* row_mask =
      mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * L;

  // Stage the row and take the minimum over its valid scores.
  float local_min = CUDART_INF_F;
  for (int i = tid; i < L; i += nthreads) {
    const float x = row_scores[i];
    const uint8_t v = row_mask == nullptr ? 1 : (row_mask[i] != 0);
    s[i] = x;
    valid[i] = v;
    if (v) local_min = fminf(local_min, x);
  }
  local_min = warp_min(local_min);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (lane == 0) warp_mins[warp] = local_min;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = (nthreads + 31) >> 5;
    float m = lane < nwarps ? warp_mins[lane] : CUDART_INF_F;
    m = warp_min(m);
    if (lane == 0) warp_mins[0] = m;
  }
  __syncthreads();
  float row_min = warp_mins[0];
  if (row_min == CUDART_INF_F) row_min = 0.0f;  // no valid item in the row

  for (int i = tid; i < L; i += nthreads) {
    if (!valid[i]) s[i] = row_min;
  }
  __syncthreads();

  const size_t val_base = static_cast<size_t>(b) * L * K;
  const size_t out_base = static_cast<size_t>(b) * topn * K;
  for (int i = tid; i < L; i += nthreads) {
    const float si = s[i];
    const uint8_t vi = valid[i];
    int count = 0;
    for (int j = 0; j < L; ++j) {
      const float sj = s[j];
      const uint8_t vj = valid[j];
      count += (sj > si) || (sj == si && (vj > vi || (vj == vi && j < i)));
    }
    ranks[static_cast<size_t>(b) * L + i] = static_cast<float>(count + 1);
    if (count < topn) {
      const float* src = vals + val_base + static_cast<size_t>(i) * K;
      float* dst = sorted + out_base + static_cast<size_t>(count) * K;
      for (int k = 0; k < K; ++k) dst[k] = src[k];
    }
  }
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
  const size_t smem = static_cast<size_t>(L) * (sizeof(float) + 1);
  if (smem > kDefaultDynamicSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        rank_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int threads = ((L + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  rank_sort_kernel<<<B, threads, smem, stream>>>(scores, mask, vals, ranks,
                                                 sorted, L, K, topn);
  return cudaGetLastError();
}

}  // extern "C"
