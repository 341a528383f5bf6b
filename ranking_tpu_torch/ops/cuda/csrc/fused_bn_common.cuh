// Shared pieces of the fused masked-BN tower kernels (fused_bn_fwd.cu,
// fused_bn_bwd.cu): operand descriptors that apply the BN fold, the ReLU,
// the dy rebuild or the row mask while a tile is loaded, two float32 FMA
// tile products, and the ordered second pass over per-block partial sums.
//
// Products. Every matrix product of these kernels is computed here, by
// hand: a 128x128 output tile per block of 256 threads, 8-deep slices
// staged in shared memory, an 8x8 register tile per thread (two 4-wide
// strips 64 apart in each direction, so that shared-memory reads are
// float4 and free of bank conflicts), float32 FMAs and float32 sums. The
// next slice is fetched into registers while the current one is multiplied.
// The kernels are held to 128 registers so that two blocks share a
// multiprocessor and one block's loads hide behind the other's FMAs; a
// deeper slice (16) or one block per multiprocessor measured slower.
// With bf16 storage the operands are rounded to bf16 as they are loaded
// and multiplied as float32: products of bf16 values are exact in float32,
// so this equals a bf16 product with float32 accumulation up to the order
// of the sums.
//
// Sums that cross blocks. Blocks run in no order, so a sum over rows
// (column statistics, dW, A, B) is written as one partial per block and
// added up by `reduce_partials_kernel` in a fixed order. Partials were
// chosen over atomics: the result is the same from run to run.
//
// Ragged edges. No input is padded. `fetch` returns 0 outside a matrix and
// every epilogue checks its row and column, so edge rows add nothing to
// any sum.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace fbn {

constexpr int kBM = 128;       // output tile rows
constexpr int kBN = 128;       // output tile columns
constexpr int kBK = 8;         // depth of one staged slice
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int kPad = 4;        // keeps float4 alignment, spreads banks
constexpr int kLd = kBM + kPad;
// Elements of one staged slice that each thread loads, per operand.
constexpr int kLoads = kBM * kBK / kThreads;

enum Mode { kRaw = 0, kFold = 1, kDy = 2, kRowMask = 3 };

// A [rows, cols] row-major matrix whose elements are transformed as they
// are loaded, by the mode its kernel was instantiated with:
//   kRaw:     p
//   kFold:    z = p * v0[c] + v1[c], then relu if `relu`
//   kDy:      g = p, y = q: dyhat = (y * v0[c] + v1[c] > 0) ? g : 0,
//             dy = v0[c] * dyhat - rowmask[r] * (y * v3[c] + v2[c])
//             (v0 = s, v1 = t, v2 = c1, v3 = c2)
//   kRowMask: rowmask[r] * p
// and rounded to bf16 (kept as float) if `round_bf16`.
struct Operand {
  const void* p;
  const void* q;
  const float* v0;
  const float* v1;
  const float* v2;
  const float* v3;
  const float* rowmask;
  int p_bf16;
  int ld;
  int rows;
  int cols;
  int relu;
  int round_bf16;
};

// A weight matrix W(k, n) = p[k * ldk + n * ldn], K x N, float32 or bf16.
// Strides let the caller pass either parameter layout, or its transpose.
struct WOperand {
  const void* p;
  long long ldk;
  long long ldn;
  int bf16;
  int K;
  int N;
};

__device__ __forceinline__ float load_elem(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_elem(void* p, size_t i, int bf16,
                                           float v) {
  if (bf16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

__device__ __forceinline__ float round_to_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// x * s + t as a multiply and an add, each rounded: the plain PyTorch
// versions compute it so, and a fused multiply-add would round once and
// could open a ReLU gate (x s + t > 0) that they keep shut.
__device__ __forceinline__ float scale_shift(float x, float s, float t) {
  return __fadd_rn(__fmul_rn(x, s), t);
}

// Element (r, c) of an operand whose mode is known when the kernel is
// compiled: each kernel is instantiated for the modes it is launched with,
// so the other modes cost no registers and no branches.
template <int kMode>
__device__ __forceinline__ float fetch(const Operand& o, int r, int c) {
  if (r >= o.rows || c >= o.cols) return 0.0f;
  const size_t i = static_cast<size_t>(r) * o.ld + c;
  float v = load_elem(o.p, i, o.p_bf16);
  if constexpr (kMode == kFold) {
    v = scale_shift(v, o.v0[c], o.v1[c]);
    if (o.relu) v = fmaxf(v, 0.0f);
  } else if constexpr (kMode == kDy) {
    const float y = load_elem(o.q, i, o.p_bf16);
    const float s = o.v0[c];
    const float yhat = scale_shift(y, s, o.v1[c]);
    const float dyhat = yhat > 0.0f ? v : 0.0f;
    v = s * dyhat - o.rowmask[r] * (y * o.v3[c] + o.v2[c]);
  } else if constexpr (kMode == kRowMask) {
    v = o.rowmask[r] * v;
  }
  return o.round_bf16 ? round_to_bf16(v) : v;
}

__device__ __forceinline__ float fetch_w(const WOperand& w, int k, int n) {
  if (k >= w.K || n >= w.N) return 0.0f;
  return load_elem(w.p, static_cast<size_t>(k) * w.ldk +
                            static_cast<size_t>(n) * w.ldn, w.bf16);
}

// Row (or column) of this thread's i-th output within the tile: two strips
// of 4, 64 apart.
__device__ __forceinline__ int strip(int t, int i) {
  return i < 4 ? t * 4 + i : 64 + t * 4 + (i - 4);
}

// acc += As^T-slice (x) Bs-slice over one staged slice.
__device__ __forceinline__ void multiply_slice(const float (*As)[kLd],
                                               const float (*Bs)[kLd], int ty,
                                               int tx, float acc[8][8]) {
#pragma unroll
  for (int k = 0; k < kBK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] += av[i] * bv[j];
    }
  }
}

// Element e (0 .. kBM * kBK - 1) of a staged slice, for a source whose depth index is
// contiguous in memory (read along the depth, stored transposed) ...
__device__ __forceinline__ void split_depth_major(int e, int* k, int* m) {
  *k = e % kBK;
  *m = e / kBK;
}

// ... and for a source whose output index is contiguous in memory.
__device__ __forceinline__ void split_output_major(int e, int* k, int* m) {
  *m = e % kBM;
  *k = e / kBM;
}

// acc[i][j] = sum_k a(m0 + row_i, k) * w(k, n0 + col_j), k over [0, w.K).
// `a` is read along its columns (the depth).
template <int kModeA>
__device__ __forceinline__ void product_rows(const Operand& a,
                                             const WOperand& w, int m0, int n0,
                                             float (*As)[kLd], float (*Bs)[kLd],
                                             float acc[8][8]) {
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const bool w_output_major = w.ldn == 1;
  float ra[kLoads], rb[kLoads];
  const int depth = w.K;

  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      int k, m;
      split_depth_major(tid + kThreads * i, &k, &m);
      ra[i] = fetch<kModeA>(a, m0 + m, k0 + k);
      if (w_output_major) {
        split_output_major(tid + kThreads * i, &k, &m);
      }
      rb[i] = fetch_w(w, k0 + k, n0 + m);
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      int k, m;
      split_depth_major(tid + kThreads * i, &k, &m);
      As[k][m] = ra[i];
      if (w_output_major) {
        split_output_major(tid + kThreads * i, &k, &m);
      }
      Bs[k][m] = rb[i];
    }
  };

  load(0);
  stage();
  __syncthreads();
  for (int k0 = 0; k0 < depth; k0 += kBK) {
    const bool more = k0 + kBK < depth;
    if (more) load(k0 + kBK);
    multiply_slice(As, Bs, ty, tx, acc);
    __syncthreads();
    if (more) {
      stage();
      __syncthreads();
    }
  }
}

// acc[i][j] = sum_r a(r, i0 + row_i) * b(r, j0 + col_j), r over
// [r_begin, r_end). Both operands are read along their columns (the outputs).
template <int kModeA, int kModeB>
__device__ __forceinline__ void product_over_rows(const Operand& a,
                                                  const Operand& b, int i0,
                                                  int j0, int r_begin,
                                                  int r_end, float (*As)[kLd],
                                                  float (*Bs)[kLd],
                                                  float acc[8][8]) {
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  float ra[kLoads], rb[kLoads];

  auto load = [&](int r0) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      int k, m;
      split_output_major(tid + kThreads * i, &k, &m);
      const int r = r0 + k;
      ra[i] = r < r_end ? fetch<kModeA>(a, r, i0 + m) : 0.0f;
      rb[i] = r < r_end ? fetch<kModeB>(b, r, j0 + m) : 0.0f;
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      int k, m;
      split_output_major(tid + kThreads * i, &k, &m);
      As[k][m] = ra[i];
      Bs[k][m] = rb[i];
    }
  };

  if (r_begin >= r_end) return;
  load(r_begin);
  stage();
  __syncthreads();
  for (int r0 = r_begin; r0 < r_end; r0 += kBK) {
    const bool more = r0 + kBK < r_end;
    if (more) load(r0 + kBK);
    multiply_slice(As, Bs, ty, tx, acc);
    __syncthreads();
    if (more) {
      stage();
      __syncthreads();
    }
  }
}

// Adds this block's two column partials (over its 128 rows) up across the 16
// thread rows, in a fixed order, and writes them to row `block_row` of the
// partial arrays p0 and p1 ([row blocks, n_cols]).
__device__ __forceinline__ void write_column_partials(
    const float c0[8], const float c1[8], float (*red)[16][kBN], int n0,
    int n_cols, int block_row, float* p0, float* p1) {
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    red[0][ty][strip(tx, j)] = c0[j];
    red[1][ty][strip(tx, j)] = c1[j];
  }
  __syncthreads();
  const int which = tid / kBN;
  const int c = tid % kBN;
  float total = 0.0f;
#pragma unroll
  for (int t = 0; t < 16; ++t) total += red[which][t][c];
  if (n0 + c < n_cols) {
    float* out = which == 0 ? p0 : p1;
    out[static_cast<size_t>(block_row) * n_cols + n0 + c] = total;
  }
}

// out[i] = sum_s partial[s * n + i], s ascending: the ordered second pass.
__global__ void reduce_partials_kernel(const float* __restrict__ partial,
                                       int splits, size_t n,
                                       float* __restrict__ out) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float total = 0.0f;
  for (int s = 0; s < splits; ++s) total += partial[s * n + i];
  out[i] = total;
}

inline cudaError_t reduce_partials(const float* partial, int splits, size_t n,
                                   float* out, cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  reduce_partials_kernel<<<blocks, threads, 0, stream>>>(partial, splits, n,
                                                         out);
  return cudaGetLastError();
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace fbn
