// The fused masked-BN tower's backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of ranking_tpu/ops/pallas/fused_bn.py:
//   `_bwd_stats_kernel` (`_bwd_stats`):   fused_bn_bwd_stats
//   `_bwd_mats_kernel`  (`_bwd_mats`):    fused_bn_bwd_dx, fused_bn_bwd_dw,
//                                         fused_bn_bwd_ab
//   `_dx_kernel`        (`_bwd_dx_only`): fused_bn_bwd_dx without the
//                                         layer-below epilogue
//   `_dw_only_kernel`   (`_bwd_dw_only`): fused_bn_bwd_dw
// They share the rebuild of dy from (g, y) (`_dy_tile` there, Operand mode
// kDy here):
//   dyhat = g where y s + t > 0 (strictly), else 0
//   dy    = s dyhat - mask (y c2 + c1)
// The reduction terms s1 = sum dyhat, s2 = sum dyhat y run over ALL rows;
// only dy's correction term carries the mask.
//
// Design. dy is never written: both products that consume it rebuild it
// from g and y while they load their tiles.
//   dx = dy W^T            one 128 x 128 tile per block (product_rows). Its
//                          epilogue gates the tile by the layer below's
//                          pre-activation (x_in s_in + t_in > 0) and writes
//                          that layer's s1, s2 as per-block column partials.
//   dW^T = dy^T z          a product that reduces over the N rows
//                          (product_over_rows). The output has few tiles,
//                          so the rows are split over gridDim.z and every
//                          split writes a partial [F_out, F_in].
//   A^T = dyhat_prev^T x0, B^T = (mask x_in)^T x0: the same product.
// Every sum over rows is finished by `reduce_partials_kernel` in a fixed
// order; there are no atomics.
//
// What this version writes that the TPU kernel kept on chip. The TPU kernel
// fed A = x0^T dyhat_prev from the dx tile in VMEM. Here dyhat_prev of
// layer 1 ([N, F_1], the activation type) goes through a scratch buffer in
// device memory between fused_bn_bwd_dx and fused_bn_bwd_ab; dx itself is
// still not written on that path. dy is rebuilt twice (for dx and for dW),
// which reads g and y twice. The bound in PERF.md counts neither.
//
// Bound. 4 N F_in F_out operations (plus 4 N F_0 F_in with the fold) on
// about 4 (3 N F_out + 2 N F_in + 2 F_in F_out) bytes: operations bound it
// at the tower's widths. The products run on the float32 pipes.

#include "fused_bn_common.cuh"

using namespace fbn;

namespace {

constexpr int kStatCols = 32;
constexpr int kStatRowsPerBlock = 256;

// Top layer's s1, s2: one partial per block of 256 rows x 32 columns.
__global__ void bwd_stats_kernel(const void* __restrict__ g,
                                 const void* __restrict__ y, int bf16,
                                 const float* __restrict__ s,
                                 const float* __restrict__ t, int N, int F,
                                 float* __restrict__ part_s1,
                                 float* __restrict__ part_s2) {
  __shared__ float red[2][8][kStatCols];
  const int c = blockIdx.x * kStatCols + threadIdx.x;
  const int r_begin = blockIdx.y * kStatRowsPerBlock;
  const int r_end = min(N, r_begin + kStatRowsPerBlock);
  float s1 = 0.0f, s2 = 0.0f;
  if (c < F) {
    const float sc = s[c];
    const float tc = t[c];
    for (int r = r_begin + threadIdx.y; r < r_end; r += 8) {
      const size_t i = static_cast<size_t>(r) * F + c;
      const float gv = load_elem(g, i, bf16);
      const float yv = load_elem(y, i, bf16);
      const float dyhat = scale_shift(yv, sc, tc) > 0.0f ? gv : 0.0f;
      s1 += dyhat;
      s2 += dyhat * yv;
    }
  }
  red[0][threadIdx.y][threadIdx.x] = s1;
  red[1][threadIdx.y][threadIdx.x] = s2;
  __syncthreads();
  if (threadIdx.y < 2 && c < F) {
    float total = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) total += red[threadIdx.y][k][threadIdx.x];
    float* out = threadIdx.y == 0 ? part_s1 : part_s2;
    out[static_cast<size_t>(blockIdx.y) * F + c] = total;
  }
}

// dx = dy W^T with the layer-below epilogue. `wt` is W read as
// (depth = F_out, output = F_in). Optional outputs: dx, dyhat_prev; with
// x_in given, the column partials of s1 = sum dyhat_prev and
// s2 = sum dyhat_prev x_in.
__global__ void __launch_bounds__(kThreads, 2)
bwd_dx_kernel(Operand dy, WOperand wt, const void* __restrict__ x_in,
              int xin_bf16, const float* __restrict__ s_in,
              const float* __restrict__ t_in, void* __restrict__ dx,
              int dx_bf16, void* __restrict__ dyhat_prev, int dyhat_bf16,
              float* __restrict__ part_s1, float* __restrict__ part_s2) {
  __shared__ __align__(16) float As[kBK][kLd];
  __shared__ __align__(16) float Bs[kBK][kLd];
  __shared__ float red[2][16][kBN];

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int n_rows = dy.rows;
  const int n_cols = wt.N;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  product_rows<kDy>(dy, wt, m0, n0, As, Bs, acc);

  float c1[8], c2[8], sv[8], tv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = n0 + strip(tx, j);
    c1[j] = 0.0f;
    c2[j] = 0.0f;
    sv[j] = (x_in != nullptr && c < n_cols) ? s_in[c] : 0.0f;
    tv[j] = (x_in != nullptr && c < n_cols) ? t_in[c] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + strip(ty, i);
    if (r >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + strip(tx, j);
      if (c >= n_cols) continue;
      const size_t idx = static_cast<size_t>(r) * n_cols + c;
      const float v = acc[i][j];
      if (dx != nullptr) store_elem(dx, idx, dx_bf16, v);
      if (x_in != nullptr) {
        const float xv = load_elem(x_in, idx, xin_bf16);
        const float dyh = scale_shift(xv, sv[j], tv[j]) > 0.0f ? v : 0.0f;
        c1[j] += dyh;
        c2[j] += dyh * xv;
        if (dyhat_prev != nullptr) {
          store_elem(dyhat_prev, idx, dyhat_bf16, dyh);
        }
      }
    }
  }
  if (x_in != nullptr) {
    write_column_partials(c1, c2, red, n0, n_cols, blockIdx.y, part_s1,
                          part_s2);
  }
}

// partial[z][i, j] = sum over the z-th chunk of rows of a(r, i) b(r, j).
template <int kModeA, int kModeB>
__global__ void __launch_bounds__(kThreads, 2)
over_rows_kernel(Operand a, Operand b, int chunk_rows,
                 float* __restrict__ partial) {
  __shared__ __align__(16) float As[kBK][kLd];
  __shared__ __align__(16) float Bs[kBK][kLd];

  const int j0 = blockIdx.x * kBN;
  const int i0 = blockIdx.y * kBM;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int r_begin = blockIdx.z * chunk_rows;
  const int r_end = min(a.rows, r_begin + chunk_rows);
  const int n_i = a.cols;
  const int n_j = b.cols;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  product_over_rows<kModeA, kModeB>(a, b, i0, j0, r_begin, r_end, As, Bs,
                                    acc);

  float* out = partial + static_cast<size_t>(blockIdx.z) * n_i * n_j;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = i0 + strip(ty, i);
    if (r >= n_i) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j0 + strip(tx, j);
      if (c < n_j) out[static_cast<size_t>(r) * n_j + c] = acc[i][j];
    }
  }
}

Operand dy_operand(const void* g, const void* y, int bf16, const float* mask,
                   const float* s, const float* t, const float* c1,
                   const float* c2, int N, int F, int round_bf16) {
  Operand o = {};
  o.p = g;
  o.q = y;
  o.p_bf16 = bf16;
  o.ld = F;
  o.rows = N;
  o.cols = F;
  o.v0 = s;
  o.v1 = t;
  o.v2 = c1;
  o.v3 = c2;
  o.rowmask = mask;
  o.round_bf16 = round_bf16;
  return o;
}

Operand raw_operand(const void* p, int bf16, int N, int F, int round_bf16) {
  Operand o = {};
  o.p = p;
  o.p_bf16 = bf16;
  o.ld = F;
  o.rows = N;
  o.cols = F;
  o.round_bf16 = round_bf16;
  return o;
}

// out[I, J] = sum_r a(r, i) b(r, j), rows split into `splits` chunks of
// `chunk_rows` (a multiple of the slice depth). `partial` holds
// splits * I * J floats; with one split the product goes straight to `out`.
template <int kModeA, int kModeB>
cudaError_t over_rows(const Operand& a, const Operand& b, int splits,
                      int chunk_rows, float* partial, float* out,
                      cudaStream_t stream) {
  if (splits < 1 || chunk_rows < 1 || chunk_rows % kBK != 0 ||
      static_cast<long long>(splits) * chunk_rows < a.rows) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(cdiv(b.cols, kBN), cdiv(a.cols, kBM), splits);
  over_rows_kernel<kModeA, kModeB><<<grid, kThreads, 0, stream>>>(
      a, b, chunk_rows, splits == 1 ? out : partial);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return reduce_partials(partial, splits,
                         static_cast<size_t>(a.cols) * b.cols, out, stream);
}

}  // namespace

extern "C" {

// Rows one block of fused_bn_bwd_stats reduces, and rows one block of
// fused_bn_bwd_dx reduces: the wrapper sizes the partial buffers with them.
int fused_bn_stat_rows() { return kStatRowsPerBlock; }
int fused_bn_tile_rows() { return fbn::kBM; }
int fused_bn_slice_depth() { return fbn::kBK; }

// g, y [N, F] (f32 or bf16), s, t [F] -> s1, s2 [F] f32.
// `partial`: 2 * ceil(N / stat_rows) * F floats.
int fused_bn_bwd_stats(const void* g, const void* y, int bf16, const float* s,
                       const float* t, float* partial, float* s1, float* s2,
                       int N, int F, cudaStream_t stream) {
  if (N <= 0 || F <= 0) return cudaErrorInvalidValue;
  const int row_blocks = fbn::cdiv(N, kStatRowsPerBlock);
  float* part_s1 = partial;
  float* part_s2 = partial + static_cast<size_t>(row_blocks) * F;
  const dim3 grid(fbn::cdiv(F, kStatCols), row_blocks);
  const dim3 block(kStatCols, 8);
  bwd_stats_kernel<<<grid, block, 0, stream>>>(g, y, bf16, s, t, N, F,
                                               part_s1, part_s2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = fbn::reduce_partials(part_s1, row_blocks, F, s1, stream);
  if (err != cudaSuccess) return err;
  return fbn::reduce_partials(part_s2, row_blocks, F, s2, stream);
}

// dx [N, F_in] = dy W^T, dy rebuilt from g, y [N, F_out] (f32 or bf16), mask
// [N], s, t, c1, c2 [F_out]; W(k, n) = w[k * w_ldk + n * w_ldn] is
// F_in x F_out. dx and dyhat_prev may be null (not written). With x_in
// [N, F_in] given (else null), also s1, s2 [F_in] of the layer below, through
// `partial` (2 * ceil(N / tile_rows) * F_in floats).
int fused_bn_bwd_dx(const void* g, const void* y, int gy_bf16,
                    const float* mask, const float* s, const float* t,
                    const float* c1, const float* c2, const void* w,
                    int w_bf16, long long w_ldk, long long w_ldn,
                    const void* x_in, int xin_bf16, const float* s_in,
                    const float* t_in, void* dx, int dx_bf16,
                    void* dyhat_prev, int dyhat_bf16, float* partial,
                    float* s1, float* s2, int N, int F_in, int F_out,
                    cudaStream_t stream) {
  if (N <= 0 || F_in <= 0 || F_out <= 0) return cudaErrorInvalidValue;
  const Operand dy = dy_operand(g, y, gy_bf16, mask, s, t, c1, c2, N, F_out,
                                w_bf16);
  // dx[m, k] = sum_n dy[m, n] W[k, n]: depth runs over W's second index.
  const WOperand wt = {w, w_ldn, w_ldk, w_bf16, F_out, F_in};
  const int row_blocks = fbn::cdiv(N, fbn::kBM);
  float* part_s1 = partial;
  float* part_s2 = x_in == nullptr
                       ? nullptr
                       : partial + static_cast<size_t>(row_blocks) * F_in;
  const dim3 grid(fbn::cdiv(F_in, fbn::kBN), row_blocks);
  bwd_dx_kernel<<<grid, fbn::kThreads, 0, stream>>>(
      dy, wt, x_in, xin_bf16, s_in, t_in, dx, dx_bf16, dyhat_prev, dyhat_bf16,
      part_s1, part_s2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || x_in == nullptr) return err;
  err = fbn::reduce_partials(part_s1, row_blocks, F_in, s1, stream);
  if (err != cudaSuccess) return err;
  return fbn::reduce_partials(part_s2, row_blocks, F_in, s2, stream);
}

// dw_t [F_out, F_in] = dy^T z, z = x_in s_in + t_in (relu if asked), both
// rounded to bf16 first if round_bf16. `partial`: splits * F_out * F_in.
int fused_bn_bwd_dw(const void* g, const void* y, int gy_bf16,
                    const float* mask, const float* s, const float* t,
                    const float* c1, const float* c2, const void* x_in,
                    int xin_bf16, const float* s_in, const float* t_in,
                    int relu_in, int round_bf16, int splits, int chunk_rows,
                    float* partial, float* dw_t, int N, int F_in, int F_out,
                    cudaStream_t stream) {
  if (N <= 0 || F_in <= 0 || F_out <= 0) return cudaErrorInvalidValue;
  const Operand dy = dy_operand(g, y, gy_bf16, mask, s, t, c1, c2, N, F_out,
                                round_bf16);
  Operand z = raw_operand(x_in, xin_bf16, N, F_in, round_bf16);
  z.v0 = s_in;
  z.v1 = t_in;
  z.relu = relu_in;
  return over_rows<kDy, kFold>(dy, z, splits, chunk_rows, partial, dw_t,
                               stream);
}

// a_t [F_in, F_0] = dyhat_prev^T x0 and b_t [F_in, F_0] = (mask x_in)^T x0:
// the two products of layer 0's dW that reduce over rows. x0 [N, F_0] f32;
// dyhat_prev, x_in [N, F_in]. `partial`: splits * F_in * F_0 floats, used by
// one product after the other.
int fused_bn_bwd_ab(const float* x0, const void* dyhat_prev, int dyhat_bf16,
                    const void* x_in, int xin_bf16, const float* mask,
                    int round_bf16, int splits, int chunk_rows, float* partial,
                    float* a_t, float* b_t, int N, int F_0, int F_in,
                    cudaStream_t stream) {
  if (N <= 0 || F_0 <= 0 || F_in <= 0) return cudaErrorInvalidValue;
  const Operand x = raw_operand(x0, 0, N, F_0, round_bf16);
  const Operand d = raw_operand(dyhat_prev, dyhat_bf16, N, F_in, round_bf16);
  Operand mx = raw_operand(x_in, xin_bf16, N, F_in, round_bf16);
  mx.rowmask = mask;
  const cudaError_t err = over_rows<kRaw, kRaw>(d, x, splits, chunk_rows,
                                                partial, a_t, stream);
  if (err != cudaSuccess) return err;
  return over_rows<kRowMask, kRaw>(mx, x, splits, chunk_rows, partial, b_t,
                                   stream);
}

}  // extern "C"
