// One layer of the fused masked-BN tower, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` behind `_layer_forward` in
// ranking_tpu/ops/pallas/fused_bn.py. Same function:
//   z = x * s_in + t_in            (the layer below's BN fold), relu if asked,
//   y = z W + b                    (z and W rounded to bf16 first when the
//                                   activations are stored as bf16),
//   col_sum = sum_r mask_r y_r,  col_ssq = sum_r mask_r y_r^2
// with the statistics taken from the float32 y before it is rounded for
// storage. The fold and the ReLU are applied while x is loaded, so no
// normalized activation is ever written to device memory.
//
// Design. Each block computes a 128 x 128 tile of y with the float32 FMA
// product of fused_bn_common.cuh, stores it, and writes the masked column
// sums of its 128 rows as one partial per block; `reduce_partials_kernel`
// then adds the partials up in a fixed order (no atomics: the sums are the
// same from run to run). Rows past N and columns past F_out are masked in
// the kernel; x is not padded.
//
// Bound. At the tower's widths the work is 2 N F_in F_out operations on
// 4 (N F_in + F_in F_out + N F_out) bytes: operations bound it (26.8 GFLOP
// against 0.16 GB at N=25600, 1024 -> 512). This first version runs the
// product on the float32 pipes, not the tensor cores.

#include "fused_bn_common.cuh"

using namespace fbn;

namespace {

__global__ void __launch_bounds__(kThreads, 2)
layer_forward_kernel(Operand x, WOperand w, const float* __restrict__ bias,
                     const float* __restrict__ mask, void* __restrict__ y,
                     int y_bf16, float* __restrict__ part_sum,
                     float* __restrict__ part_ssq) {
  __shared__ __align__(16) float As[kBK][kLd];
  __shared__ __align__(16) float Bs[kBK][kLd];
  __shared__ float red[2][16][kBN];

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int n_rows = x.rows;
  const int n_cols = w.N;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  product_rows<kFold>(x, w, m0, n0, As, Bs, acc);

  float csum[8], cssq[8], bv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = n0 + strip(tx, j);
    csum[j] = 0.0f;
    cssq[j] = 0.0f;
    bv[j] = c < n_cols ? bias[c] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + strip(ty, i);
    if (r >= n_rows) continue;
    const float m = mask[r];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + strip(tx, j);
      if (c >= n_cols) continue;
      const float v = acc[i][j] + bv[j];
      store_elem(y, static_cast<size_t>(r) * n_cols + c, y_bf16, v);
      const float vm = v * m;
      csum[j] += vm;
      cssq[j] += vm * v;
    }
  }
  write_column_partials(csum, cssq, red, n0, n_cols, blockIdx.y, part_sum,
                        part_ssq);
}

}  // namespace

extern "C" {

// Rows of x that one block reduces: the wrapper sizes `partial` with it.
int fused_bn_tile_rows() { return fbn::kBM; }

// x [N, F_in] f32 or bf16, mask [N] f32, s_in/t_in [F_in] f32,
// W(k, n) = w[k * w_ldk + n * w_ldn] (F_in x F_out, f32 or bf16), b [F_out]
// f32 -> y [N, F_out] f32 or bf16, col_sum/col_ssq [F_out] f32.
// `partial` is scratch of 2 * ceil(N / tile_rows) * F_out floats. All
// contiguous but w. Runs on `stream`; returns the CUDA error code.
int fused_bn_layer_forward(const void* x, int x_bf16, const float* mask,
                           const float* s_in, const float* t_in,
                           const void* w, int w_bf16, long long w_ldk,
                           long long w_ldn, const float* b, void* y,
                           int y_bf16, float* partial, float* col_sum,
                           float* col_ssq, int N, int F_in, int F_out,
                           int relu_in, cudaStream_t stream) {
  if (N <= 0 || F_in <= 0 || F_out <= 0) return cudaErrorInvalidValue;
  fbn::Operand xo = {};
  xo.p = x;
  xo.p_bf16 = x_bf16;
  xo.ld = F_in;
  xo.rows = N;
  xo.cols = F_in;
  xo.v0 = s_in;
  xo.v1 = t_in;
  xo.relu = relu_in;
  xo.round_bf16 = w_bf16;
  fbn::WOperand wo = {w, w_ldk, w_ldn, w_bf16, F_in, F_out};

  const int row_blocks = fbn::cdiv(N, fbn::kBM);
  float* part_sum = partial;
  float* part_ssq = partial + static_cast<size_t>(row_blocks) * F_out;
  const dim3 grid(fbn::cdiv(F_out, fbn::kBN), row_blocks);
  layer_forward_kernel<<<grid, fbn::kThreads, 0, stream>>>(
      xo, wo, b, mask, y, y_bf16, part_sum, part_ssq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = fbn::reduce_partials(part_sum, row_blocks, F_out, col_sum, stream);
  if (err != cudaSuccess) return err;
  return fbn::reduce_partials(part_ssq, row_blocks, F_out, col_ssq, stream);
}

}  // extern "C"
