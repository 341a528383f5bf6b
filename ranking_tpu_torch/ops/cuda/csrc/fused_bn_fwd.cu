// One layer of the fused masked-BN tower, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` behind `_layer_forward` in
// ranking_tpu/ops/pallas/fused_bn.py. Same function:
//   z = x * s_in + t_in            (the layer below's BN fold), relu if asked,
//   y = z W + b                    (z and W rounded to bf16 first when the
//                                   activations are stored as bf16),
//   col_sum = sum_r mask_r y_r,  col_ssq = sum_r mask_r y_r^2
// with the statistics taken from the float32 y before it is rounded for
// storage. The fold and the ReLU are applied while x is staged, so no
// normalized activation is ever written to device memory.
//
// Bound. 2 N F_in F_out operations on 4 (N F_in + F_in F_out + N F_out)
// bytes: operations bound it at the tower's widths (26.8 GFLOP against
// 0.16 GB at N=25600, 1024 -> 512). Float32-accurate work on the tensor
// cores is three TF32 passes (fused_bn_common.cuh), 165 TFLOP/s. The
// staging of the tiles bounds this engine before the tensor cores do
// (fused_bn_common.cuh; times against the bound in PERF.md).
//
// Design. Each block computes a 128 x kBN tile of y with the split-TF32
// `wgmma` engine of fused_bn_common.cuh: x is read along its rows (the
// depth), 16-byte loads where its rows are aligned, folded and split on
// the way into shared memory; W, read through its strides (the tower
// passes the parameter's transposed view), is split once a call into the
// engine's tiles, which each block copies in by bulk copy. The
// epilogue adds the bias, stores y, and writes the masked column sums of
// its 128 rows as one partial per block; `reduce_partials_kernel` then adds
// the partials up in a fixed order (no atomics: the sums are the same from
// run to run). Rows past N and columns past F_out are masked in the
// kernel; x is not padded.

#include "fused_bn_common.cuh"

using namespace fbn;

namespace {

template <int kBN, int kPasses>
__global__ void __launch_bounds__(kThreads, 1)
layer_forward_kernel(Operand x, Operand w,
                     const uint8_t* __restrict__ w_tiles, int n_cols,
                     const float* __restrict__ bias,
                     const float* __restrict__ mask, void* __restrict__ y,
                     int y_bf16, float* __restrict__ part_sum,
                     float* __restrict__ part_ssq) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem(smem_raw);
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int n_rows = x.rows;

  float acc[kBN / 2];
#pragma unroll
  for (int j = 0; j < kBN / 2; ++j) acc[j] = 0.0f;
  // This column tile's slices of the pre-split W.
  const uint8_t* tiles = w_tiles + static_cast<size_t>(blockIdx.x) *
                                       cdiv(x.cols, kBK) *
                                       weight_tile_bytes<kBN, kPasses>();
  product<kFold, kRaw, kKMajor, kEither, kBN, kPasses, true>(
      x, w, tiles, m0, n0, 0, x.cols, smem, acc);

  float m_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = m0 + frag_row(2 * h);
    m_row[h] = r < n_rows ? mask[r] : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kBN / 2; ++j) {
    const int r = m0 + frag_row(j);
    const int c = n0 + frag_col(j);
    if (r < n_rows && c < n_cols) {
      const float v = acc[j] + bias[c];
      store_elem(y, static_cast<size_t>(r) * n_cols + c, y_bf16, v);
      acc[j] = v;
    } else {
      acc[j] = 0.0f;
    }
  }
  // Both warpgroups' products have retired: the ring becomes scratch.
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  warp_column_sums<kBN>(
      [&](int j, float* sum, float* ssq) {
        const float vm = acc[j] * m_row[(j >> 1) & 1];
        *sum = vm;
        *ssq = vm * acc[j];
      },
      red);
  __syncthreads();
  write_column_partials<kBN>(red, n0, n_cols, blockIdx.y, part_sum, part_ssq);
}

template <int kBN, int kPasses>
cudaError_t launch(const Operand& x, const Operand& w, void* w_tiles,
                   int n_cols, const float* bias, const float* mask, void* y,
                   int y_bf16, float* part_sum, float* part_ssq,
                   int row_blocks, cudaStream_t stream) {
  cudaError_t err = split_weight<kBN, kPasses>(w, x.cols, n_cols, w_tiles,
                                               stream);
  if (err != cudaSuccess) return err;
  auto kernel = layer_forward_kernel<kBN, kPasses>;
  constexpr int smem = smem_bytes<kBN, kPasses>();
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(n_cols, kBN), row_blocks);
  kernel<<<grid, kThreads, smem, stream>>>(
      x, w, static_cast<const uint8_t*>(w_tiles), n_cols, bias, mask, y,
      y_bf16, part_sum, part_ssq);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of x that one block reduces: the wrapper sizes `partial` with it.
int fused_bn_tile_rows() { return fbn::kBM; }

// Bytes of the scratch that holds a K x N weight split for the products.
long long fused_bn_weight_tiles_bytes(int K, int N, int bf16) {
  return fbn::weight_tiles_bytes(K, N, bf16);
}

// x [N, F_in] f32 or bf16, mask [N] f32, s_in/t_in [F_in] f32,
// W(k, n) = w[k * w_ldk + n * w_ldn] (F_in x F_out, f32 or bf16; row-major
// or its transpose), b [F_out] f32 -> y [N, F_out] f32 or bf16,
// col_sum/col_ssq [F_out] f32. `partial` is scratch of
// 2 * ceil(N / tile_rows) * F_out floats, `w_tiles` of
// fused_bn_weight_tiles_bytes(F_in, F_out, w_bf16) bytes. All contiguous
// but w. Runs on `stream`; returns the CUDA error code.
int fused_bn_layer_forward(const void* x, int x_bf16, const float* mask,
                           const float* s_in, const float* t_in,
                           const void* w, int w_bf16, long long w_ldk,
                           long long w_ldn, void* w_tiles, const float* b,
                           void* y, int y_bf16, float* partial, float* col_sum,
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
  xo.kmajor = 1;
  xo.vec = fbn::vector_ok(x, F_in, F_in, x_bf16) && fbn::aligned16(s_in) &&
           fbn::aligned16(t_in);
  fbn::Operand wo;
  if (!fbn::weight_operand(w, w_bf16, w_ldk, w_ldn, F_in, F_out, true, &wo)) {
    return cudaErrorInvalidValue;
  }

  const int row_blocks = fbn::cdiv(N, fbn::kBM);
  float* part_sum = partial;
  float* part_ssq = partial + static_cast<size_t>(row_blocks) * F_out;
  // bf16 operands are exact in TF32: one pass. float32: three.
  cudaError_t err;
  const bool wide = fbn::tile_cols(F_out) == 136;
  if (w_bf16) {
    err = wide ? launch<136, 1>(xo, wo, w_tiles, F_out, b, mask, y, y_bf16,
                                part_sum, part_ssq, row_blocks, stream)
               : launch<128, 1>(xo, wo, w_tiles, F_out, b, mask, y, y_bf16,
                                part_sum, part_ssq, row_blocks, stream);
  } else {
    err = wide ? launch<136, 3>(xo, wo, w_tiles, F_out, b, mask, y, y_bf16,
                                part_sum, part_ssq, row_blocks, stream)
               : launch<128, 3>(xo, wo, w_tiles, F_out, b, mask, y, y_bf16,
                                part_sum, part_ssq, row_blocks, stream);
  }
  if (err != cudaSuccess) return err;
  err = fbn::reduce_partials(part_sum, row_blocks, F_out, col_sum, stream);
  if (err != cudaSuccess) return err;
  return fbn::reduce_partials(part_ssq, row_blocks, F_out, col_ssq, stream);
}

}  // extern "C"
