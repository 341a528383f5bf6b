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
// Bound. 4 N F_in F_out operations (plus 4 N F_0 F_in with the fold) on
// about 4 (3 N F_out + 2 N F_in + 2 F_in F_out) bytes: operations bound it
// at the tower's widths. Float32-accurate work on the tensor cores is three
// TF32 passes (fused_bn_common.cuh), 165 TFLOP/s; the stats pass is a
// reduction bound by bytes. The staging of the tiles bounds the products
// before the tensor cores do; those over rows also read two inputs an
// element (g and y) through L2 for each tile of 128 x 128 outputs
// (fused_bn_common.cuh; times against the bound in PERF.md).
//
// Design. dy is never written: both products that consume it rebuild it
// from g and y while they stage their tiles, on the split-TF32 `wgmma`
// engine of fused_bn_common.cuh.
//   dx = dy W^T            one 128 x kBN tile per block; dy is read along
//                          its rows (the depth, F_out); W, split once a
//                          call into the engine's tiles, arrives by bulk
//                          copy. The epilogue gates the tile by the
//                          layer below's pre-activation (x_in s_in + t_in
//                          > 0) and writes that layer's s1, s2 as per-block
//                          column partials.
//   dW^T = dy^T z          a product that reduces over the N rows: both
//                          [N, F] operands are read down their columns and
//                          staged transposed (TF32 `wgmma` reads K-major
//                          tiles only). The output has few tiles, so the
//                          rows are split over gridDim.z, about one block
//                          per multiprocessor, and every split writes a
//                          partial [F_out, F_in].
//   A^T = dyhat_prev^T x0, B^T = (mask x_in)^T x0: the same product, one
//                          136-wide tile across F_0 = 136.
// Every sum over rows is finished by `reduce_partials_kernel` in a fixed
// order; there are no atomics.
//
// What this version writes that the TPU kernel kept on chip. The TPU kernel
// fed A = x0^T dyhat_prev from the dx tile in VMEM. Here dyhat_prev of
// layer 1 ([N, F_1], the activation type) goes through a scratch buffer in
// device memory between fused_bn_bwd_dx and fused_bn_bwd_ab; dx itself is
// still not written on that path (per-block partials of A would be larger
// than dyhat_prev). dy is rebuilt twice (for dx and for dW), which reads g
// and y twice. The bound in PERF.md counts neither.

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
template <int kBN, int kPasses>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dx_kernel(Operand dy, Operand wt, const uint8_t* __restrict__ w_tiles,
              int n_cols,
              const void* __restrict__ x_in, int xin_bf16,
              const float* __restrict__ s_in, const float* __restrict__ t_in,
              void* __restrict__ dx, int dx_bf16,
              void* __restrict__ dyhat_prev, int dyhat_bf16,
              float* __restrict__ part_s1, float* __restrict__ part_s2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem(smem_raw);
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int n_rows = dy.rows;

  float acc[kBN / 2];
#pragma unroll
  for (int j = 0; j < kBN / 2; ++j) acc[j] = 0.0f;
  // This column tile's slices of the pre-split W.
  const uint8_t* tiles = w_tiles + static_cast<size_t>(blockIdx.x) *
                                       cdiv(dy.cols, kBK) *
                                       weight_tile_bytes<kBN, kPasses>();
  product<kDy, kRaw, kKMajor, kEither, kBN, kPasses, true>(
      dy, wt, tiles, m0, n0, 0, dy.cols, smem, acc);

  if (x_in == nullptr) {
#pragma unroll
    for (int j = 0; j < kBN / 2; ++j) {
      const int r = m0 + frag_row(j);
      const int c = n0 + frag_col(j);
      if (dx != nullptr && r < n_rows && c < n_cols) {
        store_elem(dx, static_cast<size_t>(r) * n_cols + c, dx_bf16, acc[j]);
      }
    }
    return;
  }
  // Both warpgroups' products have retired: the ring becomes scratch. Each
  // element is stored, gated and added to the column sums in one visit.
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  warp_column_sums<kBN>(
      [&](int j, float* s1, float* s2) {
        const int r = m0 + frag_row(j);
        const int c = n0 + frag_col(j);
        *s1 = *s2 = 0.0f;
        if (r >= n_rows || c >= n_cols) return;
        const size_t idx = static_cast<size_t>(r) * n_cols + c;
        const float v = acc[j];
        if (dx != nullptr) store_elem(dx, idx, dx_bf16, v);
        const float xv = load_elem(x_in, idx, xin_bf16);
        const float dyh = scale_shift(xv, s_in[c], t_in[c]) > 0.0f ? v : 0.0f;
        if (dyhat_prev != nullptr) store_elem(dyhat_prev, idx, dyhat_bf16, dyh);
        *s1 = dyh;
        *s2 = dyh * xv;
      },
      red);
  __syncthreads();
  write_column_partials<kBN>(red, n0, n_cols, blockIdx.y, part_s1, part_s2);
}

// partial[z][i, j] = sum over the z-th chunk of rows of a(r, i) b(r, j).
template <int kModeA, int kModeB, int kBN, int kPasses>
__global__ void __launch_bounds__(kThreads, 1)
over_rows_kernel(Operand a, Operand b, int chunk_rows,
                 float* __restrict__ partial) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem(smem_raw);
  const int j0 = blockIdx.x * kBN;
  const int i0 = blockIdx.y * kBM;
  const int r_begin = blockIdx.z * chunk_rows;
  const int r_end = min(a.rows, r_begin + chunk_rows);
  const int n_i = a.cols;
  const int n_j = b.cols;

  float acc[kBN / 2];
#pragma unroll
  for (int j = 0; j < kBN / 2; ++j) acc[j] = 0.0f;
  product<kModeA, kModeB, kColumn, kColumn, kBN, kPasses, false>(
      a, b, nullptr, i0, j0, r_begin, r_end, smem, acc);

  float* out = partial + static_cast<size_t>(blockIdx.z) * n_i * n_j;
#pragma unroll
  for (int j = 0; j < kBN / 2; ++j) {
    const int r = i0 + frag_row(j);
    const int c = j0 + frag_col(j);
    if (r < n_i && c < n_j) out[static_cast<size_t>(r) * n_j + c] = acc[j];
  }
}

// dy rebuilt from g, y [N, F]; read along its rows (`kmajor`, the dx
// product) or down its columns (the products over rows).
Operand dy_operand(const void* g, const void* y, int bf16, const float* mask,
                   const float* s, const float* t, const float* c1,
                   const float* c2, int N, int F, int kmajor) {
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
  o.kmajor = kmajor;
  o.vec = vector_ok(g, F, F, bf16) && vector_ok(y, F, F, bf16) &&
          aligned16(s) && aligned16(t) && aligned16(c1) && aligned16(c2);
  return o;
}

// An [N, F] activation read down its columns by a product over rows.
Operand column_operand(const void* p, int bf16, int N, int F) {
  Operand o = {};
  o.p = p;
  o.p_bf16 = bf16;
  o.ld = F;
  o.rows = N;
  o.cols = F;
  o.vec = vector_ok(p, F, F, bf16);
  return o;
}

template <int kBN, int kPasses>
cudaError_t launch_dx(const Operand& dy, const Operand& wt, void* w_tiles,
                      int n_cols, const void* x_in, int xin_bf16,
                      const float* s_in, const float* t_in, void* dx,
                      int dx_bf16, void* dyhat_prev, int dyhat_bf16,
                      float* part_s1, float* part_s2, int row_blocks,
                      cudaStream_t stream) {
  cudaError_t err = split_weight<kBN, kPasses>(wt, dy.cols, n_cols, w_tiles,
                                               stream);
  if (err != cudaSuccess) return err;
  auto kernel = bwd_dx_kernel<kBN, kPasses>;
  constexpr int smem = smem_bytes<kBN, kPasses>();
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(n_cols, kBN), row_blocks);
  kernel<<<grid, kThreads, smem, stream>>>(
      dy, wt, static_cast<const uint8_t*>(w_tiles), n_cols, x_in, xin_bf16,
      s_in, t_in, dx, dx_bf16, dyhat_prev, dyhat_bf16, part_s1, part_s2);
  return cudaGetLastError();
}

template <int kModeA, int kModeB, int kBN, int kPasses>
cudaError_t launch_over_rows(const Operand& a, const Operand& b, int splits,
                             int chunk_rows, float* dst,
                             cudaStream_t stream) {
  auto kernel = over_rows_kernel<kModeA, kModeB, kBN, kPasses>;
  constexpr int smem = smem_bytes<kBN, kPasses>();
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(b.cols, kBN), cdiv(a.cols, kBM), splits);
  kernel<<<grid, kThreads, smem, stream>>>(a, b, chunk_rows, dst);
  return cudaGetLastError();
}

// out[I, J] = sum_r a(r, i) b(r, j), rows split into `splits` chunks of
// `chunk_rows` (a multiple of the slice depth). `partial` holds
// splits * I * J floats; with one split the product goes straight to `out`.
// `round_bf16`: the operands are rounded to bf16 (one TF32 pass).
template <int kModeA, int kModeB>
cudaError_t over_rows(const Operand& a, const Operand& b, int round_bf16,
                      int splits, int chunk_rows, float* partial, float* out,
                      cudaStream_t stream) {
  if (splits < 1 || chunk_rows < 1 || chunk_rows % kBK != 0 ||
      static_cast<long long>(splits) * chunk_rows < a.rows) {
    return cudaErrorInvalidValue;
  }
  float* dst = splits == 1 ? out : partial;
  const bool wide = tile_cols(b.cols) == 136;
  cudaError_t err;
  if (round_bf16) {
    err = wide ? launch_over_rows<kModeA, kModeB, 136, 1>(a, b, splits,
                                                          chunk_rows, dst,
                                                          stream)
               : launch_over_rows<kModeA, kModeB, 128, 1>(a, b, splits,
                                                          chunk_rows, dst,
                                                          stream);
  } else {
    err = wide ? launch_over_rows<kModeA, kModeB, 136, 3>(a, b, splits,
                                                          chunk_rows, dst,
                                                          stream)
               : launch_over_rows<kModeA, kModeB, 128, 3>(a, b, splits,
                                                          chunk_rows, dst,
                                                          stream);
  }
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

// Bytes of the scratch that holds a K x N weight split for the products.
long long fused_bn_weight_tiles_bytes(int K, int N, int bf16) {
  return fbn::weight_tiles_bytes(K, N, bf16);
}

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
// F_in x F_out (row-major or its transpose); `w_tiles` is scratch of
// fused_bn_weight_tiles_bytes(F_out, F_in, w_bf16) bytes. dx and
// dyhat_prev may be null (not written). With x_in [N, F_in] given (else
// null), also s1, s2 [F_in] of the layer below, through `partial`
// (2 * ceil(N / tile_rows) * F_in floats).
int fused_bn_bwd_dx(const void* g, const void* y, int gy_bf16,
                    const float* mask, const float* s, const float* t,
                    const float* c1, const float* c2, const void* w,
                    int w_bf16, long long w_ldk, long long w_ldn,
                    void* w_tiles, const void* x_in, int xin_bf16,
                    const float* s_in,
                    const float* t_in, void* dx, int dx_bf16,
                    void* dyhat_prev, int dyhat_bf16, float* partial,
                    float* s1, float* s2, int N, int F_in, int F_out,
                    cudaStream_t stream) {
  if (N <= 0 || F_in <= 0 || F_out <= 0) return cudaErrorInvalidValue;
  const Operand dy = dy_operand(g, y, gy_bf16, mask, s, t, c1, c2, N, F_out,
                                1);
  // dx[m, k] = sum_n dy[m, n] W[k, n]: the depth runs over W's second index.
  Operand wt;
  if (!weight_operand(w, w_bf16, w_ldk, w_ldn, F_in, F_out, false, &wt)) {
    return cudaErrorInvalidValue;
  }
  const int row_blocks = fbn::cdiv(N, fbn::kBM);
  float* part_s1 = partial;
  float* part_s2 = x_in == nullptr
                       ? nullptr
                       : partial + static_cast<size_t>(row_blocks) * F_in;
  const bool wide = tile_cols(F_in) == 136;
  cudaError_t err;
  // bf16 operands are exact in TF32: one pass. float32: three.
  if (w_bf16) {
    err = wide ? launch_dx<136, 1>(dy, wt, w_tiles, F_in, x_in, xin_bf16,
                                   s_in, t_in, dx, dx_bf16, dyhat_prev,
                                   dyhat_bf16, part_s1, part_s2, row_blocks,
                                   stream)
               : launch_dx<128, 1>(dy, wt, w_tiles, F_in, x_in, xin_bf16,
                                   s_in, t_in, dx, dx_bf16, dyhat_prev,
                                   dyhat_bf16, part_s1, part_s2, row_blocks,
                                   stream);
  } else {
    err = wide ? launch_dx<136, 3>(dy, wt, w_tiles, F_in, x_in, xin_bf16,
                                   s_in, t_in, dx, dx_bf16, dyhat_prev,
                                   dyhat_bf16, part_s1, part_s2, row_blocks,
                                   stream)
               : launch_dx<128, 3>(dy, wt, w_tiles, F_in, x_in, xin_bf16,
                                   s_in, t_in, dx, dx_bf16, dyhat_prev,
                                   dyhat_bf16, part_s1, part_s2, row_blocks,
                                   stream);
  }
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
                                0);
  Operand z = column_operand(x_in, xin_bf16, N, F_in);
  z.v0 = s_in;
  z.v1 = t_in;
  z.relu = relu_in;
  return over_rows<kDy, kFold>(dy, z, round_bf16, splits, chunk_rows, partial,
                               dw_t, stream);
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
  const Operand x = column_operand(x0, 0, N, F_0);
  const Operand d = column_operand(dyhat_prev, dyhat_bf16, N, F_in);
  Operand mx = column_operand(x_in, xin_bf16, N, F_in);
  mx.rowmask = mask;
  const cudaError_t err = over_rows<kRaw, kRaw>(d, x, round_bf16, splits,
                                                chunk_rows, partial, a_t,
                                                stream);
  if (err != cudaSuccess) return err;
  return over_rows<kRowMask, kRaw>(mx, x, round_bf16, splits, chunk_rows,
                                   partial, b_t, stream);
}

}  // extern "C"
