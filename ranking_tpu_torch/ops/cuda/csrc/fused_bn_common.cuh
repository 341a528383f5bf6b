// Shared pieces of the fused masked-BN tower kernels (fused_bn_fwd.cu,
// fused_bn_bwd.cu): operand descriptors that apply the BN fold, the ReLU,
// the dy rebuild or the row mask while a tile is staged, the tensor-core
// product engine, and the ordered second pass over per-block partial sums.
//
// What bounds the products on an H100. Every function of the tower is a
// matrix product with a cheap prologue and epilogue; at the tower's widths
// operations bound it, not bytes. The float32 pipes give 67 TFLOP/s; the
// tensor cores take no float32 operand, but TF32 runs at 495 TFLOP/s.
//
// Numerics: split TF32. An operand x is written as hi + lo with
// hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest with ties
// away from zero (cvt.rna.tf32.f32's rounding, done on the bits by
// `to_tf32`): hi is rounded, not left to the tensor core's truncation of a
// raw float32, so |lo| <= 2^-11 |x|, and lo is exact in TF32 too.
// a b ~ hi_a lo_b + lo_a hi_b + hi_a hi_b, summed into the slice's float32
// accumulator small terms first (all of the slice's, then its hi hi
// terms): about 2^-21 of
// relative error a product, inside the float32 tolerance of the plain
// versions, at three TF32 passes (165 TFLOP/s of float32-accurate work).
// With bf16 storage every operand is rounded to bf16 as it is staged, and
// bf16's 8 mantissa bits are exact in TF32's 10: one pass is exact there.
// The number of passes is a template parameter.
//
// The engine. A block of two warpgroups (256 threads) owns a 128-row
// output tile, 64 rows a warpgroup, and kBN columns: 128, or 136 for the
// [*, 136] outputs of the first layer, which `wgmma` (N any multiple of 8
// up to 256) takes as one tile with no padding. The depth goes in slices
// of 32 floats: one 128-byte row of the 128-byte swizzle that `wgmma`'s
// shared-memory descriptors read (both operands from shared memory). For
// TF32 `wgmma` takes both operands K-major only (the PTX ISA allows a
// transpose for 16-bit types alone), so the threads that stage a tile
// write it K-major whatever the source's layout:
//   - a source whose depth runs along its rows in memory (x for y = z W,
//     dy for dx = dy W^T, W as the parameter's transposed view) is read
//     four neighbours a thread (one 16-byte load where rows are aligned),
//     which make one swizzled 16-byte chunk;
//   - a source whose depth runs down its columns (the [N, F] activations
//     of the products over rows: dW, A, B; a contiguous W) is read in
//     blocks of 4 columns by 4 depths, four neighbours a load, and written
//     as four 16-byte chunks: the transpose happens in registers.
// Activations load straight to registers, one slice ahead: slice k + 2's
// loads are issued while the tensor cores run slice k, and slice k + 1,
// loaded a slice ago, is transformed (fold, ReLU, dy rebuild, row mask,
// bf16 rounding), split into hi and lo and stored meanwhile, so the raw
// tile never visits shared memory. Per-column vectors of a column source
// are read once a product; the row mask is shared out by shuffles. The
// weight, which every row block of y = z W and dx = dy W^T reads, is split
// once a call by `split_weight` into the stage's layout and arrives by
// bulk copy (`cp.async.bulk`, counted in by an `mbarrier`): no thread
// stages it. Two stages of shared memory (64 KB each in split TF32 at
// 128 x 128) alternate.
//
// Promotion. The tensor cores add into their accumulator with truncation,
// so a long sum in one accumulator drifts, all the same way: over the
// flagship's depths that broke the float32 tolerance. Each slice is
// therefore summed on its own (its small terms first) and added to the
// float32 total with a rounding add.
//
// What bounds it on the card: the staging, not the tensor cores. Each
// slice's loads, transform, split and shared-memory stores of activations
// take longer than its 12 `wgmma`s, which also read 144 KB of tiles from
// shared memory; the products over rows stage both operands and read two
// inputs an element (g and y) through L2. The slice's `wgmma`s are issued
// in three groups with the next slice's staging between them. A producer
// warpgroup with a deeper ring is the next step (ROADMAP.md).
//
// Sums that cross blocks. Blocks run in no order, so a sum over rows
// (column statistics, dW, A, B) is written as one partial per block and
// added up by `reduce_partials_kernel` in a fixed order. Within a block
// the column sums go through fixed shuffles and a fixed order over warps.
// There are no atomics: the result is the same from run to run.
//
// Ragged edges. No input is padded: elements outside a matrix are staged
// as 0, and every epilogue checks its row and column.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace fbn {

constexpr int kBM = 128;       // output tile rows: two warpgroups of 64
constexpr int kBK = 32;        // depth of one staged slice (128 bytes)
constexpr int kThreads = 256;  // two warpgroups
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;     // the shared-memory ring
constexpr int kRowBytes = kBK * 4;

enum Mode { kRaw = 0, kFold = 1, kDy = 2, kRowMask = 3 };

// Which way a product reads an operand, when the kernel knows it: down its
// columns, along its rows (K-major), or as the operand's `kmajor` says.
enum Layout { kColumn = 0, kKMajor = 1, kEither = 2 };

// A [rows, cols] row-major matrix (row stride `ld`) whose elements are
// transformed as they are staged, by the mode its kernel was instantiated
// with:
//   kRaw:     p
//   kFold:    z = p * v0[c] + v1[c], then relu if `relu`
//   kDy:      g = p, y = q: dyhat = (y * v0[c] + v1[c] > 0) ? g : 0,
//             dy = v0[c] * dyhat - rowmask[r] * (y * v3[c] + v2[c])
//             (v0 = s, v1 = t, v2 = c1, v3 = c2)
//   kRowMask: rowmask[r] * p
// and rounded to bf16 (kept as float) in a one-pass product.
// `kmajor`: the product's depth runs along the columns (else down the
// rows). `vec`: rows start 16-byte aligned (8 for bf16), cols % 4 == 0 and
// the column vectors are 16-byte aligned, so four neighbours load as one
// vector.
struct Operand {
  const void* p;
  const void* q;
  const float* v0;
  const float* v1;
  const float* v2;
  const float* v3;
  const float* rowmask;
  long long ld;
  int p_bf16;
  int rows;
  int cols;
  int relu;
  int kmajor;
  int vec;
};

template <int kLayout>
__device__ __forceinline__ bool is_kmajor(const Operand& o) {
  if constexpr (kLayout == kEither) {
    return o.kmajor;
  } else {
    return kLayout == kKMajor;
  }
}

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

// Four neighbours (i .. i + 3) of a raw matrix as one 16-byte (float32) or
// 8-byte (bf16) load.
__device__ __forceinline__ void load_vec4(const void* p, size_t i, int bf16,
                                          float v[4]) {
  if (bf16) {
    const uint2 u =
        __ldg(reinterpret_cast<const uint2*>(
            static_cast<const __nv_bfloat16*>(p) + i));
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  } else {
    const float* q = static_cast<const float*>(p) + i;
    const float4 f = __ldg(reinterpret_cast<const float4*>(q));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
}

// Per-column vectors a mode reads: kFold s, t (v0, v1); kDy s, t, c1, c2.
template <int kMode>
__host__ __device__ constexpr int column_vectors() {
  return kMode == kFold ? 2 : kMode == kDy ? 4 : 0;
}

// Whether a mode reads the row mask.
template <int kMode>
__host__ __device__ constexpr bool reads_rowmask() {
  return kMode == kDy || kMode == kRowMask;
}

__device__ __forceinline__ const float* column_vector(const Operand& o,
                                                      int q) {
  return q == 0 ? o.v0 : q == 1 ? o.v1 : q == 2 ? o.v2 : o.v3;
}

// The staged value of an element from its raw value(s) `v` (and `w`, y for
// kDy), its column's vectors p[0..3] and its row's mask value `rm`: each
// kernel is instantiated for the modes it is launched with, so the other
// modes cost no registers and no branches.
template <int kMode, bool kRound>
__device__ __forceinline__ float transform(int relu, float v, float w,
                                           const float* p, float rm) {
  if constexpr (kMode == kFold) {
    v = scale_shift(v, p[0], p[1]);
    if (relu) v = fmaxf(v, 0.0f);
  } else if constexpr (kMode == kDy) {
    const float yhat = scale_shift(w, p[0], p[1]);
    const float dyhat = yhat > 0.0f ? v : 0.0f;
    v = p[0] * dyhat - rm * (w * p[3] + p[2]);
  } else if constexpr (kMode == kRowMask) {
    v = rm * v;
  }
  return kRound ? round_to_bf16(v) : v;
}

// tf32(x): x rounded to TF32's 10 mantissa bits, to nearest with ties away
// from zero (what cvt.rna.tf32.f32 computes), by adding half a unit of the
// 13 dropped bits to the magnitude and clearing them: two integer
// operations on the full-rate pipes.
__device__ __forceinline__ float to_tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// Byte offset of element (row, k) in a K-major tile of 128-byte rows under
// the 128-byte swizzle: 16-byte chunk k / 4 of row `row` sits at chunk
// (k / 4) ^ (row % 8). Tiles start 1024-byte aligned.
__device__ __forceinline__ uint32_t swizzled(int row, int k) {
  return row * kRowBytes + ((((k >> 2) ^ row) & 7) << 4) + (k & 3) * 4;
}

// Writes staged values: hi (and lo for three passes).
template <int kPasses>
__device__ __forceinline__ void put(uint8_t* hi, uint8_t* lo, uint32_t off,
                                    float v) {
  if constexpr (kPasses == 3) {
    const float h = to_tf32(v);
    *reinterpret_cast<float*>(hi + off) = h;
    *reinterpret_cast<float*>(lo + off) = to_tf32(v - h);
  } else {
    *reinterpret_cast<float*>(hi + off) = v;
  }
}

template <int kPasses>
__device__ __forceinline__ void put4(uint8_t* hi, uint8_t* lo, uint32_t off,
                                     const float v[4]) {
  if constexpr (kPasses == 3) {
    float4 h, l;
    h.x = to_tf32(v[0]);
    h.y = to_tf32(v[1]);
    h.z = to_tf32(v[2]);
    h.w = to_tf32(v[3]);
    l.x = to_tf32(v[0] - h.x);
    l.y = to_tf32(v[1] - h.y);
    l.z = to_tf32(v[2] - h.z);
    l.w = to_tf32(v[3] - h.w);
    *reinterpret_cast<float4*>(hi + off) = h;
    *reinterpret_cast<float4*>(lo + off) = l;
  } else {
    *reinterpret_cast<float4*>(hi + off) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

__device__ __forceinline__ float ldg_elem(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(
                    __ldg(static_cast<const __nv_bfloat16*>(p) + i))
              : __ldg(static_cast<const float*>(p) + i);
}

// This thread's share of one operand's [kR, kBK] slice as loaded, before
// the transform: `v`, and y in `w` for kDy.
//   K-major source (depth along the rows in memory): `kSlots` groups of
//   four neighbours along the depth, one 16-byte chunk of the tile each.
//   Column source (depth down the columns): `kBlocks` blocks of 4 columns
//   by 4 depths, read as four rows of four neighbours (16-byte loads where
//   rows are aligned) and written, transposed in registers, as four 16-byte
//   chunks of the tile. A warp covers 16 columns by 32 depths, which keeps
//   its stores free of bank conflicts.
// `rm`: a column source's row mask at depth k0 + lane (the warp shares it
// out by shuffles).
template <int kMode, int kR>
struct Raw {
  static constexpr int kSlots = (kR * (kBK / 4) + kThreads - 1) / kThreads;
  static constexpr int kQuads = kR / 4;
  static constexpr int kBlocks = (kQuads * (kBK / 4) + kThreads - 1) / kThreads;
  static constexpr int kN = 4 * kSlots > 16 * kBlocks ? 4 * kSlots
                                                      : 16 * kBlocks;
  static_assert(kR % 8 == 0, "tile rows: a multiple of 8");
  float v[kN];
  float w[kMode == kDy ? kN : 1];
  float rm;
};

// Tile row mn and first depth k of this thread's i-th group of four
// (K-major source) ...
__device__ __forceinline__ void kmajor_slot(int i, int* mn, int* k) {
  const int s = threadIdx.x + i * kThreads;
  *mn = s >> 3;
  *k = (s & 7) * 4;
}

// ... and the column quad (tile rows 4 cq ..) and depth quad (depths
// 4 dq ..) of its i-th block (column source).
__device__ __forceinline__ void column_block(int i, int* cq, int* dq) {
  const int p = threadIdx.x + i * kThreads;
  *cq = p >> 3;
  *dq = p & 7;
}

// The column vectors of a column source's blocks: the same for every slice,
// so they are read once a product.
template <int kMode, int kR>
struct ColumnVectors {
  static constexpr int kVecs = column_vectors<kMode>();
  static constexpr int kBlocks = Raw<kMode, kR>::kBlocks;
  float p[kBlocks][4][4];  // [block][column][vector]

  __device__ __forceinline__ void load(const Operand& o, int mn0) {
#pragma unroll
    for (int i = 0; i < kBlocks; ++i) {
      int cq, dq;
      column_block(i, &cq, &dq);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = mn0 + 4 * cq + j;
#pragma unroll
        for (int q = 0; q < kVecs; ++q) {
          p[i][j][q] = c < o.cols ? __ldg(column_vector(o, q) + c) : 0.0f;
        }
      }
    }
  }
};

// Loads this thread's share of the [kR, kBK] slice (tile rows mn0..,
// depth k0..) of operand `o`; 0 outside the matrix and at depths at or
// past `k_end`. All loads are issued before any value is used.
template <int kMode, int kLayout, int kR>
__device__ __forceinline__ void load_tile(const Operand& o, int mn0, int k0,
                                          int k_end, Raw<kMode, kR>& raw) {
  using R = Raw<kMode, kR>;
  if (is_kmajor<kLayout>(o)) {
#pragma unroll
    for (int i = 0; i < R::kSlots; ++i) {
      float* v = raw.v + 4 * i;
      float* w = raw.w + (kMode == kDy ? 4 * i : 0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = 0.0f;
        if constexpr (kMode == kDy) w[e] = 0.0f;
      }
      int mn, k;
      kmajor_slot(i, &mn, &k);
      const int r = mn0 + mn;
      const int c = k0 + k;
      if (mn >= kR || r >= o.rows) continue;
      const size_t base = static_cast<size_t>(r) * o.ld + c;
      if (o.vec) {
        if (c < o.cols) {
          load_vec4(o.p, base, o.p_bf16, v);
          if constexpr (kMode == kDy) load_vec4(o.q, base, o.p_bf16, w);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (c + e < o.cols) {
            v[e] = ldg_elem(o.p, base + e, o.p_bf16);
            if constexpr (kMode == kDy) w[e] = ldg_elem(o.q, base + e,
                                                        o.p_bf16);
          }
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < R::kBlocks; ++i) {
      int cq, dq;
      column_block(i, &cq, &dq);
      const int c = mn0 + 4 * cq;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float* v = raw.v + 16 * i + 4 * e;
        float* w = raw.w + (kMode == kDy ? 16 * i + 4 * e : 0);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = 0.0f;
          if constexpr (kMode == kDy) w[j] = 0.0f;
        }
        const int r = k0 + 4 * dq + e;
        if (cq >= R::kQuads || r >= k_end) continue;
        const size_t base = static_cast<size_t>(r) * o.ld + c;
        if (o.vec) {
          if (c < o.cols) {
            load_vec4(o.p, base, o.p_bf16, v);
            if constexpr (kMode == kDy) load_vec4(o.q, base, o.p_bf16, w);
          }
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (c + j < o.cols) {
              v[j] = ldg_elem(o.p, base + j, o.p_bf16);
              if constexpr (kMode == kDy) {
                w[j] = ldg_elem(o.q, base + j, o.p_bf16);
              }
            }
          }
        }
      }
    }
    if constexpr (reads_rowmask<kMode>()) {
      const int r = k0 + (threadIdx.x & 31);
      raw.rm = r < k_end ? __ldg(o.rowmask + r) : 0.0f;
    }
  }
}

// Transforms the loaded share (the same slice as `load_tile`'s), splits it
// into hi and lo and writes it into the K-major tiles `hi` / `lo`. Every
// global load comes first, so that none waits behind a shared-memory store.
template <int kMode, int kLayout, int kR, int kPasses>
__device__ __forceinline__ void store_tile(const Operand& o, int mn0, int k0,
                                           int k_end,
                                           const Raw<kMode, kR>& raw,
                                           const ColumnVectors<kMode, kR>& cv,
                                           uint8_t* hi, uint8_t* lo) {
  using R = Raw<kMode, kR>;
  constexpr bool kRound = kPasses == 1;
  constexpr int kVecs = column_vectors<kMode>();
  if (is_kmajor<kLayout>(o)) {
    // This thread's four depths are the same in each of its groups, and
    // so are its columns' vectors.
    int mn, k;
    kmajor_slot(0, &mn, &k);
    const int c = k0 + k;
    float p[4][4];
#pragma unroll
    for (int q = 0; q < kVecs; ++q) {
      const float* vq = column_vector(o, q);
      if (o.vec && c < o.cols) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(vq + c));
        p[0][q] = f.x;
        p[1][q] = f.y;
        p[2][q] = f.z;
        p[3][q] = f.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e][q] = c + e < o.cols ? __ldg(vq + c + e) : 0.0f;
        }
      }
    }
    float rm[R::kSlots];
#pragma unroll
    for (int i = 0; i < R::kSlots; ++i) {
      kmajor_slot(i, &mn, &k);
      rm[i] = 0.0f;
      if constexpr (reads_rowmask<kMode>()) {
        if (mn < kR && mn0 + mn < o.rows) rm[i] = __ldg(o.rowmask + mn0 + mn);
      }
    }
#pragma unroll
    for (int i = 0; i < R::kSlots; ++i) {
      kmajor_slot(i, &mn, &k);
      if (mn >= kR) break;
      const int r = mn0 + mn;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float w = 0.0f;
        if constexpr (kMode == kDy) w = raw.w[4 * i + e];
        v[e] = r < o.rows && c + e < o.cols
                   ? transform<kMode, kRound>(o.relu, raw.v[4 * i + e], w,
                                              p[e], rm[i])
                   : 0.0f;
      }
      put4<kPasses>(hi, lo, swizzled(mn, k), v);
    }
  } else {
#pragma unroll
    for (int i = 0; i < R::kBlocks; ++i) {
      int cq, dq;
      column_block(i, &cq, &dq);
      // Every lane takes part in the shuffles, live block or not.
      float rm[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        rm[e] = 0.0f;
        if constexpr (reads_rowmask<kMode>()) {
          rm[e] = __shfl_sync(0xffffffffu, raw.rm, 4 * dq + e);
        }
      }
      if (cq >= R::kQuads) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = mn0 + 4 * cq + j;
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float w = 0.0f;
          if constexpr (kMode == kDy) w = raw.w[16 * i + 4 * e + j];
          v[e] = k0 + 4 * dq + e < k_end && c < o.cols
                     ? transform<kMode, kRound>(o.relu,
                                                raw.v[16 * i + 4 * e + j], w,
                                                cv.p[i][j], rm[e])
                     : 0.0f;
        }
        put4<kPasses>(hi, lo, swizzled(4 * cq + j, 4 * dq), v);
      }
    }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `wgmma` shared-memory descriptor of a K-major tile under the 128-byte
// swizzle: start address, leading offset 16 bytes (unused by this layout),
// 1024 bytes between 8-row groups, layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint32_t a = smem_addr(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// d = A (64 x 8, K-major) B^T (8 x 128, K-major) + (scale_d ? d : 0), TF32
// in, float32 out.
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d = A (64 x 8, K-major) B^T (8 x 136, K-major) + (scale_d ? d : 0), TF32
// in, float32 out.
__device__ __forceinline__ void wgmma_tf32_n136(float (&d)[68], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %70, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n136k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67"
      "}, %68, %69, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across a
// `wgmma` that is in flight.
template <int kN>
__device__ __forceinline__ void fence_acc(float (&acc)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

template <int kBN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[kBN / 2], uint64_t da,
                                           uint64_t db, int scale_d) {
  if constexpr (kBN == 128) {
    wgmma_tf32_n128(d, da, db, scale_d);
  } else {
    static_assert(kBN == 136, "tile widths: 128 or 136");
    wgmma_tf32_n136(d, da, db, scale_d);
  }
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Copies `bytes` (a multiple of 16) from global to shared memory through
// the bulk-copy unit; `bar` completes its phase when they have landed.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Waits until `bar` has completed the phase of the given parity. A copy
// that never lands stops the kernel with an error instead of a hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  for (long long spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1ll << 26)) __trap();
  }
}

// Bytes of one stage of the ring: the A and B tiles, hi and (three passes)
// lo. A pre-split weight tile of one slice (`split_weight`) has the layout
// of the stage's B part.
template <int kBN, int kPasses>
__host__ __device__ constexpr int stage_bytes() {
  return (kBM + kBN) * kRowBytes * (kPasses == 3 ? 2 : 1);
}

// Bytes of the stage's B part: one slice of a pre-split weight.
template <int kBN, int kPasses>
__host__ __device__ constexpr int weight_tile_bytes() {
  return kBN * kRowBytes * (kPasses == 3 ? 2 : 1);
}

// Dynamic shared memory a product kernel asks for: the ring, and 1024
// bytes to align it (the swizzle's atoms are 1024-byte aligned).
template <int kBN, int kPasses>
__host__ __device__ constexpr int smem_bytes() {
  return kStages * stage_bytes<kBN, kPasses>() + 1024;
}

__device__ __forceinline__ uint8_t* align_smem(uint8_t* p) {
  const uint32_t a = smem_addr(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// acc[j] += sum_k a(m0 + row_j, k) b(n0 + col_j, k), k over
// [k_begin, k_end): A is operand `a`'s [kBM, depth] tile, B operand `b`'s
// [kBN, depth] tile, both read along the depth as their `kmajor` says.
// Every thread of the block calls it; `smem` is the aligned ring.
//
// The tensor cores add into their accumulator with truncation, so a long
// sum drifts; each slice is therefore summed on its own (`part`, 12 or 4
// `wgmma`s) and added to `acc` by a float32 add that rounds to nearest.
// That costs a second accumulator and one wait a slice: the next slice's
// loads and staging still run under this slice's products.
template <int kModeA, int kModeB, int kLayoutA, int kLayoutB, int kBN,
          int kPasses, bool kBTiles>
__device__ __forceinline__ void product(const Operand& a, const Operand& b,
                                        const uint8_t* b_tiles, int m0,
                                        int n0, int k_begin, int k_end,
                                        uint8_t* smem,
                                        float (&acc)[kBN / 2]) {
  constexpr int kA = kBM * kRowBytes;
  constexpr int kB = kBN * kRowBytes;
  constexpr int kMul = kPasses == 3 ? 2 : 1;
  constexpr int kStage = stage_bytes<kBN, kPasses>();
  // Within a stage: A hi, A lo, then B hi, B lo (lo with three passes).
  auto a_hi = [&](int s) { return smem + s * kStage; };
  auto a_lo = [&](int s) { return smem + s * kStage + kA; };
  auto b_hi = [&](int s) { return smem + s * kStage + kMul * kA; };
  auto b_lo = [&](int s) { return smem + s * kStage + kMul * kA + kB; };
  Raw<kModeA, kBM> ra;
  Raw<kModeB, kBN> rb;
  auto load = [&](int k0) {
    load_tile<kModeA, kLayoutA, kBM>(a, m0, k0, k_end, ra);
    if constexpr (!kBTiles) {
      load_tile<kModeB, kLayoutB, kBN>(b, n0, k0, k_end, rb);
    }
  };
  ColumnVectors<kModeA, kBM> cva;
  ColumnVectors<kModeB, kBN> cvb;
  auto store_a = [&](int s, int k0) {
    store_tile<kModeA, kLayoutA, kBM, kPasses>(a, m0, k0, k_end, ra, cva,
                                               a_hi(s), a_lo(s));
  };
  auto store_b = [&](int s, int k0) {
    if constexpr (!kBTiles) {
      store_tile<kModeB, kLayoutB, kBN, kPasses>(b, n0, k0, k_end, rb, cvb,
                                                 b_hi(s), b_lo(s));
    }
  };
  const int slices = (k_end - k_begin + kBK - 1) / kBK;
  if (slices <= 0) return;
  // This warpgroup's 64 rows of the A tile.
  const int a_off = (threadIdx.x / 128) * 64 * kRowBytes;
  float part[kBN / 2];

  // Pre-split B tiles (`split_weight`) arrive by bulk copy: one thread
  // asks for a slice's hi and lo tiles, and the stage's barrier counts the
  // bytes in.
  __shared__ alignas(8) uint64_t b_full[kStages];
  auto copy_b = [&](int s, int slice) {
    if constexpr (kBTiles) {
      if (threadIdx.x == 0) {
        constexpr int kTile = weight_tile_bytes<kBN, kPasses>();
        bulk_copy(b_hi(s), b_tiles + static_cast<size_t>(slice) * kTile,
                  kTile, &b_full[s]);
      }
    }
  };
  if constexpr (kBTiles) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) mbar_init(&b_full[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  if (!is_kmajor<kLayoutA>(a)) cva.load(a, m0);
  if constexpr (!kBTiles) {
    if (!is_kmajor<kLayoutB>(b)) cvb.load(b, n0);
  }
  // The slice's `wgmma`s in three groups: with three passes its small
  // terms (hi lo, lo hi) at depths 0-15, at 16-31, then its hi hi terms,
  // so that only 4 of the 12 steps add into a large accumulator (each such
  // step truncates); with one pass two groups of two steps.
  auto issue = [&](int s, int group) {
    if constexpr (kPasses == 3) {
      if (group < 2) {
#pragma unroll
        for (int kk = 2 * group; kk < 2 * group + 2; ++kk) {
          const uint64_t da = smem_desc(a_hi(s) + a_off + kk * 32);
          const uint64_t db = smem_desc(b_hi(s) + kk * 32);
          const uint64_t da_lo = smem_desc(a_lo(s) + a_off + kk * 32);
          const uint64_t db_lo = smem_desc(b_lo(s) + kk * 32);
          wgmma_tf32<kBN>(part, da, db_lo, kk > 0);
          wgmma_tf32<kBN>(part, da_lo, db, 1);
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < kBK / 8; ++kk) {
          const uint64_t da = smem_desc(a_hi(s) + a_off + kk * 32);
          const uint64_t db = smem_desc(b_hi(s) + kk * 32);
          wgmma_tf32<kBN>(part, da, db, 1);
        }
      }
    } else if (group < 2) {
#pragma unroll
      for (int kk = 2 * group; kk < 2 * group + 2; ++kk) {
        const uint64_t da = smem_desc(a_hi(s) + a_off + kk * 32);
        const uint64_t db = smem_desc(b_hi(s) + kk * 32);
        wgmma_tf32<kBN>(part, da, db, kk > 0);
      }
    }
  };

  copy_b(0, 0);
  load(k_begin);
  store_a(0, k_begin);
  store_b(0, k_begin);
  if (slices > 1) load(k_begin + kBK);
  for (int k = 0; k < slices; ++k) {
    const int s = k % kStages;
    const bool next = k + 1 < slices;
    const int k_next = k_begin + (k + 1) * kBK;
    // Generic-proxy stores become visible to the tensor cores' reads; the
    // barrier also orders every warpgroup's retirement of slice k - 1
    // (waited for below) before its stage is rewritten.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if constexpr (kBTiles) {
      if (next) copy_b((k + 1) % kStages, k + 1);
      mbar_wait(&b_full[s], (k / kStages) & 1);
    }
    fence_acc(part);
    wgmma_fence();
    // The issue of a `wgmma` waits while the tensor cores' queue is full,
    // so the staging of slice k + 1 (loaded a slice ago) goes between the
    // groups, and slice k + 2's loads fly under the last one.
    issue(s, 0);
    if (next) store_a((k + 1) % kStages, k_next);
    issue(s, 1);
    if (next) store_b((k + 1) % kStages, k_next);
    issue(s, 2);
    wgmma_commit();
    fence_acc(part);
    if (k + 2 < slices) load(k_begin + (k + 2) * kBK);
    wgmma_wait<0>();
    fence_acc(part);
#pragma unroll
    for (int j = 0; j < kBN / 2; ++j) acc[j] += part[j];
  }
}

// Where accumulator j of this thread sits in the block's output tile
// (`wgmma`'s float32 fragment: each warp owns 16 rows of its warpgroup's
// 64, each lane two rows 8 apart and two neighbouring columns of every
// 8-column group).
__device__ __forceinline__ int frag_row(int j) {
  const int t = threadIdx.x;
  return (t >> 7) * 64 + ((t >> 5) & 3) * 16 + ((t & 31) >> 2) +
         8 * ((j >> 1) & 1);
}

__device__ __forceinline__ int frag_col(int j) {
  return 8 * (j >> 2) + 2 * (threadIdx.x & 3) + (j & 1);
}

// Adds two sums over this warp's rows of each of the tile's kBN columns, in
// a fixed order (the thread's two rows, then three shuffles), and writes the
// warp's sums to red[warp * kBN + column] and red[(kWarps + warp) * kBN +
// column]. f(j, &u, &v) gives accumulator j's terms of the two sums.
template <int kBN, class F>
__device__ __forceinline__ void warp_column_sums(F f, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < kBN / 8; ++g) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float u0, v0, u1, v1;
      f(4 * g + e, &u0, &v0);
      f(4 * g + 2 + e, &u1, &v1);
      float u = u0 + u1;
      float v = v0 + v1;
#pragma unroll
      for (int d = 4; d < 32; d *= 2) {
        u += __shfl_xor_sync(0xffffffffu, u, d);
        v += __shfl_xor_sync(0xffffffffu, v, d);
      }
      if (lane < 4) {
        red[warp * kBN + 8 * g + 2 * lane + e] = u;
        red[(kWarps + warp) * kBN + 8 * g + 2 * lane + e] = v;
      }
    }
  }
}

// Adds the warps' column sums of `red` ([2][kWarps][kBN]) in warp order and
// writes them to row `block_row` of the partial arrays p0 and p1
// ([row blocks, n_cols]). Call after a barrier that follows the writes.
template <int kBN>
__device__ __forceinline__ void write_column_partials(const float* red,
                                                      int n0, int n_cols,
                                                      int block_row,
                                                      float* p0, float* p1) {
  for (int i = threadIdx.x; i < 2 * kBN; i += kThreads) {
    const int which = i / kBN;
    const int c = i % kBN;
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      total += red[(which * kWarps + w) * kBN + c];
    }
    if (n0 + c < n_cols) {
      float* out = which == 0 ? p0 : p1;
      out[static_cast<size_t>(block_row) * n_cols + n0 + c] = total;
    }
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

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Output tile width for `cols` output columns: one 136-wide tile for
// 129..136 columns (the first layer's F_0 = 136), else 128 (wrappers in
// fused_bn.py choose alike to size their row splits).
inline int tile_cols(int cols) { return cols > 128 && cols <= 136 ? 136 : 128; }

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Whether four neighbours of `o` may load as one vector.
inline int vector_ok(const void* p, long long ld, int cols, int bf16) {
  const uintptr_t align = bf16 ? 8 : 16;
  return cols % 4 == 0 && ld % 4 == 0 &&
         reinterpret_cast<uintptr_t>(p) % align == 0;
}

// The weight W(k, n) = w[k * ldk + n * ldn] (K x N, float32 or bf16) as
// the row-major matrix operand of a product whose depth runs over k
// (`depth_is_k`) or over n. W must be row-major or the transpose of a
// row-major matrix (one unit stride); false otherwise.
inline bool weight_operand(const void* w, int bf16, long long ldk,
                           long long ldn, int K, int N, bool depth_is_k,
                           Operand* o) {
  *o = Operand{};
  o->p = w;
  o->p_bf16 = bf16;
  if (ldn == 1 && ldk >= N) {
    o->rows = K;
    o->cols = N;
    o->ld = ldk;
    o->kmajor = !depth_is_k;
  } else if (ldk == 1 && ldn >= K) {
    o->rows = N;
    o->cols = K;
    o->ld = ldn;
    o->kmajor = depth_is_k;
  } else {
    return false;
  }
  o->vec = vector_ok(w, o->ld, o->cols, bf16);
  return true;
}

// The B operand `w` (depth by output: along its columns if `kmajor`, else
// down them), K x N, transformed once for every row block that reads it:
// split into hi and lo (or rounded to bf16 for one pass) and laid out as
// the stage's B tiles, slice after slice for each kBN-wide column tile,
// zero past K and N.
template <int kBN, int kPasses>
__global__ void split_weight_kernel(Operand w, int K, int N,
                                    uint8_t* __restrict__ out) {
  constexpr int kB = kBN * kRowBytes;
  constexpr int kTile = weight_tile_bytes<kBN, kPasses>();
  const int slices = cdiv(K, kBK);
  const long long total =
      static_cast<long long>(cdiv(N, kBN)) * slices * kBN * kBK;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int k = static_cast<int>(i % kBK);
    long long rest = i / kBK;
    const int n = static_cast<int>(rest % kBN);
    rest /= kBN;
    const int slice = static_cast<int>(rest % slices);
    const long long tile = rest / slices;
    const int depth = slice * kBK + k;
    const int col = static_cast<int>(tile) * kBN + n;
    float v = 0.0f;
    if (depth < K && col < N) {
      const size_t idx = w.kmajor ? static_cast<size_t>(col) * w.ld + depth
                                  : static_cast<size_t>(depth) * w.ld + col;
      v = load_elem(w.p, idx, w.p_bf16);
      if constexpr (kPasses == 1) v = round_to_bf16(v);
    }
    uint8_t* dst = out + (static_cast<size_t>(tile) * slices + slice) * kTile;
    put<kPasses>(dst, dst + kB, swizzled(n, k), v);
  }
}

// Bytes of `split_weight`'s output for a K x N weight.
inline long long weight_tiles_bytes(int K, int N, int bf16) {
  const int bn = tile_cols(N);
  return static_cast<long long>(cdiv(N, bn)) * cdiv(K, kBK) * bn * kRowBytes *
         (bf16 ? 1 : 2);
}

template <int kBN, int kPasses>
cudaError_t split_weight(const Operand& w, int K, int N, void* out,
                         cudaStream_t stream) {
  const long long total =
      static_cast<long long>(cdiv(N, kBN)) * cdiv(K, kBK) * kBN * kBK;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 8192 ? want : 8192);
  split_weight_kernel<kBN, kPasses><<<blocks, threads, 0, stream>>>(
      w, K, N, static_cast<uint8_t*>(out));
  return cudaGetLastError();
}

// Raises a kernel's dynamic shared-memory limit to what it asks for. A
// host-side attribute, not a stream operation, so it may run while a CUDA
// graph captures the stream.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace fbn
