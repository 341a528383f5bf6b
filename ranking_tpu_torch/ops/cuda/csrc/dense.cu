// Float32 dense products on the tensor cores for Hopper (sm_90a): the
// engine behind `layers.DenseGeneral` (ops/cuda/dense.py).
//
// Replaces no Pallas kernel: the JAX package leaves these products to XLA.
// It was added because the encoder's six products a layer (query, key,
// value, attention output, Dense_0, Dense_1), forward and backward, are
// most of the BERT cells' device time, and cuBLAS at float32's "highest"
// precision runs them on the float32 pipes (67 TFLOP/s), not the tensor
// cores.
//
//   C [M, N] = A [M, K] B [K, N] (+ bias [N])
//
// Numerics: split TF32, as the fused tower's engine (fused_bn_common.cuh).
// Each operand is x = hi + lo, hi = tf32(x), lo = tf32(x - hi), both
// rounded to nearest (ties away); a b ~ hi_a lo_b + lo_a hi_b + hi_a hi_b
// (and lo_a lo_b with four passes), which keeps about 22 of float32's 24
// bits. Sums are float32. The tensor cores add into their accumulator with
// truncation, so a long sum in one accumulator drifts, all one way: each
// 32-deep slice is summed on its own (`part`, small terms first within
// each step of 8) and added to the float32 total with a rounding add.
//
// Bound: operations. Three TF32 passes at 495 TFLOP/s give 165 TFLOP/s of
// float32-accurate products (the float32 pipes give 67). At the encoder's
// shapes (M = 4,096 or 16,384 rows, K and N of 768 and 3,072) the bytes
// from device memory are far below that line; the tiles' reads from L2
// are not: a 128 x 192 tile does 24 useful flops a byte it loads (A once,
// B's two planes), so 165 TFLOP/s would ask L2 for 6.9 TB/s, near what it
// gives. Large tiles and a ring deep enough to keep those reads in flight
// are the design's answer.
//
// Design: persistent and warp-specialised, three warpgroups a block and
// one block an SM.
//   - Warpgroup 0 gives up its registers (setmaxnreg); one thread of it is
//     the producer: it walks the block's tiles and, for each 32-deep slice,
//     waits for a free stage of the ring and asks the TMA unit for the A
//     tile (fp32, 128 rows) and the hi and lo tiles of B (192 rows),
//     counted in by the stage's `full` mbarrier. The ring has 3 stages of
//     64 KB, so the loads of the next slices, and of the next tile, run
//     under this one's products.
//   - Warpgroups 1 and 2 are the consumers, 64 rows of the tile each. B
//     comes pre-split: `dense_split_kernel` writes its hi and lo planes
//     ([N, K], the only layout TF32 `wgmma` reads), one pass a call, and
//     `wgmma` reads them from shared memory. A is split in registers (the
//     RS form of `wgmma`): each thread loads its fragment of the fp32 tile
//     from shared memory, one step of 8 ahead, and splits it there, so A
//     costs no extra pass and no extra bytes. The tile in shared memory is
//     either K-major (the TMA box is [128 rows, 32 depths]) or M-major
//     (four boxes of [32 depths, 32 rows]: A = X^T for dW, read straight
//     from X), under the 128-byte swizzle, which keeps the fragment loads
//     free of bank conflicts (K-major) or at two ways (M-major).
//   - A consumer warp releases a stage (the `empty` mbarrier) once its
//     warpgroup's products on it have completed; the epilogue writes the
//     tile from registers, with the bias, while the producer already loads
//     the next tile.
//   - Tiles: 128 x 192, and a split of the depth where the tiles alone
//     leave SMs idle (dW at [768, 768] is 24 tiles deep 4,096): each split
//     writes a partial [M, N] and `dense_reduce_kernel` adds them in a
//     fixed order. The wrapper picks the split from the shape by a model of
//     the waves (dense.py: `plan`); nothing is tuned at run time.
//   - Ragged edges: the TMA unit fills reads outside A and the B planes
//     with zeros, and the epilogue checks rows and columns.
// No synchronisation with the host, no allocation (the wrapper gives the
// planes and the partials), the caller's stream: the kernel can be captured
// in a CUDA graph.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;          // tile rows: two consumer warpgroups
constexpr int kBN = 192;          // tile columns
constexpr int kBK = 32;           // depth of a slice: one 128-byte row
constexpr int kThreads = 384;     // producer warpgroup + two consumers
constexpr int kConsumerWarps = 8;
constexpr int kStages = 3;
constexpr int kATile = kBM * kBK * 4;
constexpr int kBTile = kBN * kBK * 4;
constexpr int kStage = kATile + 2 * kBTile;
constexpr int kSmemBytes = kStages * kStage + 1024;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// tf32(x), rounded to nearest with ties away from zero (cvt.rna.tf32.f32):
// half a unit of the 13 dropped bits added to the magnitude, then cleared.
__device__ __forceinline__ float to_tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// `wgmma` descriptor of a K-major tile of 128-byte rows under the 128-byte
// swizzle: start address, leading offset 16 bytes (unused by this layout),
// 1024 bytes between 8-row groups, layout type 1.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint32_t a = smem_addr(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
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

// Keeps the compiler from moving reads or writes of registers that a
// `wgmma` in flight uses across the point where this stands.
template <int kN>
__device__ __forceinline__ void fence_regs(float (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int kN>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 192) = A (64 x 8, four TF32 registers a thread) B^T (8 x 192,
// K-major in shared memory) + (scale_d ? d : 0), float32 out.
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1;\n}\n"
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
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until `bar` has completed the phase of the given parity. A load
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

// The TMA unit copies the box at (x, y) (x along the contiguous axis) of
// `map`'s tensor into shared memory at `dst`; `bar` counts its bytes in.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_addr(bar))
      : "memory");
}

// Byte offset of A's element (tile row r, depth k) in a stage: K-major,
// 128-byte rows whose 16-byte chunks are swizzled by the row's low three
// bits; M-major, four [32 depths, 32 rows] boxes whose chunks are swizzled
// by the depth's.
template <bool kMMajor>
__device__ __forceinline__ uint32_t a_offset(int r, int k) {
  if constexpr (kMMajor) {
    const int rr = r & 31;
    return (r >> 5) * 4096 + k * 128 + ((((rr >> 2) ^ k) & 7) << 4) +
           ((rr & 3) << 2);
  } else {
    return r * 128 + ((((k >> 2) ^ r) & 7) << 4) + ((k & 3) << 2);
  }
}

// This thread's A fragment of step kk (depths 8 kk .. 8 kk + 7) of the
// stage's tile, split: hi in f[0..3], lo in f[4..7]. `wgmma`'s TF32 A
// fragment: a warp holds 16 rows of its warpgroup's 64; a lane rows
// r0 and r0 + 8 (r0 = lane / 4) at depths lane % 4 and lane % 4 + 4.
template <bool kMMajor>
__device__ __forceinline__ void load_fragment(const uint8_t* a, int r0,
                                              int kq, int kk,
                                              uint32_t (&hi)[4],
                                              uint32_t (&lo)[4]) {
  const int k = kk * 8 + kq;
  const float v[4] = {
      *reinterpret_cast<const float*>(a + a_offset<kMMajor>(r0, k)),
      *reinterpret_cast<const float*>(a + a_offset<kMMajor>(r0 + 8, k)),
      *reinterpret_cast<const float*>(a + a_offset<kMMajor>(r0, k + 4)),
      *reinterpret_cast<const float*>(a + a_offset<kMMajor>(r0 + 8, k + 4))};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float h = to_tf32(v[i]);
    hi[i] = __float_as_uint(h);
    lo[i] = __float_as_uint(to_tf32(v[i] - h));
  }
}

struct Shape {
  int m, n, k;
  int m_tiles, n_tiles, splits, slices;
  long long rs, cs;  // out (m, n) at m * rs + n * cs
};

// Tile and depth range of work unit u: tiles along N vary fastest, so the
// blocks in flight share A's rows, and B (the smaller operand at the
// encoder's shapes) stays in L2.
struct Unit {
  int m0, n0, split, s0, s1;
};

__device__ __forceinline__ Unit unit_of(const Shape& sh, int u) {
  Unit w;
  const int nt = u % sh.n_tiles;
  const int rest = u / sh.n_tiles;
  w.m0 = (rest % sh.m_tiles) * kBM;
  w.n0 = nt * kBN;
  w.split = rest / sh.m_tiles;
  w.s0 = static_cast<int>(static_cast<long long>(w.split) * sh.slices /
                          sh.splits);
  w.s1 = static_cast<int>(static_cast<long long>(w.split + 1) * sh.slices /
                          sh.splits);
  return w;
}

// Passes: 3 (hi lo, lo hi, hi hi) or 4 (lo lo first). `out` takes the tile
// (+ bias) where the depth is not split; else `partial` + split * M * N
// takes its share, row-major, for `dense_reduce_kernel`.
template <int kPasses, bool kMMajor>
__global__ void __launch_bounds__(kThreads, 1)
    dense_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_bhi,
                 const __grid_constant__ CUtensorMap map_blo,
                 const float* __restrict__ bias, float* __restrict__ out,
                 float* __restrict__ partial, Shape sh) {
  static_assert(kPasses == 3 || kPasses == 4, "three or four TF32 passes");
  extern __shared__ uint8_t smem_raw[];
  __shared__ alignas(8) uint64_t full[kStages];
  __shared__ alignas(8) uint64_t empty[kStages];
  uint8_t* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int units = sh.m_tiles * sh.n_tiles * sh.splits;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // The producer.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit w = unit_of(sh, u);
        for (int sl = w.s0; sl < w.s1; ++sl, ++it) {
          const int s = it % kStages;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          uint8_t* st = smem + s * kStage;
          mbar_expect_tx(&full[s], kStage);
          const int k0 = sl * kBK;
          if constexpr (kMMajor) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              tma_load(st + q * 4096, &map_a, w.m0 + 32 * q, k0, &full[s]);
            }
          } else {
            tma_load(st, &map_a, k0, w.m0, &full[s]);
          }
          tma_load(st + kATile, &map_bhi, k0, w.n0, &full[s]);
          tma_load(st + kATile + kBTile, &map_blo, k0, w.n0, &full[s]);
        }
      }
    }
    return;
  }

  // The consumers.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int t = threadIdx.x - 128;
  const int wg = t >> 7;
  const int warp = (t >> 5) & 3;
  const int lane = t & 31;
  const int r0 = wg * 64 + warp * 16 + (lane >> 2);
  const int kq = lane & 3;
  float acc[kBN / 2];
  float part[kBN / 2];
#pragma unroll
  for (int j = 0; j < kBN / 2; ++j) part[j] = 0.0f;
  uint32_t hi[2][4], lo[2][4];
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit w = unit_of(sh, u);
#pragma unroll
    for (int j = 0; j < kBN / 2; ++j) acc[j] = 0.0f;
    for (int sl = w.s0; sl < w.s1; ++sl, ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      const uint8_t* a = smem + s * kStage;
      const uint8_t* b_hi = a + kATile;
      const uint8_t* b_lo = b_hi + kBTile;
      load_fragment<kMMajor>(a, r0, kq, 0, hi[0], lo[0]);
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {
        const int f = kk & 1;
        const uint64_t d_hi = smem_desc(b_hi + kk * 32);
        const uint64_t d_lo = smem_desc(b_lo + kk * 32);
        fence_regs(part);
        wgmma_fence();
        // Small terms first: only the last step of each 8 adds into a
        // part that holds hi hi terms of this step.
        if constexpr (kPasses == 4) {
          wgmma_rs_n192(part, lo[f], d_lo, kk > 0);
          wgmma_rs_n192(part, hi[f], d_lo, 1);
        } else {
          wgmma_rs_n192(part, hi[f], d_lo, kk > 0);
        }
        wgmma_rs_n192(part, lo[f], d_hi, 1);
        wgmma_rs_n192(part, hi[f], d_hi, 1);
        wgmma_commit();
        fence_regs(part);
        if (kk + 1 < kBK / 8) {
          // Step kk - 1 has completed, so its fragment registers are free
          // for step kk + 1's.
          wgmma_wait<1>();
          fence_regs(hi[f ^ 1]);
          fence_regs(lo[f ^ 1]);
          load_fragment<kMMajor>(a, r0, kq, kk + 1, hi[f ^ 1], lo[f ^ 1]);
        }
      }
      wgmma_wait<0>();
      fence_regs(part);
      fence_regs(hi[0]);
      fence_regs(lo[0]);
      fence_regs(hi[1]);
      fence_regs(lo[1]);
      if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int j = 0; j < kBN / 2; ++j) acc[j] += part[j];
    }

    // The epilogue: accumulator j of this thread is tile row
    // r0 + 8 ((j >> 1) & 1), column 8 (j >> 2) + 2 (lane % 4) + (j & 1).
    // N is even, so both columns of a pair are in or out.
    float* dst = out;
    long long rs = sh.rs, cs = sh.cs;
    const float* b = bias;
    if (sh.splits > 1) {
      dst = partial + static_cast<long long>(w.split) * sh.m * sh.n;
      rs = sh.n;
      cs = 1;
      b = nullptr;
    }
#pragma unroll
    for (int j = 0; j < kBN / 2; j += 2) {
      const int row = w.m0 + r0 + 8 * ((j >> 1) & 1);
      const int col = w.n0 + 8 * (j >> 2) + 2 * kq;
      if (row >= sh.m || col >= sh.n) continue;
      float v0 = acc[j], v1 = acc[j + 1];
      if (b != nullptr) {
        v0 += b[col];
        v1 += b[col + 1];
      }
      if (cs == 1) {
        *reinterpret_cast<float2*>(dst + row * rs + col) =
            make_float2(v0, v1);
      } else {
        dst[row * rs + col * cs] = v0;
        dst[row * rs + (col + 1) * cs] = v1;
      }
    }
  }
}

// hi and lo planes [n, k] (rows `ldp` apart, K-major for `wgmma`) of a
// float32 matrix: src[i * ld + j] is element (i, j) of [n, k] (`transpose`
// 0) or of [k, n] (`transpose` 1, through a 32 x 32 tile in shared memory,
// so that both the reads and the writes are coalesced).
__global__ void __launch_bounds__(256)
    dense_split_kernel(const float* __restrict__ src, long long ld, int n,
                       int k, int transpose, float* __restrict__ hi,
                       float* __restrict__ lo, long long ldp) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int j0 = blockIdx.x * 32;  // along k
  const int i0 = blockIdx.y * 32;  // along n
  if (transpose) {
    // src is [k, n]: read rows j0.. (depth) along n, write along k.
    for (int r = ty; r < 32; r += 8) {
      const int j = j0 + r, i = i0 + tx;
      tile[r][tx] = (j < k && i < n) ? src[j * ld + i] : 0.0f;
    }
    __syncthreads();
    for (int r = ty; r < 32; r += 8) {
      const int i = i0 + r, j = j0 + tx;
      if (i < n && j < k) {
        const float v = tile[tx][r];
        const float h = to_tf32(v);
        hi[i * ldp + j] = h;
        lo[i * ldp + j] = to_tf32(v - h);
      }
    }
  } else {
    for (int r = ty; r < 32; r += 8) {
      const int i = i0 + r, j = j0 + tx;
      if (i < n && j < k) {
        const float v = src[i * ld + j];
        const float h = to_tf32(v);
        hi[i * ldp + j] = h;
        lo[i * ldp + j] = to_tf32(v - h);
      }
    }
  }
}

// out (m, n) = sum over the splits, in order, of partial[s][m][n] (+ bias).
__global__ void __launch_bounds__(256)
    dense_reduce_kernel(const float* __restrict__ partial, int splits, int m,
                        int n, const float* __restrict__ bias,
                        float* __restrict__ out, long long rs, long long cs) {
  const long long total = static_cast<long long>(m) * n;
  for (long long e = blockIdx.x * 256ll + threadIdx.x; e < total;
       e += static_cast<long long>(gridDim.x) * 256) {
    float v = partial[e];
    for (int s = 1; s < splits; ++s) v += partial[s * total + e];
    const int row = static_cast<int>(e / n), col = static_cast<int>(e % n);
    if (bias != nullptr) v += bias[col];
    out[row * rs + col * cs] = v;
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The CUDA driver API's tensor-map encoder, found through the runtime (no
// link to libcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A 2-D float32 tensor map: `inner` elements along the contiguous axis,
// `outer` rows `ld` elements apart; boxes of [box_outer, 32] under the
// 128-byte swizzle, reads outside the tensor filled with zeros.
bool tensor_map(CUtensorMap* map, const void* p, long long inner,
                long long outer, long long ld, int box_outer) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 4};
  const cuuint32_t box[2] = {32, static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<void*>(p), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kPasses, bool kMMajor>
cudaError_t launch(const CUtensorMap& a, const CUtensorMap& bhi,
                   const CUtensorMap& blo, const float* bias, float* out,
                   float* partial, const Shape& sh, int grid,
                   cudaStream_t stream) {
  auto kernel = dense_kernel<kPasses, kMMajor>;
  // The shared-memory allowance is set once a device (before any capture:
  // the first call of a shape runs eagerly).
  static unsigned long long ready = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64) return cudaErrorInvalidDevice;
  if (!(ready >> device & 1ull)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return err;
    ready |= 1ull << device;
  }
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(a, bhi, blo, bias, out,
                                                 partial, sh);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Three TF32 passes. A fourth (lo lo) would add about two bits; the BERT
// cells' correctness readings stay under half their limits at three
// (PERF.md, row 11's findings), so it is not built.
constexpr int kTf32Passes = 3;

}  // namespace

extern "C" {

// hi and lo planes [n, k] of a float32 matrix (see dense_split_kernel), rows
// `ldp` apart. Returns the CUDA error of the launch (0 on success).
int dense_split(const float* src, long long ld, int n, int k, int transpose,
                float* hi, float* lo, long long ldp, cudaStream_t stream) {
  if (n <= 0 || k <= 0 || ldp < k) return cudaErrorInvalidValue;
  const dim3 grid((k + 31) / 32, (n + 31) / 32);
  dense_split_kernel<<<grid, 256, 0, stream>>>(src, ld, n, k, transpose, hi,
                                               lo, ldp);
  return cudaGetLastError();
}

// out = A B (+ bias), float32, on the tensor cores in kTf32Passes TF32
// passes. A [m, k] is read at a + i * lda + j (`a_mmajor` 0) or
// a + j * lda + i (`a_mmajor` 1: A^T stored row-major); B's hi and lo
// planes are [n, k], rows `ldb` apart (dense_split). out (i, j) is written
// at out + i * rs + j * cs, with rs or cs 1 and n even. `splits` is the
// number of depth ranges (partial then holds splits * m * n floats), `grid`
// the number of persistent blocks.
// lda and ldb multiples of 4 (the TMA unit's 16-byte strides); a, the
// planes and out 16-byte aligned.
int dense_gemm(const float* a, long long lda, int a_mmajor, const float* bhi,
               const float* blo, long long ldb, const float* bias, float* out,
               long long rs, long long cs, float* partial, int m, int n, int k,
               int splits, int grid, cudaStream_t stream) {
  if (m <= 0 || n <= 0 || k <= 0 || lda % 4 || ldb % 4 || ldb < k ||
      !aligned16(a) || !aligned16(bhi) || !aligned16(blo) ||
      !aligned16(out) || splits < 1 || grid < 1 ||
      n % 2 || (cs != 1 && rs != 1) || (splits > 1 && partial == nullptr)) {
    return cudaErrorInvalidValue;
  }
  Shape sh;
  sh.m = m;
  sh.n = n;
  sh.k = k;
  sh.m_tiles = (m + kBM - 1) / kBM;
  sh.n_tiles = (n + kBN - 1) / kBN;
  sh.splits = splits;
  sh.slices = (k + kBK - 1) / kBK;
  sh.rs = rs;
  sh.cs = cs;
  if (splits > sh.slices) return cudaErrorInvalidValue;
  CUtensorMap map_a, map_bhi, map_blo;
  const bool ok =
      (a_mmajor ? tensor_map(&map_a, a, m, k, lda, 32)
                : tensor_map(&map_a, a, k, m, lda, kBM)) &&
      tensor_map(&map_bhi, bhi, k, n, ldb, kBN) &&
      tensor_map(&map_blo, blo, k, n, ldb, kBN);
  if (!ok) return cudaErrorInvalidValue;
  const cudaError_t err =
      a_mmajor ? launch<kTf32Passes, true>(map_a, map_bhi, map_blo, bias, out,
                                           partial, sh, grid, stream)
               : launch<kTf32Passes, false>(map_a, map_bhi, map_blo, bias,
                                            out, partial, sh, grid, stream);
  if (err != cudaSuccess || splits == 1) return err;
  const long long total = static_cast<long long>(m) * n;
  const int blocks = static_cast<int>((total + 255) / 256 < 4096
                                          ? (total + 255) / 256
                                          : 4096);
  dense_reduce_kernel<<<blocks, 256, 0, stream>>>(partial, splits, m, n,
                                                 bias, out, rs, cs);
  return cudaGetLastError();
}

}  // extern "C"
