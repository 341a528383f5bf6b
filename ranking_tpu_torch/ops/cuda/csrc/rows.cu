// In-place row scatter into embedding tables for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_scatter_kernel` behind `scatter_rows`
// and `_make_multi_kernel` behind `scatter_rows_multi` in
// ranking_tpu/ops/pallas/rows.py. Same function, for n = 1, 2 or 3 tables
// of one shape [V, D] under one id stream of K slots:
//   for every slot i with valid[i] != 0 and 0 <= ids[i] < V:
//     table_t[ids[i], :] = update_t[i, :]       for t = 0 .. n-1
// Every other slot is skipped. Valid ids must be unique (the sparse step's
// deduplication guarantees it), so no two slots write one row and the
// result does not depend on the order of the writes. Rows no slot names
// keep their bits.
//
// Design. The TPU kernel issues one DMA a row from VMEM under a budget of
// DMA semaphores, which caps its block at 256 rows and its row width at one
// 128-lane tile. Neither limit exists here: a group of lanes copies one row
// straight from the update slab to the table's own storage, in a
// grid-stride loop over the slots. The group is the power of two (at most a
// warp) nearest above the row's count of copy units, so a 512-byte row
// (D = 128, float32) takes a warp of 16-byte units and a 256-byte row half
// a warp. A group reads its slot's id and flag once; a slot that is
// invalid, negative or at or beyond V is skipped here, inside the kernel,
// because the kernel writes raw addresses and must never trust an id. Ids
// are read as the caller gave them, int32 or int64, and compared with V in
// 64 bits, so no id wraps into the table. For n
// tables one pass over the id stream loads a unit from each of the n slabs
// and then stores all n, so the id work and the loop are paid once. Units
// are 16-byte vectors when the row's bytes and every base pointer allow
// them, single elements otherwise (a 40-byte bfloat16 row of D = 20). No
// atomics, no host synchronisation, the caller's stream.
//
// Bound. The function moves n * (valid rows) * D * element bytes twice (read
// from the slabs, written to the tables) plus the id stream (K * 5 bytes
// with int32 ids):
// at K = 51200 rows of D = 128 float32 and n = 3, 157 MB, 47 us at
// 3.35 TB/s. Each row lands at a random place of a 1.5 GB table, so every
// store is a full-sector write to a cold line; with a 512-byte row a warp
// writes 16 whole sectors, so nothing beyond the bytes of the function
// should bound it once enough rows are in flight (the grid fills every
// multiprocessor).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTables = 3;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 2048 threads: a full multiprocessor

template <int N>
struct Slabs {
  void* table[N];
  const void* update[N];
};

template <int N, typename Unit, typename Id>
__global__ void __launch_bounds__(kThreads)
    scatter_rows_kernel(Slabs<N> s, const Id* __restrict__ ids,
                        const uint8_t* __restrict__ valid, int64_t K,
                        int64_t V, int units, int log2_group) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int group = 1 << log2_group;
  const int lane = static_cast<int>(tid & (group - 1));
  const int64_t stride =
      (static_cast<int64_t>(gridDim.x) * blockDim.x) >> log2_group;
  for (int64_t slot = tid >> log2_group; slot < K; slot += stride) {
    const int64_t id = static_cast<int64_t>(ids[slot]);
    if (valid[slot] == 0 || id < 0 || id >= V) continue;
    const int64_t dst = id * units;
    const int64_t src = slot * units;
    for (int u = lane; u < units; u += group) {
      Unit v[N];
#pragma unroll
      for (int t = 0; t < N; ++t) {
        v[t] = static_cast<const Unit*>(s.update[t])[src + u];
      }
#pragma unroll
      for (int t = 0; t < N; ++t) {
        static_cast<Unit*>(s.table[t])[dst + u] = v[t];
      }
    }
  }
}

template <int N, typename Unit, typename Id>
cudaError_t launch(void* const* tables, const void* const* updates,
                   const Id* ids, const uint8_t* valid, int64_t K,
                   int64_t V, int units, cudaStream_t stream) {
  Slabs<N> s;
  for (int t = 0; t < N; ++t) {
    s.table[t] = tables[t];
    s.update[t] = updates[t];
  }
  int log2_group = 0;
  while ((1 << log2_group) < units && log2_group < 5) ++log2_group;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) return err;
  const int64_t needed =
      ((K << log2_group) + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  const int blocks = static_cast<int>(needed < cap ? needed : cap);
  scatter_rows_kernel<N, Unit, Id><<<blocks, kThreads, 0, stream>>>(
      s, ids, valid, K, V, units, log2_group);
  return cudaGetLastError();
}

template <typename Unit, typename Id>
cudaError_t dispatch(int n, void* const* tables, const void* const* updates,
                     const Id* ids, const uint8_t* valid, int64_t K,
                     int64_t V, int units, cudaStream_t stream) {
  switch (n) {
    case 1:
      return launch<1, Unit, Id>(tables, updates, ids, valid, K, V, units, stream);
    case 2:
      return launch<2, Unit, Id>(tables, updates, ids, valid, K, V, units, stream);
    case 3:
      return launch<3, Unit, Id>(tables, updates, ids, valid, K, V, units, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename Id>
cudaError_t by_unit(int n, void* const* tables, const void* const* updates,
                    const Id* ids, const uint8_t* valid, int64_t K,
                    int64_t V, int D, int elem_bytes, cudaStream_t stream) {
  const int64_t row_bytes = static_cast<int64_t>(D) * elem_bytes;
  bool vec = row_bytes % 16 == 0;
  for (int t = 0; t < n; ++t) {
    vec = vec && aligned16(tables[t]) && aligned16(updates[t]);
  }
  if (vec) {
    return dispatch<uint4, Id>(n, tables, updates, ids, valid, K, V,
                               static_cast<int>(row_bytes / 16), stream);
  }
  if (elem_bytes == 4) {
    return dispatch<uint32_t, Id>(n, tables, updates, ids, valid, K, V, D,
                                  stream);
  }
  return dispatch<uint16_t, Id>(n, tables, updates, ids, valid, K, V, D,
                                stream);
}

}  // namespace

extern "C" {

int rows_max_tables() { return kMaxTables; }

// n contiguous tables [V, D] and n contiguous update slabs [K, D], all of one
// element type of elem_bytes (2 or 4) bytes; ids [K] of id_bytes (4: int32,
// 8: int64) and valid [K] uint8 on the device. Unused table and update
// pointers (n < 3) are ignored. Runs on `stream`; returns the CUDA error code
// of the launch (0 on success).
int scatter_rows(void* table0, void* table1, void* table2,
                 const void* update0, const void* update1,
                 const void* update2, const void* ids, int id_bytes,
                 const uint8_t* valid, int n, int64_t K, int64_t V, int D,
                 int elem_bytes, cudaStream_t stream) {
  if (n < 1 || n > kMaxTables || K < 0 || V < 0 || D < 0 ||
      (elem_bytes != 2 && elem_bytes != 4) ||
      (id_bytes != 4 && id_bytes != 8)) {
    return cudaErrorInvalidValue;
  }
  if (K == 0 || D == 0) return cudaSuccess;
  void* const tables[kMaxTables] = {table0, table1, table2};
  const void* const updates[kMaxTables] = {update0, update1, update2};
  if (id_bytes == 8) {
    return by_unit(n, tables, updates, static_cast<const int64_t*>(ids),
                   valid, K, V, D, elem_bytes, stream);
  }
  return by_unit(n, tables, updates, static_cast<const int32_t*>(ids), valid,
                 K, V, D, elem_bytes, stream);
}

}  // extern "C"
