// Native streaming data loader: files -> shuffled, decoded, padded batches.
//
// The port's copy of ranking_tpu/data/native/loader.cc. Beyond it: the
// documents past list_size report their counts (FeatureSpec.overflow, kept
// in the cache slots too), and a file that does not end at a record
// boundary is a stream error, as in the plain reader
// (ranking_tpu_torch/data/tfrecord.py).
//
// The runtime-executor counterpart of the reference's tf.data input
// pipeline (tensorflow_ranking/python/data.py:914-1017, which delegates
// threading to TensorFlow's C++ runtime — reader_num_threads /
// num_parser_threads AUTOTUNE at data.py:924-1011). One reader thread owns
// file walking, TFRecord scanning, the shuffle buffer, and record-batch
// assembly (so shuffle order is a pure function of the seed); N decode
// workers parse ELWC protos into padded feature buffers (decoder.cc); a
// sequence-ordered reorder buffer hands batches to the consumer in
// assembly order, making the output stream bit-identical for every
// num_threads. Exposed via a C ABI consumed with ctypes
// (ranking_tpu_torch/data/native).
//
// Build (one library with the decoder and the LIBSVM parser):
//   g++ -O3 -shared -fPIC -std=c++17 -pthread decoder.cc loader.cc libsvm.cc

#include <fcntl.h>
#include <sys/file.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

// From decoder.cc.
struct FeatureSpec {
  const char* name;
  int32_t kind;
  int32_t size;
  int64_t buckets;
  float* fout;
  int32_t* iout;
  float default_value;
  int64_t* lout;
  int32_t* present;
  const void* vocab;  // kind 4: rt_vocab_create handle
  int32_t* overflow;
};

extern "C" int rt_decode_elwc_batch(const uint8_t** recs, const int64_t* lens,
                                    int n, int list_size,
                                    FeatureSpec* ctx_specs, int n_ctx,
                                    FeatureSpec* ex_specs, int n_ex,
                                    int32_t* sizes_out);
extern "C" int rt_decode_seq_batch(const uint8_t** recs, const int64_t* lens,
                                   int n, int list_size,
                                   FeatureSpec* ctx_specs, int n_ctx,
                                   FeatureSpec* ex_specs, int n_ex,
                                   int32_t* sizes_out);
extern "C" int64_t rt_scan_tfrecord(const uint8_t* data, int64_t size,
                                    int64_t* offsets, int64_t* lengths,
                                    int64_t max_records);

namespace {

struct OwnedSpec {
  std::string name;
  int32_t kind;
  int32_t size;
  int64_t buckets;
  float default_value;
  const void* vocab;
};

// Consumer-owned output buffers for ONE batch (numpy memory registered
// via rt_loader_submit). Decode workers write feature values, presence
// counts, and sizes straight into these — the loader holds no
// intermediate buffers and the consumer thread copies nothing. The
// decoder's own prefill covers defaults for the n decoded rows; rows
// beyond n are left as-is and sliced away by the binding.
struct OutPtr {
  float* f = nullptr;
  int32_t* i = nullptr;
  int64_t* l = nullptr;
  int32_t* present = nullptr;
  int32_t* overflow = nullptr;
};
struct BufferSet {
  std::vector<OutPtr> ctx, ex;  // parallel to the loader's spec lists
  int32_t* sizes = nullptr;
};

// One mapped (or read) input file, shared by every in-flight record view
// that points into it; unmapped when the last view drops.
struct FileBuf {
  const uint8_t* data = nullptr;
  size_t size = 0;
  bool mapped = false;
  std::string owned;  // fallback when mmap is unavailable
  ~FileBuf() {
    if (mapped && data)
      munmap(const_cast<uint8_t*>(data), size);
  }
};

// Zero-copy record view: the reader never copies record payloads; the
// shuffle buffer and batches hold refs into the file mapping. cache_id is
// the record's canonical index into the decoded-once epoch cache (-1 when
// no cache is active); in cache READ mode owner/p/len are unused — the
// slot holds the decoded payload and the proto file is never opened.
struct RecordRef {
  std::shared_ptr<FileBuf> owner;
  const uint8_t* p = nullptr;
  int64_t len = 0;
  int64_t cache_id = -1;
};

// ---- Decoded-once epoch cache ---------------------------------------
//
// Host proto decode can pace the input pipeline, and the reference's
// tf.data pipeline
// re-parses every epoch and never caches
// (tensorflow_ranking/python/data.py:914-1017). The cache stores each
// record's DECODED payload — feature values, presence counts, list size,
// at a fixed per-record stride — at its canonical (path-list order, file
// order) position in one mmap(MAP_SHARED) spill file. The reader walks
// epochs exactly as without the cache: std::shuffle over the path order
// and the reservoir-shuffle rng() draws depend only on file/record
// COUNTS, so the emitted record sequence (and hence every batch) is
// bitwise-identical whether the cache is off, building, or complete.
//
// Decode workers consult a per-record published flag:
//   * set    -> one contiguous memcpy per feature from the slot into the
//               consumer's registered buffers (no proto decode at all);
//   * unset  -> decode the single record INTO its slot (the decoder's
//               prefill + per-record decode make slot bytes bit-equal to
//               the batch decode path), publish the flag (release), then
//               memcpy to the consumer.
// So epoch 1 pays one extra payload memcpy per record and every later
// epoch runs at memory bandwidth. When the last record is cached the
// header's `complete` marker is published (msync). Only complete caches
// are trusted across processes: an in-progress or crashed build is
// rebuilt from scratch (the in-memory flags are authoritative within the
// building process). Single-writer discipline via flock: readers of a
// complete cache hold LOCK_SH, a (re)builder holds LOCK_EX. A loader that
// was asked for a cache and cannot open, lock or write it fails its
// stream (rt_loader_cache_state then returns -1): it never runs uncached
// in its place.

inline int value_width(int32_t kind) {
  switch (kind) {
    case 0: return 4;           // float32
    case 1: case 2: return 8;   // int64
    default: return 4;          // int32 ids (hashed / vocab)
  }
}
inline bool is_fixed_kind(int32_t kind) { return kind == 0 || kind == 1; }

// Per-spec offsets of values (+ presence for fixed kinds, + the overflow
// count for fixed example kinds) inside one record's cache slot; ctx specs
// store 1 row, ex specs list_size rows.
struct SlotLayout {
  struct Field {
    int64_t val_off = 0;
    int64_t pres_off = -1;
    int64_t ovf_off = -1;
  };
  std::vector<Field> ctx, ex;
  int64_t sizes_off = 0;
  int64_t stride = 0;
};

SlotLayout make_slot_layout(const std::vector<OwnedSpec>& ctx_specs,
                            const std::vector<OwnedSpec>& ex_specs,
                            int list_size) {
  SlotLayout out;
  int64_t off = 0;
  auto add = [&](const std::vector<OwnedSpec>& specs, int64_t rows,
                 bool listwise, std::vector<SlotLayout::Field>* fields) {
    for (const auto& s : specs) {
      SlotLayout::Field f;
      f.val_off = off;
      off += rows * s.size * value_width(s.kind);
      if (is_fixed_kind(s.kind)) {
        f.pres_off = off;
        off += rows * 4;
        if (listwise) {
          f.ovf_off = off;
          off += 4;
        }
      }
      fields->push_back(f);
    }
  };
  add(ctx_specs, 1, false, &out.ctx);
  add(ex_specs, list_size, true, &out.ex);
  out.sizes_off = off;
  off += 4;
  out.stride = (off + 7) & ~int64_t(7);
  return out;
}

inline uint64_t fnv1a(uint64_t h, const void* data, size_t n) {
  const auto* p = static_cast<const uint8_t*>(data);
  for (size_t i = 0; i < n; ++i) {
    h ^= p[i];
    h *= 1099511628211ull;
  }
  return h;
}

// Structural fingerprint of the decode configuration. Guards shape/kind
// staleness; CONTENT identity of vocab tables is the binding's job (the
// Python side folds a vocab/content hash into the cache file name).
uint64_t cache_spec_hash(const std::vector<OwnedSpec>& ctx,
                         const std::vector<OwnedSpec>& ex, int list_size,
                         int format) {
  uint64_t h = 1469598103934665603ull;
  auto mix = [&](const std::vector<OwnedSpec>& specs) {
    for (const auto& s : specs) {
      h = fnv1a(h, s.name.data(), s.name.size());
      int64_t vals[3] = {s.kind, s.size, s.buckets};
      h = fnv1a(h, vals, sizeof vals);
      h = fnv1a(h, &s.default_value, sizeof s.default_value);
    }
  };
  mix(ctx);
  h = fnv1a(h, "|", 1);
  mix(ex);
  int64_t tail[2] = {list_size, format};
  return fnv1a(h, tail, sizeof tail);
}

constexpr uint64_t kCacheMagic = 0x3243414352544b52ull;  // "RKTRCAC2"

struct CacheHeader {
  uint64_t magic;
  uint64_t complete;
  uint64_t spec_hash;
  uint64_t stride;
  uint64_t total;
  uint64_t n_files;
};
struct CacheFileEntry {
  uint64_t path_hash, file_size, mtime_ns, n_records;
};

struct Cache {
  int fd = -1;
  uint8_t* base = nullptr;  // PROT_READ MAP_SHARED view of the spill
  size_t map_size = 0;
  int64_t table_off = 0;    // id -> payload offset table (int64 each)
  int64_t payload_off = 0;
  int64_t stride = 0;
  int64_t total = 0;
  std::vector<int64_t> file_counts, file_starts;  // canonical path order
  // Record id -> byte offset of its slot. Slots live in DECODE-ARRIVAL
  // order, not id order: build-time writes append via `cursor`, so the
  // spill is written sequentially — random per-record pwrites into a
  // sparse file cost 100-270us each on a virtualized host (page-by-page hole
  // allocation), ~10x the decode they were caching; sequential appends
  // run at full page-cache speed. The table is in-memory during a build
  // (each element written once under its record's striped lock, read
  // only after the flag acquire) and is persisted in one sequential
  // pwrite right before `complete`; readers load it back at init.
  std::vector<int64_t> offsets;
  std::atomic<int64_t> cursor{0};
  SlotLayout layout;
  std::atomic<int> mode{0};  // 0 = off, 1 = build, 2 = read
  // Build-mode only: per-record published flags + striped build locks
  // (the same record can legitimately be in flight twice across an epoch
  // boundary via the shuffle buffer; the lock serializes the slot write).
  // Slot WRITES go through pwrite from a thread-local scratch, not the
  // mapping: a per-4KB write fault on a fresh MAP_SHARED page costs
  // 10-25us on virtualized hosts; pwrite lands in the
  // page cache with no per-page trap and stays coherent with the
  // read-only mapping.
  std::unique_ptr<std::atomic<uint8_t>[]> flags;
  std::atomic<int64_t> n_cached{0};
  std::mutex build_mu[64];
  // Completion runs detached from the stream: the fsync that orders
  // payload-before-marker flushes ~GBs of dirty pages (seconds of disk
  // writeback) and must not stall the decode worker that happened to
  // cache the last record — the consumer would wait on it at end of
  // stream. Joined here so the fd outlives the sync.
  std::thread sync_thread;
  ~Cache() {
    if (sync_thread.joinable()) sync_thread.join();
    if (base) munmap(base, map_size);
    if (fd >= 0) ::close(fd);  // releases the flock
  }
};

// Full pwrite (loops over partial writes). False on any failure.
bool pwrite_all(int fd, const void* data, size_t n, int64_t off) {
  const auto* p = static_cast<const uint8_t*>(data);
  while (n > 0) {
    ssize_t w = pwrite(fd, p, n, static_cast<off_t>(off));
    if (w <= 0) return false;
    p += w;
    off += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

// Build-mode pre-scanned input file (kept mapped for the whole run so
// epochs > 1 of an in-progress build need no re-scan).
struct ScannedFile {
  std::shared_ptr<FileBuf> buf;
  std::vector<int64_t> offs, lens;
};

// Opens `path` for zero-copy reading. nullptr = hard error (unreadable,
// fstat failure, short read): the caller must surface it — silently
// skipping would train on a partial corpus with no signal. `*skip` is set
// instead for non-regular files (FIFOs/sockets), which are skipped by
// design.
std::shared_ptr<FileBuf> open_file(const std::string& path, bool* skip) {
  *skip = false;
  auto buf = std::make_shared<FileBuf>();
  int fd = ::open(path.c_str(), O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 0) {
    ::close(fd);
    return nullptr;
  }
  if (!S_ISREG(st.st_mode)) {
    ::close(fd);
    *skip = true;
    return nullptr;
  }
  buf->size = static_cast<size_t>(st.st_size);
  if (buf->size > 0) {
    void* m = mmap(nullptr, buf->size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (m != MAP_FAILED) {
      buf->data = static_cast<const uint8_t*>(m);
      buf->mapped = true;
      madvise(m, buf->size, MADV_SEQUENTIAL);
    } else {
      buf->owned.resize(buf->size);
      size_t got = 0;
      while (got < buf->size) {
        ssize_t r = ::read(fd, buf->owned.data() + got, buf->size - got);
        if (r <= 0) break;
        got += static_cast<size_t>(r);
      }
      if (got != buf->size) {
        ::close(fd);
        return nullptr;
      }
      buf->data = reinterpret_cast<const uint8_t*>(buf->owned.data());
    }
  }
  ::close(fd);
  return buf;
}

struct Work {
  int64_t seq;
  std::vector<RecordRef> records;
  // Cache-build backfill (no consumer batch): decode the records into
  // their spill slots only — no buffer wait, no sequence number. Pushed
  // by the reader at end of stream for records the run never decoded
  // (drop_remainder tails, skip_batches fast-forwards, the final
  // shuffle-buffer partial batch), so one clean full pass always
  // finishes the spill.
  bool cache_fill = false;
};

struct Loader {
  std::vector<std::string> paths;
  std::vector<OwnedSpec> ctx_specs, ex_specs;
  int batch_size, list_size, shuffle_buffer, epochs, ring_capacity;
  int format;  // 0 = ELWC, 1 = SequenceExample
  int num_threads;
  bool shuffle, drop_remainder;
  uint64_t seed;
  // Decode-free fast-forward (deterministic data resume): the reader
  // assembles and DROPS this many leading record batches — the shuffle
  // RNG advances identically, no decode work is dispatched, so the
  // stream after the skip is bitwise-equal to batches[skip:] of an
  // unskipped run at mmap-scan speed (~2M rec/s) instead of decode
  // speed. Reader-thread-only field (no locking).
  int64_t skip_batches = 0;
  // Decoded-once epoch cache (empty path = off). `cache` and `scanned`
  // are set in rt_loader_create before any thread starts; after that
  // `scanned` is reader-thread-only.
  std::string cache_path;
  std::unique_ptr<Cache> cache;
  std::atomic<bool> cache_failed{false};
  std::vector<ScannedFile> scanned;

  // Reader -> decoders (bounded; also bounds total in-flight batches).
  std::deque<Work> work_q;
  // Consumer-submitted output buffer sets awaiting a decoder, and
  // finished sequence numbers (seq -> decoded row count), both keyed by
  // assembly sequence number so the output order never depends on
  // decode-thread scheduling. A worker holding work seq s waits for
  // bufs[s]; the consumer submits sets in order, so the oldest pending
  // work always has (or is about to get) its buffers — deadlock-free.
  std::map<int64_t, BufferSet> bufs;
  std::map<int64_t, int> done;
  int64_t next_seq = 0;     // next sequence number the reader will assign
  int64_t next_submit = 0;  // next sequence number a submit will bind to
  int64_t next_out = 0;     // next sequence number the consumer will take
  std::mutex mu;
  std::condition_variable cv_work, cv_space, cv_out, cv_bufs;
  bool reader_done = false;
  int live_decoders = 0;
  std::atomic<bool> stop{false}, error{false};
  std::vector<std::thread> threads;

  ~Loader() {
    {
      // The lock orders this store against a thread that has evaluated
      // its wait predicate but not yet blocked — without it that thread
      // misses the notify and join() deadlocks.
      std::lock_guard<std::mutex> lock(mu);
      stop = true;
    }
    cv_work.notify_all();
    cv_space.notify_all();
    cv_out.notify_all();
    cv_bufs.notify_all();
    for (auto& t : threads)
      if (t.joinable()) t.join();
  }
};

void signal_error(Loader* L) {
  {
    std::lock_guard<std::mutex> lock(L->mu);
    L->error = true;
    L->stop = true;
  }
  L->cv_out.notify_all();
  L->cv_work.notify_all();
  L->cv_space.notify_all();
  L->cv_bufs.notify_all();
}

void cache_mark_complete(Cache* c) {
  // Persist the offset table, then the complete marker, with an fsync
  // between: payload + table bytes reach the disk before `complete` does
  // — a machine crash can lose an in-progress build (it rebuilds) but
  // can never yield complete=1 over torn payloads. Runs once per corpus
  // on the worker that caches the last record, detached onto
  // sync_thread (see Cache). Concurrent readers are unaffected: they
  // go through the page cache, and a process that opens the file before
  // the marker lands simply rebuilds/falls back as for any incomplete
  // spill.
  c->sync_thread = std::thread([c] {
    if (c->total > 0 &&
        !pwrite_all(c->fd, c->offsets.data(), sizeof(int64_t) * c->total,
                    c->table_off))
      return;  // marker stays 0: the next run rebuilds
    fsync(c->fd);
    const uint64_t one = 1;
    pwrite_all(c->fd, &one, sizeof one, offsetof(CacheHeader, complete));
  });
}

// The cache that was asked for cannot be opened, locked or written: the
// stream fails.
bool cache_fail(Loader* L) {
  L->cache_failed = true;
  signal_error(L);
  return false;
}

// Opens (READ), validates, or (re)builds the spill file. Runs in
// rt_loader_create, before any thread starts. Returns false after
// signalling the error: an unreadable corpus file (the strictness of the
// uncached walk), or a cache-side failure (another loader holds the lock,
// the path is unwritable, the spill cannot be sized or mapped).
bool cache_init(Loader* L) {
  auto c = std::make_unique<Cache>();
  c->layout = make_slot_layout(L->ctx_specs, L->ex_specs, L->list_size);
  const uint64_t shash = cache_spec_hash(L->ctx_specs, L->ex_specs,
                                         L->list_size, L->format);
  const size_t n = L->paths.size();
  std::vector<CacheFileEntry> entries(n);
  std::vector<bool> regular(n, true);
  for (size_t i = 0; i < n; ++i) {
    struct stat st;
    if (stat(L->paths[i].c_str(), &st) != 0) {
      signal_error(L);  // missing corpus file: match open_file strictness
      return false;
    }
    entries[i].path_hash =
        fnv1a(1469598103934665603ull, L->paths[i].data(),
              L->paths[i].size());
    if (!S_ISREG(st.st_mode)) {  // FIFOs etc. are skipped by design
      regular[i] = false;
      entries[i].file_size = entries[i].mtime_ns = entries[i].n_records = 0;
      continue;
    }
    entries[i].file_size = static_cast<uint64_t>(st.st_size);
    entries[i].mtime_ns = static_cast<uint64_t>(st.st_mtim.tv_sec) *
                              1000000000ull +
                          static_cast<uint64_t>(st.st_mtim.tv_nsec);
    entries[i].n_records = 0;  // filled by the build scan / header
  }

  c->fd = ::open(L->cache_path.c_str(), O_RDWR | O_CREAT | O_CLOEXEC, 0644);
  if (c->fd < 0) return cache_fail(L);

  // Fast path: a complete cache with a matching fingerprint is mapped
  // read-only under a shared lock (which blocks any rebuilder for as
  // long as this loader lives).
  if (flock(c->fd, LOCK_SH | LOCK_NB) == 0) {
    CacheHeader h;
    bool valid = pread(c->fd, &h, sizeof h, 0) == sizeof h &&
                 h.magic == kCacheMagic && h.complete == 1 &&
                 h.spec_hash == shash &&
                 h.stride == static_cast<uint64_t>(c->layout.stride) &&
                 h.n_files == n;
    std::vector<CacheFileEntry> on_disk(n);
    if (valid && n > 0) {
      valid = pread(c->fd, on_disk.data(), sizeof(CacheFileEntry) * n,
                    sizeof h) ==
              static_cast<ssize_t>(sizeof(CacheFileEntry) * n);
      for (size_t i = 0; valid && i < n; ++i)
        valid = on_disk[i].path_hash == entries[i].path_hash &&
                on_disk[i].file_size == entries[i].file_size &&
                on_disk[i].mtime_ns == entries[i].mtime_ns;
    }
    if (valid) {
      c->stride = c->layout.stride;
      c->total = static_cast<int64_t>(h.total);
      c->table_off =
          (sizeof(CacheHeader) + sizeof(CacheFileEntry) * n + 63) &
          ~int64_t(63);
      c->payload_off =
          (c->table_off + 8 * c->total + 63) & ~int64_t(63);
      int64_t start = 0;
      for (size_t i = 0; i < n; ++i) {
        c->file_starts.push_back(start);
        c->file_counts.push_back(static_cast<int64_t>(on_disk[i].n_records));
        start += c->file_counts.back();
      }
      struct stat cst;
      if (start == c->total && fstat(c->fd, &cst) == 0 &&
          static_cast<int64_t>(cst.st_size) >=
              c->payload_off + c->total * c->stride) {
        c->map_size = static_cast<size_t>(c->payload_off +
                                          c->total * c->stride);
        // Load + range-check the id -> slot table (every slot must fit
        // entirely inside the payload region).
        c->offsets.resize(c->total);
        bool table_ok =
            c->total == 0 ||
            pread(c->fd, c->offsets.data(), sizeof(int64_t) * c->total,
                  c->table_off) ==
                static_cast<ssize_t>(sizeof(int64_t) * c->total);
        for (int64_t i = 0; table_ok && i < c->total; ++i)
          table_ok = c->offsets[i] >= c->payload_off &&
                     c->offsets[i] + c->stride <=
                         static_cast<int64_t>(c->map_size);
        void* m = table_ok ? mmap(nullptr, c->map_size ? c->map_size : 1,
                                  PROT_READ, MAP_SHARED, c->fd, 0)
                           : MAP_FAILED;
        if (m != MAP_FAILED) {
          c->base = static_cast<uint8_t*>(m);
          c->mode.store(2);
          std::lock_guard<std::mutex> lock(L->mu);
          L->cache = std::move(c);
          return true;
        }
        c->map_size = 0;
      }
      c->file_starts.clear();
      c->file_counts.clear();
      c->offsets.clear();
    }
  }

  // Build path: exclusive lock, full scan, fresh spill.
  if (flock(c->fd, LOCK_EX | LOCK_NB) != 0) return cache_fail(L);  // busy
  L->scanned.resize(n);
  int64_t total = 0;
  for (size_t i = 0; i < n; ++i) {
    if (!regular[i]) continue;
    bool skip = false;
    std::shared_ptr<FileBuf> buf = open_file(L->paths[i], &skip);
    if (!buf) {
      if (skip) {
        regular[i] = false;
        continue;
      }
      signal_error(L);
      return false;
    }
    L->scanned[i].buf = buf;
    if (buf->size == 0) continue;
    int64_t size = static_cast<int64_t>(buf->size);
    int64_t max_records = size / 16 + 16;
    L->scanned[i].offs.resize(max_records);
    L->scanned[i].lens.resize(max_records);
    int64_t cnt = rt_scan_tfrecord(buf->data, size,
                                   L->scanned[i].offs.data(),
                                   L->scanned[i].lens.data(), max_records);
    if (cnt < 0) {  // a truncated or corrupt file
      signal_error(L);
      return false;
    }
    L->scanned[i].offs.resize(cnt);
    L->scanned[i].lens.resize(cnt);
    entries[i].n_records = static_cast<uint64_t>(cnt);
    total += cnt;
  }
  c->stride = c->layout.stride;
  c->total = total;
  c->table_off = (sizeof(CacheHeader) + sizeof(CacheFileEntry) * n + 63) &
                 ~int64_t(63);
  c->payload_off = (c->table_off + 8 * total + 63) & ~int64_t(63);
  c->map_size = static_cast<size_t>(c->payload_off + total * c->stride);
  c->offsets.assign(static_cast<size_t>(total), 0);
  c->cursor.store(c->payload_off);
  // Truncate-to-zero first so a stale payload never survives under a new
  // header; then size the fresh spill. Header + payload are written with
  // pwrite (see the Cache comment on write-fault cost); the mapping is
  // read-only and stays coherent through the shared page cache.
  CacheHeader h;
  h.magic = kCacheMagic;
  h.complete = 0;
  h.spec_hash = shash;
  h.stride = static_cast<uint64_t>(c->stride);
  h.total = static_cast<uint64_t>(total);
  h.n_files = n;
  if (ftruncate(c->fd, 0) != 0 ||
      ftruncate(c->fd, static_cast<off_t>(c->map_size)) != 0 ||
      !pwrite_all(c->fd, &h, sizeof h, 0) ||
      (n > 0 && !pwrite_all(c->fd, entries.data(),
                            sizeof(CacheFileEntry) * n, sizeof h)))
    return cache_fail(L);
  void* m = mmap(nullptr, c->map_size ? c->map_size : 1, PROT_READ,
                 MAP_SHARED, c->fd, 0);
  if (m == MAP_FAILED) {
    c->map_size = 0;
    return cache_fail(L);
  }
  c->base = static_cast<uint8_t*>(m);
  int64_t start = 0;
  for (size_t i = 0; i < n; ++i) {
    c->file_starts.push_back(start);
    c->file_counts.push_back(static_cast<int64_t>(entries[i].n_records));
    start += c->file_counts.back();
  }
  if (total > 0) {
    c->flags.reset(new std::atomic<uint8_t>[total]);
    for (int64_t i = 0; i < total; ++i)
      c->flags[i].store(0, std::memory_order_relaxed);
  } else {
    cache_mark_complete(c.get());
  }
  c->mode.store(1);
  {
    std::lock_guard<std::mutex> lock(L->mu);
    L->cache = std::move(c);
  }
  return true;
}

inline uint8_t* out_base(const OutPtr& o, int32_t kind) {
  switch (kind) {
    case 0: return reinterpret_cast<uint8_t*>(o.f);
    case 1: case 2: return reinterpret_cast<uint8_t*>(o.l);
    default: return reinterpret_cast<uint8_t*>(o.i);
  }
}

// Returns the record's decoded payload: the mmap slot when already
// cached, or — decoding it now into the calling thread's scratch,
// pwriting the slot, and publishing the flag — the scratch. Safe under
// concurrent duplicate attempts (the same record can be in flight twice
// across an epoch boundary) via the striped build locks. nullptr =
// the record failed to decode (corrupt data) or its slot could not be
// written (disk full: `cache_failed` says which); either fails the
// stream.
const uint8_t* cache_payload(Loader* L, const RecordRef& rec) {
  Cache* c = L->cache.get();
  if (c->mode.load(std::memory_order_relaxed) == 2 ||
      c->flags[rec.cache_id].load(std::memory_order_acquire))
    return c->base + c->offsets[rec.cache_id];
  static thread_local std::vector<uint8_t> scratch;
  if (static_cast<int64_t>(scratch.size()) < c->stride)
    scratch.assign(c->stride, 0);
  std::lock_guard<std::mutex> g(c->build_mu[rec.cache_id % 64]);
  if (c->flags[rec.cache_id].load(std::memory_order_acquire))
    return c->base + c->offsets[rec.cache_id];
  std::vector<FeatureSpec> ctx(L->ctx_specs.size());
  std::vector<FeatureSpec> ex(L->ex_specs.size());
  auto build = [&](const std::vector<OwnedSpec>& specs,
                   const std::vector<SlotLayout::Field>& fields,
                   std::vector<FeatureSpec>& out) {
    for (size_t s = 0; s < specs.size(); ++s) {
      out[s].name = specs[s].name.c_str();
      out[s].kind = specs[s].kind;
      out[s].size = specs[s].size;
      out[s].buckets = specs[s].buckets;
      out[s].default_value = specs[s].default_value;
      out[s].vocab = specs[s].vocab;
      uint8_t* v = scratch.data() + fields[s].val_off;
      out[s].fout = reinterpret_cast<float*>(v);
      out[s].iout = reinterpret_cast<int32_t*>(v);
      out[s].lout = reinterpret_cast<int64_t*>(v);
      out[s].present =
          fields[s].pres_off >= 0
              ? reinterpret_cast<int32_t*>(scratch.data() +
                                           fields[s].pres_off)
              : nullptr;
      out[s].overflow =
          fields[s].ovf_off >= 0
              ? reinterpret_cast<int32_t*>(scratch.data() +
                                           fields[s].ovf_off)
              : nullptr;
    }
  };
  build(L->ctx_specs, c->layout.ctx, ctx);
  build(L->ex_specs, c->layout.ex, ex);
  const uint8_t* recp = rec.p;
  int64_t len = rec.len;
  auto decode = L->format == 1 ? rt_decode_seq_batch : rt_decode_elwc_batch;
  if (decode(&recp, &len, 1, L->list_size, ctx.data(),
             static_cast<int>(ctx.size()), ex.data(),
             static_cast<int>(ex.size()),
             reinterpret_cast<int32_t*>(scratch.data() +
                                        c->layout.sizes_off)) != 0)
    return nullptr;
  // Sequential append: slots land in decode-arrival order (see Cache).
  const int64_t off = c->cursor.fetch_add(c->stride);
  if (!pwrite_all(c->fd, scratch.data(), static_cast<size_t>(c->stride),
                  off)) {
    L->cache_failed = true;
    return nullptr;
  }
  c->offsets[rec.cache_id] = off;
  c->flags[rec.cache_id].store(1, std::memory_order_release);
  if (c->n_cached.fetch_add(1) + 1 == c->total) cache_mark_complete(c);
  return scratch.data();
}

// Fills batch row `i` of the consumer's buffers from the record's
// decoded payload. False = the record could not be decoded or cached.
bool cache_decode_into(Loader* L, const RecordRef& rec, int i,
                       BufferSet& set) {
  Cache* c = L->cache.get();
  const uint8_t* slot = cache_payload(L, rec);
  if (slot == nullptr) return false;
  for (size_t s = 0; s < L->ctx_specs.size(); ++s) {
    const OwnedSpec& sp = L->ctx_specs[s];
    const SlotLayout::Field& f = c->layout.ctx[s];
    const int64_t bytes = int64_t(sp.size) * value_width(sp.kind);
    std::memcpy(out_base(set.ctx[s], sp.kind) + int64_t(i) * bytes,
                slot + f.val_off, bytes);
    if (f.pres_off >= 0 && set.ctx[s].present)
      set.ctx[s].present[i] =
          *reinterpret_cast<const int32_t*>(slot + f.pres_off);
  }
  for (size_t s = 0; s < L->ex_specs.size(); ++s) {
    const OwnedSpec& sp = L->ex_specs[s];
    const SlotLayout::Field& f = c->layout.ex[s];
    const int64_t bytes =
        int64_t(L->list_size) * sp.size * value_width(sp.kind);
    std::memcpy(out_base(set.ex[s], sp.kind) + int64_t(i) * bytes,
                slot + f.val_off, bytes);
    if (f.pres_off >= 0 && set.ex[s].present)
      std::memcpy(set.ex[s].present + int64_t(i) * L->list_size,
                  slot + f.pres_off, int64_t(L->list_size) * 4);
    if (f.ovf_off >= 0 && set.ex[s].overflow)
      set.ex[s].overflow[i] =
          *reinterpret_cast<const int32_t*>(slot + f.ovf_off);
  }
  set.sizes[i] =
      *reinterpret_cast<const int32_t*>(slot + c->layout.sizes_off);
  return true;
}

// Decodes one record batch DIRECTLY into the consumer's registered
// buffers (no intermediate copy; rt_decode_*_batch's own prefill covers
// defaults and presence for the n decoded rows).
bool decode_into(Loader* L, std::vector<RecordRef>& records,
                 BufferSet& set) {
  if (L->cache) {
    for (size_t i = 0; i < records.size(); ++i)
      if (!cache_decode_into(L, records[i], static_cast<int>(i), set))
        return false;
    return true;
  }
  int n = static_cast<int>(records.size());
  std::vector<FeatureSpec> ctx(L->ctx_specs.size());
  std::vector<FeatureSpec> ex(L->ex_specs.size());
  auto build = [&](const std::vector<OwnedSpec>& specs,
                   const std::vector<OutPtr>& ptrs,
                   std::vector<FeatureSpec>& c_specs) {
    for (size_t s = 0; s < specs.size(); ++s) {
      c_specs[s].name = specs[s].name.c_str();
      c_specs[s].kind = specs[s].kind;
      c_specs[s].size = specs[s].size;
      c_specs[s].buckets = specs[s].buckets;
      c_specs[s].default_value = specs[s].default_value;
      c_specs[s].vocab = specs[s].vocab;
      c_specs[s].fout = ptrs[s].f;
      c_specs[s].iout = ptrs[s].i;
      c_specs[s].lout = ptrs[s].l;
      c_specs[s].present = ptrs[s].present;
      c_specs[s].overflow = ptrs[s].overflow;
    }
  };
  build(L->ctx_specs, set.ctx, ctx);
  build(L->ex_specs, set.ex, ex);

  std::vector<const uint8_t*> recs(n);
  std::vector<int64_t> lens(n);
  for (int i = 0; i < n; ++i) {
    recs[i] = records[i].p;
    lens[i] = records[i].len;
  }
  auto decode = L->format == 1 ? rt_decode_seq_batch : rt_decode_elwc_batch;
  return decode(recs.data(), lens.data(), n, L->list_size,
                ctx.data(), static_cast<int>(ctx.size()),
                ex.data(), static_cast<int>(ex.size()),
                set.sizes) == 0;
}

// Reader-thread side: enqueue one assembled record batch for decoding.
// cache_fill batches carry no sequence number (seq -1): they bypass the
// consumer buffer ring entirely.
void push_work(Loader* L, std::vector<RecordRef>&& records,
               bool cache_fill = false) {
  std::unique_lock<std::mutex> lock(L->mu);
  L->cv_space.wait(lock, [&] {
    return L->stop ||
           static_cast<int>(L->work_q.size()) < L->ring_capacity;
  });
  if (L->stop) return;
  L->work_q.push_back(
      Work{cache_fill ? -1 : L->next_seq++, std::move(records), cache_fill});
  L->cv_work.notify_one();
}

void decode_loop(Loader* L) {
  // Backpressure is the consumer's buffer ring: a worker cannot start a
  // decode until the consumer has registered output buffers for that
  // sequence number (the consumer keeps K sets outstanding), so at most
  // K batches are ever in flight past the work queue. Deadlock-free:
  // work is popped in sequence order and buffers are submitted in
  // sequence order, so the oldest pending work always has its buffers.
  for (;;) {
    Work w;
    BufferSet set;
    {
      std::unique_lock<std::mutex> lock(L->mu);
      L->cv_work.wait(lock, [&] {
        return L->stop || (L->work_q.empty() && L->reader_done) ||
               !L->work_q.empty();
      });
      if (L->stop || (L->work_q.empty() && L->reader_done)) break;
      w = std::move(L->work_q.front());
      L->work_q.pop_front();
    }
    L->cv_space.notify_one();
    if (w.cache_fill) {
      bool ok = true;
      for (const RecordRef& rec : w.records)
        if (!(ok = cache_payload(L, rec) != nullptr)) break;
      if (!ok) {
        signal_error(L);
        break;
      }
      continue;
    }
    {
      std::unique_lock<std::mutex> lock(L->mu);
      L->cv_bufs.wait(lock, [&] {
        return L->stop || L->bufs.count(w.seq) != 0;
      });
      if (L->stop) break;
      auto it = L->bufs.find(w.seq);
      set = std::move(it->second);
      L->bufs.erase(it);
    }
    bool ok = decode_into(L, w.records, set);
    {
      std::lock_guard<std::mutex> lock(L->mu);
      if (!ok) {
        // Data corruption: surface it to the consumer (rt_loader_wait
        // returns -1 -> Python raises) — the one-shot decode path raises
        // for the same input, and the two paths must match in strictness.
        L->error = true;
        L->stop = true;
      } else {
        L->done.emplace(w.seq, static_cast<int>(w.records.size()));
      }
    }
    if (!ok) {
      L->cv_out.notify_all();
      L->cv_work.notify_all();
      L->cv_space.notify_all();
      L->cv_bufs.notify_all();
      break;
    }
    L->cv_out.notify_all();
  }
  {
    std::lock_guard<std::mutex> lock(L->mu);
    --L->live_decoders;
  }
  L->cv_out.notify_all();
}

void read_loop(Loader* L) {
  if (L->error) return;  // cache_init failed in rt_loader_create
  std::mt19937_64 rng(L->seed);
  std::vector<RecordRef> shuffle_buf;
  shuffle_buf.reserve(L->shuffle_buffer);
  std::vector<RecordRef> pending;

  auto emit = [&](RecordRef&& rec) {
    pending.push_back(std::move(rec));
    if (static_cast<int>(pending.size()) == L->batch_size) {
      if (L->skip_batches > 0) {
        --L->skip_batches;  // fast-forward: drop without dispatching decode
        pending.clear();
      } else {
        push_work(L, std::move(pending));
        pending = {};
      }
      pending.reserve(L->batch_size);
    }
  };

  int64_t offered = 0;  // records offered by the current epoch
  auto offer = [&](RecordRef&& rec) {
    ++offered;
    if (!L->shuffle || L->shuffle_buffer <= 1) {
      emit(std::move(rec));
      return;
    }
    if (static_cast<int>(shuffle_buf.size()) < L->shuffle_buffer) {
      shuffle_buf.push_back(std::move(rec));
      return;
    }
    size_t k = rng() % shuffle_buf.size();
    std::swap(shuffle_buf[k], rec);
    emit(std::move(rec));
  };

  const int cache_mode =
      L->cache ? L->cache->mode.load(std::memory_order_relaxed) : 0;
  for (int epoch = 0; (L->epochs <= 0 || epoch < L->epochs) && !L->stop;
       ++epoch) {
    // Shuffle path INDICES (not strings): identical rng consumption —
    // std::shuffle draws depend only on the element count — and the
    // index keys the cache's canonical per-file spans.
    offered = 0;
    std::vector<size_t> order(L->paths.size());
    for (size_t i = 0; i < order.size(); ++i) order[i] = i;
    if (L->shuffle)
      std::shuffle(order.begin(), order.end(), rng);
    for (size_t fi : order) {
      if (L->stop) break;
      if (cache_mode == 2) {
        // Complete cache: records ARE their slots; the proto files are
        // never opened (per-file counts come from the validated header).
        int64_t start = L->cache->file_starts[fi];
        int64_t cnt = L->cache->file_counts[fi];
        for (int64_t i = 0; i < cnt && !L->stop; ++i)
          offer(RecordRef{nullptr, nullptr, 0, start + i});
        continue;
      }
      if (cache_mode == 1) {
        // Building: emit from the init-time scan (files stay mapped for
        // the whole run), records tagged with their canonical slot.
        const ScannedFile& sf = L->scanned[fi];
        int64_t start = L->cache->file_starts[fi];
        for (size_t i = 0; i < sf.offs.size() && !L->stop; ++i)
          offer(RecordRef{sf.buf, sf.buf->data + sf.offs[i], sf.lens[i],
                          start + static_cast<int64_t>(i)});
        continue;
      }
      // mmap (fallback: full read) — records are zero-copy views into the
      // mapping, kept alive by the shared FileBuf until the last in-flight
      // record from this file drains. Non-regular files (FIFOs) skip;
      // unreadable/short-read files are a loader error (rt_loader_next
      // returns -1), matching decode-failure strictness.
      bool skip = false;
      std::shared_ptr<FileBuf> buf = open_file(L->paths[fi], &skip);
      if (!buf) {
        if (skip) continue;
        signal_error(L);
        break;
      }
      if (buf->size == 0) continue;
      int64_t size = static_cast<int64_t>(buf->size);
      int64_t max_records = size / 16 + 16;
      std::vector<int64_t> offs(max_records), lens(max_records);
      int64_t n = rt_scan_tfrecord(buf->data, size, offs.data(),
                                   lens.data(), max_records);
      if (n < 0) {  // a truncated or corrupt file
        signal_error(L);
        break;
      }
      for (int64_t i = 0; i < n && !L->stop; ++i)
        offer(RecordRef{buf, buf->data + offs[i], lens[i]});
    }
    // An epoch that offered no record would repeat forever without one:
    // with more epochs to go, that is a stream error (rt_loader_wait
    // returns -1 and Python raises).
    if (offered == 0 && !L->stop &&
        (L->epochs <= 0 || epoch + 1 < L->epochs)) {
      signal_error(L);
      break;
    }
  }
  if (!L->stop) {
    if (L->shuffle) {
      std::shuffle(shuffle_buf.begin(), shuffle_buf.end(), rng);
      for (auto& rec : shuffle_buf) emit(std::move(rec));
    }
    if (!pending.empty() && !L->drop_remainder) {
      if (L->skip_batches > 0)
        --L->skip_batches;  // the final partial batch counts too
      else
        push_work(L, std::move(pending));
    }
  }
  if (cache_mode == 1 && !L->stop) {
    // Backfill: records this run never decoded (drop_remainder tails,
    // skip_batches fast-forwards, a dropped final partial batch) would
    // otherwise leave the spill forever incomplete — and the next run
    // rebuilding from scratch. Sweep the flags and queue the gaps as
    // cache-fill work (a tiny tail in the common case; decode workers
    // may still be writing in-flight batches, so flags are re-checked
    // under the striped locks). End-of-stream waits on these like any
    // queued work, so a clean full pass always publishes `complete`.
    std::vector<RecordRef> fill;
    for (size_t fi = 0; fi < L->paths.size() && !L->stop; ++fi) {
      const ScannedFile& sf = L->scanned[fi];
      int64_t start = L->cache->file_starts[fi];
      for (size_t i = 0; i < sf.offs.size() && !L->stop; ++i) {
        int64_t id = start + static_cast<int64_t>(i);
        if (L->cache->flags[id].load(std::memory_order_acquire)) continue;
        fill.push_back(RecordRef{sf.buf, sf.buf->data + sf.offs[i],
                                 sf.lens[i], id});
        if (static_cast<int>(fill.size()) == L->batch_size) {
          push_work(L, std::move(fill), /*cache_fill=*/true);
          fill = {};
        }
      }
    }
    if (!fill.empty() && !L->stop)
      push_work(L, std::move(fill), /*cache_fill=*/true);
  }
  {
    std::lock_guard<std::mutex> lock(L->mu);
    L->reader_done = true;
  }
  L->cv_work.notify_all();
  L->cv_out.notify_all();
}

}  // namespace

extern "C" {

void* rt_loader_create(const char** paths, int n_paths,
                       FeatureSpec* ctx_specs, int n_ctx,
                       FeatureSpec* ex_specs, int n_ex, int batch_size,
                       int list_size, int shuffle, int shuffle_buffer,
                       int epochs, int drop_remainder, uint64_t seed,
                       int ring_capacity, int format, int num_threads,
                       int64_t skip_batches, const char* cache_path) {
  auto* L = new Loader();
  for (int i = 0; i < n_paths; ++i) L->paths.emplace_back(paths[i]);
  auto copy = [](FeatureSpec* specs, int n, std::vector<OwnedSpec>* out) {
    for (int i = 0; i < n; ++i)
      out->push_back({specs[i].name, specs[i].kind, specs[i].size,
                      specs[i].buckets, specs[i].default_value,
                      specs[i].vocab});
  };
  copy(ctx_specs, n_ctx, &L->ctx_specs);
  copy(ex_specs, n_ex, &L->ex_specs);
  L->batch_size = batch_size;
  L->list_size = list_size;
  L->shuffle = shuffle != 0;
  L->shuffle_buffer = shuffle_buffer;
  L->epochs = epochs;
  L->drop_remainder = drop_remainder != 0;
  L->seed = seed;
  L->num_threads = num_threads > 0 ? num_threads : 1;
  // The work queue bound also bounds in-flight decoded batches: at most
  // ring_capacity queued + num_threads decoding + that many finished in
  // the reorder buffer awaiting the consumer.
  L->ring_capacity = ring_capacity > 0 ? ring_capacity : 4;
  L->format = format;
  L->skip_batches = skip_batches > 0 ? skip_batches : 0;
  if (cache_path && cache_path[0]) {
    L->cache_path = cache_path;
    cache_init(L);  // on failure the stream's first wait returns -1
  }
  L->live_decoders = L->num_threads;
  L->threads.reserve(L->num_threads + 1);
  for (int i = 0; i < L->num_threads; ++i)
    L->threads.emplace_back(decode_loop, L);
  L->threads.emplace_back(read_loop, L);
  return L;
}

// Registers one set of consumer-owned output buffers (numpy memory) for
// the next unbound sequence number. The caller must keep the buffers
// alive until rt_loader_wait has returned for that sequence number (or
// the loader is destroyed). Pointer fields (fout/iout/lout/present) are
// copied out of the spec structs immediately; the structs themselves may
// be reused for the next submit.
int rt_loader_submit(void* handle, FeatureSpec* ctx_specs, int n_ctx,
                     FeatureSpec* ex_specs, int n_ex, int32_t* sizes_out) {
  auto* L = static_cast<Loader*>(handle);
  BufferSet set;
  set.ctx.resize(n_ctx);
  for (int s = 0; s < n_ctx; ++s)
    set.ctx[s] = OutPtr{ctx_specs[s].fout, ctx_specs[s].iout,
                        ctx_specs[s].lout, ctx_specs[s].present,
                        ctx_specs[s].overflow};
  set.ex.resize(n_ex);
  for (int s = 0; s < n_ex; ++s)
    set.ex[s] = OutPtr{ex_specs[s].fout, ex_specs[s].iout,
                       ex_specs[s].lout, ex_specs[s].present,
                       ex_specs[s].overflow};
  set.sizes = sizes_out;
  {
    std::lock_guard<std::mutex> lock(L->mu);
    L->bufs.emplace(L->next_submit++, std::move(set));
  }
  L->cv_bufs.notify_all();
  return 0;
}

// Blocks until the oldest submitted buffer set is filled; returns its
// decoded row count (0 = end of stream, -1 = stream error). Fill order
// is the submit order (the reorder map keys decode completion by
// sequence number), so the caller pops its oldest outstanding set.
int rt_loader_wait(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lock(L->mu);
  L->cv_out.wait(lock, [&] {
    return L->stop || L->done.count(L->next_out) ||
           (L->reader_done && L->work_q.empty() && L->live_decoders == 0);
  });
  auto it = L->done.find(L->next_out);
  if (it == L->done.end()) return L->error ? -1 : 0;
  int n = it->second;
  L->done.erase(it);
  ++L->next_out;
  return n;
}

// Cache engagement for this loader, set when it is created: 0 = off (no
// cache requested), 1 = building, 2 = reading a complete cache, -1 = the
// cache asked for could not be opened, locked or written (the stream
// fails).
int rt_loader_cache_state(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  if (L->cache_failed) return -1;
  std::lock_guard<std::mutex> lock(L->mu);
  return L->cache ? L->cache->mode.load() : 0;
}

void rt_loader_destroy(void* handle) {
  delete static_cast<Loader*>(handle);
}

}  // extern "C"
