// Native batch decoder for ranking data: ELWC, ExampleInExample,
// SequenceExample and tf.Example wire format -> padded arrays.
//
// The port's copy of ranking_tpu/data/native/decoder.cc (its LIBSVM part is
// libsvm.cc here), the host side that replaces the proto decode the
// reference delegates to TensorFlow's C++ kernels (tf.io.decode_proto /
// parse_example, tensorflow_ranking/python/data.py:83-96,142). One call
// decodes a batch of serialized records straight into caller-allocated
// padded arrays ([B, L, F] floats, [B, L, T] token ids with -1 padding,
// hashed or vocabulary strings). Exposed through a C ABI that
// ranking_tpu_torch/data/native/__init__.py binds with ctypes.
//
// Wire contract (field numbers):
//   ExampleListWithContext: examples = repeated bytes 1, context = bytes 2
//   Example.features = 1; Features.feature = map<string, Feature> 1
//   map entry: key = 1, value = 2
//   Feature (a oneof): bytes_list = 1, float_list = 2, int64_list = 3;
//   *.value = 1 (float packed or unpacked, int64 varint packed or unpacked)
//   SequenceExample: context = Features 1, feature_lists = FeatureLists 2;
//   FeatureLists.feature_list = map<string, FeatureList> 1;
//   FeatureList.feature = repeated Feature 1
//
// Parse semantics are protobuf's, which the plain parser
// (ranking_tpu_torch/data/proto.py) follows too: a singular message that
// occurs again merges; a map key that occurs again replaces its value
// whole; the Feature oneof keeps the kind that came last; unknown fields
// (groups included) are skipped by wire type; a malformed field makes the
// batch call return -1. Beyond the JAX package's copy: the errors of nested
// messages reach the caller, a value of another list type than the spec's
// is reported (count -1), and the documents (frames) past list_size are
// checked for the counts the plain parser checks (FeatureSpec.overflow).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread decoder.cc loader.cc
//        libsvm.cc

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

// kind: 0 = fixed-len float, 1 = fixed-len int64,
//       2 = varlen int64 tokens, 3 = varlen hashed-string tokens,
//       4 = varlen vocabulary-file string tokens
struct FeatureSpec {
  const char* name;
  int32_t kind;
  int32_t size;      // fixed: values per example; varlen: max_len
  int64_t buckets;   // kind 3: hash bucket count
  float* fout;       // kind 0 output base
  int32_t* iout;     // kind 3/4 output base (int32 ids, -1 pad)
  float default_value;
  int64_t* lout;     // kind 1/2 output base (full-width int64)
  int32_t* present;  // fixed kinds: per row, the values of the spec's list
                     // type, or -1 for values of another type only
  const void* vocab; // kind 4: rt_vocab_create handle
  int32_t* overflow; // fixed example kinds: per record, the worst count of
                     // the documents past list_size (size = all fine)
};

namespace {

struct Slice {
  const uint8_t* p;
  size_t n;
};

// --- varint / wire primitives ---------------------------------------------

inline bool read_varint(const uint8_t*& p, const uint8_t* end, uint64_t* out) {
  uint64_t v = 0;
  int shift = 0;
  while (p < end && shift < 70) {
    uint8_t b = *p++;
    if (shift < 64) v |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = v;
      return true;
    }
    shift += 7;
  }
  return false;
}

// A field's tag; field number 0 is malformed.
inline bool read_tag(const uint8_t*& p, const uint8_t* end, uint64_t* tag) {
  return read_varint(p, end, tag) && (*tag >> 3) != 0;
}

// Skips the field of `tag`. Returns false on malformed input.
bool skip_field(const uint8_t*& p, const uint8_t* end, uint64_t tag,
                int depth = 0) {
  uint64_t tmp;
  switch (tag & 7) {
    case 0:
      return read_varint(p, end, &tmp);
    case 1:
      if (end - p < 8) return false;
      p += 8;
      return true;
    case 2:
      if (!read_varint(p, end, &tmp) || tmp > static_cast<uint64_t>(end - p))
        return false;
      p += tmp;
      return true;
    case 3:  // a group: fields up to its end-group tag
      if (depth > 64) return false;
      for (;;) {
        uint64_t inner;
        if (!read_tag(p, end, &inner)) return false;
        if ((inner & 7) == 4) return (inner >> 3) == (tag >> 3);
        if (!skip_field(p, end, inner, depth + 1)) return false;
      }
    case 5:
      if (end - p < 4) return false;
      p += 4;
      return true;
    default:
      return false;
  }
}

inline bool read_len_delim(const uint8_t*& p, const uint8_t* end, Slice* out) {
  uint64_t len;
  if (!read_varint(p, end, &len) || len > static_cast<uint64_t>(end - p))
    return false;
  out->p = p;
  out->n = static_cast<size_t>(len);
  p += len;
  return true;
}

// --- fnv1a hash (matches ranking_tpu_torch/data/parsers.py) ----------------

inline uint64_t fnv1a(const uint8_t* p, size_t n) {
  uint64_t h = 0xCBF29CE484222325ULL;
  for (size_t i = 0; i < n; ++i) {
    h ^= p[i];
    h *= 0x100000001B3ULL;
  }
  return h;
}

// --- vocabulary table (matches parsers.Vocabulary) --------------------------
//
// Read-only after rt_vocab_create, so decode threads share one handle with
// no synchronization. Token -> index + num_oov; miss -> fnv1a % num_oov.

struct VocabEntry {
  uint64_t hash;
  uint32_t off;
  uint32_t len;
  int32_t id;
};

struct Vocab {
  std::string arena;               // concatenated token bytes
  std::vector<VocabEntry> entries;
  std::vector<int32_t> slots;      // open addressing: entry + 1, 0 = empty
  uint64_t mask = 0;
  int64_t num_oov = 1;
};

inline int32_t vocab_lookup(const Vocab* v, const uint8_t* p, size_t n) {
  uint64_t h = fnv1a(p, n);
  size_t slot = static_cast<size_t>(h & v->mask);
  for (;;) {
    int32_t e = v->slots[slot];
    if (e == 0) break;
    const VocabEntry& ent = v->entries[e - 1];
    if (ent.hash == h && ent.len == n &&
        std::memcmp(v->arena.data() + ent.off, p, n) == 0)
      return ent.id;
    slot = (slot + 1) & v->mask;
  }
  return static_cast<int32_t>(h % static_cast<uint64_t>(v->num_oov));
}

// --- feature values ----------------------------------------------------------

// Per-batch view of a FeatureSpec with the name length computed once.
struct SpecView {
  const FeatureSpec* spec;
  uint32_t name_len;
};

inline std::vector<SpecView> make_views(const FeatureSpec* specs, int n) {
  std::vector<SpecView> views(n);
  for (int i = 0; i < n; ++i)
    views[i] = {&specs[i],
                static_cast<uint32_t>(std::strlen(specs[i].name))};
  return views;
}

// The Feature field (1 bytes, 2 float, 3 int64) that holds a spec's values.
inline uint32_t list_field(int32_t kind) {
  return kind == 0 ? 2 : (kind == 1 || kind == 2) ? 3 : 1;
}

inline void fill_row(const FeatureSpec& spec, size_t row) {
  const size_t base = row * static_cast<size_t>(spec.size);
  if (spec.kind == 0) {
    for (int i = 0; i < spec.size; ++i)
      spec.fout[base + i] = spec.default_value;
  } else if (spec.kind == 1) {
    const int64_t d = static_cast<int64_t>(spec.default_value);
    for (int i = 0; i < spec.size; ++i) spec.lout[base + i] = d;
  } else if (spec.kind == 2) {
    for (int i = 0; i < spec.size; ++i) spec.lout[base + i] = -1;
  } else {
    for (int i = 0; i < spec.size; ++i) spec.iout[base + i] = -1;
  }
}

// Decodes one list message (field 1 = value) of the spec's type; writes
// into `row` unless it is negative, up to the row's width. `seen` counts
// every value.
bool decode_list(const Slice& list, const FeatureSpec& spec, int64_t row,
                 int* wrote, int* seen) {
  const uint8_t* q = list.p;
  const uint8_t* qend = list.p + list.n;
  const size_t base = row < 0 ? 0 : static_cast<size_t>(row) * spec.size;
  const bool write = row >= 0;
  while (q < qend) {
    uint64_t vtag;
    if (!read_tag(q, qend, &vtag)) return false;
    const uint32_t vwt = vtag & 7;
    if ((vtag >> 3) != 1) {
      if (!skip_field(q, qend, vtag)) return false;
      continue;
    }
    if (spec.kind == 0 && vwt == 5) {  // one float
      if (qend - q < 4) return false;
      if (write && *wrote < spec.size)
        std::memcpy(spec.fout + base + (*wrote)++, q, 4);
      q += 4;
      ++*seen;
    } else if (spec.kind == 0 && vwt == 2) {  // packed floats
      Slice packed;
      if (!read_len_delim(q, qend, &packed) || packed.n % 4) return false;
      const int count = static_cast<int>(packed.n / 4);
      // Wire floats are little-endian IEEE754: the packed payload is the
      // output bytes (memcpy handles the unaligned source).
      if (write && *wrote < spec.size) {
        const int take = count < spec.size - *wrote ? count
                                                    : spec.size - *wrote;
        std::memcpy(spec.fout + base + *wrote, packed.p, take * 4);
        *wrote += take;
      }
      *seen += count;
    } else if ((spec.kind == 1 || spec.kind == 2) && vwt == 0) {
      uint64_t v;
      if (!read_varint(q, qend, &v)) return false;
      if (write && *wrote < spec.size)
        spec.lout[base + (*wrote)++] = static_cast<int64_t>(v);
      ++*seen;
    } else if ((spec.kind == 1 || spec.kind == 2) && vwt == 2) {
      Slice packed;
      if (!read_len_delim(q, qend, &packed)) return false;
      const uint8_t* r = packed.p;
      const uint8_t* rend = packed.p + packed.n;
      while (r < rend) {
        uint64_t v;
        if (!read_varint(r, rend, &v)) return false;
        if (write && *wrote < spec.size)
          spec.lout[base + (*wrote)++] = static_cast<int64_t>(v);
        ++*seen;
      }
    } else if ((spec.kind == 3 || spec.kind == 4) && vwt == 2) {
      Slice s;
      if (!read_len_delim(q, qend, &s)) return false;
      if (write && *wrote < spec.size)
        spec.iout[base + (*wrote)++] =
            spec.kind == 3
                ? static_cast<int32_t>(fnv1a(s.p, s.n) %
                                       static_cast<uint64_t>(spec.buckets))
                : vocab_lookup(static_cast<const Vocab*>(spec.vocab), s.p,
                               s.n);
      ++*seen;
    } else if (!skip_field(q, qend, vtag)) {
      return false;
    }
  }
  return true;
}

// Counts (and checks) the values of one list message of `field`'s type.
bool count_list(const Slice& list, uint32_t field, int64_t* n) {
  const uint8_t* q = list.p;
  const uint8_t* qend = list.p + list.n;
  while (q < qend) {
    uint64_t vtag;
    if (!read_tag(q, qend, &vtag)) return false;
    const uint32_t vwt = vtag & 7;
    const uint8_t* at = q;
    if (!skip_field(q, qend, vtag)) return false;
    if ((vtag >> 3) != 1) continue;
    if (field == 1 && vwt == 2) {
      ++*n;
    } else if (field == 2 && vwt == 5) {
      ++*n;
    } else if (field == 2 && vwt == 2) {
      Slice packed{at, 0};
      read_len_delim(at, qend, &packed);
      if (packed.n % 4) return false;
      *n += static_cast<int64_t>(packed.n / 4);
    } else if (field == 3 && vwt == 0) {
      ++*n;
    } else if (field == 3 && vwt == 2) {
      Slice packed{at, 0};
      read_len_delim(at, qend, &packed);
      const uint8_t* r = packed.p;
      const uint8_t* rend = packed.p + packed.n;
      uint64_t v;
      while (r < rend) {
        if (!read_varint(r, rend, &v)) return false;
        ++*n;
      }
    }
  }
  return true;
}

// The Feature's oneof: the list field that came last, and where the run of
// its occurrences begins (an occurrence of another kind clears the earlier
// ones; occurrences of one kind merge).
bool final_run(const Slice& feat, uint32_t* kind, const uint8_t** run) {
  const uint8_t* p = feat.p;
  const uint8_t* end = feat.p + feat.n;
  *kind = 0;
  *run = end;
  while (p < end) {
    const uint8_t* at = p;
    uint64_t tag;
    if (!read_tag(p, end, &tag)) return false;
    const uint32_t field = static_cast<uint32_t>(tag >> 3);
    if (!skip_field(p, end, tag)) return false;
    if ((tag & 7) == 2 && field >= 1 && field <= 3 && field != *kind) {
      *kind = field;
      *run = at;
    }
  }
  return true;
}

// Decodes one Feature for `spec` into `row` (count only when negative).
// *count: the values of the spec's list type, or -1 when the Feature holds
// values of another type only.
bool decode_feature(const Slice& feat, const FeatureSpec& spec, int64_t row,
                    int32_t* count) {
  uint32_t kind;
  const uint8_t* p;
  if (!final_run(feat, &kind, &p)) return false;
  const uint8_t* end = feat.p + feat.n;
  const uint32_t want = list_field(spec.kind);
  int wrote = 0, seen = 0;
  int64_t other = 0;
  while (p < end) {
    uint64_t tag = 0;
    read_tag(p, end, &tag);  // checked by final_run
    if ((tag & 7) != 2 || (tag >> 3) != kind) {
      skip_field(p, end, tag);
      continue;
    }
    Slice list{p, 0};
    read_len_delim(p, end, &list);
    if (!(kind == want ? decode_list(list, spec, row, &wrote, &seen)
                       : count_list(list, kind, &other)))
      return false;
  }
  *count = (kind != want && other > 0) ? -1 : seen;
  return true;
}

// Folds one past-list_size document's count into the record's overflow:
// a wrong count or type wins over a missing value, which wins over fine.
inline void note_overflow(const FeatureSpec& spec, size_t record,
                          int32_t count) {
  if (!spec.overflow || count == spec.size) return;
  int32_t& o = spec.overflow[record];
  if (o == spec.size || (o == 0 && count != 0)) o = count;
}

// Reads a map entry (key = 1, value = 2). An absent key is the empty
// string and an absent value an empty message; value occurrences merge, as
// their concatenation parses (`merged` holds them when there are several).
bool read_entry(const Slice& entry, Slice* key, Slice* value,
                std::string* merged) {
  const uint8_t* q = entry.p;
  const uint8_t* qend = entry.p + entry.n;
  *key = {entry.p, 0};
  *value = {entry.p, 0};
  int n_values = 0;
  while (q < qend) {
    uint64_t tag;
    if (!read_tag(q, qend, &tag)) return false;
    if ((tag >> 3) == 1 && (tag & 7) == 2) {
      if (!read_len_delim(q, qend, key)) return false;
    } else if ((tag >> 3) == 2 && (tag & 7) == 2) {
      Slice v;
      if (!read_len_delim(q, qend, &v)) return false;
      if (n_values++ == 0) {
        *value = v;
      } else {
        if (n_values == 2)
          merged->assign(reinterpret_cast<const char*>(value->p), value->n);
        merged->append(reinterpret_cast<const char*>(v.p), v.n);
      }
    } else if (!skip_field(q, qend, tag)) {
      return false;
    }
  }
  if (n_values > 1)
    *value = {reinterpret_cast<const uint8_t*>(merged->data()),
              merged->size()};
  return true;
}

// Walks a Features message's map entries and decodes each one a spec
// names into `row`, or with `counts` non-null only counts into
// counts[spec]. A key that occurs again replaces its earlier value (the
// row is filled anew: `seen_mask` marks the specs already decoded for this
// row, specs past bit 63 always refill); an entry without a value is an
// empty Feature; value occurrences merge, as their concatenation parses.
bool decode_features(const Slice& features, const std::vector<SpecView>& specs,
                     int64_t row, uint64_t* seen_mask, int32_t* counts) {
  const int n_specs = static_cast<int>(specs.size());
  const uint8_t* p = features.p;
  const uint8_t* end = features.p + features.n;
  while (p < end) {
    uint64_t tag;
    if (!read_tag(p, end, &tag)) return false;
    if ((tag >> 3) != 1 || (tag & 7) != 2) {
      if (!skip_field(p, end, tag)) return false;
      continue;
    }
    Slice entry;
    if (!read_len_delim(p, end, &entry)) return false;
    Slice key, value;
    std::string merged;
    if (!read_entry(entry, &key, &value, &merged)) return false;
    for (int s = 0; s < n_specs; ++s) {
      const FeatureSpec& spec = *specs[s].spec;
      if (specs[s].name_len != key.n ||
          std::memcmp(spec.name, key.p, key.n) != 0)
        continue;
      int32_t count;
      if (counts) {
        if (!decode_feature(value, spec, -1, &count)) return false;
        counts[s] = count;
        break;
      }
      bool refill = true;
      if (s < 64) {
        const uint64_t bit = uint64_t{1} << s;
        refill = (*seen_mask & bit) != 0;
        *seen_mask |= bit;
      }
      if (refill) fill_row(spec, static_cast<size_t>(row));
      if (!decode_feature(value, spec, row, &count)) return false;
      if (spec.present) spec.present[row] = count;
      break;
    }
  }
  return true;
}

// Decodes each occurrence of Example.features (field 1) in order: they
// merge, key by key.
bool decode_example(const Slice& example, const std::vector<SpecView>& specs,
                    int64_t row, uint64_t* seen_mask, int32_t* counts) {
  const uint8_t* p = example.p;
  const uint8_t* end = example.p + example.n;
  while (p < end) {
    uint64_t tag;
    if (!read_tag(p, end, &tag)) return false;
    if ((tag >> 3) == 1 && (tag & 7) == 2) {
      Slice features;
      if (!read_len_delim(p, end, &features) ||
          !decode_features(features, specs, row, seen_mask, counts))
        return false;
    } else if (!skip_field(p, end, tag)) {
      return false;
    }
  }
  return true;
}

// One document of record `record`: decoded into its row when it is within
// list_size, else only checked (its counts go to the overflow).
bool decode_document(const Slice& doc, const std::vector<SpecView>& specs,
                     size_t record, int list_size, int index,
                     std::vector<int32_t>* counts) {
  if (index < list_size) {
    uint64_t mask = 0;
    return decode_example(
        doc, specs, static_cast<int64_t>(record) * list_size + index, &mask,
        nullptr);
  }
  counts->assign(specs.size(), 0);
  if (!decode_example(doc, specs, -1, nullptr, counts->data())) return false;
  for (size_t s = 0; s < specs.size(); ++s)
    note_overflow(*specs[s].spec, record, (*counts)[s]);
  return true;
}

void prefill(FeatureSpec* specs, int n_specs, size_t rows, size_t records) {
  for (int s = 0; s < n_specs; ++s) {
    FeatureSpec& sp = specs[s];
    for (size_t r = 0; r < rows; ++r) fill_row(sp, r);
    if (sp.present)
      for (size_t i = 0; i < rows; ++i) sp.present[i] = 0;
    if (sp.overflow)
      for (size_t i = 0; i < records; ++i) sp.overflow[i] = sp.size;
  }
}

// The value of the last map entry whose key is `name`, in every Features
// (or FeatureLists) occurrence of field `field` of `msg`: the map replaces
// a key's value, and value occurrences merge (`store` holds a merge).
bool last_entry(const Slice& msg, uint32_t field, const char* name,
                size_t name_len, Slice* out, bool* found, std::string* store) {
  const uint8_t* p = msg.p;
  const uint8_t* end = msg.p + msg.n;
  while (p < end) {
    uint64_t tag;
    if (!read_tag(p, end, &tag)) return false;
    if ((tag >> 3) != field || (tag & 7) != 2) {
      if (!skip_field(p, end, tag)) return false;
      continue;
    }
    Slice map;
    if (!read_len_delim(p, end, &map)) return false;
    const uint8_t* q = map.p;
    const uint8_t* qend = map.p + map.n;
    while (q < qend) {
      uint64_t mtag;
      if (!read_tag(q, qend, &mtag)) return false;
      if ((mtag >> 3) != 1 || (mtag & 7) != 2) {
        if (!skip_field(q, qend, mtag)) return false;
        continue;
      }
      Slice entry;
      if (!read_len_delim(q, qend, &entry)) return false;
      Slice key, value;
      std::string merged;
      if (!read_entry(entry, &key, &value, &merged)) return false;
      if (key.n != name_len || std::memcmp(key.p, name, name_len) != 0)
        continue;
      *found = true;
      if (value.p == reinterpret_cast<const uint8_t*>(merged.data())) {
        *store = std::move(merged);
        value = {reinterpret_cast<const uint8_t*>(store->data()),
                 store->size()};
      }
      *out = value;
    }
  }
  return true;
}

// Calls fn(value) for each value of a Feature's bytes_list (its final
// oneof run); a Feature of another kind has none. False on malformed input
// or when fn returns false.
template <typename Fn>
bool for_each_bytes(const Slice& feat, Fn&& fn) {
  uint32_t kind;
  const uint8_t* p;
  if (!final_run(feat, &kind, &p)) return false;
  if (kind != 1) return true;
  const uint8_t* end = feat.p + feat.n;
  while (p < end) {
    uint64_t tag = 0;
    read_tag(p, end, &tag);
    if ((tag & 7) != 2 || (tag >> 3) != 1) {
      skip_field(p, end, tag);
      continue;
    }
    Slice list{p, 0};
    read_len_delim(p, end, &list);
    const uint8_t* q = list.p;
    const uint8_t* qend = list.p + list.n;
    while (q < qend) {
      uint64_t vtag;
      if (!read_tag(q, qend, &vtag)) return false;
      if ((vtag >> 3) == 1 && (vtag & 7) == 2) {
        Slice s;
        if (!read_len_delim(q, qend, &s) || !fn(s)) return false;
      } else if (!skip_field(q, qend, vtag)) {
        return false;
      }
    }
  }
  return true;
}

}  // namespace

extern "C" {

// Decodes n serialized ELWC records. Context outputs are [n, size]; example
// outputs are [n, list_size, size] (row-major). sizes_out[i] = real
// documents in list i, clipped to list_size. Returns -1 on a malformed
// record.
int rt_decode_elwc_batch(const uint8_t** recs, const int64_t* lens, int n,
                         int list_size, FeatureSpec* ctx_specs, int n_ctx,
                         FeatureSpec* ex_specs, int n_ex,
                         int32_t* sizes_out) {
  prefill(ctx_specs, n_ctx, static_cast<size_t>(n), 0);
  prefill(ex_specs, n_ex, static_cast<size_t>(n) * list_size,
          static_cast<size_t>(n));
  const auto ctx_views = make_views(ctx_specs, n_ctx);
  const auto ex_views = make_views(ex_specs, n_ex);
  std::vector<int32_t> counts;
  for (int i = 0; i < n; ++i) {
    const uint8_t* p = recs[i];
    const uint8_t* end = recs[i] + lens[i];
    int doc = 0;
    uint64_t ctx_mask = 0;  // context occurrences merge
    while (p < end) {
      uint64_t tag;
      if (!read_tag(p, end, &tag)) return -1;
      const uint32_t field = static_cast<uint32_t>(tag >> 3);
      if ((tag & 7) != 2 || (field != 1 && field != 2)) {
        if (!skip_field(p, end, tag)) return -1;
        continue;
      }
      Slice msg;
      if (!read_len_delim(p, end, &msg)) return -1;
      if (field == 1) {  // one document Example
        if (!decode_document(msg, ex_views, i, list_size, doc++, &counts))
          return -1;
      } else if (!decode_example(msg, ctx_views, i, &ctx_mask, nullptr)) {
        return -1;
      }
    }
    sizes_out[i] = doc < list_size ? doc : list_size;
  }
  return 0;
}

// Decodes n serialized plain tf.Example records pointwise: each record is
// one document (list_size rows padded), its context features read from the
// same record (python/data.py:1348-1395).
int rt_decode_example_batch(const uint8_t** recs, const int64_t* lens,
                            int n, int list_size, FeatureSpec* ctx_specs,
                            int n_ctx, FeatureSpec* ex_specs, int n_ex,
                            int32_t* sizes_out) {
  prefill(ctx_specs, n_ctx, static_cast<size_t>(n), 0);
  prefill(ex_specs, n_ex, static_cast<size_t>(n) * list_size,
          static_cast<size_t>(n));
  const auto ctx_views = make_views(ctx_specs, n_ctx);
  const auto ex_views = make_views(ex_specs, n_ex);
  for (int i = 0; i < n; ++i) {
    Slice rec{recs[i], static_cast<size_t>(lens[i])};
    uint64_t ctx_mask = 0, ex_mask = 0;
    if (!decode_example(rec, ctx_views, i, &ctx_mask, nullptr) ||
        !decode_example(rec, ex_views, static_cast<int64_t>(i) * list_size,
                        &ex_mask, nullptr))
      return -1;
    sizes_out[i] = 1;
  }
  return 0;
}

// Decodes n serialized ExampleInExample records: an outer tf.Example
// holding 'serialized_context' (bytes; its first value is the context) and
// 'serialized_examples' (repeated bytes) (python/data.py:133-208). Same
// output contract as rt_decode_elwc_batch.
int rt_decode_eie_batch(const uint8_t** recs, const int64_t* lens, int n,
                        int list_size, FeatureSpec* ctx_specs, int n_ctx,
                        FeatureSpec* ex_specs, int n_ex,
                        int32_t* sizes_out) {
  prefill(ctx_specs, n_ctx, static_cast<size_t>(n), 0);
  prefill(ex_specs, n_ex, static_cast<size_t>(n) * list_size,
          static_cast<size_t>(n));
  static const char kCtx[] = "serialized_context";
  static const char kExs[] = "serialized_examples";
  const auto ctx_views = make_views(ctx_specs, n_ctx);
  const auto ex_views = make_views(ex_specs, n_ex);
  std::vector<int32_t> counts;
  for (int i = 0; i < n; ++i) {
    const Slice rec{recs[i], static_cast<size_t>(lens[i])};
    // The outer Example's Features occurrences (field 1) merge: the last
    // entry of each carrier key across all of them.
    Slice ctx{rec.p, 0}, exs{rec.p, 0};
    bool has_ctx = false, has_exs = false;
    std::string ctx_store, exs_store;
    if (!last_entry(rec, 1, kCtx, sizeof(kCtx) - 1, &ctx, &has_ctx,
                    &ctx_store) ||
        !last_entry(rec, 1, kExs, sizeof(kExs) - 1, &exs, &has_exs,
                    &exs_store))
      return -1;
    bool first = true;
    uint64_t ctx_mask = 0;
    if (has_ctx && !for_each_bytes(ctx, [&](const Slice& s) {
          if (!first) return true;
          first = false;
          return decode_example(s, ctx_views, i, &ctx_mask, nullptr);
        }))
      return -1;
    int doc = 0;
    if (has_exs && !for_each_bytes(exs, [&](const Slice& s) {
          return decode_document(s, ex_views, i, list_size, doc++, &counts);
        }))
      return -1;
    sizes_out[i] = doc < list_size ? doc : list_size;
  }
  return 0;
}

// Decodes n serialized SequenceExample records (context Features and
// per-document FeatureLists). A spec's FeatureList is the last entry of
// its key; a list has as many documents as the longest FeatureList a spec
// names, and a spec's frames past its own list are padding, which the
// plain parser does not check (present = size). Same output contract as
// rt_decode_elwc_batch.
int rt_decode_seq_batch(const uint8_t** recs, const int64_t* lens, int n,
                        int list_size, FeatureSpec* ctx_specs, int n_ctx,
                        FeatureSpec* ex_specs, int n_ex,
                        int32_t* sizes_out) {
  prefill(ctx_specs, n_ctx, static_cast<size_t>(n), 0);
  prefill(ex_specs, n_ex, static_cast<size_t>(n) * list_size,
          static_cast<size_t>(n));
  const auto ctx_views = make_views(ctx_specs, n_ctx);
  std::vector<Slice> lists(n_ex);
  std::vector<std::string> stores(n_ex);
  std::vector<int> frames(n_ex);
  for (int i = 0; i < n; ++i) {
    const Slice rec{recs[i], static_cast<size_t>(lens[i])};
    const uint8_t* p = rec.p;
    const uint8_t* end = rec.p + rec.n;
    uint64_t ctx_mask = 0;
    while (p < end) {
      uint64_t tag;
      if (!read_tag(p, end, &tag)) return -1;
      if ((tag >> 3) == 1 && (tag & 7) == 2) {  // context Features
        Slice msg;
        if (!read_len_delim(p, end, &msg) ||
            !decode_features(msg, ctx_views, i, &ctx_mask, nullptr))
          return -1;
      } else if (!skip_field(p, end, tag)) {
        return -1;
      }
    }
    int n_frames = 0;
    for (int s = 0; s < n_ex; ++s) {
      bool found = false;
      if (!last_entry(rec, 2, ex_specs[s].name, std::strlen(ex_specs[s].name),
                      &lists[s], &found, &stores[s]))
        return -1;
      frames[s] = 0;
      if (!found) continue;
      const uint8_t* q = lists[s].p;
      const uint8_t* qend = lists[s].p + lists[s].n;
      while (q < qend) {
        uint64_t ftag;
        if (!read_tag(q, qend, &ftag)) return -1;
        if ((ftag >> 3) == 1 && (ftag & 7) == 2) ++frames[s];
        if (!skip_field(q, qend, ftag)) return -1;
      }
      if (frames[s] > n_frames) n_frames = frames[s];
    }
    const int kept = n_frames < list_size ? n_frames : list_size;
    for (int s = 0; s < n_ex; ++s) {
      const FeatureSpec& spec = ex_specs[s];
      const int64_t base = static_cast<int64_t>(i) * list_size;
      int frame = 0;
      const uint8_t* q = lists[s].p;
      const uint8_t* qend = frames[s] ? lists[s].p + lists[s].n : q;
      while (q < qend) {
        uint64_t ftag = 0;
        read_tag(q, qend, &ftag);
        if ((ftag >> 3) != 1 || (ftag & 7) != 2) {
          skip_field(q, qend, ftag);
          continue;
        }
        Slice feat{q, 0};
        read_len_delim(q, qend, &feat);
        int32_t count;
        if (frame < list_size) {
          if (!decode_feature(feat, spec, base + frame, &count)) return -1;
          if (spec.present) spec.present[base + frame] = count;
        } else {
          if (!decode_feature(feat, spec, -1, &count)) return -1;
          note_overflow(spec, i, count);
        }
        ++frame;
      }
      if (spec.present)
        for (int f = frames[s]; f < kept; ++f)
          spec.present[base + f] = spec.size;
    }
    sizes_out[i] = kept;
  }
  return 0;
}

// Scans TFRecord framing: fills offsets/lengths for up to max_records
// payloads and returns the count, or -1 when the data does not end at a
// record boundary (a truncated or corrupt file). No checksum verification
// on the hot path.
int64_t rt_scan_tfrecord(const uint8_t* data, int64_t size, int64_t* offsets,
                         int64_t* lengths, int64_t max_records) {
  int64_t pos = 0, count = 0;
  while (pos + 12 <= size && count < max_records) {
    uint64_t len;
    std::memcpy(&len, data + pos, 8);
    pos += 12;  // length + length crc
    // Unsigned bound check first: a corrupt high-bit length must stop the
    // scan, not wrap negative through the signed arithmetic below.
    if (size - pos < 4 || len > static_cast<uint64_t>(size - pos - 4))
      return -1;
    offsets[count] = pos;
    lengths[count] = static_cast<int64_t>(len);
    ++count;
    pos += static_cast<int64_t>(len) + 4;  // payload + payload crc
  }
  return pos == size || count == max_records ? count : -1;
}

// Builds a vocabulary lookup table for kind-4 specs. `tokens`/`lens` give
// n token byte strings (lengths explicit: tokens may contain NULs); ids
// are index + num_oov, the last occurrence of a duplicate wins (as
// parsers.Vocabulary's dict does). Immutable after creation and safe to
// share across decode threads.
void* rt_vocab_create(const char** tokens, const int64_t* lens, int64_t n,
                      int64_t num_oov) {
  auto* v = new Vocab();
  v->num_oov = num_oov > 0 ? num_oov : 1;
  size_t total = 0;
  for (int64_t i = 0; i < n; ++i) total += static_cast<size_t>(lens[i]);
  v->arena.reserve(total);
  v->entries.reserve(static_cast<size_t>(n));
  size_t cap = 16;
  while (cap < static_cast<size_t>(n) * 2 + 1) cap *= 2;
  v->slots.assign(cap, 0);
  v->mask = cap - 1;
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* p = reinterpret_cast<const uint8_t*>(tokens[i]);
    const size_t len = static_cast<size_t>(lens[i]);
    const uint64_t h = fnv1a(p, len);
    const int32_t id = static_cast<int32_t>(i + v->num_oov);
    size_t slot = static_cast<size_t>(h & v->mask);
    for (;;) {
      int32_t e = v->slots[slot];
      if (e == 0) {
        v->entries.push_back({h, static_cast<uint32_t>(v->arena.size()),
                              static_cast<uint32_t>(len), id});
        v->arena.append(tokens[i], len);
        v->slots[slot] = static_cast<int32_t>(v->entries.size());
        break;
      }
      VocabEntry& ent = v->entries[e - 1];
      if (ent.hash == h && ent.len == len &&
          std::memcmp(v->arena.data() + ent.off, p, len) == 0) {
        ent.id = id;  // duplicate token: last occurrence wins
        break;
      }
      slot = (slot + 1) & v->mask;
    }
  }
  return v;
}

void rt_vocab_free(void* handle) {
  delete static_cast<Vocab*>(handle);
}

// Counts the top-level ELWC `examples` entries (field 1, length-delimited)
// of each record without decoding any feature: the probe behind
// Predictor.predict(list_size=None)'s bucket. -1 on a malformed record.
int rt_elwc_sizes(const uint8_t** recs, const int64_t* lens, int n,
                  int32_t* sizes_out) {
  for (int i = 0; i < n; ++i) {
    const uint8_t* p = recs[i];
    const uint8_t* end = recs[i] + lens[i];
    int32_t count = 0;
    while (p < end) {
      uint64_t tag;
      if (!read_tag(p, end, &tag)) return -1;
      if ((tag >> 3) == 1 && (tag & 7) == 2) ++count;
      if (!skip_field(p, end, tag)) return -1;
    }
    sizes_out[i] = count;
  }
  return 0;
}

}  // extern "C"
