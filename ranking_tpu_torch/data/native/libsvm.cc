// LIBSVM ranking parser: text rows -> padded listwise arrays.
//
// The port's copy of the LIBSVM part of ranking_tpu/data/native/decoder.cc
// (rt_libsvm_parse, _num_queries, _num_bad, _fill, _qid, _free), with the
// semantics of the reference's host loader
// (examples/tf_ranking_libsvm.py:137-195). Exposed through a C ABI that
// ranking_tpu_torch/data/native/__init__.py binds with ctypes.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libranking_libsvm.so libsvm.cc

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <utility>
#include <vector>

// --- LIBSVM ranking parser -------------------------------------------------
//
// Handle-based API: rt_libsvm_parse() does one pass over the text buffer
// grouping rows by qid (first-seen order, like the reference's host loop at
// examples/tf_ranking_libsvm.py:137-195); rt_libsvm_fill() writes padded
// [Q, list_size, F] / [Q, list_size] arrays; rt_libsvm_free() releases.

namespace {

struct LibsvmRow {
  float label;
  std::vector<std::pair<int32_t, float>> feats;
};

struct LibsvmData {
  std::vector<std::vector<LibsvmRow>> queries;  // first-seen qid order
  std::vector<std::string> qids;
  int64_t n_bad = 0;  // rows missing qid / with malformed feature tokens
};

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

}  // namespace

extern "C" {

void* rt_libsvm_parse(const char* buf, int64_t len) {
  auto* data = new LibsvmData();
  std::unordered_map<std::string, size_t> qid_index;
  const char* p = buf;
  const char* end = buf + len;
  std::string qid;
  while (p < end) {
    const char* line_end = p;
    while (line_end < end && *line_end != '\n') ++line_end;
    const char* q = skip_ws(p, line_end);
    // Strip comments.
    const char* hash = q;
    while (hash < line_end && *hash != '#') ++hash;
    const char* lend = hash;
    if (q < lend) {
      LibsvmRow row;
      char* next = nullptr;
      row.label = std::strtof(q, &next);
      q = next;
      qid.clear();
      bool ok = true;
      while (true) {
        q = skip_ws(q, lend);
        if (q >= lend) break;
        const char* colon = q;
        while (colon < lend && *colon != ':' && *colon != ' ') ++colon;
        if (colon >= lend || *colon != ':') break;
        if (colon - q == 3 && std::memcmp(q, "qid", 3) == 0) {
          const char* v = colon + 1;
          const char* vend = v;
          while (vend < lend && *vend != ' ' && *vend != '\t') ++vend;
          qid.assign(v, vend - v);
          q = vend;
        } else {
          int32_t idx = static_cast<int32_t>(std::strtol(q, &next, 10));
          if (next != colon) { ok = false; break; }
          float val = std::strtof(colon + 1, &next);
          row.feats.emplace_back(idx, val);
          q = next;
        }
      }
      if (ok && !qid.empty()) {
        auto it = qid_index.find(qid);
        size_t qi;
        if (it == qid_index.end()) {
          qi = data->queries.size();
          qid_index.emplace(qid, qi);
          data->queries.emplace_back();
          data->qids.push_back(qid);
        } else {
          qi = it->second;
        }
        data->queries[qi].push_back(std::move(row));
      } else {
        // Counted, not dropped silently: the Python loader raises for
        // these rows, and the fast path must not be laxer (the binding
        // raises when n_bad > 0).
        ++data->n_bad;
      }
    }
    p = line_end + 1;
  }
  return data;
}

int64_t rt_libsvm_num_queries(void* handle) {
  return static_cast<LibsvmData*>(handle)->queries.size();
}

int64_t rt_libsvm_num_bad(void* handle) {
  return static_cast<LibsvmData*>(handle)->n_bad;
}

// Fills features [Q, list_size, num_features] (zero default) and labels
// [Q, list_size] (padding_label default). 1-based feature indices.
void rt_libsvm_fill(void* handle, int list_size, int num_features,
                    float padding_label, float* features, float* labels) {
  auto* data = static_cast<LibsvmData*>(handle);
  const size_t nq = data->queries.size();
  const size_t lf = static_cast<size_t>(list_size) * num_features;
  for (size_t i = 0; i < nq * lf; ++i) features[i] = 0.0f;
  for (size_t i = 0; i < nq * list_size; ++i) labels[i] = padding_label;
  for (size_t qi = 0; qi < nq; ++qi) {
    const auto& rows = data->queries[qi];
    const size_t n = rows.size() < static_cast<size_t>(list_size)
                         ? rows.size() : static_cast<size_t>(list_size);
    for (size_t di = 0; di < n; ++di) {
      labels[qi * list_size + di] = rows[di].label;
      float* frow = features + qi * lf + di * num_features;
      for (const auto& kv : rows[di].feats) {
        if (kv.first >= 1 && kv.first <= num_features)
          frow[kv.first - 1] = kv.second;
      }
    }
  }
}

// Copies qid string i into buf (NUL-terminated, truncated to buflen).
int rt_libsvm_qid(void* handle, int64_t i, char* buf, int buflen) {
  auto* data = static_cast<LibsvmData*>(handle);
  if (i < 0 || i >= static_cast<int64_t>(data->qids.size()) || buflen < 1)
    return -1;
  const std::string& q = data->qids[i];
  int n = static_cast<int>(q.size()) < buflen - 1
              ? static_cast<int>(q.size()) : buflen - 1;
  std::memcpy(buf, q.data(), n);
  buf[n] = '\0';
  return n;
}

void rt_libsvm_free(void* handle) {
  delete static_cast<LibsvmData*>(handle);
}

}  // extern "C"
