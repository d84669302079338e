// Native runtime of the PyTorch/CUDA port (spark_scheduler_tpu_torch).
//
// The port's own copy of the JAX package's native/runtime.cpp, built by
// spark_scheduler_tpu_torch/native/__init__.py into the package's _build/
// directory. Host-side components that sit on the request path around the
// device solver (the runtime slots of SURVEY.md §2d):
//
//   ClusterArena  — dense per-slot cluster state (allocatable, zone, flags,
//                   priority ranks) with O(1) upsert/remove and a single-call
//                   snapshot that materializes the ClusterTensors inputs
//                   (available = clip(alloc - usage - overhead),
//                   schedulable = clip(alloc - overhead)) into caller
//                   buffers. Replaces the per-request Python walk over all
//                   nodes (the reference rebuilds string-keyed maps per
//                   request, resources.go:61-100; we rebuild nothing).
//
//   ShardedQueue  — the async write-back queue (store/queue.go:22-144
//                   semantics): per-key dedup via an inflight set, FNV-1a
//                   sharding so one key always lands on the same consumer,
//                   bounded per-shard buffers, blocking/non-blocking add,
//                   blocking pop with timeout. Payloads stay in Python;
//                   the queue moves opaque u64 ticket ids.
//
// Exposed as a C ABI for ctypes. No Python.h dependency so it builds with
// a bare g++ -shared -fPIC.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <unordered_set>
#include <vector>

namespace {

constexpr int kDims = 3;
constexpr int32_t kInt32Inf = 2147483647 / 2;  // models/resources.INT32_INF

inline int32_t clip64(int64_t v) {
  if (v > kInt32Inf) return kInt32Inf;
  if (v < -kInt32Inf) return -kInt32Inf;
  return static_cast<int32_t>(v);
}

// ----------------------------------------------------------- ClusterArena

struct ClusterArena {
  std::mutex mu;
  // Slot-indexed, grown on demand; slot indices are owned by the Python
  // NodeRegistry (stable across churn, recycled+masked like cluster.py).
  std::vector<int64_t> alloc;        // [cap * 3]
  std::vector<int32_t> zone_id;      // [cap]
  std::vector<int32_t> name_rank;    // [cap]
  std::vector<int32_t> lr_driver;    // [cap]
  std::vector<int32_t> lr_executor;  // [cap]
  std::vector<uint8_t> unschedulable;
  std::vector<uint8_t> ready;
  std::vector<uint8_t> valid;
  int64_t capacity = 0;

  void ensure(int64_t idx) {
    if (idx < capacity) return;
    int64_t cap = std::max<int64_t>(8, capacity);
    while (cap <= idx) cap *= 2;
    alloc.resize(cap * kDims, 0);
    zone_id.resize(cap, 0);
    name_rank.resize(cap, kInt32Inf);
    lr_driver.resize(cap, kInt32Inf);
    lr_executor.resize(cap, kInt32Inf);
    unschedulable.resize(cap, 0);
    ready.resize(cap, 0);
    valid.resize(cap, 0);
    capacity = cap;
  }
};

// ----------------------------------------------------------- ShardedQueue

struct Shard {
  std::mutex mu;
  std::condition_variable not_empty;
  std::condition_variable not_full;
  std::deque<uint64_t> tickets;
};

struct ShardedQueue {
  std::vector<Shard> shards;
  size_t buffer_size;
  std::mutex inflight_mu;
  std::unordered_set<std::string> inflight;

  ShardedQueue(size_t buckets, size_t buffer)
      : shards(buckets), buffer_size(buffer) {}
};

uint32_t fnv1a32(const char* data, size_t len) {
  uint32_t h = 2166136261u;
  for (size_t i = 0; i < len; ++i) {
    h ^= static_cast<uint8_t>(data[i]);
    h *= 16777619u;
  }
  return h;
}

// ------------------------------------------------------------ native ingest
//
// The zero-copy serving lane (`server.ingest: native`): an incremental
// HTTP/1.1 request framer over connection-owned buffers plus a predicate
// body decoder that tokenizes the candidate-node-id bulk (the ~200 KB part
// of a 10k-node ExtenderArgs body) straight into a reusable arena slot —
// the Python side never json.loads the body on the hot path; it receives a
// ticket (pod sub-document span + a '\0'-separated name blob with an
// offsets table and an FNV-1a 64 digest) that the batcher and the solver's
// candidate-mask cache consume directly.
//
// Framing strictness mirrors server/transport_async.py exactly (RFC 7230
// 3.3.2): duplicate differing Content-Length and non-1*DIGIT forms are
// unframeable, Transfer-Encoding is rejected, oversize bodies drain in
// place for a 413 that keeps the keep-alive framing alive. Anything the
// fast-path decoder is not SURE about (escapes, duplicate keys, non-string
// entries, invalid UTF-8) returns 0 so the caller falls back to the Python
// parser — correctness is never traded for the fast path, and the miss is
// counted in the zero-copy hit-ratio telemetry.

// Content digest for the candidate-name blob — the ticket's cache key.
// Word-wise (8 bytes per multiply) because the byte-serial FNV-1a it
// replaced ran at ~1 byte/cycle and dominated the whole decode at 10k
// names. Collision quality only affects cache efficiency, never
// correctness: every consumer verifies equality with a blob memcmp.
inline uint64_t mix64(uint64_t x) {
  x ^= x >> 30;
  x *= 0xbf58476d1ce4e5b9ull;
  x ^= x >> 27;
  x *= 0x94d049bb133111ebull;
  x ^= x >> 31;
  return x;
}

uint64_t blob_digest(const char* d, size_t n) {
  uint64_t h = 1469598103934665603ull ^ (n * 0x9e3779b97f4a7c15ull);
  size_t i = 0;
  for (; i + 8 <= n; i += 8) {
    uint64_t w;
    memcpy(&w, d + i, 8);
    h = (h ^ w) * 1099511628211ull;
    h = (h << 27) | (h >> 37);
  }
  uint64_t tail = 0;
  for (size_t j = 0; i < n; ++i, j += 8) {
    tail |= static_cast<uint64_t>(static_cast<uint8_t>(d[i])) << j;
  }
  h = (h ^ tail) * 1099511628211ull;
  return mix64(h);
}

std::atomic<int64_t> g_live_slots{0};

struct PredicateSlot {
  std::vector<char> pod;      // the Pod value's exact JSON bytes ("{}" if absent)
  std::vector<char> blob;     // candidate node names, '\0' after each
  std::vector<int32_t> offs;  // name i starts at offs[i]; offs[count] = blob end
  uint64_t digest = 0;        // FNV-1a 64 over blob (names + separators)
  int64_t decode_ns = 0;

  void reset() {
    pod.clear();
    blob.clear();
    offs.clear();
    digest = 0;
  }
};

bool is_json_ws(char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r';
}

struct Cursor {
  const char* p;
  const char* end;
};

void skip_ws(Cursor& c) {
  while (c.p < c.end && is_json_ws(*c.p)) ++c.p;
}

// c.p at the opening quote; leaves c.p past the closing quote. memchr does
// the scanning (the libc SIMD path), backslash-parity decides whether a
// quote is real.
bool skip_string(Cursor& c) {
  const char* p = c.p + 1;
  while (p < c.end) {
    const char* q =
        static_cast<const char*>(memchr(p, '"', c.end - p));
    if (q == nullptr) break;
    const char* b = q;
    while (b > p && b[-1] == '\\') --b;
    if ((q - b) % 2 == 0) {
      c.p = q + 1;
      return true;
    }
    p = q + 1;
  }
  c.p = c.end;
  return false;
}

bool skip_container(Cursor& c, char open, char close) {
  int depth = 0;
  while (c.p < c.end) {
    char ch = *c.p;
    if (ch == '"') {
      if (!skip_string(c)) return false;
      continue;
    }
    if (ch == open) {
      ++depth;
    } else if (ch == close) {
      --depth;
      if (depth == 0) {
        ++c.p;
        return true;
      }
    }
    ++c.p;
  }
  return false;
}

bool skip_value(Cursor& c) {
  skip_ws(c);
  if (c.p >= c.end) return false;
  char ch = *c.p;
  if (ch == '"') return skip_string(c);
  if (ch == '{') return skip_container(c, '{', '}');
  if (ch == '[') return skip_container(c, '[', ']');
  const char* start = c.p;
  while (c.p < c.end) {
    ch = *c.p;
    if (ch == ',' || ch == '}' || ch == ']' || is_json_ws(ch)) break;
    ++c.p;
  }
  return c.p > start;  // bare literal/number; delimiter checks follow outside
}

// Valid UTF-8 and no raw control characters (< 0x20) — the two conditions
// under which Python's json.loads would have accepted the same name bytes.
// One pass over the final blob ('\0' separators are the one allowed < 0x20).
bool blob_is_clean_utf8(const std::vector<char>& blob) {
  const unsigned char* p =
      reinterpret_cast<const unsigned char*>(blob.data());
  const unsigned char* end = p + blob.size();
  while (p < end) {
    unsigned char c = *p;
    if (c < 0x80) {
      if (c < 0x20 && c != '\0') return false;
      ++p;
      continue;
    }
    int n;
    uint32_t cp;
    if ((c & 0xE0) == 0xC0) {
      n = 1;
      cp = c & 0x1F;
      if (cp < 2) return false;  // overlong 2-byte
    } else if ((c & 0xF0) == 0xE0) {
      n = 2;
      cp = c & 0x0F;
    } else if ((c & 0xF8) == 0xF0) {
      n = 3;
      cp = c & 0x07;
    } else {
      return false;
    }
    if (end - p <= n) return false;
    for (int i = 1; i <= n; ++i) {
      if ((p[i] & 0xC0) != 0x80) return false;
      cp = (cp << 6) | (p[i] & 0x3F);
    }
    if (n == 2 && (cp < 0x800 || (cp >= 0xD800 && cp <= 0xDFFF)))
      return false;
    if (n == 3 && (cp < 0x10000 || cp > 0x10FFFF)) return false;
    p += n + 1;
  }
  return true;
}

// Fast path for the existing JSON predicate schema:
//   {"Pod": {...}, "NodeNames": ["n1", "n2", ...]}
// Returns 1 with the slot filled, or 0 when the body deviates from the
// shape in ANY way the caller's Python parser might read differently
// (escapes, duplicate NodeNames keys, non-string entries, an empty or
// missing NodeNames — Python's `or` chain falls through to "Nodes" there —
// trailing bytes, invalid UTF-8). The caller falls back to json.loads.
int32_t decode_predicate_json_impl(PredicateSlot* s, const char* body,
                                   int64_t len) {
  s->reset();
  // One reservation covers the whole tokenized output (names are a strict
  // subset of the body): growth reallocations would otherwise memmove the
  // ~200 KB blob several times at 10k names.
  s->blob.reserve(static_cast<size_t>(len));
  s->offs.reserve(static_cast<size_t>(len / 16) + 8);
  Cursor c{body, body + len};
  skip_ws(c);
  if (c.p >= c.end || *c.p != '{') return 0;
  ++c.p;
  const char* pod_b = nullptr;
  const char* pod_e = nullptr;
  const char* podl_b = nullptr;
  const char* podl_e = nullptr;
  bool saw_names = false;
  skip_ws(c);
  if (c.p < c.end && *c.p == '}') {
    ++c.p;
  } else {
    while (true) {
      skip_ws(c);
      if (c.p >= c.end || *c.p != '"') return 0;
      const char* kb = c.p + 1;
      if (!skip_string(c)) return 0;
      const char* ke = c.p - 1;
      skip_ws(c);
      if (c.p >= c.end || *c.p != ':') return 0;
      ++c.p;
      skip_ws(c);
      size_t klen = static_cast<size_t>(ke - kb);
      // A key containing an escape could DECODE to "Pod"/"NodeNames"
      // (e.g. "\u0050od") while comparing unequal on raw bytes here —
      // only the Python parser may interpret it.
      if (memchr(kb, '\\', klen) != nullptr) return 0;
      bool is_pod = (klen == 3 && memcmp(kb, "Pod", 3) == 0);
      bool is_podl = (klen == 3 && memcmp(kb, "pod", 3) == 0);
      bool is_names = (klen == 9 && memcmp(kb, "NodeNames", 9) == 0);
      if (is_names) {
        if (saw_names) return 0;  // duplicate key: json.loads keeps the last
        saw_names = true;
        if (c.p >= c.end || *c.p != '[') return 0;  // null/other type
        ++c.p;
        skip_ws(c);
        if (c.p < c.end && *c.p == ']') {
          ++c.p;
        } else {
          while (true) {
            // Names are short (10-40 bytes): a fused byte loop beats two
            // memchr calls per name — the compiler vectorizes the triple
            // compare, and escapes/quotes resolve in the same pass.
            if (c.p >= c.end) return 0;
            char ch = *c.p;
            while (ch == ' ' || ch == '\t' || ch == '\n' || ch == '\r') {
              if (++c.p >= c.end) return 0;
              ch = *c.p;
            }
            if (ch != '"') return 0;
            ++c.p;
            const char* nb = c.p;
            const char* e = c.end;
            while (c.p < e) {
              ch = *c.p;
              // Stop on the closing quote, an escape, or anything outside
              // printable ASCII: valid k8s node names are RFC 1123 DNS
              // labels, so a control byte / UTF-8 name is a legitimate
              // fast-path miss (the Python parser decides what it means).
              if (static_cast<unsigned char>(ch) - 0x20u >= 0x5Fu ||
                  ch == '"' || ch == '\\')
                break;
              ++c.p;
            }
            if (c.p >= e || ch != '"') return 0;  // EOF/escape/non-ASCII
            s->offs.push_back(static_cast<int32_t>(s->blob.size()));
            s->blob.insert(s->blob.end(), nb, c.p);
            s->blob.push_back('\0');
            ++c.p;
            if (c.p >= e) return 0;
            ch = *c.p;
            while (ch == ' ' || ch == '\t' || ch == '\n' || ch == '\r') {
              if (++c.p >= e) return 0;
              ch = *c.p;
            }
            if (ch == ',') {
              ++c.p;
              continue;
            }
            if (ch == ']') {
              ++c.p;
              break;
            }
            return 0;
          }
        }
      } else if (is_pod || is_podl) {
        if (c.p < c.end && *c.p == '{') {
          const char* vb = c.p;
          if (!skip_container(c, '{', '}')) return 0;
          if (is_pod) {
            pod_b = vb;
            pod_e = c.p;
          } else {
            podl_b = vb;
            podl_e = c.p;
          }
        } else {
          // Only a JSON null reads as "absent" the way Python's
          // `raw.get(...) or ...` chain does; any other type falls back.
          const char* vb = c.p;
          if (!skip_value(c)) return 0;
          if (c.p - vb != 4 || memcmp(vb, "null", 4) != 0) return 0;
        }
      } else {
        if (!skip_value(c)) return 0;
      }
      skip_ws(c);
      if (c.p >= c.end) return 0;
      if (*c.p == ',') {
        ++c.p;
        continue;
      }
      if (*c.p == '}') {
        ++c.p;
        break;
      }
      return 0;
    }
  }
  skip_ws(c);
  if (c.p != c.end) return 0;  // trailing bytes: json.loads would raise
  // Empty/missing NodeNames: Python's `or` chain falls through to "Nodes".
  if (!saw_names || s->offs.empty()) return 0;
  auto nonempty_obj = [](const char* b, const char* e) {
    Cursor t{b + 1, e};
    skip_ws(t);
    return t.p < t.end && *t.p != '}';
  };
  // `raw.get("Pod") or raw.get("pod") or {}`: an empty {} is falsy too.
  const char* ub = nullptr;
  const char* ue = nullptr;
  if (pod_b != nullptr && nonempty_obj(pod_b, pod_e)) {
    ub = pod_b;
    ue = pod_e;
  } else if (podl_b != nullptr && nonempty_obj(podl_b, podl_e)) {
    ub = podl_b;
    ue = podl_e;
  } else if (pod_b != nullptr) {
    ub = pod_b;
    ue = pod_e;
  } else if (podl_b != nullptr) {
    ub = podl_b;
    ue = podl_e;
  }
  if (ub != nullptr) {
    s->pod.assign(ub, ue);
  } else {
    s->pod = {'{', '}'};
  }
  s->offs.push_back(static_cast<int32_t>(s->blob.size()));
  s->digest = blob_digest(s->blob.data(), s->blob.size());
  return 1;
}

inline uint32_t read_u32le(const unsigned char* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

// Compact binary predicate protocol (content type
// application/x-spark-predicate), length-prefixed frames:
//   "SPRD" | version u8 (=1) | pod_json_len u32le | pod JSON bytes
//   | names_count u32le | names_count x (len u16le | name bytes)
// Exact-length bodies only. Returns 1/0 like the JSON fast path; a 0 sends
// the caller to the pure-Python decoder, which raises the protocol error.
int32_t decode_predicate_binary_impl(PredicateSlot* s, const char* body,
                                     int64_t len) {
  s->reset();
  const unsigned char* p = reinterpret_cast<const unsigned char*>(body);
  const unsigned char* end = p + len;
  if (end - p < 13) return 0;
  if (memcmp(p, "SPRD", 4) != 0 || p[4] != 1) return 0;
  uint32_t pod_len = read_u32le(p + 5);
  p += 9;
  if (static_cast<uint64_t>(end - p) < pod_len + 4ull) return 0;
  s->pod.assign(p, p + pod_len);
  p += pod_len;
  uint32_t count = read_u32le(p);
  p += 4;
  // The count is attacker-controlled: clamp the reservation by what the
  // remaining body could possibly hold (>= 2 bytes per name frame) BEFORE
  // trusting it — an oversized reserve would throw bad_alloc across the C
  // ABI and terminate the process on a 13-byte request.
  if (static_cast<uint64_t>(count) > static_cast<uint64_t>(end - p) / 2)
    return 0;
  s->offs.reserve(count + 1);
  s->blob.reserve(static_cast<size_t>(end - p) + count);
  for (uint32_t i = 0; i < count; ++i) {
    if (end - p < 2) return 0;
    uint32_t n = static_cast<uint32_t>(p[0]) |
                 (static_cast<uint32_t>(p[1]) << 8);
    p += 2;
    if (static_cast<uint64_t>(end - p) < n) return 0;
    // A NUL inside a name would alias the blob's separator format (digest
    // and materialization would see two names): defer to the Python
    // decoder, which represents 'a\0b' faithfully.
    if (memchr(p, '\0', n) != nullptr) return 0;
    s->offs.push_back(static_cast<int32_t>(s->blob.size()));
    s->blob.insert(s->blob.end(), p, p + n);
    s->blob.push_back('\0');
    p += n;
  }
  if (p != end) return 0;
  if (!blob_is_clean_utf8(s->blob)) return 0;
  if (s->pod.empty()) s->pod = {'{', '}'};
  s->offs.push_back(static_cast<int32_t>(s->blob.size()));
  s->digest = blob_digest(s->blob.data(), s->blob.size());
  return 1;
}

// ------------------------------------------------------ HTTP/1.1 framer

// Event kinds / body-error codes mirrored by the ctypes bindings.
constexpr int32_t kNeedMore = 0;
constexpr int32_t kRequest = 1;
constexpr int32_t kReject = 2;
constexpr int32_t kErrTransferEncoding = 1;
constexpr int32_t kErrContentLength = 2;
constexpr int32_t kErrBodyTooLarge = 3;
constexpr int32_t kRejectHeaderTooLarge = 1;
constexpr int32_t kRejectRequestLine = 2;
constexpr int32_t kRejectHeaderLine = 3;
constexpr int32_t kFlagKeepAlive = 1;
constexpr int32_t kFlagCloseAfter = 2;
constexpr int32_t kFlagPredicate = 4;

struct IngestEvent {
  int32_t kind;
  int32_t status;     // reject-only: HTTP status (400/431)
  int32_t flags;      // kFlag*
  int32_t body_error; // kErr* (deferred into the routing layer's Request)
  int32_t err_code;   // kReject* detail for reject events
  int32_t pad_;
  int64_t method_off, method_len;
  int64_t target_off, target_len;
  int64_t head_off, head_len;  // full head incl. request line
  int64_t body_off, body_len;
  int64_t declared_len;        // Content-Length for 413 messages
  int64_t parse_ns;
};

struct IngestConn {
  std::vector<char> buf;
  size_t consumed = 0;   // prefix to drop at the next next() call
  size_t scan = 0;       // \r\n\r\n scan progress
  int state = 0;         // 0 headers, 1 body, 2 drain, 3 closed
  int64_t max_body = -1; // -1 = unlimited
  int64_t max_header = 65536;
  IngestEvent pend{};    // request meta carried from headers into body/drain
  size_t body_start = 0;
  size_t body_need = 0;
  int64_t drain_left = 0;
  // Last emitted request's body span, for zero-copy in-place decode.
  size_t last_body_off = 0;
  size_t last_body_len = 0;
};

bool token_ws(char c) {
  return c == ' ' || c == '\t' || c == '\r' || c == '\n' || c == '\v' ||
         c == '\f';
}

void trim(const char*& b, const char*& e) {
  while (b < e && token_ws(*b)) ++b;
  while (e > b && token_ws(e[-1])) --e;
}

bool iequal(const char* b, const char* e, const char* lit) {
  size_t n = strlen(lit);
  if (static_cast<size_t>(e - b) != n) return false;
  for (size_t i = 0; i < n; ++i) {
    char c = b[i];
    if (c >= 'A' && c <= 'Z') c += 32;
    if (c != lit[i]) return false;
  }
  return true;
}

// Parse the head [hb, he) into the pending event. Returns kRequest on
// success or kReject (with status/err_code set) — the same decisions
// transport_async._begin_request makes, byte for byte on the wire.
int32_t parse_head(IngestConn* conn, const char* hb, const char* he) {
  IngestEvent& ev = conn->pend;
  const char* base = conn->buf.data();
  // Request line: Python's str.split() — any whitespace runs — must yield
  // exactly [method, target, version] with version starting "HTTP/1.".
  const char* line_end = static_cast<const char*>(
      memchr(hb, '\r', he - hb));
  const char* rl_end = line_end != nullptr ? line_end : he;
  const char* toks[4];
  const char* tok_ends[4];
  int ntok = 0;
  const char* p = hb;
  while (p < rl_end) {
    while (p < rl_end && token_ws(*p)) ++p;
    if (p >= rl_end) break;
    const char* tb = p;
    while (p < rl_end && !token_ws(*p)) ++p;
    if (ntok < 4) {
      toks[ntok] = tb;
      tok_ends[ntok] = p;
    }
    ++ntok;
  }
  if (ntok != 3 || tok_ends[2] - toks[2] < 7 ||
      memcmp(toks[2], "HTTP/1.", 7) != 0) {
    ev.kind = kReject;
    ev.status = 400;
    ev.err_code = kRejectRequestLine;
    return kReject;
  }
  bool http10 = iequal(toks[2], tok_ends[2], "http/1.0");
  ev.method_off = toks[0] - base;
  ev.method_len = tok_ends[0] - toks[0];
  ev.target_off = toks[1] - base;
  ev.target_len = tok_ends[1] - toks[1];
  // Header lines.
  bool te_present = false;
  bool te_seen = false;
  bool cl_seen = false;
  bool cl_conflict = false;
  bool cl_bad = false;
  int64_t cl_value = 0;
  const char* cl_b = nullptr;
  const char* cl_e = nullptr;
  std::string conn_tok;  // first Connection header, lowered
  bool conn_seen = false;
  p = line_end != nullptr ? line_end : he;
  while (p < he) {
    if (*p == '\r' || *p == '\n') {
      ++p;
      continue;
    }
    const char* lb = p;
    const char* le = static_cast<const char*>(memchr(p, '\r', he - p));
    if (le == nullptr) le = he;
    p = le;
    const char* colon =
        static_cast<const char*>(memchr(lb, ':', le - lb));
    if (colon == nullptr) {
      ev.kind = kReject;
      ev.status = 400;
      ev.err_code = kRejectHeaderLine;
      return kReject;
    }
    const char* nb = lb;
    const char* ne = colon;
    const char* vb = colon + 1;
    const char* ve = le;
    trim(nb, ne);
    trim(vb, ve);
    if (iequal(nb, ne, "transfer-encoding")) {
      // Match the Python framer's `headers.get(...)` truthiness gate:
      // only the FIRST Transfer-Encoding header counts, and an empty
      // value is ignored.
      if (!te_seen) {
        te_seen = true;
        te_present = vb < ve;
      }
    } else if (iequal(nb, ne, "content-length")) {
      if (cl_seen) {
        if (static_cast<size_t>(ve - vb) !=
                static_cast<size_t>(cl_e - cl_b) ||
            memcmp(vb, cl_b, ve - vb) != 0) {
          cl_conflict = true;  // RFC 7230 3.3.2: differing duplicates
        }
      } else {
        cl_seen = true;
        cl_b = vb;
        cl_e = ve;
        if (vb == ve) {
          cl_bad = true;
        } else {
          for (const char* d = vb; d < ve; ++d) {
            if (*d < '0' || *d > '9') {
              cl_bad = true;
              break;
            }
          }
          if (!cl_bad) {
            cl_value = 0;
            for (const char* d = vb; d < ve; ++d) {
              if (cl_value > (INT64_MAX - 9) / 10) {
                cl_bad = true;  // absurd length: unframeable
                break;
              }
              cl_value = cl_value * 10 + (*d - '0');
            }
          }
        }
      }
    } else if (!conn_seen && iequal(nb, ne, "connection")) {
      conn_seen = true;
      conn_tok.assign(vb, ve);
      for (auto& ch : conn_tok) {
        if (ch >= 'A' && ch <= 'Z') ch += 32;
      }
    }
  }
  bool keep_alive;
  if (http10) {
    keep_alive = conn_tok.find("keep-alive") != std::string::npos;
  } else {
    keep_alive = conn_tok.find("close") == std::string::npos;
  }
  ev.kind = kRequest;
  ev.status = 0;
  ev.err_code = 0;
  ev.flags = keep_alive ? kFlagKeepAlive : 0;
  ev.body_error = 0;
  ev.body_off = 0;
  ev.body_len = 0;
  ev.declared_len = 0;
  // POST /predicates (query-string allowed): the hot-path flag the Python
  // side uses to route the body straight into a predicate slot.
  if (ev.method_len == 4 && memcmp(base + ev.method_off, "POST", 4) == 0) {
    const char* tb = base + ev.target_off;
    size_t tl = static_cast<size_t>(ev.target_len);
    const char* qm = static_cast<const char*>(memchr(tb, '?', tl));
    size_t plen = qm != nullptr ? static_cast<size_t>(qm - tb) : tl;
    if (plen == 11 && memcmp(tb, "/predicates", 11) == 0) {
      ev.flags |= kFlagPredicate;
    }
  }
  if (te_present) {
    ev.body_error = kErrTransferEncoding;
    ev.flags |= kFlagCloseAfter;
    return kRequest;
  }
  if (cl_conflict || cl_bad) {
    ev.body_error = kErrContentLength;
    ev.flags |= kFlagCloseAfter;
    return kRequest;
  }
  ev.declared_len = cl_seen ? cl_value : 0;
  return kRequest;
}

int32_t conn_next(IngestConn* conn, IngestEvent* out) {
  auto t0 = std::chrono::steady_clock::now();
  auto finish = [&](int32_t kind) {
    conn->pend.kind = kind;
    conn->pend.parse_ns +=
        std::chrono::duration_cast<std::chrono::nanoseconds>(
            std::chrono::steady_clock::now() - t0)
            .count();
    *out = conn->pend;
    return kind;
  };
  if (conn->consumed > 0) {
    conn->buf.erase(conn->buf.begin(),
                    conn->buf.begin() + conn->consumed);
    conn->consumed = 0;
  }
  if (conn->state == 3) return finish(kNeedMore);
  if (conn->state == 0) {
    conn->pend = IngestEvent{};
    const char* data = conn->buf.data();
    size_t size = conn->buf.size();
    size_t from = conn->scan > 3 ? conn->scan - 3 : 0;
    const char* hit = nullptr;
    while (from + 4 <= size) {
      const char* q = static_cast<const char*>(
          memchr(data + from, '\r', size - from));
      if (q == nullptr || static_cast<size_t>(q - data) + 4 > size) break;
      if (memcmp(q, "\r\n\r\n", 4) == 0) {
        hit = q;
        break;
      }
      from = q - data + 1;
    }
    if (hit == nullptr) {
      if (static_cast<int64_t>(size) > conn->max_header) {
        conn->state = 3;
        conn->pend.status = 431;
        conn->pend.err_code = kRejectHeaderTooLarge;
        return finish(kReject);
      }
      conn->scan = size;
      return finish(kNeedMore);
    }
    size_t idx = hit - data;
    conn->scan = 0;
    int32_t kind = parse_head(conn, data, data + idx);
    conn->pend.head_off = 0;
    conn->pend.head_len = idx;
    if (kind == kReject) {
      conn->state = 3;
      return finish(kReject);
    }
    conn->body_start = idx + 4;
    if (conn->pend.body_error != 0) {
      // TE / bad Content-Length: the body cannot be framed — emit the
      // request with the deferred error; nothing after it is parseable.
      conn->state = 3;
      conn->last_body_len = 0;
      return finish(kRequest);
    }
    int64_t length = conn->pend.declared_len;
    if (conn->max_body >= 0 && length > conn->max_body) {
      conn->pend.body_error = kErrBodyTooLarge;
      conn->state = 2;
      conn->drain_left = length;
      // fall through to drain below
    } else {
      conn->body_need = static_cast<size_t>(length);
      conn->state = 1;
      // fall through to body below
    }
  }
  if (conn->state == 1) {
    if (conn->buf.size() < conn->body_start + conn->body_need)
      return finish(kNeedMore);
    conn->pend.body_off = conn->body_start;
    conn->pend.body_len = conn->body_need;
    conn->last_body_off = conn->body_start;
    conn->last_body_len = conn->body_need;
    conn->consumed = conn->body_start + conn->body_need;
    conn->state = 0;
    return finish(kRequest);
  }
  // state 2: discard an oversized body in place, then emit the 413 request
  // with keep-alive framing intact.
  size_t have = conn->buf.size() > conn->body_start
                    ? conn->buf.size() - conn->body_start
                    : 0;
  size_t take = static_cast<size_t>(
      std::min<int64_t>(conn->drain_left, static_cast<int64_t>(have)));
  if (take > 0) {
    conn->buf.erase(conn->buf.begin() + conn->body_start,
                    conn->buf.begin() + conn->body_start + take);
    conn->drain_left -= static_cast<int64_t>(take);
  }
  if (conn->drain_left > 0) return finish(kNeedMore);
  conn->pend.body_off = 0;
  conn->pend.body_len = 0;
  conn->last_body_len = 0;
  conn->consumed = conn->body_start;
  conn->state = 0;
  return finish(kRequest);
}

}  // namespace

extern "C" {

// ---- arena ----------------------------------------------------------------

void* arena_create() { return new ClusterArena(); }

void arena_destroy(void* h) { delete static_cast<ClusterArena*>(h); }

void arena_upsert(void* h, int64_t idx, const int64_t* alloc3, int32_t zone,
                  int32_t unschedulable, int32_t ready, int32_t lr_driver,
                  int32_t lr_executor) {
  auto* a = static_cast<ClusterArena*>(h);
  std::lock_guard<std::mutex> lock(a->mu);
  a->ensure(idx);
  std::memcpy(&a->alloc[idx * kDims], alloc3, kDims * sizeof(int64_t));
  a->zone_id[idx] = zone;
  a->unschedulable[idx] = unschedulable ? 1 : 0;
  a->ready[idx] = ready ? 1 : 0;
  a->lr_driver[idx] = lr_driver;
  a->lr_executor[idx] = lr_executor;
  a->valid[idx] = 1;
}

void arena_remove(void* h, int64_t idx) {
  auto* a = static_cast<ClusterArena*>(h);
  std::lock_guard<std::mutex> lock(a->mu);
  if (idx < a->capacity) {
    a->valid[idx] = 0;
    a->name_rank[idx] = kInt32Inf;
  }
}

// ranks: [n_pairs] slot indices in name-sorted order. Slots not listed keep
// their previous rank only if still valid; callers pass the full live set.
void arena_set_name_ranks(void* h, const int64_t* sorted_idx, int64_t n) {
  auto* a = static_cast<ClusterArena*>(h);
  std::lock_guard<std::mutex> lock(a->mu);
  std::fill(a->name_rank.begin(), a->name_rank.end(), kInt32Inf);
  for (int64_t r = 0; r < n; ++r) {
    int64_t idx = sorted_idx[r];
    a->ensure(idx);
    a->name_rank[idx] = static_cast<int32_t>(r);
  }
}

// Scatter EXPLICIT rank values onto slots. The gapped (order-maintenance)
// name-rank scheme rides this: every kernel consumes rank ORDER only, so
// values need not be dense — a node ADD assigns a midpoint between its
// lexicographic neighbours' values and touches ONE slot, where the dense
// scheme (arena_set_name_ranks) renumbers every slot per add. Unlisted
// slots keep their previous ranks.
void arena_set_name_rank_values(void* h, const int64_t* idx,
                                const int32_t* ranks, int64_t n) {
  auto* a = static_cast<ClusterArena*>(h);
  std::lock_guard<std::mutex> lock(a->mu);
  for (int64_t i = 0; i < n; ++i) {
    a->ensure(idx[i]);
    a->name_rank[idx[i]] = ranks[i];
  }
}

// Materialize the solver inputs for slots [0, n) into caller buffers.
// usage/overhead are [n*3] int64 (sparse scatter done by the caller into a
// reusable buffer); outputs are the ClusterTensors fields.
void arena_snapshot(void* h, int64_t n, const int64_t* usage,
                    const int64_t* overhead, int32_t* available,
                    int32_t* schedulable, int32_t* zone_id, int32_t* name_rank,
                    int32_t* lr_driver, int32_t* lr_executor,
                    uint8_t* unschedulable, uint8_t* ready, uint8_t* valid) {
  auto* a = static_cast<ClusterArena*>(h);
  std::lock_guard<std::mutex> lock(a->mu);
  a->ensure(n > 0 ? n - 1 : 0);
  for (int64_t i = 0; i < n; ++i) {
    for (int d = 0; d < kDims; ++d) {
      int64_t al = a->alloc[i * kDims + d];
      int64_t ov = overhead[i * kDims + d];
      int64_t us = usage[i * kDims + d];
      available[i * kDims + d] = clip64(al - us - ov);
      schedulable[i * kDims + d] = clip64(al - ov);
    }
    zone_id[i] = a->zone_id[i];
    name_rank[i] = a->name_rank[i];
    lr_driver[i] = a->lr_driver[i];
    lr_executor[i] = a->lr_executor[i];
    unschedulable[i] = a->unschedulable[i];
    ready[i] = a->ready[i];
    valid[i] = a->valid[i];
  }
}

// Incremental twin of arena_snapshot: recompute ONLY `rows` into the
// caller's RESIDENT output buffers (each sized [n] rows). This is the
// C-speed half of the O(K + changed) tensor build — the per-window full
// materialization pass over all n slots was a measured ~35-50 ms at the
// million-node tier even when a handful of rows had changed. Rows at or
// past n are skipped defensively (the caller's buffers bound the write).
void arena_snapshot_rows(void* h, const int64_t* rows, int64_t k, int64_t n,
                         const int64_t* usage, const int64_t* overhead,
                         int32_t* available, int32_t* schedulable,
                         int32_t* zone_id, int32_t* name_rank,
                         int32_t* lr_driver, int32_t* lr_executor,
                         uint8_t* unschedulable, uint8_t* ready,
                         uint8_t* valid) {
  auto* a = static_cast<ClusterArena*>(h);
  std::lock_guard<std::mutex> lock(a->mu);
  a->ensure(n > 0 ? n - 1 : 0);
  for (int64_t r = 0; r < k; ++r) {
    int64_t i = rows[r];
    if (i < 0 || i >= n) continue;
    for (int d = 0; d < kDims; ++d) {
      int64_t al = a->alloc[i * kDims + d];
      int64_t ov = overhead[i * kDims + d];
      int64_t us = usage[i * kDims + d];
      available[i * kDims + d] = clip64(al - us - ov);
      schedulable[i * kDims + d] = clip64(al - ov);
    }
    zone_id[i] = a->zone_id[i];
    name_rank[i] = a->name_rank[i];
    lr_driver[i] = a->lr_driver[i];
    lr_executor[i] = a->lr_executor[i];
    unschedulable[i] = a->unschedulable[i];
    ready[i] = a->ready[i];
    valid[i] = a->valid[i];
  }
}

int64_t arena_capacity(void* h) {
  auto* a = static_cast<ClusterArena*>(h);
  std::lock_guard<std::mutex> lock(a->mu);
  return a->capacity;
}

// ---- queue ----------------------------------------------------------------

void* queue_create(int64_t buckets, int64_t buffer_size) {
  return new ShardedQueue(static_cast<size_t>(buckets),
                          static_cast<size_t>(buffer_size));
}

void queue_destroy(void* h) { delete static_cast<ShardedQueue*>(h); }

int64_t queue_bucket(void* h, const char* key, int64_t key_len) {
  auto* q = static_cast<ShardedQueue*>(h);
  return fnv1a32(key, static_cast<size_t>(key_len)) % q->shards.size();
}

// Dedup semantics of queue.go:58-68: every request marks the key inflight
// if absent; a request whose key was already inflight is dropped (the
// consumer reads the latest object from the store anyway) UNLESS it is a
// delete — deletes always enqueue so created-then-deleted objects still
// reach the backend. Returns 0 when dropped, 1 when enqueued. Blocks while
// the shard buffer is full.
int32_t queue_add_if_absent(void* h, const char* key, int64_t key_len,
                            uint64_t ticket, int32_t is_delete) {
  auto* q = static_cast<ShardedQueue*>(h);
  std::string k(key, static_cast<size_t>(key_len));
  bool added;
  {
    std::lock_guard<std::mutex> lock(q->inflight_mu);
    added = q->inflight.insert(k).second;
  }
  if (!added && !is_delete) return 0;
  Shard& s = q->shards[fnv1a32(key, key_len) % q->shards.size()];
  std::unique_lock<std::mutex> lock(s.mu);
  s.not_full.wait(lock, [&] { return s.tickets.size() < q->buffer_size; });
  s.tickets.push_back(ticket);
  s.not_empty.notify_one();
  return 1;
}

// Non-blocking variant (TryAddIfAbsent, queue.go:73-88): returns -1 if the
// shard buffer is full (caller handles overflow; the inflight mark this
// call added is rolled back), else as add_if_absent.
int32_t queue_try_add_if_absent(void* h, const char* key, int64_t key_len,
                                uint64_t ticket, int32_t is_delete) {
  auto* q = static_cast<ShardedQueue*>(h);
  std::string k(key, static_cast<size_t>(key_len));
  bool added;
  {
    std::lock_guard<std::mutex> lock(q->inflight_mu);
    added = q->inflight.insert(k).second;
  }
  if (!added && !is_delete) return 0;
  Shard& s = q->shards[fnv1a32(key, key_len) % q->shards.size()];
  std::unique_lock<std::mutex> lock(s.mu);
  if (s.tickets.size() >= q->buffer_size) {
    lock.unlock();
    if (added) {
      std::lock_guard<std::mutex> ilock(q->inflight_mu);
      q->inflight.erase(k);
    }
    return -1;
  }
  s.tickets.push_back(ticket);
  s.not_empty.notify_one();
  return 1;
}

// Blocking pop with timeout; returns 1 and fills *ticket, or 0 on timeout.
int32_t queue_pop(void* h, int64_t bucket, int64_t timeout_ms,
                  uint64_t* ticket) {
  auto* q = static_cast<ShardedQueue*>(h);
  Shard& s = q->shards[static_cast<size_t>(bucket)];
  std::unique_lock<std::mutex> lock(s.mu);
  if (!s.not_empty.wait_for(lock, std::chrono::milliseconds(timeout_ms),
                            [&] { return !s.tickets.empty(); })) {
    return 0;
  }
  *ticket = s.tickets.front();
  s.tickets.pop_front();
  s.not_full.notify_one();
  return 1;
}

// Consumers release the key from the inflight set when they start working
// on it, so later mutations re-enqueue (queue.go:90-104).
void queue_release(void* h, const char* key, int64_t key_len) {
  auto* q = static_cast<ShardedQueue*>(h);
  std::lock_guard<std::mutex> lock(q->inflight_mu);
  q->inflight.erase(std::string(key, static_cast<size_t>(key_len)));
}

int64_t queue_len(void* h, int64_t bucket) {
  auto* q = static_cast<ShardedQueue*>(h);
  Shard& s = q->shards[static_cast<size_t>(bucket)];
  std::lock_guard<std::mutex> lock(s.mu);
  return static_cast<int64_t>(s.tickets.size());
}

int64_t queue_num_buckets(void* h) {
  auto* q = static_cast<ShardedQueue*>(h);
  return static_cast<int64_t>(q->shards.size());
}

// ---- ingest: predicate slots ----------------------------------------------

void* pslot_create() {
  g_live_slots.fetch_add(1, std::memory_order_relaxed);
  return new PredicateSlot();
}

void pslot_destroy(void* h) {
  g_live_slots.fetch_sub(1, std::memory_order_relaxed);
  delete static_cast<PredicateSlot*>(h);
}

int64_t ingest_live_slots() {
  return g_live_slots.load(std::memory_order_relaxed);
}

int32_t predicate_decode_json(void* h, const char* body, int64_t len) {
  auto* s = static_cast<PredicateSlot*>(h);
  auto t0 = std::chrono::steady_clock::now();
  int32_t rc = decode_predicate_json_impl(s, body, len);
  s->decode_ns = std::chrono::duration_cast<std::chrono::nanoseconds>(
                     std::chrono::steady_clock::now() - t0)
                     .count();
  return rc;
}

int32_t predicate_decode_binary(void* h, const char* body, int64_t len) {
  auto* s = static_cast<PredicateSlot*>(h);
  auto t0 = std::chrono::steady_clock::now();
  int32_t rc = decode_predicate_binary_impl(s, body, len);
  s->decode_ns = std::chrono::duration_cast<std::chrono::nanoseconds>(
                     std::chrono::steady_clock::now() - t0)
                     .count();
  return rc;
}

const char* pslot_pod_ptr(void* h) {
  return static_cast<PredicateSlot*>(h)->pod.data();
}

int64_t pslot_pod_len(void* h) {
  return static_cast<int64_t>(static_cast<PredicateSlot*>(h)->pod.size());
}

const char* pslot_blob_ptr(void* h) {
  return static_cast<PredicateSlot*>(h)->blob.data();
}

int64_t pslot_blob_len(void* h) {
  return static_cast<int64_t>(static_cast<PredicateSlot*>(h)->blob.size());
}

const int32_t* pslot_offs_ptr(void* h) {
  return static_cast<PredicateSlot*>(h)->offs.data();
}

int64_t pslot_names_count(void* h) {
  auto* s = static_cast<PredicateSlot*>(h);
  return s->offs.empty() ? 0
                         : static_cast<int64_t>(s->offs.size()) - 1;
}

uint64_t pslot_digest(void* h) {
  return static_cast<PredicateSlot*>(h)->digest;
}

int64_t pslot_decode_ns(void* h) {
  return static_cast<PredicateSlot*>(h)->decode_ns;
}

int32_t pslot_blob_equal(void* ha, void* hb) {
  auto* a = static_cast<PredicateSlot*>(ha);
  auto* b = static_cast<PredicateSlot*>(hb);
  return a->blob.size() == b->blob.size() &&
                 memcmp(a->blob.data(), b->blob.data(), a->blob.size()) == 0
             ? 1
             : 0;
}

// ---- ingest: HTTP framer --------------------------------------------------

void* ingest_conn_create(int64_t max_body_bytes, int64_t max_header_bytes) {
  auto* c = new IngestConn();
  c->max_body = max_body_bytes;
  if (max_header_bytes > 0) c->max_header = max_header_bytes;
  return c;
}

void ingest_conn_destroy(void* h) { delete static_cast<IngestConn*>(h); }

void ingest_conn_feed(void* h, const char* data, int64_t len) {
  auto* c = static_cast<IngestConn*>(h);
  if (c->state == 3) return;  // closed: discard (drain-before-close)
  c->buf.insert(c->buf.end(), data, data + len);
}

int32_t ingest_conn_next(void* h, IngestEvent* out) {
  return conn_next(static_cast<IngestConn*>(h), out);
}

const char* ingest_conn_ptr(void* h) {
  return static_cast<IngestConn*>(h)->buf.data();
}

// Decode the LAST emitted request's body straight out of the connection
// buffer into a slot — the zero-copy hand-off (socket -> conn buffer ->
// arena slot; the body bytes never become a Python object). Valid only
// until the next ingest_conn_next call.
int32_t ingest_conn_decode_json(void* h, void* slot) {
  auto* c = static_cast<IngestConn*>(h);
  return predicate_decode_json(
      slot, c->buf.data() + c->last_body_off,
      static_cast<int64_t>(c->last_body_len));
}

int32_t ingest_conn_decode_binary(void* h, void* slot) {
  auto* c = static_cast<IngestConn*>(h);
  return predicate_decode_binary(
      slot, c->buf.data() + c->last_body_off,
      static_cast<int64_t>(c->last_body_len));
}

}  // extern "C"
