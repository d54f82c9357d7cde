// Native gateway: the horizontally-scalable front-end's relay loop in C++.
//
// The port's copy of the JAX package's native/gateway.cpp, built with g++
// by fluidframework_tpu_torch/native/build.py into build/torch_kernels/.
//
// Ref: SURVEY §2.9 — the reference's socket tier is socket.io behind N
// Alfred instances (driver-base/src/documentDeltaConnection.ts:53,
// services/src/socketIoRedisPublisher.ts); §2.9 prescribes a native
// streaming front end in its place. The Python gateway
// (service/gateway.py) established the protocol: this
// file is the same relay with zero Python on the hot path — one epoll
// thread pumping length-prefixed frames between client sockets and ONE
// upstream backbone connection to the ordering core.
//
// Wire contract (shared with front_end.py / gateway.py):
//   frame      := u32be length + body
//   binary body: 0x01 ftype ...   (protocol/binwire.py)
//     client submit  (ftype 1) -> upstream fsubmit (ftype 3, u32 sid spliced)
//     upstream fops  (ftype 4) -> client ops (ftype 2, topic stripped),
//                                 fanned out per topic subscriber
//     columnar twins (ftype 5-8) relay IDENTICALLY: cols_submit (5) ->
//     cols_fsubmit (6) by the same 6-byte sid splice, cols_fops (8) ->
//     cols_ops (7) by the same topic strip — the column payload is
//     never parsed on the relay path.
//   JSON body  : {"t": ...}
//     connect -> fconnect (sid assigned, bin:1 forced), fconnected ->
//     connected; submit/signal/disconnect -> f*; storage RPCs forwarded
//     with rid remapped; fnack/fsignal routed by sid/topic.
//
// Compatibility: clients SHOULD negotiate the binary ops push ("bin":1
// — the driver default). Legacy JSON-ops clients are served too: each
// binary broadcast batch is decoded to the JSON ops frame once per
// topic (ops_body_to_json / cols_body_to_json below) and shared by
// every legacy subscriber. A batch that cannot be decoded sends the
// legacy session an error frame and closes it, so its reconnect +
// delta backfill repairs the sequence gap instead of stalling on it.
//
// JSON handling is a shallow top-level scanner: keys + raw value spans.
// Frames are REASSEMBLED from spans (never re-serialized), so payloads
// pass through byte-identical, exactly like the Python relay.

#include <arpa/inet.h>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <ctime>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <deque>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

constexpr uint8_t kMagic = 0x01;
constexpr uint8_t kFtSubmit = 1;
constexpr uint8_t kFtOps = 2;
constexpr uint8_t kFtFsubmit = 3;
constexpr uint8_t kFtFops = 4;
constexpr uint8_t kFtColsSubmit = 5;
constexpr uint8_t kFtColsFsubmit = 6;
constexpr uint8_t kFtColsOps = 7;
constexpr uint8_t kFtColsFops = 8;
constexpr uint8_t kFtPresence = 11;
constexpr uint8_t kFtFpresence = 12;
constexpr size_t kMaxFrame = 8u * 1024 * 1024;     // front_end.py MAX_FRAME
constexpr size_t kMaxBuffered = 32u * 1024 * 1024; // slow-consumer drop

// ------------------------------------------------------------ JSON scanner

struct JsonField {
  std::string key;      // unescaped key
  const char* val;      // raw value span (escaped, verbatim)
  size_t val_len;
};

// Skip one JSON value starting at p; returns one past its end (nullptr on
// malformed input). Handles nesting + string escapes.
const char* skip_value(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) p++;
  if (p >= end) return nullptr;
  if (*p == '"') {
    p++;
    while (p < end) {
      if (*p == '\\') { p += 2; continue; }
      if (*p == '"') return p + 1;
      p++;
    }
    return nullptr;
  }
  if (*p == '{' || *p == '[') {
    char open = *p, close = (open == '{') ? '}' : ']';
    int depth = 0;
    bool in_str = false;
    while (p < end) {
      char c = *p;
      if (in_str) {
        if (c == '\\') { p += 2; continue; }
        if (c == '"') in_str = false;
        p++;
        continue;
      }
      if (c == '"') in_str = true;
      else if (c == open) depth++;
      else if (c == close) { depth--; if (depth == 0) return p + 1; }
      p++;
    }
    return nullptr;
  }
  // number / true / false / null
  while (p < end && *p != ',' && *p != '}' && *p != ']' && *p != ' ' &&
         *p != '\t' && *p != '\n' && *p != '\r')
    p++;
  return p;
}

// Unescape a JSON string body (between the quotes). Only the escapes the
// wire actually produces; \uXXXX is decoded for BMP codepoints.
std::string unescape(const char* p, size_t n) {
  std::string out;
  out.reserve(n);
  const char* end = p + n;
  while (p < end) {
    if (*p != '\\') { out.push_back(*p++); continue; }
    if (++p >= end) break;
    char c = *p++;
    switch (c) {
      case '"': out.push_back('"'); break;
      case '\\': out.push_back('\\'); break;
      case '/': out.push_back('/'); break;
      case 'b': out.push_back('\b'); break;
      case 'f': out.push_back('\f'); break;
      case 'n': out.push_back('\n'); break;
      case 'r': out.push_back('\r'); break;
      case 't': out.push_back('\t'); break;
      case 'u': {
        if (p + 4 > end) return out;
        unsigned cp = 0;
        for (int i = 0; i < 4; i++) {
          char h = p[i];
          cp <<= 4;
          if (h >= '0' && h <= '9') cp |= h - '0';
          else if (h >= 'a' && h <= 'f') cp |= h - 'a' + 10;
          else if (h >= 'A' && h <= 'F') cp |= h - 'A' + 10;
          else return out;
        }
        p += 4;
        if (cp < 0x80) out.push_back((char)cp);
        else if (cp < 0x800) {
          out.push_back((char)(0xC0 | (cp >> 6)));
          out.push_back((char)(0x80 | (cp & 0x3F)));
        } else {
          out.push_back((char)(0xE0 | (cp >> 12)));
          out.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
          out.push_back((char)(0x80 | (cp & 0x3F)));
        }
        break;
      }
      default: out.push_back(c);
    }
  }
  return out;
}

// Scan a top-level JSON object into key -> raw value span fields.
bool scan_object(const char* body, size_t len, std::vector<JsonField>* out) {
  const char* p = body;
  const char* end = body + len;
  while (p < end && *p != '{') p++;
  if (p >= end) return false;
  p++;
  while (p < end) {
    while (p < end && (*p == ' ' || *p == ',' || *p == '\t' || *p == '\n' ||
                       *p == '\r'))
      p++;
    if (p < end && *p == '}') return true;
    if (p >= end || *p != '"') return false;
    const char* kstart = ++p;
    while (p < end && *p != '"') {
      if (*p == '\\') p++;
      p++;
    }
    if (p >= end) return false;
    std::string key = unescape(kstart, (size_t)(p - kstart));
    p++;  // closing quote
    while (p < end && (*p == ' ' || *p == ':')) p++;
    const char* vstart = p;
    const char* vend = skip_value(p, end);
    if (!vend) return false;
    out->push_back({std::move(key), vstart, (size_t)(vend - vstart)});
    p = vend;
  }
  return false;
}

const JsonField* find(const std::vector<JsonField>& fs, const char* key) {
  for (const auto& f : fs)
    if (f.key == key) return &f;
  return nullptr;
}

std::string str_value(const JsonField* f) {
  if (!f || f->val_len < 2 || f->val[0] != '"') return std::string();
  return unescape(f->val + 1, f->val_len - 2);
}

long long int_value(const JsonField* f, long long dflt = -1) {
  if (!f) return dflt;
  return strtoll(std::string(f->val, f->val_len).c_str(), nullptr, 10);
}

void append_json_str(std::string* out, const std::string& s) {
  out->push_back('"');
  for (char c : s) {
    switch (c) {
      case '"': *out += "\\\""; break;
      case '\\': *out += "\\\\"; break;
      case '\n': *out += "\\n"; break;
      case '\r': *out += "\\r"; break;
      case '\t': *out += "\\t"; break;
      default:
        if ((unsigned char)c < 0x20) {
          char buf[8];
          snprintf(buf, sizeof buf, "\\u%04x", c);
          *out += buf;
        } else {
          out->push_back(c);
        }
    }
  }
  out->push_back('"');
}

// ------------------------------------------- binwire -> JSON ops decode
// For JSON-ops legacy clients: decode an ops body (binwire.py layout)
// into the exact {"t":"ops","msgs":[message_to_dict(...)...]} frame the
// Python front end would send. One decode per batch per gateway, shared
// by every legacy subscriber of the topic.

void append_double(std::string* out, double v) {
  char buf[32];
  // shortest round-trip double; json accepts %.17g's forms
  snprintf(buf, sizeof buf, "%.17g", v);
  // ensure it parses as a float (json floats need . or e for Python to
  // produce a float — but int is fine too; Python accepts either)
  *out += buf;
}

struct BinReader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;
  uint8_t u8() {
    if (p + 1 > end) { ok = false; return 0; }
    return *p++;
  }
  uint16_t u16() {
    if (p + 2 > end) { ok = false; return 0; }
    uint16_t v = ((uint16_t)p[0] << 8) | p[1];
    p += 2;
    return v;
  }
  uint32_t u32() {
    if (p + 4 > end) { ok = false; return 0; }
    uint32_t v = ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
                 ((uint32_t)p[2] << 8) | p[3];
    p += 4;
    return v;
  }
  int32_t i32() { return (int32_t)u32(); }
  int64_t i64() {
    uint64_t hi = u32(), lo = u32();
    return (int64_t)((hi << 32) | lo);
  }
  double f64() {
    uint64_t hi = u32(), lo = u32();
    uint64_t bits = (hi << 32) | lo;
    double d;
    memcpy(&d, &bits, 8);
    return d;
  }
  std::string bytes_str(size_t n) {
    if (p + n > end) { ok = false; return std::string(); }
    std::string s((const char*)p, n);
    p += n;
    return s;
  }
};

// Decode an ops body (after MAGIC+ftype, i.e. starting at the pool) into
// a JSON frame body. Returns empty string on malformed input.
std::string ops_body_to_json(const uint8_t* body, size_t len) {
  BinReader r{body + 2, body + len};
  uint16_t npool = r.u16();
  std::vector<std::string> pool(npool);
  for (uint16_t i = 0; i < npool && r.ok; i++)
    pool[i] = r.bytes_str(r.u16());
  uint16_t nrec = r.u16();
  if (!r.ok) return std::string();
  std::string out = "{\"t\":\"ops\",\"msgs\":[";
  for (uint16_t i = 0; i < nrec; i++) {
    uint16_t cid_idx = r.u16();
    int64_t seq = r.i64(), msn = r.i64();
    int32_t cseq = r.i32(), rseq = r.i32();
    double ts = r.f64();
    uint8_t ntr = r.u8();
    std::string traces = "[";
    for (uint8_t t = 0; t < ntr && r.ok; t++) {
      uint16_t svc = r.u16(), act = r.u16();
      double hts = r.f64();
      if (svc >= npool || act >= npool) { r.ok = false; break; }
      if (t) traces += ",";
      traces += "{\"service\":";
      append_json_str(&traces, pool[svc]);
      traces += ",\"action\":";
      append_json_str(&traces, pool[act]);
      traces += ",\"timestamp\":";
      append_double(&traces, hts);
      traces += "}";
    }
    traces += "]";
    uint8_t kind = r.u8();
    std::string type_contents;  // '"type":...,"contents":...[,...]'
    if (kind <= 2) {
      uint16_t ds = r.u16(), ch = r.u16();
      if (ds >= npool || ch >= npool) r.ok = false;
      std::string op;
      if (kind == 0) {
        uint32_t pos = r.u32();
        std::string text = r.bytes_str(r.u16());
        op = "{\"type\":0,\"pos\":" + std::to_string(pos) + ",\"text\":";
        append_json_str(&op, text);
        op += "}";
      } else if (kind == 1) {
        uint32_t start = r.u32(), end2 = r.u32();
        op = "{\"type\":1,\"start\":" + std::to_string(start) +
             ",\"end\":" + std::to_string(end2) + "}";
      } else {
        uint32_t start = r.u32(), end2 = r.u32();
        std::string props = r.bytes_str(r.u16());
        op = "{\"type\":2,\"start\":" + std::to_string(start) +
             ",\"end\":" + std::to_string(end2) + ",\"props\":" + props +
             "}";
      }
      if (!r.ok) return std::string();
      type_contents = "\"type\":\"op\",\"contents\":{\"kind\":\"chanop\","
                      "\"address\":";
      append_json_str(&type_contents, pool[ds]);
      type_contents += ",\"contents\":{\"address\":";
      append_json_str(&type_contents, pool[ch]);
      type_contents += ",\"contents\":" + op + "}}";
      type_contents += ",\"metadata\":null,\"origin\":null";
    } else if (kind == 0xFF) {
      uint32_t ln = r.u32();
      std::string blob = r.bytes_str(ln);
      if (!r.ok) return std::string();
      // blob = {"type":...,"contents":...,"metadata":...[,"origin":...]}
      std::vector<JsonField> gf;
      if (!scan_object(blob.data(), blob.size(), &gf)) return std::string();
      const JsonField* ty = find(gf, "type");
      const JsonField* co = find(gf, "contents");
      const JsonField* md = find(gf, "metadata");
      const JsonField* og = find(gf, "origin");
      if (!ty) return std::string();
      type_contents = "\"type\":" + std::string(ty->val, ty->val_len);
      type_contents += ",\"contents\":";
      type_contents += co ? std::string(co->val, co->val_len) : "null";
      type_contents += ",\"metadata\":";
      type_contents += md ? std::string(md->val, md->val_len) : "null";
      type_contents += ",\"origin\":";
      type_contents += og ? std::string(og->val, og->val_len) : "null";
    } else {
      return std::string();
    }
    if (!r.ok) return std::string();
    if (i) out += ",";
    out += "{\"_kind\":\"seq\",\"client_id\":";
    if (cid_idx == 0xFFFF) {
      out += "null";
    } else {
      if (cid_idx >= npool) return std::string();
      append_json_str(&out, pool[cid_idx]);
    }
    out += ",\"sequence_number\":" + std::to_string(seq);
    out += ",\"minimum_sequence_number\":" + std::to_string(msn);
    out += ",\"client_sequence_number\":" + std::to_string(cseq);
    out += ",\"reference_sequence_number\":" + std::to_string(rseq);
    out += "," + type_contents;
    out += ",\"timestamp\":";
    append_double(&out, ts);
    out += ",\"traces\":" + traces + "}";
  }
  out += "]}";
  return out;
}

// Columnar ops decode for JSON-ops legacy clients. The column section
// (binwire.py columnar layout) is LITTLE-endian by design — numpy-native
// on the Python ends — so this reader is the LE twin of BinReader.

struct LeReader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;
  uint16_t u16() {
    if (p + 2 > end) { ok = false; return 0; }
    uint16_t v = (uint16_t)p[0] | ((uint16_t)p[1] << 8);
    p += 2;
    return v;
  }
  uint32_t u32() {
    if (p + 4 > end) { ok = false; return 0; }
    uint32_t v = (uint32_t)p[0] | ((uint32_t)p[1] << 8) |
                 ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
    p += 4;
    return v;
  }
  int64_t i64() {
    uint64_t lo = u32(), hi = u32();
    return (int64_t)((hi << 32) | lo);
  }
  double f64() {
    uint64_t lo = u32(), hi = u32();
    uint64_t bits = (hi << 32) | lo;
    double d;
    memcpy(&d, &bits, 8);
    return d;
  }
  std::string bytes_str(size_t n) {
    if (p + n > end) { ok = false; return std::string(); }
    std::string s((const char*)p, n);
    p += n;
    return s;
  }
  bool skip(size_t n) {
    if (p + n > end) { ok = false; return false; }
    p += n;
    return true;
  }
};

int32_t rd_i32le(const uint8_t* p) {
  return (int32_t)((uint32_t)p[0] | ((uint32_t)p[1] << 8) |
                   ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24));
}

int64_t rd_i64le(const uint8_t* p) {
  uint64_t lo = (uint32_t)p[0] | ((uint32_t)p[1] << 8) |
                ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
  uint64_t hi = (uint32_t)p[4] | ((uint32_t)p[5] << 8) |
                ((uint32_t)p[6] << 16) | ((uint32_t)p[7] << 24);
  return (int64_t)((hi << 32) | lo);
}

// text_off holds CHARACTER offsets into the utf8 text blob; map them to
// byte offsets with a sequential walk (offsets are non-decreasing).
struct Utf8Walker {
  const char* s;
  size_t len;
  size_t byte = 0;
  long long ch = 0;
  size_t to_byte(long long target) {
    while (ch < target && byte < len) {
      unsigned char c = (unsigned char)s[byte];
      byte += (c < 0x80) ? 1 : (c < 0xE0) ? 2 : (c < 0xF0) ? 3 : 4;
      ch++;
    }
    return byte;
  }
};

// Decode a cols_ops body (MAGIC kFtColsOps stamp cols msns) into the
// exact {"t":"ops","msgs":[...]} frame front_end.py's JSON slot would
// produce. Empty string on malformed input.
std::string cols_body_to_json(const uint8_t* body, size_t len) {
  LeReader r{body + 2, body + len};
  std::string cid = r.bytes_str(r.u16());
  int64_t base_seq = r.i64();
  double ts = r.f64();
  uint16_t n = r.u16();
  std::string ds = r.bytes_str(r.u16());
  std::string ch = r.bytes_str(r.u16());
  if (!r.ok || n == 0) return std::string();
  const uint8_t* kind = r.p;
  if (!r.skip(n)) return std::string();
  const uint8_t* a = r.p;
  if (!r.skip(4ull * n)) return std::string();
  const uint8_t* b = r.p;
  if (!r.skip(4ull * n)) return std::string();
  const uint8_t* cseq = r.p;
  if (!r.skip(4ull * n)) return std::string();
  const uint8_t* rseq = r.p;
  if (!r.skip(4ull * n)) return std::string();
  const uint8_t* text_off = r.p;
  if (!r.skip(4ull * (n + 1))) return std::string();
  uint32_t tlen = r.u32();
  const char* text = (const char*)r.p;
  if (!r.skip(tlen)) return std::string();
  uint32_t plen = r.u32();
  const char* props_raw = (const char*)r.p;
  if (!r.skip(plen)) return std::string();
  const uint8_t* msns = r.p;
  if (!r.skip(8ull * n)) return std::string();
  // split the per-op props array (JSON list of dict-or-null) into spans
  std::vector<std::pair<const char*, size_t>> props_spans;
  if (plen) {
    const char* p = props_raw;
    const char* pend = props_raw + plen;
    while (p < pend && *p != '[') p++;
    if (p >= pend) return std::string();
    p++;
    while (p < pend) {
      while (p < pend && (*p == ' ' || *p == ',')) p++;
      if (p < pend && *p == ']') break;
      const char* vend = skip_value(p, pend);
      if (!vend) return std::string();
      props_spans.push_back({p, (size_t)(vend - p)});
      p = vend;
    }
    if (props_spans.size() != n) return std::string();
  }
  Utf8Walker w{text, tlen};
  std::string cid_json;
  append_json_str(&cid_json, cid);
  std::string out = "{\"t\":\"ops\",\"msgs\":[";
  for (uint16_t i = 0; i < n; i++) {
    uint8_t k = kind[i];
    std::string op;
    if (k == 0) {
      long long c0 = rd_i32le(text_off + 4ull * i);
      long long c1 = rd_i32le(text_off + 4ull * (i + 1));
      if (c1 < c0) return std::string();
      size_t b0 = w.to_byte(c0);
      size_t b1 = w.to_byte(c1);
      op = "{\"type\":0,\"pos\":" +
           std::to_string(rd_i32le(a + 4ull * i)) + ",\"text\":";
      append_json_str(&op, std::string(text + b0, b1 - b0));
      op += "}";
    } else if (k == 1) {
      op = "{\"type\":1,\"start\":" +
           std::to_string(rd_i32le(a + 4ull * i)) + ",\"end\":" +
           std::to_string(rd_i32le(b + 4ull * i)) + "}";
    } else if (k == 2) {
      op = "{\"type\":2,\"start\":" +
           std::to_string(rd_i32le(a + 4ull * i)) + ",\"end\":" +
           std::to_string(rd_i32le(b + 4ull * i)) + ",\"props\":";
      if (i < props_spans.size() && props_spans[i].second &&
          *props_spans[i].first == '{')
        op.append(props_spans[i].first, props_spans[i].second);
      else
        op += "{}";
      op += "}";
    } else {
      return std::string();
    }
    if (i) out += ",";
    out += "{\"_kind\":\"seq\",\"client_id\":" + cid_json;
    out += ",\"sequence_number\":" + std::to_string(base_seq + i);
    out += ",\"minimum_sequence_number\":" +
           std::to_string(rd_i64le(msns + 8ull * i));
    out += ",\"client_sequence_number\":" +
           std::to_string(rd_i32le(cseq + 4ull * i));
    out += ",\"reference_sequence_number\":" +
           std::to_string(rd_i32le(rseq + 4ull * i));
    out += ",\"type\":\"op\",\"contents\":{\"kind\":\"chanop\",\"address\":";
    append_json_str(&out, ds);
    out += ",\"contents\":{\"address\":";
    append_json_str(&out, ch);
    out += ",\"contents\":" + op + "}}";
    out += ",\"metadata\":null,\"origin\":null";
    out += ",\"timestamp\":";
    append_double(&out, ts);
    out += ",\"traces\":[]}";
  }
  out += "]}";
  return out;
}

// --------------------------------------------------------------- sessions

struct Session {
  int fd = -1;
  uint32_t sid = 0;        // 0 = not connected yet
  std::string topic;       // "tenant/doc" once connected
  bool binary = false;     // negotiated binwire ops push (bin:1)
  bool gated = false;      // connect in flight: buffer pushes
  std::vector<std::string> gate_buffer;
  size_t gate_bytes = 0;   // gate_buffer total, counted toward the
                           // slow-consumer bound (a gated session must
                           // not buffer unboundedly just because its
                           // connect reply is slow)
  std::string rbuf;        // partial inbound bytes
  std::deque<std::string> wq;  // pending outbound frames
  size_t wq_bytes = 0;
  size_t wq_off = 0;       // offset into wq.front()
  bool dead = false;
};

struct PendingRpc {
  int client_fd;
  std::string client_rid;  // raw span text ("7", "\"abc\"", or "" = absent)
  bool is_connect;
  uint32_t sid;            // for connect gating
};

struct Gateway {
  int epfd = -1;
  int listen_fd = -1;
  int up_fd = -1;
  int port = 0;
  std::string up_rbuf;
  std::deque<std::string> up_wq;
  size_t up_wq_off = 0;
  uint32_t next_sid = 1;
  long long next_rid = 1;
  std::unordered_map<int, Session> sessions;           // fd -> session
  std::unordered_map<uint32_t, int> sid_to_fd;
  std::unordered_map<long long, PendingRpc> pending;   // gateway rid -> rpc
  std::unordered_map<std::string, std::unordered_set<int>> topics;
  volatile bool stop = false;
};

void frame_header(std::string* out, size_t body_len) {
  out->push_back((char)((body_len >> 24) & 0xFF));
  out->push_back((char)((body_len >> 16) & 0xFF));
  out->push_back((char)((body_len >> 8) & 0xFF));
  out->push_back((char)(body_len & 0xFF));
}

std::string make_frame(const std::string& body) {
  std::string out;
  out.reserve(body.size() + 4);
  frame_header(&out, body.size());
  out += body;
  return out;
}

void arm_out(Gateway* g, int fd, bool want_out) {
  epoll_event ev{};
  ev.events = EPOLLIN | (want_out ? EPOLLOUT : 0);
  ev.data.fd = fd;
  epoll_ctl(g->epfd, EPOLL_CTL_MOD, fd, &ev);
}

void close_session(Gateway* g, int fd, bool notify_core);

// Queue a pre-framed byte string to a client session.
void send_to(Gateway* g, Session* s, std::string frame) {
  if (s->dead) return;
  if (s->gated) {
    s->gate_bytes += frame.size();
    if (s->wq_bytes + s->gate_bytes > kMaxBuffered) {
      s->dead = true;  // gated slow consumer: same bound as below
      return;
    }
    s->gate_buffer.push_back(std::move(frame));
    return;
  }
  s->wq_bytes += frame.size();
  if (s->wq_bytes + s->gate_bytes > kMaxBuffered) {
    s->dead = true;  // slow consumer: drop (mirrors MAX_BUFFERED)
    return;
  }
  bool was_empty = s->wq.empty();
  s->wq.push_back(std::move(frame));
  if (was_empty) {
    // opportunistic immediate write
    while (!s->wq.empty()) {
      const std::string& f = s->wq.front();
      ssize_t n = ::send(s->fd, f.data() + s->wq_off, f.size() - s->wq_off,
                         MSG_NOSIGNAL | MSG_DONTWAIT);
      if (n < 0) {
        if (errno == EAGAIN || errno == EWOULDBLOCK) break;
        s->dead = true;
        return;
      }
      s->wq_off += (size_t)n;
      if (s->wq_off == f.size()) {
        s->wq_bytes -= f.size();
        s->wq.pop_front();
        s->wq_off = 0;
      }
    }
    if (!s->wq.empty()) arm_out(g, s->fd, true);
  }
}

void send_upstream(Gateway* g, std::string frame) {
  bool was_empty = g->up_wq.empty();
  g->up_wq.push_back(std::move(frame));
  if (was_empty) {
    while (!g->up_wq.empty()) {
      const std::string& f = g->up_wq.front();
      ssize_t n = ::send(g->up_fd, f.data() + g->up_wq_off,
                         f.size() - g->up_wq_off,
                         MSG_NOSIGNAL | MSG_DONTWAIT);
      if (n < 0) {
        if (errno == EAGAIN || errno == EWOULDBLOCK) break;
        g->stop = true;
        return;
      }
      g->up_wq_off += (size_t)n;
      if (g->up_wq_off == f.size()) {
        g->up_wq.pop_front();
        g->up_wq_off = 0;
      }
    }
    if (!g->up_wq.empty()) arm_out(g, g->up_fd, true);
  }
}

void send_error(Gateway* g, Session* s, const std::string& rid_span,
                const std::string& msg) {
  std::string body = "{\"t\":\"error\"";
  if (!rid_span.empty()) {
    body += ",\"rid\":";
    body += rid_span;
  }
  body += ",\"message\":";
  append_json_str(&body, msg);
  body += "}";
  send_to(g, s, make_frame(body));
}

void detach_session(Gateway* g, Session* s, bool notify_core) {
  if (s->sid != 0) {
    auto it = g->topics.find(s->topic);
    if (it != g->topics.end()) {
      it->second.erase(s->fd);
      if (it->second.empty()) g->topics.erase(it);
    }
    if (notify_core && g->up_fd >= 0) {
      std::string body = "{\"t\":\"fdisconnect\",\"sid\":";
      body += std::to_string(s->sid);
      body += "}";
      send_upstream(g, make_frame(body));
    }
    g->sid_to_fd.erase(s->sid);
    s->sid = 0;
    s->topic.clear();
  }
}

void close_session(Gateway* g, int fd, bool notify_core) {
  auto it = g->sessions.find(fd);
  if (it == g->sessions.end()) return;
  detach_session(g, &it->second, notify_core);
  epoll_ctl(g->epfd, EPOLL_CTL_DEL, fd, nullptr);
  ::close(fd);
  g->sessions.erase(it);
}

// ----------------------------------------------------- client frame logic

void handle_client_json(Gateway* g, Session* s, const char* body, size_t len) {
  std::vector<JsonField> fields;
  if (!scan_object(body, len, &fields)) return;  // malformed: drop frame
  const JsonField* tf = find(fields, "t");
  std::string t = str_value(tf);
  const JsonField* ridf = find(fields, "rid");
  std::string rid_span = ridf ? std::string(ridf->val, ridf->val_len) : "";

  if (t == "connect") {
    if (s->sid != 0) detach_session(g, s, true);  // re-connect on live socket
    s->binary = int_value(find(fields, "bin"), 0) == 1;
    std::string tenant = str_value(find(fields, "tenant"));
    std::string doc = str_value(find(fields, "doc"));
    if (tenant.empty() || doc.empty()) {
      send_error(g, s, rid_span, "connect missing tenant/doc");
      return;
    }
    s->sid = g->next_sid++;
    s->topic = tenant + "/" + doc;
    s->gated = true;
    g->sid_to_fd[s->sid] = s->fd;
    g->topics[s->topic].insert(s->fd);
    long long grid = g->next_rid++;
    g->pending[grid] = {s->fd, rid_span, true, s->sid};
    // rebuild: {"t":"fconnect","sid":N,"rid":G,"bin":1, <other fields>}
    std::string out = "{\"t\":\"fconnect\",\"sid\":";
    out += std::to_string(s->sid);
    out += ",\"rid\":";
    out += std::to_string(grid);
    out += ",\"bin\":1";
    for (const auto& f : fields) {
      if (f.key == "t" || f.key == "rid" || f.key == "bin") continue;
      out += ",";
      append_json_str(&out, f.key);
      out += ":";
      out.append(f.val, f.val_len);
    }
    out += "}";
    send_upstream(g, make_frame(out));
  } else if (t == "submit") {
    if (s->sid == 0) { send_error(g, s, rid_span, "submit before connect"); return; }
    const JsonField* ops = find(fields, "ops");
    if (!ops) return;
    std::string out = "{\"t\":\"fsubmit\",\"sid\":";
    out += std::to_string(s->sid);
    out += ",\"ops\":";
    out.append(ops->val, ops->val_len);
    out += "}";
    send_upstream(g, make_frame(out));
  } else if (t == "signal") {
    if (s->sid == 0) { send_error(g, s, rid_span, "signal before connect"); return; }
    std::string out = "{\"t\":\"fsignal\",\"sid\":";
    out += std::to_string(s->sid);
    for (const auto& f : fields) {
      if (f.key == "t") continue;
      out += ",";
      append_json_str(&out, f.key);
      out += ":";
      out.append(f.val, f.val_len);
    }
    out += "}";
    send_upstream(g, make_frame(out));
  } else if (t == "disconnect") {
    detach_session(g, s, true);
  } else if (t == "ping") {
    // client liveness probe: answered at this hop (driver/network.py
    // recv-timeout escalation), never relayed upstream
    send_to(g, s, make_frame("{\"t\":\"pong\"}"));
  } else if (t == "get_deltas" || t == "get_versions" || t == "get_tree" ||
             t == "read_blob" || t == "write_blob" || t == "upload_summary") {
    long long grid = g->next_rid++;
    g->pending[grid] = {s->fd, rid_span, false, 0};
    std::string out = "{";
    bool first = true;
    for (const auto& f : fields) {
      if (f.key == "rid") continue;
      if (!first) out += ",";
      first = false;
      append_json_str(&out, f.key);
      out += ":";
      out.append(f.val, f.val_len);
    }
    out += first ? "\"rid\":" : ",\"rid\":";
    out += std::to_string(grid);
    out += "}";
    send_upstream(g, make_frame(out));
  } else {
    send_error(g, s, rid_span, "unknown frame type");
  }
}

void handle_client_frame(Gateway* g, Session* s, const char* body,
                         size_t len) {
  if (len >= 2 && (uint8_t)body[0] == kMagic) {
    uint8_t ft = (uint8_t)body[1];
    if ((ft == kFtSubmit || ft == kFtColsSubmit) && s->sid != 0) {
      // splice: 01 01 <batch> -> 01 03 u32sid <batch>; the columnar
      // twin is the identical rewrite (01 05 -> 01 06 u32sid)
      uint8_t hoptail_k =
          (ft == kFtColsSubmit && len >= 3) ? (uint8_t)body[len - 1] : 0;
      // sampled columnar frame (hoptail count > 0): splice the
      // gateway/relay hop before the trailing count byte — unsampled
      // frames cost one byte read, same as the Python gateway
      bool stamp = hoptail_k > 0 && hoptail_k < 0xFF;
      std::string out;
      out.reserve(len + 8 + 4 + (stamp ? 9 : 0));
      frame_header(&out, len + 4 + (stamp ? 9 : 0));
      out.push_back((char)kMagic);
      out.push_back((char)(ft == kFtSubmit ? kFtFsubmit : kFtColsFsubmit));
      out.push_back((char)((s->sid >> 24) & 0xFF));
      out.push_back((char)((s->sid >> 16) & 0xFF));
      out.push_back((char)((s->sid >> 8) & 0xFF));
      out.push_back((char)(s->sid & 0xFF));
      if (stamp) {
        out.append(body + 2, len - 3);  // content minus count byte
        out.push_back((char)1);         // hop id: gateway/relay
        struct timespec now_ts;
        clock_gettime(CLOCK_REALTIME, &now_ts);
        double now =
            (double)now_ts.tv_sec + (double)now_ts.tv_nsec * 1e-9;
        uint64_t bits;
        std::memcpy(&bits, &now, sizeof(bits));
        for (int i = 7; i >= 0; --i)
          out.push_back((char)((bits >> (8 * i)) & 0xFF));
        out.push_back((char)(hoptail_k + 1));
      } else {
        out.append(body + 2, len - 2);
      }
      send_upstream(g, std::move(out));
    } else {
      send_error(g, s, "", "unexpected binary frame");
    }
    return;
  }
  handle_client_json(g, s, body, len);
}

// --------------------------------------------------- upstream frame logic

void fan_out(Gateway* g, const std::string& topic, const std::string& frame) {
  auto it = g->topics.find(topic);
  if (it == g->topics.end()) return;
  // copy: send_to may mark sessions dead (erased later in the event loop)
  std::vector<int> fds(it->second.begin(), it->second.end());
  for (int fd : fds) {
    auto sit = g->sessions.find(fd);
    if (sit != g->sessions.end()) send_to(g, &sit->second, frame);
  }
}

// Decode a presence body (01 0B u16 n; n x [u16 cidlen cid (0xFFFF =
// null), u16 typelen type, u32 clen content-json]) into concatenated
// legacy {"t":"signal"} frames for a JSON session. The content span is
// already JSON and splices verbatim. Empty string on malformed input.
std::string presence_body_to_json_frames(const uint8_t* b, size_t len) {
  if (len < 4) return "";
  auto u16 = [&](size_t o) -> uint32_t {
    return ((uint32_t)b[o] << 8) | b[o + 1];
  };
  size_t off = 2;
  uint32_t n = u16(off);
  off += 2;
  std::string out;
  for (uint32_t i = 0; i < n; ++i) {
    if (off + 2 > len) return "";
    uint32_t cl = u16(off);
    off += 2;
    bool has_cid = cl != 0xFFFF;
    std::string cid;
    if (has_cid) {
      if (off + cl > len) return "";
      cid.assign((const char*)b + off, cl);
      off += cl;
    }
    if (off + 2 > len) return "";
    uint32_t tl = u16(off);
    off += 2;
    if (off + tl > len) return "";
    std::string type((const char*)b + off, tl);
    off += tl;
    if (off + 4 > len) return "";
    uint32_t clen = ((uint32_t)b[off] << 24) | ((uint32_t)b[off + 1] << 16) |
                    ((uint32_t)b[off + 2] << 8) | b[off + 3];
    off += 4;
    if (off + clen > len) return "";
    std::string sig =
        "{\"t\":\"signal\",\"signal\":{\"_kind\":\"signal\",\"client_id\":";
    if (has_cid) append_json_str(&sig, cid);
    else sig += "null";
    sig += ",\"type\":";
    append_json_str(&sig, type);
    sig += ",\"content\":";
    sig.append((const char*)b + off, clen);
    off += clen;
    sig += "}}";
    out += make_frame(sig);
  }
  return out;
}

void handle_upstream_frame(Gateway* g, const char* body, size_t len) {
  if (len >= 2 && (uint8_t)body[0] == kMagic) {
    uint8_t ft = (uint8_t)body[1];
    if ((ft == kFtFops || ft == kFtColsFops) && len >= 4) {
      // 01 04 u16 tlen topic <batch> -> topic, frame(01 02 <batch>);
      // the columnar twin strips identically (01 08 -> 01 07)
      size_t tlen = ((size_t)(uint8_t)body[2] << 8) | (uint8_t)body[3];
      if (4 + tlen > len) return;
      std::string topic(body + 4, tlen);
      std::string ops_body;
      ops_body.reserve(len - 4 - tlen + 2);
      ops_body.push_back((char)kMagic);
      ops_body.push_back((char)(ft == kFtFops ? kFtOps : kFtColsOps));
      ops_body.append(body + 4 + tlen, len - 4 - tlen);
      std::string bin_frame = make_frame(ops_body);
      auto it = g->topics.find(topic);
      if (it == g->topics.end()) return;
      std::string json_frame;  // lazily decoded once per batch
      bool json_failed = false;
      std::vector<int> fds(it->second.begin(), it->second.end());
      for (int fd : fds) {
        auto sit = g->sessions.find(fd);
        if (sit == g->sessions.end()) continue;
        Session* s = &sit->second;
        if (s->binary) {
          send_to(g, s, bin_frame);
        } else {
          if (json_frame.empty() && !json_failed) {
            std::string j =
                (ft == kFtFops)
                    ? ops_body_to_json((const uint8_t*)ops_body.data(),
                                       ops_body.size())
                    : cols_body_to_json((const uint8_t*)ops_body.data(),
                                        ops_body.size());
            if (j.empty()) json_failed = true;
            else json_frame = make_frame(j);
          }
          if (json_failed) {
            // a silently skipped batch would stall this session on
            // the seq gap forever — error + close instead, so its
            // reconnect + delta backfill repairs the stream
            send_error(g, s, "", "undecodable ops batch; reconnect");
            s->dead = true;
            continue;
          }
          send_to(g, s, json_frame);
        }
      }
    } else if (ft == kFtFpresence && len >= 4) {
      // 01 0C u16 tlen topic <batch> -> topic, frame(01 0B <batch>):
      // the presence lane's coalesced flush relays by the same topic
      // strip as fops — the batch bytes are never decoded for binary
      // subscribers
      size_t tlen = ((size_t)(uint8_t)body[2] << 8) | (uint8_t)body[3];
      if (4 + tlen > len) return;
      std::string topic(body + 4, tlen);
      std::string pbody;
      pbody.reserve(len - 4 - tlen + 2);
      pbody.push_back((char)kMagic);
      pbody.push_back((char)kFtPresence);
      pbody.append(body + 4 + tlen, len - 4 - tlen);
      std::string bin_frame = make_frame(pbody);
      auto it = g->topics.find(topic);
      if (it == g->topics.end()) return;
      std::string json_frames;  // lazily decoded once per flush
      bool json_tried = false;
      std::vector<int> fds(it->second.begin(), it->second.end());
      for (int fd : fds) {
        auto sit = g->sessions.find(fd);
        if (sit == g->sessions.end()) continue;
        Session* s = &sit->second;
        if (s->binary) {
          send_to(g, s, bin_frame);
        } else {
          if (!json_tried) {
            json_tried = true;
            json_frames = presence_body_to_json_frames(
                (const uint8_t*)pbody.data(), pbody.size());
          }
          // presence is ephemeral: a malformed batch drops silently —
          // unlike ops there is no sequence gap to stall on
          if (!json_frames.empty()) send_to(g, s, json_frames);
        }
      }
    }
    return;
  }
  std::vector<JsonField> fields;
  if (!scan_object(body, len, &fields)) return;
  const JsonField* ridf = find(fields, "rid");
  if (ridf) {
    long long grid = int_value(ridf);
    auto pit = g->pending.find(grid);
    if (pit == g->pending.end()) return;
    PendingRpc rpc = pit->second;
    g->pending.erase(pit);
    auto sit = g->sessions.find(rpc.client_fd);
    if (sit == g->sessions.end()) return;
    Session* s = &sit->second;
    const JsonField* tf = find(fields, "t");
    std::string t = str_value(tf);
    bool is_error = (t == "error");
    // rebuild the reply with the client's rid (and fconnected->connected)
    std::string out = "{";
    bool first = true;
    for (const auto& f : fields) {
      if (f.key == "rid" || f.key == "sid") continue;
      if (f.key == "t" && rpc.is_connect && !is_error) {
        if (!first) out += ",";
        first = false;
        out += "\"t\":\"connected\"";
        continue;
      }
      if (!first) out += ",";
      first = false;
      append_json_str(&out, f.key);
      out += ":";
      out.append(f.val, f.val_len);
    }
    if (!rpc.client_rid.empty()) {
      out += first ? "\"rid\":" : ",\"rid\":";
      out += rpc.client_rid;
    }
    out += "}";
    if (rpc.is_connect) {
      if (is_error) {
        // refused connect: unregister, drop the gate buffer
        s->gate_buffer.clear();
        s->gate_bytes = 0;
        s->gated = false;
        detach_session(g, s, false);
        send_to(g, s, make_frame(out));
      } else {
        // deliver connected FIRST, then the gated pushes, then ungate.
        // Each frame's bytes move from the gate account to the write
        // queue account as it replays — decrement BEFORE send_to so
        // the bound check never double-counts a frame mid-replay.
        s->gated = false;
        send_to(g, s, make_frame(out));
        for (auto& fbuf : s->gate_buffer) {
          s->gate_bytes -= fbuf.size();
          send_to(g, s, std::move(fbuf));
        }
        s->gate_buffer.clear();
      }
    } else {
      send_to(g, s, make_frame(out));
    }
    return;
  }
  const JsonField* tf = find(fields, "t");
  std::string t = str_value(tf);
  if (t == "fnack") {
    uint32_t sid = (uint32_t)int_value(find(fields, "sid"), 0);
    auto fit = g->sid_to_fd.find(sid);
    if (fit == g->sid_to_fd.end()) return;
    auto sit = g->sessions.find(fit->second);
    if (sit == g->sessions.end()) return;
    const JsonField* nack = find(fields, "nack");
    if (!nack) return;
    std::string out = "{\"t\":\"nack\",\"nack\":";
    out.append(nack->val, nack->val_len);
    out += "}";
    send_to(g, &sit->second, make_frame(out));
  } else if (t == "fsignal") {
    std::string topic = str_value(find(fields, "topic"));
    const JsonField* sig = find(fields, "signal");
    if (!sig) return;
    std::string out = "{\"t\":\"signal\",\"signal\":";
    out.append(sig->val, sig->val_len);
    out += "}";
    fan_out(g, topic, make_frame(out));
  } else if (t == "fops") {
    // core's JSON fallback for a batch binwire couldn't pack
    std::string topic = str_value(find(fields, "topic"));
    const JsonField* msgs = find(fields, "msgs");
    if (!msgs) return;
    std::string out = "{\"t\":\"ops\",\"msgs\":";
    out.append(msgs->val, msgs->val_len);
    out += "}";
    fan_out(g, topic, make_frame(out));
  } else if (t == "fdropped") {
    // core revoked this client's partition: close just that client so
    // its auto-reconnect lands on the takeover owner
    uint32_t sid = (uint32_t)int_value(find(fields, "sid"), 0);
    auto fit = g->sid_to_fd.find(sid);
    if (fit != g->sid_to_fd.end()) close_session(g, fit->second, false);
  }
}

// ------------------------------------------------------------- event loop

// Drain complete frames from a buffer; calls fn(body, len). Returns false
// on a framing error.
template <typename Fn>
bool drain_frames(std::string* buf, Fn fn) {
  size_t off = 0;
  while (buf->size() - off >= 4) {
    const unsigned char* p = (const unsigned char*)buf->data() + off;
    size_t n = ((size_t)p[0] << 24) | ((size_t)p[1] << 16) |
               ((size_t)p[2] << 8) | (size_t)p[3];
    if (n > kMaxFrame) return false;
    if (buf->size() - off - 4 < n) break;
    fn((const char*)buf->data() + off + 4, n);
    off += 4 + n;
  }
  if (off) buf->erase(0, off);
  return true;
}

void flush_wq(Gateway* g, int fd) {
  if (fd == g->up_fd) {
    while (!g->up_wq.empty()) {
      const std::string& f = g->up_wq.front();
      ssize_t n = ::send(fd, f.data() + g->up_wq_off, f.size() - g->up_wq_off,
                         MSG_NOSIGNAL | MSG_DONTWAIT);
      if (n < 0) {
        if (errno == EAGAIN || errno == EWOULDBLOCK) return;
        g->stop = true;
        return;
      }
      g->up_wq_off += (size_t)n;
      if (g->up_wq_off == f.size()) {
        g->up_wq.pop_front();
        g->up_wq_off = 0;
      }
    }
    arm_out(g, fd, false);
    return;
  }
  auto it = g->sessions.find(fd);
  if (it == g->sessions.end()) return;
  Session* s = &it->second;
  while (!s->wq.empty()) {
    const std::string& f = s->wq.front();
    ssize_t n = ::send(fd, f.data() + s->wq_off, f.size() - s->wq_off,
                       MSG_NOSIGNAL | MSG_DONTWAIT);
    if (n < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK) return;
      s->dead = true;
      return;
    }
    s->wq_off += (size_t)n;
    if (s->wq_off == f.size()) {
      s->wq_bytes -= f.size();
      s->wq.pop_front();
      s->wq_off = 0;
    }
  }
  arm_out(g, fd, false);
}

}  // namespace

extern "C" {

void* gateway_create(const char* core_host, int core_port,
                     const char* listen_host, int listen_port) {
  auto* g = new Gateway();
  g->epfd = epoll_create1(0);
  if (g->epfd < 0) { delete g; return nullptr; }

  // upstream backbone
  g->up_fd = ::socket(AF_INET, SOCK_STREAM, 0);
  sockaddr_in up{};
  up.sin_family = AF_INET;
  up.sin_port = htons((uint16_t)core_port);
  if (inet_pton(AF_INET, core_host, &up.sin_addr) != 1) {
    hostent* he = gethostbyname(core_host);
    if (!he) { ::close(g->up_fd); delete g; return nullptr; }
    memcpy(&up.sin_addr, he->h_addr, (size_t)he->h_length);
  }
  if (connect(g->up_fd, (sockaddr*)&up, sizeof up) != 0) {
    ::close(g->up_fd);
    delete g;
    return nullptr;
  }
  int one = 1;
  setsockopt(g->up_fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);

  // listener (non-blocking: the accept drain loop must hit EAGAIN, not
  // block the relay)
  g->listen_fd = ::socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
  setsockopt(g->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)listen_port);
  if (inet_pton(AF_INET, listen_host, &addr.sin_addr) != 1)
    addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  if (bind(g->listen_fd, (sockaddr*)&addr, sizeof addr) != 0 ||
      listen(g->listen_fd, 1024) != 0) {
    ::close(g->up_fd);
    ::close(g->listen_fd);
    delete g;
    return nullptr;
  }
  socklen_t alen = sizeof addr;
  getsockname(g->listen_fd, (sockaddr*)&addr, &alen);
  g->port = ntohs(addr.sin_port);

  epoll_event ev{};
  ev.events = EPOLLIN;
  ev.data.fd = g->listen_fd;
  epoll_ctl(g->epfd, EPOLL_CTL_ADD, g->listen_fd, &ev);
  ev.data.fd = g->up_fd;
  epoll_ctl(g->epfd, EPOLL_CTL_ADD, g->up_fd, &ev);
  return g;
}

int gateway_port(void* h) { return static_cast<Gateway*>(h)->port; }

void gateway_stop(void* h) { static_cast<Gateway*>(h)->stop = true; }

// Run the relay loop; returns 0 on clean stop, -1 when the core vanished.
int gateway_run(void* h) {
  auto* g = static_cast<Gateway*>(h);
  epoll_event events[256];
  char buf[256 * 1024];
  while (!g->stop) {
    int n = epoll_wait(g->epfd, events, 256, 200);
    if (n < 0) {
      if (errno == EINTR) continue;
      break;
    }
    for (int i = 0; i < n && !g->stop; i++) {
      int fd = events[i].data.fd;
      uint32_t evs = events[i].events;
      if (fd == g->listen_fd) {
        while (true) {
          int cfd = accept4(g->listen_fd, nullptr, nullptr, SOCK_NONBLOCK);
          if (cfd < 0) break;
          int one = 1;
          setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
          Session s;
          s.fd = cfd;
          g->sessions.emplace(cfd, std::move(s));
          epoll_event ev{};
          ev.events = EPOLLIN;
          ev.data.fd = cfd;
          epoll_ctl(g->epfd, EPOLL_CTL_ADD, cfd, &ev);
        }
        continue;
      }
      if (fd == g->up_fd) {
        if (evs & EPOLLOUT) flush_wq(g, fd);
        if (evs & (EPOLLIN | EPOLLHUP | EPOLLERR)) {
          ssize_t r;
          while ((r = recv(fd, buf, sizeof buf, MSG_DONTWAIT)) > 0)
            g->up_rbuf.append(buf, (size_t)r);
          bool eof = (r == 0) || (r < 0 && errno != EAGAIN &&
                                  errno != EWOULDBLOCK);
          if (!drain_frames(&g->up_rbuf, [g](const char* b, size_t l) {
                handle_upstream_frame(g, b, l);
              }))
            eof = true;
          if (eof) {
            g->stop = true;  // core gone: every client is dead too
            return -1;
          }
        }
        continue;
      }
      auto sit = g->sessions.find(fd);
      if (sit == g->sessions.end()) continue;
      Session* s = &sit->second;
      if (evs & EPOLLOUT) flush_wq(g, fd);
      if (evs & (EPOLLIN | EPOLLHUP | EPOLLERR)) {
        ssize_t r;
        while ((r = recv(fd, buf, sizeof buf, MSG_DONTWAIT)) > 0)
          s->rbuf.append(buf, (size_t)r);
        bool eof = (r == 0) ||
                   (r < 0 && errno != EAGAIN && errno != EWOULDBLOCK);
        if (!drain_frames(&s->rbuf, [g, s](const char* b, size_t l) {
              handle_client_frame(g, s, b, l);
            }))
          eof = true;
        if (eof || s->dead) {
          close_session(g, fd, true);
          continue;
        }
      }
      if (s->dead) close_session(g, fd, true);
    }
    // sweep sessions a fan-out marked dead (slow consumers)
    std::vector<int> dead;
    for (auto& [fd2, s2] : g->sessions)
      if (s2.dead) dead.push_back(fd2);
    for (int fd2 : dead) close_session(g, fd2, true);
  }
  return 0;
}

void gateway_destroy(void* h) {
  auto* g = static_cast<Gateway*>(h);
  for (auto& [fd, s] : g->sessions) ::close(fd);
  if (g->listen_fd >= 0) ::close(g->listen_fd);
  if (g->up_fd >= 0) ::close(g->up_fd);
  if (g->epfd >= 0) ::close(g->epfd);
  delete g;
}

}  // extern "C"
