// Durable append-only partitioned op log — the librdkafka-role component.
//
// The port's copy of the JAX package's native/oplog.cpp (same C ABI, same
// on-disk layout, so either package reads a directory the other wrote).
// Built with g++ by fluidframework_tpu_torch/native/build.py.
//
// Ref role: node-rdkafka/librdkafka carries the ordered, checkpointed
// message log between the reference's pipeline stages (SURVEY §2.9).
// Here: one directory per log, one (data, index) file pair per topic.
// Data file: length-prefixed records; index file: uint64 byte offsets,
// one per record, so offset->record lookup is O(1) and recovery is a
// single index scan. Appends are buffered by libc and made durable by
// oplog_sync (the checkpoint boundary deli/scribe flush on).
//
// C ABI (ctypes-friendly), no exceptions across the boundary.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cctype>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <sys/stat.h>
#ifdef _WIN32
#include <io.h>
#else
#include <unistd.h>
#endif
#include <utility>
#include <vector>

namespace {

// portable file truncation: recovery MUST be able to cut ragged tails on
// every platform, or a crash mid-write leaves misaligned index entries
// that silently corrupt later record ordinals
int truncate_file(FILE *f, uint64_t size) {
#ifdef _WIN32
    return _chsize_s(_fileno(f), (long long)size);
#else
    return ftruncate(fileno(f), (off_t)size);
#endif
}

struct Topic {
    FILE* data = nullptr;
    FILE* index = nullptr;
    std::vector<uint64_t> offsets;  // byte offset of each record
    uint64_t data_end = 0;
    bool dirty = false;  // appended-to since the last flush/sync
    bool unsynced = false;  // appended-to since the last fsync
    uint64_t last_use = 0;  // handle-LRU stamp
};

// --------------------------------------------------------------- segments
// Columnar segment streams (the Kafka segment+index trick): block bytes
// are packed back to back into fixed-size segment files
// <stream>.seg<k>, and a flat side index <stream>.segidx holds one
// 32-byte entry per block:
//
//     entry := i64 first_seq, i64 last_seq,
//              u32 seg, u32 off, u32 len, u32 btype   (little-endian)
//
// first/last_seq are the block's sequence-number span (non-decreasing
// across entries — the deltas topic is appended in ticket order), so a
// [from_seq, to_seq) backfill is a binary search over two sorted i64
// columns plus raw byte-range reads. The Python side (service/
// segment_store.py) mmaps the index + segment files and reads with one
// np.frombuffer per file; this side owns appends, the segment roll, and
// the torn-tail scan.

struct SegEntry {
    int64_t first_seq;
    int64_t last_seq;
    uint32_t seg;
    uint32_t off;
    uint32_t len;
    uint32_t btype;
};
static_assert(sizeof(SegEntry) == 32, "segidx entry layout is on-disk ABI");

struct SegStream {
    FILE* index = nullptr;
    FILE* data = nullptr;       // tail segment (writer only)
    uint32_t cur_seg = 0;
    uint64_t cur_off = 0;       // validated byte extent of the tail segment
    std::vector<SegEntry> entries;
    bool dirty = false;
    bool unsynced = false;      // appended-to since the last fsync
    bool torn = false;          // deliberate torn bytes past cur_off on disk
    uint64_t last_use = 0;      // handle-LRU stamp
};

struct OpLog {
    std::string dir;
    std::map<std::string, Topic> topics;
    std::map<std::string, SegStream> segs;
    std::mutex mu;
    uint64_t seg_bytes = 4u << 20;  // segment roll threshold
    // consumer-process handles: never truncate (recovery is the single
    // writer's job — a reader truncating a live writer's ragged tail
    // would silently shift the writer's record ordinals)
    bool readonly = false;
    // ------------------------------------------------------ handle LRU
    // Topic/stream METADATA (offsets, seg entries, extents) stays
    // resident forever — it is what makes length/read O(1) — but the
    // FILE*s behind it are a bounded cache: a core holding 10k
    // rehydrated docs at ~8 handles each would blow any RLIMIT_NOFILE.
    // When open_files exceeds fd_cap (0 = unlimited), the
    // least-recently-used quarter is flushed and closed; a later touch
    // reopens on demand and trusts the in-memory metadata (single
    // writer — no re-scan, no truncation).
    uint64_t fd_cap = 0;
    uint64_t open_files = 0;
    uint64_t lru_clock = 0;
    // files with appends not yet fsync'd whose handles were evicted:
    // oplog_sync must cover them or the checkpoint-boundary durability
    // contract silently narrows to "whatever happened to still be open"
    std::vector<std::string> evicted_unsynced;
};

void evict_excess(OpLog* log) {
    if (log->fd_cap == 0 || log->open_files <= log->fd_cap) return;
    std::vector<std::pair<uint64_t, std::pair<bool, const std::string*>>> open_entries;
    for (auto& kv : log->topics)
        if (kv.second.data)
            open_entries.push_back({kv.second.last_use, {false, &kv.first}});
    for (auto& kv : log->segs)
        // a torn stream's on-disk residue is deliberate state the next
        // append must find exactly as left — never cycle its handles
        if ((kv.second.index || kv.second.data) && !kv.second.torn)
            open_entries.push_back({kv.second.last_use, {true, &kv.first}});
    std::sort(open_entries.begin(), open_entries.end(),
              [](const auto& a, const auto& b) { return a.first < b.first; });
    // close down to 3/4 of the cap so evictions amortize over many opens
    uint64_t target = log->fd_cap - log->fd_cap / 4;
    for (const auto& ent : open_entries) {
        if (log->open_files <= target) break;
        if (ent.first == log->lru_clock) continue;  // the entry in use now
        if (ent.second.first) {
            SegStream& s = log->segs[*ent.second.second];
            if (s.data) fflush(s.data);
            if (s.index) fflush(s.index);
            if (s.unsynced) {
                log->evicted_unsynced.push_back(
                    log->dir + "/" + *ent.second.second + ".segidx");
                log->evicted_unsynced.push_back(
                    log->dir + "/" + *ent.second.second + ".seg" +
                    std::to_string(s.cur_seg));
                s.unsynced = false;
            }
            if (s.data) { fclose(s.data); s.data = nullptr; log->open_files--; }
            if (s.index) { fclose(s.index); s.index = nullptr; log->open_files--; }
            s.dirty = false;
        } else {
            Topic& t = log->topics[*ent.second.second];
            fflush(t.data);
            fflush(t.index);
            if (t.unsynced) {
                log->evicted_unsynced.push_back(
                    log->dir + "/" + *ent.second.second + ".data");
                log->evicted_unsynced.push_back(
                    log->dir + "/" + *ent.second.second + ".idx");
                t.unsynced = false;
            }
            fclose(t.data);
            fclose(t.index);
            t.data = t.index = nullptr;
            t.dirty = false;
            log->open_files -= 2;
        }
    }
}

// reopen an evicted topic's handles, trusting the resident metadata
bool reopen_topic(OpLog* log, const std::string& name, Topic* t) {
    std::string base = log->dir + "/" + name;
    const char* mode = log->readonly ? "rb" : "ab+";
    t->data = fopen((base + ".data").c_str(), mode);
    t->index = fopen((base + ".idx").c_str(), mode);
    if (!t->data || !t->index) {
        if (t->data) fclose(t->data);
        if (t->index) fclose(t->index);
        t->data = t->index = nullptr;
        return false;
    }
    log->open_files += 2;
    return true;
}

bool valid_topic_name(const char* t) {
    for (const char* p = t; *p; ++p) {
        if (!(isalnum(*p) || *p == '-' || *p == '_' || *p == '.')) return false;
    }
    return *t != 0;
}

Topic* get_topic(OpLog* log, const char* name) {
    auto it = log->topics.find(name);
    if (it != log->topics.end()) {
        Topic* t = &it->second;
        t->last_use = ++log->lru_clock;
        if (!t->data) {  // evicted: reopen on demand
            if (!reopen_topic(log, it->first, t)) return nullptr;
            evict_excess(log);
        }
        return t;
    }
    if (!valid_topic_name(name)) return nullptr;

    Topic t;
    std::string base = log->dir + "/" + name;
    std::string dpath = base + ".data", ipath = base + ".idx";
    const char* mode = log->readonly ? "rb" : "ab+";
    t.data = fopen(dpath.c_str(), mode);
    t.index = fopen(ipath.c_str(), mode);
    if (!t.data || !t.index) {
        // readonly: the producer has not created this topic yet — the
        // caller (oplog_refresh) retries later; not cached as a failure
        if (t.data) fclose(t.data);
        if (t.index) fclose(t.index);
        return nullptr;
    }
    // recover the index
    fseek(t.index, 0, SEEK_SET);
    uint64_t off;
    while (fread(&off, sizeof(off), 1, t.index) == 1) t.offsets.push_back(off);
    // a torn trailing PARTIAL index entry (crash mid-index-write) must be
    // cut even when every complete entry validates against the data extent
    // below — otherwise the next append lands misaligned after the ragged
    // tail and silently corrupts the ordinals of later records
    fseek(t.index, 0, SEEK_END);
    uint64_t index_bytes = (uint64_t)ftell(t.index);
    if (index_bytes != t.offsets.size() * sizeof(uint64_t) &&
        !log->readonly) {
        if (truncate_file(t.index,
                          t.offsets.size() * sizeof(uint64_t)) != 0) {
            fclose(t.data);
            fclose(t.index);
            return nullptr;
        }
    }
    fseek(t.data, 0, SEEK_END);
    t.data_end = (uint64_t)ftell(t.data);
    // drop torn trailing records (crash mid-append): index entries whose
    // record extends past the data end. The files MUST be truncated to the
    // validated extent too — an in-memory-only drop would let the next
    // append re-expose the stale index entry on a subsequent restart,
    // shifting every record ordinal.
    size_t valid = t.offsets.size();
    uint64_t valid_end = t.data_end;
    while (valid > 0) {
        uint64_t last = t.offsets[valid - 1];
        uint32_t len = 0;
        if (last + sizeof(len) <= t.data_end) {
            fseek(t.data, (long)last, SEEK_SET);
            if (fread(&len, sizeof(len), 1, t.data) == 1 &&
                last + sizeof(len) + len <= t.data_end) {
                valid_end = last + sizeof(len) + len;
                break;
            }
        }
        valid--;
        valid_end = last;
    }
    if (valid < t.offsets.size() || valid_end < t.data_end) {
        t.offsets.resize(valid);
        if (log->readonly) {
            // in-memory drop only: the tail may simply be mid-write by
            // the live producer; oplog_refresh re-admits it once whole
            t.data_end = valid_end;
        } else {
            fflush(t.index);
            fflush(t.data);
            if (truncate_file(t.index, valid * sizeof(uint64_t)) != 0 ||
                truncate_file(t.data, valid_end) != 0) {
                fclose(t.data);
                fclose(t.index);
                return nullptr;
            }
            t.data_end = valid_end;
        }
    }
    t.last_use = ++log->lru_clock;
    auto res = log->topics.emplace(name, std::move(t));
    log->open_files += 2;
    evict_excess(log);
    return &res.first->second;
}

std::string seg_path(OpLog* log, const char* name, uint32_t seg) {
    return log->dir + "/" + name + ".seg" + std::to_string(seg);
}

// physical size of segment file <name>.seg<k>, or 0 when absent
uint64_t seg_file_size(OpLog* log, const char* name, uint32_t seg) {
    FILE* f = fopen(seg_path(log, name, seg).c_str(), "rb");
    if (!f) return 0;
    fseek(f, 0, SEEK_END);
    uint64_t n = (uint64_t)ftell(f);
    fclose(f);
    return n;
}

// reopen an evicted stream's handles, trusting the resident metadata
// (the eviction flushed, so the tail segment's extent is authoritative)
bool reopen_seg(OpLog* log, const std::string& name, SegStream* s) {
    std::string ipath = log->dir + "/" + name + ".segidx";
    s->index = fopen(ipath.c_str(), log->readonly ? "rb" : "ab+");
    if (!s->index) return false;
    log->open_files += 1;
    if (!log->readonly) {
        s->data = fopen(seg_path(log, name.c_str(), s->cur_seg).c_str(),
                        "ab+");
        if (!s->data) {
            fclose(s->index);
            s->index = nullptr;
            log->open_files -= 1;
            return false;
        }
        log->open_files += 1;
    }
    return true;
}

SegStream* get_seg(OpLog* log, const char* name) {
    auto it = log->segs.find(name);
    if (it != log->segs.end()) {
        SegStream* s = &it->second;
        s->last_use = ++log->lru_clock;
        if (!s->index) {  // evicted: reopen on demand
            if (!reopen_seg(log, it->first, s)) return nullptr;
            evict_excess(log);
        }
        return s;
    }
    if (!valid_topic_name(name)) return nullptr;

    SegStream s;
    std::string ipath = log->dir + "/" + name + ".segidx";
    s.index = fopen(ipath.c_str(), log->readonly ? "rb" : "ab+");
    if (!s.index) return nullptr;  // readonly: producer not there yet
    fseek(s.index, 0, SEEK_SET);
    SegEntry e;
    while (fread(&e, sizeof(e), 1, s.index) == 1) s.entries.push_back(e);
    fseek(s.index, 0, SEEK_END);
    uint64_t index_bytes = (uint64_t)ftell(s.index);
    // torn-tail scan, index side: cut a partial trailing entry (crash
    // mid-index-write), then walk back entries whose block bytes never
    // fully landed in the segment file (crash mid-block-write)
    bool ragged = index_bytes != s.entries.size() * sizeof(SegEntry);
    while (!s.entries.empty()) {
        const SegEntry& last = s.entries.back();
        if ((uint64_t)last.off + last.len <=
            seg_file_size(log, name, last.seg)) break;
        s.entries.pop_back();
        ragged = true;
    }
    if (ragged && !log->readonly) {
        if (truncate_file(s.index, s.entries.size() * sizeof(SegEntry)) != 0) {
            fclose(s.index);
            return nullptr;
        }
    }
    if (!s.entries.empty()) {
        s.cur_seg = s.entries.back().seg;
        s.cur_off = (uint64_t)s.entries.back().off + s.entries.back().len;
    }
    if (!log->readonly) {
        // writer owns the tail segment: open it and cut any bytes past the
        // validated extent (torn block data with no surviving index entry)
        s.data = fopen(seg_path(log, name, s.cur_seg).c_str(), "ab+");
        if (!s.data) {
            fclose(s.index);
            return nullptr;
        }
        fseek(s.data, 0, SEEK_END);
        if ((uint64_t)ftell(s.data) != s.cur_off &&
            truncate_file(s.data, s.cur_off) != 0) {
            fclose(s.index);
            fclose(s.data);
            return nullptr;
        }
    }
    s.last_use = ++log->lru_clock;
    auto res = log->segs.emplace(name, std::move(s));
    log->open_files += res.first->second.data ? 2 : 1;
    evict_excess(log);
    return &res.first->second;
}

// drop in-process knowledge of deliberate torn bytes (oplog_seg_tear) by
// truncating the files back to the validated extent — the same cut the
// open-time scan would make after a real crash
bool seg_untear(SegStream* s) {
    fflush(s->data);
    fflush(s->index);
    if (truncate_file(s->index, s->entries.size() * sizeof(SegEntry)) != 0 ||
        truncate_file(s->data, s->cur_off) != 0)
        return false;
    s->torn = false;
    return true;
}

}  // namespace

extern "C" {

void* oplog_open(const char* dir) {
    if (!dir) return nullptr;
    mkdir(dir, 0755);  // EEXIST is fine
    auto* log = new OpLog();
    log->dir = dir;
    return log;
}

// Consumer-process handle: reads and tails topics another process
// writes; never creates or truncates files.
void* oplog_open_readonly(const char* dir) {
    if (!dir) return nullptr;
    auto* log = new OpLog();
    log->dir = dir;
    log->readonly = true;
    return log;
}

void oplog_close(void* handle) {
    auto* log = static_cast<OpLog*>(handle);
    if (!log) return;
    for (auto& kv : log->topics) {
        if (kv.second.data) fclose(kv.second.data);
        if (kv.second.index) fclose(kv.second.index);
    }
    for (auto& kv : log->segs) {
        if (kv.second.data) fclose(kv.second.data);
        if (kv.second.index) fclose(kv.second.index);
    }
    delete log;
}

// Segment roll threshold for every stream of this handle (testing knob;
// production leaves the 4 MiB default). Affects future appends only.
int oplog_seg_config(void* handle, int64_t seg_bytes) {
    auto* log = static_cast<OpLog*>(handle);
    if (!log || seg_bytes <= 0) return -1;
    std::lock_guard<std::mutex> lk(log->mu);
    log->seg_bytes = (uint64_t)seg_bytes;
    return 0;
}

// Append one column block spanning sequence numbers [first, last] to the
// segment stream; returns its block ordinal, or -1 on error. Rolls to a
// fresh segment file when the block would overflow the current one.
int64_t oplog_seg_append(void* handle, const char* stream, int64_t first,
                         int64_t last, const void* data, int64_t len,
                         int64_t btype) {
    auto* log = static_cast<OpLog*>(handle);
    if (!log || log->readonly || !stream || !data || len <= 0 ||
        (uint64_t)len > 0xffffffffu)
        return -1;
    std::lock_guard<std::mutex> lk(log->mu);
    SegStream* s = get_seg(log, stream);
    if (!s) return -1;
    if (s->torn && !seg_untear(s)) return -1;
    if (s->cur_off > 0 && s->cur_off + (uint64_t)len > log->seg_bytes) {
        // roll: "wb+" truncates any stale bytes a crashed roll left behind
        fclose(s->data);
        s->cur_seg += 1;
        s->cur_off = 0;
        s->data = fopen(seg_path(log, stream, s->cur_seg).c_str(), "wb+");
        if (!s->data) {
            log->open_files -= 1;  // the closed tail; index stays open
            return -1;
        }
    }
    fseek(s->data, 0, SEEK_END);
    if (fwrite(data, 1, (size_t)len, s->data) != (size_t)len) {
        fflush(s->data);
        truncate_file(s->data, s->cur_off);
        return -1;
    }
    SegEntry e;
    e.first_seq = first;
    e.last_seq = last;
    e.seg = s->cur_seg;
    e.off = (uint32_t)s->cur_off;
    e.len = (uint32_t)len;
    e.btype = (uint32_t)btype;
    fseek(s->index, 0, SEEK_END);
    if (fwrite(&e, sizeof(e), 1, s->index) != 1) {
        fflush(s->data);
        truncate_file(s->data, s->cur_off);
        return -1;
    }
    s->entries.push_back(e);
    s->cur_off += (uint64_t)len;
    s->dirty = true;
    s->unsynced = true;
    return (int64_t)s->entries.size() - 1;
}

int64_t oplog_seg_count(void* handle, const char* stream) {
    auto* log = static_cast<OpLog*>(handle);
    if (!log || !stream) return -1;
    std::lock_guard<std::mutex> lk(log->mu);
    SegStream* s = get_seg(log, stream);
    return s ? (int64_t)s->entries.size() : -1;
}

// Read block `ordinal`; same contract as oplog_read (returns the needed
// size when buflen is too small; -1 on bad args / unknown block). Cold
// path — the hot read path is the Python-side mmap of the segment files.
int64_t oplog_seg_read(void* handle, const char* stream, int64_t ordinal,
                       void* buf, int64_t buflen) {
    auto* log = static_cast<OpLog*>(handle);
    if (!log || !stream || ordinal < 0) return -1;
    std::lock_guard<std::mutex> lk(log->mu);
    SegStream* s = get_seg(log, stream);
    if (!s || (uint64_t)ordinal >= s->entries.size()) return -1;
    const SegEntry& e = s->entries[(size_t)ordinal];
    if ((int64_t)e.len > buflen) return (int64_t)e.len;
    if (s->data) fflush(s->data);
    FILE* f = fopen(seg_path(log, stream, e.seg).c_str(), "rb");
    if (!f) return -1;
    fseek(f, (long)e.off, SEEK_SET);
    bool ok = fread(buf, 1, e.len, f) == e.len;
    fclose(f);
    return ok ? (int64_t)e.len : -1;
}

// Block metadata for ordinal -> (first, last, seg, off, len, btype).
int oplog_seg_entry(void* handle, const char* stream, int64_t ordinal,
                    int64_t* first, int64_t* last, int64_t* seg, int64_t* off,
                    int64_t* len, int64_t* btype) {
    auto* log = static_cast<OpLog*>(handle);
    if (!log || !stream || ordinal < 0) return -1;
    std::lock_guard<std::mutex> lk(log->mu);
    SegStream* s = get_seg(log, stream);
    if (!s || (uint64_t)ordinal >= s->entries.size()) return -1;
    const SegEntry& e = s->entries[(size_t)ordinal];
    if (first) *first = e.first_seq;
    if (last) *last = e.last_seq;
    if (seg) *seg = (int64_t)e.seg;
    if (off) *off = (int64_t)e.off;
    if (len) *len = (int64_t)e.len;
    if (btype) *btype = (int64_t)e.btype;
    return 0;
}

// Tail the stream for blocks appended by ANOTHER process; admits only
// complete entries whose block bytes fully landed (cf. oplog_refresh).
int64_t oplog_seg_refresh(void* handle, const char* stream) {
    auto* log = static_cast<OpLog*>(handle);
    if (!log || !stream) return -1;
    std::lock_guard<std::mutex> lk(log->mu);
    SegStream* s = get_seg(log, stream);
    if (!s) return -1;
    fseek(s->index, 0, SEEK_END);
    uint64_t index_bytes = (uint64_t)ftell(s->index);
    size_t disk_n = (size_t)(index_bytes / sizeof(SegEntry));
    size_t have = s->entries.size();
    if (disk_n <= have) return (int64_t)have;
    fseek(s->index, (long)(have * sizeof(SegEntry)), SEEK_SET);
    SegEntry e;
    uint32_t sized_seg = 0;
    uint64_t sized_bytes = 0;
    bool sized = false;
    while (s->entries.size() < disk_n &&
           fread(&e, sizeof(e), 1, s->index) == 1) {
        if (!sized || e.seg != sized_seg) {
            sized_seg = e.seg;
            sized_bytes = seg_file_size(log, stream, e.seg);
            sized = true;
        }
        if ((uint64_t)e.off + e.len > sized_bytes) break;  // mid-write tail
        s->entries.push_back(e);
        s->cur_seg = e.seg;
        s->cur_off = (uint64_t)e.off + e.len;
    }
    return (int64_t)s->entries.size();
}

// Chaos-plane seam: leave a deliberately torn tail on disk, exactly the
// residue of a crash mid-append, WITHOUT admitting the block.
//   mode 0: half the block bytes land, no index entry (crash mid-block)
//   mode 1: all block bytes land, half an index entry (crash mid-index)
// The stream stays usable: the next append (or a reopen) runs the
// torn-tail scan and cuts the residue before writing.
int oplog_seg_tear(void* handle, const char* stream, int64_t first,
                   int64_t last, const void* data, int64_t len, int64_t btype,
                   int64_t mode) {
    auto* log = static_cast<OpLog*>(handle);
    if (!log || log->readonly || !stream || !data || len <= 0 ||
        (uint64_t)len > 0xffffffffu)
        return -1;
    std::lock_guard<std::mutex> lk(log->mu);
    SegStream* s = get_seg(log, stream);
    if (!s) return -1;
    if (s->torn && !seg_untear(s)) return -1;
    if (s->cur_off > 0 && s->cur_off + (uint64_t)len > log->seg_bytes) {
        fclose(s->data);
        s->cur_seg += 1;
        s->cur_off = 0;
        s->data = fopen(seg_path(log, stream, s->cur_seg).c_str(), "wb+");
        if (!s->data) {
            log->open_files -= 1;  // the closed tail; index stays open
            return -1;
        }
    }
    size_t nbytes = mode == 0 ? (size_t)(len / 2 ? len / 2 : 1) : (size_t)len;
    fseek(s->data, 0, SEEK_END);
    if (fwrite(data, 1, nbytes, s->data) != nbytes) return -1;
    if (mode != 0) {
        SegEntry e;
        e.first_seq = first;
        e.last_seq = last;
        e.seg = s->cur_seg;
        e.off = (uint32_t)s->cur_off;
        e.len = (uint32_t)len;
        e.btype = (uint32_t)btype;
        fseek(s->index, 0, SEEK_END);
        if (fwrite(&e, 1, sizeof(e) / 2, s->index) != sizeof(e) / 2)
            return -1;
    }
    // flush so the residue is really on disk for a reopen to find
    fflush(s->data);
    fflush(s->index);
    s->torn = true;
    return 0;
}

// Append one record; returns its offset (record ordinal), or -1 on error.
int64_t oplog_append(void* handle, const char* topic, const void* data,
                     int64_t len) {
    auto* log = static_cast<OpLog*>(handle);
    if (!log || !topic || (!data && len > 0) || len < 0) return -1;
    std::lock_guard<std::mutex> lk(log->mu);
    Topic* t = get_topic(log, topic);
    if (!t) return -1;
    uint64_t record_start = t->data_end;
    uint32_t len32 = (uint32_t)len;
    fseek(t->data, 0, SEEK_END);
    bool ok = fwrite(&len32, sizeof(len32), 1, t->data) == 1 &&
              (len == 0 || fwrite(data, 1, (size_t)len, t->data) == (size_t)len);
    if (ok) {
        fseek(t->index, 0, SEEK_END);
        ok = fwrite(&record_start, sizeof(record_start), 1, t->index) == 1;
    }
    if (!ok) {
        // roll the data file back to the last valid extent, or the next
        // append would index a record that starts inside garbage bytes
        fflush(t->data);
        truncate_file(t->data, t->data_end);  // portable rollback
        fseek(t->data, 0, SEEK_END);
        return -1;
    }
    t->data_end = record_start + sizeof(len32) + (uint64_t)len;
    t->offsets.push_back(record_start);
    t->dirty = true;
    t->unsynced = true;
    return (int64_t)t->offsets.size() - 1;
}

int64_t oplog_length(void* handle, const char* topic) {
    auto* log = static_cast<OpLog*>(handle);
    if (!log || !topic) return -1;
    std::lock_guard<std::mutex> lk(log->mu);
    Topic* t = get_topic(log, topic);
    return t ? (int64_t)t->offsets.size() : -1;
}

// Read record `offset`; returns record length. If it exceeds buflen the
// buffer is untouched and the needed size is returned (call again).
// Returns -1 on bad args / unknown record.
int64_t oplog_read(void* handle, const char* topic, int64_t offset, void* buf,
                   int64_t buflen) {
    auto* log = static_cast<OpLog*>(handle);
    if (!log || !topic || offset < 0) return -1;
    std::lock_guard<std::mutex> lk(log->mu);
    Topic* t = get_topic(log, topic);
    if (!t || (uint64_t)offset >= t->offsets.size()) return -1;
    uint64_t start = t->offsets[(size_t)offset];
    uint32_t len = 0;
    fflush(t->data);
    fseek(t->data, (long)start, SEEK_SET);
    if (fread(&len, sizeof(len), 1, t->data) != 1) return -1;
    if ((int64_t)len > buflen) return (int64_t)len;
    if (len > 0 && fread(buf, 1, len, t->data) != len) return -1;
    return (int64_t)len;
}

// Push buffered appends into the OS page cache (fflush, no fsync) so a
// CONSUMER PROCESS sharing the directory can see them via oplog_refresh.
// The per-stage process composition (service/stage_runner.py) flushes at
// drain-batch boundaries: visibility, not durability — durability stays
// on oplog_sync at checkpoint boundaries.
int oplog_flush(void* handle) {
    auto* log = static_cast<OpLog*>(handle);
    if (!log) return -1;
    std::lock_guard<std::mutex> lk(log->mu);
    for (auto& kv : log->topics) {
        if (!kv.second.dirty || !kv.second.data) continue;  // O(appended)
        fflush(kv.second.data);
        fflush(kv.second.index);
        kv.second.dirty = false;
    }
    for (auto& kv : log->segs) {
        if (!kv.second.dirty || !kv.second.index) continue;
        // block bytes before index entry: a reader that sees the entry
        // must find the bytes (mmap validation re-checks anyway)
        if (kv.second.data) fflush(kv.second.data);
        fflush(kv.second.index);
        kv.second.dirty = false;
    }
    return 0;
}

// Re-scan the on-disk index tail for records appended by ANOTHER process
// sharing this directory; returns the refreshed record count (or -1).
// Only COMPLETE records (index entry present AND the data extent covers
// the whole record) are admitted — a record mid-write by the producer
// stays invisible until its bytes land, so tailing never sees a torn
// record. Unlike recovery, nothing is truncated here.
int64_t oplog_refresh(void* handle, const char* topic) {
    auto* log = static_cast<OpLog*>(handle);
    if (!log || !topic) return -1;
    std::lock_guard<std::mutex> lk(log->mu);
    Topic* t = get_topic(log, topic);
    if (!t) return -1;
    fseek(t->index, 0, SEEK_END);
    uint64_t index_bytes = (uint64_t)ftell(t->index);
    size_t disk_n = (size_t)(index_bytes / sizeof(uint64_t));
    size_t have = t->offsets.size();
    if (disk_n <= have) return (int64_t)have;
    fseek(t->data, 0, SEEK_END);
    uint64_t data_bytes = (uint64_t)ftell(t->data);
    fseek(t->index, (long)(have * sizeof(uint64_t)), SEEK_SET);
    uint64_t off;
    uint64_t new_end = t->data_end;
    while (t->offsets.size() < disk_n &&
           fread(&off, sizeof(off), 1, t->index) == 1) {
        uint32_t len = 0;
        if (off + sizeof(len) > data_bytes) break;
        fseek(t->data, (long)off, SEEK_SET);
        if (fread(&len, sizeof(len), 1, t->data) != 1) break;
        if (off + sizeof(len) + len > data_bytes) break;
        t->offsets.push_back(off);
        new_end = off + sizeof(len) + (uint64_t)len;
    }
    if (new_end > t->data_end) t->data_end = new_end;
    return (int64_t)t->offsets.size();
}

// Make everything appended so far durable (fflush + fsync).
int oplog_sync(void* handle) {
    auto* log = static_cast<OpLog*>(handle);
    if (!log) return -1;
    std::lock_guard<std::mutex> lk(log->mu);
    for (auto& kv : log->topics) {
        if (!kv.second.data) continue;  // evicted: covered below
        fflush(kv.second.data);
        fflush(kv.second.index);
#ifndef _WIN32
        fsync(fileno(kv.second.data));
        fsync(fileno(kv.second.index));
#endif
        kv.second.unsynced = false;
    }
    for (auto& kv : log->segs) {
        if (!kv.second.index) continue;  // evicted: covered below
        if (kv.second.data) fflush(kv.second.data);
        fflush(kv.second.index);
#ifndef _WIN32
        if (kv.second.data) fsync(fileno(kv.second.data));
        fsync(fileno(kv.second.index));
#endif
        kv.second.unsynced = false;
    }
    // files whose handles were LRU-evicted after un-fsync'd appends:
    // already in the page cache (eviction flushed), so a brief
    // open+fsync+close keeps the durability contract whole
    for (const std::string& path : log->evicted_unsynced) {
        FILE* f = fopen(path.c_str(), "rb");
        if (!f) continue;  // e.g. a rolled-away tail segment
#ifndef _WIN32
        fsync(fileno(f));
#endif
        fclose(f);
    }
    log->evicted_unsynced.clear();
    return 0;
}

// Cap on concurrently open FILE*s across this handle's topics and
// segment streams (0 = unlimited). Metadata stays resident; cold
// handles are flushed, closed, and reopened on demand.
int oplog_fd_cap(void* handle, int64_t cap) {
    auto* log = static_cast<OpLog*>(handle);
    if (!log || cap < 0) return -1;
    std::lock_guard<std::mutex> lk(log->mu);
    log->fd_cap = (uint64_t)cap;
    evict_excess(log);
    return 0;
}

// Currently open FILE*s (introspection for tests and fd budgeting).
int64_t oplog_open_files(void* handle) {
    auto* log = static_cast<OpLog*>(handle);
    if (!log) return -1;
    std::lock_guard<std::mutex> lk(log->mu);
    return (int64_t)log->open_files;
}

}  // extern "C"
