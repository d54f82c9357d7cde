// Content-addressed chunk store — the libgit2-role component.
//
// The port's copy of the JAX package's native/chunkstore.cpp (same C ABI,
// same on-disk layout, so either package reads a directory the other
// wrote). Built with g++ by fluidframework_tpu_torch/native/build.py.
//
// Ref role: nodegit/libgit2 gives the reference hash-addressed snapshot
// storage (git blobs/trees behind gitrest, SURVEY §2.9). Here: SHA-256
// addressed blobs fanned out over <dir>/<h[0:2]>/<h[2:]> exactly like
// .git/objects, with writes going through a temp file + rename so a
// crash never leaves a corrupt object. Dedup falls out of content
// addressing: an existing object is never rewritten.
//
// Self-contained SHA-256 (public-domain-style reference structure), no
// external deps. C ABI for ctypes.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <sys/stat.h>
#ifndef _WIN32
#include <unistd.h>
#endif

namespace {

// ------------------------------------------------------------- sha-256
struct Sha256 {
    uint32_t h[8];
    uint64_t len = 0;
    uint8_t buf[64];
    size_t buflen = 0;

    Sha256() {
        static const uint32_t init[8] = {
            0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
            0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
        memcpy(h, init, sizeof(h));
    }

    static uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

    void block(const uint8_t* p) {
        static const uint32_t K[64] = {
            0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b,
            0x59f111f1, 0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01,
            0x243185be, 0x550c7dc3, 0x72be5d74, 0x80deb1fe, 0x9bdc06a7,
            0xc19bf174, 0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
            0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da, 0x983e5152,
            0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
            0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc,
            0x53380d13, 0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
            0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3, 0xd192e819,
            0xd6990624, 0xf40e3585, 0x106aa070, 0x19a4c116, 0x1e376c08,
            0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f,
            0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
            0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};
        uint32_t w[64];
        for (int i = 0; i < 16; i++)
            w[i] = (uint32_t(p[i * 4]) << 24) | (uint32_t(p[i * 4 + 1]) << 16) |
                   (uint32_t(p[i * 4 + 2]) << 8) | uint32_t(p[i * 4 + 3]);
        for (int i = 16; i < 64; i++) {
            uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
            uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
            w[i] = w[i - 16] + s0 + w[i - 7] + s1;
        }
        uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
                 g = h[6], hh = h[7];
        for (int i = 0; i < 64; i++) {
            uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
            uint32_t ch = (e & f) ^ (~e & g);
            uint32_t t1 = hh + S1 + ch + K[i] + w[i];
            uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
            uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
            uint32_t t2 = S0 + maj;
            hh = g; g = f; f = e; e = d + t1;
            d = c; c = b; b = a; a = t1 + t2;
        }
        h[0] += a; h[1] += b; h[2] += c; h[3] += d;
        h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
    }

    void update(const uint8_t* p, size_t n) {
        len += n;
        while (n > 0) {
            size_t take = 64 - buflen < n ? 64 - buflen : n;
            memcpy(buf + buflen, p, take);
            buflen += take; p += take; n -= take;
            if (buflen == 64) { block(buf); buflen = 0; }
        }
    }

    void final_hex(char out[65]) {
        uint64_t bits = len * 8;
        uint8_t pad = 0x80;
        update(&pad, 1);
        uint8_t zero = 0;
        while (buflen != 56) update(&zero, 1);
        uint8_t lenb[8];
        for (int i = 0; i < 8; i++) lenb[i] = (uint8_t)(bits >> (56 - 8 * i));
        update(lenb, 8);
        static const char* hex = "0123456789abcdef";
        for (int i = 0; i < 8; i++)
            for (int j = 0; j < 4; j++) {
                uint8_t byte = (uint8_t)(h[i] >> (24 - 8 * j));
                out[i * 8 + j * 2] = hex[byte >> 4];
                out[i * 8 + j * 2 + 1] = hex[byte & 0xf];
            }
        out[64] = 0;
    }
};

struct Store {
    std::string dir;
};

bool valid_hash(const char* hash) {
    for (int i = 0; i < 64; i++) {
        char c = hash[i];
        if (!((c >= '0' && c <= '9') || (c >= 'a' && c <= 'f'))) return false;
    }
    return hash[64] == 0;
}

std::string object_path(const Store* s, const char* hash) {
    return s->dir + "/" + std::string(hash, 2) + "/" + std::string(hash + 2);
}

}  // namespace

extern "C" {

void* cas_open(const char* dir) {
    if (!dir) return nullptr;
    mkdir(dir, 0755);
    auto* s = new Store();
    s->dir = dir;
    return s;
}

void cas_close(void* handle) { delete static_cast<Store*>(handle); }

// Store a blob; writes its 64-hex-char sha256 into hash_out (65 bytes).
// Dedup: existing objects are not rewritten. Returns 0, or -1 on error.
int cas_put(void* handle, const void* data, int64_t len, char* hash_out) {
    auto* s = static_cast<Store*>(handle);
    if (!s || (!data && len > 0) || len < 0 || !hash_out) return -1;
    Sha256 sha;
    sha.update(static_cast<const uint8_t*>(data), (size_t)len);
    sha.final_hex(hash_out);

    std::string path = object_path(s, hash_out);
    struct stat st;
    if (stat(path.c_str(), &st) == 0) return 0;  // dedup hit

    std::string fan = s->dir + "/" + std::string(hash_out, 2);
    mkdir(fan.c_str(), 0755);
    std::string tmp = path + ".tmp";
    FILE* f = fopen(tmp.c_str(), "wb");
    if (!f) return -1;
    if (len > 0 && fwrite(data, 1, (size_t)len, f) != (size_t)len) {
        fclose(f);
        remove(tmp.c_str());
        return -1;
    }
    fflush(f);
#ifndef _WIN32
    fsync(fileno(f));
#endif
    fclose(f);
    if (rename(tmp.c_str(), path.c_str()) != 0) {
        remove(tmp.c_str());
        return -1;
    }
    return 0;
}

// Read a blob; returns its length. If it exceeds buflen the buffer is
// untouched and the needed size is returned. -1 if absent/bad hash.
int64_t cas_get(void* handle, const char* hash, void* buf, int64_t buflen) {
    auto* s = static_cast<Store*>(handle);
    if (!s || !hash || !valid_hash(hash)) return -1;
    FILE* f = fopen(object_path(s, hash).c_str(), "rb");
    if (!f) return -1;
    fseek(f, 0, SEEK_END);
    int64_t len = (int64_t)ftell(f);
    if (len > buflen) { fclose(f); return len; }
    fseek(f, 0, SEEK_SET);
    if (len > 0 && fread(buf, 1, (size_t)len, f) != (size_t)len) {
        fclose(f);
        return -1;
    }
    fclose(f);
    return len;
}

int cas_has(void* handle, const char* hash) {
    auto* s = static_cast<Store*>(handle);
    if (!s || !hash || !valid_hash(hash)) return 0;
    struct stat st;
    return stat(object_path(s, hash).c_str(), &st) == 0 ? 1 : 0;
}

}  // extern "C"
