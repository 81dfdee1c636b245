// Native runtime support library for mitsubaer_tpu.
//
// Array-program analogue of the reference's C++ data-loading layer:
// OBJ/PLY mesh parsing (src/shapes/{obj,ply}.cpp) and Mitsuba VOL3 grid
// loading (src/volume/gridvolume.cpp incl. its mmap usage, libcore/mmap.cpp).
// Python binds via ctypes (mitsubaer_tpu/native/__init__.py); the pure-Python
// parsers in utils/io.py remain as fallback.
//
// Build: g++ -O3 -march=native -shared -fPIC mernative.cpp -o libmernative.so

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstdint>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct MappedFile {
    const char* data = nullptr;
    size_t size = 0;
    int fd = -1;
    bool ok() const { return data != nullptr; }
    explicit MappedFile(const char* path) {
        fd = open(path, O_RDONLY);
        if (fd < 0) return;
        struct stat st;
        if (fstat(fd, &st) != 0 || st.st_size == 0) { close(fd); fd = -1; return; }
        size = (size_t)st.st_size;
        void* p = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
        if (p == MAP_FAILED) { close(fd); fd = -1; return; }
        data = (const char*)p;
    }
    ~MappedFile() {
        if (data) munmap((void*)data, size);
        if (fd >= 0) close(fd);
    }
};

inline const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    return p;
}

inline const char* next_line(const char* p, const char* end) {
    while (p < end && *p != '\n') ++p;
    return p < end ? p + 1 : end;
}

inline const char* parse_float(const char* p, const char* end, float* out) {
    char* q;
    *out = strtof(p, &q);
    (void)end;
    return q;
}

inline const char* parse_int(const char* p, const char* end, long* out) {
    char* q;
    *out = strtol(p, &q, 10);
    (void)end;
    return q;
}

struct ObjData {
    std::vector<float> verts;   // xyz triples
    std::vector<int32_t> tris;  // index triples (0-based)
};

bool parse_obj_impl(const char* path, ObjData& out) {
    MappedFile mf(path);
    if (!mf.ok()) return false;
    const char* p = mf.data;
    const char* end = mf.data + mf.size;
    std::vector<long> face;
    face.reserve(8);
    while (p < end) {
        p = skip_ws(p, end);
        if (p + 1 < end && p[0] == 'v' && (p[1] == ' ' || p[1] == '\t')) {
            p += 2;
            float x, y, z;
            p = parse_float(p, end, &x);
            p = parse_float(p, end, &y);
            p = parse_float(p, end, &z);
            out.verts.push_back(x);
            out.verts.push_back(y);
            out.verts.push_back(z);
        } else if (p < end && p[0] == 'f' && p + 1 < end && (p[1] == ' ' || p[1] == '\t')) {
            p += 2;
            face.clear();
            while (p < end && *p != '\n') {
                p = skip_ws(p, end);
                if (p >= end || *p == '\n' || *p == '\r') break;
                long idx;
                p = parse_int(p, end, &idx);
                // skip /vt/vn suffixes
                while (p < end && *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r') ++p;
                long nv = (long)(out.verts.size() / 3);
                face.push_back(idx > 0 ? idx - 1 : nv + idx);
            }
            for (size_t k = 2; k < face.size(); ++k) {
                out.tris.push_back((int32_t)face[0]);
                out.tris.push_back((int32_t)face[k - 1]);
                out.tris.push_back((int32_t)face[k]);
            }
        }
        p = next_line(p, end);
    }
    return true;
}

}  // namespace

extern "C" {

// Two-phase API: parse once into a handle, copy out, free.
void* obj_parse(const char* path, int64_t* n_verts, int64_t* n_tris) {
    auto* d = new ObjData();
    if (!parse_obj_impl(path, *d)) {
        delete d;
        *n_verts = -1;
        *n_tris = -1;
        return nullptr;
    }
    *n_verts = (int64_t)(d->verts.size() / 3);
    *n_tris = (int64_t)(d->tris.size() / 3);
    return d;
}

void obj_copy(void* handle, float* verts_out, int32_t* tris_out) {
    auto* d = (ObjData*)handle;
    memcpy(verts_out, d->verts.data(), d->verts.size() * sizeof(float));
    memcpy(tris_out, d->tris.data(), d->tris.size() * sizeof(int32_t));
}

void obj_free(void* handle) { delete (ObjData*)handle; }

// VOL3 header probe: returns 0 on success, fills dims/channels/bbox.
int vol_header(const char* path, int32_t* enc, int32_t* dims3,
               int32_t* channels, float* bbox6) {
    MappedFile mf(path);
    if (!mf.ok() || mf.size < 48) return 1;
    if (memcmp(mf.data, "VOL", 3) != 0 || mf.data[3] != 3) return 2;
    memcpy(enc, mf.data + 4, 4);
    memcpy(dims3, mf.data + 8, 12);
    memcpy(channels, mf.data + 20, 4);
    memcpy(bbox6, mf.data + 24, 24);
    return 0;
}

// Bulk VOL3 payload read (float32 output regardless of encoding).
int vol_read(const char* path, float* out, int64_t capacity) {
    MappedFile mf(path);
    if (!mf.ok() || mf.size < 48) return 1;
    int32_t enc, dims[3], ch;
    memcpy(&enc, mf.data + 4, 4);
    memcpy(dims, mf.data + 8, 12);
    memcpy(&ch, mf.data + 20, 4);
    int64_t n = (int64_t)dims[0] * dims[1] * dims[2] * ch;
    if (n > capacity) return 3;
    const char* payload = mf.data + 48;
    if (enc == 1) {
        if (mf.size < 48 + (size_t)n * 4) return 4;
        memcpy(out, payload, (size_t)n * 4);
    } else if (enc == 2) {
        if (mf.size < 48 + (size_t)n * 2) return 4;
        const uint16_t* h = (const uint16_t*)payload;
        for (int64_t i = 0; i < n; ++i) {
            // half -> float
            uint16_t x = h[i];
            uint32_t sign = (uint32_t)(x >> 15) << 31;
            uint32_t exp = (x >> 10) & 0x1F;
            uint32_t man = x & 0x3FF;
            uint32_t f;
            if (exp == 0) {
                if (man == 0) f = sign;
                else {
                    exp = 127 - 15 + 1;
                    while (!(man & 0x400)) { man <<= 1; --exp; }
                    man &= 0x3FF;
                    f = sign | (exp << 23) | (man << 13);
                }
            } else if (exp == 31) {
                f = sign | 0x7F800000u | (man << 13);
            } else {
                f = sign | ((exp - 15 + 127) << 23) | (man << 13);
            }
            memcpy(out + i, &f, 4);
        }
    } else if (enc == 3) {
        if (mf.size < 48 + (size_t)n) return 4;
        const uint8_t* b = (const uint8_t*)payload;
        for (int64_t i = 0; i < n; ++i) out[i] = b[i] / 255.0f;
    } else {
        return 5;
    }
    return 0;
}

}  // extern "C"
