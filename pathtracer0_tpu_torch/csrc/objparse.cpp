// Wavefront OBJ tokenizer of the PyTorch/CUDA port (its own copy of the
// JAX package's native/objparse.cpp, the same bytes past this comment).
//
// The reference's data loader is scene.parseObj (dispatch.java:888-1003),
// a line-by-line Java parser; the port's Python equivalent
// (scene/objparse.py) is exact but slow at the reference's 4M-triangle
// scale (dispatch.java:1798). This tokenizer does the byte crunching in
// C++ (two passes: count, then fill caller-allocated arrays) and leaves
// ALL semantics (vertex transforms, flat-normal fallback,
// usemtl-by-name+parentDir lookup, object ranges) to
// scene/native_obj.py, which consumes the arrays vectorized.
//
// A plain C interface loaded with ctypes; built with g++ at first use by
// kernels/build.py (HOST_LIBS "objparse"), into a temporary file that is
// then renamed, so concurrent builds never load a half-written library.
//
// Faces are emitted as triangles from their first three vertices, exactly
// like the reference (dispatch.java:961 -- quads lose their 4th vertex).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

struct Cursor {
    const char* p;
    const char* end;
};

inline void skip_ws(Cursor& c) {
    while (c.p < c.end && (*c.p == ' ' || *c.p == '\t' || *c.p == '\r'))
        ++c.p;
}

inline void skip_line(Cursor& c) {
    while (c.p < c.end && *c.p != '\n') ++c.p;
    if (c.p < c.end) ++c.p;
}

inline double parse_double(Cursor& c) {
    char* out = nullptr;
    double v = strtod(c.p, &out);
    c.p = out;
    return v;
}

inline long parse_int(Cursor& c) {
    char* out = nullptr;
    long v = strtol(c.p, &out, 10);
    c.p = out;
    return v;
}

// Parse one face vertex "v", "v/vt", "v//vn", "v/vt/vn". OBJ indices are
// 1-based; negative indices are relative to the current count. Returns
// 0-based indices or -1.
inline void parse_face_vert(Cursor& c, long nv, long nvt, long nvn,
                            int32_t* vi, int32_t* ti, int32_t* ni) {
    long v = parse_int(c);
    *vi = (int32_t)(v > 0 ? v - 1 : (v < 0 ? nv + v : -1));
    *ti = -1;
    *ni = -1;
    if (c.p < c.end && *c.p == '/') {
        ++c.p;
        if (c.p < c.end && *c.p != '/' && *c.p != ' ' && *c.p != '\n') {
            long t = parse_int(c);
            *ti = (int32_t)(t > 0 ? t - 1 : (t < 0 ? nvt + t : -1));
        }
        if (c.p < c.end && *c.p == '/') {
            ++c.p;
            long n = parse_int(c);
            *ni = (int32_t)(n > 0 ? n - 1 : (n < 0 ? nvn + n : -1));
        }
    }
}

inline bool starts(const Cursor& c, const char* s, size_t n) {
    return (size_t)(c.end - c.p) > n && memcmp(c.p, s, n) == 0;
}

}  // namespace

extern "C" {

// Pass 1: count records. Returns 0 on success.
//   out[0]=n_verts out[1]=n_uvs out[2]=n_norms out[3]=n_faces
//   out[4]=n_name_events (o/g/usemtl) out[5]=name_bytes (incl. NULs)
int pt0_obj_count(const char* data, int64_t len, int64_t* out) {
    Cursor c{data, data + len};
    int64_t nv = 0, nvt = 0, nvn = 0, nf = 0, nev = 0, nbytes = 0;
    while (c.p < c.end) {
        skip_ws(c);
        if (starts(c, "v ", 2)) ++nv;
        else if (starts(c, "vt ", 3)) ++nvt;
        else if (starts(c, "vn ", 3)) ++nvn;
        else if (starts(c, "f ", 2)) ++nf;
        else if (starts(c, "o ", 2) || starts(c, "g ", 2) ||
                 starts(c, "usemtl ", 7)) {
            ++nev;
            const char* q = c.p;
            while (q < c.end && *q != '\n' && *q != '\r') ++q;
            nbytes += (q - c.p) + 1;
        }
        skip_line(c);
    }
    out[0] = nv; out[1] = nvt; out[2] = nvn; out[3] = nf;
    out[4] = nev; out[5] = nbytes;
    return 0;
}

// Pass 2: fill caller-allocated arrays.
//   verts (nv,3) f64; uvs (nvt,2) f64; norms (nvn,3) f64
//   faces (nf,9) i32: v1 vt1 vn1 v2 vt2 vn2 v3 vt3 vn3 (-1 = absent)
//   ev_face (nev) i32: face index at which the event takes effect
//   ev_kind (nev) i32: 0 = o/g (new object), 1 = usemtl
//   names: 'kind-stripped' event payload lines, NUL-separated
int pt0_obj_fill(const char* data, int64_t len,
                 double* verts, double* uvs, double* norms,
                 int32_t* faces, int32_t* ev_face, int32_t* ev_kind,
                 char* names) {
    Cursor c{data, data + len};
    int64_t nv = 0, nvt = 0, nvn = 0, nf = 0, nev = 0;
    char* np_ = names;
    while (c.p < c.end) {
        skip_ws(c);
        if (starts(c, "v ", 2)) {
            c.p += 2;
            double* o = verts + 3 * nv;
            o[0] = parse_double(c);
            o[1] = parse_double(c);
            o[2] = parse_double(c);
            ++nv;
        } else if (starts(c, "vt ", 3)) {
            c.p += 3;
            double* o = uvs + 2 * nvt;
            o[0] = parse_double(c);
            o[1] = parse_double(c);
            ++nvt;
        } else if (starts(c, "vn ", 3)) {
            c.p += 3;
            double* o = norms + 3 * nvn;
            o[0] = parse_double(c);
            o[1] = parse_double(c);
            o[2] = parse_double(c);
            ++nvn;
        } else if (starts(c, "f ", 2)) {
            c.p += 2;
            int32_t* o = faces + 9 * nf;
            for (int k = 0; k < 3; ++k) {
                skip_ws(c);
                parse_face_vert(c, nv, nvt, nvn, o + 3 * k, o + 3 * k + 1,
                                o + 3 * k + 2);
            }
            ++nf;
        } else if (starts(c, "o ", 2) || starts(c, "g ", 2) ||
                   starts(c, "usemtl ", 7)) {
            int kind = (*c.p == 'u') ? 1 : 0;
            c.p += (kind ? 7 : 2);
            skip_ws(c);
            ev_face[nev] = (int32_t)nf;
            ev_kind[nev] = kind;
            while (c.p < c.end && *c.p != '\n' && *c.p != '\r')
                *np_++ = *c.p++;
            *np_++ = '\0';
            ++nev;
        }
        skip_line(c);
    }
    return 0;
}

}  // extern "C"
