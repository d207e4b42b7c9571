// Per-ray functions of the path tracer, for the frame kernel
// (frame_kernel.cu) and the block kernel (block_kernel.cu) through
// integrate.cuh. Everything here is __host__ __device__ and mirrors
// the plain PyTorch version operation for operation:
//   RNG                core/rng.py
//   bilinear, sky      scene/texture.py
//   implicit_f, march  shade/implicits.py
//   choose_ray         shade/bsdf.py
//   closest_hit        render/integrator.py closest_hit (triangle_loop,
//                      then finish_hit: traverse.py's merge and
//                      surface_sample)
// Build without --use_fast_math and with -fmad=false: a contracted
// multiply-add flips knife-edge comparisons against the plain version.
#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define PT_HD __host__ __device__ __forceinline__
#define PT_HDC __host__ __device__
#else
#define PT_HD inline
#define PT_HDC
#endif

namespace pt {

constexpr float MISS = 1e30f;
constexpr float HIT_T = 1e25f;
constexpr float EPSILON = 1e-10f;   // frag.glsl:228
constexpr float AIR_IOR = 1.0029f;  // frag.glsl:816
constexpr float NUDGE = 1e-4f;      // frag.glsl:549
constexpr float GRAD_H = 1e-4f;
constexpr float INV32 = 1.0f / 4294967295.0f;  // frag.glsl:693
constexpr float TWO_PI = (float)(2.0 * 3.1415926);
constexpr float SKY_U_DIV = (float)(2.0 * 3.14159);
constexpr float SKY_V_DIV = (float)(3.14159);
constexpr int MAX_STACK = 16;
constexpr int N_MAP_CH = 9;
// columns of the (M, 9) material -> atlas slot table (scene/packing.py
// MAP_CHANNELS)
enum { MAP_KA, MAP_KD, MAP_KS, MAP_KE, MAP_TR, MAP_PM, MAP_PR, MAP_PC,
       MAP_NORM };

// ---- PHASES: clock64() cycles of the parts of a scene query, per warp ----
// (check-only instantiations of the frame kernel; never on the main path).
// The lowest lane of the lanes that run a part together adds the part's
// cycles once for them.
enum { PH_TRI, PH_IMP, PH_ELL, PH_DECODE, PH_SKY, PH_CHOOSE, PH_WARP, N_PHASES };
PT_HD long long tick() {
#ifdef __CUDA_ARCH__
  return clock64();
#else
  return 0;
#endif
}
PT_HD void tock(unsigned long long* cyc, int k, long long t0) {
#ifdef __CUDA_ARCH__
  const long long dt = clock64() - t0;
  const unsigned mask = __activemask();
  if ((threadIdx.x & 31) == __ffs(mask) - 1) cyc[k] += (unsigned long long)dt;
#endif
}

// A read of memory no thread of the launch writes, through the read-only
// cache on the card.
template <class T>
PT_HD T ld_ro(const T* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// Row k of an (N, 10) float table (the triangles' attributes and UVs), for
// finish_hit's ROWS8: on the card a table on an 8-byte boundary (every row
// then is) is read in five 8-byte loads through the read-only cache, in ten
// 4-byte ones else.
struct Row10 {
  float f[10];
};
PT_HD Row10 row10(const float* table, int k) {
  Row10 out;
  const float* p = table + 10 * (size_t)k;
#ifdef __CUDA_ARCH__
  if ((reinterpret_cast<uintptr_t>(table) & 7) == 0) {
    const float2* q = reinterpret_cast<const float2*>(p);
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const float2 v = __ldg(q + i);
      out.f[2 * i] = v.x;
      out.f[2 * i + 1] = v.y;
    }
    return out;
  }
#endif
#pragma unroll
  for (int i = 0; i < 10; ++i) out.f[i] = ld_ro(p + i);
  return out;
}

// ---- small float helpers that propagate NaN like torch ----------------
PT_HD float nan_max(float a, float b) { return (a != a || a > b) ? a : b; }
PT_HD float nan_min(float a, float b) { return (a != a || a < b) ? a : b; }
PT_HD float clamp_pm1(float x) { return x < -1.0f ? -1.0f : (x > 1.0f ? 1.0f : x); }

struct V3 { float x, y, z; };
PT_HD V3 v3(float x, float y, float z) { return V3{x, y, z}; }
PT_HD float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
PT_HD V3 unit(V3 a) {
  float m = sqrtf(dot(a, a));
  return v3(a.x / m, a.y / m, a.z / m);
}
PT_HD V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
// R v and R^T v for a row-major 3x3 matrix
PT_HD V3 mul_r(const float* r, V3 v) {
  return v3(r[0] * v.x + r[1] * v.y + r[2] * v.z,
            r[3] * v.x + r[4] * v.y + r[5] * v.z,
            r[6] * v.x + r[7] * v.y + r[8] * v.z);
}
PT_HD V3 mul_rt(const float* r, V3 v) {
  return v3(r[0] * v.x + r[3] * v.y + r[6] * v.z,
            r[1] * v.x + r[4] * v.y + r[7] * v.z,
            r[2] * v.x + r[5] * v.y + r[8] * v.z);
}

// ---- RNG (frag.glsl:683-701) ------------------------------------------
struct Affine { uint32_t a, c; };
PT_HDC constexpr Affine affine(int n) {
  uint64_t a = 1, c = 0, mul = 747796405u, inc = 2891336453u;
  for (int k = n; k; k >>= 1) {
    if (k & 1) {
      a = (a * mul) & 0xFFFFFFFFu;
      c = (c * mul + inc) & 0xFFFFFFFFu;
    }
    inc = ((mul + 1) * inc) & 0xFFFFFFFFu;
    mul = (mul * mul) & 0xFFFFFFFFu;
  }
  return Affine{(uint32_t)a, (uint32_t)c};
}
template <int N>
PT_HD uint32_t advance(uint32_t s) {
  constexpr Affine k = affine(N);
  return s * k.a + k.c;
}
PT_HD uint32_t extract(uint32_t s) {
  uint32_t shift = (s >> 28) + 4u;
  uint32_t r = ((s >> shift) ^ s) * 277803737u;
  return (r >> 22) ^ r;
}
PT_HD float u32_to_f32(uint32_t b) {
#ifdef __CUDA_ARCH__
  return __uint2float_rn(b);
#else
  return (float)b;
#endif
}
template <int N>
PT_HD float peek(uint32_t s) { return u32_to_f32(extract(advance<N>(s))) * INV32; }
PT_HD float normal_from(float u1, float u2) {
  float theta = TWO_PI * u1;
  float rho = sqrtf(-2.0f * logf(u2));
  return rho * cosf(theta);
}

// ---- textures (scene/texture.py bilinear) -----------------------------
PT_HD long long pmod(long long a, long long m) {
  long long r = a % m;
  return r < 0 ? r + m : r;
}
// The texel indices f mod n and (f + 1) mod n of an integral float f. The
// card has no 64-bit integer divider (a remainder is a software routine of
// tens of instructions), so where f lies within one image size of [0, n),
// which every uv in [-1, 2) gives, the indices come from 32-bit compares and
// adds; elsewhere from the 64-bit remainder. The same indices either way.
PT_HD void wrap2(float f, int n, int& i0, int& i1) {
  const float nf = (float)n;
  if (f >= 0.0f && f < nf) {
    i0 = (int)f;
  } else if (f >= -nf && f < 0.0f) {
    i0 = (int)f + n;
  } else {
    const long long l = (long long)f;
    i0 = (int)pmod(l, n);
    i1 = (int)pmod(l + 1, n);
    return;
  }
  i1 = i0 + 1 == n ? 0 : i0 + 1;
}
// texel (y, x) of an image at flat[(base + y*w + x)*3 + c]
PT_HD V3 bilinear(const float* flat, long long base, int h, int w, float u, float v) {
  float x = u * (float)w - 0.5f;
  float y = v * (float)h - 0.5f;
  float x0 = floorf(x), y0 = floorf(y);
  float fx = x - x0, fy = y - y0;
  int x0i, x1i, y0i, y1i;
  wrap2(x0, w, x0i, x1i);
  wrap2(y0, h, y0i, y1i);
  const float* img = flat + base * 3;
  const float* c00 = img + 3 * (size_t)(y0i * w + x0i);
  const float* c01 = img + 3 * (size_t)(y0i * w + x1i);
  const float* c10 = img + 3 * (size_t)(y1i * w + x0i);
  const float* c11 = img + 3 * (size_t)(y1i * w + x1i);
  float out[3];
  for (int c = 0; c < 3; ++c) {
    float top = c00[c] * (1.0f - fx) + c01[c] * fx;
    float bot = c10[c] * (1.0f - fx) + c11[c] * fx;
    out[c] = top * (1.0f - fy) + bot * fy;
  }
  return v3(out[0], out[1], out[2]);
}
PT_HD V3 sky_color(const float* sky, int h, int w, V3 d) {
  float u = 0.5f + atan2f(d.z, d.x) / SKY_U_DIV;
  float v = 0.5f - asinf(clamp_pm1(d.y)) / SKY_V_DIV;
  return bilinear(sky, 0, h, w, u, v);
}

// ---- implicit surfaces (shade/implicits.py, frag.glsl:299-349) ----------
constexpr double GR_D = 0.5 + 2.2360679774997896964 / 2.0;
constexpr float GR2 = (float)(GR_D * GR_D);
constexpr float GR_K = (float)(1.0 + 2.0 * GR_D);

PT_HD float ipow4(float x) { float x2 = x * x; return x2 * x2; }
PT_HD float ipow10(float x) { float x2 = x * x, x4 = x2 * x2, x8 = x4 * x4; return x8 * x2; }

// Surface FN at (x, y, z); FN is a template argument so that a march
// evaluates one function and no switch.
template <int FN>
PT_HD float implicit_fn(float x, float y, float z) {
  const float nan = NAN;
  float x2 = x * x, y2 = y * y, z2 = z * z, fx = 0.0f;
  if (FN == 1) return x2 + y2 + z2 - 15.0f;
  if (FN == 2) return sinf(x / 2.0f) + sinf(z / 2.0f) + y / 2.0f + 10.0f;
  if (FN == 3) return 2.0f * x2 + y2 + 2.0f * z2 - 3.0f;
  if (FN == 4) fx = y < -0.63f ? 0.2f * (y - 5.0f) : nan;
  if (FN == 5) {
    float s = x2 + y2 + z2 - 1.0f;
    return 4.0f * (GR2 * x2 - y2) * (GR2 * y2 - z2) * (GR2 * z2 - x2)
           - GR_K * (s * s) * 1.0f;
  }
  if (FN == 6)
    fx = y > -0.7417f
             ? (y > 0.0f ? (y < 1.3f ? y * y * y - 3.0f : nan)
                         : (y > -2.0f ? 10.0f * sinf(y + 4.7f) + 7.0f : nan))
             : nan;
  if (FN == 7) fx = -1.047f * sqrtf(-(y - 1.25f) * (y - 1.25f) + 1.0f);
  if (FN == 8)
    fx = (y > 7.6f || y < 0.0f)
             ? nan
             : (y < 0.196f ? 0.5625f * cosf(17.0f * y) + 0.6875f
                           : 0.125f + ipow10(sinf(0.9f * powf(fabsf(y / 2.5f), 0.6f))));
  if (FN == 9) {
    float yy = -y;
    fx = (yy < 2.0f || yy > 8.0f) ? nan
       : yy > 7.0f ? -ipow10(fabsf(yy - 7.0f)) + 1.0f
       : yy > 5.0f ? 1.0f
       : yy > 4.1f ? sinf(yy - 0.27f)
       : yy > 2.5f ? (yy + 0.9826f) / 8.0f
       : yy > 2.0f ? sinf(40.0f * yy) / 40.0f + 0.45f
       : 0.0f;
  }
  if (FN == 10)
    fx = !(y > 0.0f) ? nan
       : y < 5.488f ? -powf(10.0f, -5.0f * y) + 1.04f
       : y < 6.74f ? 0.34f * sinf(2.5f * y + 6.7f) + 0.7f
       : y < 8.43f ? 0.36f
       : y < 8.76f ? -50.0f * ipow4(y - 8.6f) + 0.4f
       : y < 9.0f ? 0.36f
       : nan;
  if (FN < 1 || FN > 10) return nan;
  return x2 + z2 - fx * fx;
}

PT_HD float implicit_f(int fn, float x, float y, float z) {
  switch (fn) {
    case 1: return implicit_fn<1>(x, y, z);
    case 2: return implicit_fn<2>(x, y, z);
    case 3: return implicit_fn<3>(x, y, z);
    case 4: return implicit_fn<4>(x, y, z);
    case 5: return implicit_fn<5>(x, y, z);
    case 6: return implicit_fn<6>(x, y, z);
    case 7: return implicit_fn<7>(x, y, z);
    case 8: return implicit_fn<8>(x, y, z);
    case 9: return implicit_fn<9>(x, y, z);
    case 10: return implicit_fn<10>(x, y, z);
    default: return NAN;
  }
}

// local-frame bounding radius of a bounded surface, 0 if unbounded
PT_HD float bound_radius(int fn) {
  switch (fn) {
    case 1: return 4.0f;
    case 3: return 2.0f;
    case 6: return 18.0f;
    case 7: return 2.6f;
    case 8: return 8.0f;
    case 9: return 8.5f;
    case 10: return 9.5f;
    default: return 0.0f;
  }
}

// First root of surface FN along O + t D on the lattice t = k*dt,
// k = 0..steps, then bisection. A bounded surface has every root inside
// its bounding sphere, so the march covers only the lattice indices
// around the sphere's chord (with one margin step each side); the
// samples it takes are exactly those of the full march there.
template <int FN>
PT_HD bool march_fn(V3 O, V3 D, int steps, int bisect_iters, float t_max, float* t_out) {
  float dt = t_max / (float)steps;
  int k0 = 0, k1 = steps;
  float br = bound_radius(FN);
  if (br > 0.0f) {
    float sa = D.x * D.x + D.y * D.y + D.z * D.z;
    float sb = 2.0f * (O.x * D.x + O.y * D.y + O.z * D.z);
    float sc = O.x * O.x + O.y * O.y + O.z * O.z - br * br;
    float disc = sb * sb - 4.0f * sa * sc;
    float sq = sqrtf(nan_max(disc, 0.0f));
    float s_enter = (-sb - sq) / (2.0f * sa);
    float s_exit = (-sb + sq) / (2.0f * sa);
    if (!(disc > 0.0f && s_exit > 0.0f)) return false;
    float k0f = nan_max(floorf(nan_max(s_enter, 0.0f) / dt) - 1.0f, 0.0f);
    k0 = (int)fminf(k0f, (float)steps);
    k1 = (int)nan_min(ceilf(s_exit / dt) + 1.0f, (float)steps);
  }
  float tk0 = dt * (float)k0;
  float f_prev = implicit_fn<FN>(O.x + D.x * tk0, O.y + D.y * tk0, O.z + D.z * tk0);
  float t_lo = 0.0f, t_hi = t_max;
  bool found = false;
  for (int k = k0 + 1; k <= k1; ++k) {
    float tc = dt * (float)k;
    float f = implicit_fn<FN>(O.x + D.x * tc, O.y + D.y * tc, O.z + D.z * tc);
    if (f_prev * f < 0.0f) {
      t_lo = tc - dt;
      t_hi = tc;
      found = true;
      break;
    }
    f_prev = f;
  }
  if (!found) return false;
  float f_lo = implicit_fn<FN>(O.x + D.x * t_lo, O.y + D.y * t_lo, O.z + D.z * t_lo);
  for (int i = 0; i < bisect_iters; ++i) {
    float t_mid = 0.5f * (t_lo + t_hi);
    float f_mid = implicit_fn<FN>(O.x + D.x * t_mid, O.y + D.y * t_mid, O.z + D.z * t_mid);
    if (f_lo * f_mid < 0.0f) {
      t_hi = t_mid;
    } else {
      t_lo = t_mid;
      f_lo = f_mid;
    }
  }
  *t_out = 0.5f * (t_lo + t_hi);
  return true;
}

// The march of surface fn, its function chosen once per implicit: an id
// outside 1..10 (a NaN surface, which the full march never finds) gives no
// root.
PT_HD bool march_implicit(int fn, V3 O, V3 D, int steps, int bisect_iters,
                          float t_max, float* t_out) {
  switch (fn) {
    case 1: return march_fn<1>(O, D, steps, bisect_iters, t_max, t_out);
    case 2: return march_fn<2>(O, D, steps, bisect_iters, t_max, t_out);
    case 3: return march_fn<3>(O, D, steps, bisect_iters, t_max, t_out);
    case 4: return march_fn<4>(O, D, steps, bisect_iters, t_max, t_out);
    case 5: return march_fn<5>(O, D, steps, bisect_iters, t_max, t_out);
    case 6: return march_fn<6>(O, D, steps, bisect_iters, t_max, t_out);
    case 7: return march_fn<7>(O, D, steps, bisect_iters, t_max, t_out);
    case 8: return march_fn<8>(O, D, steps, bisect_iters, t_max, t_out);
    case 9: return march_fn<9>(O, D, steps, bisect_iters, t_max, t_out);
    case 10: return march_fn<10>(O, D, steps, bisect_iters, t_max, t_out);
    default: return false;
  }
}

PT_HD V3 implicit_normal(int fn, V3 p) {
  float fc = implicit_f(fn, p.x, p.y, p.z);
  V3 g = v3((implicit_f(fn, p.x + GRAD_H, p.y, p.z) - fc) / GRAD_H,
            (implicit_f(fn, p.x, p.y + GRAD_H, p.z) - fc) / GRAD_H,
            (implicit_f(fn, p.x, p.y, p.z + GRAD_H) - fc) / GRAD_H);
  return unit(g);
}

// ---- scene tables -------------------------------------------------------
struct Scene {
  const float* mats;      // (M, 48)
  const float* ell;       // (E, 17)
  const float* imp;       // (I, 17)
  const int* ell_flags;   // (E,)
  const int* imp_info;    // (I, 2)
  const float* tris;      // (T, 9)
  const float* attr;      // (T, 10)
  const float* uvt;       // (T, 10)
  const float* atlas;     // (N, 3)
  const int* slots;       // (S, 3) h, w, offset
  const int* mat_maps;    // (M, 9)
  const float* sky;       // (h*w, 3)
  int n_mats, n_ell, n_imp, n_tris, sky_h, sky_w;
  int march_steps, bisect_iters;
  float march_tmax;
};

struct Hit {
  float t;
  V3 n;          // shading normal before any flip
  int mat;       // 0 on a miss
  bool is_hit;
  float tu, tv;  // GL uv (v flipped), -1 without UVs
  V3 tw;         // raw UV-space tangent
  bool uvok;
};

// One triangle row k (v1, e1, e2) of the block kernel's dense loop below
// against o + t d: accepted where it is the closest so far.
//
// Early exit: once det and u's numerator are known, a row that no lane of
// the warp can accept skips the second cross product and its two dots. A
// lane can accept only if adet >= EPSILON, uc >= 0 and uc <= adet: with
// vc >= 0, RN(uc + vc) >= uc, so uc + vc <= adet implies uc <= adet, and
// NaN fails both. The rows a lane accepts, and so its bits, do not change.
// On the card the skip is warp-uniform (__any_sync over the active lanes);
// the host build of the same body (csrc/dense_hit_host.cpp) skips per ray.
PT_HD void dense_row(V3 o, V3 d, V3 v1, V3 e1, V3 e2, int k, float& tn, float& td,
                     float& un, float& vn, int& hid) {
  V3 p = cross(d, e2);
  float det = dot(e1, p);
  V3 s = v3(o.x - v1.x, o.y - v1.y, o.z - v1.z);
  float ur = dot(s, p);
  float sg = det >= 0.0f ? 1.0f : -1.0f;
  float adet = det * sg, uc = ur * sg;
  const bool maybe = adet >= EPSILON && uc >= 0.0f && uc <= adet;
#ifdef __CUDA_ARCH__
  if (!__any_sync(__activemask(), maybe)) return;
#else
  if (!maybe) return;
#endif
  V3 q = cross(s, e1);
  float vr = dot(d, q);
  float tr = dot(e2, q);
  float vc = vr * sg, tc = tr * sg;
  if (adet >= EPSILON && uc >= 0.0f && vc >= 0.0f && uc + vc <= adet &&
      tc > EPSILON * adet && tc * td < tn * adet) {
    tn = tc;
    td = adet;
    un = uc;
    vn = vc;
    hid = k;
  }
}

// The closest of n_tris triangles along o + t d, division-free
// Möller-Trumbore (kernels/intersect.py `tri_candidate`): the first in
// table order of the least t = tn / td, compared by cross-multiplication;
// u = un / td, v = vn / td. Returns its row, -1 (tn = MISS, td = 1) if
// none. Rows 0 .. n_staged - 1 come from `staged`, 12 floats a row (v1,
// e1, e2, 3 pad) 16 bytes aligned (the block kernel stages them in shared
// memory), the rest from `tris`, 9 floats a row. The block kernel's form of
// closest_hit's triangle loop, with dense_row's early exit.
PT_HD int dense_closest(const float* tris, int n_tris, const float* staged, int n_staged, V3 o,
                        V3 d, float& tn, float& td, float& un, float& vn) {
  tn = MISS;
  td = 1.0f;
  un = vn = 0.0f;
  int hid = -1;
  for (int k = 0; k < n_staged; ++k) {
#ifdef __CUDA_ARCH__
    const float4* r = reinterpret_cast<const float4*>(staged) + 3 * k;
    const float4 a = r[0], b = r[1], c = r[2];
    dense_row(o, d, v3(a.x, a.y, a.z), v3(a.w, b.x, b.y), v3(b.z, b.w, c.x), k, tn, td, un,
              vn, hid);
#else
    const float* r = staged + 12 * k;
    dense_row(o, d, v3(r[0], r[1], r[2]), v3(r[3], r[4], r[5]), v3(r[6], r[7], r[8]), k, tn,
              td, un, vn, hid);
#endif
  }
  for (int k = n_staged; k < n_tris; ++k) {
    const float* r = tris + 9 * k;
    dense_row(o, d, v3(r[0], r[1], r[2]), v3(r[3], r[4], r[5]), v3(r[6], r[7], r[8]), k, tn,
              td, un, vn, hid);
  }
  return hid;
}

// The block kernel's staged rows, where it stages (kernels/fused.py
// STAGE_MIN picks the instantiation): the first STAGED_ROWS rows in shared
// memory as 16-byte rows (24 KB at most, with the stacks' 8 KB room for
// several blocks a multiprocessor).
constexpr int STAGED_ROWS = 512;
PT_HD int staged_rows(int n_tris) { return n_tris < STAGED_ROWS ? n_tris : STAGED_ROWS; }
#ifdef __CUDACC__
// The staged rows: the block kernel's dynamic shared memory.
__device__ __forceinline__ float4* staged_rows_smem() {
  extern __shared__ float4 pt_staged_rows[];
  return pt_staged_rows;
}
#endif

// The closest triangle along o + t d (the nudged origin o): every row of
// `tris` tested in full, or with STAGED (the block kernel from STAGE_MIN
// triangles on) dense_closest, with its early exit, over the rows the block
// staged in shared memory; a host build of STAGED has no staged rows and
// reads every row from `tris`, with the same results. The full test is
// written out here, not dense_closest without its exit: that form made the
// frame kernel 2.5-4.1% slower in config 6 (NVIDIA H100 80GB HBM3,
// 700.00 W; PERF.md). Returns the row hit (-1 for none) with its t, u, v
// (t = MISS where none).
template <bool STAGED = false>
PT_HD int triangle_loop(const Scene& sc, V3 o, V3 d, float& t, float& u, float& v) {
  t = MISS;
  u = v = 0.0f;
  int hid = -1;
  if (sc.n_tris > 0) {
    const float* staged = nullptr;
    int n_staged = 0;
#ifdef __CUDA_ARCH__
    if (STAGED) {
      staged = reinterpret_cast<const float*>(staged_rows_smem());
      n_staged = staged_rows(sc.n_tris);
    }
#endif
    float tn = MISS, td = 1.0f, un = 0.0f, vn = 0.0f;
    if (!STAGED) {
      for (int k = 0; k < sc.n_tris; ++k) {
        const float* r = sc.tris + 9 * k;
        V3 v1 = v3(r[0], r[1], r[2]), e1 = v3(r[3], r[4], r[5]),
           e2 = v3(r[6], r[7], r[8]);
        V3 p = cross(d, e2);
        float det = dot(e1, p);
        V3 s = v3(o.x - v1.x, o.y - v1.y, o.z - v1.z);
        float ur = dot(s, p);
        V3 q = cross(s, e1);
        float vr = dot(d, q);
        float tr = dot(e2, q);
        float sg = det >= 0.0f ? 1.0f : -1.0f;
        float adet = det * sg, uc = ur * sg, vc = vr * sg, tc = tr * sg;
        if (adet >= EPSILON && uc >= 0.0f && vc >= 0.0f && uc + vc <= adet &&
            tc > EPSILON * adet && tc * td < tn * adet) {
          tn = tc;
          td = adet;
          un = uc;
          vn = vc;
          hid = k;
        }
      }
    } else {
      hid = dense_closest(sc.tris, sc.n_tris, staged, n_staged, o, d, tn, td, un, vn);
    }
    float invd = 1.0f / td;
    t = tn * invd;
    if (hid >= 0) {
      u = un * invd;
      v = vn * invd;
    }
  }
  return hid;
}

// The hit record of ray (o, d), o the nudged origin, from its closest
// triangle `tri` (-1 for none) at t with barycentrics u, v: the analytic
// primitives merged over it, implicits then ellipsoids, each with a strict
// t < closest so that the first of equal distances wins (kernels/traverse.py
// `_merge_analytic_batched`), and the attributes at the final hit
// (`surface_sample`, `_assemble_sample`): the smooth or flat normal, GL's
// flipped v, the raw UV tangent and the material from attr[:, 9]. The frame
// and block kernels call it after their triangle loop (closest_hit), the
// bounce kernel after the forest or streamed walk, with `tri` the walk's
// row through its permutation. PH: add each part's cycles into cyc
// (PH_TRI from t0, PH_IMP, PH_ELL). ROWS8: read the triangle's rows with
// `row10` (the bounce kernel's path form, where it paid; the frame kernel
// lost ~4% to it and keeps its loads).
template <bool PH = false, bool ROWS8 = false>
PT_HD Hit finish_hit(const Scene& sc, V3 o, V3 d, float t, int tri, float u, float v,
                     unsigned long long* cyc = nullptr, long long t0 = 0) {
  Hit h;
  h.n = v3(0.0f, 0.0f, 0.0f);
  h.mat = 0;
  h.tu = h.tv = -1.0f;
  h.tw = v3(0.0f, 0.0f, 0.0f);
  h.uvok = false;
  int kind = 0;
  if (tri >= 0) {
    Row10 attr, uvt;
    const float* a = sc.attr + 10 * tri;
    if (ROWS8) {
      attr = row10(sc.attr, tri);
      a = attr.f;
    }
    float half = floorf(a[9] * 0.5f);
    bool smooth = (a[9] - 2.0f * half) > 0.5f;
    h.mat = (int)half;
    float w = 1.0f - u - v;
    V3 ni = v3(a[0] * w + a[3] * u + a[6] * v, a[1] * w + a[4] * u + a[7] * v,
               a[2] * w + a[5] * u + a[8] * v);
    float mag = sqrtf(dot(ni, ni));
    h.n = smooth ? v3(ni.x / mag, ni.y / mag, ni.z / mag) : v3(a[0], a[1], a[2]);
    kind = 1;
    const float* uv = sc.uvt + 10 * tri;
    if (ROWS8) {
      uvt = row10(sc.uvt, tri);
      uv = uvt.f;
    }
    float tur = uv[0] * w + uv[2] * u + uv[4] * v;
    float tvr = uv[1] * w + uv[3] * u + uv[5] * v;
    h.tw = v3(uv[6], uv[7], uv[8]);
    h.uvok = uv[9] > 0.5f;
    if (h.uvok) {
      h.tu = tur;
      h.tv = 1.0f - tvr;
    }
  }
  if (PH) {
    tock(cyc, PH_TRI, t0);
    t0 = tick();
  }
  for (int k = 0; k < sc.n_imp; ++k) {
    const float* r = sc.imp + 17 * k;
    int fn = sc.imp_info[2 * k];
    bool rotated = sc.imp_info[2 * k + 1] != 0;
    V3 lo = v3((o.x - r[0]) / r[3], (o.y - r[1]) / r[4], (o.z - r[2]) / r[5]);
    V3 ld = v3(d.x / r[3], d.y / r[4], d.z / r[5]);
    if (rotated) {
      lo = mul_r(r + 8, lo);
      ld = mul_r(r + 8, ld);
    }
    float tk;
    if (march_implicit(fn, lo, ld, sc.march_steps, sc.bisect_iters, sc.march_tmax, &tk) &&
        tk < t) {
      V3 p = v3(lo.x + ld.x * tk, lo.y + ld.y * tk, lo.z + ld.z * tk);
      V3 g = implicit_normal(fn, p);
      if (rotated) g = mul_rt(r + 8, g);
      t = tk;
      h.n = g;
      h.mat = (int)r[7];
      kind = 2;
    }
  }
  if (PH) {
    tock(cyc, PH_IMP, t0);
    t0 = tick();
  }
  for (int e = 0; e < sc.n_ell; ++e) {
    const float* r = sc.ell + 17 * e;
    bool rotated = sc.ell_flags[e] != 0;
    V3 ro = rotated ? mul_r(r + 8, o) : o;
    V3 rd = rotated ? mul_r(r + 8, d) : d;
    float fx = r[3], fy = r[4], fz = r[5], rad = r[6];
    V3 oc = v3(ro.x - r[0], ro.y - r[1], ro.z - r[2]);
    float a = fx * rd.x * rd.x + fy * rd.y * rd.y + fz * rd.z * rd.z;
    float b = 2.0f * (fx * oc.x * rd.x + fy * oc.y * rd.y + fz * oc.z * rd.z);
    float cc = fx * oc.x * oc.x + fy * oc.y * oc.y + fz * oc.z * oc.z - rad * rad;
    float disc = b * b - 4.0f * a * cc;
    float sq = sqrtf(nan_max(disc, 0.0f));
    float inv_2a = 1.0f / (2.0f * a);
    float t0 = (-b - sq) * inv_2a, t1 = (-b + sq) * inv_2a;
    float t_lo = nan_min(t0, t1), t_hi = nan_max(t0, t1);
    float te = t_lo > 0.0f ? t_lo : t_hi;
    if (disc > 0.0f && te > 0.0f && te < t) {
      V3 l = unit(v3(ro.x + te * rd.x - r[0], ro.y + te * rd.y - r[1],
                     ro.z + te * rd.z - r[2]));
      if (rotated) l = mul_rt(r + 8, l);
      t = te;
      h.n = l;
      h.mat = (int)r[7];
      kind = 3;
    }
  }
  if (PH) tock(cyc, PH_ELL, t0);
  h.t = t;
  h.is_hit = t < HIT_T;
  if (kind != 1) {
    h.uvok = false;
    h.tu = h.tv = -1.0f;
  }
  return h;
}

// Closest hit from the nudged origin o: triangles, implicits, ellipsoids
// (the frame and block kernels' scene query). STAGED: triangle_loop's. PH:
// add each part's cycles into cyc (PH_TRI, PH_IMP, PH_ELL).
template <bool PH = false, bool STAGED = false>
PT_HD Hit closest_hit(const Scene& sc, V3 o, V3 d, unsigned long long* cyc = nullptr) {
  const long long t0 = PH ? tick() : 0;
  float t, u, v;
  const int hid = triangle_loop<STAGED>(sc, o, d, t, u, v);
  return finish_hit<PH>(sc, o, d, t, hid, u, v, cyc, t0);
}

// Sample the atlas map bound to material `mat`'s channel `ch`; false if
// none is bound.
PT_HD bool map_sample(const Scene& sc, int mat, int ch, float tu, float tv, V3* out) {
  int slot = sc.mat_maps[mat * N_MAP_CH + ch];
  if (slot < 0) return false;
  const int* s = sc.slots + 3 * slot;
  *out = bilinear(sc.atlas, s[2], s[0], s[1], tu, tv);
  return true;
}

// Normal mapping: the raw tangent Gram-Schmidt'ed against n (zero without
// UVs), bitangent n x t, then normalize(T a.x + B a.y + N a.z) with the
// magnitude floored at 1e-20.
PT_HD V3 tbn_map(const Hit& h, V3 n, V3 s) {
  V3 g = v3(0.0f, 0.0f, 0.0f);
  if (h.uvok) {
    float ndt = dot(h.tw, n);
    g = v3(h.tw.x - n.x * ndt, h.tw.y - n.y * ndt, h.tw.z - n.z * ndt);
    float gm = sqrtf(dot(g, g));
    g = v3(g.x / gm, g.y / gm, g.z / gm);
  }
  V3 b = cross(n, g);
  float ax = s.x * 2.0f - 1.0f, ay = s.y * 2.0f - 1.0f, az = s.z * 2.0f - 1.0f;
  V3 m = v3(g.x * ax + b.x * ay + n.x * az, g.y * ax + b.y * ay + n.y * az,
            g.z * ax + b.z * ay + n.z * az);
  float mm = nan_max(sqrtf(dot(m, m)), 1e-20f);
  return v3(m.x / mm, m.y / mm, m.z / mm);
}

// ---- Fresnel + chooseRay (shade/bsdf.py, frag.glsl:726-809) -------------
PT_HD float fresnel(float n1, float n2, V3 n, V3 d) {
  float r0 = (n1 - n2) / (n1 + n2);
  r0 = r0 * r0;
  float cos_x = -dot(n, d);
  float rn = n1 / n2;
  float sin_t2 = rn * rn * (1.0f - cos_x * cos_x);
  bool tir = (n1 > n2) && (sin_t2 > 1.0f);
  if (n1 > n2) cos_x = sqrtf(nan_max(1.0f - sin_t2, 0.0f));
  float x = 1.0f - cos_x;
  float ret = r0 + (1.0f - r0) * x * x * x * x * x;
  return tir ? 1.0f : ret;
}

struct Lobe {
  V3 dir;
  int win;  // 0 diffuse, 1 reflect, 2 clearcoat, 3 transmission, 4 subsurface
  uint32_t state;
};

struct ShadeFields {
  float Pr, Pm, Pc, Pcr, Tr, illum, subsurface;
  V3 Tf;
};

PT_HD Lobe choose_ray(const ShadeFields& m, float n1, float n2, V3 n, V3 d,
                      uint32_t state, bool gate_ss) {
  float reflection_w = 1.0f - m.Pr;
  float tf_mean = (m.Tf.x + m.Tf.y + m.Tf.z) / 3.0f;
  float transmission_w = m.Tr > 0.0f ? m.Tr : (m.Tf.x > 0.0f ? tf_mean : 0.0f);
  float eta = n1 / n2;
  bool do_fresnel = m.illum == 5.0f || m.illum == 7.0f || transmission_w > 0.0f;
  float fr = do_fresnel ? fresnel(n1, n2, n, d) : 0.0f;
  reflection_w = reflection_w + fr * m.Pr;
  transmission_w = transmission_w * (1.0f - fr);
  float diffuse_w = (1.0f - m.Pm) * (1.0f - transmission_w) * (1.0f - fr);
  float total = diffuse_w + reflection_w + m.Pc + transmission_w;
  float rw = reflection_w / total, cw = m.Pc / total, tw = transmission_w / total;

  float roll = peek<1>(state);
  float t1 = rw, t2 = t1 + cw, t3 = t2 + tw;
  bool is_reflect = roll < t1;
  bool is_coat = !is_reflect && roll < t2;
  bool is_trans = !is_reflect && !is_coat && roll < t3;
  bool is_else = !(is_reflect || is_coat || is_trans);
  bool has_ss = gate_ss && m.subsurface > 0.0f;
  float dn = dot(n, d);
  Lobe out;
  if (is_trans) {
    // refract(D, N, eta); total internal reflection gives the zero vector
    float kk = 1.0f - eta * eta * (1.0f - dn * dn);
    float ksq = sqrtf(nan_max(kk, 0.0f));
    out.dir = kk < 0.0f ? v3(0.0f, 0.0f, 0.0f)
                        : v3(eta * d.x - (eta * dn + ksq) * n.x,
                             eta * d.y - (eta * dn + ksq) * n.y,
                             eta * d.z - (eta * dn + ksq) * n.z);
    out.win = 3;
    out.state = advance<1>(state);
    return out;
  }
  V3 refl = v3(d.x - 2.0f * dn * n.x, d.y - 2.0f * dn * n.y, d.z - 2.0f * dn * n.z);
  if (is_reflect) {
    out.dir = refl;
    out.win = 1;
    out.state = advance<7>(state);
    return out;
  }
  if (is_else && has_ss) {
    // the sub-roll is draw 2, the lambertian vec draws 3..8
    float sub_roll = peek<2>(state);
    V3 l = v3(normal_from(peek<3>(state), peek<4>(state)),
              normal_from(peek<5>(state), peek<6>(state)),
              normal_from(peek<7>(state), peek<8>(state)));
    out.dir = unit(v3(l.x + n.x, l.y + n.y, l.z + n.z));
    out.win = sub_roll < m.subsurface ? 4 : 0;
    out.state = advance<8>(state);
    return out;
  }
  V3 l = v3(normal_from(peek<2>(state), peek<3>(state)),
            normal_from(peek<4>(state), peek<5>(state)),
            normal_from(peek<6>(state), peek<7>(state)));
  V3 cp = unit(v3(l.x + n.x, l.y + n.y, l.z + n.z));
  if (is_coat) {
    out.dir = v3(refl.x * (1.0f - m.Pcr) + cp.x * m.Pcr,
                 refl.y * (1.0f - m.Pcr) + cp.y * m.Pcr,
                 refl.z * (1.0f - m.Pcr) + cp.z * m.Pcr);
    out.win = 2;
  } else {
    out.dir = cp;
    out.win = 0;
  }
  out.state = advance<7>(state);
  return out;
}

}  // namespace pt
