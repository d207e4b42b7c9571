// The integrators of one ray, shared by the frame kernel
// (frame_kernel.cu), the block kernel (block_kernel.cu) and the bounce
// kernel (bounce_kernel.cu): the path (frag.glsl:810-882: `PathState`,
// `path_begin`, `path_step` and the loop over them, `trace_path`) and the
// Whitted `direct_diffuse` (frag.glsl:655-681) over pathtrace.cuh's
// brute-force closest hit, the scene arguments the launchers take, and the
// per-block sum of a count. Each bounce is a scene query and its shading
// half, `path_shade` or `direct_shade`, which takes a finished Hit: the
// bounce kernel shades the hits of a forest or streamed walk with the same
// halves. The halves are __host__ __device__, so that a g++ build of the
// bounce kernel's body (bounce_host.cpp) runs their arithmetic on the CPU;
// the loops and the block sum are the card's alone. Plain versions:
// pathtracer0_tpu_torch/render/integrator.py `trace_plain` and
// `direct_diffuse_plain`; kernels/bounce.py `bounce_step_plain`.
#pragma once

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "pathtrace.cuh"

namespace pt {

// The scene tables and their counts (kernels/fused.py `SceneArgs`, field
// for field).
struct SceneArgs {
  const float* mats;
  const float* ell;
  const float* imp;
  const int* ell_flags;
  const int* imp_info;
  const float* tris;
  const float* attr;
  const float* uvt;
  const float* atlas;
  const int* slots;
  const int* mat_maps;
  const float* sky;
  int n_mats, n_ell, n_imp, n_tris, sky_h, sky_w, march_steps, bisect_iters;
  float march_tmax;
  int gate_ss;
};

constexpr int BLOCK = 128;

PT_HD Scene make_scene(const SceneArgs& a) {
  return Scene{a.mats, a.ell, a.imp, a.ell_flags, a.imp_info, a.tris, a.attr,
               a.uvt, a.atlas, a.slots, a.mat_maps, a.sky, a.n_mats, a.n_ell,
               a.n_imp, a.n_tris, a.sky_h, a.sky_w, a.march_steps,
               a.bisect_iters, a.march_tmax};
}

PT_HD float mat_col(const Scene& sc, int mat, int col) {
#ifdef __CUDA_ARCH__
  return __ldg(sc.mats + mat * 48 + col);
#else
  return sc.mats[mat * 48 + col];
#endif
}

// Component r of a (3, n) array, one row per component (the bounce
// kernel's state).
PT_HD V3 load3(const float* a, int r, int n) {
  return v3(a[r], a[n + r], a[2 * (size_t)n + r]);
}
PT_HD void store3(float* a, int r, int n, V3 v) {
  a[r] = v.x;
  a[n + r] = v.y;
  a[2 * (size_t)n + r] = v.z;
}

// The camera of one pixel: where its samples' rays start and aim (the frame
// kernel's raygen and the bounce kernel's camera form; plain version:
// core/camera.py `dof_ray`).
struct PixelCamera {
  float r[9];  // rotation matrix, row-major
  V3 c, pd;    // camera position, primary direction
  float ifd, blur;

  // The sample's ray with depth of field (frag.glsl:899-908): 6 draws,
  // always consumed.
  PT_HD void ray(uint32_t& state, V3& o, V3& d) const {
    o = c;
    if (blur != 0.0f) {
      V3 j = v3(normal_from(peek<1>(state), peek<2>(state)) * blur,
                normal_from(peek<3>(state), peek<4>(state)) * blur,
                normal_from(peek<5>(state), peek<6>(state)) * blur);
      o = v3(c.x + (r[0] * j.x + r[1] * j.y + r[2] * j.z),
             c.y + (r[3] * j.x + r[4] * j.y + r[5] * j.z),
             c.z + (r[6] * j.x + r[7] * j.y + r[8] * j.z));
    }
    state = advance<6>(state);
    V3 dd = v3((c.x + pd.x * ifd) - o.x, (c.y + pd.y * ifd) - o.y, (c.z + pd.z * ifd) - o.z);
    float mag = sqrtf(dot(dd, dd));
    d = v3(dd.x / mag, dd.y / mag, dd.z / mag);
  }
};

// The path integrator of one ray (frag.glsl:810-882), in three pieces that
// both schedules of the frame kernel share: the state a path carries from
// bounce to bounce, `path_begin` and `path_step` (one bounce). `trace_path`
// is the per-sample loop over them; the refill schedule of
// frame_kernel.cu runs one flat loop over (sample, bounce) instead.
//
// The refraction-index stack is bottom first, behind an accessor `Stk`
// (entry j at stk[j]): the frame and block kernels keep a thread's stack
// in shared memory, entry j at j * BLOCK (a warp's lanes on 32 banks at any
// depths; `SmemStack`); the bounce kernel keeps it in device memory, one
// column per ray, entry j of ray r at j * R + r (a warp's lanes on
// neighbouring addresses; `ColumnStack`). A bounce reads the top two
// entries and pushes or pops one, so nothing is shifted and the stack holds
// no registers. Entries at and past `ssize` read as 0, as those of a stack
// shifted in place.
// `one_deep`: whether a stack of one entry (S = 1) can reach path_shade;
// the frame and block kernels take 2..MAX_STACK entries alone.
struct SmemStack {
  static constexpr bool one_deep = false;
  float* p;
  PT_HD float& operator[](int j) const { return p[j * BLOCK]; }
};
struct ColumnStack {
  static constexpr bool one_deep = true;
  float* p;
  int stride;
  PT_HD float& operator[](int j) const { return p[(size_t)j * stride]; }
};

// Where the ray entered its medium, read only where a transmission is
// absorbed and written only where a medium is entered: in registers (the
// frame and block kernels, `RegEnter`) or in the ray's columns of device
// memory (the bounce kernel, `ColumnEnter`), so the bounce kernel moves it
// only for the rays that need it.
struct RegEnter {
  static constexpr bool lazy = false;
  V3 v;
  PT_HD V3 get() const { return v; }
  PT_HD void set(V3 x) { v = x; }
};
struct ColumnEnter {
  static constexpr bool lazy = true;
  float* p;
  int r, n;
  PT_HD V3 get() const { return load3(p, r, n); }
  PT_HD void set(V3 x) const { store3(p, r, n, x); }
};

template <class Stk, class Ent = RegEnter>
struct PathStateT {
  V3 o, d, col;          // ray, throughput
  Stk stk;               // this thread's refraction-index stack
  int ssize;
  bool inobj;
  Ent enter;             // where the ray entered the medium
  bool alive;
  int bounce;            // bounces taken
};
using PathState = PathStateT<SmemStack>;

// `stk`: the thread's stack, MAX_STACK entries BLOCK floats apart.
PT_HD void path_begin(PathState& p, V3 o, V3 d, float* stk) {
  p.o = o;
  p.d = d;
  p.col = v3(1.0f, 1.0f, 1.0f);
  p.stk = SmemStack{stk};
  stk[0] = AIR_IOR;
  p.ssize = 1;
  p.inobj = false;
  p.enter.set(v3(0.0f, 0.0f, 0.0f));
  p.alive = true;
  p.bounce = 0;
}

// Whether the path takes another bounce (`ray_on` of fused.py:1207).
PT_HD bool path_on(const PathState& p, int max_bounces) {
  return p.alive && p.bounce < max_bounces;
}

// The miss of a live path along d with throughput col: the sky on each
// channel whose throughput is positive, added into skyc.
PT_HD void path_miss(const Scene& sc, V3 d, V3 col, V3& skyc) {
  const V3 s = sky_color(sc.sky, sc.sky_h, sc.sky_w, d);
  if (col.x > 0.0f) skyc.x += s.x * col.x;
  if (col.y > 0.0f) skyc.y += s.y * col.y;
  if (col.z > 0.0f) skyc.z += s.z * col.z;
}

// The shading half of one bounce of a live path at h, the finished hit of
// ray (on, p.d) from the nudged origin on. Adds the emission into inc and,
// on a miss, the sky into skyc; a miss or the throughput cut-off ends the
// path (alive = false). PH: add the cycles of the material decode with its
// maps, the sky and the lobe choice with the refraction stack into cyc.
template <bool PH = false, class Stk, class Ent>
PT_HD void path_shade(const Scene& sc, PathStateT<Stk, Ent>& p, const Hit& h, V3 on,
                      uint32_t& state, int S, bool gate_ss, V3& inc, V3& skyc,
                      unsigned long long* cyc = nullptr) {
  const V3 d = p.d;
  V3 col = p.col;
  long long t0 = PH ? tick() : 0;
  if (!h.is_hit) {
    path_miss(sc, d, col, skyc);
    p.alive = false;
    if (PH) tock(cyc, PH_SKY, t0);
    return;
  }
  V3 hx = v3(on.x + h.t * d.x, on.y + h.t * d.y, on.z + h.t * d.z);
  int m = h.mat;
  V3 Kd = v3(mat_col(sc, m, 3), mat_col(sc, m, 4), mat_col(sc, m, 5));
  V3 Ks = v3(mat_col(sc, m, 6), mat_col(sc, m, 7), mat_col(sc, m, 8));
  V3 Ke = v3(mat_col(sc, m, 16), mat_col(sc, m, 17), mat_col(sc, m, 18));
  V3 Tf = v3(mat_col(sc, m, 12), mat_col(sc, m, 13), mat_col(sc, m, 14));
  ShadeFields f;
  f.Tr = mat_col(sc, m, 11);
  f.Tf = Tf;
  f.illum = mat_col(sc, m, 20);
  f.Pm = mat_col(sc, m, 24);
  f.Pr = mat_col(sc, m, 25);
  f.Pc = mat_col(sc, m, 27);
  f.Pcr = mat_col(sc, m, 28);
  f.subsurface = mat_col(sc, m, 41);
  float Ni = mat_col(sc, m, 15), Density = mat_col(sc, m, 19);
  V3 n = h.n;
  V3 s;
  if (map_sample(sc, m, MAP_KD, h.tu, h.tv, &s)) Kd = v3(Kd.x * s.x, Kd.y * s.y, Kd.z * s.z);
  if (map_sample(sc, m, MAP_PM, h.tu, h.tv, &s)) f.Pm = s.x;
  if (map_sample(sc, m, MAP_PR, h.tu, h.tv, &s)) f.Pr = s.x;
  if (map_sample(sc, m, MAP_NORM, h.tu, h.tv, &s)) n = tbn_map(h, h.n, s);
  if (map_sample(sc, m, MAP_KS, h.tu, h.tv, &s)) Ks = s;
  if (map_sample(sc, m, MAP_PC, h.tu, h.tv, &s)) f.Pc = s.x;
  if (map_sample(sc, m, MAP_TR, h.tu, h.tv, &s)) f.Tr = s.x;
  if (map_sample(sc, m, MAP_KE, h.tu, h.tv, &s)) Ke = s;
  if (PH) {
    tock(cyc, PH_DECODE, t0);
    t0 = tick();
  }

  // normal flip by sign(N.D) (frag.glsl:829-830)
  float nd = dot(n, d);
  float flip = nd > 0.0f ? -1.0f : 1.0f;
  n = v3(n.x * flip, n.y * flip, n.z * flip);

  // refraction-index stack (frag.glsl:832-841): entering pushes Ni
  // (n1 = the old top, n2 = Ni) unless the stack holds S entries (then n1,
  // n2 = the second and the top); leaving reads n1, n2 = the top and the
  // second and pops. A stack of one entry (S = 1) has no second: it reads
  // as the first, as the reference's index past a one-entry stack clamps
  // to it (pathtracer0_tpu/render/integrator.py:206-207)
  const bool entering = nd < 0.0f;
  const int ns = p.ssize;
  const bool one = Stk::one_deep && S == 1;
  const float s0 = ns >= 1 ? p.stk[ns - 1] : 0.0f;
  const float s1 = one ? s0 : (ns >= 2 ? p.stk[ns - 2] : 0.0f);
  float n1 = s0, n2 = s1;
  if (entering) {
    if (ns < S) {
      p.stk[ns] = Ni;
      p.ssize = ns + 1;
      n2 = Ni;
      if (one) n1 = Ni;
    } else {
      n1 = s1;
      n2 = s0;
    }
  } else if (ns > 0) {
    p.ssize = ns - 1;
  }

  Lobe lobe = choose_ray(f, n1, n2, n, d, state, gate_ss);
  if (PH) tock(cyc, PH_CHOOSE, t0);

  // medium bookkeeping (frag.glsl:847-863)
  bool transmitted = lobe.win == 3;
  bool apply_absorb = transmitted && (!entering || p.inobj);
  float dist = 0.0f;  // the distance travelled in the medium
  if (!Ent::lazy || apply_absorb) {
    const V3 e = p.enter.get();
    const V3 dd = v3(e.x - hx.x, e.y - hx.y, e.z - hx.z);
    dist = sqrtf(dot(dd, dd));
  }
  if (transmitted) {
    p.inobj = entering;
    if (entering) p.enter.set(hx);
  }

  // transport (frag.glsl:865-874)
  inc.x += Ke.x * col.x;
  inc.y += Ke.y * col.y;
  inc.z += Ke.z * col.z;
  bool cutoff = sqrtf(dot(col, col)) < 0.1f;
  if (apply_absorb) {
    col = v3(col.x * expf(-Tf.x * dist * Density), col.y * expf(-Tf.y * dist * Density),
             col.z * expf(-Tf.z * dist * Density));
  } else if (lobe.win != 4) {
    V3 k = lobe.win == 2 ? Ks : Kd;
    col = v3(col.x * k.x, col.y * k.y, col.z * k.z);
  }
  p.col = col;
  p.o = hx;
  p.d = lobe.dir;
  state = lobe.state;
  p.alive = !cutoff;
}

// The Whitted shade (frag.glsl:655-681) at h, the finished hit of a ray
// along d: Ka + Kd (0.2 + N.y) + Ke on a hit with the unflipped (possibly
// normal-mapped) normal, the sky on a miss. PH: add the cycles of the
// decode with its maps, or of the sky, into cyc.
template <bool PH = false>
PT_HD V3 direct_shade(const Scene& sc, const Hit& h, V3 d, unsigned long long* cyc = nullptr) {
  const long long t0 = PH ? tick() : 0;
  if (!h.is_hit) {
    const V3 s = sky_color(sc.sky, sc.sky_h, sc.sky_w, d);
    if (PH) tock(cyc, PH_SKY, t0);
    return s;
  }
  int m = h.mat;
  V3 Ka = v3(mat_col(sc, m, 0), mat_col(sc, m, 1), mat_col(sc, m, 2));
  V3 Kd = v3(mat_col(sc, m, 3), mat_col(sc, m, 4), mat_col(sc, m, 5));
  V3 Ke = v3(mat_col(sc, m, 16), mat_col(sc, m, 17), mat_col(sc, m, 18));
  V3 n = h.n, s;
  if (map_sample(sc, m, MAP_KA, h.tu, h.tv, &s)) Ka = v3(Ka.x * s.x, Ka.y * s.y, Ka.z * s.z);
  if (map_sample(sc, m, MAP_KD, h.tu, h.tv, &s)) Kd = v3(Kd.x * s.x, Kd.y * s.y, Kd.z * s.z);
  if (map_sample(sc, m, MAP_KE, h.tu, h.tv, &s)) Ke = s;
  if (map_sample(sc, m, MAP_NORM, h.tu, h.tv, &s)) n = tbn_map(h, h.n, s);
  if (PH) tock(cyc, PH_DECODE, t0);
  return v3(Ka.x + Kd.x * (0.2f + n.y) + Ke.x, Ka.y + Kd.y * (0.2f + n.y) + Ke.y,
            Ka.z + Kd.z * (0.2f + n.y) + Ke.z);
}

// ---- the bounce kernel's body (bounce_kernel.cu; bounce_host.cpp) ------
// One bounce of the per-bounce route for the rays a walk (the forest or
// streamed kernels) has queried: the counterpart of the body of the JAX
// package's `lax.while_loop` (pathtracer0_tpu/render/integrator.py:180-287)
// and of its Whitted `direct_diffuse` (:295), and the camera form that
// begins each sample's rays on the same state. Plain versions:
// kernels/bounce.py `bounce_step_plain`, `camera_step_plain`.
enum { FORM_PATH, FORM_WHITTED, FORM_LOCATE, FORM_CAMERA };

// The state of R rays, one array per component ((3, R): x, then y, then z)
// or per entry ((S, R) stack), updated in place (kernels/bounce.py
// `BounceState`, field for field).
struct BounceArgs {
  SceneArgs scene;
  // the walk: closest triangle of each ray, t, u, v and its row (-1: none),
  // and the permutation from a row to a triangle id (null: the row is it)
  const float* walk_t;
  const float* walk_u;
  const float* walk_v;
  const int* walk_row;
  const int* perm;
  float* o;                   // (3, R) origins, not nudged
  float* d;                   // (3, R)
  float* col;                 // (3, R) throughput
  float* inc;                 // (3, R) radiance without sky; WHITTED: out
  float* skyc;                // (3, R) sky radiance
  float* enter;               // (3, R) where the ray entered the medium
  float* stack;               // (S, R) refraction indices, bottom first
  int* ssize;                 // (R,)
  unsigned char* inobj;       // (R,) bool
  long long* state;           // (R,) RNG state
  unsigned char* alive;       // (R,) bool
  long long* queries;         // (R,) scene queries
  const float* probe_t;       // WHITTED: the thickness probe's t, or null
  float* loc;                 // LOCATE: out, (3, R) hit locations
  const float* pd;            // CAMERA: (3, R) primary directions
  const float* cam;           // CAMERA: camera position (3), rotation
                              // matrix (9, row-major), focal distance
  float* total;               // CAMERA: (3, R) radiance summed over the
                              // samples, or null
  int n_rays, stack_size, form;
  int accumulate;             // CAMERA: add the sample before into total
                              // (else total = 0)
  float blur;                 // CAMERA
};

// Ray r: nudge, the hit record from the walk's triangle (finish_hit), then
// PATH: the path's shading half (path_shade) with its stack and entry
// point in device memory, its state written back where it hit, one query
// counted; a miss reads its throughput and sky radiance alone, adds the
// sky and ends the ray. WHITTED: writes the Whitted shade into inc (0 where not alive),
// a subsurface material shaded by the thickness behind the hit where
// probe_t is given (render/integrator.py `_direct`). LOCATE: writes the
// hit location (the nudged origin where not alive), which the thickness
// probe walks from.
template <int FORM>
PT_HD void bounce_ray(const Scene& sc, const BounceArgs& a, int r) {
  const int n = a.n_rays;
  const bool alive = a.alive[r] != 0;
  if (FORM == FORM_PATH && !alive) return;
  const V3 o = load3(a.o, r, n), d = load3(a.d, r, n);
  const V3 on = v3(o.x + NUDGE * d.x, o.y + NUDGE * d.y, o.z + NUDGE * d.z);
  if (!alive) {
    if (FORM == FORM_LOCATE) store3(a.loc, r, n, on);
    if (FORM == FORM_WHITTED) store3(a.inc, r, n, v3(0.0f, 0.0f, 0.0f));
    return;
  }
  const int row = a.walk_row[r];
  const int tri = row < 0 ? -1 : (a.perm ? a.perm[row] : row);
  // the path form reads the triangle's rows in 8-byte loads (it paid there;
  // the locate form lost to it)
  const Hit h = finish_hit<false, FORM == FORM_PATH>(sc, on, d, a.walk_t[r], tri,
                                                     a.walk_u[r], a.walk_v[r]);
  if (FORM == FORM_LOCATE) {
    store3(a.loc, r, n, v3(on.x + h.t * d.x, on.y + h.t * d.y, on.z + h.t * d.z));
    return;
  }
  if (FORM == FORM_WHITTED) {
    V3 c = direct_shade(sc, h, d);
    if (a.probe_t && h.is_hit && mat_col(sc, h.mat, 41) > 0.0f) {
      // thickness: the same direction again from the hit point
      // (frag.glsl:662-676), the distance actually travelled
      const float si = a.probe_t[r];
      float k[3];
      for (int i = 0; i < 3; ++i) {
        const float sigma_t = 1.0f / nan_max(mat_col(sc, h.mat, 45 + i), 1e-4f);
        k[i] = expf(-sigma_t * si) * mat_col(sc, h.mat, 42 + i);
      }
      c = v3(k[0], k[1], k[2]);
    }
    store3(a.inc, r, n, c);
    return;
  }
  a.queries[r] += 1;
  if (!h.is_hit) {
    // a miss reads its throughput and sky radiance, nothing else
    V3 skyc = load3(a.skyc, r, n);
    path_miss(sc, d, load3(a.col, r, n), skyc);
    store3(a.skyc, r, n, skyc);
    a.alive[r] = 0;
    return;
  }
  PathStateT<ColumnStack, ColumnEnter> p;
  p.o = o;
  p.d = d;
  p.col = load3(a.col, r, n);
  p.stk = ColumnStack{a.stack + r, n};
  const int ssize = a.ssize[r];
  const bool inobj = a.inobj[r] != 0;
  p.ssize = ssize;
  p.inobj = inobj;
  p.enter = ColumnEnter{a.enter, r, n};
  p.alive = true;
  p.bounce = 0;
  V3 inc = load3(a.inc, r, n), skyc = v3(0.0f, 0.0f, 0.0f);
  uint32_t state = (uint32_t)a.state[r];
  path_shade(sc, p, h, on, state, a.stack_size, a.scene.gate_ss != 0, inc, skyc);
  store3(a.o, r, n, p.o);
  store3(a.d, r, n, p.d);
  store3(a.col, r, n, p.col);
  store3(a.inc, r, n, inc);
  // the stack size and the medium flag where they changed (path_shade
  // wrote the pushed entry and the entry point itself)
  if (p.inobj != inobj) a.inobj[r] = p.inobj;
  if (p.ssize != ssize) a.ssize[r] = p.ssize;
  a.state[r] = (long long)state;
  if (!p.alive) a.alive[r] = 0;
}

// The camera form: ray r's next sample, the camera's ray with depth of
// field from its primary direction and RNG state (PixelCamera::ray: 6
// draws), written into o, d and state, the ray alive. With `total`, the
// sample before is added into it first (total + (inc + skyc), render_rays'
// order of sums; the Whitted state has no skyc: total + inc), or total is
// set to 0. The path state (stack non-null) is begun as kernels/bounce.py
// `begin` begins it: throughput 1, radiance, sky radiance and entry point 0,
// the stack holding the air's index, outside any medium, no query counted
// (with `accumulate` the queries run on over the samples).
PT_HD void camera_ray(const BounceArgs& a, int r) {
  const int n = a.n_rays;
  PixelCamera cam;
  for (int i = 0; i < 9; ++i) cam.r[i] = ld_ro(a.cam + 3 + i);
  cam.c = v3(ld_ro(a.cam), ld_ro(a.cam + 1), ld_ro(a.cam + 2));
  cam.ifd = ld_ro(a.cam + 12);
  cam.blur = a.blur;
  cam.pd = load3(a.pd, r, n);
  uint32_t state = (uint32_t)a.state[r];
  V3 o, d;
  cam.ray(state, o, d);
  store3(a.o, r, n, o);
  store3(a.d, r, n, d);
  a.state[r] = (long long)state;
  a.alive[r] = 1;
  if (a.total) {
    V3 t = v3(0.0f, 0.0f, 0.0f);
    if (a.accumulate) {
      V3 c = load3(a.inc, r, n);
      if (a.skyc) {
        const V3 s = load3(a.skyc, r, n);
        c = v3(c.x + s.x, c.y + s.y, c.z + s.z);
      }
      t = load3(a.total, r, n);
      t = v3(t.x + c.x, t.y + c.y, t.z + c.z);
    }
    store3(a.total, r, n, t);
  }
  if (a.stack) {
    const V3 zero = v3(0.0f, 0.0f, 0.0f);
    store3(a.col, r, n, v3(1.0f, 1.0f, 1.0f));
    store3(a.inc, r, n, zero);
    store3(a.skyc, r, n, zero);
    store3(a.enter, r, n, zero);
    a.stack[r] = AIR_IOR;
    a.ssize[r] = 1;
    a.inobj[r] = 0;
    if (!a.accumulate) a.queries[r] = 0;
  }
}

#ifdef __CUDACC__
// One bounce of a live path: one scene query (closest_hit; STAGED: its)
// and its shading half. PH: add the cycles of each part into cyc.
template <bool PH = false, bool STAGED = false>
__device__ __forceinline__ void path_step(const Scene& sc, PathState& p, uint32_t& state, int S,
                                          bool gate_ss, V3& inc, V3& skyc,
                                          unsigned long long* cyc = nullptr) {
  const V3 o = p.o, d = p.d;
  ++p.bounce;
  V3 on = v3(o.x + NUDGE * d.x, o.y + NUDGE * d.y, o.z + NUDGE * d.z);
  Hit h = closest_hit<PH, STAGED>(sc, on, d, cyc);
  path_shade<PH>(sc, p, h, on, state, S, gate_ss, inc, skyc, cyc);
}

// Check-only instantiations of the kernels that run paths (frame_kernel.cu,
// block_kernel.cu), never launched on the main path, whose instantiations
// (NO_CHECK) count nothing:
//   LANES   adds, for each group of lanes that runs a bounce together, the
//           lanes in it (__popc(__activemask())) and one warp step, so the
//           share of the 32 lanes that a bounce step keeps busy can be read;
//   PHASES  adds the clock64() cycles of each part of a scene query per
//           warp (pathtrace.cuh PH_*) and each warp's cycles from start to
//           end, so the share of a warp's time each part takes can be read.
enum { NO_CHECK, LANES, PHASES };

// LANES: the lanes that run this bounce step together, counted once by the
// lowest of them.
template <int CHECK>
__device__ __forceinline__ void count_lanes(unsigned long long& used,
                                            unsigned long long& steps) {
  if (CHECK == LANES) {
    const unsigned mask = __activemask();
    if ((threadIdx.x & 31) == __ffs(mask) - 1) {
      used += __popc(mask);
      ++steps;
    }
  }
}

// One sample's path from ray (o, d), bounce after bounce, with the
// refraction stack `stk` (the block kernel's loop; STAGED: closest_hit's).
// Adds the radiance without sky into inc and the sky into skyc; returns the
// queries made. CHECK: count into used and steps (LANES) or the parts'
// cycles into cyc (PHASES).
template <int CHECK, bool STAGED>
__device__ int trace_path(const Scene& sc, V3 o, V3 d, uint32_t& state,
                          int max_bounces, int S, bool gate_ss, V3& inc,
                          V3& skyc, float* stk, unsigned long long* used = nullptr,
                          unsigned long long* steps = nullptr,
                          unsigned long long* cyc = nullptr) {
  PathState p;
  path_begin(p, o, d, stk);
  int queries = 0;
  while (path_on(p, max_bounces)) {
    if (CHECK == LANES) count_lanes<CHECK>(*used, *steps);
    ++queries;
    path_step<CHECK == PHASES, STAGED>(sc, p, state, S, gate_ss, inc, skyc, cyc);
  }
  return queries;
}

// Whitted shade (frag.glsl:655-681) of ray (o, d) over the closest hit.
// PH: as path_step.
template <bool PH = false>
__device__ V3 direct_diffuse(const Scene& sc, V3 o, V3 d, unsigned long long* cyc = nullptr) {
  V3 on = v3(o.x + NUDGE * d.x, o.y + NUDGE * d.y, o.z + NUDGE * d.z);
  Hit h = closest_hit<PH>(sc, on, d, cyc);
  return direct_shade<PH>(sc, h, d, cyc);
}

// Add every thread's `value` of a BLOCK-wide block into *total with one
// atomic (T: unsigned long long or unsigned int). Every thread of the
// block must call it.
template <typename T>
__device__ __forceinline__ void block_sum_add(T value, T* total) {
  __shared__ T warp_sum[BLOCK / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) value += __shfl_down_sync(0xffffffffu, value, off);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = value;
  __syncthreads();
  if (threadIdx.x == 0) {
    T sum = 0;
#pragma unroll
    for (int w = 0; w < BLOCK / 32; ++w) sum += warp_sum[w];
    if (sum) atomicAdd(total, sum);
  }
}
#endif  // __CUDACC__

}  // namespace pt
