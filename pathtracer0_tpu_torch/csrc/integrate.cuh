// The integrators of one ray, shared by the frame kernel
// (frame_kernel.cu) and the block kernel (block_kernel.cu): the path
// (frag.glsl:810-882: `PathState`, `path_begin`, `path_step` and the loop
// over them, `trace_path`) and the Whitted `direct_diffuse`
// (frag.glsl:655-681) over pathtrace.cuh's brute-force closest hit, the
// scene arguments both launchers take, and the per-block sum of the
// query count. Plain version: pathtracer0_tpu_torch/render/integrator.py
// `trace_plain` and `direct_diffuse_plain`.
#pragma once

#include <cuda_runtime.h>

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

__device__ __forceinline__ Scene make_scene(const SceneArgs& a) {
  return Scene{a.mats, a.ell, a.imp, a.ell_flags, a.imp_info, a.tris, a.attr,
               a.uvt, a.atlas, a.slots, a.mat_maps, a.sky, a.n_mats, a.n_ell,
               a.n_imp, a.n_tris, a.sky_h, a.sky_w, a.march_steps,
               a.bisect_iters, a.march_tmax};
}

__device__ __forceinline__ float mat_col(const Scene& sc, int mat, int col) {
  return __ldg(sc.mats + mat * 48 + col);
}

// The path integrator of one ray (frag.glsl:810-882), in three pieces that
// both schedules of the frame kernel share: the state a path carries from
// bounce to bounce, `path_begin` and `path_step` (one bounce). `trace_path`
// is the per-sample loop over them; the refill schedule of
// frame_kernel.cu runs one flat loop over (sample, bounce) instead.
//
// The refraction-index stack lives in shared memory, bottom first: entry j
// of a thread's stack at stk[j * BLOCK] (a warp's lanes on 32 banks at any
// depths). A bounce reads the top two entries and pushes or pops one, so
// nothing is shifted and the stack holds no registers. Entries at and past
// `ssize` read as 0, as those of a stack shifted in place.
struct PathState {
  V3 o, d, col;          // ray, throughput
  float* stk;            // this thread's refraction-index stack
  int ssize;
  bool inobj;
  V3 enter;              // where the ray entered the medium
  bool alive;
  int bounce;            // bounces taken
};

// `stk`: the thread's stack, MAX_STACK entries BLOCK floats apart.
__device__ __forceinline__ void path_begin(PathState& p, V3 o, V3 d, float* stk) {
  p.o = o;
  p.d = d;
  p.col = v3(1.0f, 1.0f, 1.0f);
  p.stk = stk;
  stk[0] = AIR_IOR;
  p.ssize = 1;
  p.inobj = false;
  p.enter = v3(0.0f, 0.0f, 0.0f);
  p.alive = true;
  p.bounce = 0;
}

// Whether the path takes another bounce (`ray_on` of fused.py:1207).
__device__ __forceinline__ bool path_on(const PathState& p, int max_bounces) {
  return p.alive && p.bounce < max_bounces;
}

// One bounce of a live path: one scene query. Adds the emission into inc
// and, on a miss, the sky into skyc; a miss or the throughput cut-off ends
// the path (alive = false). PH: add the cycles of the closest hit, the
// material decode with its maps, the sky and the lobe choice with the
// refraction stack into cyc. STAGED: closest_hit's.
template <bool PH = false, bool STAGED = false>
__device__ __forceinline__ void path_step(const Scene& sc, PathState& p, uint32_t& state, int S,
                                          bool gate_ss, V3& inc, V3& skyc,
                                          unsigned long long* cyc = nullptr) {
  const V3 o = p.o, d = p.d;
  V3 col = p.col;
  ++p.bounce;
  V3 on = v3(o.x + NUDGE * d.x, o.y + NUDGE * d.y, o.z + NUDGE * d.z);
  Hit h = closest_hit<PH, STAGED>(sc, on, d, cyc);
  long long t0 = PH ? tick() : 0;
  if (!h.is_hit) {
    V3 s = sky_color(sc.sky, sc.sky_h, sc.sky_w, d);
    if (col.x > 0.0f) skyc.x += s.x * col.x;
    if (col.y > 0.0f) skyc.y += s.y * col.y;
    if (col.z > 0.0f) skyc.z += s.z * col.z;
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
  // second and pops
  const bool entering = nd < 0.0f;
  const int ns = p.ssize;
  const float s0 = ns >= 1 ? p.stk[(ns - 1) * BLOCK] : 0.0f;
  const float s1 = ns >= 2 ? p.stk[(ns - 2) * BLOCK] : 0.0f;
  float n1 = s0, n2 = s1;
  if (entering) {
    if (ns < S) {
      p.stk[ns * BLOCK] = Ni;
      p.ssize = ns + 1;
      n2 = Ni;
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
  V3 dd = v3(p.enter.x - hx.x, p.enter.y - hx.y, p.enter.z - hx.z);
  float dist = sqrtf(dot(dd, dd));
  bool apply_absorb = transmitted && (!entering || p.inobj);
  if (transmitted) {
    p.inobj = entering;
    if (entering) p.enter = hx;
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

// Whitted shade (frag.glsl:655-681): Ka + Kd (0.2 + N.y) + Ke on a hit
// with the unflipped normal, the sky on a miss. PH: as path_step.
template <bool PH = false>
__device__ V3 direct_diffuse(const Scene& sc, V3 o, V3 d, unsigned long long* cyc = nullptr) {
  V3 on = v3(o.x + NUDGE * d.x, o.y + NUDGE * d.y, o.z + NUDGE * d.z);
  Hit h = closest_hit<PH>(sc, on, d, cyc);
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

// Add every thread's `value` of a BLOCK-wide block into *total with one
// atomic. Every thread of the block must call it.
__device__ __forceinline__ void block_sum_add(unsigned long long value,
                                              unsigned long long* total) {
  __shared__ unsigned long long warp_sum[BLOCK / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) value += __shfl_down_sync(0xffffffffu, value, off);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = value;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long sum = 0;
#pragma unroll
    for (int w = 0; w < BLOCK / 32; ++w) sum += warp_sum[w];
    if (sum) atomicAdd(total, sum);
  }
}

}  // namespace pt
