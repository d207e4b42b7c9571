// Host-side builder of the streamed two-level LBVH (accel/lbvh.py twin),
// own copy of the JAX package's native/streambuild.cpp with the port's
// table layouts: one triangle per 9-float row, one box per 8-float row.
//
// Four passes:
//   1. centroid bounds (double, same IEEE operations as (v1+v2+v3)/3.0 in
//      NumPy);
//   2. the triangle order: mode 0 Morton codes (quantized in float32 exactly
//      like lbvh.morton_codes, up to 21 bits an axis) and a stable LSD radix
//      sort (= NumPy's kind="stable" argsort); mode 1 the balanced
//      median-split order (median_order below);
//   3. gather and pack the triangles (float32 [a, b-a, c-a], 14 to a row)
//      with the per-row boxes on the fly;
//   4. bottom-up boxes of the complete tree: the top tree down to treelets
//      and each treelet's subtree over groups of rows.
//
// Mode 0 is bit-equal to lbvh._build_streamed_numpy (tests/
// test_torch_lbvh.py): every arithmetic step mirrors the NumPy expression
// noted inline. Plain C interface for ctypes; built on first use by
// kernels/build.py with g++ -O3 -ffp-contract=off -shared -fPIC.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int64_t BOX = 8;  // floats in a box row: min xyz, max xyz, 2 pads

// Spread the low 21 bits of v so there are two zero bits between each
// (the classic 64-bit Morton magic); mirrors accel/lbvh.morton_codes.
inline uint64_t spread21(uint64_t v) {
    v &= 0x1fffffULL;
    v = (v | (v << 32)) & 0x1f00000000ffffULL;
    v = (v | (v << 16)) & 0x1f0000ff0000ffULL;
    v = (v | (v << 8)) & 0x100f00f00f00f00fULL;
    v = (v | (v << 4)) & 0x10c30c30c30c30c3ULL;
    v = (v | (v << 2)) & 0x1249249249249249ULL;
    return v;
}

// Balanced median-split ordering (mode 1): recursively partition the
// triangle ids to match the complete tree's fixed row capacities — the
// left child of a node covering `rows` leaf rows holds EXACTLY
// rows/2 * tris_per_row triangles (when available), selected as the
// smallest centroids along the widest axis via nth_element. Unlike the
// Morton order, every tree node then bounds an actual object-median
// partition, so node AABBs are tight at all levels; padding naturally
// accumulates in the right-most rows. O(n log n), same output layout.
void median_order(const float* cent, int64_t* ids, int64_t n, int64_t rows,
                  int64_t tris_per_row) {
    if (rows <= 1 || n <= 1) return;
    const int64_t cap_left = (rows / 2) * tris_per_row;
    const int64_t k = n < cap_left ? n : cap_left;
    if (k > 0 && k < n) {
        float mn[3] = {INFINITY, INFINITY, INFINITY};
        float mx[3] = {-INFINITY, -INFINITY, -INFINITY};
        for (int64_t i = 0; i < n; ++i) {
            const float* c = cent + 3 * ids[i];
            for (int a = 0; a < 3; ++a) {
                mn[a] = fminf(mn[a], c[a]);
                mx[a] = fmaxf(mx[a], c[a]);
            }
        }
        int axis = 0;
        float best = mx[0] - mn[0];
        for (int a = 1; a < 3; ++a)
            if (mx[a] - mn[a] > best) {
                best = mx[a] - mn[a];
                axis = a;
            }
        std::nth_element(ids, ids + k, ids + n,
                         [cent, axis](int64_t x, int64_t y) {
                             return cent[3 * x + axis] < cent[3 * y + axis];
                         });
    }
    median_order(cent, ids, k, rows / 2, tris_per_row);
    median_order(cent, ids + k, n - k, rows - rows / 2, tris_per_row);
}

}  // namespace

extern "C" {

// Build the streamed forest. All output buffers are caller-allocated and
// ZEROED (np.zeros); only live entries are written, zero padding
// self-masks in the kernel (det == 0 rows, see accel/lbvh.py docstring).
//
//   v1/v2/v3 : (t, 3) float64, C-contiguous
//   bits     : Morton bits per axis (<= 21)
//   tris     : (r_pad * tris_per_row, 9) float32, slot = row * tris_per_row
//              + position in the row
//   row_perm : (r_pad * tris_per_row,) int32, caller-filled with -1
//   ctree_f  : (2 * n_treelets - 1, 8) float32
//   sub_f    : (n_treelets * 2 * n_groups, 8) float32
//
// where r_pad = n_treelets * treelet_rows, n_treelets is the power-of-two
// treelet count and n_groups = treelet_rows / sub_group_rows — all
// computed by the Python wrapper with the same formulas as the NumPy
// builder. Returns 0 on success.
int64_t pt0_build_streamed(const double* v1, const double* v2,
                           const double* v3, int64_t t, int64_t tris_per_row,
                           int64_t treelet_rows, int64_t sub_group_rows,
                           int64_t bits, int64_t n_treelets, int64_t mode,
                           float* tris, int32_t* row_perm, float* ctree_f,
                           float* sub_f) {
    if (t <= 0 || bits < 1 || bits > 21) return 1;
    if (mode != 0 && mode != 1) return 3;
    const int64_t n_rows = (t + tris_per_row - 1) / tris_per_row;
    const int64_t r_pad = n_treelets * treelet_rows;
    if (n_rows > r_pad) return 2;

    // ---- pass 1: centroid bounds (double, matching (v1+v2+v3)/3.0) ------
    double lo[3] = {INFINITY, INFINITY, INFINITY};
    double hi[3] = {-INFINITY, -INFINITY, -INFINITY};
    for (int64_t i = 0; i < t; ++i) {
        for (int k = 0; k < 3; ++k) {
            const double c =
                (v1[3 * i + k] + v2[3 * i + k] + v3[3 * i + k]) / 3.0;
            if (c < lo[k]) lo[k] = c;
            if (c > hi[k]) hi[k] = c;
        }
    }
    double span[3];
    for (int k = 0; k < 3; ++k) {
        span[k] = hi[k] - lo[k];
        if (span[k] < 1e-12) span[k] = 1e-12;  // np.maximum(hi - lo, 1e-12)
    }

    // ---- pass 2: triangle ordering ---------------------------------------
    std::vector<int64_t> order(static_cast<size_t>(t));
    for (int64_t i = 0; i < t; ++i) order[static_cast<size_t>(i)] = i;
    if (mode == 0) {
        // Morton codes + stable LSD radix argsort
        const float scale = static_cast<float>((1ULL << bits) - 1ULL);
        std::vector<uint64_t> codes(static_cast<size_t>(t));
        for (int64_t i = 0; i < t; ++i) {
            uint64_t q[3];
            for (int k = 0; k < 3; ++k) {
                const double c =
                    (v1[3 * i + k] + v2[3 * i + k] + v3[3 * i + k]) / 3.0;
                // norm.astype(np.float32) then * np.float32(2**bits - 1),
                // clipped and truncated — the exact morton_codes sequence
                const float nf = static_cast<float>((c - lo[k]) / span[k]);
                float s = nf * scale;
                if (!(s > 0.0f)) s = 0.0f;  // also catches NaN
                if (s > scale) s = scale;
                q[k] = static_cast<uint64_t>(s);
            }
            codes[static_cast<size_t>(i)] = (spread21(q[0]) << 2) |
                                            (spread21(q[1]) << 1) |
                                            spread21(q[2]);
        }
        // 4 passes x 16-bit digits over (code, index) pairs; LSD radix is
        // stable, matching np.argsort(kind="stable") tie order.
        std::vector<int64_t> order_tmp(static_cast<size_t>(t));
        std::vector<uint64_t> codes_tmp(static_cast<size_t>(t));
        const int needed_bits = static_cast<int>(3 * bits);
        std::vector<int64_t> hist(1 << 16);
        for (int shift = 0; shift < needed_bits; shift += 16) {
            std::memset(hist.data(), 0, hist.size() * sizeof(int64_t));
            for (int64_t i = 0; i < t; ++i)
                ++hist[(codes[static_cast<size_t>(i)] >> shift) & 0xffff];
            int64_t run = 0;
            for (size_t d = 0; d < hist.size(); ++d) {
                const int64_t c = hist[d];
                hist[d] = run;
                run += c;
            }
            for (int64_t i = 0; i < t; ++i) {
                const uint64_t code = codes[static_cast<size_t>(i)];
                const int64_t dst = hist[(code >> shift) & 0xffff]++;
                codes_tmp[static_cast<size_t>(dst)] = code;
                order_tmp[static_cast<size_t>(dst)] =
                    order[static_cast<size_t>(i)];
            }
            codes.swap(codes_tmp);
            order.swap(order_tmp);
        }
    } else {
        // mode 1: balanced median-split order over f32 centroids. The
        // complete tree's row capacities drive the partition sizes, so
        // the recursion must mirror pass 4's padding (real rows first).
        std::vector<float> cent(static_cast<size_t>(t) * 3);
        for (int64_t i = 0; i < t; ++i)
            for (int k = 0; k < 3; ++k)
                cent[static_cast<size_t>(3 * i + k)] = static_cast<float>(
                    (v1[3 * i + k] + v2[3 * i + k] + v3[3 * i + k]) / 3.0);
        median_order(cent.data(), order.data(), t, r_pad, tris_per_row);
    }

    // ---- pass 3: gather + pack rows + per-row AABBs ----------------------
    std::vector<float> row_min(static_cast<size_t>(r_pad) * 3, INFINITY);
    std::vector<float> row_max(static_cast<size_t>(r_pad) * 3, -INFINITY);
    for (int64_t k = 0; k < t; ++k) {
        const int64_t id = order[static_cast<size_t>(k)];
        const int64_t row = k / tris_per_row;
        float* dst = tris + 9 * k;
        float* rmin = row_min.data() + 3 * row;
        float* rmax = row_max.data() + 3 * row;
        for (int c = 0; c < 3; ++c) {
            // sa = v[order].astype(f32); edges subtracted IN f32
            const float a = static_cast<float>(v1[3 * id + c]);
            const float b = static_cast<float>(v2[3 * id + c]);
            const float cc = static_cast<float>(v3[3 * id + c]);
            dst[c] = a;
            dst[3 + c] = b - a;
            dst[6 + c] = cc - a;
            const float mn = fminf(fminf(a, b), cc);
            const float mx = fmaxf(fmaxf(a, b), cc);
            if (mn < rmin[c]) rmin[c] = mn;
            if (mx > rmax[c]) rmax[c] = mx;
        }
        row_perm[k] = static_cast<int32_t>(id);
    }

    // ---- pass 4a: per-treelet subtree AABBs over row groups --------------
    const int64_t n_groups = treelet_rows / sub_group_rows;
    const int64_t sub_stride = 2 * n_groups;
    for (int64_t tl = 0; tl < n_treelets; ++tl) {
        float* base = sub_f + BOX * sub_stride * tl;
        // leaves: groups of sub_group_rows rows at heap [n_groups-1, ...)
        for (int64_t g = 0; g < n_groups; ++g) {
            float mn[3] = {INFINITY, INFINITY, INFINITY};
            float mx[3] = {-INFINITY, -INFINITY, -INFINITY};
            const int64_t row0 = tl * treelet_rows + g * sub_group_rows;
            for (int64_t r = row0; r < row0 + sub_group_rows; ++r)
                for (int c = 0; c < 3; ++c) {
                    mn[c] = fminf(mn[c], row_min[3 * r + c]);
                    mx[c] = fmaxf(mx[c], row_max[3 * r + c]);
                }
            float* node = base + BOX * (n_groups - 1 + g);
            for (int c = 0; c < 3; ++c) {
                node[c] = mn[c];
                node[3 + c] = mx[c];
            }
        }
        // the one unused pad slot of the size-2n heap stays at the
        // inverted-infinity init value in the NumPy builder — mirror it
        float* pad = base + BOX * (2 * n_groups - 1);
        for (int c = 0; c < 3; ++c) {
            pad[c] = INFINITY;
            pad[3 + c] = -INFINITY;
        }
        // internal nodes bottom-up (heap: children of i at 2i+1, 2i+2)
        for (int64_t i = n_groups - 2; i >= 0; --i) {
            const float* l = base + BOX * (2 * i + 1);
            const float* r = base + BOX * (2 * i + 2);
            float* node = base + BOX * i;
            for (int c = 0; c < 3; ++c) {
                node[c] = fminf(l[c], r[c]);
                node[3 + c] = fmaxf(l[3 + c], r[3 + c]);
            }
        }
    }

    // ---- pass 4b: top tree at treelet granularity -------------------------
    // Treelet-level AABBs == the full row-tree reduced to the cut level
    // (min/max grouping is associative, so the values are identical).
    for (int64_t tl = 0; tl < n_treelets; ++tl) {
        // the subtree root (heap 0) already holds the treelet AABB
        const float* root = sub_f + BOX * sub_stride * tl;
        float* node = ctree_f + BOX * (n_treelets - 1 + tl);
        for (int c = 0; c < 6; ++c) node[c] = root[c];
    }
    for (int64_t i = n_treelets - 2; i >= 0; --i) {
        const float* l = ctree_f + BOX * (2 * i + 1);
        const float* r = ctree_f + BOX * (2 * i + 2);
        float* node = ctree_f + BOX * i;
        for (int c = 0; c < 3; ++c) {
            node[c] = fminf(l[c], r[c]);
            node[3 + c] = fmaxf(l[3 + c], r[3 + c]);
        }
    }
    return 0;
}

}  // extern "C"
