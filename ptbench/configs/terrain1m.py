"""The terrain configuration's data and its plain scene query.

`mesh` is the benchmark's frozen copy of the scale benchmark's height
field (bench.py:237-320): n x n vertices over [-ext, ext]^2 in x and z,
two triangles a quad, 999,698 triangles at n = 708.

`GridQuery` is the reference's own scene query for it, built from the
triangles and nothing of the program: a uniform grid over x and z whose
cells are the quads, each holding the two triangles that lie in it
(checked when it is built), walked cell by cell along each ray in the
order the ray crosses them (a 2D DDA), with the same division-free
triangle test as the renderer. The first cell whose triangles give a hit
no farther than the cell's exit holds the closest one, since every later
cell lies farther along the ray.
"""
from __future__ import annotations

import numpy as np
import torch

from ptbench.reference.tracer import MISS, tri_candidate

# cells a ray crosses in one step of the walk
STEPS = 16


def mesh(params):
    """(verts (n*n, 3) float64, faces (2 (n - 1)^2, 3) int64, grid xs)."""
    n = int(params["n"])
    ext = float(params["extent"]) * (n / 708.0)
    xs = np.linspace(-ext, ext, n)
    X, Z = np.meshgrid(xs, xs)
    Y = (np.sin(X * 0.35) * np.cos(Z * 0.28) * 1.8
         + np.sin(X * 0.09 + 1.3) * 4.0
         + np.random.RandomState(0).rand(n, n) * 0.15)
    g = np.arange(n * n, dtype=np.int64).reshape(n, n)
    ga, gb = g[:-1, :-1].reshape(-1), g[1:, :-1].reshape(-1)
    gc, gd = g[:-1, 1:].reshape(-1), g[1:, 1:].reshape(-1)
    faces = np.concatenate([np.stack([ga, gb, gc], axis=1),
                            np.stack([gd, gb, gc], axis=1)])
    return np.stack([X, Y, Z], axis=-1).reshape(-1, 3), faces, xs


def camera(params):
    """(position, rotation) over the terrain from its near edge."""
    n = int(params["n"])
    return ((0.0, 14.0, -float(params["extent"]) * (n / 708.0) * 1.16),
            (0.25, 0.0, 0.0))


class GridQuery:
    """The closest triangle of rays over the quads of a height field."""

    def __init__(self, xs, v1, v2, v3, rows):
        n = xs.shape[0]
        q = n - 1
        # each triangle lies in its quad's cell: A = (i, j), B = q^2 + A
        lo = np.minimum(np.minimum(v1, v2), v3)
        hi = np.maximum(np.maximum(v1, v2), v3)
        cell = np.arange(q * q)
        i, j = np.concatenate([cell, cell]) // q, np.concatenate(
            [cell, cell]) % q
        if not (v1.shape[0] == 2 * q * q
                and np.array_equal(lo[:, 0], xs[j])
                and np.array_equal(hi[:, 0], xs[j + 1])
                and np.array_equal(lo[:, 2], xs[i])
                and np.array_equal(hi[:, 2], xs[i + 1])):
            raise ValueError("the triangles are not the grid's two a quad")
        dev = rows[0].device
        self.q = q
        self.xs = torch.tensor(xs, dtype=torch.float64, device=dev)
        self.rows = rows
        self.y = (float(lo[:, 1].min()) - 1.0, float(hi[:, 1].max()) + 1.0)

    def to(self, dtype):
        out = object.__new__(GridQuery)
        out.__dict__.update(self.__dict__)
        out.rows = tuple(r.to(dtype) for r in self.rows)
        return out

    def __call__(self, o, d, alive):
        xs, q = self.xs, self.q
        o64 = [c.to(torch.float64) for c in o]
        d64 = [c.to(torch.float64) for c in d]
        lo = (xs[0], self.y[0], xs[0])
        hi = (xs[-1], self.y[1], xs[-1])
        t0 = torch.zeros_like(o64[0])
        t1 = torch.full_like(o64[0], float("inf"))
        for a in range(3):
            flat = d64[a] == 0.0
            inside = (o64[a] >= lo[a]) & (o64[a] <= hi[a])
            safe = torch.where(flat, 1.0, d64[a])
            ta, tb = (lo[a] - o64[a]) / safe, (hi[a] - o64[a]) / safe
            t0 = torch.where(flat, torch.where(inside, t0, float("inf")),
                             torch.maximum(t0, torch.minimum(ta, tb)))
            t1 = torch.where(flat, t1,
                             torch.minimum(t1, torch.maximum(ta, tb)))
        t = torch.full_like(o[0], MISS)
        u, v = torch.zeros_like(o[0]), torch.zeros_like(o[0])
        tri = torch.full(o[0].shape, -1, dtype=torch.int64,
                         device=o[0].device)
        sel = (alive & (t0 <= t1)).nonzero()[:, 0]

        def cell(p):
            return torch.clamp(torch.searchsorted(
                xs, p.contiguous(), right=True) - 1, 0, q - 1)

        j = cell(o64[0][sel] + t0[sel] * d64[0][sel])
        i = cell(o64[2][sel] + t0[sel] * d64[2][sel])
        steps = torch.arange(1, STEPS + 1, device=xs.device)
        while sel.numel():
            i, j, t, u, v, tri, done = self._steps(
                sel, i, j, steps, o, d, o64, d64, t1, t, u, v, tri)
            keep = (~done).nonzero()[:, 0]
            sel, i, j = sel[keep], i[keep], j[keep]
        return t, u, v, tri

    def _steps(self, sel, i, j, steps, o, d, o64, d64, t1, t, u, v, tri):
        """The next STEPS cells of rays `sel` from cells (i, j): their
        triangles tested, the closest hit kept where it lies in them."""
        xs, q = self.xs, self.q
        sx = torch.sign(d64[0][sel]).to(torch.int64)
        sz = torch.sign(d64[2][sel]).to(torch.int64)

        def crossings(c, s, oo, dd):
            # the times of the next STEPS grid lines the ray crosses
            k = c[:, None] + torch.where(s > 0, 1, 0)[:, None] \
                + s[:, None] * (steps[None] - 1)
            ok = (s[:, None] != 0) & (k >= 0) & (k <= q)
            safe = torch.where(dd == 0.0, 1.0, dd)[:, None]
            tk = (xs[torch.clamp(k, 0, q)] - oo[:, None]) / safe
            return torch.where(ok, tk, float("inf"))

        tx = crossings(j, sx, o64[0][sel], d64[0][sel])
        tz = crossings(i, sz, o64[2][sel], d64[2][sel])
        times, order = torch.sort(torch.cat([tx, tz], 1), dim=1, stable=True)
        times = times[:, :STEPS]
        is_x = (order[:, :STEPS] < STEPS).to(torch.int64)
        # cell m lies between crossing m - 1 and crossing m
        jm = j[:, None] + sx[:, None] * torch.cat(
            [torch.zeros_like(is_x[:, :1]), is_x.cumsum(1)], 1)
        im = i[:, None] + sz[:, None] * torch.cat(
            [torch.zeros_like(is_x[:, :1]), (1 - is_x).cumsum(1)], 1)
        enter = torch.cat([torch.full_like(times[:, :1], -float("inf")),
                           times[:, :-1]], 1)
        valid = ((enter < t1[sel, None]) & (jm[:, :STEPS] >= 0)
                 & (jm[:, :STEPS] < q) & (im[:, :STEPS] >= 0)
                 & (im[:, :STEPS] < q))
        base = (torch.clamp(im[:, :STEPS], 0, q - 1) * q
                + torch.clamp(jm[:, :STEPS], 0, q - 1))
        ids = torch.stack([base, base + q * q], 2).reshape(sel.shape[0], -1)
        ok_cell = valid.repeat_interleave(2, 1)
        v1, e1, e2 = (r[ids] for r in self.rows)
        ok, tc, adet, uc, vc = tri_candidate(
            tuple(c[sel, None] for c in o), tuple(c[sel, None] for c in d),
            v1.unbind(-1), e1.unbind(-1), e2.unbind(-1))
        ok = ok & ok_cell
        dist = torch.where(ok, tc / torch.where(ok, adet, 1.0), float("inf"))
        # the first of the closest in the order the ray meets them
        k = torch.argmin(dist, 1)
        rows = torch.arange(sel.shape[0], device=sel.device)
        got = ok[rows, k]
        inv = 1.0 / adet[rows, k]
        t_k, u_k, v_k = tc[rows, k] * inv, uc[rows, k] * inv, vc[rows, k] * inv
        found = got & (dist[rows, k].to(torch.float64) <= times[:, -1])
        hit = sel[found]
        t[hit], u[hit], v[hit] = t_k[found], u_k[found], v_k[found]
        tri[hit] = ids[rows, k][found]
        done = (found | (times[:, -1] >= t1[sel]) | (jm[:, -1] < 0)
                | (jm[:, -1] >= q) | (im[:, -1] < 0) | (im[:, -1] >= q))
        return im[:, -1], jm[:, -1], t, u, v, tri, done


def reference_query(params, verts, faces, extra, rows):
    """The scene query of the reference for this configuration's mesh."""
    v1, v2, v3 = (verts[faces[:, k]] for k in range(3))
    return GridQuery(extra, v1, v2, v3, rows)


