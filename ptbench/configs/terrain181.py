"""The terrain181 configuration's data and its plain scene query.

`mesh` and `camera` are configs/terrain1m.py's, the one copy of the height
field: here at n = 181, 64,800 triangles, which the port keeps on its SAH
forest.

`DividingGridQuery` walks the quads as that file's `GridQuery` does, and
tests a cell's triangles as the forest does, with the upstream's dividing
Moller-Trumbore test (frag.glsl:447-537, EPSILON frag.glsl:228): det =
e1 . (d x e2) and inv = 1 / det, u = (s . p) inv, v = (d . q) inv, t =
(e2 . q) inv, a hit where |det| >= 1e-10, 0 <= u <= 1, v >= 0, u + v <= 1
and t > 1e-10; the closest by a strict t < closest, so the first of equal
t in the order the ray meets them wins. Each operation is its own
PyTorch op in the rows' dtype (float32, or bfloat16 for the control), so
nothing is contracted. The division-free test of `GridQuery` accepts and
rounds apart from this one on rays that graze an edge, and a height field's
quads share a diagonal each.

The walk keeps the closest hit over the cells tested so far, where
`GridQuery` keeps the first chunk's: a hit on the edge of a chunk's last
cell rounds past that cell's exit (the float32 vertices stand off the
float64 grid lines), and the cells after it hold the triangles that share
the edge. So a chunk's hit ends the walk only where it lies short of the
chunk's last grid line by EDGE_ROOM, and the closest of every tested cell
is kept, the first met on a tie.
"""
from __future__ import annotations

from pathlib import Path

import torch

from ptbench.bench import _module
from ptbench.reference.core import dot3
from ptbench.reference.tracer import EPSILON

# how far past a chunk's last grid line, over the ray's speed across it
# and per unit of t, a hit in the chunk may lie
EDGE_ROOM = 1e-4
_grid = _module(Path(__file__).with_name("terrain1m.py"),
                "ptbench_config_terrain1m")
mesh, camera, GridQuery = _grid.mesh, _grid.camera, _grid.GridQuery


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def tri_divide(o, d, v1, e1, e2):
    """The dividing Moller-Trumbore test on (x, y, z) tuples: (ok, t, u,
    v); the closest-so-far test is the caller's."""
    p = _cross(d, e2)
    det = dot3(e1, p)
    inv = 1.0 / det
    s = (o[0] - v1[0], o[1] - v1[1], o[2] - v1[2])
    u = dot3(s, p) * inv
    q = _cross(s, e1)
    v = dot3(d, q) * inv
    t = dot3(e2, q) * inv
    ok = ((torch.abs(det) >= EPSILON) & (u >= 0.0) & (u <= 1.0)
          & (v >= 0.0) & (u + v <= 1.0) & (t > EPSILON))
    return ok, t, u, v


class DividingGridQuery(GridQuery):
    """`GridQuery` with the forest's dividing triangle test."""

    def to(self, dtype):
        out = object.__new__(type(self))
        out.__dict__.update(self.__dict__)
        out.rows = tuple(r.to(dtype) for r in self.rows)
        return out

    def _steps(self, sel, i, j, steps, o, d, o64, d64, t1, t, u, v, tri):
        """The next STEPS cells of rays `sel` from cells (i, j): their
        triangles tested, the closest hit kept where it lies in them."""
        xs, q = self.xs, self.q
        n_steps = steps.shape[0]
        sx = torch.sign(d64[0][sel]).to(torch.int64)
        sz = torch.sign(d64[2][sel]).to(torch.int64)

        def crossings(c, s, oo, dd):
            # the times of the next grid lines the ray crosses
            k = c[:, None] + torch.where(s > 0, 1, 0)[:, None] \
                + s[:, None] * (steps[None] - 1)
            ok = (s[:, None] != 0) & (k >= 0) & (k <= q)
            safe = torch.where(dd == 0.0, 1.0, dd)[:, None]
            tk = (xs[torch.clamp(k, 0, q)] - oo[:, None]) / safe
            return torch.where(ok, tk, float("inf"))

        tx = crossings(j, sx, o64[0][sel], d64[0][sel])
        tz = crossings(i, sz, o64[2][sel], d64[2][sel])
        times, order = torch.sort(torch.cat([tx, tz], 1), dim=1, stable=True)
        times = times[:, :n_steps]
        is_x = (order[:, :n_steps] < n_steps).to(torch.int64)
        # cell m lies between crossing m - 1 and crossing m
        jm = j[:, None] + sx[:, None] * torch.cat(
            [torch.zeros_like(is_x[:, :1]), is_x.cumsum(1)], 1)
        im = i[:, None] + sz[:, None] * torch.cat(
            [torch.zeros_like(is_x[:, :1]), (1 - is_x).cumsum(1)], 1)
        enter = torch.cat([torch.full_like(times[:, :1], -float("inf")),
                           times[:, :-1]], 1)
        valid = ((enter < t1[sel, None]) & (jm[:, :n_steps] >= 0)
                 & (jm[:, :n_steps] < q) & (im[:, :n_steps] >= 0)
                 & (im[:, :n_steps] < q))
        base = (torch.clamp(im[:, :n_steps], 0, q - 1) * q
                + torch.clamp(jm[:, :n_steps], 0, q - 1))
        ids = torch.stack([base, base + q * q], 2).reshape(sel.shape[0], -1)
        v1, e1, e2 = (r[ids] for r in self.rows)
        ok, tk, uk, vk = tri_divide(
            tuple(c[sel, None] for c in o), tuple(c[sel, None] for c in d),
            v1.unbind(-1), e1.unbind(-1), e2.unbind(-1))
        ok = ok & valid.repeat_interleave(2, 1)
        dist = torch.where(ok, tk, float("inf"))
        # the first of the closest in the order the ray meets them, kept
        # only where it is closer than the closest of the cells before
        k = torch.argmin(dist, 1)
        rows = torch.arange(sel.shape[0], device=sel.device)
        best = dist[rows, k]
        better = ok[rows, k] & (best < t[sel])
        hit = sel[better]
        t[hit] = best[better]
        u[hit], v[hit] = uk[rows, k][better], vk[rows, k][better]
        tri[hit] = ids[rows, k][better]
        # the next cells lie past the last crossing, but a hit on a cell's
        # edge can lie past it too: the float32 vertices stand off the
        # float64 grid lines by rounding, which a ray near the line's
        # direction stretches, so a hit ends the walk only with room
        last_x = is_x[:, -1] == 1
        across = torch.where(last_x, d64[0][sel], d64[2][sel]).abs()
        room = EDGE_ROOM * (1.0 + times[:, -1].abs()) / across
        done = ((t[sel].to(torch.float64) < times[:, -1] - room)
                | (times[:, -1] >= t1[sel]) | (jm[:, -1] < 0)
                | (jm[:, -1] >= q) | (im[:, -1] < 0) | (im[:, -1] >= q))
        return im[:, -1], jm[:, -1], t, u, v, tri, done


def reference_query(params, verts, faces, extra, rows):
    """The scene query of the reference for this configuration's mesh."""
    v1, v2, v3 = (verts[faces[:, k]] for k in range(3))
    return DividingGridQuery(extra, v1, v2, v3, rows)
