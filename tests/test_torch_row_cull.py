"""The streamed walk's row cull inside a group (csrc/row_cull.cuh, the plain
twin kernels/wavefront.py `group_rows`) on the CPU: the row boxes of
scene/packing.py `row_boxes`, the host build of the row choice (g++,
csrc/group_test_host.cpp `pt_group_rows`) against the twin, the tie rule,
and the twin's walk against the walk that tests every slot of a group and
against a brute-force closest hit.

The cull changes which slots are tested, not the hit: where a row box holds
its slots' hits, the outputs are those of the group's 56 slots in order, bit
for bit, and so are the counters (2 box tests an internal node, 4 rows a
group entered).
"""
import ctypes

import numpy as np
import pytest
import torch

from pathtracer0_tpu_torch import RenderConfig, scenes
from pathtracer0_tpu_torch.accel import lbvh
from pathtracer0_tpu_torch.kernels import build, wavefront
from pathtracer0_tpu_torch.kernels.intersect import (MISS, safe_inv_dir,
                                                     tri_candidate)
from pathtracer0_tpu_torch.scene.packing import row_boxes

torch.set_num_threads(1)
PER, ROWS = lbvh.TRIS_PER_ROW, lbvh.SUB_GROUP_ROWS


@pytest.fixture(scope="module")
def terrain():
    """A streamed terrain of 2 * 39^2 = 3,042 triangles (two treelets, the
    second part empty) and its camera."""
    n = 40
    sc, info = scenes.terrain(n).build(
        device="cpu", config=RenderConfig(stream_threshold=0))
    assert info.streamed and info.st_n_treelets == 2
    return sc, info, scenes.terrain_camera(n)


def _rays(sc, cam, n_rays, seed):
    """Half from the camera, half from above the root box, mostly
    downwards, some with a zero direction component; one in seven off."""
    g = torch.Generator().manual_seed(seed)
    top = sc.st_top[0]
    lo, hi = top[0:3], top[3:6]
    o = lo + (hi - lo) * torch.rand(n_rays, 3, generator=g) \
        + torch.tensor([0.0, 2.0, 0.0])
    o[: n_rays // 2] = torch.tensor(cam[0], dtype=torch.float32)
    d = torch.randn(n_rays, 3, generator=g) + torch.tensor([0.0, -1.2, 0.0])
    d[::13, 0] = 0.0
    d = d / d.norm(dim=1, keepdim=True)
    t_init = torch.where(torch.arange(n_rays) % 7 == 0, 0.0, MISS)
    return tuple(o.T.contiguous()), tuple(d.T.contiguous()), t_init


def test_row_boxes_hold_their_slots(terrain):
    """Every vertex of a slot that holds a triangle, as the slot test sees
    it, lies inside its row's box, within one ulp of its faces; rows with
    no triangle are inverted (+inf, -inf); the pads are zero."""
    sc, info, _ = terrain
    rows = sc.st_rows.numpy()
    tris = sc.st_tris.numpy().reshape(-1, PER, 9)
    perm = sc.st_perm.numpy().reshape(-1, PER)
    assert rows.shape == (lbvh.TREELET_ROWS * info.st_n_treelets, 8)
    assert np.array_equal(rows, row_boxes(sc.st_tris.numpy(),
                                          sc.st_perm.numpy()))
    live = perm >= 0
    full = live.any(1)
    assert full.any() and (~full).any()
    v1 = tris[..., 0:3]
    verts = (v1, v1 + tris[..., 3:6], v1 + tris[..., 6:9])
    for v in verts:
        inside = ((v >= rows[:, None, 0:3]) & (v <= rows[:, None, 3:6]))
        assert inside.all(-1)[live].all()
    # the tightest box, widened by one ulp
    lo = np.min([np.where(live[..., None], v, np.inf).min(1) for v in verts],
                0)
    hi = np.max([np.where(live[..., None], v, -np.inf).max(1)
                 for v in verts], 0)
    assert np.array_equal(lo[full], np.nextafter(rows[full, 0:3],
                                                 np.float32(np.inf)))
    assert np.array_equal(hi[full], np.nextafter(rows[full, 3:6],
                                                 np.float32(-np.inf)))
    assert np.isinf(rows[~full, 0:3]).all() and (rows[~full, 0:3] > 0).all()
    assert np.isinf(rows[~full, 3:6]).all() and (rows[~full, 3:6] < 0).all()
    assert (rows[:, 6:8] == 0.0).all()


def test_scene_without_a_tree_has_a_placeholder_row():
    sc, info = scenes.BUILDERS[6]().build(device="cpu")
    assert not info.streamed and tuple(sc.st_rows.shape) == (1, 8)


def _group_inputs(sc, o, d, groups, t0, idx0):
    """For each ray a group (`groups`), its slots, the entry distances of
    its row boxes, and a starting closest hit (t0 over td = 1, idx0)."""
    n = groups.shape[0]
    slot0 = (groups * ROWS * PER).to(torch.int32)
    tri = sc.st_tris[slot0[:, None].long() + torch.arange(ROWS * PER)]
    rd = wavefront.box_entry(
        tuple(c[:, None] for c in o),
        tuple(safe_inv_dir(c)[:, None] for c in d),
        sc.st_rows[groups[:, None] * ROWS + torch.arange(ROWS)]).contiguous()
    best = [t0.clone(), torch.ones(n), torch.zeros(n), torch.zeros(n),
            idx0.clone(), t0.clone()]
    return tri, rd, slot0, best


def _host_rows(lib, o, d, tri, rd, slot0, best):
    t, td, u, v, idx, tcur = (np.ascontiguousarray(x.numpy()).copy()
                              for x in best)
    rays = np.ascontiguousarray(torch.stack([*o, *d]).numpy())
    tri = np.ascontiguousarray(tri.numpy())
    rd = np.ascontiguousarray(rd.numpy())
    s0 = np.ascontiguousarray(slot0.numpy())
    order = np.zeros((rd.shape[0], ROWS), np.int64)
    fn = lib.pt_group_rows
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] + \
        [ctypes.c_void_p] * 7
    fn.restype = None
    ptr = (lambda a: a.ctypes.data_as(ctypes.c_void_p))
    fn(ptr(rays), ptr(tri), ptr(rd), ptr(s0), rd.shape[0], ptr(t), ptr(td),
       ptr(u), ptr(v), ptr(idx), ptr(tcur), ptr(order))
    return [t, td, u, v, idx, tcur], order


@pytest.mark.parametrize("start", ["miss", "short", "hit_in_group"])
def test_host_row_choice_equals_the_twin(terrain, start):
    """csrc/row_cull.cuh built by g++ against `group_rows`, one group a ray
    (the group the ray's walk hits, or a random one): the rows tested, in
    order, and t, td, u, v, idx and the pruning distance, bit for bit,
    from no hit, from a short t_init, and from a hit already taken in the
    same group (so a later row may take an exact tie)."""
    sc, info, cam = terrain
    o, d, t_init = _rays(sc, cam, 4096, seed=11)
    on = t_init > 0.0
    o, d = tuple(c[on] for c in o), tuple(c[on] for c in d)
    n = o[0].shape[0]
    hit = wavefront.streamed_reference(o, d, torch.full((n,), MISS), sc,
                                       info)
    g = torch.Generator().manual_seed(3)
    n_groups = info.st_n_treelets * lbvh.TREELET_ROWS // ROWS
    groups = torch.where(hit[3] >= 0, hit[3].long() // (ROWS * PER),
                         torch.randint(0, n_groups, (n,), generator=g))
    t0 = torch.full((n,), MISS)
    if start == "short":
        t0 = torch.where(hit[3] >= 0, hit[0] * 1.0001, 0.5)
    tri, rd, slot0, best = _group_inputs(
        sc, o, d, groups, t0, torch.full((n,), -1, dtype=torch.int32))
    if start == "hit_in_group":
        # the group's own closest hit, its numerators as the row test left
        # them, as if the group's last slot had taken it
        first = wavefront.group_rows(o, d, tri, rd, slot0, best)[0]
        took = first[4] >= 0
        assert float(took.float().mean()) > 0.2
        best = [x.clone() for x in first]
        best[4] = torch.where(took, slot0 + ROWS * PER - 1, -1)
    got, order = wavefront.group_rows(o, d, tri, rd, slot0,
                                      [x.clone() for x in best])
    host, host_order = _host_rows(build.load("group_test"), o, d, tri, rd,
                                  slot0, best)
    assert np.array_equal(order.numpy(), host_order)
    for a, b in zip(got, host):
        assert np.array_equal(a.numpy(), b)
    tested = (order >= 0).sum(1)
    assert int(tested.max()) <= ROWS and float(tested.float().mean()) < ROWS
    if start == "hit_in_group":
        # the hit row is tested again and its slot takes the exact tie
        assert torch.equal(got[4], first[4])


def _tie_group():
    """One group of 56 slots: the same triangle at slot 3 (row 0) and slot
    30 (row 2), facing a ray along +z from the origin at z = 5; row 2 also
    holds a triangle beside the ray at z = 2, so its box is entered first."""
    tri = torch.zeros(ROWS * PER, 9)
    face = torch.tensor([-1.0, -1.0, 5.0, 3.0, 0.0, 0.0, 0.0, 3.0, 0.0])
    tri[3] = face
    tri[30] = face
    tri[31] = torch.tensor([3.0, 0.0, 2.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0])
    perm = torch.full((ROWS * PER,), -1, dtype=torch.int32)
    perm[[3, 30, 31]] = torch.tensor([0, 1, 2], dtype=torch.int32)
    return tri, perm


@pytest.mark.parametrize("host", [False, True])
def test_tie_goes_to_the_lower_slot(host):
    """Two rows hit at one distance: the nearer row box (row 2) is tested
    first and takes the hit, then row 0's slot, the lower, takes the exact
    tie, as the group's slots in order give it."""
    tri, perm = _tie_group()
    rows = torch.from_numpy(row_boxes(tri.numpy(), perm.numpy()))
    o = tuple(torch.zeros(1) for _ in range(3))
    d = (torch.zeros(1), torch.zeros(1), torch.ones(1))
    rd = wavefront.box_entry(tuple(c[:, None] for c in o),
                             tuple(safe_inv_dir(c)[:, None] for c in d),
                             rows[None])
    assert float(rd[0, 2]) < float(rd[0, 0]) < 5.0 and float(rd[0, 1]) > 1e29
    best = [torch.full((1,), MISS), torch.ones(1), torch.zeros(1),
            torch.zeros(1), torch.full((1,), -1, dtype=torch.int32),
            torch.full((1,), MISS)]
    slot0 = torch.zeros(1, dtype=torch.int32)
    if host:
        out, order = _host_rows(build.load("group_test"), o, d, tri[None],
                                rd.contiguous(), slot0, best)
        out = [torch.from_numpy(x) for x in out]
        order = torch.from_numpy(order)
    else:
        out, order = wavefront.group_rows(o, d, tri[None], rd, slot0, best)
    assert order[0].tolist() == [2, 0, -1, -1]
    assert int(out[4][0]) == 3
    assert float(out[0][0] / out[1][0]) == 5.0
    # the 56 slots in order agree
    full = wavefront.group_accept(
        o, d, tri[None], torch.arange(ROWS * PER, dtype=torch.int32)[None],
        [torch.full((1,), MISS), torch.ones(1), torch.zeros(1),
         torch.zeros(1), torch.full((1,), -1, dtype=torch.int32),
         torch.full((1,), MISS)])
    for a, b in zip(out, full):
        assert torch.equal(a, b)


def _every_slot(o, d, tri, rd, slot0, best):
    """`group_rows` as the walk tested a group before the cull: its 56
    slots in order, every row counted."""
    slots = slot0[:, None] + torch.arange(ROWS * PER, dtype=torch.int32)
    order = torch.arange(ROWS).expand(rd.shape[0], ROWS)
    return wavefront.group_accept(o, d, tri, slots, best), order


@pytest.mark.parametrize("seed", [21, 22])
def test_twin_walk_equals_every_slot_and_brute_force(terrain, monkeypatch,
                                                     seed):
    """The twin's walk with the cull against the same walk testing every
    slot of a group: t, u, v, idx, box tests and row visits bit for bit.
    Against a brute-force closest hit over every slot of the table (the
    slots in order, cross-multiplied): the same slot on >= 99.9% of the
    rays, t, u, v bit for bit there. Fewer rows tested than 4 a group."""
    sc, info, cam = terrain
    o, d, t_init = _rays(sc, cam, 2048, seed)
    tested = torch.zeros(2048, dtype=torch.int32)
    cull = wavefront.streamed_reference(o, d, t_init, sc, info,
                                        rows_tested=tested)
    with monkeypatch.context() as m:
        m.setattr(wavefront, "group_rows", _every_slot)
        every = wavefront.streamed_reference(o, d, t_init, sc, info)
    for a, b in zip(cull, every):
        assert torch.equal(a, b)
    groups = int(cull[5].sum()) // ROWS
    assert 0 < int(tested.sum()) < 2 * groups
    assert bool((tested <= cull[5]).all())
    # brute force over the whole table, 256 rays at a time
    out = [[] for _ in range(5)]
    for at in torch.arange(2048).split(256):
        ok, tc, adet, uc, vc = tri_candidate(
            tuple(c[at, None] for c in o), tuple(c[at, None] for c in d),
            *(tuple(sc.st_tris[None, :, i] for i in range(k, k + 3))
              for k in (0, 3, 6)))
        t, td = t_init[at].clone(), torch.ones(at.shape[0])
        u, v = torch.zeros_like(td), torch.zeros_like(td)
        idx = torch.full(td.shape, -1, dtype=torch.int32)
        for j in range(sc.st_tris.shape[0]):
            okj = ok[:, j] & (tc[:, j] * td < t * adet[:, j])
            t = torch.where(okj, tc[:, j], t)
            td = torch.where(okj, adet[:, j], td)
            u = torch.where(okj, uc[:, j], u)
            v = torch.where(okj, vc[:, j], v)
            idx = torch.where(okj, j, idx)
        for x, y in zip(out, (t, td, u, v, idx)):
            x.append(y)
    t, td, u, v, idx = (torch.cat(x) for x in out)
    same = idx == cull[3]
    assert float(same.float().mean()) >= 0.999
    assert 0.2 < float((idx >= 0).float().mean()) < 0.95
    inv = 1.0 / td
    for a, b in zip((t * inv, u * inv, v * inv), cull[:3]):
        assert torch.equal(a[same], b[same])
