"""The per-bounce route's frame as one CUDA graph (render/graph.py) and the
bounce loop it captures, which reads nothing back.

On the CPU: `integrator._run_bounces` without readbacks against the loop
with them, bit for bit (every tensor of the state, so the images and the
queries), over the plain walk and the plain bounce step and over the
kernel's body built by g++, on the tiny terrain through the forest and the
streamed LBVH and on a view of the sky alone, where every ray dies at the
first bounce and the loop with readbacks stops early; `render_rays` with
the stream seen as capturing against `render_rays` as it runs; the frame
seed as a 0-d int64 tensor against the int; which frames `render_frame`
takes through a graph; the slot's key.

On the card (marker `cuda`), a small streamed scene with its sorted
query: the graph's frames against the eager route's, bit for bit, over
three seeds, after `move_camera` and after `reset_accumulation`; one
capture and a replay a later frame; the launch counters a replay adds
against the eager route's; a frame handed to a caller is not overwritten
by the next replay. This file imports neither jax nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_route_graph.py
"""
import dataclasses

import pytest
import torch

from pathtracer0_tpu_torch import RenderConfig, Renderer, scenes
from pathtracer0_tpu_torch.core import camera
from pathtracer0_tpu_torch.core import math as tmath
from pathtracer0_tpu_torch.core import rng as trng
from pathtracer0_tpu_torch.kernels import bounce
from pathtracer0_tpu_torch.render import graph, integrator, renderer

BOUNCES, SPP = 4, 2
# looking down on the terrain (its rays hit for two bounces at most); from
# high above it, up into the sky
POSES = {"terrain": ((0.0, 4.8, -0.2), (1.4, 0.0, 0.0)),
         "sky": ((0.0, 40.0, 0.0), (-1.2, 0.0, 0.0))}
FIELDS = ("o", "d", "alive", "inc", "col", "skyc", "enter", "stack",
          "ssize", "inobj", "state", "queries", "live", "total")


def _terrain(streamed: bool, device="cpu"):
    """The tiny terrain (`scenes.terrain(9)`, 128 triangles) through the
    SAH forest or, past a stream threshold of 100, the streamed LBVH."""
    cfg = RenderConfig(width=12, height=9, samples_per_frame=SPP,
                       max_bounces=BOUNCES, blur=0.001, auto_focus=False,
                       stream_threshold=100 if streamed else 1 << 16)
    sc, info = scenes.terrain(9).build(cfg, device=device)
    assert bool(info.streamed) == streamed
    return sc, info, cfg


def _begun(sc, info, cfg, pose, camera_step):
    """A path state of every pixel that the camera form has begun."""
    uv, index = camera.pixel_centers(cfg.width, cfg.height, "cpu")
    pos, rot = (torch.tensor(v, dtype=torch.float32) for v in pose)
    rotmat = tmath.rotation_matrix(rot)
    pd = camera.primary_directions(uv, rotmat, cfg.cam_size,
                                   cfg.focal_length, cfg.screen_h_ratio)
    cam = bounce.camera_scalars(pos, rotmat, torch.tensor(4.0))
    st = integrator.sample_state(
        info, trng.seed(index, 2024), raytracing=True,
        max_bounces=cfg.max_bounces,
        stack_size=cfg.refraction_stack_depth, fused="off")
    camera_step(st, pd.T.contiguous(), cam, cfg.blur)
    return st


STEPS = {"plain": (bounce.bounce_step_plain, bounce.camera_step_plain),
         "host": (bounce.bounce_step_host, bounce.camera_step_host)}


@pytest.mark.parametrize("step", sorted(STEPS))
@pytest.mark.parametrize("view", ("forest", "streamed", "sky"))
def test_loop_without_readbacks_matches_the_loop_with_them(view, step):
    """Every bounce issued and nothing read back gives the state of the
    loop that reads the live count back after each bounce, bit for bit;
    that loop stops after the bounce that leaves no ray alive (the
    third on the terrain, the first on the sky alone), the other runs
    all of them over rays that are no longer alive."""
    sc, info, cfg = _terrain(streamed=view == "streamed")
    bounce_step, camera_step = STEPS[step]
    pose = POSES["sky" if view == "sky" else "terrain"]
    walk = integrator._forest_walk(sc, info, "auto")
    runs = {}
    for readback in (True, False):
        st = _begun(sc, info, cfg, pose, camera_step)
        integrator._run_bounces(walk, bounce_step, sc, info, st,
                                max_bounces=BOUNCES,
                                n_live=st.alive.shape[0], readback=readback)
        runs[readback] = st
    with_rb, without = runs[True], runs[False]
    for name in FIELDS:
        assert torch.equal(getattr(with_rb, name), getattr(without, name)), \
            name
    assert without.bounce == BOUNCES
    if view == "sky":
        assert with_rb.bounce == 1 and not bool(with_rb.alive.any())
        assert float(with_rb.skyc.abs().sum()) > 0.0
    else:
        assert with_rb.bounce == 3 and int(with_rb.live[1]) > 0


def test_step_without_readback_returns_nothing():
    """The path form without `readback` returns None and leaves the count
    in st.live; with it, the count; the bounce is taken either way."""
    sc, info, cfg = _terrain(streamed=False)
    walk = integrator._forest_walk(sc, info, "auto")
    for readback, want in ((True, int), (False, type(None))):
        st = _begun(sc, info, cfg, POSES["terrain"],
                    bounce.camera_step_plain)
        w, _ = walk(tuple(st.o), tuple(st.d), st.alive)
        got = bounce.bounce_step_plain(sc, info, st, w, readback=readback)
        assert isinstance(got, want) and st.bounce == 1
        assert int(st.live[0]) == int(st.alive.sum())


@pytest.mark.parametrize("view", ("forest", "streamed", "sky"))
def test_render_rays_while_capturing_matches(view, monkeypatch):
    """`render_rays` with the stream seen as capturing a graph (so its
    loop reads nothing back) gives the image and the queries it gives
    with readbacks, bit for bit."""
    sc, info, cfg = _terrain(streamed=view == "streamed")
    pos, rot = (torch.tensor(v, dtype=torch.float32)
                for v in POSES["sky" if view == "sky" else "terrain"])
    uv, index = camera.pixel_centers(cfg.width, cfg.height, "cpu")

    def frame():
        return renderer.render_rays(sc, info, uv, index, pos, rot, 77,
                                    torch.tensor(4.0), config=cfg)

    want = frame()
    monkeypatch.setattr(integrator, "capturing", lambda device: True)
    got = frame()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(want[1]) >= cfg.width * cfg.height * SPP


@pytest.mark.parametrize("frame_seed", [0, 1, 9999, 2**31 - 1, 2**31,
                                        2**32 - 1, 2**32 + 5, -3])
def test_seed_takes_a_tensor(frame_seed):
    """vrng.seed with the frame seed as a 0-d int64 tensor (the graph's
    static input holds seed & MASK) gives the bits of the int form."""
    index = torch.arange(0, 4096, 7, dtype=torch.int64) * 104729
    want = trng.seed(index, frame_seed)
    for given in (frame_seed, frame_seed & trng.MASK):
        got = trng.seed(index, torch.tensor(given, dtype=torch.int64))
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_which_frames_take_the_graph():
    """CUDA tensors, path mode and no legacy mode: the graph; the CPU,
    Whitted mode and the legacy modes: the eager route."""
    sc, info, cfg = _terrain(streamed=True)
    card, cpu = torch.device("cuda"), torch.device("cpu")
    assert renderer.takes_graph(cfg, info, card)
    assert not renderer.takes_graph(cfg, info, cpu)
    for change in ({"raytracing": False}, {"legacy_pathtrace": True}):
        assert not renderer.takes_graph(dataclasses.replace(cfg, **change),
                                        info, card)


def test_slot_keeps_one_key():
    """A slot keeps the graph of its latest key: the same scene, info,
    config and device find it again; another scene or config replaces
    it, with its static inputs on the key's device."""
    sc, info, cfg = _terrain(streamed=False)
    sc2, info2, _ = _terrain(streamed=False)
    cpu = torch.device("cpu")
    slot = graph.Slot()

    def body(*inputs):
        raise AssertionError("no frame is run here")

    first = slot.frame_for((sc, info, cfg, cpu), body)
    assert slot.frame_for((sc, info, dataclasses.replace(cfg), cpu),
                          body) is first
    assert first.seed.dtype == torch.int64 and first.seed.shape == ()
    assert first.graph is None and first.pos.device == cpu
    wider = slot.frame_for(
        (sc, info, dataclasses.replace(cfg, width=16), cpu), body)
    assert wider is not first and slot.frame is wider
    assert slot.frame_for((sc2, info2, cfg, cpu), body) is not wider


# ---- on the card ----------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (see the module docstring)")


def _card_scene():
    """A streamed scene (2,048 triangles past a stream threshold of 1,000)
    at 32 x 32 = SORT_MIN_RAYS pixels, 2 spp, 3 bounces, so every query is
    the sorted one (sort_key_kernel, the argsort, streamed_kernel)."""
    cfg = RenderConfig(width=32, height=32, samples_per_frame=2,
                       max_bounces=3, blur=0.001, auto_focus=False,
                       stream_threshold=1000)
    sc, info = scenes.terrain(33).build(cfg)
    assert info.streamed
    return sc, info, cfg


def _eager(sc, info, cfg, seed, pose):
    """The eager route's frame (readbacks and all) at `pose`."""
    pos, rot = (torch.tensor(v, dtype=torch.float32, device="cuda")
                for v in pose)
    return renderer._route_frame(
        sc, info, cfg, torch.device("cuda"), seed, pos, rot,
        torch.tensor(cfg.focal_distance, device="cuda"))


@pytest.mark.cuda
def test_graph_frames_equal_the_eager_route_on_card():
    """Renderer's accumulation through the graph equals the sums of the
    eager route's frames, bit for bit, over three seeds, then after a
    camera move (the same graph, new static inputs) and after a reset;
    one capture, a replay every later frame."""
    _card()
    sc, info, cfg = _card_scene()
    poses = (((0.0, 7.0, -1.5), (1.0, 0.0, 0.0)),
             ((1.0, 6.0, -2.5), (0.8, 0.2, 0.05)))
    r = Renderer(sc, info, cfg, cam_pos=poses[0][0], cam_rot=poses[0][1])
    before = dict(graph.counts)
    frames = 0
    for pose, action in ((poses[0], None), (poses[1], "move"),
                         (poses[1], "reset")):
        if action == "move":
            r.move_camera(*pose)
        elif action == "reset":
            r.reset_accumulation()
        rays0 = r.rays_traced
        want = torch.zeros_like(r._sum)
        queries = 0
        for seed in (11, 2**32 - 7, 40961):
            r.step(seed)
            img, q = _eager(sc, info, cfg, seed, pose)
            want = want + img
            queries += int(q)
            frames += 1
        torch.cuda.synchronize()
        assert torch.equal(r._sum, want), (pose, action)
        assert r.rays_traced - rays0 == queries
    assert graph.counts["captures"] - before["captures"] == 1
    assert graph.counts["replays"] - before["replays"] == frames - 1


@pytest.mark.cuda
def test_replay_adds_the_eager_routes_launches_on_card():
    """A replayed frame adds to bounce_step.launches,
    camera_step.launches and wavefront.launches what an eager frame of
    the route adds (every ray of this view lives to the last bounce), and
    the capture adds nothing."""
    _card()
    from pathtracer0_tpu_torch.tools import profile

    sc, info, cfg = _card_scene()
    pose = ((0.0, 7.0, -1.5), (1.0, 0.0, 0.0))
    r = Renderer(sc, info, cfg, cam_pos=pose[0], cam_rot=pose[1])

    def added(fn):
        before = profile.launch_counts()
        fn()
        torch.cuda.synchronize()
        after = profile.launch_counts()
        return {k: after[k] - before[k] for k in after
                if after[k] != before[k]}

    eager = added(lambda: _eager(sc, info, cfg, 5, pose))
    assert eager == {"bounce_kernel": 6, "bounce_kernel_camera": 2,
                     "streamed_kernel": 6, "sort_key_kernel": 6}
    replays = graph.counts["replays"]
    assert added(lambda: r.step(5)) == eager     # eager frame + capture
    assert graph.counts["replays"] == replays
    for seed in (6, 7):
        assert added(lambda seed=seed: r.step(seed)) == eager
    assert graph.counts["replays"] == replays + 2


@pytest.mark.cuda
def test_frame_handed_to_a_caller_is_its_own_on_card():
    """render_frame without a slot of the caller's hands a copy: the next
    replay leaves it as it was."""
    _card()
    sc, info, cfg = _card_scene()
    pose = ((0.0, 7.0, -1.5), (1.0, 0.0, 0.0))
    replays = graph.counts["replays"]
    frames = [renderer.render_frame(sc, info, cfg, *pose, seed)
              for seed in (3, 4)]
    kept = [x.clone() for x in frames[1]]
    third = renderer.render_frame(sc, info, cfg, *pose, 5)
    torch.cuda.synchronize()
    assert graph.counts["replays"] == replays + 2
    assert torch.equal(frames[1][0], kept[0])
    assert torch.equal(frames[1][1], kept[1])
    assert not torch.equal(third[0], frames[1][0])
    assert torch.equal(third[0], _eager(sc, info, cfg, 5, pose)[0])
