"""The per-bounce route's frame as one CUDA graph (render/graph.py) and the
bounce loop it captures, which reads nothing back on any device.

On the CPU: `integrator._run_bounces` to the bounce that leaves no ray
alive against the loop run to its last bounce, bit for bit (every tensor
of the state, so the images and the queries), over the plain walk and the
plain bounce step and over the kernel's body built by g++, on the tiny
terrain through the forest and the streamed LBVH and on a view of the sky
alone, where every ray dies at the first bounce; the plain route
`trace_bounces_reference` against `trace_bounces`; `render_frame` with
pallas "off" against "auto"; the frame seed as a 0-d int64 tensor against
the int; which frames `render_frame` takes through a graph; the slot's
key.

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
          "ssize", "inobj", "state", "queries", "total")


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
        stack_size=cfg.refraction_stack_depth, fused="off")
    camera_step(st, pd.T.contiguous(), cam, cfg.blur)
    return st


STEPS = {"plain": (bounce.bounce_step_plain, bounce.camera_step_plain),
         "host": (bounce.bounce_step_host, bounce.camera_step_host)}


@pytest.mark.parametrize("step", sorted(STEPS))
@pytest.mark.parametrize("view", ("forest", "streamed", "sky"))
def test_loop_without_readbacks_matches_the_loop_with_them(view, step):
    """The loop runs every bounce and reads nothing back: the bounces
    past the one that leaves no ray alive (the third on the terrain, the
    first on the sky alone), where a loop that read the live count back
    would stop, change nothing, bit for bit."""
    sc, info, cfg = _terrain(streamed=view == "streamed")
    bounce_step, camera_step = STEPS[step]
    pose = POSES["sky" if view == "sky" else "terrain"]
    walk = integrator._forest_walk(sc, info)
    last = 1 if view == "sky" else 3
    runs = {}
    for n in (last - 1, last, BOUNCES):
        st = _begun(sc, info, cfg, pose, camera_step)
        integrator._run_bounces(walk, bounce_step, sc, info, st,
                                max_bounces=n)
        runs[n] = st
    stopped, full = runs[last], runs[BOUNCES]
    assert bool(runs[last - 1].alive.any()) and not bool(stopped.alive.any())
    for name in FIELDS:
        assert torch.equal(getattr(stopped, name), getattr(full, name)), \
            name
    assert stopped.bounce == last and full.bounce == BOUNCES
    if view == "sky":
        assert float(stopped.skyc.abs().sum()) > 0.0


@pytest.mark.parametrize("view", ("forest", "streamed", "sky"))
def test_reference_route_matches_the_route_on_cpu(view, monkeypatch):
    """`trace_bounces_reference` (the plain walks and the plain bounce
    step, the card's yardstick) gives `trace_bounces`' path state on CPU
    tensors, bit for bit over every field."""
    sc, info, cfg = _terrain(streamed=view == "streamed")
    pose = POSES["sky" if view == "sky" else "terrain"]
    st = _begun(sc, info, cfg, pose, bounce.camera_step_plain)
    begun = []
    begin = bounce.begin

    def keep(*args, **kwargs):
        begun.append(begin(*args, **kwargs))
        return begun[-1]

    monkeypatch.setattr(bounce, "begin", keep)
    for trace in (integrator.trace_bounces,
                  integrator.trace_bounces_reference):
        out = trace(sc, info, tuple(st.o), tuple(st.d), st.alive, st.state,
                    max_bounces=BOUNCES)
        assert out[2] is begun[-1].state and out[3] is begun[-1].queries
    want, got = begun
    for name in FIELDS[:-1]:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert got.bounce == want.bounce == BOUNCES
    assert int(want.queries.sum()) >= cfg.width * cfg.height


def test_pallas_renders_alike_on_cpu():
    """`render_frame` on CPU tensors with pallas "off" and "auto": the
    same image and queries, bit for bit (the tensors' device alone picks
    the plain versions), on the streamed terrain."""
    sc, info, cfg = _terrain(streamed=True)
    pos, rot = POSES["terrain"]
    out = [renderer.render_frame(sc, info, dataclasses.replace(cfg, pallas=p),
                                 pos, rot, 77, device="cpu")
           for p in ("auto", "off")]
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    assert int(out[0][1]) >= cfg.width * cfg.height * SPP


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
    """The eager route's frame at `pose`."""
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
