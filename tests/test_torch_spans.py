"""The port's spans (utils/trace.span) under torch.profiler on the CPU,
each step inside a `step` span of the caller's, as the benchmark wraps
Renderer.step: on the frame route `pt0.frame` once a step; on a streamed
scene's per-bounce route, of at least SORT_MIN_RAYS pixels so the query
sorts, a `pt0.query` and a `pt0.bounce` a sample and bounce; every span
inside its step; and with no profiler recording, one shared null
context.

This file imports neither jax nor the JAX package.
"""
import contextlib
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pathtracer0_tpu_torch import RenderConfig, Renderer, Scene, scenes
from pathtracer0_tpu_torch.kernels import traverse
from pathtracer0_tpu_torch.utils import trace

SPP, BOUNCES, STEPS = 2, 3, 2
NAMES = ("step", "pt0.frame", "pt0.query", "pt0.bounce")


def _spheres():
    sc = Scene()
    sc.set_constant_sky((0.5, 0.6, 0.9))
    sc.add_material("ground")
    sc.set_last_mtl("Kd", (0.5, 0.5, 0.45))
    sc.add_material("mirror")
    sc.set_last_mtl("Pr", 0.0)
    sc.set_last_mtl("Pm", 1.0)
    sc.add_sphere((0.0, -50.0, 3.0), 50.0, m=0)
    sc.add_sphere((0.0, 0.4, 3.0), 0.5, m=1)
    cfg = RenderConfig(width=16, height=12, samples_per_frame=SPP,
                       max_bounces=BOUNCES, blur=0.0,
                       auto_focus=False)
    return sc, cfg, ((0.0, 0.5, 0.0), (0.1, 0.0, 0.0))


def _terrain():
    # 2,048 triangles past a stream threshold of 1,000: the streamed LBVH;
    # 32 x 32 = SORT_MIN_RAYS pixels, looking down on it, every ray alive
    # for all three bounces (the rough material's throughput stays > 0.1)
    sc = scenes.terrain(33)
    cfg = RenderConfig(width=32, height=32, samples_per_frame=SPP,
                       max_bounces=BOUNCES, blur=0.0, auto_focus=False,
                       stream_threshold=1000)
    return sc, cfg, ((0.0, 7.0, -1.5), (1.0, 0.0, 0.0))


# spans a step by name, and the span each name opens in, on each route.
# On the CPU the frame route runs frame_kernel's plain version, a bounce
# loop over the brute-force walk (its bounces open in pt0.frame, and no
# pt0.query); on the card frame_kernel has no bounce loop of the host's
ROUTES = {
    "frame": (_spheres,
              {"step": 1, "pt0.frame": 1, "pt0.bounce": SPP * BOUNCES},
              {"pt0.frame": "step", "pt0.bounce": "pt0.frame"}),
    "bounce": (_terrain,
               {"step": 1, "pt0.query": SPP * BOUNCES,
                "pt0.bounce": SPP * BOUNCES},
               {"pt0.query": "step", "pt0.bounce": "step"}),
}


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_spans_nest_once_a_layer(route, tmp_path):
    build, per_step, parent = ROUTES[route]
    sc, cfg, (pos, rot) = build()
    scene, info = sc.build(cfg, device="cpu")
    assert bool(info.streamed) == (route == "bounce")
    if info.streamed:
        assert cfg.width * cfg.height >= traverse.SORT_MIN_RAYS
    r = Renderer(scene, info, cfg, cam_pos=pos, cam_rot=rot, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(STEPS):
            with torch.profiler.record_function("step"):
                r.step(1 + k)
    # read as the benchmark reads it: Chrome's trace, user annotations
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e["name"] in NAMES]
    by = {n: [s for s in spans if s[0] == n] for n in NAMES}
    assert {n: len(v) for n, v in by.items()} == {
        n: STEPS * per_step.get(n, 0) for n in NAMES}
    for s in spans:
        assert any(_inside(s, st) for st in by["step"])
    for child, up in parent.items():
        for s in by[child]:
            assert sum(_inside(s, p) for p in by[up]) == 1


def test_span_is_a_shared_null_context_with_the_profiler_off():
    assert not torch.autograd._profiler_enabled()
    a, b = trace.span("pt0.frame"), trace.span("pt0.query")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]):
        on = trace.span("pt0.frame")
    assert isinstance(on, torch.profiler.record_function)
