"""Profiling harness: a per-stage time budget for one bench config.

Counterpart of the JAX package's tools/profile.py. It times the full frame
of a bench config (its own copy of bench.py's BENCH_PARAMS, spp capped at
8, blur 0.001, no autofocus) through `render_frame`, then again with one
stage family taken away or swapped: one bounce, one sample, the
per-bounce route (fused="off") and the frame kernel (fused="on"); the
differences attribute wall time to stages. Each row is a mean over
`--frames` frames, each with a fresh seed, after a warm-up frame that is
not timed, ended by a synchronize; beside it, the kernel launches a frame
(`frame_kernel`, `block_kernel`, the forest and streamed kernels of
kernels/wavefront.py, and `bounce_kernel`, one a bounce of the per-bounce
route). A scene without triangles launches no forest kernel: its
fused="off" row is the per-bounce shading alone.

`--trace DIR` also writes one frame's torch.profiler trace
(DIR/profile_config<n>.json, Chrome's format) and prints the card's busy
share and the kernels that took most of its time (`trace_busy`).

Run it as a module, never as a file:

  python -m pathtracer0_tpu_torch.tools.profile --config 3 [--frames 5]
         [--spp S] [--trace DIR] [--device cpu]

(`python pathtracer0_tpu_torch/tools/profile.py` would put this directory
first on sys.path, where this file shadows the standard library's
`profile`, which cProfile and torch.profiler import.) It runs on the card
and raises without one; `--device cpu` runs the plain versions (keep them
tiny) and measures no time.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import time

import torch

from .. import scenes
from ..config import RenderConfig
from ..core.device import resolve_device, synchronize
from ..kernels import bounce, frame, fused, wavefront
from ..render.renderer import render_frame

# (width, height, spp, bounces, raytracing), bench.py's table
BENCH_PARAMS = {
    1: (800, 600, 1, 6, False),
    2: (800, 600, 64, 6, True),
    3: (800, 600, 128, 6, True),
    4: (800, 600, 256, 6, True),
    6: (800, 600, 64, 6, True),
}
DEFAULT_PARAMS = (800, 600, 8, 6, True)
# (name, RenderConfig overrides) of each row, the JAX tool's
ROWS = (("full frame", {}),
        ("1 bounce (traversal+shade x1)", {"max_bounces": 1}),
        ("1 spp", {"samples_per_frame": 1}),
        ("fused=off (per-bounce path)", {"fused": "off"}),
        ("fused=on", {"fused": "on"}))


def frame_config(config, spp=None, overrides=None, params=None):
    """The RenderConfig of a row: bench config `config`'s size, spp (`spp`,
    else its own capped at 8), bounces and mode, blur 0.001, no autofocus,
    then `overrides`. `params` replaces BENCH_PARAMS' entry (tests give a
    tiny size through it)."""
    w, h, bench_spp, bounces, raytracing = params or BENCH_PARAMS.get(
        config, DEFAULT_PARAMS)
    base = dict(width=w, height=h, samples_per_frame=spp or min(bench_spp, 8),
                max_bounces=bounces, raytracing=raytracing, auto_focus=False,
                blur=0.001)
    base.update(overrides or {})
    return RenderConfig(**base)


def launch_counts():
    """The package's kernel launch counts so far, by kernel."""
    return {"frame_kernel": frame.trace_frame.launches,
            "frame_kernel_refill": frame.trace_frame.refill_launches,
            "block_kernel": fused.trace_block.launches,
            "bounce_kernel": bounce.bounce_step.launches,
            "bounce_kernel_camera": bounce.camera_step.launches,
            **wavefront.launches}


def time_call(fn, dev, frames=5):
    """Mean seconds of fn(frame_seed) over `frames` calls, each with a
    fresh seed, after one warm-up call that is not timed, the last call
    ended by a synchronize (None off the card), and the launches a timed
    call made, by kernel."""
    rng = random.Random(time.time_ns())
    fn(rng.randrange(1, 2 ** 31))
    synchronize(dev)
    before = launch_counts()
    t0 = time.perf_counter()
    for _ in range(frames):
        fn(rng.randrange(1, 2 ** 31))
    synchronize(dev)
    dt = (time.perf_counter() - t0) / frames
    after = launch_counts()
    launches = {k: (after[k] - before[k]) / frames for k in after
                if after[k] != before[k]}
    return (dt if dev.type == "cuda" else None), launches


TRACE_TRIES = 5
# tiny kernels (`torch.cuda._sleep`'s spin_kernel) launched inside the
# profiler's window ahead of the call, and left out of every count: the
# profiler drops the device records of a trace's first operations, more
# the longer the process has run (13 of 256 by the end of chip_smoke.py
# on an H100; another run kept 2 of a short trace's ~90), and then drops
# these
TRACE_LEAD = 1024
LEAD_KERNEL = "spin_kernel"


def trace_busy(step, device="cuda", trace_path=None):
    """One call of `step` (a frame) under torch.profiler, after a warm-up
    call and an untraced one: how busy the card is (its device time over
    the same traced call's wall time; the untraced call's wall time beside
    it) and which kernels take its time
    (`ours`: the package's own kernels, whose names end in their `...Args`
    struct, csrc/*.cu). Writes the trace to `trace_path` (Chrome's format)
    where given. Off the card only the host is traced and no device time
    or share is given. Raises when the profiler loses part of the call's
    device activity TRACE_TRIES times in a row."""
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_card else [])
    step()
    synchronize(dev)
    t = time.perf_counter()
    step()
    synchronize(dev)
    untraced_ms = 1e3 * (time.perf_counter() - t)
    # The profiler can drop the device records of a trace's first
    # operations or lose all of them. So TRACE_LEAD tiny kernels run first
    # inside the window, and a trace is whole when it kept one of them at
    # least and as many of the package's kernels as their launch counts
    # say the call launched (the host's records of kernel launches are no
    # measure: up to 5% of them had no kernel in any trace of a frame). One
    # that is not is taken again, at most TRACE_TRIES times.
    for tries in range(1, TRACE_TRIES + 1):
        before = sum(launch_counts().values())
        with profile(activities=activities) as prof:
            if on_card:
                with torch.cuda.device(dev):
                    for _ in range(TRACE_LEAD):
                        torch.cuda._sleep(1)
                synchronize(dev)
            t = time.perf_counter()
            step()
            synchronize(dev)
            wall_ms = 1e3 * (time.perf_counter() - t)
        launched = sum(launch_counts().values()) - before
        # a record_function span (utils/trace.span) also leaves a range
        # on the device's timeline, keyed as a CUDA event with the range's
        # length as its device time: no operation, so left out
        ran = [e for e in prof.key_averages()
               if getattr(e, "device_time_total", 0) > 0
               and str(getattr(e, "device_type", "")).endswith("CUDA")
               and not getattr(e, "is_user_annotation", False)]
        lead = sum(e.count for e in ran if LEAD_KERNEL in e.key)
        kernels = [e for e in ran if LEAD_KERNEL not in e.key]
        n_ops = int(sum(e.count for e in kernels))
        traced = sum(e.count for e in kernels if e.key.endswith("Args)"))
        if not on_card or (lead and kernels and traced >= launched):
            break
    else:
        raise RuntimeError(
            f"torch.profiler lost device activity in {TRACE_TRIES} traces "
            f"in a row: the last held {n_ops} device operations and "
            f"{traced} of the package's kernels of {launched} counted")
    if trace_path:
        prof.export_chrome_trace(trace_path)
    if not on_card:
        return {"wall_ms_untraced": None, "wall_ms_traced": None,
                "device_busy_ms": None, "busy_share": None, "ours": [],
                "device_kernels": None, "top": [], "trace": trace_path,
                "trace_tries": tries, "lead_kept": None}
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:12]
    ours = [e for e in kernels if e.key.endswith("Args)")]
    return {"wall_ms_untraced": untraced_ms, "wall_ms_traced": wall_ms,
            "device_busy_ms": busy_ms, "busy_share": busy_ms / wall_ms,
            "ours": [{"name": e.key[:80], "count": int(e.count),
                      "ms": e.device_time_total / 1e3,
                      "share_of_busy": e.device_time_total / 1e3 / busy_ms}
                     for e in ours],
            "device_kernels": n_ops, "trace_tries": tries,
            "lead_kept": lead,
            "top": [{"name": e.key[:80], "count": int(e.count),
                     "ms": e.device_time_total / 1e3} for e in top],
            "trace": trace_path}


def main(argv=None, *, params=None, out=print):
    """Parse `argv` (sys.argv[1:] when None), time every row and, with
    --trace, trace one full frame. Returns {"config", "rows", "trace"}:
    each row its name, ms a frame (None off the card), nominal Mrays/s
    (pixels x spp x bounces of the full frame over the row's time), the
    launches a frame by kernel and its RenderConfig's overrides.
    `params` replaces the config's BENCH_PARAMS entry (a test hook)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", type=int, default=3)
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--trace", type=str, default=None,
                    help="directory for a torch.profiler trace of one frame")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    sc, info = scenes.BUILDERS[args.config]().build(max_leaf=4, device=dev)
    cam, rot = scenes.CAMERAS[args.config]
    full = frame_config(args.config, args.spp, params=params)

    def framer(overrides):
        cfg = frame_config(args.config, args.spp, overrides, params)

        def fn(seed):
            return render_frame(sc, info, cfg, cam, rot, seed, device=dev)
        return fn

    n_rays = full.width * full.height * full.samples_per_frame
    out(json.dumps({"config": args.config, "width": full.width,
                    "height": full.height, "spp": full.samples_per_frame,
                    "bounces": full.max_bounces,
                    "mode": "path" if full.raytracing else "whitted",
                    "device": str(dev)}))
    rows = []
    for name, overrides in ROWS:
        t, launches = time_call(framer(overrides), dev, frames=args.frames)
        row = {"row": name, "overrides": overrides,
               "ms": None if t is None else 1e3 * t,
               "mrays_per_s_nominal": (None if t is None else
                                       n_rays * full.max_bounces / t / 1e6),
               "launches_per_frame": launches}
        out(json.dumps(row))
        rows.append(row)

    busy = None
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        fn = framer({})
        seeds = random.Random(time.time_ns())
        busy = trace_busy(lambda: fn(seeds.randrange(1, 2 ** 31)), dev,
                          os.path.join(args.trace,
                                       f"profile_config{args.config}.json"))
        out(json.dumps({"trace": busy["trace"],
                        "busy_share": busy["busy_share"],
                        "device_kernels": busy["device_kernels"],
                        "top": busy["top"]}))
    return {"config": args.config, "rows": rows, "trace": busy}


if __name__ == "__main__":
    main()
