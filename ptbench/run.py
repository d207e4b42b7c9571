"""Run one cell of the benchmark and print its result line.

    python -m ptbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Set-up (imports, the CUDA context, the
kernels loaded from pathtracer0_tpu_torch/_build/, the scene build, one
warm-up of the cell's own shapes) is timed from the start of this module;
then the window runs the cell's traffic for `--seconds` (`--trace 0`) or
profiles a fixed stretch of it (`--trace 1`); then the plain reference
checks what the window showed (check.py). The last line of standard output
is one JSON object: correct, attempted, failed, metrics, device and, with
--trace 1, breakdown, then the numbers compared beside their limits
(`checks`), which also end standard error.

The run needs a card: without one it exits 2 and prints no result. It
also exits 3, with no result, if `jax`, `jaxlib`, `flax` or the JAX package
`pathtracer0_tpu` is in sys.modules once the window has closed (top-level
names compared whole: `pathtracer0_tpu_torch` is the port).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "pathtracer0_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


class Bench:
    """A cell's program and reference scenes on one device."""

    def __init__(self, workload, *, device="cuda", overrides=None):
        import torch

        from . import bench

        self.cell = bench.cell(workload, overrides)
        bench.check_config(self.cell.config)
        dev = torch.device(device)
        self.on_card = dev.type == "cuda"
        if self.on_card:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.scene, self.info, self.rc = bench.build_program_scene(
            self.cell.config, self.cell.config_module, dev)
        _check_route(self.cell.config, self.info, self.rc)
        self.render = bench.render_fields(self.cell.config)

    def session(self, seed):
        from .drive import Session

        sess = Session(self.cell, self.scene, self.info, self.rc, seed,
                       self.device)
        sess.warm()
        return sess

    def free(self):
        """Drop the program's scene (the reference runs after it)."""
        import torch

        self.scene = None
        if self.on_card:
            torch.cuda.empty_cache()

    def reference(self, images, dtype=None):
        """The reference's values of the images (float32 by default)."""
        import torch

        from . import bench, check

        ref_scene = bench.build_reference_scene(
            self.cell.config, self.cell.config_module, self.device)
        dtype = dtype or torch.float32
        if dtype != torch.float32:
            ref_scene = ref_scene.to(dtype)
        return check.reference_images(ref_scene, self.render, images,
                                      dtype=dtype,
                                      sum_order=self.cell.config["route"])


def run_cell(workload, seed, seconds, trace, *, device="cuda",
             overrides=None, log=_log):
    """One run of `workload`: returns the result object. `device` "cpu"
    runs the port's plain versions (the tests shrink the cell through
    `overrides`); no time or device number of such a run means anything."""
    import numpy as np
    import torch

    from . import bench, check
    from . import trace as tr

    t_import = time.perf_counter()
    b = Bench(workload, device=device, overrides=overrides)
    c, dev = b.cell, b.device
    t_scene = time.perf_counter()
    sess = b.session(seed)
    # what set-up made lives on: the window's collections skip it
    gc.collect()
    gc.freeze()
    t_setup = time.perf_counter()
    setup_s = t_setup - T_START
    reduced = None
    if trace:
        def stretch():
            q0 = _queries(sess)
            rec = sess.run(count=c.mix["trace_count"])
            rec.queries = _queries(sess) - q0
            return rec
        if b.on_card:
            rec, reduced = tr.profile_stretch(stretch, dev, bench.tmp_dir())
        else:
            rec = stretch()
    else:
        rec = sess.run(seconds=seconds)
    if b.on_card:
        torch.cuda.synchronize(dev)
    t_window = time.perf_counter()
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(dev) if b.on_card else 0
    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {', '.join(found)}")
        raise SystemExit(3)
    record = {"setup_s": setup_s, "record": rec, "trace": reduced,
              "config": c.config, "render": b.render, "mix": c.mix,
              "info": {"n_tris": b.info.num_tris,
                       "n_ell": b.info.num_ellipsoids,
                       "n_imp": b.info.num_implicits,
                       "n_rot": (sum(b.info.ell_rotated)
                                 + sum(b.info.imp_rotated)),
                       "n_mats": len(c.config["materials"]),
                       "streamed": bool(b.info.streamed)}}
    sess.close()
    del sess
    b.free()

    ref = b.reference(rec.images)
    values, per_image = check.numbers(rec.images,
                                      [im.values for im in rec.images], ref)
    correct, failed, checks = check.judge(values, c.limits, per_image)
    t_check = time.perf_counter()

    metrics = {}
    for m in (c.per_layer if trace else c.end_to_end):
        v = bench.metric_reader(m["name"])(record)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": bool(correct),
           "attempted": rec.frames,
           "failed": int(failed), "metrics": metrics,
           "device": {"platform": "gpu" if b.on_card else dev.type,
                      "kind": (torch.cuda.get_device_name(dev) if b.on_card
                               else "cpu"),
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if trace and reduced is not None:
        lo, hi = reduced["window"]
        out["device"]["busy_s"] = tr.busy_s(reduced["device"], lo, hi)
        out["device"]["window_s"] = hi - lo
        out["breakdown"] = tr.breakdown(reduced)
    out["checks"] = checks
    if rec.frame_s:
        q = np.percentile(np.asarray(rec.frame_s) * 1e3,
                          [50, 90, 95, 99, 100])
        log("frame ms p50/p90/p95/p99/max: "
            + " / ".join(f"{v:.4f}" for v in q) + f" of {rec.frames}")
    if not trace:
        _log_fifths(log, rec)
    log(f"set-up: to the run {t_import - T_START:.3f} s, the scene "
        f"{t_scene - t_import:.3f} s, the warm-up {t_setup - t_scene:.3f} s")
    log(f"phases: set-up {setup_s:.3f} s, window "
        f"{t_window - t_setup:.3f} s, check {t_check - t_window:.3f} s; "
        f"{len(rec.images)} images, {rec.frames} frames")
    for name, cv in checks.items():
        log(f"{name} {cv['value']!r} limit {cv['limit']!r}")
    return out


def _queries(sess):
    """Scene queries so far of the session's renderer."""
    return sess.renderer.rays_traced


def _log_fifths(log, rec):
    """The frame rate of each fifth of the window: how far the host's
    speed moves within a run."""
    import numpy as np

    ends = np.asarray(rec.frame_end)
    fifth = (rec.end - rec.start) / 5.0
    rates = []
    for k in range(5):
        n = int(((ends > rec.start + k * fifth)
                 & (ends <= rec.start + (k + 1) * fifth)).sum())
        rates.append(n / fifth)
    log("frames/s by fifth of the window: "
        + " / ".join(f"{v:.1f}" for v in rates))


def _check_route(config, info, rc):
    """The configuration names the route it exercises; a scene that takes
    the other one is refused."""
    from pathtracer0_tpu_torch.kernels import frame

    takes_frame = rc.fused != "off" and frame.eligible(
        info, stack_size=rc.refraction_stack_depth)
    if takes_frame != (config["route"] == "frame"):
        raise RuntimeError(
            f"the configuration names the {config['route']} route, but the "
            f"scene takes the {'frame' if takes_frame else 'bounce'} route")


def main(argv=None):
    ap = argparse.ArgumentParser(description="Run one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    from . import bench

    chips = next(w["chips"] for w in bench.benchmark()["workloads"]
                 if w["name"] == args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        _log(f"this cell needs {chips} CUDA device(s); {have} found")
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        _log(f"forbidden modules loaded: {', '.join(found)}")
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
