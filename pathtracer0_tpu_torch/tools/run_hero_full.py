"""Run the hero config (BASELINE config 5) to the real 4,096-spp target
once, end to end (reference: dispatch.java:49-55, 594-602).

Counterpart of the JAX package's tools/run_hero_full.py. The run goes
through `render.driver.FrameLoopDriver`, so the render-anomaly watchdog
is checked after every chunk; it first renders one chunk to warm up the
very calls the loop makes and resets the accumulation, checkpoints the
accumulation every `ckpt_every` frames and screenshots the final image.
`time_to_4096spp_s` is the JAX record's: the loop's wall time, the
checkpoints in it, until the image is on the host. Each checkpoint's own
seconds are taken after a synchronize, so the frames still queued on the
card are not counted in them.
Then it renders an independent second accumulation (seed + 1), so the
final noise is measured: for two independent unbiased accumulations
rmse(a, b) = sqrt(2) sigma, so the residual noise of one image is
rmse / sqrt(2).

It writes hero_run_torch.json, hero_ckpt_torch.npz and GLSL_render.png
into `out_dir` and nowhere else (the repo-root HERO_RUN.json is the JAX
package's record and is not this run's). The record has the JAX record's
keys, plus the card's name and power limit.

Run:  python -m pathtracer0_tpu_torch.tools.run_hero_full --out-dir DIR
                [--spp 4096] [--ckpt-every 64] [--chunk 16] [--device cpu]

It runs on the card and raises without one; `--device cpu` runs the plain
versions (far too slow at the hero's size) and measures no time.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time

import numpy as np

from .. import scenes
from ..config import RenderConfig
from ..core.device import resolve_device, synchronize
from ..render.driver import FrameLoopDriver
from ..render.renderer import Renderer

HERO = dict(width=1920, height=1080, samples_per_frame=8, max_bounces=6,
            auto_focus=False, blur=0.001)


def card_name_and_power(dev):
    """(name, power limit) as nvidia-smi gives them for the card; ("cpu",
    None) off the card."""
    if dev.type != "cuda":
        return "cpu", None
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    name, power = (x.strip() for x in line.split(",", 1))
    return name, power


def run(target_spp=4096, ckpt_every=64, chunk=16, seed=0, *, out_dir,
        device=None, overrides=None, log=print):
    """Render config 5 to `target_spp` samples a pixel and again with seed
    + 1; write the record, the last checkpoint and the screenshot into
    `out_dir`; return the record. `overrides` replaces fields of the
    hero's RenderConfig (tests give a tiny size through it). Times are
    None off the card."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"

    cfg = dataclasses.replace(RenderConfig(**HERO), **(overrides or {}))
    n_frames = target_spp // cfg.samples_per_frame
    os.makedirs(out_dir, exist_ok=True)

    t0 = time.perf_counter()
    scene, info = scenes.BUILDERS[5]().build(max_leaf=4, device=dev)
    synchronize(dev)
    build_s = time.perf_counter() - t0

    cam, rot = scenes.CAMERAS[5]
    drv = FrameLoopDriver(scene, info, cfg, cam_pos=cam, cam_rot=rot,
                          screenshot_dir=out_dir, log=log, device=dev)
    # warm up the calls the loop makes, and the watchdog's copy, then
    # start the accumulation afresh
    drv.renderer.render(frames=chunk, chunk=chunk)
    drv._watchdog_check()
    drv.renderer.reset_accumulation()
    drv.frames_still = 0
    synchronize(dev)
    compile_s = time.perf_counter() - t0 - build_s

    ckpt_path = os.path.join(out_dir, "hero_ckpt_torch.npz")
    per_ckpt = []
    t0 = time.perf_counter()
    done = 0
    while done < n_frames:
        k = min(chunk, n_frames - done)
        drv.renderer.render(frames=k, chunk=chunk)
        drv.frames_still += k
        drv._watchdog_check()
        if drv.anomaly:
            raise RuntimeError(f"watchdog tripped: {drv.anomaly}")
        done += k
        if done % ckpt_every == 0 or done == n_frames:
            synchronize(dev)
            tc = time.perf_counter()
            drv.renderer.save_checkpoint(ckpt_path)
            per_ckpt.append(time.perf_counter() - tc)
    # the copy to the host waits for the card: the clock stops when the
    # image is real
    img_a = np.clip(drv.renderer.display_image().cpu().numpy(), 0.0, 1.0)
    wall_s = time.perf_counter() - t0
    if drv.renderer._count != n_frames:
        raise RuntimeError(f"accumulated {drv.renderer._count} frames, "
                           f"not {n_frames}")
    shot = drv.renderer.screenshot(directory=out_dir)

    # an independent accumulation, for the measured residual noise
    r2 = Renderer(scene, info, cfg, cam_pos=cam, cam_rot=rot, seed=seed + 1,
                  device=dev)
    t0 = time.perf_counter()
    r2.render(frames=n_frames, chunk=chunk)
    img_b = np.clip(r2.display_image().cpu().numpy(), 0.0, 1.0)
    wall_b = time.perf_counter() - t0
    rmse_pair = float(np.sqrt(np.mean((img_a - img_b) ** 2)))

    name, power = card_name_and_power(dev)
    rec = {
        "metric": "config5 hero run to 4096 spp (measured, not estimated)",
        "target_spp": target_spp,
        "frames": n_frames,
        "time_to_4096spp_s": wall_s if on_card else None,
        "time_to_4096spp_s_second_run": wall_b if on_card else None,
        "samples_per_s": (cfg.width * cfg.height * target_spp / wall_s
                          if on_card else None),
        "build_s": build_s if on_card else None,
        "compile_s": compile_s if on_card else None,
        "ckpt_every_frames": ckpt_every,
        "ckpt_save_s": per_ckpt[:4] if on_card else None,
        "ckpt_save_s_total": sum(per_ckpt) if on_card else None,
        "rmse_between_independent_4096spp": rmse_pair,
        "residual_noise_per_image": rmse_pair / float(np.sqrt(2)),
        "screenshot": os.path.basename(shot),
        "watchdog": "active (checked every chunk)",
        "device": name,
        "power_limit": power,
        "shape": [cfg.width, cfg.height, cfg.samples_per_frame,
                  cfg.max_bounces],
        "checkpoints": len(per_ckpt),
    }
    with open(os.path.join(out_dir, "hero_run_torch.json"), "w") as f:
        json.dump(rec, f, indent=1)
    log(json.dumps(rec))
    return rec


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spp", type=int, default=4096)
    ap.add_argument("--ckpt-every", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    run(target_spp=args.spp, ckpt_every=args.ckpt_every, chunk=args.chunk,
        out_dir=args.out_dir, device=args.device)
