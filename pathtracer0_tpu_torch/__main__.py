"""CLI: the progressive render loop with stdin commands, on the card.

Usage:
    python -m pathtracer0_tpu_torch [--scene {1..5}|path.obj] [--width W]
        [--height H] [--spp N] [--bounces N] [--frames N] [--whitted]
        [--auto-screenshot N] [--out DIR] [--device cuda|cpu]

The flags of the JAX package's CLI, plus `--device` (default "cuda"; "cpu"
runs the plain PyTorch versions of the kernels). The loop reads commands
from stdin once a frame (the reference's functions.commands,
dispatch.java:779-802): `telemetry`, `screenshot [name]`, `move x y z`,
`rot rx ry rz`, WASD/q/e/arrow keys as words, '=' / '-' speed scaling,
`quit`.
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="pathtracer0_tpu_torch")
    ap.add_argument("--scene", default="3",
                    help="built-in scene 1-5 (pathtracer0_tpu_torch.scenes) "
                         "or a .obj path")
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=600)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--bounces", type=int, default=6)
    ap.add_argument("--frames", type=int, default=None,
                    help="stop after N frames (default: run until quit)")
    ap.add_argument("--whitted", action="store_true")
    ap.add_argument("--auto-screenshot", type=int, default=None,
                    metavar="N", help="save a screenshot after N still "
                                      "frames (dispatch.java:594-602)")
    ap.add_argument("--out", default="screenshots")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default: cuda)")
    args = ap.parse_args(argv)

    from . import RenderConfig, Scene, scenes
    from .render.driver import FrameLoopDriver

    if args.scene in {"1", "2", "3", "4", "5"}:
        n = int(args.scene)
        sc = scenes.BUILDERS[n]()
        cam, rot = scenes.CAMERAS[n]
    else:
        sc = Scene()
        sc.set_constant_sky((0.5, 0.6, 0.9))
        sc.add_material("default")
        sc.set_last_mtl("Kd", (0.7, 0.7, 0.7))
        sc.add_object(args.scene, material=0)
        cam, rot = (0.0, 1.0, -3.0), (0.0, 0.0, 0.0)

    cfg = RenderConfig(width=args.width, height=args.height,
                       samples_per_frame=args.spp, max_bounces=args.bounces,
                       raytracing=not args.whitted)
    t0 = time.perf_counter()
    dev, info = sc.build(cfg, max_leaf=4, device=args.device)
    print(f"scene built in {time.perf_counter() - t0:.1f}s "
          f"(tris={info.num_tris}, streamed={info.streamed})", flush=True)

    drv = FrameLoopDriver(dev, info, cfg, cam_pos=cam, cam_rot=rot,
                          auto_screenshot_after=args.auto_screenshot,
                          screenshot_dir=args.out, device=args.device)
    t0 = time.perf_counter()
    drv.run(max_frames=args.frames)
    # frame indices only grow; _count restarts at every move and preview
    n_frames = drv.renderer._frame_index + drv.preview_renderer._frame_index
    dt = time.perf_counter() - t0
    print(f"{n_frames} frames in {dt:.1f}s "
          f"({drv.renderer.rays_traced / max(dt, 1e-9) / 1e6:.1f} Mrays/s)",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
