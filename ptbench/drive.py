"""The one session generator: how a user drives the renderer, from a traffic
mix's parameters.

A session is one user in a closed loop at a fixed camera: frames of
`Renderer.step(frame_seed)` back to back, each ended by a synchronize, as
a displayed frame is. After `clean_spp` samples a pixel the image is
clean: it is written as an auto-screenshot PNG (deleted at once), the
accumulation is reset and a new seed stream starts
(dispatch.java:594-602).

Frame seeds come from the run's seed and are passed to `step`, so the
check knows them.

Every image the session shows is an answer. The check takes each image
when it is complete, the first frame after each reset (shown alone), and
the image on the display when the window closes: a sample of its pixels,
drawn from the run's seed and the image's index, is gathered on the
device (no sync), with what the check needs to render it again: the pose
and the frame seeds.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional

import numpy as np
import torch

from .bench import camera

QUALITIES = ("full", "first")


def stream(seed: int, *key) -> np.random.Generator:
    """An independent generator for (seed, *key)."""
    return np.random.Generator(np.random.PCG64(
        np.random.SeedSequence([int(seed) & ((1 << 64) - 1), *key])))


@dataclasses.dataclass
class Image:
    """One shown image to be checked."""

    quality: str            # "full" or "first" (a first frame alone)
    pos: tuple              # float32 pose
    rot: tuple
    seeds: list             # its frames' seeds, in order
    idx: torch.Tensor       # (P,) the pixels sampled, on the device
    values: torch.Tensor    # (P, 3) the program's pixels, on the device


@dataclasses.dataclass
class Record:
    """What a stretch of the session did."""

    frames: int = 0                     # frames rendered
    samples: int = 0                    # pixel samples of all frames
    start: float = 0.0
    end: float = 0.0
    frame_s: List[float] = dataclasses.field(default_factory=list)
    frame_end: List[float] = dataclasses.field(default_factory=list)
    step_host_s: List[float] = dataclasses.field(default_factory=list)
    images: List[Image] = dataclasses.field(default_factory=list)
    queries: int = 0                    # scene queries (traced stretch)


def pixels(seed, image, width, height, count, quality, device):
    """`count` distinct pixel indices of a width x height image, drawn
    anew for each image and quality."""
    rng = stream(seed, 7, QUALITIES.index(quality), image)
    n = width * height
    idx = rng.choice(n, size=min(count, n), replace=False)
    return torch.as_tensor(np.sort(idx), dtype=torch.int64, device=device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _span(name):
    return torch.profiler.record_function(name)


class Session:
    """A user at the renderer for one run."""

    def __init__(self, cell, scene, info, rc, seed: int, device):
        from pathtracer0_tpu_torch.render.renderer import Renderer

        self.mix, self.seed, self.device = cell.mix, int(seed), device
        self.rc = rc
        pos, rot = camera(cell.config, cell.config_module)
        self.pose0 = (np.asarray(pos, np.float32), np.asarray(rot, np.float32))
        self.count = {"full": self.mix["check_pixels"],
                      "first": self.mix["check_pixels_first"]}
        self.shot_dir = None
        self.renderer = Renderer(scene, info, rc, cam_pos=self.pose0[0],
                                 cam_rot=self.pose0[1], device=device)
        self.per_image = max(1, self.mix["clean_spp"]
                             // rc.samples_per_frame)
        self.image_k = 0
        self._new_image()

    def _new_image(self):
        """A fresh image: its seed stream."""
        self.image_seeds = stream(self.seed, 1, self.image_k).integers(
            0, 1 << 32, size=self.per_image).tolist()
        self.seeds = []

    def restart(self):
        """Start the measured session anew after the warm-up: a fresh
        accumulation and seed streams, so the warm-up leaves nothing
        behind."""
        self.renderer.reset_accumulation()
        self.image_k = 0
        self._new_image()

    def _frame(self, rec: Record):
        r = self.renderer
        seed = int(self.image_seeds[len(self.seeds)])
        t0 = time.perf_counter()
        with _span("ptbench.step"):
            img = r.step(seed)
        t1 = time.perf_counter()
        _sync(self.device)
        t2 = time.perf_counter()
        rec.frame_s.append(t2 - t0)
        rec.frame_end.append(t2)
        rec.step_host_s.append(t1 - t0)
        rec.frames += 1
        rec.samples += self.rc.width * self.rc.height \
            * self.rc.samples_per_frame
        self.seeds.append(seed)
        self.last = img
        if len(self.seeds) == 1 < self.per_image:
            # the first frame after a reset is shown alone: an answer
            # of one frame, where a wrong sample is not averaged away,
            # checked at more pixels, as few of a frame's paths part
            self._finish_image(rec, shot=False, quality="first")
        if len(self.seeds) == self.per_image:
            self._finish_image(rec, shot=self.mix.get("screenshot", False))
            r.reset_accumulation()
            self.image_k += 1
            self._new_image()

    def _finish_image(self, rec: Record, shot: bool, quality="full"):
        idx = pixels(self.seed, self.image_k, self.rc.width, self.rc.height,
                     self.count[quality], quality, self.device)
        vals = self.last.reshape(-1, 3)[idx]
        rec.images.append(Image(quality, tuple(self.pose0[0]),
                                tuple(self.pose0[1]), list(self.seeds), idx,
                                vals))
        if shot:
            with _span("ptbench.screenshot"):
                path = self.renderer.auto_screenshot(self.shot_directory())
                os.remove(path)

    def shot_directory(self):
        if self.shot_dir is None:
            import tempfile

            from .bench import tmp_dir
            self.shot_dir = tempfile.mkdtemp(prefix="shots", dir=tmp_dir())
        return self.shot_dir

    def run(self, *, seconds: Optional[float] = None,
            count: Optional[int] = None):
        """Run until `seconds` have passed (whole frames) or for `count`
        frames. Returns the Record; the image in progress is added as an
        answer at the end."""
        rec = Record()
        rec.start = time.perf_counter()
        done = 0
        with _span("ptbench.window"):
            while True:
                if seconds is not None and time.perf_counter() - rec.start \
                        >= seconds:
                    break
                if count is not None and done >= count:
                    break
                self._frame(rec)
                done += 1
        rec.end = time.perf_counter()
        if self.seeds:
            self._finish_image(rec, shot=False)
        return rec

    def warm(self):
        """Every shape the stretch uses, once: an image's first frames and
        a screenshot."""
        for _ in range(self.mix["warm"]):
            self._frame(Record())
        if self.mix.get("screenshot"):
            self._finish_image(Record(), shot=True)
        _sync(self.device)
        self.restart()

    def close(self):
        if self.shot_dir is not None:
            import shutil

            shutil.rmtree(self.shot_dir, ignore_errors=True)
