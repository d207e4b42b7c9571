"""One frame of the per-bounce route as a CUDA graph.

`renderer.render_frame` renders a path-mode frame of the per-bounce route
on the card (`pixel_centers`, then `render_rays` over every pixel: per
sample the camera form, then per bounce the walk, the streamed query's
key, sort and ordered walk, and `bounce_step`; the sample totals and the
queries) by replaying a `torch.cuda.CUDAGraph` of that whole frame. A
`Slot` holds the graph of one key (the scene, its info, the config, the
device); another key frees it before the next is captured.

The first frame of a key runs the same route eagerly: it loads every
kernel, and it is that frame's answer. Then the frame is captured as it
is: `integrator._run_bounces` runs every bounce and reads nothing back
on any device, so the replays give the eager frame's bits. Each
later frame writes its inputs into the graph's static buffers (the frame
seed as a 0-d int64 holding seed & MASK, cam_pos, cam_rot, ifd), so a
camera move replays the same graph, and replays it in one
`pt0.route.replay` span. Its outputs are the graph's static buffers,
which the next replay overwrites.

A captured launch runs at every replay, so each replay adds the launches
the capture made to the kernels' launch counters (`bounce.bounce_step`,
`bounce.camera_step`, `wavefront.launches`), which the capture itself
leaves as they were: they keep counting kernels run. `counts` holds the
captures and the replays.
"""
from __future__ import annotations

import torch

from ..core.rng import MASK
from ..kernels import bounce, wavefront
from ..utils.trace import span

counts = {"captures": 0, "replays": 0}


def _launches():
    """The launch counters a frame of the route advances."""
    return {"bounce_step": bounce.bounce_step.launches,
            "camera_step": bounce.camera_step.launches,
            **wavefront.launches}


def _add_launches(by):
    """Add `by` (keys as `_launches`) to the launch counters."""
    bounce.bounce_step.launches += by["bounce_step"]
    bounce.camera_step.launches += by["camera_step"]
    for name in wavefront.launches:
        wavefront.launches[name] += by[name]


def _minus(a, b):
    return {k: a[k] - b[k] for k in a}


class FrameGraph:
    """The frame of one key (scene, info, config, device): the static
    inputs, and once captured the graph, its outputs and the launches it
    holds. `body(frame_seed, cam_pos, cam_rot, ifd)` renders the frame
    from the static inputs."""

    def __init__(self, key, body):
        self.key, self.body = key, body
        self.device = device = key[3]
        self.seed = torch.zeros((), dtype=torch.int64, device=device)
        self.pos = torch.zeros(3, dtype=torch.float32, device=device)
        self.rot = torch.zeros(3, dtype=torch.float32, device=device)
        self.ifd = torch.zeros((), dtype=torch.float32, device=device)
        self.graph = self.out = self.launched = None

    def _inputs(self):
        return self.seed, self.pos, self.rot, self.ifd

    def run(self, frame_seed: int, cam_pos, cam_rot, ifd):
        """The frame of `frame_seed` at the pose: the body run eagerly
        and then captured at a key's first frame, the graph replayed at
        the others (then the outputs are the graph's buffers)."""
        self.seed.fill_(int(frame_seed) & MASK)
        self.pos.copy_(cam_pos)
        self.rot.copy_(cam_rot)
        self.ifd.copy_(ifd.reshape(()))
        with torch.cuda.device(self.device):
            if self.graph is None:
                out = self.body(*self._inputs())
                self._capture()
                return out
            with span("pt0.route.replay"):
                self.graph.replay()
        _add_launches(self.launched)
        counts["replays"] += 1
        return self.out

    def _capture(self):
        before = _launches()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                out = self.body(*self._inputs())
        finally:
            captured = _minus(_launches(), before)
            # nothing ran: the counters stay as they were
            _add_launches(_minus(before, _launches()))
        self.graph, self.out, self.launched = graph, out, captured
        counts["captures"] += 1


def _same(a, b) -> bool:
    """Keys (scene, info, config, device): the same scene and info
    objects, equal config and device."""
    return a[0] is b[0] and a[1] is b[1] and a[2:] == b[2:]


class Slot:
    """The one frame graph kept: that of the latest key. Another key drops
    it, and with it its memory pool, before the next is made."""

    def __init__(self):
        self.frame = None

    def frame_for(self, key, body) -> FrameGraph:
        if self.frame is None or not _same(self.frame.key, key):
            self.frame = None
            self.frame = FrameGraph(key, body)
        return self.frame
