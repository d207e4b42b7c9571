"""Faults planted in the program under test, to show that `correct` catches
them (tests/test_ptb_faults.py on the CPU; control.py --fault on the card).

  state_unchanged  a step that leaves the accumulation as it was: the
                   frame is rendered and counted, its image never added
  half_batch       half of each frame's samples left out, the mean taken
                   over the rest
  answer_altered   one frame in two altered where it is produced: its
                   image scaled by 1.25

One card renders each cell, so no exchange between cards can be left out.
`plant(name)` patches the port in this process and returns the function
that undoes it.
"""
from __future__ import annotations

import dataclasses

FAULTS = ("state_unchanged", "half_batch", "answer_altered")


def plant(name: str):
    from pathtracer0_tpu_torch.render import renderer as mod

    if name == "state_unchanged":
        real = mod.Renderer._accum

        def accum(self, seeds):
            before = self._sum
            real(self, seeds)
            self._sum = before

        mod.Renderer._accum = accum
        return lambda: setattr(mod.Renderer, "_accum", real)
    real = mod.render_frame
    calls = [0]

    if name == "half_batch":
        def render_frame(scene, info, config, *a, **kw):
            half = dataclasses.replace(
                config, samples_per_frame=max(1, config.samples_per_frame
                                              // 2))
            return real(scene, info, half, *a, **kw)
    elif name == "answer_altered":
        def render_frame(*a, **kw):
            img, rays = real(*a, **kw)
            calls[0] += 1
            return (img * 1.25 if calls[0] % 2 == 0 else img), rays
    else:
        raise ValueError(f"no fault {name!r}; faults: {FAULTS}")
    mod.render_frame = render_frame
    return lambda: setattr(mod, "render_frame", real)
