"""Faults planted in the program under test, to show that `correct` catches
them (tests/test_ptb_faults.py on the CPU; control.py --fault on the card).

  state_unchanged  a step that leaves the accumulation as it was: the
                   frame is rendered and counted, its image never added
  half_batch       half of each frame's samples left out, the mean taken
                   over the rest
  answer_altered   one frame in two altered where it is produced: its
                   image scaled by 1.25

Faults of the geometry, in a tuple of their own (a scene without the
primitive they break renders as before, so they are planted only where
the cell's configuration has it):

  march_coarse         an implicit surface marched over half the lattice
                       steps (MARCH_STEPS) with half the bisections
                       (BISECT_ITERS)
  ellipsoid_unrotated  each ellipsoid's rotation dropped when the scene is
                       built

One card renders each cell, so no exchange between cards can be left out.
`plant(name)` patches the port in this process and returns the function
that undoes it; plant it before the scene is built.
"""
from __future__ import annotations

import dataclasses

FAULTS = ("state_unchanged", "half_batch", "answer_altered")
GEOMETRY_FAULTS = ("march_coarse", "ellipsoid_unrotated")


def applies(name: str, config: dict) -> bool:
    """Whether fault `name` can show in a scene of `config`."""
    if name == "march_coarse":
        return bool(config.get("implicits"))
    if name == "ellipsoid_unrotated":
        return any(any(v != 0 for v in e["rot"])
                   for e in config.get("ellipsoids", []))
    return True


def _plant_geometry(name: str):
    if name == "march_coarse":
        from pathtracer0_tpu_torch.shade import implicits

        saved = {k: getattr(implicits, k)
                 for k in ("MARCH_STEPS", "BISECT_ITERS", "march")}
        steps = saved["MARCH_STEPS"] // 2
        iters = saved["BISECT_ITERS"] // 2
        real = saved["march"]

        def march(fn_id, ox, oy, oz, dx, dy, dz, **kw):
            return real(fn_id, ox, oy, oz, dx, dy, dz,
                        **{**kw, "steps": steps, "bisect_iters": iters})

        # the card's kernels read the module's constants at each launch,
        # the plain route calls `march`
        implicits.MARCH_STEPS, implicits.BISECT_ITERS = steps, iters
        implicits.march = march
        return lambda: [setattr(implicits, k, v) for k, v in saved.items()]
    from pathtracer0_tpu_torch.scene.scene import Scene

    real = Scene.add_ellipsoid

    def add_ellipsoid(self, c, stretch, rot, radius, m):
        real(self, c, stretch, (0.0, 0.0, 0.0), radius, m)

    Scene.add_ellipsoid = add_ellipsoid
    return lambda: setattr(Scene, "add_ellipsoid", real)


def plant(name: str):
    if name in GEOMETRY_FAULTS:
        return _plant_geometry(name)
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
        raise ValueError(f"no fault {name!r}; faults: "
                         f"{FAULTS + GEOMETRY_FAULTS}")
    mod.render_frame = render_frame
    return lambda: setattr(mod, "render_frame", real)
