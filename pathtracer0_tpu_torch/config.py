"""Render configuration of the PyTorch/CUDA port.

Same fields and defaults as the JAX package's `RenderConfig`, so a config
can be written once and handed to either renderer. Of that package's
execution knobs the port takes two, both "auto", "on" or "off" (there is
no "interpret": the plain PyTorch versions of the kernels serve the CPU):

  fused   "auto" / "on": a scene the brute-force kernels take (at most
          2048 triangles, 1..32 materials) renders through the whole-frame
          kernel, and `render_rays` sends its rays to the block kernel;
          "off": every scene goes the per-bounce route over the SAH forest.
          A streamed scene always goes the per-bounce route; "on" refuses
          it
  pallas  selects nothing: the tensors' device does (the CUDA kernels
          on the card, their plain versions on the CPU, where every
          value renders alike). The renderer's check is its one reader:
          it refuses "off" on the card, where nothing takes the kernels'
          place

`debug`, `legacy_shading` and `legacy_pathtrace` render as the JAX
package's do (render/renderer.py), never through the frame path.

`ray_batch_size` bounds the pixels the per-bounce route renders at once
(render/renderer.render_rays; 0: no limit). `traversal_stack_depth` is
ignored: the traversal stack is sized from the forest's depth.
`max_bvh_depth`, `max_tris_in_leaf`, `sah_planes` and `stream_threshold`
are read by `Scene.build(config=...)`: a scene of more than
`stream_threshold` triangles gets the streamed LBVH instead of the forest.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """The params block of the reference shader (frag.glsl:39-52) plus the
    host-side constants (dispatch.java:45-61)."""

    width: int = 800
    height: int = 600

    cam_size: float = 1.5
    focal_length: float = 1.0

    samples_per_frame: int = 8
    max_bounces: int = 6

    blur: float = 0.001
    focal_distance: float = 1.0
    auto_focus: bool = True

    raytracing: bool = True         # True = path trace, False = Whitted
    debug: bool = False             # BVH traversal-cost heatmap
    legacy_shading: bool = False    # Whitted: Phong with disk lights
    legacy_pathtrace: bool = False  # path mode: the deterministic pathTrace

    gamma: float = 0.0

    max_bvh_depth: int = 256
    max_tris_in_leaf: int = 1
    sah_planes: int = 5

    # Routing (see the module docstring).
    pallas: str = "auto"
    fused: str = "auto"
    ray_batch_size: int = 1 << 20
    traversal_stack_depth: int = 64  # ignored (see the module docstring)
    refraction_stack_depth: int = 10
    stream_threshold: int = 65536

    @property
    def screen_h_ratio(self) -> float:
        return self.height / float(self.width)

    @property
    def resolution(self) -> Tuple[int, int]:
        return (self.width, self.height)

    def preview(self) -> "RenderConfig":
        """The interactive quality while the camera moves: 500 px wide at
        the same aspect, 4 spp, 2 bounces (dispatch.java:649-662)."""
        return dataclasses.replace(
            self, width=500, height=int(round(500 * self.screen_h_ratio)),
            samples_per_frame=4, max_bounces=2)
