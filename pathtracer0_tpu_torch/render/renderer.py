"""Frames, progressive accumulation and screenshots (dispatch.java:593-851,
frag.glsl:884-933).

`render_frame` renders one frame of H*W pixels x spp samples, one RNG
stream per pixel seeded index + frame_seed and carried across the samples,
by one of two routes:

  frame path        kernels/frame.py, the whole frame in one launch, where
                    the scene is eligible and `config.fused` is not "off"
  per-bounce route  `render_rays`: the samples one after the other on one
                    state of the rays (kernels/bounce.py), each the camera
                    form of bounce_kernel (`camera_step`: the rays with
                    depth of field, the path state begun, the sample
                    before added into the running sum), then the bounces
                    of `integrator.trace_state` (or the Whitted
                    `direct_state`) over the SAH forest or, for a
                    streamed scene, the two-level LBVH, or the block
                    kernel (`trace_fused`) where the scene is eligible;
                    more than `config.ray_batch_size` pixels go through
                    it in chunks. On the card a path-mode frame of it is
                    one CUDA graph's replay (render/graph.py: captured at
                    the first frame of a scene and config)

Autofocus takes the centre ray's hit distance (frag.glsl:901-906), probed
once per frame, or once per camera pose by `Renderer`.

`render_rays` also serves the modes that never take the frame path:
`fold_spp=True` folds the samples into the ray axis (one query of spp x N
rays, each sample its own RNG stream, a different but equally unbiased
estimator); `config.legacy_pathtrace` (path mode) and
`config.legacy_shading` (Whitted mode, on a scene with disk lights) render
one evaluation of shade/arealights.py per frame, spp being its soft-shadow
resolution. `render_debug_frame` is the traversal-cost heatmap of
`config.debug` (frag.glsl:534, 539-547).

`Renderer` is the session around them: progressive accumulation, camera
moves, screenshots, checkpoint and resume (the JAX package's `.npz` keys,
so a checkpoint of either package loads in the other), the mouse
inspector (`pick`, `display_image_with_pick`) and the `telemetry` text;
with `config.debug` it accumulates heatmap frames instead.
"""
from __future__ import annotations

import dataclasses
import datetime
import functools
import os
from typing import Optional

import numpy as np
import torch

from ..config import RenderConfig
from ..core import camera
from ..core import math as vm
from ..core import rng as vrng
from ..core.device import resolve_device
from ..kernels import bounce, frame, traverse
from ..shade import arealights
from . import graph, integrator

# sample k of a folded pixel seeds its stream as pixel index + k * stride:
# an odd constant (2^32 / golden ratio), not the local pixel count, so a
# tiled render of several cards seeds as one card does
FOLD_STRIDE = 2654435769
# the heatmap's red term of the triangle tests, which the reference never
# counts: exp(0.02 (0 - 150)) (frag.glsl:534)
_HEAT_TRI = float(np.float32(np.exp(0.02 * (0.0 - 150.0))))
# the frame graph of render_frame's callers that keep none of their own
_GRAPHS = graph.Slot()


def _check(config: RenderConfig, dev: torch.device):
    """Refuse a `fused` or `pallas` none of "auto", "on", "off", and
    pallas="off" on the card: `pallas`'s one reader (the tensors' device
    picks the kernels or their plain versions)."""
    for name in ("fused", "pallas"):
        if getattr(config, name) not in ("auto", "on", "off"):
            raise ValueError(
                f"{name} must be 'auto', 'on' or 'off', not "
                f"{getattr(config, name)!r}: the port has no interpret "
                "mode, its plain versions serve the CPU")
    if config.pallas == "off" and dev.type != "cpu":
        raise ValueError(
            "pallas='off' renders through the plain versions, on the CPU "
            "only (integrator.trace_bounces_reference runs them anywhere)")


def _on(scene, device) -> torch.device:
    dev = resolve_device(device)
    if scene.device != dev:
        raise ValueError(f"scene lies on {scene.device}, renderer on {dev}")
    return dev


def autofocus_distance(scene, info, cam_pos, cam_rot, focal_distance: float,
                       auto_focus: bool):
    """The internal focal distance: the centre ray's hit distance when
    autofocus is on and it hits, else `focal_distance` (0-dim f32)."""
    ifd = torch.tensor(focal_distance, dtype=torch.float32,
                       device=scene.device)
    if not auto_focus:
        return ifd
    d = camera.center_probe_direction(cam_rot)
    hit, _ = traverse.ray_scene(
        tuple(cam_pos[i].reshape(1) for i in range(3)),
        tuple(d[i].reshape(1) for i in range(3)), scene, info)
    mid = torch.where(hit.is_hit, hit.t, -1.0)[0]
    return torch.where(mid > 0.0, mid, ifd)


def _legacy(config: RenderConfig, info) -> bool:
    """Whether `render_rays` renders through shade/arealights.py."""
    return (config.legacy_pathtrace if config.raytracing
            else config.legacy_shading and bool(info.lights))


def render_rays(scene, info, uv, index, cam_pos, cam_rot, frame_seed: int,
                ifd, *, config: RenderConfig, screen_h_ratio=None,
                fold_spp: bool = False):
    """The per-bounce route over a flat batch of pixels: uv (N, 2) pixel
    centres, index (N,) pixel indices that seed the RNG streams. This is
    the unit that spreads over several cards: pixels are independent.
    `screen_h_ratio` is the whole image's height / width (default: the
    config's). Returns (colour (N, 3), mean of the samples; queries (1,)
    int64).

    More than `config.ray_batch_size` pixels (0: no limit) are rendered in
    that many nearly equal chunks one after the other, so the live state
    (some 30 tensors a ray) stays inside a fixed envelope whatever the
    resolution; a pixel's RNG stream depends on its index alone, so the
    result is the same.

    fold_spp=True (with spp > 1) folds the samples into the ray axis: one
    query of spp x N rays, sample k of pixel i seeded i + k * FOLD_STRIDE,
    the colour the mean over the samples. Otherwise a legacy mode of the
    config renders one evaluation of shade/arealights.py (spp its
    soft-shadow resolution), and the other modes spp samples one after
    the other."""
    _check(config, index.device)
    integrator.check_fused(info, config.fused)
    if screen_h_ratio is None:
        screen_h_ratio = config.screen_h_ratio
    n, batch = index.shape[0], config.ray_batch_size
    if batch and n > batch:
        whole = dataclasses.replace(config, ray_batch_size=0)
        n_chunks = -(-n // batch)
        parts = [render_rays(scene, info, uv_c, index_c, cam_pos, cam_rot,
                             frame_seed, ifd, config=whole,
                             screen_h_ratio=screen_h_ratio, fold_spp=fold_spp)
                 for uv_c, index_c in zip(uv.tensor_split(n_chunks),
                                          index.tensor_split(n_chunks))]
        return (torch.cat([p[0] for p in parts]),
                torch.stack([p[1] for p in parts]).sum(0))
    spp = config.samples_per_frame
    rotmat = vm.rotation_matrix(cam_rot.to(torch.float32))
    direction = camera.primary_directions(
        uv, rotmat, config.cam_size, config.focal_length, screen_h_ratio)
    cam = bounce.camera_scalars(cam_pos, rotmat, ifd)
    if fold_spp and spp > 1:
        return _render_folded(scene, info, index, cam, direction,
                              frame_seed, config)
    state = vrng.seed(index, frame_seed)
    pd = direction.T.contiguous()
    if _legacy(config, info):
        st = bounce.state_for(state, path=False, rays_only=True)
        _camera_step(st)(st, pd, cam, config.blur)
        o, d, state = tuple(st.o), tuple(st.d), st.state
        if config.raytracing:
            col, state, queries = arealights.path_trace(
                o, d, state, scene, info, spp, config.max_bounces,
                stack_size=config.refraction_stack_depth)
        else:
            col, state = arealights.shade_point(o, d, state, scene, info,
                                                spp)
            queries = torch.full((1,), n, dtype=torch.int64,
                                 device=state.device)
        return torch.stack(col, dim=-1), queries
    st = _sample_state(info, state, config)
    step = _camera_step(st)
    for k in range(spp):
        step(st, pd, cam, config.blur, accumulate=k > 0)
        _trace_sample(scene, info, st, config)
    # the last sample into the sum, as the camera form adds the others
    total = st.total + _sample_radiance(st)
    if config.raytracing:
        queries = st.queries.sum().reshape(1)
    else:
        queries = torch.full((1,), spp * n, dtype=torch.int64,
                             device=state.device)
    return total.T / float(spp), queries


def _camera_step(st):
    """The camera form of the state's device: the kernel on CUDA tensors,
    its plain version on CPU tensors."""
    if st.alive.device.type == "cuda":
        return bounce.camera_step
    return bounce.camera_step_plain


def _sample_state(info, state, config, totals=True):
    """`integrator.sample_state` of the config's route."""
    return integrator.sample_state(
        info, state, raytracing=config.raytracing,
        stack_size=config.refraction_stack_depth, fused=config.fused,
        totals=totals)


def _trace_sample(scene, info, st, config):
    """One begun sample through `integrator.trace_state` (path) or
    `direct_state` (Whitted)."""
    if config.raytracing:
        integrator.trace_state(scene, info, st,
                               max_bounces=config.max_bounces,
                               stack_size=config.refraction_stack_depth)
    else:
        integrator.direct_state(scene, info, st)


def _sample_radiance(st):
    """The radiance of the state's sample: inc + sky (path), inc
    (Whitted)."""
    return st.inc if st.skyc is None else st.inc + st.skyc


def fold_seeds(index, spp: int, frame_seed: int):
    """The RNG states of spp x N folded samples, sample-major: sample k of
    pixel index i starts from i + k * FOLD_STRIDE + frame_seed (mod
    2^32)."""
    folded = (index[None, :].to(torch.int64)
              + torch.arange(spp, device=index.device)[:, None]
              * FOLD_STRIDE) & vrng.MASK
    return vrng.seed(folded.reshape(-1), frame_seed)


def _render_folded(scene, info, index, cam, direction, frame_seed, config):
    """`render_rays` with fold_spp: one batch of spp x N rays."""
    spp, n = config.samples_per_frame, index.shape[0]
    state = fold_seeds(index, spp, frame_seed)
    st = _sample_state(info, state, config, totals=False)
    _camera_step(st)(st, direction.repeat(spp, 1).T.contiguous(), cam,
                     config.blur)
    _trace_sample(scene, info, st, config)
    col = _sample_radiance(st).T
    queries = (st.queries.sum().reshape(1) if config.raytracing
               else torch.full((1,), spp * n, dtype=torch.int64,
                               device=state.device))
    per_sample = col.reshape(spp, n, 3)
    total = per_sample[0]
    for k in range(1, spp):
        total = total + per_sample[k]
    return total / float(spp), queries


def heat_color(box, leaf):
    """The frag.glsl:534 colour of (R,) box tests and leaf visits: red
    0.01 per leaf plus exp(0.02 (tri - 150)) with tri, which the
    reference never counts, 0; blue exp(0.01 (box - 200)); green 0. The
    exponential is taken in float64 and rounded once, so the card and the
    CPU agree. Returns (R, 3) float32."""
    box = box.to(torch.float32)
    red = 0.01 * leaf.to(torch.float32) + _HEAT_TRI
    blue = torch.exp((0.01 * (box - 200.0)).to(torch.float64)).to(
        torch.float32)
    return torch.stack([red, torch.zeros_like(red), blue], dim=-1)


def render_debug_frame(scene, info, config: RenderConfig, cam_pos, cam_rot,
                       device=None):
    """The BVH traversal-cost heatmap (frag.glsl:534, 539-547) of the
    undeflected primary rays: (H, W, 3) float32.

    Over the SAH forest each object is walked alone from no hit, as the
    reference's debugRayScene does (wavefront.walk_object:
    traverse_kernel with that one root), and the mean of the objects'
    colours is taken. A streamed scene has no objects to walk: the colour
    of the whole query's per-ray counters (box tests, row visits) over
    max(objects, triangle objects, 1), the JAX package's packet formula
    (which counts per block of 1,024 rays). A scene of no triangles is
    black."""
    dev = _on(scene, device)
    _check(config, dev)
    cam_pos = torch.as_tensor(cam_pos, dtype=torch.float32, device=dev)
    cam_rot = torch.as_tensor(cam_rot, dtype=torch.float32, device=dev)
    w, h = config.width, config.height
    if info.num_objects == 0 and not info.streamed:
        return torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
    uv, _ = camera.pixel_centers(w, h, dev)
    d = camera.primary_directions(uv, vm.rotation_matrix(cam_rot),
                                  config.cam_size, config.focal_length,
                                  config.screen_h_ratio).unbind(-1)
    o = tuple(cam_pos[i].expand(w * h) for i in range(3))
    if info.streamed:
        box, rows = traverse.heat_counts(o, d, scene, info)
        n_obj = max(info.num_objects, info.num_tri_objects, 1)
        return (heat_color(box, rows) / float(n_obj)).reshape(h, w, 3)
    img = torch.zeros((w * h, 3), dtype=torch.float32, device=dev)
    for k in range(info.num_objects):
        box, leaf = traverse.object_heat_counts(o, d, scene, info, k)
        img = img + heat_color(box, leaf) / float(info.num_objects)
    return img.reshape(h, w, 3)


def render_frame(scene, info, config: RenderConfig, cam_pos, cam_rot,
                 frame_seed: int, device=None, ifd=None, graphs=None):
    """One frame: ((H, W, 3) float32 mean of the samples, scene queries
    (1,) int64). `ifd` skips the autofocus probe when given.

    Where `takes_graph`, the frame of the per-bounce route is a CUDA
    graph's replay (render/graph.py), kept in `graphs` (a `graph.Slot`):
    a caller that gives its own slot gets the graph's output buffers,
    which its next frame overwrites; without one, the module's slot and a
    copy."""
    dev = _on(scene, device)
    _check(config, dev)
    cam_pos = torch.as_tensor(cam_pos, dtype=torch.float32, device=dev)
    cam_rot = torch.as_tensor(cam_rot, dtype=torch.float32, device=dev)
    if ifd is None:
        ifd = autofocus_distance(scene, info, cam_pos, cam_rot,
                                 config.focal_distance, config.auto_focus)
    whitted = not config.raytracing
    if (config.fused != "off" and not config.legacy_shading
            and not config.legacy_pathtrace
            and frame.eligible(info, whitted=whitted,
                               stack_size=config.refraction_stack_depth)):
        col, rays = frame.render_fused_frame(
            scene, info, cam_pos, cam_rot, frame_seed, ifd,
            width=config.width, height=config.height,
            spp=config.samples_per_frame, max_bounces=config.max_bounces,
            stack_size=config.refraction_stack_depth,
            cam_size=config.cam_size, focal_length=config.focal_length,
            blur=config.blur, whitted=whitted)
        return col.reshape(config.height, config.width, 3), rays
    if not takes_graph(config, info, dev):
        return _route_frame(scene, info, config, dev, frame_seed, cam_pos,
                            cam_rot, ifd)
    slot = _GRAPHS if graphs is None else graphs
    body = functools.partial(_route_frame, scene, info, config, dev)
    out = slot.frame_for((scene, info, config, dev), body).run(
        frame_seed, cam_pos, cam_rot, ifd)
    return out if graphs is not None else tuple(x.clone() for x in out)


def takes_graph(config: RenderConfig, info, dev) -> bool:
    """Whether `render_frame` replays a CUDA graph of the per-bounce
    route's frame (render/graph.py): CUDA tensors, path mode, no legacy
    mode."""
    return dev.type == "cuda" and config.raytracing and not _legacy(
        config, info)


def _route_frame(scene, info, config, dev, frame_seed, cam_pos, cam_rot,
                 ifd):
    """A frame of the per-bounce route over every pixel: ((H, W, 3),
    queries (1,))."""
    uv, index = camera.pixel_centers(config.width, config.height, dev)
    col, rays = render_rays(scene, info, uv, index, cam_pos, cam_rot,
                            frame_seed, ifd, config=config)
    return col.reshape(config.height, config.width, 3), rays


def render_frames_accum(scene, info, config: RenderConfig, cam_pos, cam_rot,
                        frame_seeds, sum0, rays0, device=None, ifd=None,
                        graphs=None):
    """Add len(frame_seeds) frames to the running sum: returns
    (sum0 + frames, rays0 + queries). `graphs` as in `render_frame`: each
    frame is added before the next replays."""
    for seed in frame_seeds:
        img, rays = render_frame(scene, info, config, cam_pos, cam_rot,
                                 int(seed), device=device, ifd=ifd,
                                 graphs=graphs)
        sum0 = sum0 + img
        rays0 = rays0 + rays
    return sum0, rays0


class Renderer:
    """Progressive accumulation: the running sum image and frame count of
    the reference (FRAME image + u_frameCount, frag.glsl:924-933), reset
    whenever the camera moves (dispatch.java:646-691)."""

    def __init__(self, scene, info, config: RenderConfig, cam_pos=None,
                 cam_rot=None, seed: int = 0, device=None):
        self.device = _on(scene, device)
        _check(config, self.device)
        self.scene, self.info, self.config = scene, info, config
        self.seed = seed
        self.cam_pos = torch.as_tensor(
            np.zeros(3) if cam_pos is None else cam_pos,
            dtype=torch.float32, device=self.device)
        self.cam_rot = torch.as_tensor(
            np.zeros(3) if cam_rot is None else cam_rot,
            dtype=torch.float32, device=self.device)
        self._sum = torch.zeros((config.height, config.width, 3),
                                dtype=torch.float32, device=self.device)
        self._count = 0
        self._frame_index = 0
        # queries accumulate on the device: reading them syncs
        self._rays = torch.zeros(1, dtype=torch.int64, device=self.device)
        self._rng = np.random.RandomState(seed)
        # seeds drawn from self._rng (not _frame_index where callers pass
        # explicit seeds): a resumed session fast-forwards by this count
        self._seed_draws = 0
        self._ifd = None  # autofocus distance of the current pose
        self._graphs = graph.Slot()  # its frame graph (render_frame)

    @property
    def rays_traced(self) -> int:
        """Scene queries so far (reading it waits for the device)."""
        return int(self._rays.item())

    def reset_accumulation(self):
        self._sum = torch.zeros_like(self._sum)
        self._count = 0

    def move_camera(self, pos=None, rot=None):
        """Camera motion resets the accumulation (dispatch.java:646-667)."""
        if pos is not None:
            self.cam_pos = torch.as_tensor(pos, dtype=torch.float32,
                                           device=self.device)
        if rot is not None:
            self.cam_rot = torch.as_tensor(rot, dtype=torch.float32,
                                           device=self.device)
        self._ifd = None
        self.reset_accumulation()

    def _draw(self, k: int):
        """k frame seeds from the session's stream (u_seed, a fresh random
        int per frame, dispatch.java:698)."""
        self._seed_draws += k
        return [int(self._rng.randint(0, 10000)) for _ in range(k)]

    def _accum(self, seeds):
        cfg = self.config
        if self._ifd is None:
            self._ifd = autofocus_distance(
                self.scene, self.info, self.cam_pos, self.cam_rot,
                cfg.focal_distance, cfg.auto_focus)
        self._sum, self._rays = render_frames_accum(
            self.scene, self.info, cfg, self.cam_pos, self.cam_rot, seeds,
            self._sum, self._rays, device=self.device, ifd=self._ifd,
            graphs=self._graphs)
        self._count += len(seeds)
        self._frame_index += len(seeds)

    def step(self, frame_seed: Optional[int] = None) -> torch.Tensor:
        """Render one frame into the accumulation, with `frame_seed` or the
        next seed of the stream (a heatmap frame with `config.debug`,
        which draws its seed all the same); returns the display image."""
        seeds = self._draw(1) if frame_seed is None else [frame_seed]
        if self.config.debug:
            self._sum = self._sum + render_debug_frame(
                self.scene, self.info, self.config, self.cam_pos,
                self.cam_rot, device=self.device)
            self._count += 1
            self._frame_index += 1
        else:
            self._accum(seeds)
        return self.display_image()

    def render(self, frames: int = 1, chunk: int = 8) -> torch.Tensor:
        """Accumulate `frames` frames, at most `chunk` a
        `render_frames_accum` call, the seeds drawn chunk by chunk (the
        same stream for any `chunk`); heatmap frames one `step` each."""
        if self.config.debug:
            for _ in range(frames):
                self.step()
            return self.display_image()
        left = frames
        while left > 0:
            k = min(chunk, left)
            self._accum(self._draw(k))
            left -= k
        return self.display_image()

    def display_image(self) -> torch.Tensor:
        return self._sum / float(max(self._count, 1))

    # -- I/O ------------------------------------------------------------------
    def screenshot(self, filename: Optional[str] = None,
                   directory: str = "screenshots") -> str:
        """PNG of the display image, flipped like the reference readback
        (dispatch.java:804-851)."""
        from ..utils import image as img_util

        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, filename or "GLSL_render.png")
        img_util.write_png(path, self.display_image().cpu().numpy())
        return path

    def auto_screenshot(self, directory: str = "screenshots") -> str:
        """autoScreenshot_<frames>_<timestamp>.png (dispatch.java:595-599)
        in `directory`."""
        stamp = datetime.datetime.now().strftime("%Y_%m_%d_%H_%M")
        return self.screenshot(f"autoScreenshot_{self._count}_{stamp}.png",
                               directory=directory)

    def pick(self, px: int, py: int) -> dict:
        """The mouse inspector (frag.glsl:888-893) as a probe record: the
        scene through pixel (px, py), (0, 0) bottom-left as in GL. Keys:
        normal (3,) float32, material, distance, obj (the root node of the
        object hit, its ordinal in a streamed scene; -1 for an analytic
        primitive or a miss), kind (0 none, 1 triangle, 2 implicit, 3
        ellipsoid), hit, loc (3,) float32, as the JAX package returns
        them. The ray is the pixel centre's undeflected primary ray,
        unnormalized, so `distance` is in units of its length."""
        cfg = self.config
        uv = torch.tensor([[(px + 0.5) / float(cfg.width),
                            (py + 0.5) / float(cfg.height)]],
                          dtype=torch.float32, device=self.device)
        d = camera.primary_directions(
            uv, vm.rotation_matrix(self.cam_rot), cfg.cam_size,
            cfg.focal_length, cfg.screen_h_ratio).unbind(-1)
        o = tuple(self.cam_pos[i].reshape(1) for i in range(3))
        hit, o_n = traverse.ray_scene(o, d, self.scene, self.info)
        surf = traverse.surface_sample(hit, o_n, d, self.scene, self.info)

        def vec(v):
            return torch.stack(v, -1)[0].cpu().numpy()

        return {"normal": vec(surf.norm), "material": int(surf.mat[0]),
                "distance": float(hit.t[0]), "obj": int(hit.obj[0]),
                "kind": int(hit.kind[0]), "hit": bool(hit.is_hit[0]),
                "loc": vec(surf.loc)}

    def display_image_with_pick(self, px: int, py: int,
                                radius: float = 0.005) -> np.ndarray:
        """The display image with the inspector overlay (frag.glsl:888-893):
        pixels whose texCoord lies within `radius` (texture-coordinate
        units, the reference's 0.5%) of the cursor show the surface normal
        under it."""
        rec = self.pick(px, py)
        cfg = self.config
        u = (np.arange(cfg.width, dtype=np.float32) + 0.5) / cfg.width
        v = (np.arange(cfg.height, dtype=np.float32) + 0.5) / cfg.height
        du = (u - (px + 0.5) / cfg.width)[None, :]
        dv = (v - (py + 0.5) / cfg.height)[:, None]
        out = self.display_image().cpu().numpy().copy()
        out[du * du + dv * dv < radius * radius] = rec["normal"]
        return out

    def telemetry(self) -> str:
        """The stdin `telemetry` command (dispatch.java:785-792), the pose
        printed as float32 values."""
        p = self.cam_pos.cpu().numpy()
        r = self.cam_rot.cpu().numpy()
        return (f"Camera Position: \n({p[0]},{p[1]},{p[2]})\n"
                f"Rotation:\n({r[0]},{r[1]},{r[2]})")

    # -- checkpoint and resume ---------------------------------------------
    def save_checkpoint(self, path: str):
        """Write the accumulation, the counters and the pose to an `.npz`
        with the JAX package's keys and dtypes; the seed stream's position
        is `seed_draws` draws past `seed`."""
        np.savez(path, sum=self._sum.cpu().numpy(), count=self._count,
                 frame_index=self._frame_index, seed_draws=self._seed_draws,
                 cam_pos=self.cam_pos.cpu().numpy(),
                 cam_rot=self.cam_rot.cpu().numpy())

    def load_checkpoint(self, path: str):
        """Resume from a checkpoint of either package: the same seed then
        continues the same stream (files without `seed_draws` fast-forward
        by `frame_index`)."""
        data = np.load(path, allow_pickle=False)
        self._sum = torch.as_tensor(np.asarray(data["sum"], np.float32),
                                    device=self.device)
        self._count = int(data["count"])
        self._frame_index = int(data["frame_index"])
        self.cam_pos = torch.as_tensor(np.asarray(data["cam_pos"]),
                                       dtype=torch.float32,
                                       device=self.device)
        self.cam_rot = torch.as_tensor(np.asarray(data["cam_rot"]),
                                       dtype=torch.float32,
                                       device=self.device)
        self._ifd = None
        self._rng = np.random.RandomState(self.seed)
        self._seed_draws = (int(data["seed_draws"]) if "seed_draws" in data
                            else self._frame_index)
        for _ in range(self._seed_draws):
            self._rng.randint(0, 10000)
