"""Rendering over several devices from one process.

The JAX package shards the flat pixel axis over a 1-D `jax.sharding.Mesh`
with `shard_map` and replicates the scene on every device. Here a mesh
is an explicit list of `torch.device`s (`make_mesh`); a list may name
one device several times, which is how one card runs a mesh of k tiles.
The scene's tensors are copied once to each distinct device
(`replicate_scene`), and one host process launches every tile: kernel
launches are asynchronous, so tiles on different cards overlap without
threads. Each tile's work runs with its card made the current CUDA
device, because the kernels launch on the current device.

  * `render_frame_tiled`: pixel tiles, one `render_rays` call per device,
    no communication until the image is assembled on one device;
  * `render_frame_sample_split`: every device renders the full image
    with its own seed and the images are averaged;
  * `DistributedRenderer`: progressive accumulation with the running sum
    kept as one slice per tile on its device; checkpoints hold the
    gathered, padded sum under the JAX package's `.npz` keys, so a
    checkpoint loads across the packages at the same mesh size.

Like the JAX package's, these functions render through `render_rays`
(the per-bounce route, or the block kernel where the scene is small),
never through the whole-frame kernel. A pixel's RNG stream is seeded by
its global index, so the tiles of any mesh give the pixels of one
untiled `render_rays` call.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..config import RenderConfig
from ..core import camera
from ..core import rng as vrng
from ..core.device import resolve_device
from ..render.renderer import _check, autofocus_distance, render_rays

# device k of a sample split renders with seed frame_seed + k * SPLIT_STRIDE
# (mod 2^32): a large odd stride, so the devices' pixel streams never meet
SPLIT_STRIDE = 2654435761


def make_mesh(n_devices: Optional[int] = None, devices=None) -> List[
        torch.device]:
    """The mesh: `devices` (e.g. ["cpu"] * 8, or ["cuda:0"] * 4 for four
    tiles on one card), or else every card this process sees, the first
    `n_devices` of either. Without a card a CUDA device raises."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices=['cpu'] * n to "
                "run the plain PyTorch path on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    mesh = [resolve_device(d) for d in devices]
    if n_devices is not None:
        mesh = mesh[:n_devices]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def device_guard(dev: torch.device):
    """Make `dev` the current CUDA device for the launches inside."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def replicate_scene(scene, mesh) -> list:
    """The scene on each device of the mesh, one copy per distinct device
    (a device named twice shares its copy; the scene's own device uses
    the scene itself)."""
    copies = {scene.device: scene}
    for dev in mesh:
        if dev not in copies:
            with device_guard(dev):
                copies[dev] = dataclasses.replace(scene, **{
                    f.name: getattr(scene, f.name).to(dev)
                    for f in dataclasses.fields(scene)})
    return [copies[dev] for dev in mesh]


def _pad_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _tiles(config: RenderConfig, mesh, row_range=None):
    """The pixels (uv, index) of the image, or of rows [start, stop), padded
    to a multiple of the mesh size (pad uv (0, 0), index 0) and split into
    one equal tile per device, each on its device; and the pixel count
    before the padding."""
    w, h = config.width, config.height
    uv, index = camera.pixel_centers(w, h, mesh[0])
    if row_range is not None:
        start, stop = row_range
        if not 0 <= start < stop <= h:
            raise ValueError(f"row_range {row_range} outside 0..{h}")
        uv, index = uv[start * w:stop * w], index[start * w:stop * w]
    n = index.shape[0]
    pad = _pad_to(n, len(mesh)) - n
    uv = torch.cat([uv, uv.new_zeros((pad, 2))])
    index = torch.cat([index, index.new_zeros(pad)])
    tiles = zip(uv.chunk(len(mesh)), index.chunk(len(mesh)))
    return [(u.to(dev), i.to(dev)) for (u, i), dev in zip(tiles, mesh)], n


def _frame_inputs(scenes, info, config, cam_pos, cam_rot):
    """Per device of the mesh: (camera position, rotation, internal focal
    distance). Autofocus probes once, on the first device, as the JAX
    package probes once for the whole mesh."""
    first = scenes[0].device
    cam_pos = torch.as_tensor(cam_pos, dtype=torch.float32, device=first)
    cam_rot = torch.as_tensor(cam_rot, dtype=torch.float32, device=first)
    with device_guard(first):
        ifd = autofocus_distance(scenes[0], info, cam_pos, cam_rot,
                                 config.focal_distance, config.auto_focus)
    return [(cam_pos.to(s.device), cam_rot.to(s.device), ifd.to(s.device))
            for s in scenes]


def _render_tiles(scenes, info, config, tiles, inputs, frame_seed):
    """One `render_rays` call per tile on its device, the image's aspect
    ratio the whole image's: [(colour (n_tile, 3), queries (1,))]."""
    out = []
    for scene, (uv, index), (pos, rot, ifd) in zip(scenes, tiles, inputs):
        with device_guard(scene.device):
            out.append(render_rays(scene, info, uv, index, pos, rot,
                                   frame_seed, ifd, config=config,
                                   screen_h_ratio=config.screen_h_ratio))
    return out


def _out_device(mesh, device):
    return mesh[0] if device is None else resolve_device(device)


def render_frame_tiled(scene, info, config: RenderConfig, cam_pos, cam_rot,
                       frame_seed: int, mesh, *, row_range=None,
                       device=None):
    """One frame with the pixels tiled over the mesh: ((H, W, 3) image,
    queries (1,) int64) on `device` (default: the mesh's first device).

    The queries are summed over all tiles, the pad pixels' included, as
    the JAX package counts them. row_range=(start, stop) traces only those
    rows, with the camera of the whole image and each pixel's stream
    seeded by its global index (the multi-process slabs of
    dist/multihost.py); the image is then (stop - start, W, 3)."""
    _check(config, mesh[0])
    scenes = replicate_scene(scene, mesh)
    tiles, n = _tiles(config, mesh, row_range)
    inputs = _frame_inputs(scenes, info, config, cam_pos, cam_rot)
    out = _render_tiles(scenes, info, config, tiles, inputs, frame_seed)
    dev = _out_device(mesh, device)
    col = torch.cat([c.to(dev) for c, _ in out])[:n]
    queries = sum(q.to(dev) for _, q in out)
    return col.reshape(n // config.width, config.width, 3), queries


def split_seed(frame_seed: int, k: int) -> int:
    """Device k's seed of a sample split, wrapping as uint32."""
    return (int(frame_seed) + k * SPLIT_STRIDE) & vrng.MASK


def render_frame_sample_split(scene, info, config: RenderConfig, cam_pos,
                              cam_rot, frame_seed: int, mesh, *,
                              device=None):
    """One frame in which device k renders the FULL image with seed
    `split_seed(frame_seed, k)`; the images are averaged over the mesh
    (spp x mesh size samples a pixel) and the queries summed. Returns
    ((H, W, 3) image, queries (1,) int64) on `device` (default: the mesh's
    first device)."""
    _check(config, mesh[0])
    scenes = replicate_scene(scene, mesh)
    inputs = _frame_inputs(scenes, info, config, cam_pos, cam_rot)
    out = []
    for k, (sc, (pos, rot, ifd)) in enumerate(zip(scenes, inputs)):
        with device_guard(sc.device):
            uv, index = camera.pixel_centers(config.width, config.height,
                                             sc.device)
            out.append(render_rays(sc, info, uv, index, pos, rot,
                                   split_seed(frame_seed, k), ifd,
                                   config=config))
    dev = _out_device(mesh, device)
    col = sum(c.to(dev) for c, _ in out) / float(len(mesh))
    queries = sum(q.to(dev) for _, q in out)
    return col.reshape(config.height, config.width, 3), queries


class DistributedRenderer:
    """Progressive accumulation over a mesh: the `Renderer`'s frame loop
    with the pixels tiled over the devices.

    The running sum is kept padded, (n_pad, 3) with n_pad the pixel count
    rounded up to a multiple of the mesh size, as one slice per tile on
    its device: folding a frame in is a local add on each device, and the
    pixels are gathered only when the display image or a checkpoint is
    read."""

    def __init__(self, scene, info, config: RenderConfig, mesh,
                 cam_pos=None, cam_rot=None, seed: int = 0):
        _check(config, mesh[0])
        self.info, self.config, self.mesh = info, config, list(mesh)
        self.seed = seed
        self.scenes = replicate_scene(scene, self.mesh)
        self.cam_pos = torch.as_tensor(
            np.zeros(3) if cam_pos is None else cam_pos, dtype=torch.float32,
            device=self.mesh[0])
        self.cam_rot = torch.as_tensor(
            np.zeros(3) if cam_rot is None else cam_rot, dtype=torch.float32,
            device=self.mesh[0])
        self._rng = np.random.RandomState(seed)
        # seeds drawn from self._rng, not _frame_index where callers pass
        # explicit seeds: a resumed session fast-forwards by this count
        self._seed_draws = 0
        self._tiles, self._n = _tiles(config, self.mesh)
        self._sum = [torch.zeros((uv.shape[0], 3), dtype=torch.float32,
                                 device=uv.device) for uv, _ in self._tiles]
        self._count = 0
        self._frame_index = 0
        # queries accumulate on each device: reading them syncs
        self._rays = [torch.zeros(1, dtype=torch.int64, device=dev)
                      for dev in self.mesh]
        self._inputs = None   # camera and focal distance of the pose

    @property
    def rays_traced(self) -> int:
        """Scene queries so far, over all tiles (reading it waits for the
        devices)."""
        return sum(int(r.item()) for r in self._rays)

    # -- state -------------------------------------------------------------
    def reset_accumulation(self):
        self._sum = [torch.zeros_like(s) for s in self._sum]
        self._count = 0

    def move_camera(self, pos=None, rot=None):
        """Camera motion resets the accumulation (dispatch.java:646-667)."""
        if pos is not None:
            self.cam_pos = torch.as_tensor(pos, dtype=torch.float32,
                                           device=self.mesh[0])
        if rot is not None:
            self.cam_rot = torch.as_tensor(rot, dtype=torch.float32,
                                           device=self.mesh[0])
        self._inputs = None
        self.reset_accumulation()

    # -- rendering -----------------------------------------------------------
    def step(self, frame_seed: Optional[int] = None) -> torch.Tensor:
        """Render one frame into the accumulation, with `frame_seed` or the
        next seed of the stream; returns the display image."""
        if frame_seed is None:
            frame_seed = int(self._rng.randint(0, 10000))
            self._seed_draws += 1
        if self._inputs is None:
            self._inputs = _frame_inputs(self.scenes, self.info, self.config,
                                         self.cam_pos, self.cam_rot)
        out = _render_tiles(self.scenes, self.info, self.config, self._tiles,
                            self._inputs, frame_seed)
        self._sum = [s + c for s, (c, _) in zip(self._sum, out)]
        self._rays = [r + q for r, (_, q) in zip(self._rays, out)]
        self._count += 1
        self._frame_index += 1
        return self.display_image()

    def _gathered_sum(self) -> torch.Tensor:
        return torch.cat([s.to(self.mesh[0]) for s in self._sum])

    def display_image(self) -> torch.Tensor:
        """The mean of the frames so far, (H, W, 3) on the mesh's first
        device."""
        cfg = self.config
        img = self._gathered_sum()[:self._n] / float(max(self._count, 1))
        return img.reshape(cfg.height, cfg.width, 3)

    # -- checkpoint and resume ---------------------------------------------
    def save_checkpoint(self, path: str):
        """Write the padded sum (n_pad, 3), the counters and the pose to an
        `.npz` with the JAX package's keys and dtypes."""
        np.savez(path, sum=self._gathered_sum().cpu().numpy(),
                 count=self._count, frame_index=self._frame_index,
                 seed_draws=self._seed_draws,
                 cam_pos=self.cam_pos.cpu().numpy(),
                 cam_rot=self.cam_rot.cpu().numpy())

    def load_checkpoint(self, path: str):
        """Resume from a checkpoint of either package's distributed
        renderer at the same padded length; the same seed then continues
        the same stream. A sum of another length (a mesh size that pads
        the pixels otherwise) raises, as it does in the JAX package."""
        data = np.load(path, allow_pickle=False)
        total = np.asarray(data["sum"], np.float32)
        sizes = [s.shape[0] for s in self._sum]
        if total.shape != (sum(sizes), 3):
            raise ValueError(
                f"checkpoint sum {total.shape} does not fit this mesh's "
                f"padded pixels ({sum(sizes)}, 3): it was saved on a mesh "
                "that pads the image to another length")
        parts = torch.as_tensor(total).split(sizes)
        self._sum = [p.to(s.device) for p, s in zip(parts, self._sum)]
        self._count = int(data["count"])
        self._frame_index = int(data["frame_index"])
        self.cam_pos = torch.as_tensor(np.asarray(data["cam_pos"]),
                                       dtype=torch.float32,
                                       device=self.mesh[0])
        self.cam_rot = torch.as_tensor(np.asarray(data["cam_rot"]),
                                       dtype=torch.float32,
                                       device=self.mesh[0])
        self._inputs = None
        self._rng = np.random.RandomState(self.seed)
        self._seed_draws = (int(data["seed_draws"]) if "seed_draws" in data
                            else self._frame_index)
        for _ in range(self._seed_draws):
            self._rng.randint(0, 10000)
