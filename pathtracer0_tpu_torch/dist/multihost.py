"""Rendering over several processes with `torch.distributed`.

The same scaling model as the JAX package's dist/multihost.py:

  * `initialize()` sets up one process group per run (coordinator address,
    process count and rank from the arguments or the PT0_* environment
    variables) and is a no-op in a single-process run, so everything
    downstream works unchanged;
  * every process holds the whole scene and owns a contiguous row slab of
    the image (`local_rows`), which it renders over its own devices with
    dist/mesh.render_frame_tiled (`render_local_slab`): nothing crosses
    between processes while they render;
  * the image is assembled by ONE all-gather of the finished slabs
    (`assemble_image`), the analogue of the reference's single
    glReadPixels (dispatch.java:813).

A run of several processes, one a host:

    PT0_COORDINATOR=host0:1234 PT0_NUM_PROCESSES=4 PT0_PROCESS_ID=k \\
        python my_render.py

The backend is an argument: "nccl" by default in a process that sees a
card, "gloo" in one that does not. NCCL takes one card a rank, so two
ranks sharing one card pass backend="gloo".
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import make_mesh, render_frame_tiled


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> bool:
    """Join the process group when several processes are configured; a
    no-op otherwise.

    The arguments come first, then PT0_COORDINATOR (host:port),
    PT0_NUM_PROCESSES and PT0_PROCESS_ID. Returns True iff a process group
    of more than one process was set up."""
    coordinator_address = coordinator_address or os.environ.get(
        "PT0_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("PT0_NUM_PROCESSES", "0")) or None
    if process_id is None:
        pid = os.environ.get("PT0_PROCESS_ID")
        process_id = int(pid) if pid is not None else None
    if not coordinator_address or not num_processes or num_processes <= 1:
        return False
    if process_id is None:
        raise ValueError("several processes need each its process_id "
                         "(PT0_PROCESS_ID)")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def process_info() -> tuple:
    """(rank, world size); (0, 1) when there is no process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _slab(pid: int, n: int, height: int) -> tuple:
    base, rem = divmod(height, n)
    start = pid * base + min(pid, rem)
    return start, start + base + (1 if pid < rem else 0)


def local_rows(height: int) -> tuple:
    """This process's contiguous image rows [start, stop): a near-equal
    split of `height` over the processes, the remainder to the low
    ranks."""
    return _slab(*process_info(), height)


def local_mesh(devices=None):
    """The mesh of this process's devices: every card it sees, or the
    `devices` given (e.g. ["cpu"] * 4); dist/mesh.make_mesh."""
    return make_mesh(devices=devices)


def render_local_slab(scene, info, config, cam_pos, cam_rot, frame_seed: int,
                      mesh, *, device=None):
    """This process's row slab of the full image over its mesh: ((rows, W,
    3) slab, queries (1,) int64). The camera is the whole image's and each
    pixel's stream is seeded by its global index, so the assembled image
    equals a single-process render."""
    return render_frame_tiled(scene, info, config, cam_pos, cam_rot,
                              frame_seed, mesh,
                              row_range=local_rows(config.height),
                              device=device)


def assemble_image(local_slab, height: int) -> np.ndarray:
    """All-gather every process's row slab into the full (H, W, 3) image,
    a numpy array. Slabs may differ by one row: each is padded to the
    largest for the all-gather and trimmed after. Gloo gathers CPU
    tensors, NCCL tensors on this process's card."""
    pid, n = process_info()
    slab = torch.as_tensor(local_slab)
    if n == 1:
        return slab.cpu().numpy()
    max_rows = _slab(0, n, height)[1]
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    padded = torch.zeros((max_rows,) + tuple(slab.shape[1:]),
                         dtype=slab.dtype, device=dev)
    padded[:slab.shape[0]] = slab.to(dev)
    gathered = [torch.empty_like(padded) for _ in range(n)]
    dist.all_gather(gathered, padded)
    rows = []
    for p, g in enumerate(gathered):
        start, stop = _slab(p, n, height)
        rows.append(g[:stop - start])
    return torch.cat(rows).cpu().numpy()
