"""The port's rendering over several devices and processes
(pathtracer0_tpu_torch.dist) against its own single-device render and the
JAX package's dist/mesh.py and dist/multihost.py, on the CPU.

A mesh of the port is a list of devices; ["cpu"] * 8 stands where the
JAX tests take the 8 virtual CPU devices of tests/conftest.py. The same
scene, built through both packages' Scene API, and the same seeds go to
both.

Tolerances:
  the port tiled, sliced into row slabs or spread over processes against
  its own untiled `render_rays`: images equal to every bit (a pixel's
  stream is seeded by its global index), queries equal but for the pad
  pixels' own queries;
  RNG states of the sample split against the JAX package's: bit-exact;
  the port against the JAX package: tests/test_torch_route.py's (per-pixel
  max-abs difference < 1e-4 on >= 99% of the pixels, mean abs difference
  < 5e-3), queries equal, pad pixels included;
  DistributedRenderer against the port's Renderer (its frame path):
  elements bit-equal on > 99.5%, tests/test_dist.py's limit;
  checkpoints: loaded sums equal to every bit, and the images after one
  more step bit-equal within the port, at the route limits across the
  packages.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":          # a worker of the two-process test
    sys.path.insert(0, ROOT)

from pathtracer0_tpu_torch import RenderConfig, Renderer, Scene  # noqa: E402
from pathtracer0_tpu_torch.core import camera  # noqa: E402
from pathtracer0_tpu_torch.core import rng as trng  # noqa: E402
from pathtracer0_tpu_torch.dist import mesh as tmesh  # noqa: E402
from pathtracer0_tpu_torch.dist import multihost as tmultihost  # noqa: E402
from pathtracer0_tpu_torch.render.renderer import render_rays  # noqa: E402

torch.set_num_threads(1)

KW = dict(width=40, height=24, samples_per_frame=2, max_bounces=3,
          auto_focus=False, blur=0.0)
# 26 x 17 = 442 pixels: 6 pad pixels on 8 devices
PAD_KW = dict(KW, width=26, height=17)
SEED = 42


def _simple(sc):
    """tests/conftest.py's `simple_scene` through either package's Scene
    API: two spheres under a constant sky."""
    sc.set_constant_sky((0.6, 0.7, 0.9))
    sc.add_material("diffuse_red")
    sc.set_last_mtl("Kd", (0.8, 0.2, 0.2))
    sc.set_last_mtl("Pr", 1.0)
    sc.add_material("floorish")
    sc.set_last_mtl("Kd", (0.7, 0.7, 0.7))
    sc.set_last_mtl("Pr", 1.0)
    sc.add_sphere((0.0, 0.0, 3.0), 1.0, m=0)
    sc.add_ellipsoid((0.0, -101.0, 3.0), (1, 1, 1), (0, 0, 0), 100.0, m=1)
    return sc


def _port_scene():
    return _simple(Scene()).build(device="cpu")


def _cpus(n):
    return tmesh.make_mesh(devices=["cpu"] * n)


def _untiled(sc, info, cfg, seed=SEED, cam=(0.0, 0.0, 0.0),
             rot=(0.0, 0.0, 0.0)):
    """One `render_rays` call over the whole image: ((H, W, 3), queries)."""
    uv, index = camera.pixel_centers(cfg.width, cfg.height, "cpu")
    col, q = render_rays(sc, info, uv, index, torch.tensor(cam),
                         torch.tensor(rot), seed,
                         torch.tensor(cfg.focal_distance), config=cfg)
    return col.reshape(cfg.height, cfg.width, 3), int(q)


def _pad_queries(sc, info, cfg, n_pad, seed=SEED):
    """The queries of `n_pad` pad pixels (uv (0, 0), index 0)."""
    if n_pad == 0:
        return 0
    _, q = render_rays(sc, info, torch.zeros((n_pad, 2)),
                       torch.zeros(n_pad, dtype=torch.int64), torch.zeros(3),
                       torch.zeros(3), seed, torch.tensor(cfg.focal_distance),
                       config=cfg)
    return int(q)


def _assert_route(a, b):
    diff = np.abs(a - b).max(axis=-1)
    assert np.isfinite(b).all()
    assert (diff < 1e-4).mean() >= 0.99, (diff.max(), (diff < 1e-4).mean())
    assert np.abs(a - b).mean() < 5e-3


def test_make_mesh():
    assert _cpus(3) == [torch.device("cpu")] * 3
    assert tmesh.make_mesh(2, devices=["cpu"] * 8) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError):
        tmesh.make_mesh(devices=[])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.make_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.make_mesh(devices=["cuda"] * 2)


def test_replicate_scene_one_copy_per_device():
    sc, _ = _port_scene()
    copies = tmesh.replicate_scene(sc, _cpus(4))
    assert all(c is sc for c in copies)


@pytest.mark.parametrize("n_dev, kw", [(1, KW), (8, KW), (8, PAD_KW),
                                       (7, KW)])
def test_tiled_equals_untiled(n_dev, kw):
    """Every mesh size gives the pixels of one untiled call, to every bit;
    the queries add the pad pixels' own."""
    sc, info = _port_scene()
    cfg = RenderConfig(**kw)
    img, q = tmesh.render_frame_tiled(sc, info, cfg, (0, 0, 0), (0, 0, 0),
                                      SEED, _cpus(n_dev), device="cpu")
    ref, q_ref = _untiled(sc, info, cfg)
    assert img.shape == (cfg.height, cfg.width, 3) and q.shape == (1,)
    assert img.device == q.device == torch.device("cpu")
    assert torch.equal(img, ref)
    n = cfg.width * cfg.height
    n_pad = -n % n_dev
    assert int(q) == q_ref + _pad_queries(sc, info, cfg, n_pad)


def test_tiled_matches_jax(eight_devices):
    """The port's tiles on ["cpu"] * 8 against the JAX package's
    render_frame_tiled on 8 devices, 6 of its pixels pad: images at the
    route limits, queries equal, pad included."""
    import jax.numpy as jnp
    from pathtracer0_tpu import Scene as JScene
    from pathtracer0_tpu.dist import mesh as jmesh

    cfg = RenderConfig(**PAD_KW)
    dev, info = _simple(JScene()).build()
    img_j, q_j = jmesh.render_frame_tiled(
        dev, jnp.zeros(3, jnp.float32), jnp.zeros(3, jnp.float32), SEED,
        jmesh.make_mesh(8), **_jax_kwargs(PAD_KW, info))
    sc, pinfo = _port_scene()
    img_t, q_t = tmesh.render_frame_tiled(sc, pinfo, cfg, (0, 0, 0),
                                          (0, 0, 0), SEED, _cpus(8))
    _assert_route(np.asarray(img_j), img_t.numpy())
    assert int(q_t) == int(q_j)


def _jax_config(**kw):
    """The JAX package's config of the port's `RenderConfig(**kw)`: its
    block path in interpret mode (fused="interpret"), the counterpart of
    the port's block path on the CPU (tests/test_torch_route.py)."""
    from pathtracer0_tpu import RenderConfig as JConfig

    return JConfig(fused="interpret", **kw)


def _jax_kwargs(kw, info):
    from pathtracer0_tpu.render.renderer import _frame_params

    cfg = _jax_config(**kw)
    return dict(info=info, params=_frame_params(cfg), width=cfg.width,
                height=cfg.height, spp=cfg.samples_per_frame,
                raytracing=cfg.raytracing, auto_focus=cfg.auto_focus,
                cam_size=cfg.cam_size, focal_length=cfg.focal_length,
                blur=cfg.blur, focal_distance=cfg.focal_distance)


@pytest.fixture(scope="module")
def eight_devices():
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax.devices()[:8]


@pytest.mark.parametrize("rows", [(8, 16), (0, 1), (23, 24)])
def test_row_range_slab(rows):
    """A slab through row_range equals those rows of the full image."""
    sc, info = _port_scene()
    cfg = RenderConfig(**KW)
    full, _ = tmesh.render_frame_tiled(sc, info, cfg, (0, 0, 0), (0, 0, 0),
                                       SEED, _cpus(8))
    slab, _ = tmesh.render_frame_tiled(sc, info, cfg, (0, 0, 0), (0, 0, 0),
                                       SEED, _cpus(3), row_range=rows)
    assert slab.shape == (rows[1] - rows[0], cfg.width, 3)
    assert torch.equal(slab, full[rows[0]:rows[1]])
    with pytest.raises(ValueError, match="row_range"):
        tmesh.render_frame_tiled(sc, info, cfg, (0, 0, 0), (0, 0, 0), SEED,
                                 _cpus(3), row_range=(5, 25))


@pytest.mark.parametrize("frame_seed", [7, 9999, 4000000000])
def test_sample_split_seeds_match_jax(frame_seed):
    """Device k's RNG states, k = 0..7, against the JAX package's
    frame_seed + k * uint32(2654435761) seeding, past 2^31 too."""
    import jax.numpy as jnp
    from pathtracer0_tpu.core import rng as jrng

    index = np.arange(0, 4096 * 977, 977, dtype=np.int64)
    for k in range(8):
        seed_j = jnp.uint32(frame_seed) + jnp.uint32(k) * jnp.uint32(
            2654435761)
        state_j = np.asarray(jrng.seed(jnp.asarray(index, jnp.uint32),
                                       seed_j)).astype(np.int64)
        s = tmesh.split_seed(frame_seed, k)
        assert s == int(seed_j)
        state_t = trng.seed(torch.as_tensor(index), s).numpy()
        np.testing.assert_array_equal(state_t, state_j)


def test_sample_split_is_the_mean_of_its_seeds():
    """Two devices: the mean of two untiled calls with seeds s and
    s + 2654435761 (mod 2^32), to every bit; queries summed."""
    sc, info = _port_scene()
    cfg = RenderConfig(**KW)
    img, q = tmesh.render_frame_sample_split(sc, info, cfg, (0, 0, 0),
                                             (0, 0, 0), SEED, _cpus(2))
    a, qa = _untiled(sc, info, cfg, seed=SEED)
    b, qb = _untiled(sc, info, cfg, seed=(SEED + 2654435761) % 2 ** 32)
    assert torch.equal(img, (a + b) / 2.0)
    assert int(q) == qa + qb


def test_sample_split_matches_jax(eight_devices):
    """The JAX package's sample split on 8 devices against the port's on
    ["cpu"] * 8: route limits, queries equal."""
    import jax.numpy as jnp
    from pathtracer0_tpu import Scene as JScene
    from pathtracer0_tpu.dist import mesh as jmesh

    kw = dict(KW, width=24, height=16, samples_per_frame=1)
    cfg = RenderConfig(**kw)
    dev, info = _simple(JScene()).build()
    img_j, q_j = jmesh.render_frame_sample_split(
        dev, jnp.zeros(3, jnp.float32), jnp.zeros(3, jnp.float32), 7,
        jmesh.make_mesh(8), **_jax_kwargs(kw, info))
    sc, pinfo = _port_scene()
    img_t, q_t = tmesh.render_frame_sample_split(
        sc, pinfo, cfg, (0, 0, 0), (0, 0, 0), 7, _cpus(8))
    _assert_route(np.asarray(img_j), img_t.numpy())
    assert int(q_t) == int(q_j)


def _grid_obj(path):
    """tests/test_dist.py TestStreamedSharded's 12 x 12 height-field OBJ."""
    nx = nz = 12
    xs = np.linspace(0.0, 8.0, nx + 1)
    with open(path, "w") as f:
        for z in xs:
            for x in xs:
                f.write(f"v {x} {np.sin(x) * np.cos(z):.4f} {z}\n")
        for iz in range(nz):
            for ix in range(nx):
                a = iz * (nx + 1) + ix + 1
                b, c, d4 = a + 1, a + nx + 1, a + nx + 2
                f.write(f"f {a} {b} {c}\nf {b} {d4} {c}\n")


def _grid_scene(sc, path):
    sc.set_constant_sky((0.5, 0.6, 0.9))
    sc.add_material("m")
    sc.set_last_mtl("Kd", (0.7, 0.6, 0.5))
    sc.add_object(path, material=0)
    return sc


def test_streamed_grid_tiled(tmp_path):
    """TestStreamedSharded's scene, loaded through add_object and built
    streamed: 8 tiles against one call to every bit and against the JAX
    package's own OBJ load of the same file (the triangles it packs)."""
    from pathtracer0_tpu import RenderConfig as JConfig
    from pathtracer0_tpu import Scene as JScene

    path = str(tmp_path / "grid.obj")
    _grid_obj(path)
    cfg = RenderConfig(width=32, height=16, samples_per_frame=1,
                       max_bounces=2, auto_focus=False, blur=0.0,
                       stream_threshold=0)
    sc, info = _grid_scene(Scene(), path).build(cfg, device="cpu")
    assert info.streamed and info.num_tris == 288
    jdev, jinfo = _grid_scene(JScene(), path).build(
        JConfig(stream_threshold=0))
    assert jinfo.streamed and jinfo.st_n_treelets == info.st_n_treelets
    np.testing.assert_array_equal(sc.tris[:, 0:3].numpy(),
                                  np.asarray(jdev.tri_v1))
    cam, rot = (4.0, 3.0, -4.0), (0.35, 0.0, 0.0)
    img, q = tmesh.render_frame_tiled(sc, info, cfg, cam, rot, 13, _cpus(8))
    ref, q_ref = _untiled(sc, info, cfg, seed=13, cam=cam, rot=rot)
    assert torch.equal(img, ref) and int(q) == q_ref
    assert (img[..., 2] - img[..., 0]).abs().max() > 1e-3   # grid visible


RKW = dict(KW, samples_per_frame=1, max_bounces=2)


def _renderer(n_dev=8):
    sc, info = _port_scene()
    return tmesh.DistributedRenderer(sc, info, RenderConfig(**RKW),
                                     _cpus(n_dev))


def test_distributed_renderer_matches_renderer():
    """tests/test_dist.py's check: the mesh's accumulation against the
    single-device Renderer (its frame path), the same explicit seeds."""
    dr = _renderer()
    r = Renderer(*_port_scene(), dr.config, device="cpu")
    for seed in (3, 4):
        dr.step(frame_seed=seed)
        r.step(frame_seed=seed)
    a, b = dr.display_image().numpy(), r.display_image().numpy()
    assert a.shape == (24, 40, 3)
    assert (a == b).mean() > 0.995
    assert abs(dr.rays_traced - r.rays_traced) <= 0.01 * r.rays_traced


def test_distributed_checkpoint_round_trip(tmp_path):
    dr = _renderer()
    dr.step(frame_seed=5)
    dr.step()
    path = str(tmp_path / "ck.npz")
    dr.save_checkpoint(path)
    data = np.load(path)
    assert data["sum"].shape == (960, 3) and int(data["seed_draws"]) == 1
    dr2 = _renderer()
    dr2.load_checkpoint(path)
    assert torch.equal(dr2.display_image(), dr.display_image())
    assert (dr2._count, dr2._frame_index, dr2._seed_draws) == (2, 2, 1)
    # a mesh of the same padded length loads it too
    dr4 = _renderer(4)
    dr4.load_checkpoint(path)
    # the stream continues where it stopped
    img = dr.step()
    assert torch.equal(dr2.step(), img) and torch.equal(dr4.step(), img)


def test_resume_on_another_padded_length_raises(tmp_path):
    """960 pixels pad to 960 on 8 devices and to 966 on 7: the JAX package
    refuses that checkpoint on 7 devices, and so does the port."""
    from pathtracer0_tpu import Scene as JScene
    from pathtracer0_tpu.dist import mesh as jmesh

    dr = _renderer()
    dr.step(frame_seed=1)
    path = str(tmp_path / "ck8.npz")
    dr.save_checkpoint(path)
    with pytest.raises(ValueError, match="padded"):
        _renderer(7).load_checkpoint(path)
    dev, info = _simple(JScene()).build()
    jdr = jmesh.DistributedRenderer(dev, info, _jax_config(**RKW),
                                    jmesh.make_mesh(7))
    with pytest.raises(ValueError, match="divisible"):
        jdr.load_checkpoint(path)


def test_checkpoints_across_the_packages(tmp_path, eight_devices):
    """A checkpoint of either package's DistributedRenderer on 8 devices
    loads in the other's: the same sum and counters, the same seed
    stream, and one more frame at the route limits."""
    from pathtracer0_tpu import Scene as JScene
    from pathtracer0_tpu.dist import mesh as jmesh

    dev, info = _simple(JScene()).build()
    jcfg = _jax_config(**RKW)

    def jax_renderer():
        return jmesh.DistributedRenderer(dev, info, jcfg, jmesh.make_mesh(8))

    # mixed explicit and drawn seeds: 2 draws in 3 frames
    jdr, dr = jax_renderer(), _renderer()
    for seed in (None, 5, None):
        jdr.step(frame_seed=seed)
        dr.step(frame_seed=seed)
    assert jdr._seed_draws == dr._seed_draws == 2
    _assert_route(np.asarray(jdr.display_image()), dr.display_image().numpy())
    j_path, t_path = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jdr.save_checkpoint(j_path)
    dr.save_checkpoint(t_path)
    a, b = np.load(j_path), np.load(t_path)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k

    port_from_jax = _renderer()
    port_from_jax.load_checkpoint(j_path)
    np.testing.assert_array_equal(port_from_jax.display_image().numpy(),
                                  np.asarray(jdr.display_image()))
    jax_from_port = jax_renderer()
    jax_from_port.load_checkpoint(t_path)
    np.testing.assert_array_equal(np.asarray(jax_from_port.display_image()),
                                  dr.display_image().numpy())
    for r in (port_from_jax, jax_from_port):
        assert (r._count, r._frame_index, r._seed_draws) == (3, 3, 2)
    # the next drawn seed is the same on all four
    draws = {int(r._rng.randint(0, 10000))
             for r in (jdr, dr, port_from_jax, jax_from_port)}
    assert len(draws) == 1
    jax_from_port.step(frame_seed=11)
    port_from_jax.step(frame_seed=11)
    _assert_route(np.asarray(jax_from_port.display_image()),
                  port_from_jax.display_image().numpy())


def test_move_camera_resets():
    dr = _renderer()
    dr.step(frame_seed=1)
    before = dr.rays_traced
    dr.move_camera(pos=(0.0, 0.2, 0.0))
    assert dr._count == 0 and dr._frame_index == 1
    assert float(dr.display_image().abs().max()) == 0.0
    dr.step(frame_seed=2)
    assert dr._count == 1 and dr.rays_traced > before
    assert torch.equal(dr.cam_pos, torch.tensor([0.0, 0.2, 0.0]))


def test_multihost_single_process(monkeypatch):
    """One process: initialize is a no-op, every row is local, the slab is
    the image and assemble_image hands it back."""
    for var in ("PT0_COORDINATOR", "PT0_NUM_PROCESSES", "PT0_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert tmultihost.initialize() is False
    assert tmultihost.initialize("localhost:1", num_processes=1) is False
    assert tmultihost.process_info() == (0, 1)
    assert tmultihost.local_rows(48) == (0, 48)
    slab = np.arange(24 * 4 * 3, dtype=np.float32).reshape(24, 4, 3)
    np.testing.assert_array_equal(tmultihost.assemble_image(slab, 24), slab)
    sc, info = _port_scene()
    cfg = RenderConfig(**KW)
    img, _ = tmultihost.render_local_slab(
        sc, info, cfg, (0, 0, 0), (0, 0, 0), SEED,
        tmultihost.local_mesh(["cpu"] * 2))
    assert torch.equal(img, _untiled(sc, info, cfg)[0])


@pytest.mark.parametrize("n", [2, 3, 4, 7])
@pytest.mark.parametrize("height", [24, 37, 1080])
def test_local_rows_split(monkeypatch, n, height):
    """The near-equal split with the remainder to the low ranks, the JAX
    package's, for every rank."""
    from pathtracer0_tpu.dist import multihost as jmultihost

    slabs = []
    for pid in range(n):
        monkeypatch.setattr(tmultihost, "process_info", lambda: (pid, n))
        monkeypatch.setattr(jmultihost, "process_info", lambda: (pid, n))
        slabs.append(tmultihost.local_rows(height))
        assert slabs[-1] == jmultihost.local_rows(height)
    assert slabs[0][0] == 0 and slabs[-1][1] == height
    assert all(a[1] == b[0] for a, b in zip(slabs, slabs[1:]))


W2, H2, SEED2 = 48, 37, 321   # 37 rows: slabs of 19 and 18


def _worker(addr, n_procs, pid, out):
    """One rank of the two-process test: its slab over a 2-tile CPU mesh,
    then the image assembled over gloo; rank 0 saves it."""
    assert tmultihost.initialize(addr, n_procs, pid, backend="gloo")
    assert tmultihost.process_info() == (pid, n_procs)
    sc, info = _port_scene()
    cfg = RenderConfig(**dict(KW, width=W2, height=H2))
    slab, _ = tmultihost.render_local_slab(
        sc, info, cfg, (0, 0, 0), (0, 0, 0), SEED2,
        tmultihost.local_mesh(["cpu"] * 2))
    start, stop = tmultihost.local_rows(H2)
    assert slab.shape == (stop - start, W2, 3)
    full = tmultihost.assemble_image(slab, H2)
    assert full.shape == (H2, W2, 3)
    if pid == 0:
        np.save(out, full)
    torch.distributed.destroy_process_group()


def test_two_processes_over_gloo(tmp_path):
    """Two real processes joined by torch.distributed (gloo, a local TCP
    port): the assembled image equals the single-process render."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = str(tmp_path / "assembled.npy")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker",
         f"127.0.0.1:{port}", "2", str(pid), out],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o.decode(errors="replace")[-3000:]
    sc, info = _port_scene()
    ref, _ = _untiled(sc, info, RenderConfig(**dict(KW, width=W2,
                                                    height=H2)), seed=SEED2)
    np.testing.assert_array_equal(np.load(out), ref.numpy())


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
