"""The port's renderer (pathtracer0_tpu_torch.render.renderer) end to end
on the CPU: the BASELINE goldens, determinism, progressive accumulation,
screenshots, the device rule, and the import boundary.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pathtracer0_tpu_torch import RenderConfig, Renderer, render_frame
from pathtracer0_tpu_torch import scenes
from pathtracer0_tpu_torch.scene import packing
from pathtracer0_tpu_torch.utils import image as img_util

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "goldens")
RMSE_BUDGET = 0.05  # tests/test_goldens.py


def _scene(n):
    return scenes.BUILDERS[n]().build(device="cpu")


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6])
def test_golden(n):
    """160x120x4 at seed 1234, blur 0, no autofocus (bench.py GOLDEN_*)."""
    sc, info = _scene(n)
    cam, rot = scenes.CAMERAS[n]
    cfg = RenderConfig(width=160, height=120, samples_per_frame=4,
                       max_bounces=6, raytracing=n != 1, auto_focus=False,
                       blur=0.0)
    img, rays = render_frame(sc, info, cfg, cam, rot, 1234, device="cpu")
    assert img.shape == (120, 160, 3)
    golden = img_util.read_png(os.path.join(GOLDEN_DIR, f"config{n}.png"))
    err = img_util.rmse(np.clip(img.numpy(), 0.0, 1.0), golden)
    assert err < RMSE_BUDGET, f"config{n} RMSE {err:.5f}"
    assert int(rays) >= 160 * 120 * 4


def _small(n=2, **kw):
    cfg = dict(width=24, height=16, samples_per_frame=2, max_bounces=3)
    cfg.update(kw)
    return RenderConfig(**cfg)


def test_same_seed_is_deterministic():
    sc, info = _scene(4)
    cam, rot = scenes.CAMERAS[4]
    a, ra = render_frame(sc, info, _small(), cam, rot, 42, device="cpu")
    b, rb = render_frame(sc, info, _small(), cam, rot, 42, device="cpu")
    c, _ = render_frame(sc, info, _small(), cam, rot, 43, device="cpu")
    assert torch.equal(a, b) and torch.equal(ra, rb)
    assert not torch.equal(a, c)


def test_accumulation_reset_and_screenshot(tmp_path):
    sc, info = _scene(2)
    cam, rot = scenes.CAMERAS[2]
    cfg = _small()
    r = Renderer(sc, info, cfg, cam_pos=cam, cam_rot=rot, seed=7,
                 device="cpu")
    f1 = r.step(frame_seed=11).clone()
    img2 = r.step(frame_seed=12)
    one, _ = render_frame(sc, info, cfg, cam, rot, 11, device="cpu")
    two, _ = render_frame(sc, info, cfg, cam, rot, 12, device="cpu")
    torch.testing.assert_close(f1, one, rtol=0, atol=0)
    torch.testing.assert_close(img2, (one + two) / 2.0, rtol=0, atol=1e-6)
    assert r._count == 2
    q = r.rays_traced
    assert q > 0
    r.render(2)
    assert r._count == 4 and r.rays_traced > q
    r.move_camera(pos=(0.0, 0.7, 0.0))
    assert r._count == 0
    assert float(r.display_image().abs().sum()) == 0.0
    path = r.screenshot("shot.png", directory=str(tmp_path))
    assert img_util.read_png(path).shape == (16, 24, 3)


def test_autofocus_probe():
    """Autofocus takes the centre ray's hit distance (config 4: the red
    clearcoat sphere) and keeps the configured distance on a miss
    (config 2: the centre ray passes between the spheres)."""
    from pathtracer0_tpu_torch.render.renderer import autofocus_distance

    def probe(n, on):
        sc, info = _scene(n)
        cam, rot = (torch.tensor(v, dtype=torch.float32)
                    for v in scenes.CAMERAS[n])
        return float(autofocus_distance(sc, info, cam, rot, 1.0, on))

    assert probe(4, False) == 1.0
    assert 3.0 < probe(4, True) < 3.5
    assert probe(2, True) == 1.0


def test_no_device_means_the_card():
    """Without a device the entry points ask for the card and raise when
    there is none; they never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        scenes.BUILDERS[2]().build()
    sc, info = _scene(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        Renderer(sc, info, _small())
    with pytest.raises(RuntimeError, match="CUDA"):
        render_frame(sc, info, _small(), (0, 0, 0), (0, 0, 0), 1)
    # the JAX package's scene carried across: the device is resolved
    # before any table is read
    with pytest.raises(RuntimeError, match="CUDA"):
        packing.scene_from_numpy({}, {})


def test_unported_modes_raise():
    """The one mode of the JAX package the port has not, "interpret" (its
    plain versions serve the CPU), is refused; the debug heatmap and the
    legacy modes render."""
    sc, info = _scene(2)
    for cfg in (_small(fused="interpret"), _small(pallas="interpret")):
        with pytest.raises(ValueError, match="interpret"):
            render_frame(sc, info, cfg, (0, 0, 0), (0, 0, 0), 1,
                         device="cpu")
    for cfg in (_small(debug=True), _small(legacy_shading=True),
                _small(legacy_pathtrace=True)):
        img = Renderer(sc, info, cfg, device="cpu").render(1)
        assert img.shape == (16, 24, 3) and bool(torch.isfinite(img).all())


def test_import_boundary():
    """Importing the port (and driving it, its run tools included) loads
    neither jax nor the JAX package, nor bench.py or the JAX package's
    tools; neither does chip_smoke.py's import section."""
    code = (
        "import sys\n"
        "import pathtracer0_tpu_torch\n"
        "from pathtracer0_tpu_torch import scenes, render_frame\n"
        "from pathtracer0_tpu_torch.kernels import frame, build, fused\n"
        "from pathtracer0_tpu_torch.kernels import wavefront, traverse\n"
        "from pathtracer0_tpu_torch.accel import bvh, lbvh, native_lbvh\n"
        "from pathtracer0_tpu_torch.scene import packing, objparse\n"
        "from pathtracer0_tpu_torch.render import integrator, renderer\n"
        "from pathtracer0_tpu_torch.render import driver\n"
        "from pathtracer0_tpu_torch.core import camera\n"
        "import pathtracer0_tpu_torch.__main__\n"
        "from pathtracer0_tpu_torch.kernels import mxu_group, mxu_tri\n"
        "from pathtracer0_tpu_torch.kernels import mm_probe\n"
        "from pathtracer0_tpu_torch.tools import diag_mxu, diag_mxu_mm\n"
        "from pathtracer0_tpu_torch.shade import arealights, mtl\n"
        "from pathtracer0_tpu_torch.render.renderer import (\n"
        "    render_debug_frame, render_rays)\n"
        "diag_mxu.main(1, 1, n_blocks=1, device='cpu', out=lambda s: None)\n"
        "diag_mxu_mm.main(8, 1, device='cpu', out=lambda s: None)\n"
        "from pathtracer0_tpu_torch import RenderConfig\n"
        "cfg = RenderConfig(16, 12, samples_per_frame=1)\n"
        "s, i = scenes.BUILDERS[3]().build(cfg, device='cpu')\n"
        "driver.FrameLoopDriver(s, i, cfg, device='cpu').run_script(\n"
        "    [None, 'telemetry'])\n"
        "from pathtracer0_tpu_torch import Renderer, Scene\n"
        "lit = Scene()\n"
        "lit.set_constant_sky((0.1, 0.1, 0.1))\n"
        "lit.add_material('m')\n"
        "lit.add_material('light')\n"
        "lit.set_last_mtl('Ke', (3.0, 3.0, 3.0))\n"
        "lit.add_tri((-2, -1, 4), (2, -1, 4), (0, 2, 5), 0)\n"
        "lit.add_emissive_sphere((0, 3, 3), 0.5, 1)\n"
        "ls, li = lit.build(cfg, device='cpu')\n"
        "import dataclasses\n"
        "for kw in (dict(debug=True), dict(legacy_pathtrace=True),\n"
        "           dict(legacy_shading=True, raytracing=False)):\n"
        "    Renderer(ls, li, dataclasses.replace(cfg, **kw),\n"
        "             device='cpu').render(1)\n"
        "uv, ix = camera.pixel_centers(16, 12, 'cpu')\n"
        "import torch\n"
        "render_rays(ls, li, uv, ix, torch.zeros(3), torch.zeros(3), 1,\n"
        "            torch.tensor(1.0), fold_spp=True,\n"
        "            config=dataclasses.replace(cfg, samples_per_frame=2))\n"
        "from pathtracer0_tpu_torch.dist import mesh, multihost\n"
        "from pathtracer0_tpu_torch.scene import native_obj\n"
        "import os, tempfile\n"
        "obj = os.path.join(tempfile.mkdtemp(), 'tri.obj')\n"
        "open(obj, 'w').write('o t\\nv 0 0 3\\nv 1 0 3\\nv 0 1 3\\n"
        "f 1 2 3\\n')\n"
        "os.environ['PT0_NATIVE_OBJ'] = '1'\n"
        "lit.add_object(obj)\n"
        "assert len(lit.bulk_meshes) == 1\n"
        "ls, li = lit.build(cfg, device='cpu')\n"
        "m = mesh.make_mesh(devices=['cpu'] * 3)\n"
        "mesh.render_frame_tiled(ls, li, cfg, (0, 0, 0), (0, 0, 0), 1, m)\n"
        "mesh.render_frame_sample_split(ls, li, cfg, (0, 0, 0), (0, 0, 0),\n"
        "                               1, m[:2])\n"
        "mesh.DistributedRenderer(ls, li, cfg, m).step()\n"
        "multihost.assemble_image(multihost.render_local_slab(\n"
        "    ls, li, cfg, (0, 0, 0), (0, 0, 0), 1, multihost.local_mesh(\n"
        "        ['cpu']))[0], cfg.height)\n"
        "from pathtracer0_tpu_torch.tools import (diag_build4m,\n"
        "    diag_scale_frame, diag_streamed, profile, run_hero_full)\n"
        "q = lambda *_: None\n"
        "diag_streamed.main(8, scene=diag_streamed.terrain(8, config=\n"
        "    RenderConfig(stream_threshold=0), device='cpu'), rays=64,\n"
        "    out=q)\n"
        "diag_scale_frame.main(8, size=(8, 6), device='cpu', out=q)\n"
        "diag_build4m.main(8, device='cpu', out=q)\n"
        "profile.main(['--config', '3', '--frames', '1', '--device', 'cpu',\n"
        "              '--trace', tempfile.mkdtemp()],\n"
        "             params=(8, 6, 1, 2, True), out=q)\n"
        "run_hero_full.run(4, 2, 2, out_dir=tempfile.mkdtemp(),\n"
        "                  device='cpu', log=q, overrides=dict(\n"
        "                      width=8, height=6, samples_per_frame=2))\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'pathtracer0_tpu' or m.startswith('pathtracer0_tpu.')"
        " or m in ('bench', 'tools') or m.startswith('tools.')]\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_sources_import_no_jax():
    """No module of the port, and not chip_smoke.py, names jax, the JAX
    package, bench.py or the JAX package's tools in an import
    statement."""
    import ast
    import glob

    files = glob.glob(os.path.join(ROOT, "pathtracer0_tpu_torch", "**",
                                   "*.py"), recursive=True)
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "pathtracer0_tpu",
                                   "bench", "tools"), (path, name)
