"""A configuration, a traffic mix and a per-layer metric are added as new
files and entries alone: the harness, copied unchanged, runs a cell made
of them (spheres, a rotated ellipsoid and a rotated implicit surface), and
its own CPU tests find the new cell by name, at the CPU size its files
give, with no test file edited."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import ptbench

ROOT = Path(ptbench.__file__).resolve().parent.parent

CONFIG = {
    "source": "a test scene", "reduced": [], "assumed": [],
    "route": "frame", "device_memory_bytes": None,
    "render": {"width": 12, "height": 8, "samples_per_frame": 2,
               "max_bounces": 3, "blur": 0.0, "auto_focus": False},
    "camera": {"pos": [0.0, 0.5, 0.0], "rot": [0.1, 0.0, 0.0]},
    "sky": {"constant": [0.4, 0.5, 0.8]},
    "materials": [{"name": "red", "props": {"Kd": [0.8, 0.2, 0.2]}},
                  {"name": "mirror", "props": {"Pr": 0.0, "Pm": 1.0}},
                  {"name": "blue", "props": {"Kd": [0.2, 0.3, 0.9],
                                             "Pc": 0.5, "Pcr": 0.2}}],
    "spheres": [{"center": [0.0, 0.4, 3.0], "radius": 0.5, "material": 1},
                {"center": [0.0, -50.0, 3.0], "radius": 50.0,
                 "material": 0}],
    "ellipsoids": [{"center": [-0.9, 0.35, 2.4], "stretch": [1.0, 2.5, 1.0],
                    "rot": [0.4, 0.0, 0.6], "radius": 0.5, "material": 0}],
    "implicits": [{"fn": 3, "shift": [0.85, 0.45, 2.4],
                   "scale": [0.3, 0.3, 0.3], "rot": [0.0, 0.5, 0.3],
                   "material": 2}]}
MIX = {"entry": "renderer", "clean_spp": 4, "screenshot": False, "warm": 1,
       "trace_count": 2, "check_pixels": 96, "check_pixels_first": 96}
METRIC = '''"""Frames a second of the window (a test metric)."""


def read(r):
    rec = r["record"]
    return rec.frames / (rec.end - rec.start)
'''


def test_new_cell_from_files_alone(tmp_path):
    shutil.copytree(ROOT / "ptbench", tmp_path / "ptbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_tmp"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "ptbench").rglob("*") if p.is_file()}
    (tmp_path / "ptbench/configs/balls.json").write_text(json.dumps(CONFIG))
    (tmp_path / "ptbench/traffic/burst.json").write_text(json.dumps(MIX))
    # the CPU sizes: the cell is tiny already
    (tmp_path / "ptbench/configs/balls.tiny.json").write_text("{}")
    (tmp_path / "ptbench/traffic/burst.tiny.json").write_text("{}")
    (tmp_path / "ptbench/metrics/frames_per_s.py").write_text(METRIC)
    (tmp_path / "ptbench/limits/balls.burst.json").write_text(
        json.dumps({"numbers": {"err.full": {"limit": 1e-6},
                                "err.first": {"limit": 1e-6}}}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "balls", "source": "a test",
                             "file": "ptbench/configs/balls.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "balls.burst", "config": "balls",
                               "traffic": "burst", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "frames_per_s", "unit": "1/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "renderer",
                               "moves": "samples_per_s.frame_path",
                               "workloads": ["balls.burst"]})
    bench["end_to_end"][0]["workloads"].append("balls.burst")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json\n"
            "from ptbench.run import run_cell\n"
            "out = [run_cell('balls.burst', 5, 0.5, t, device='cpu') "
            "for t in (0, 1)]\n"
            "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    plain, traced = json.loads(res.stdout.strip().splitlines()[-1])
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"samples_per_s.frame_path", "setup_s"}
    assert "frames_per_s" in traced["metrics"]
    assert plain["checks"]["err.full"]["value"] == 0.0
    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "ptbench/tests/test_ptb_faults.py",
         "ptbench/tests/test_ptb_control.py",
         "ptbench/tests/test_ptb_reference.py", "-k", "balls"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert tests.returncode == 0, tests.stdout[-3000:]
    # the sound run, 3 + 2 faults, the control, 3 reference tests
    assert tests.stdout.splitlines()[-1].startswith("10 passed"), \
        tests.stdout[-3000:]
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "ptbench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())
