"""No module of the benchmark loads JAX or the JAX package, and the run's
own guard finds them by their whole top-level names."""
import pkgutil
import subprocess
import sys
import types
from pathlib import Path

import ptbench
from ptbench import run

ROOT = Path(ptbench.__file__).resolve().parent.parent


def test_every_module_imports_without_jax():
    names = [m.name for m in pkgutil.walk_packages(ptbench.__path__,
                                                   "ptbench.")]
    code = ("import importlib, sys\n"
            f"for n in {names!r}:\n"
            "    importlib.import_module(n)\n"
            "import ptbench.bench as b\n"
            "for w in b.benchmark()['workloads']:\n"
            "    b.cell(w['name'])\n"
            "for m in b.benchmark()['end_to_end'] + "
            "b.benchmark()['per_layer']:\n"
            "    b.metric_reader(m['name'])\n"
            "from ptbench.run import forbidden_modules\n"
            "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    assert len(names) > 10


def test_guard_compares_whole_top_level_names(monkeypatch):
    for name in ("pathtracer0_tpu_torch_extra", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "pathtracer0_tpu.scene",
                        types.ModuleType("pathtracer0_tpu.scene"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.forbidden_modules() == ["jax", "pathtracer0_tpu"]


def test_run_refuses_without_a_card():
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "ptbench.run", "--workload",
         "hero.progressive", "--seed", "1", "--seconds", "1"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 2
    assert out.stdout == ""
