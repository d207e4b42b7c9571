"""Tests of the benchmark: the CPU ones shrink each cell (`tiny`); those
marked `cuda` need a card and skip without one, decided in the `card`
fixture.

    python -m pytest ptbench/tests            (from the checkout's root)
    python -m pytest -m cuda ptbench/tests    (on a machine with a card)

The cells and configurations are those of BENCHMARK.json, each test
parametrized over them by name. A configuration's CPU size is
`configs/<config>.tiny.json`, a traffic mix's `traffic/<mix>.tiny.json`:
merged into the cell as its `overrides`, so a cell added as files is
tested here with no test file edited.
"""
import json

import pytest

from ptbench import bench

_BENCH = bench.benchmark()
WORKLOADS = [w["name"] for w in _BENCH["workloads"]]
CONFIGS = [c["name"] for c in _BENCH["configs"]]


def _tiny_file(kind, name):
    with open(bench.PKG / kind / f"{name}.tiny.json") as f:
        return json.load(f)


def workload_of(config):
    """The first cell of BENCHMARK.json that runs `config`."""
    return next(w["name"] for w in _BENCH["workloads"]
                if w["config"] == config)


def tiny_config(config):
    """The CPU size of configuration `config`: its `.tiny.json`."""
    return _tiny_file("configs", config)


def tiny(workload):
    """The overrides that shrink cell `workload` to its CPU size."""
    w = next(w for w in _BENCH["workloads"] if w["name"] == workload)
    return {"config": tiny_config(w["config"]),
            "mix": _tiny_file("traffic", w["traffic"])}


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    """The tests run in several workers: two threads each."""
    import torch

    torch.set_num_threads(2)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")
