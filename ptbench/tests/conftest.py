"""Tests of the benchmark: the CPU ones shrink each cell (`tiny`); those
marked `cuda` need a card and skip without one, decided in the `card`
fixture.

    python -m pytest ptbench/tests            (from the checkout's root)
    python -m pytest -m cuda ptbench/tests    (on a machine with a card)
"""
import pytest

# each cell at a size the CPU renders in seconds: every pixel checked, the
# terrain at n = 33 (2,048 triangles) through the streamed LBVH
TINY = {
    "hero": {"render": {"width": 16, "height": 12,
                        "samples_per_frame": 2}},
    "terrain1m": {"render": {"width": 16, "height": 12,
                             "samples_per_frame": 2,
                             "stream_threshold": 1000},
                  "mesh": {"n": 33},
                  "camera": {"pos": [0.0, 7.0, -1.5], "rot": [1.0, 0.0, 0.0]}},
}
TINY_MIX = {
    "progressive": {"check_pixels": 192, "check_pixels_first": 192,
                    "clean_spp": 8, "trace_count": 3, "warm": 1},
}


def tiny(workload):
    config, mix = workload.split(".")
    return {"config": TINY[config], "mix": TINY_MIX[mix]}


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
