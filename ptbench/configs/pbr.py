"""The pbr configuration's data: the gradient sky of the repository's
bench scenes, which scenes.py's `full_pbr` shares with the hero; its one
copy is configs/hero.py's."""
from __future__ import annotations

from pathlib import Path

from ptbench.bench import _module

sky_image = _module(Path(__file__).with_name("hero.py"),
                    "ptbench_config_hero").sky_image
