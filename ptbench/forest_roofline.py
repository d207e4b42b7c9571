"""The frozen work count of the SAH forest's walk, `traverse_kernel`
(csrc/forest_kernel.cu), beside roofline.py's counts and on its peaks.

The floor counts bytes alone, the work any walk of the forest needs
whatever its order of visits: each live query's ray and pruning distance
in (origin, direction and t_init, 28 bytes) and its hit's t, u, v and row
out (16). Box tests and triangle tests depend on the rays and the tree,
and are left out, as roofline.py leaves out what the data decides.
"""
from __future__ import annotations

from ptbench import roofline

TRAVERSE_RAY_BYTES = 28 + 16


def traverse_kernel_s(*, queries):
    """traverse_kernel's floor over `queries` live queries."""
    return roofline.least_s(queries * TRAVERSE_RAY_BYTES)
