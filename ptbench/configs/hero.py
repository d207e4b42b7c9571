"""The hero configuration's data: the gradient sky of the repository's
bench scenes (scenes.py `_gradient_sky`), 64 x 128 texels, row 0 the top."""
from __future__ import annotations

import numpy as np


def sky_image(params):
    rows, cols = int(params["rows"]), int(params["cols"])
    base = np.asarray(params["top"], np.float64)
    slope = np.asarray(params["slope"], np.float64)
    sky = np.zeros((rows, cols, 3), np.float32)
    for row in range(rows):
        sky[row] = base + slope * (row / float(rows - 1))
    return sky
