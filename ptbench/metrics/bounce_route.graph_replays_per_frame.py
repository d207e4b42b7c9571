"""The port's `pt0.route.replay` spans a traced frame: replays of the CUDA
graph that holds a whole frame of the per-bounce route
(render/graph.py), 1.0 where every frame is one replay; nothing where the
program replays no graph."""
from ptbench import spans


def read(r):
    return spans.per_frame(r, "pt0.route.replay")
