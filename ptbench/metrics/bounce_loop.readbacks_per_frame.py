"""The port's `pt0.bounce.readback` spans a traced frame: host syncs of the
bounce loop, spp x bounces where every sample's rays live to the last
bounce."""
from ptbench import spans


def read(r):
    return spans.per_frame(r, "pt0.bounce.readback")
