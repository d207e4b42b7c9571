"""The host's ms a traced frame in the port's `pt0.bounce.readback` spans
(kernels/bounce._finish: the 4-byte read of the rays left alive, which
waits for the bounce's work on the device)."""
from ptbench import spans


def read(r):
    return spans.host_ms(r, "pt0.bounce.readback")
