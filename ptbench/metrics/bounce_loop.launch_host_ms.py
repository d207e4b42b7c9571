"""The host's ms a traced frame in the port's `pt0.bounce` spans (a bounce
step of render/integrator._run_bounces) outside their
`pt0.bounce.readback`: building bounce_kernel's arguments and launching
it."""
from ptbench import spans


def read(r):
    return spans.self_ms(r, "pt0.bounce", "pt0.bounce.readback")
