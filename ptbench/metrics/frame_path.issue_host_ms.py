"""The host's ms a traced frame in the port's `pt0.frame` span
(kernels/frame.render_fused_frame: the seeds, the scalars packed, the
outputs, frame_kernel's launch, the division by spp)."""
from ptbench import spans


def read(r):
    return spans.host_ms(r, "pt0.frame")
