"""The share of the traced stretch, in %, in which no device operation ran
while the host was inside Renderer.step (the `ptbench.step` spans): the
idle the program's own issue leaves; device.idle_share.frame_path less
this is the idle under the session loop between steps. Not listed in
BENCHMARK.json: it sets host spans against device intervals, and where the
trace's device clock drifts from the host's by 0.2 ms or more it
reads low (PERF.md section 7)."""
from ptbench import spans


def read(r):
    return spans.idle_share_in_step(r)
