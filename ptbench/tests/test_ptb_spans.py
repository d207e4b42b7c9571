"""The readers of the port's own spans, on a reduced trace built by hand:
values worked out in the comments, in seconds unless said."""
import pytest

from ptbench import trace
from ptbench.bench import metric_reader
from ptbench.drive import Record

# window 0-10, 2 frames
#   ptbench.step 1-4, 5-9 (the benchmark's span around Renderer.step)
#   pt0.frame   1.5-3, 5.5-6.5                       covers 2.5
#   pt0.query   1.25-1.5, 2.5-3, 6-6.5, 9.5-10.5     cut to 9.5-10: 1.75
#   pt0.bounce  1.5-2.5, 3-3.5, 7-8                  covers 2.5
#     readback  2-2.25, 3-3.5, 7.5-7.75              covers 1.0, 3 spans
#   device      0-1.5, 2-3, 5.5-6, 8.5-9.5           busy 4.0 of the 10
# idle inside the steps: 1-4 busy 0.5 + 1 -> 1.5 idle; 5-9 busy 0.5 + 0.5
# -> 3 idle; 4.5 of the window's 10
STEPS = {"ptbench.step": [(1.0, 4.0), (5.0, 9.0)]}
HOST = ([("pt0.frame", 1.5, 3.0), ("pt0.frame", 5.5, 6.5),
         ("aten::mul", 1.5, 1.75)]
        + [("pt0.query", s, t) for s, t in
           ((1.25, 1.5), (2.5, 3.0), (6.0, 6.5), (9.5, 10.5))]
        + [("pt0.bounce", s, t) for s, t in
           ((1.5, 2.5), (3.0, 3.5), (7.0, 8.0))]
        + [("pt0.bounce.readback", s, t) for s, t in
           ((2.0, 2.25), (3.0, 3.5), (7.5, 7.75))])
DEVICE = [("k", 0.0, 1.5), ("k", 2.0, 3.0), ("k", 5.5, 6.0),
          ("k", 8.5, 9.5)]
WANT = {
    "frame_path.issue_host_ms": 1e3 * 2.5 / 2,
    "scene_query.issue_host_ms": 1e3 * 1.75 / 2,
    # bounces 2.5 less the 1.0 their readbacks cover
    "bounce_loop.launch_host_ms": 1e3 * 1.5 / 2,
    "bounce_loop.readback_wait_ms": 1e3 * 1.0 / 2,
    "bounce_loop.readbacks_per_frame": 3 / 2,
    "device.idle_share_in_step.frame_path": 45.0,
}


def _record(host=HOST, device=DEVICE, spans=STEPS):
    red = {"window": (0.0, 10.0), "device": device, "spans": spans,
           "host": host, "lead_kept": 1}
    return {"trace": red, "record": Record(frames=2)}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_by_hand(name):
    read = metric_reader(name)
    assert read(_record()) == pytest.approx(WANT[name])
    # no trace (a --trace 0 run), or a trace without the span
    assert read({"trace": None, "record": Record(frames=2)}) is None
    assert read(_record(host=[("aten::mul", 1.0, 2.0)], spans={})) is None


def test_idle_in_step_is_within_the_window_idle():
    r = _record()
    idle = metric_reader("device.idle_share.frame_path")(r)
    assert idle == pytest.approx(60.0)
    assert metric_reader("device.idle_share_in_step.frame_path")(r) <= idle


def test_reduce_events_keeps_the_port_spans_for_the_readers():
    def x(name, cat, ts, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}

    # microseconds: window 0-100, one step 10-90 holding a frame 20-60,
    # a kernel 20-30
    events = [x("ptbench.window", "user_annotation", 0, 100),
              x("ptbench.step", "user_annotation", 10, 80),
              x("pt0.frame", "user_annotation", 20, 40),
              x("pt0.frame", "gpu_user_annotation", 20, 10),
              x("spin_kernel", "kernel", 0, 1),
              x("k", "kernel", 20, 10)]
    red = trace.reduce_events(events)
    assert [h[0] for h in red["host"]] == ["pt0.frame"]
    r = {"trace": red, "record": Record(frames=1)}
    assert metric_reader("frame_path.issue_host_ms")(r) == \
        pytest.approx(40e-3)
    # 80 us in the step, 10 of them busy: 70 of the window's 100
    assert metric_reader("device.idle_share_in_step.frame_path")(r) == \
        pytest.approx(70.0)
