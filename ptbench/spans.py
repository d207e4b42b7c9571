"""The port's own spans in a reduced trace (trace.reduce_events keeps them
among the host events): `pt0.frame` (kernels/frame.render_fused_frame),
`pt0.query` (kernels/traverse.walk_triangles), `pt0.bounce` (a bounce step
of render/integrator._run_bounces) and `pt0.bounce.readback` (its read of
the live count). Every reader returns None where the run has no trace or
the trace no span of the name, as a program without these spans gives."""
from ptbench.trace import busy_s, union


def _cut(red, spans):
    lo, hi = red["window"]
    return [(max(s, lo), min(t, hi)) for s, t in spans if t > lo and s < hi]


def intervals(red, name):
    """The spans `name` of the reduced trace `red`, cut to its window, in
    seconds: [(start, end)]."""
    return _cut(red, [(s, t) for n, s, t in red["host"] if n == name])


def covered(spans):
    """Seconds that the union of `spans` covers."""
    return sum(t - s for s, t in union(spans))


def host_ms(r, name):
    """The host's ms a traced frame inside the spans `name`."""
    red, frames = r["trace"], r["record"].frames
    if red is None or not frames:
        return None
    got = intervals(red, name)
    return 1e3 * covered(got) / frames if got else None


def self_ms(r, name, child):
    """The host's ms a traced frame inside the spans `name` and outside
    their children `child`."""
    red, frames = r["trace"], r["record"].frames
    if red is None or not frames:
        return None
    outer = union(intervals(red, name))
    if not outer:
        return None
    inner = union(intervals(red, child))
    # the part of each outer span that its children cover
    under = sum(max(0.0, min(t, b) - max(s, a))
                for a, b in outer for s, t in inner)
    return 1e3 * (covered(outer) - under) / frames


def per_frame(r, name):
    """The spans `name` a traced frame: a count."""
    red, frames = r["trace"], r["record"].frames
    if red is None or not frames:
        return None
    got = intervals(red, name)
    return len(got) / frames if got else None


def idle_share_in_step(r):
    """The share of the traced window, in %, in which no device operation
    ran while the host was inside `Renderer.step` (the benchmark's
    `ptbench.step` spans): never above the window's idle share
    (device.idle_share.*), which also counts the idle under the session
    loop between the steps."""
    red = r["trace"]
    if red is None:
        return None
    steps = union(_cut(red, red["spans"].get("ptbench.step", [])))
    if not steps:
        return None
    lo, hi = red["window"]
    idle = sum(t - s - busy_s(red["device"], s, t) for s, t in steps)
    return 100.0 * idle / (hi - lo)
