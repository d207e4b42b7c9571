"""The host's time in `Renderer.step` until it returns, before the sync,
as a mean over the traced frames, in ms: the benchmark's own span around
the call."""


def read(r):
    host = r["record"].step_host_s
    if r["trace"] is None or not host:
        return None
    return 1e3 * sum(host) / len(host)
