"""Spans at the port's layer boundaries, on torch.profiler's clock.

`span(name)` is a `torch.profiler.record_function` while the profiler
records, so the span lands in the same trace as the device's kernels, and
one shared null context otherwise: an ungated record_function costs about
as much with the profiler off as on (~15 us a span on a CPU host), the
gate under 1 us.
"""
import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that marks `name` in the profiler's trace, if one runs."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
