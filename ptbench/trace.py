"""The traced stretch: torch.profiler over a fixed count of frames or
cycles, reduced to device intervals and the benchmark's own spans.

The profiler can drop the device records of a trace's first operations
(the repository's tools/profile.py `trace_busy` saw up to 152 lost). So
LEAD tiny kernels (`torch.cuda._sleep`, named LEAD_KERNEL) run first inside
the profiler's window and before the stretch; they are left out of every
count, and a trace that kept none of them is taken again. Busy time and
wall time are both taken over the same traced stretch.
"""
from __future__ import annotations

import json
import os
import tempfile

import torch

LEAD = 1024
LEAD_KERNEL = "spin_kernel"
TRIES = 4
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profile_stretch(run, device, tmp):
    """Run `run()` (which returns the stretch's Record) under the profiler
    and return (record, reduced trace). Retaken when the trace kept no
    lead kernel."""
    from torch.profiler import ProfilerActivity, profile

    for tries in range(1, TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with torch.cuda.device(device):
                for _ in range(LEAD):
                    torch.cuda._sleep(1)
            torch.cuda.synchronize(device)
            rec = run()
            torch.cuda.synchronize(device)
        fd, path = tempfile.mkstemp(suffix=".json", dir=tmp)
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        red = reduce_events(events)
        if red["lead_kept"]:
            red["tries"] = tries
            return rec, red
    raise RuntimeError(f"torch.profiler kept no lead kernel in {TRIES} "
                       "traces in a row")


def reduce_events(events):
    """The stretch (the benchmark's ptbench.window span) and what lies in
    it: device ops (name, start s, end s), host spans by name, and the
    host events that can label an idle gap."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    window = [e for e in xs if e.get("cat") == "user_annotation"
              and e.get("name") == "ptbench.window"]
    if not window:
        raise RuntimeError("the trace holds no ptbench.window span")
    w = window[-1]
    lo, hi = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    dev, lead = [], 0
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        if LEAD_KERNEL in e["name"]:
            lead += 1
            continue
        s, t = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if s >= lo and t <= hi:
            dev.append((e["name"], s * 1e-6, t * 1e-6))
    spans = {}
    host = []
    for e in xs:
        s, t = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if t < lo or s > hi:
            continue
        if e.get("cat") == "user_annotation" and str(
                e.get("name", "")).startswith("ptbench."):
            spans.setdefault(e["name"], []).append((s * 1e-6, t * 1e-6))
        elif e.get("cat") in ("cpu_op", "cuda_runtime", "user_annotation",
                              "cuda_driver"):
            host.append((e["name"], s * 1e-6, t * 1e-6))
    return {"window": (lo * 1e-6, hi * 1e-6), "device": dev, "spans": spans,
            "host": host, "lead_kept": lead}


def union(intervals):
    """The intervals merged: [(start, end)] sorted and disjoint."""
    out = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t))
        else:
            out.append((s, t))
    return out


def busy_s(device, lo, hi):
    """Seconds in [lo, hi] in which some device op ran."""
    return sum(max(0.0, min(t, hi) - max(s, lo))
               for s, t in union([(s, t) for _, s, t in device]))


def breakdown(red, top=10):
    """The device ops that took most time and the longest idle gaps by the
    innermost host event under each gap's middle."""
    by_op = {}
    for name, s, t in red["device"]:
        by_op[name] = by_op.get(name, 0.0) + (t - s)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    lo, hi = red["window"]
    busy = union([(s, t) for _, s, t in red["device"]])
    gaps, at = [], lo
    for s, t in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, t)
    if hi > at:
        gaps.append((at, hi))
    # host events nest: sweep them in order of start, keeping the open
    # ones on a stack, whose top is the innermost under a gap's middle
    host = sorted(red["host"], key=lambda h: (h[1], -h[2]))
    by_gap, stack, k = {}, [], 0
    for s, t in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (s + t)
        while k < len(host) and host[k][1] <= mid:
            while stack and stack[-1][2] < host[k][1]:
                stack.pop()
            stack.append(host[k])
            k += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        label = stack[-1][0] if stack else "no host event"
        by_gap[label] = by_gap.get(label, 0.0) + (t - s)
    idle = sorted(by_gap.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:120], v] for n, v in ops],
            "idle_gaps": [[n[:120], v] for n, v in idle]}
