"""bounce_kernel of this checkout against other checkouts' in turns: the
device time of one launch of each form on the same state and walk, and
whether the outputs are the same bits. `chip_smoke.py` phase `bounce`
calls `turns` with its --parent trees' kernels/bounce.py on its cells, and
`camera_ms` for the camera form. A timing is 20 launches back to back
between CUDA events on 20 copies of the state (the path form writes its
state in place), taken for each checkout in turns, change first: (change,
trees..., trees reversed..., change) twice; the median of each is kept.
They run on the card only.
"""
from __future__ import annotations

import dataclasses
import statistics

import torch

from ..kernels import bounce

# the state fields each form writes, compared bit for bit
OUTPUTS = {"path": ("o", "d", "col", "inc", "skyc", "enter", "stack",
                    "ssize", "inobj", "state", "alive", "queries"),
           "whitted": ("inc",), "locate": ("loc",)}


def _copy(mod, st):
    """A copy of state `st` as checkout `mod`'s kernels/bounce.py holds it
    (the fields its BounceState has). A checkout whose path state still
    counts the rays left alive after each bounce (`live`) gets a zeroed
    counter for each bounce up to this one."""
    names = {f.name for f in dataclasses.fields(mod.BounceState)}
    fields = {
        f.name: (getattr(st, f.name).clone()
                 if isinstance(getattr(st, f.name), torch.Tensor)
                 else getattr(st, f.name))
        for f in dataclasses.fields(st) if f.name in names}
    if "live" in names and st.stack is not None:
        fields["live"] = torch.zeros(st.bounce + 1, dtype=torch.int32,
                                     device=st.alive.device)
    return mod.BounceState(**fields)


def _timed(mod, sc, info, st, walk, form, probe_t, reps):
    """(device ms of one launch of `mod`'s kernel in `form`, the state of
    its first launch): reps launches back to back on as many copies."""
    dev = st.alive.device
    copies = [_copy(mod, st) for _ in range(reps + 1)]
    made = [mod._args(sc, info, s, walk, form, probe_t) for s in copies]
    mod.launch(made[0][0], dev)
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for args, _ in made[1:]:
        mod.launch(args, dev)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps, copies[0]


def turns(sc, info, st, walk, form, mods, probe_t=None, rounds=2, reps=20):
    """{checkout: {"ms": median, "ms_all": [...], "bits_equal": its outputs
    equal the change's}} of `form` on state `st` and `walk` for each
    kernels/bounce.py of `mods` ({"change": ..., label: ...}), timed in
    turns."""
    order = list(mods) + list(mods)[::-1]
    times = {who: [] for who in mods}
    outs = {}
    for who in order * rounds:
        ms, out = _timed(mods[who], sc, info, st, walk, form, probe_t, reps)
        times[who].append(ms)
        outs.setdefault(who, out)
    ref = outs["change"]

    def differs(out):
        """{field: rays on which it differs from the change's}"""
        got = {}
        for f in OUTPUTS[form]:
            a, b = getattr(out, f), getattr(ref, f)
            if a is not None and b is not None and not torch.equal(a, b):
                ne = a != b
                got[f] = int((ne.any(0) if ne.dim() == 2 else ne).sum())
        return got

    return {who: {"ms": statistics.median(t), "ms_all": t,
                  "bits_equal": not differs(outs[who]),
                  "differs": differs(outs[who])}
            for who, t in times.items()}


def camera_ms(st, pd, cam, blur, accumulate, reps=20):
    """Device ms of one launch of this checkout's camera form on `st` (its
    work does not depend on the state, so the launches share it)."""
    args = bounce.camera_args(st, pd, cam, blur, accumulate)
    bounce.launch(args, st.alive.device)
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        bounce.launch(args, st.alive.device)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps
