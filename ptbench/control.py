"""The readings the limits of `correct` are set from, on the card.

    python -m ptbench.control --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--fault <name>]

For each seed, in one process (the scene is built once): a window of the
cell's own traffic for `--seconds`, then the numbers check.py compares,
twice over the same images: the program against the float32 reference
(`sound`, the lower reading where no fault is planted), and the reference
computed in bfloat16, the precision below the configuration's float32, in
the program's place (`control`, the upper reading). `--fault` plants one of
faults.FAULTS or faults.GEOMETRY_FAULTS in the program before the scene is
built; its `sound` numbers are then the fault's readings. One JSON line a
seed. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def readings(b, seed, seconds):
    """(sound numbers, control numbers, images compared, non-finite pixel
    values of the program and of the reference) of one window."""
    import torch

    from . import check

    sess = b.session(seed)
    rec = sess.run(seconds=seconds)
    sess.close()
    ref = b.reference(rec.images)
    low = b.reference(rec.images, dtype=torch.bfloat16)
    program = [im.values for im in rec.images]
    sound, _ = check.numbers(rec.images, program, ref)
    control, _ = check.numbers(rec.images, low, ref)
    nonfinite = [sum(int((~torch.isfinite(v)).sum()) for v in vals)
                 for vals in (program, ref)]
    return sound, control, len(rec.images), nonfinite


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    from .run import Bench

    undo = None
    if args.fault:
        from .faults import plant
        undo = plant(args.fault)
    try:
        b = Bench(args.workload)
        for seed in args.seeds:
            t = time.perf_counter()
            sound, control, n, nonfinite = readings(b, seed, args.seconds)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "fault": args.fault, "images": n,
                              "nonfinite": nonfinite,
                              "sound": sound, "control": control,
                              "seconds": time.perf_counter() - t}),
                  flush=True)
    finally:
        if undo:
            undo()
    return 0


if __name__ == "__main__":
    sys.exit(main())
