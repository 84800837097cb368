"""Readings that the limits of a cell's check are set from.

    python -m portbench.calibrate --workload <cell> --seeds 1,2,3 \
        --seconds 2 [--controls control,half] [--out FILE]

For each seed, in one process: the cell's set-up, a window of
``--seconds`` at its own load, the program's numbers (the lower readings)
and the numbers of each control judged in the program's place (the upper
readings): ``control`` is the plain reference computed at the next lower
precision than the configuration states (float8 for the bfloat16 forward,
bfloat16 for the float32 LM and ICP); the train loop's ``half`` trains on
half of each batch and ``sign`` steps up the gradient.  ``--controls ""``
reads the program alone.  One JSON line per seed on standard output (and
appended to ``--out``).  The benchmark's own runs never run a control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from . import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--controls", default="control")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    run.pin_caches()
    import torch
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA device", file=sys.stderr)
        return run.NO_CARD
    controls = tuple(c for c in args.controls.split(",") if c)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.monotonic()
        result, checks = run.run_cell(args.workload, seed, args.seconds,
                                      False, controls=controls, t0=t)
        line = json.dumps({
            "workload": args.workload, "seed": seed,
            "readings": result["readings"],
            "correct": result["correct"], "metrics": result["metrics"],
            "check_s": result["check_s"],
            "memory_peak_bytes": result["device"]["memory_peak_bytes"],
            "seconds": time.monotonic() - t})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
