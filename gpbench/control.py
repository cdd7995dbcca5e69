"""The readings that a cell's limits are set from, at the cell's own size.

    python3 gpbench/control.py --workload <name> --seconds <s> --seeds <n> [<n> ...]

For each seed, one window of the program as ``run.py`` runs it, then the
numbers that decide ``correct`` (the generator's ``judge``), read twice: from
the program's answers, and from the control's: the plain reference in
float32 with TF32 matmuls (the precision below the configuration's),
computed at the same iterates and fitted parameters in the program's
place.  One JSON line a seed; set-up is paid once, for the first seed.
Needs a CUDA card, as ``run.py`` does.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [p for p in (ROOT, HERE) if p not in sys.path]
    import torch
    if not torch.cuda.is_available():
        print("gpbench: the control needs a CUDA card", file=sys.stderr)
        return 2
    from harness.cell import run_cell
    from harness.manifest import Manifest
    manifest = Manifest(ROOT)
    cell = manifest.cell(args.workload)
    limits = manifest.limits(cell)
    for seed in args.seeds:
        t = time.perf_counter()
        out = run_cell(manifest, cell, seed, args.seconds, False,
                       sources=("program", "control"))
        print(json.dumps({"workload": cell["name"], "seed": seed,
                          "readings": out["readings"], "limits": limits,
                          "window": out["window"],
                          "metrics": out["metrics"],
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
