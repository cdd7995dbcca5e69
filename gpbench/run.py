"""Run one cell of the benchmark of ``edrgp_tpu_torch`` once.

    python3 gpbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``) names a
configuration and a traffic mix, and the mix its generator
(``mixes/<generator>.py``); the run sets up, runs the generator's window
for ``--seconds`` seconds, checks what it computed against the plain
float64 reference, and prints one JSON line last on standard output:
``correct``, ``attempted`` (the window's outer-loop steps: L-BFGS
iterations in fit traffic), ``failed`` (numbers over their limits),
``metrics`` (the end-to-end metrics; with ``--trace 1`` the per-layer
ones), ``device``, with ``--trace 1`` ``breakdown``, and last ``checks``:
each number compared with its limit, which standard error's last lines
repeat.  It refuses to run (exit 2, no result) without a CUDA
card, and fails (exit 3, no result) if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: Top-level modules that may not be loaded in the process that prints the
#: result, compared by whole top-level name: the port's own name begins
#: with the JAX package's.
FORBIDDEN = ("jax", "jaxlib", "flax", "edrgp_tpu")


def forbidden_modules() -> list:
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the kernels' library goes to ``build/edrgp_tpu_torch/`` already)."""
    base = os.path.join(ROOT, "build", "gpbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(base, "nv_compute_cache")


def _power_limit() -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "power limit not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _caches()
    sys.path[:0] = [p for p in (ROOT, HERE) if p not in sys.path]
    from harness.manifest import Manifest
    manifest = Manifest(ROOT)
    cell = manifest.cell(args.workload)
    limits = manifest.limits(cell)

    import torch
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gpbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 2

    from harness.cell import run_cell
    result = run_cell(manifest, cell, args.seed, args.seconds,
                      bool(args.trace), device="cuda", t_start=T_START,
                      limits=limits)

    found = forbidden_modules()
    if found:
        print(f"gpbench: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3

    print(f"card: {_power_limit()}", file=sys.stderr)
    print("window: " + json.dumps(result["window"]), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['reading']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result_line(result)), flush=True)
    return 0


def result_line(result: dict) -> dict:
    """The printed result: its fixed keys in order, then ``checks`` last."""
    line = {k: result[k] for k in ("correct", "attempted", "failed",
                                   "metrics", "device")}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["checks"] = result["checks"]
    return line


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
