"""One run of one cell: set-up, the window, the metrics, the comparison.

``run_cell`` returns the result's fields; ``run.py`` prints them.  What a
run does is the cell's traffic generator's (``mixes/<generator>.py``,
found through the traffic file); this module only times it, traces it
and frees the program's state before the reference runs.  With ``trace``
the window runs under ``torch.profiler`` and the metrics are the cell's
per-layer metrics; without, its end-to-end metrics.
"""

from __future__ import annotations

import gc
import time

from . import checks


def _library_build_s() -> float | None:
    """Seconds spent building the program's kernel library (``nvcc``, once
    a checkout), 0 where it was built already; None without a card.  Set-up
    counts it; the run's window line shows it apart."""
    import torch
    if not torch.cuda.is_available():
        return None
    from edrgp_tpu_torch.ops.cuda import _build
    if _build.library_path().exists():
        return 0.0
    t = time.perf_counter()
    _build.build()
    return time.perf_counter() - t


def run_cell(manifest, cell: dict, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float | None = None,
             config: dict | None = None, limits: dict | None = None,
             sources=("program",)) -> dict:
    """The result of one run.  With ``limits`` None it has no ``correct``
    and ``checks`` but ``readings``: {source: {number: reading}} for each
    of ``sources`` ("program", and "control": the reference in the
    precision below the configuration's, in the program's place)."""
    import torch
    config = config or manifest.config(cell)
    traffic = manifest.traffic(cell)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    t_setup = time.perf_counter()
    stages = {"before_setup_s": (t_setup - t_start if t_start is not None
                                 else None),
              "library_build_s": _library_build_s() if on_card else None}
    mix = manifest.mix(traffic)(config, traffic, seed, device)
    mix.setup()
    stages["problems_and_warmup_s"] = time.perf_counter() - t_setup

    tracer = None
    if trace:
        from .trace import Tracer
        tracer = Tracer()
        tracer.__enter__()
    starts = {}
    t0, t1 = mix.window(seconds, spans=trace,
                        on_start=lambda: starts.update(ns=time.time_ns()))
    window_s = t1 - t0
    records = None
    if tracer is not None:
        t_stop = time.perf_counter()
        tracer.__exit__(None, None, None)
        t_read = time.perf_counter()
        records = tracer.records(starts["ns"],
                                 starts["ns"] + int(window_s * 1e9))
        stages.update(trace_stop_s=t_read - t_stop,
                      trace_read_s=time.perf_counter() - t_read)
        records.probe, records.config = getattr(mix, "probe", None), config
        records.window_s = window_s
        if "flops" in config:
            records.flops = manifest.flops(config)
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    metrics = {}
    if trace:
        for m in manifest.per_layer(cell):
            value = manifest.reader(m)(records)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(mix.end_to_end(window_s),
                      setup_s=(t0 - t_start) if t_start is not None else None)
        for m in manifest.end_to_end(cell):
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}

    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if on_card
                            else "cpu"),
                   "count": int(cell.get("chips", 1)),
                   "memory_peak_bytes": int(peak)}
    breakdown = None
    if records is not None:
        device_info["busy_s"] = records.busy_s()
        device_info["window_s"] = window_s
        breakdown = records.breakdown()

    # The program's state goes before the reference runs.
    mix.release()
    records = tracer = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    readings = {source: mix.judge(source) for source in sources}
    out = {"attempted": mix.attempted, "metrics": metrics,
           "device": device_info, "window": {
               "seconds": window_s, **mix.summary(),
               "check_s": time.perf_counter() - t_check, **stages}}
    if breakdown is not None:
        out["breakdown"] = breakdown
    if limits is None:
        out["readings"] = readings
        return out
    correct, failed, compared = checks.verdict(readings["program"], limits,
                                               mix.required)
    out.update(correct=correct, failed=failed, checks=compared)
    return out
