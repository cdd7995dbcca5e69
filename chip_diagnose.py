#!/usr/bin/env python3
"""Two measurements on one NVIDIA card behind choices in ``chip_smoke.py``.

    python3 chip_diagnose.py group [none|group ...]   # Bayesian fits outside or inside an NCCL group
    python3 chip_diagnose.py trace [seconds]   # a profiler trace's kernel events as the process ages
    python3 chip_diagnose.py launches [kind ...]  # the same probe after bulk work of one kind

``group`` runs the first fit of chip_smoke's bayes_edr (N=1,024, Q=10, 4
chains, depth 6; warmup and samples cut to 60 + 20) once per variant named
(default: none, group, group, none) in one process, after a warm-up fit:
``none`` outside any process group, ``group`` inside a one-rank NCCL group
joined for that fit and left after it.  Every fit starts from the same
seed, so each does the same chain evaluations (the K launches are printed
beside the seconds and the process's age).

``trace [seconds]`` joins a one-rank NCCL group and takes a torch.profiler
trace of one sharded NLML evaluation (N=2,048, Q=8) after each of
chip_smoke's sharded phases (sharded_edr's 1,048,576-row Gram on an SVGP
model after 20 steps), then again after each of further sampler and SVGP
phases until the process is ``seconds`` old (default 960).  Each probe
prints the kernel events and the runtime launches in the trace, each
kernel's start less its launch's and each launch's start less its
operator's, and is taken twice: as it comes, and with the evaluation 0.1 s
after the profiler's start and before its stop.  At the first probe
without kernel events it tries a third probe and a probe in a new group,
then stops.

``launches`` takes the same probe after bulk work of one kind, three rounds
each: 100,000 launches of kernel K, 100,000 of a PyTorch kernel, 2,000
NCCL all-reduces (the default), or chip_smoke's sharded_samplers phase.
Each probe names the kernels it lacks against the process's first probe,
and is taken twice: as above, and with the profiler's external
correlation (its operator-to-launch links) off.

Each line is one JSON object; the script imports nothing of JAX.
"""

import json
import os
import sys
import time
from collections import Counter

import numpy as np

import chip_smoke as cs

START = time.monotonic()
#: The kernel names of the process's first probe.
FIRST = {}


def _uptime():
    return time.monotonic() - START


def _fit_bayes(X, y, device="cuda"):
    from edrgp_tpu_torch.models import BayesianGaussianProcessRegressor
    from edrgp_tpu_torch.ops.cuda import rbf
    rbf.reset_launches()
    cs._sync(device)
    t0 = time.perf_counter()
    BayesianGaussianProcessRegressor(
        kernels=["RBF"], kernel_options=[{"ARD": True}], num_chains=4,
        num_warmup=60, num_samples=20, max_depth=6, device=device).fit(X, y)
    cs._sync(device)
    return time.perf_counter() - t0, dict(rbf.LAUNCHES)


def run_group(variants):
    """One warm-up fit, then one fit per variant: ``none`` outside any
    process group, ``group`` inside a one-rank NCCL group joined for it."""
    import torch.distributed as dist
    from edrgp_tpu_torch.parallel import initialize
    X, y, _, _, _ = cs._edr_problem(1024)
    _fit_bayes(X[:, :4], y)                  # build and warm the kernels
    for variant in variants:
        joined = {"none": False, "group": True}[variant]
        if joined:
            initialize()
        seconds, launches = _fit_bayes(X, y)
        if joined:
            dist.destroy_process_group()
        cs.emit(diagnose="group", variant=variant, seconds=seconds,
                launches=launches, uptime_s=_uptime())


def probe(mesh, tag, model, pad_s=0.0, device="cuda", **config):
    """A torch.profiler trace of one sharded NLML evaluation, as chip_smoke's
    aux phase took it before ``profiling.trace`` fenced the card (a warm
    evaluation left running, a synchronize inside): kernel and launch
    events, and each kernel's start less its launch's, in µs."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile
    from edrgp_tpu_torch.parallel import sharded_nlml_value_and_grad
    path = os.path.join(cs.ROOT, "build", f"probe-{os.getpid()}.json")
    sharded_nlml_value_and_grad(model, mesh, model._X, model._y)
    try:
        experimental = (_ExperimentalConfig(**config) if config else None)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     experimental_config=experimental) as prof:
            time.sleep(pad_s)
            sharded_nlml_value_and_grad(model, mesh, model._X, model._y)
            cs._sync(device)
            time.sleep(pad_s)
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        if os.path.exists(path):
            os.unlink(path)
    stats = cs._trace_stats(events)
    names = Counter(e.get("name", "")[:60] for e in events
                    if e.get("cat") == "kernel")
    FIRST.setdefault("names", names)
    out = dict(diagnose="trace", tag=tag, uptime_s=_uptime(), pad_s=pad_s,
               config=config, missing_vs_first=dict(FIRST["names"] - names),
               names_K=any("kmat_kernel" in k
                           for k in stats.pop("kernel_names")),
               cpu_op_events=sum(e.get("cat") == "cpu_op" for e in events),
               **stats)
    cs.emit(**out)
    return out


def _svgp_handoff(N=1_048_576, Q=10, M=512, device="cuda"):
    """An SVGP model at svgp_edr's size after 20 steps, its rows and
    unsharded dμ/dx*: what sharded_edr's Gram at that size takes."""
    from edrgp_tpu_torch.models.svgp import SVGPModel
    from edrgp_tpu_torch.ops.kernels import RBF
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(N, Q)).astype(np.float32)
    y = np.sin(X[:, 0]).astype(np.float32)
    model = SVGPModel(X, y, RBF(Q, ARD=True), num_inducing=M, seed=0,
                      device=device)
    model.optimize(max_iters=20, batch_size=4096)    # q(u)'s mean off 0
    G = model.predictive_gradients(X)[0][:, :, 0]
    return cs._stash(model, "diagnose"), X, G


def run_trace(deadline_s, device="cuda"):
    import torch.distributed as dist
    from edrgp_tpu_torch.models.state import ExactGPModel
    from edrgp_tpu_torch.ops.kernels import RBF
    from edrgp_tpu_torch.parallel import initialize, make_mesh
    initialize()
    mesh = make_mesh(("data",))
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2048, 8))
    model = ExactGPModel(X, np.sin(X[:, 0]), RBF(8, ARD=True), device=device)
    theta_hat = cs._map_theta(device, 1024, 4, cs._gp_target(
        device, 1024, 4)[1])[0]
    _, _, B, _, _ = cs._edr_problem(8192)
    steps = [("start", lambda: None),
             ("sharded_nlml", lambda: cs.phase_sharded_nlml(mesh)),
             ("sharded_edr",
              lambda: cs.phase_sharded_edr(mesh, B, _svgp_handoff())),
             ("sharded_svgp", lambda: cs.phase_sharded_svgp(mesh)),
             ("sharded_samplers",
              lambda: cs.phase_sharded_samplers(theta_hat))]
    i = 0
    while True:
        if i < len(steps):
            tag, fn = steps[i]
        else:
            if _uptime() > deadline_s:
                break
            tag, fn = steps[3 + i % 2]
        fn()
        i += 1
        plain = probe(mesh, tag, model)
        probe(mesh, tag, model, pad_s=0.1)
        if plain["kernel_events"]:
            continue
        probe(mesh, "again", model)
        dist.destroy_process_group()
        initialize()
        mesh = make_mesh(("data",))
        probe(mesh, "new_group", model)
        break
    dist.destroy_process_group()


def run_launches(kinds, rounds=3, device="cuda"):
    """Probes after bulk work of one kind at a time, ``rounds`` times each:
    ``kernel_K`` 100,000 launches of kernel K (1,000-chain batches of
    16 × 16, Q=4), ``torch_add`` 100,000 launches of a PyTorch kernel,
    ``nccl_all_reduce`` 2,000 one-rank NCCL all-reduces,
    ``sharded_samplers`` chip_smoke's phase of that name."""
    import torch
    import torch.distributed as dist
    from edrgp_tpu_torch.models.state import ExactGPModel
    from edrgp_tpu_torch.ops.cuda import rbf
    from edrgp_tpu_torch.ops.kernels import RBF
    from edrgp_tpu_torch.parallel import initialize, make_mesh
    initialize()
    mesh = make_mesh(("data",))
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2048, 8))
    model = ExactGPModel(X, np.sin(X[:, 0]), RBF(8, ARD=True), device=device)
    probe(mesh, "start", model)
    probe(mesh, "start", model, disable_external_correlation=True)
    xs = torch.randn(1000, 16, 4, device=device)
    ones = torch.ones(1000, device=device)
    v = torch.zeros(16, device=device)
    s = torch.ones(1, device=device)

    def kernel_k():
        for _ in range(100):
            rbf.rbf_kernel_matrix(xs, xs, ones)

    def torch_kernel():
        for _ in range(100_000):
            v.add_(1.0)

    def all_reduce():
        for _ in range(2_000):
            dist.all_reduce(s)

    work = {"kernel_K": kernel_k, "torch_add": torch_kernel,
            "nccl_all_reduce": all_reduce}
    if "sharded_samplers" in kinds:
        theta_hat = cs._map_theta(device, 1024, 4, cs._gp_target(
            device, 1024, 4)[1])[0]
        work["sharded_samplers"] = lambda: cs.phase_sharded_samplers(
            theta_hat)
    for tag in kinds:
        fn = work[tag]
        for _ in range(rounds):
            t0 = time.perf_counter()
            fn()
            cs._sync(device)
            cs.emit(diagnose="launches", tag=tag,
                    seconds=time.perf_counter() - t0)
            probe(mesh, tag, model)
            probe(mesh, tag, model, disable_external_correlation=True)
    dist.destroy_process_group()


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_diagnose: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cs.phase_device()
    cs.phase_build()
    if sys.argv[1] == "group":
        run_group(sys.argv[2:] or ["none", "group", "group", "none"])
    elif sys.argv[1] == "launches":
        run_launches(sys.argv[2:] or ["kernel_K", "torch_add",
                                      "nccl_all_reduce"])
    else:
        run_trace(float(sys.argv[2]) if len(sys.argv) > 2 else 960.0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
