#!/usr/bin/env python3
"""Drive the PyTorch port's exact-GP EDR main path once on an NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases, in order, each printing one JSON line:

0. device — the card, PyTorch and CUDA versions, nvcc;
1. build — compile ``edrgp_tpu_torch/ops/cuda/rbf.cu`` from the checkout;
2. kernels — each hand-written kernel against its plain PyTorch version on
   the card, float32, at the main path's shapes: the largest error relative
   to the plain result's largest entry (limits: K 1e-5, G and A 1e-4), both
   times from CUDA events after a warm-up (σ² a tensor on the card, as the
   main path passes it), the kernel's bound on an H100 with the resource
   that sets it, the share of that bound the kernel reaches, and that a
   second launch gives the same bits;
3. nlml — NLML value+grad at N=10,000, Q=8, RBF-ARD: ms per evaluation
   through the kernels and through the plain autograd backward, and the
   largest relative gradient difference between the two;
4. small_reference — the N=500 acceptance recipe on the card (float32)
   against the port's CPU float64 run: the two subspaces must agree;
5. main_path — ``EffectiveDimensionalityReduction(GaussianProcessRegressor(
   kernels="RBF", kernel_options={"ARD": True}), SVDTransformer(),
   n_components=3).fit(X, y)`` at N=8,192, Q=10 with a planted 3-D
   subspace, 5 float32 restarts, ``max_iters=200``; every kernel must launch
   in it and the subspace must be recovered (discrepancy < 0.1); then
   gradients — the first fit's gradient extraction alone at N=8,192,
   Q=10, and the part of it that kernel G takes.

Then one JSON line on the kernels (at N=8,192, Q=10: times, bound, share
of bound, launches on the main path; ``library_ms`` is null because no
single PyTorch call computes any of the three functions), the
``nvidia-smi`` name and power limit,
and last ``{"ok": true, "device": {...}}``, printed only when every phase
passed.  Any failure raises and exits non-zero; so does a machine without
CUDA.  The script imports nothing of JAX.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np

KERNELS = {
    "rbf_kernel_matrix": "edrgp_tpu/ops/pallas/rbf.py:98",
    "rbf_grad_mu": "edrgp_tpu/ops/pallas/rbf.py:172",
    "rbf_nlml_adjoint": "edrgp_tpu/ops/pallas/rbf.py:262",
}
SOURCE = "edrgp_tpu_torch/ops/cuda/rbf.cu"
LIMITS = {"rbf_kernel_matrix": 1e-5, "rbf_grad_mu": 1e-4,
          "rbf_nlml_adjoint": 1e-4}
#: The shape (rows, columns, Q) whose times the kernels line reports: the
#: first EDR fit's N = 8,192 training rows in Q = 10.
MAIN_SHAPE = (8192, 8192, 10)
#: Published peaks of one H100 SXM at 700 W: HBM bytes and fp32 flops (FMA
#: counted as two, no tensor cores) per millisecond.
HBM_BYTES_PER_MS = 3.35e9
FP32_FLOPS_PER_MS = 67e9
#: Why library_ms is null for every kernel.
NO_LIBRARY = {
    "rbf_kernel_matrix": "no single PyTorch call: a distance, then an exp",
    "rbf_grad_mu": "no single PyTorch call: an elementwise weighting, a "
                   "skinny product and a row sum",
    "rbf_nlml_adjoint": "no single PyTorch call: an elementwise weighting, "
                        "a skinny product and a row sum",
}


def emit(**fields):
    print(json.dumps(fields, default=float), flush=True)


def check(ok, message):
    if not ok:
        raise RuntimeError(message)


def kernel_bound(name, rows, cols, Q):
    """(ms, resource): the least time an H100 could take for the kernel's
    work, the larger of its bytes (each input read once, each output
    written once) over the HBM rate and its fp32 flops over the fp32 peak;
    resource is "hbm_read", "hbm_write" or "fp32".  Flops per pair: for K
    and A the distance is Q subtractions and Q FMAs (3Q), for G a dot
    product of Q FMAs (2Q) beside the rows' and columns' norms (2Q flops a
    row); G and A add Q FMAs for the weighted sum (2Q), and each kernel a
    few scalar operations around the exp (for G the norms' sum, an FMA,
    the weight and the row sum: 5)."""
    if name == "rbf_kernel_matrix":
        read, write = (rows + cols) * Q * 4, rows * cols * 4
        flops = (3 * Q + 2) * rows * cols
    elif name == "rbf_grad_mu":
        read, write = (rows * Q + cols * Q + cols) * 4, rows * Q * 4
        flops = (4 * Q + 5) * rows * cols + 2 * Q * (rows + cols)
    else:
        read, write = (rows * cols + rows * Q) * 4, rows * (Q + 1) * 4
        flops = (5 * Q + 4) * rows * cols
    bytes_ms = (read + write) / HBM_BYTES_PER_MS
    flops_ms = flops / FP32_FLOPS_PER_MS
    if flops_ms > bytes_ms:
        return flops_ms, "fp32"
    return bytes_ms, "hbm_write" if write > read else "hbm_read"


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` in ms over ``reps`` runs after warm-up.
    The card first spins for ~10 ms while the host queues the runs, so the
    span between the events is the card's work, not the host's time to
    enqueue it (a wrapper's Python and CUDA API calls can take as long as a
    0.1 ms kernel).  A ``fn`` that waits on the card inside still times
    right: it only queues less ahead."""
    import torch
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def principal_angles_deg(A, B):
    Qa = np.linalg.qr(np.asarray(A, np.float64))[0]
    Qb = np.linalg.qr(np.asarray(B, np.float64))[0]
    s = np.clip(np.linalg.svd(Qa.T @ Qb, compute_uv=False), -1.0, 1.0)
    return np.degrees(np.arccos(s))


def phase_device():
    import torch
    from edrgp_tpu_torch.ops.cuda import _build
    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit(phase="device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=_build.nvcc_path())
    return smi


def phase_build():
    from edrgp_tpu_torch.ops.cuda import _build
    t0 = time.perf_counter()
    _build.load()
    regs = [line.split(":", 1)[1].strip()
            for line in _build.build_log.splitlines() if "Used" in line]
    emit(phase="build", seconds=time.perf_counter() - t0,
         library=str(_build.library_path()), ptxas=regs)


def _kernel_case(name, rows, cols, Q, gen):
    """(kernel call, plain call) on random inputs of the given shape."""
    import torch
    from edrgp_tpu_torch.ops.cuda import rbf
    dev = "cuda"
    ls = 0.5 * math.sqrt(Q) * (1.0 + torch.rand(Q, generator=gen,
                                                device=dev))
    s2 = torch.tensor(1.3, device=dev)
    if name == "rbf_kernel_matrix":
        X1 = torch.randn(rows, Q, generator=gen, device=dev) / ls
        X2 = torch.randn(cols, Q, generator=gen, device=dev) / ls
        return (lambda: rbf.rbf_kernel_matrix(X1, X2, s2),
                lambda: rbf.rbf_kernel_matrix_plain(X1, X2, s2))
    if name == "rbf_grad_mu":
        Xn = torch.randn(rows, Q, generator=gen, device=dev)
        X = torch.randn(cols, Q, generator=gen, device=dev)
        a = torch.randn(cols, generator=gen, device=dev)
        return (lambda: rbf.rbf_grad_mu(Xn, X, a, ls, s2),
                lambda: rbf.rbf_grad_mu_plain(Xn, X, a, ls, s2))
    X = torch.randn(rows, Q, generator=gen, device=dev)
    W = torch.randn(rows, rows, generator=gen, device=dev)
    W = 0.5 * (W + W.T)
    return (lambda: rbf.rbf_nlml_adjoint(X, W, ls, s2),
            lambda: rbf.rbf_nlml_adjoint_plain(X, W, ls, s2))


def phase_kernels():
    """Kernel vs plain at a ragged shape and the main path's: N=8,192 at
    each Q of the EDR's fits (10, 7, 4, 3), the held-out cross-kernel, G at
    the tall shapes of sparse models' gradients (M=102,400 by N=8,192 and
    M=1,048,576 by N=512: one column split), and each kernel at N=8,191
    (N % 4 != 0: 4-byte stores for K, 4-byte cp.async loads instead of TMA
    for A)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    fits = [(8192, 8192, Q) for Q in (10, 7, 4, 3)]
    shapes = {
        "rbf_kernel_matrix": [(1000, 1537, 10), *fits, (8192, 2000, 3),
                              (8191, 8191, 10)],
        "rbf_grad_mu": [(1000, 1537, 10), *fits, (8191, 8191, 10),
                        (102400, 8192, 10), (1048576, 512, 10)],
        "rbf_nlml_adjoint": [(1537, 1537, 10), *fits, (8191, 8191, 10)],
    }
    summary = {}
    for name, cases in shapes.items():
        worst = 0.0
        for rows, cols, Q in cases:
            kernel, plain = _kernel_case(name, rows, cols, Q, gen)
            got, want = kernel(), plain()
            if isinstance(got, torch.Tensor):
                got, want = (got,), (want,)
            torch.cuda.synchronize()
            check(all(bool(torch.isfinite(g).all()) for g in got),
                  f"{name}: non-finite output")
            errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
            err = max(errs)
            rel = max(e / float(w.abs().max()) for e, w in zip(errs, want))
            again = kernel()
            again = (again,) if isinstance(again, torch.Tensor) else again
            bitwise = all(torch.equal(a, g) for a, g in zip(again, got))
            del again
            ms, plain_ms = cuda_ms(kernel, 20), cuda_ms(plain, 20)
            bound_ms, resource = kernel_bound(name, rows, cols, Q)
            emit(phase="kernels", kernel=name, rows=rows, cols=cols, Q=Q,
                 max_abs_err=err, rel_err=rel, limit=LIMITS[name], ms=ms,
                 plain_ms=plain_ms, bound_ms=bound_ms, resource=resource,
                 share_of_bound=bound_ms / ms, bitwise_repeat=bitwise)
            check(rel <= LIMITS[name], f"{name} at {(rows, cols, Q)}: "
                  f"relative error {rel:.3g} > {LIMITS[name]}")
            check(bitwise, f"{name} at {(rows, cols, Q)}: two launches on "
                  "the same inputs differ")
            worst = max(worst, err)
            if (rows, cols, Q) == MAIN_SHAPE:
                summary[name] = {
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": "operations" if resource == "fp32"
                    else "bytes",
                    "resource": resource, "share_of_bound": bound_ms / ms,
                    "library_ms": None, "library_note": NO_LIBRARY[name]}
            del kernel, plain, got, want
        summary[name]["max_abs_err"] = worst
    torch.cuda.empty_cache()
    return summary


def phase_nlml(device="cuda", N=10_000, Q=8):
    """NLML value+grad at the headline shape of bench.py (N=10k, Q=8)."""
    import torch
    from edrgp_tpu_torch.ops import exact, linalg
    from edrgp_tpu_torch.ops.cuda import rbf
    from edrgp_tpu_torch.ops.kernels import RBF
    from edrgp_tpu_torch.models.state import ExactGPModel
    rng = np.random.default_rng(0)
    X = rng.normal(size=(N, Q))
    y = np.sin(rng.normal(size=N))
    m = ExactGPModel(X, y, RBF(Q, ARD=True), normalizer=False, noise_var=0.1,
                     device=device)

    def fused():
        m.zero_grad()
        v = exact.nlml(m, m._X, m._y)
        v.backward()
        return v

    def plain():
        m.zero_grad()
        logdet, quad = linalg.logdet_and_quad(exact._Ky_generic(m, m._X),
                                              m._y)
        v = 0.5 * (N * math.log(2 * math.pi) + logdet + quad)
        v.backward()
        return v

    out = {}
    for label, fn in (("kernels", fused), ("plain", plain)):
        rbf.reset_launches()
        v = fn()
        launches = dict(rbf.LAUNCHES)
        out[label] = (v.item(), [p.grad.clone() for p in m.parameters()],
                      launches)
    check(out["kernels"][2]["rbf_kernel_matrix"] == 1
          and out["kernels"][2]["rbf_nlml_adjoint"] == 1,
          f"nlml did not go through the kernels: {out['kernels'][2]}")
    check(sum(out["plain"][2].values()) == 0, "plain path launched a kernel")
    grad_rel = max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(out["kernels"][1], out["plain"][1]))
    value_rel = abs(out["kernels"][0] - out["plain"][0]) / abs(out["plain"][0])
    check(math.isfinite(out["kernels"][0]), "non-finite NLML")
    check(grad_rel < 1e-3, f"NLML gradient differs by {grad_rel:.3g}")
    ms = cuda_ms(fused, 5)
    plain_ms = cuda_ms(plain, 5)
    emit(phase="nlml", N=N, Q=Q, nlml=out["kernels"][0], ms_per_eval=ms,
         plain_ms_per_eval=plain_ms, grad_max_rel_diff=grad_rel,
         value_rel_diff=value_rel,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    del m
    torch.cuda.empty_cache()


def _edr(device, n_components):
    from edrgp_tpu_torch import EffectiveDimensionalityReduction, SVDTransformer
    from edrgp_tpu_torch.models import GaussianProcessRegressor
    return EffectiveDimensionalityReduction(
        GaussianProcessRegressor(kernels="RBF", kernel_options={"ARD": True},
                                 device=device),
        SVDTransformer(), n_components=n_components)


def phase_small_reference(device="cuda"):
    """The N=500 acceptance recipe, card float32 vs CPU float64."""
    from edrgp_tpu_torch import discrepancy
    from edrgp_tpu_torch.datasets import get_gaussian_inputs, get_tanh_targets
    rng = np.random.default_rng(5)
    X = get_gaussian_inputs(eig_values=[1, 0.3], sample_size=500,
                            eig_vectors=np.array([[1, 1], [-1, 1]]), rng=rng)
    y = get_tanh_targets(X, [0.5, 0.5], rng=rng)
    comps = {}
    for dev in ("cpu", device):
        comps[dev] = _edr(dev, 1).fit(X, y).components_.T
    d = discrepancy(comps["cpu"] / np.linalg.norm(comps["cpu"]),
                    comps[device])
    unit = comps[device][:, 0] / np.linalg.norm(comps[device])
    emit(phase="small_reference", discrepancy_cuda_vs_cpu=d,
         component=unit.tolist())
    check(d < 1e-2, f"card and CPU subspaces differ: {d:.3g}")
    check(abs(abs(unit @ np.array([1.0, 1.0]) / math.sqrt(2)) - 1) < 1e-2,
          f"component {unit} is not ±(1,1)/√2")


def phase_main_path(device="cuda", N=8192, max_iters=200):
    import torch
    from edrgp_tpu_torch import discrepancy
    from edrgp_tpu_torch.datasets import get_beta_inputs, get_edr_target
    from edrgp_tpu_torch.ops.cuda import rbf
    Q, D = 10, 3
    rng = np.random.default_rng(0)
    X = get_beta_inputs(N, Q, rng=rng)
    B = np.linalg.qr(rng.normal(size=(Q, D)))[0]
    y = get_edr_target(X @ B, sigma=0.1, rng=rng)
    X_test = get_beta_inputs(2000, Q, rng=rng)
    y_test = get_edr_target(X_test @ B)

    rbf.reset_launches()
    t0 = time.perf_counter()
    edr = _edr(device, D).fit(X, y, max_iters=max_iters)
    fit_s = time.perf_counter() - t0      # the fit ends in host numpy
    pred = edr.estimator_.predict(edr._preprocessing_transform(X_test))
    launches = dict(rbf.LAUNCHES)

    disc = discrepancy(B, edr.components_.T)
    angles = principal_angles_deg(B, edr.components_.T)
    rmse = float(np.sqrt(np.mean((pred - y_test) ** 2)))
    model = edr.estimator_.estimator_
    emit(phase="main_path", N=N, Q=Q, n_components=D, fit_seconds=fit_s,
         nlml_reduced=model._objective, discrepancy=disc,
         principal_angles_deg=angles.tolist(), heldout_rmse=rmse,
         heldout_y_std=float(np.std(y_test)), launches=launches,
         hyperparameters={k: np.asarray(v).tolist() for k, v in
                          model.get_hyperparameters().items()},
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(all(v >= 1 for v in launches.values()),
          f"a kernel did not launch on the main path: {launches}")
    check(edr.components_.shape == (D, Q)
          and np.isfinite(edr.components_).all(), "bad components")
    check(np.isfinite(pred).all() and pred.shape == y_test.shape,
          "bad predictions")
    check(disc < 0.1, f"discrepancy {disc:.3g} >= 0.1")
    phase_gradients(device, X, y)
    return launches


def phase_gradients(device, X, y):
    """The first EDR fit's gradient extraction (``predictive_gradients`` at
    M = N = 8,192, Q = 10, at the model's initial hyperparameters): host
    clock around the first call (it factors the posterior) and a second one
    (both end in host numpy), and CUDA events around its dμ/dx* alone, which
    kernel G computes."""
    from edrgp_tpu_torch.models.state import ExactGPModel
    from edrgp_tpu_torch.ops import exact
    from edrgp_tpu_torch.ops.kernels import RBF
    gp = ExactGPModel(X, y, RBF(X.shape[1], ARD=True), device=device)
    ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        dmu, dvar = gp.predictive_gradients(X)
        ms.append(1e3 * (time.perf_counter() - t0))
    alpha = gp._posterior()[1]
    dmu_ms = cuda_ms(lambda: exact.predict_mean_grad(gp, gp._X, alpha,
                                                     gp._X), 5)
    emit(phase="gradients", M=X.shape[0], Q=X.shape[1], first_ms=ms[0],
         ms=ms[1], dmu_kernel_ms=dmu_ms, dmu_share=dmu_ms / ms[1])
    check(np.isfinite(dmu).all() and np.isfinite(dvar).all(),
          "non-finite predictive gradients")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # The GP's float32 matmuls must run in full float32 (config checks it).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    smi = phase_device()
    phase_build()
    summary = phase_kernels()
    phase_nlml()
    phase_small_reference()
    launches = phase_main_path()

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": where,
         "launches": launches[name], **summary[name]}
        for name, where in KERNELS.items()]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
