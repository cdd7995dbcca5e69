#!/usr/bin/env python3
"""Drive the PyTorch port's exact-GP, sparse, SVGP, classifier,
heteroscedastic and Bayesian EDR paths, the reference's notebook
workloads, its entry points, its samplers and its multi-device layer once
on an NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases, in order, each printing one JSON line:

0. device — the card, PyTorch and CUDA versions, nvcc, and the process
   group the sharded phases will run in (backend, world size, NCCL
   version);
1. build — compile ``edrgp_tpu_torch/ops/cuda/rbf.cu`` and the native data
   loader (``edrgp_tpu_torch/native/dataloader.cpp``) from the checkout;
   trace — ``profiling.trace`` of one sharded NLML evaluation in a
   one-rank NCCL group joined for it: the trace must name kernel K (it
   runs before the sampler phases, after which PyTorch's profiler loses
   kernel records: ROADMAP Queue 3);
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
3a. kinv — Ky⁻¹ from the factor at N=8,192, Q=10 (main_path's data,
   its kernel's parameters at their start) by the NLML adjoint's blocked
   trtri + lauum, mirrored: ms from CUDA events beside its bound (2N³/3
   flops at the fp32 peak) and beside ``torch.cholesky_inverse`` as
   ``library_ms`` (the port no longer calls it), each one's largest error
   against the float64 inverse of the same factor relative to its largest
   entry (limit 1e-4 for the blocked one), exact symmetry; then a
   five-iteration single-start fit there, in which every evaluation with
   a gradient must form Ky⁻¹ by the blocked path;
4. small_reference — the N=500 acceptance recipe on the card (float32)
   against the port's CPU float64 run: the two subspaces must agree;
5. main_path — ``EffectiveDimensionalityReduction(GaussianProcessRegressor(
   kernels="RBF", kernel_options={"ARD": True}), SVDTransformer(),
   n_components=3).fit(X, y)`` at N=8,192, Q=10 with a planted 3-D
   subspace, 5 float32 restarts, ``max_iters=200``; every kernel must launch
   in it and the subspace must be recovered (discrepancy < 0.1); then
   gradients — the first fit's gradient extraction alone at N=8,192,
   Q=10, and the part of it that kernel G takes;
5a. notebooks — the reference's notebook workloads as
   ``benchmarks/parity_runs.py:150-259`` defines them, seed 0, through the
   port's own PCA and SparsePCA (regression with PCA as the DR method;
   BriefIntro one-shot, iterative ``step=1`` and the sparse projector with
   ``refit(SparsePCA(n_components=2, alpha=2))``; chain-PCA on the
   correlated and the uncorrelated covariance, raw and with
   ``preprocessor=PCA(n_components=2)``), 5 starts a fit, on the card
   (float32) against the port's CPU float64 run (in a process of its own
   beside the card's phases; its line is printed after sparse_refit,
   when that run is in): each subspace within
   discrepancy 1e-2 (chain-PCA uncorrelated with the preprocessor and
   BriefIntro iterative reported only), the refit with the same zero
   pattern and within 1e-2; each workload's discrepancy to its planted
   direction;
5b. entry — ``edrgp_tpu_torch.entry.entry()``: the NLML value+grad at
   N=2,048, Q=8 (``__graft_entry__.py``'s shapes), ms an evaluation over
   20 (CUDA events), against the CPU float64 evaluation (1e-4 relative,
   gradients 1e-3 of their largest entry); K and A must launch;
6. sgpr — BASELINE config 3 (``benchmarks/baseline_scale_tpu.py:29-58``)
   in the port: ``SGPRModel`` with 512 inducing inputs on N=100,000, Q=8,
   float32, 5 restarts, ``max_iters=200``; the RMSE against the noise-free
   target on 4,000 rows must be below 0.05; kernel G must serve
   ``predictive_gradients`` at 100,000 × 512; a save/load round trip on the
   card must predict the same bits; a torch.profiler split of one ELBO
   value+grad at that size; SGPR at N=2,000, M=64 on the card against the
   port's CPU float64 at the same parameters (ELBO within 1e-4 relative,
   dμ/dx* within 1e-4 of its largest entry), from a lengthscale that
   keeps the signal; the uncertain-input bound (``X_variance=0.01``) and
   its gradients at N=5,000, M=128 (two Psi2 chunks) on the card against
   the port's CPU float64 at the same fixed parameters (bound within 1e-4
   relative, each gradient within 1e-3 of its largest entry); an
   uncertain-input fit (N=8,192, M=128) with a finite bound;
7. sparse_edr — ``EffectiveDimensionalityReduction(
   SparseGaussianProcessRegressor(kernels="RBF", kernel_options={"ARD":
   True}, num_inducing=512), SVDTransformer(), n_components=3)`` at
   N=100,000, Q=10 on main_path's data, ``max_iters=200``: kernels G and K
   must launch in it and the subspace must be recovered (discrepancy < 0.1);
7a. sparse_refit — the same sparse EDR (M=512, ``n_components=2``) at
   N=100,000 on BriefIntro's sparse projector B_sparse, then
   ``refit(SparsePCA(n_components=2, alpha=10))`` on its cached
   gradients: both discrepancies < 0.1, at least B_sparse's exact zeros,
   G and K launched; fit seconds, the refit's host seconds and iterations;
8. svgp_reference — SVGP at N=4,096, M=64, Q=8 on the card (float32)
   against the port's CPU float64 at the same parameters, q(u) and 512-row
   minibatch: the ELBO (1e-4 relative), each parameter's gradient (1e-3 of
   its largest entry), θ₁ and θ₂ after one natural-gradient step with
   ρ = 0.5 (1e-3 of their largest entries), ``predict`` and dμ/dx* (1e-4
   of their largest entries);
9. svgp_stream — the SVGP half of BASELINE config 5
   (``benchmarks/baseline_scale_tpu.py:60-125``): N=10,000,000, Q=8 written
   to a temporary dataset file, ``SVGPModel.from_dataset`` with 512
   inducing inputs, ``optimize_stream`` over the native loader's 8,192-row
   batches for 3,000 steps; fit seconds, steps/s, rows/s, the device idle
   share and the split of a step over a 50-step profiler window, the
   loader's rows/s alone, peak memory; the RMSE against the noise-free
   target on 4,000 rows must be below 0.05, kernel K must serve
   ``predict`` and the native loader the stream;
10. svgp_edr — the north-star capstone (``benchmarks/edr_scale_tpu.py``) at
   N=1,048,576, Q=10, a planted 3-D subspace: a streamed SVGP-512 fit
   (1,000 steps of 4,096 rows), dμ/dx* at every row (one G launch), the
   eigenvectors of GᵀG; then ``EffectiveDimensionalityReduction(
   SVGPRegressor(num_inducing=512, batch_size=4096, lr=5e-3),
   SVDTransformer(), n_components=3, step=7).fit(X, y, max_iters=500)``
   (two fits, Q=10 then Q=3) and a held-out ``predict`` (K); both
   discrepancies must be below 0.1, G must launch once per fit;
11. cls_reference — the four classifiers on the card (float32) against the
   port's CPU float64 at the same fixed parameters, on main_path's
   generator with labels 1[f > median f]: VI and EP at N=1,024 (VI's
   state is N(N+1)/2 = 524,800 parameters, so the full VI model runs
   here only), sparse VI (probit and logit) and EP-DTC at N=2,000, M=64;
   the bound or log Z_EP within 1e-4 relative (EP 1e-3: float32 stops
   its sites at 1e-5), each parameter's gradient within 1e-3 of its
   largest entry, ``predict`` P(y=1) and dμ/dx* within 1e-4 of theirs;
   G and K must serve the card's predictions;
12. cls_ep_edr — ``EffectiveDimensionalityReduction(
   GaussianProcessClassifier(kernels="RBF", kernel_options={"ARD": True},
   inference="ep"), SVDTransformer(), n_components=3, step=7)`` at
   N=4,096, Q=10 (two fits), ``max_iters=100``: discrepancy < 0.1, held-out accuracy on 4,000
   rows > 0.85, G once per fit, K in every EP site loop; fit seconds,
   L-BFGS evaluations per fit, EP iterations per evaluation, ms per EP
   iteration, and the device idle share of one evaluation;
13. cls_sparse_edr — the same EDR over
   ``SparseGaussianProcessClassifier(num_inducing=512)`` (VI, probit) at
   N=100,000, Q=10 (two fits), ``max_iters=200``, then one EP-DTC fit at
   N=100,000, M=512, ``max_iters=50`` with dμ/dx* at every row and GᵀG's
   eigenvectors: both discrepancies < 0.1, both held-out accuracies >
   0.85, G once per fit, K in ``predict_proba`` and in every EP-DTC site
   loop, a save/load round trip on the card that predicts the same bits;
   ms per EP-DTC iteration; the launches count the VI EDR and the EP-DTC
   fit, not the timed bound evaluations between them;
14. het_reference — the per-point-noise NLML and its gradients at
   N=1,000 on the card (K forward, A backward) against the port's CPU
   float64 (value 1e-4 relative, gradients 1e-3 of their largest entry);
15. het_edr — EDR over ``GaussianProcessHeteroscedasticRegressor(
   kernels="RBF", kernel_options={"ARD": True}, Y_metadata={
   "output_index": row mod 4})`` at N=8,192, Q=10, noise std per group
   0.02 / 0.05 / 0.1 / 0.2 × std(f), ``max_iters=200``: discrepancy < 0.1,
   each learned group noise variance within a factor of 1.5 of its truth,
   A and K in every NLML evaluation, G once per fit;
16. sampler_reference — the samplers' numerics at BASELINE config 4's
   target (N=500, Q=4, 16 θ near the MAP) on the card (float32) against
   the port's CPU float64: ``nlml_chains`` value (1e-4 relative) and
   gradient (1e-3 of each parameter's largest entry), a 16-step leapfrog
   trajectory (1e-4), ``curvature_inv_mass`` (2e-2), and a chain at σ² =
   inf whose failure stays in its lane;
17. nuts_gp — BASELINE config 4 (``benchmarks/nuts_tpu.py``): NUTS over
   the exact-GP hyperparameters (4 ARD lengthscales, variance, noise) at
   N=1,024, Q=4, one group of 16 chains from the MAP with the Laplace
   mass, warmup 256, 128 samples, pooled ε: samples/s steady and with
   warmup, leapfrogs per transition, split-R̂ < 1.05, ESS ≥ 100,
   divergences ≤ 1%, the device idle share of a sampling segment and a
   profile of one 16-chain value+gradient; K and A once per chain per
   evaluation;
18. smc_gp — adaptive-tempering SMC on nuts_gp's target
   (``benchmarks/baseline_scale_tpu.py:128-231``: 256 particles from the
   MAP + 0.5·N(0, I), chunks of 64): β = 1 within 60 stages, ≥ 25%
   unique particles after every resample, the posterior against nuts_gp's
   draws (|z| < 2 a dimension, SD ratios in [0.5, 2]);
19. bayes_edr — ``EffectiveDimensionalityReduction(
   BayesianGaussianProcessRegressor(kernels=["RBF"], kernel_options=[{"ARD":
   True}], num_chains=4, ...), SVDTransformer(), n_components=3,
   step=7)`` at N=1,024, Q=10 (two fits, Q=10 then Q=3; 150 warmup and
   50 sampling transitions a fit, trees of depth 6 at most): each
   fit's R̂ < 1.1, discrepancy < 0.1, G once per kept sample, K once per
   kept sample in ``predict``, a bitwise save/load round trip;
distributed — join a one-rank NCCL process group on the card (the
   backend, world size and NCCL version; the barrier; ``checksum`` and
   ``assert_replicas_agree`` on a parameter dict), which the sharded
   phases run in; a failed NCCL start raises;
20. sharded_nlml — the row-slab-sharded NLML value+grad at N=10,000, Q=8
   on the group's ``data`` dimension against the single-device NLML on the
   card (value 1e-4 relative, gradients 1e-3 of their largest entry), the
   same bits twice, one K launch (the slab) an evaluation; ms beside the
   single-device path's, and a profiler split;
21. sharded_edr — main_path's EDR with ``GaussianProcessRegressor(
   method="optimize_sharded")`` and ``gradient_mesh``: discrepancy < 0.1,
   angles to main_path's subspace, each staged Gram against GᵀG (1e-4), G
   once a fit; then ``model_gradient_gram`` at N=1,048,576 on svgp_edr's
   streamed SVGP model against its unsharded G (the same bits, the Gram
   1e-4);
   surface — the routes no other phase drives: ``ops.sgpr.
   predict_mean_grad_batched`` (8,192-row chunks) on sparse_edr's model at
   its 100,000 rows against the unbatched call and float64 (each row 1e-6
   of its own sum of |terms|: its weights cancel ~9,000-fold, so float32
   rounding is a share of that, not of G), ``make_sharded_grad_gram`` on
   main_path's GP against ``exact.predict_mean_grad`` (1e-6) and its Gram
   against GᵀG (1e-4), ``add_jitter`` on the card (the host's bits), and
   PCA's whitening, randomized and ARPACK solvers on main_path's gradient
   matrix against the exact subspace (1e-6), with their host ms; G must
   launch once a chunk and once a sharded call;
22. sharded_svgp — ``make_sharded_svgp_step`` at config 5's shapes
   (8,192-row batches, M=512, Q=8): 10 steps against ``SVGPModel``'s own
   from the same start and batches (1e-4 of each largest entry), then
   steps/s and the kernel launches over 200 sharded steps;
23. sharded_samplers — ``run_sharded_nuts`` on nuts_gp's target (16
   chains, warmup 128, 64 samples, depth 8): split-R̂ < 1.05, divergences
   ≤ 1%, one pooled ε, samples/s; one ``run_sharded_smc_stage`` on 256
   particles; ``distributed_systematic_resample`` against
   ``systematic_resample`` with the same u0;
24. aux — a NUTS state's checkpoint round trip on the card (the same
   bits), ``StallWatchdog`` on a stall and while beaten, and a
   ``profiling.trace`` of one sharded NLML evaluation, taken last: it
   names kernel K with a kernel for every launch, or ``profiling.trace``
   reports the kernels the profiler lost;
25. dryrun_multichip — ``edrgp_tpu_torch.entry.dryrun_multichip(1)`` in
   the group: one step of each sharded path with ``__graft_entry__.py``'s
   checks; K and G must launch.

Then one JSON line on the kernels (at N=8,192, Q=10: times, bound, share
of bound, launches on the main path and, under ``launches_by_path``, on
each EDR path (main_path, notebooks, sparse_edr, sparse_refit,
svgp_stream, svgp_edr, cls_ep_edr, cls_sparse_edr, het_edr), on entry,
each sampler path (nuts_gp, smc_gp, bayes_edr) and sharded path
(sharded_nlml, sharded_edr, surface, sharded_svgp, sharded_samplers,
dryrun_multichip);
``library_ms`` is null because no single PyTorch call computes
any of the three functions), the ``nvidia-smi`` name and power limit, and
last ``{"ok": true, "device": {...}}``, printed only when every phase
passed.  Any failure raises and exits non-zero; so does a machine without
CUDA.  The script imports nothing of JAX; the process group it joins is
destroyed before the last lines.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
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


T0 = time.perf_counter()


def emit(**fields):
    """Print one phase's line, with the script's seconds so far."""
    fields["elapsed_s"] = time.perf_counter() - T0
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
    # The sharded phases at the end run in a one-rank NCCL group, joined
    # just before them so that no earlier phase runs beside its threads.
    emit(phase="device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=_build.nvcc_path(), process_group=dict(
             backend="nccl", world_size=1,
             nccl_version=".".join(map(str, torch.cuda.nccl.version())),
             joined_before="sharded_nlml"))
    return smi


def phase_build():
    from edrgp_tpu_torch import data
    from edrgp_tpu_torch.ops.cuda import _build
    t0 = time.perf_counter()
    _build.load()
    regs = [line.split(":", 1)[1].strip()
            for line in _build.build_log.splitlines() if "Used" in line]
    seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    loader = data.build_native()
    emit(phase="build", seconds=seconds, library=str(_build.library_path()),
         ptxas=regs, loader_seconds=time.perf_counter() - t0,
         loader_library=str(loader))


def _kernel_case(name, rows, cols, Q, gen, chains=None):
    """(kernel call, plain call) on random inputs of the given shape; with
    ``chains``, K and A on a chain batch (a leading axis, ℓ and σ² one per
    chain), as the samplers' NLML calls them."""
    import torch
    from edrgp_tpu_torch.ops.cuda import rbf
    dev = "cuda"
    lead = () if chains is None else (chains,)
    ls = 0.5 * math.sqrt(Q) * (1.0 + torch.rand(*lead, Q, generator=gen,
                                                device=dev))
    s2 = 1.3 + 0.2 * torch.rand(lead, generator=gen, device=dev)
    if chains is not None:
        X = torch.randn(chains, rows, Q, generator=gen, device=dev)
        if name == "rbf_kernel_matrix":
            Xs = X / ls[:, None, :]
            return (lambda: rbf.rbf_kernel_matrix(Xs, Xs, s2),
                    lambda: rbf.rbf_kernel_matrix_plain(Xs, Xs, s2))
        W = torch.randn(chains, rows, rows, generator=gen, device=dev)
        W = 0.5 * (W + W.mT)
        return (lambda: rbf.rbf_nlml_adjoint(X, W, ls, s2),
                lambda: rbf.rbf_nlml_adjoint_plain(X, W, ls, s2))
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
    the tall shapes of sparse models' gradients (M=102,400 by N=8,192,
    M=1,048,576 by N=512: one column split, at each Q of svgp_edr's fits),
    the sparse paths' shapes (G at 100,000 rows by 512 inducing inputs at
    the sgpr phase's Q=8 and at each Q of sparse_edr's fits; K(Z, X*) at
    512 by 2,000 in the last fit's Q=3 and at 512 by 4,000 in svgp_stream's
    Q=8), each kernel at N=8,191 (N % 4 != 0: 4-byte stores for K,
    4-byte cp.async loads instead of TMA for A), and the classifiers'
    shapes: K and G at 4,096² at each Q of cls_ep_edr's fits (its site
    loops' and caches' K(X, X) and its gradients), K(X, X*) at 4,096 by
    4,000 and K(Z, X*) at 512 by 4,000 in Q=3 (their held-out
    predictions), the EP-DTC fit's K(Z, X) at 512 by 100,000 (its site
    loops and cache) and K(Z, X*) at 512 by 4,000 (its predictions), both
    in Q=10; het_edr runs at main_path's 8,192² shapes.  The samplers'
    shapes: K and A at N=1,024 in Q=4 (nuts_gp, smc_gp) and Q=10
    (bayes_edr's first fit), one chain and a batch of 16 chains (nuts_gp's
    group; a 4-tuple names the chains), and 64 (smc_gp's particle chunk)
    in Q=4; G at 1,024² in each Q of bayes_edr's fits and K(X, X*) at
    1,024 by 2,000 in its last Q=3 (its per-sample predictions).  The
    sharded paths: K's slab of one rank at sharded_nlml's N=10,000, Q=8
    (the whole matrix at one rank); sharded_edr's slabs and G at
    1,048,576 by 512 are shapes above.  The notebook workloads: K, A and G
    at N=500 in Q = 3, 2 (the chain-PCA and regression fits) and K and A
    in Q=1 (their reduced fits), at N=200 in Q = 10, 2 (BriefIntro's first
    and last); entry's K and A at 2,048² in Q=8; sparse_refit's last fit,
    G at 100,000 by 512 and K(Z, X*) at 512 by 2,000 in Q=2; the dry
    run's K at 16² in Q=3 and G at 8² in Q = 4, 2; surface's chunks of
    sparse_edr's last model, G at 8,192 and at the last 1,696 of its
    100,000 rows by 512 in Q=3 (its sharded call is main_path's 8,192²
    in Q=3, above)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    qs = (10, 7, 4, 3)
    fits = [(8192, 8192, Q) for Q in qs]
    ep_fits = [(4096, 4096, Q) for Q in qs]
    chains = [(1024, 1024, 4), (1024, 1024, 10), (1024, 1024, 4, 16),
              (1024, 1024, 10, 16), (1024, 1024, 4, 64)]
    notebooks = [(500, 500, 3), (500, 500, 2), (200, 200, 10),
                 (200, 200, 2)]
    shapes = {
        "rbf_kernel_matrix": [(1000, 1537, 10), *fits, (8192, 2000, 3),
                              (8191, 8191, 10), (512, 2000, 3),
                              (512, 4000, 8), *ep_fits, (4096, 4000, 3),
                              (512, 4000, 3), (512, 100000, 10),
                              (512, 4000, 10), *chains, (1024, 2000, 3),
                              (10000, 10000, 8), *notebooks, (500, 500, 1),
                              (2048, 2048, 8), (512, 2000, 2), (16, 16, 3)],
        "rbf_grad_mu": [(1000, 1537, 10), *fits, *ep_fits, (8191, 8191, 10),
                        (102400, 8192, 10),
                        *[(1048576, 512, Q) for Q in qs],
                        (100000, 512, 8),
                        *[(100000, 512, Q) for Q in qs],
                        *[(1024, 1024, Q) for Q in qs], *notebooks,
                        (100000, 512, 2), (8, 8, 4), (8, 8, 2),
                        (8192, 512, 3), (1696, 512, 3)],
        "rbf_nlml_adjoint": [(1537, 1537, 10), *fits, (8191, 8191, 10),
                             *chains, *notebooks, (500, 500, 1),
                             (2048, 2048, 8)],
    }
    summary = {}
    for name, cases in shapes.items():
        worst = 0.0
        for rows, cols, Q, *batch in cases:
            C = batch[0] if batch else None
            kernel, plain = _kernel_case(name, rows, cols, Q, gen, C)
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
            bound_ms *= C or 1
            emit(phase="kernels", kernel=name, rows=rows, cols=cols, Q=Q,
                 chains=C, max_abs_err=err, rel_err=rel, limit=LIMITS[name],
                 ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                 resource=resource, share_of_bound=bound_ms / ms,
                 bitwise_repeat=bitwise)
            shape = (rows, cols, Q, *batch)
            check(rel <= LIMITS[name], f"{name} at {shape}: "
                  f"relative error {rel:.3g} > {LIMITS[name]}")
            check(bitwise, f"{name} at {shape}: two launches on "
                  "the same inputs differ")
            worst = max(worst, err)
            if (rows, cols, Q) == MAIN_SHAPE and C is None:
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


def phase_kinv(device="cuda", N=8192, Q=10):
    """Ky⁻¹ at N=8,192 by the NLML adjoint's blocked path against its bound
    and ``torch.cholesky_inverse``; every evaluation of a fit there takes
    the blocked path."""
    import torch
    from edrgp_tpu_torch.datasets import get_beta_inputs, get_edr_target
    from edrgp_tpu_torch.models.state import ExactGPModel
    from edrgp_tpu_torch.ops import exact, linalg
    from edrgp_tpu_torch.ops.kernels import RBF
    rng = np.random.default_rng(0)
    X = get_beta_inputs(N, Q, rng=rng)
    B = np.linalg.qr(rng.normal(size=(Q, 3)))[0]
    y = get_edr_target(X @ B, sigma=0.1, rng=rng)
    m = ExactGPModel(X, y, RBF(Q, ARD=True), device=device)
    with torch.no_grad():
        L = linalg.cholesky_once(exact._Ky(m, m._X))
    b = linalg.KINV_BLOCK

    def blocked():
        return linalg._mirror_upper(linalg._sym_square_upper(
            linalg._tri_inv(L, b), b), b)

    def library():
        return torch.cholesky_inverse(L)

    want = torch.cholesky_inverse(L.double())
    scale = float(want.abs().max())
    got = blocked()
    err = float((got.double() - want).abs().max()) / scale
    lib_err = float((library().double() - want).abs().max()) / scale
    symmetric = bool(torch.equal(got, got.mT))
    del got
    ms = cuda_ms(blocked, 5)
    lib_ms = cuda_ms(library, 5)
    bound_ms = 2 * N ** 3 / 3 / FP32_FLOPS_PER_MS
    before = dict(linalg.KINV_FORMED)
    with count_calls(exact, "nlml",
                     keep=lambda v: v.requires_grad) as calls:
        m.optimize(max_iters=5, num_restarts=1)
    formed = {k: linalg.KINV_FORMED[k] - before[k] for k in before}
    evals = sum(1 for grad, _ in calls if grad)
    emit(phase="kinv", N=N, Q=Q, block=b, ms=ms, bound_ms=bound_ms,
         share_of_bound=bound_ms / ms, library="torch.cholesky_inverse",
         library_ms=lib_ms, max_rel_err=err, library_max_rel_err=lib_err,
         symmetric=symmetric, fit_evaluations=evals, kinv_formed=formed)
    check(err < 1e-4, f"blocked Ky⁻¹ off by {err:.3g} of its largest entry")
    check(symmetric, "blocked Ky⁻¹ is not exactly symmetric")
    check(evals >= 1 and formed == {"blocked": evals, "single_block": 0},
          f"{evals} evaluations, Ky⁻¹ formed {formed}")
    del m, L, want
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
    return (launches, edr.components_.T,
            (_stash(model, "main_path"), edr._first_gradients_))


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


ROOT = os.path.dirname(os.path.abspath(__file__))


def _peak_gb(device, reset=False):
    """Peak device memory in GB since the last reset (None on the CPU)."""
    import torch
    if torch.device(device).type != "cuda":
        return None
    if reset:
        torch.cuda.reset_peak_memory_stats()
    return torch.cuda.max_memory_allocated() / 1e9


@contextlib.contextmanager
def count_calls(module, name, keep=None):
    """Record each call of ``module.name`` made inside the block (the
    models look it up there at each evaluation): a list with one
    (``keep(result)`` or None, host ms) per call."""
    fn = getattr(module, name)
    calls = []

    def counted(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        calls.append((keep(out) if keep else None,
                      1e3 * (time.perf_counter() - t0)))
        return out

    setattr(module, name, counted)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def _profiled(fn, reps=1):
    """Run ``fn`` ``reps`` times under torch.profiler with the host clock
    around the runs: (the CPU-side events, wall ms per run, device busy ms
    per run: the time of the kernels those events launched)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    cpu_ops = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    busy = sum(k.duration for e in cpu_ops for k in e.kernels) / 1e3
    return cpu_ops, wall / reps, busy / reps


def _stash(model, name):
    """Pickle ``model`` under the checkout's git-ignored ``build/`` for a
    later phase; returns the path."""
    scratch = os.path.join(ROOT, "build")
    os.makedirs(scratch, exist_ok=True)
    path = os.path.join(scratch, f"{name}-{os.getpid()}.pickle")
    model.pickle(path)
    return path


def _sgpr_problem(n, q, rng):
    """BASELINE config 3's data (``benchmarks/baseline_scale_tpu.py:29-34``):
    X uniform on [−3, 3], f = sin x₀·cos x₁ + 0.5·tanh x₂, noise 0.1."""
    X = rng.uniform(-3, 3, size=(n, q)).astype(np.float32)
    f = np.sin(X[:, 0]) * np.cos(X[:, 1]) + 0.5 * np.tanh(X[:, 2])
    y = (f + 0.1 * rng.normal(size=n)).astype(np.float32)
    return X, y, f


def _save_load_bitwise(model, Xs, device):
    """Whether a pickle round trip (in a scratch directory under the
    checkout's git-ignored ``build/``) predicts the same bits at Xs."""
    from edrgp_tpu_torch.models.state import load_model
    scratch = os.path.join(ROOT, "build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as d:
        path = os.path.join(d, "model.pickle")
        model.pickle(path)
        loaded = load_model(path, device=device)
    return all(np.array_equal(a, b) for a, b in
               zip(model.predict(Xs), loaded.predict(Xs)))


def phase_sgpr(device="cuda", N=100_000, M=512, Q=8, max_iters=200):
    """BASELINE config 3: Titsias SGPR, 512 inducing inputs, N=100k."""
    import torch
    from edrgp_tpu_torch.models.state import SGPRModel
    from edrgp_tpu_torch.ops import sgpr
    from edrgp_tpu_torch.ops.cuda import rbf
    from edrgp_tpu_torch.ops.kernels import RBF
    rng = np.random.default_rng(0)
    X, y, f = _sgpr_problem(N, Q, rng)
    _peak_gb(device, reset=True)
    rbf.reset_launches()
    with count_calls(sgpr, "elbo") as evals:
        t0 = time.perf_counter()
        model = SGPRModel(X, y, RBF(Q, ARD=True), num_inducing=M, seed=0,
                          device=device)
        model.optimize(max_iters=max_iters)
        fit_s = time.perf_counter() - t0
    fit_launches = dict(rbf.LAUNCHES)
    idx = np.sort(rng.integers(0, N, 4000))
    pred, var = model.predict(X[idx])
    rmse = float(np.sqrt(np.mean((pred[:, 0] - f[idx]) ** 2)))
    rbf.reset_launches()
    t0 = time.perf_counter()
    dmu, dvar = model.predictive_gradients(X)
    grad_ms = 1e3 * (time.perf_counter() - t0)
    grad_launches = dict(rbf.LAUNCHES)
    peak = _peak_gb(device)
    bitwise = _save_load_bitwise(model, X[idx], device)
    emit(phase="sgpr", N=N, Q=Q, num_inducing=M, max_iters=max_iters,
         fit_seconds=fit_s, elbo_evaluations=len(evals),
         elbo=float(model.log_likelihood()[0][0]), rmse_vs_truth=rmse,
         noise_std_truth=0.1, mean_pred_std=float(np.sqrt(var).mean()),
         gradients_ms=grad_ms, launches_fit=fit_launches,
         launches_gradients=grad_launches, save_load_bitwise=bitwise,
         hyperparameters={k: np.asarray(v).tolist() for k, v in
                          model.get_hyperparameters().items() if k != "['Z']"},
         peak_mem_gb=peak)
    check(np.isfinite(pred).all() and np.isfinite(dmu).all()
          and np.isfinite(dvar).all() and dmu.shape == (N, Q, 1),
          "bad SGPR predictions or gradients")
    check(rmse < 0.05, f"SGPR RMSE vs truth {rmse:.4g} >= 0.05")
    check(grad_launches["rbf_grad_mu"] == 1,
          f"G did not serve the SGPR gradients: {grad_launches}")
    check(bitwise, "SGPR save/load changed the predictions")
    profile_sgpr_elbo(model)
    del model
    torch.cuda.empty_cache()
    phase_sgpr_reference(device)
    phase_sgpr_uncertain_reference(device)
    phase_sgpr_uncertain(device)


def profile_sgpr_elbo(model, reps=3):
    """torch.profiler split of one ELBO value+grad: device time of the
    kernels launched under each of ``ops/sgpr.py``'s labels, the rest of
    the forward, and the backward (all device time outside the forward)."""
    from torch.profiler import record_function
    from edrgp_tpu_torch.ops import sgpr

    def step():
        model.zero_grad()
        with record_function("elbo.forward"):
            loss = -sgpr.elbo(model, model._X, model._y)
        loss.backward()

    ms = cuda_ms(step, reps)
    cpu_ops, _, busy = _profiled(step, reps)
    split = {}
    for e in cpu_ops:
        if e.name.startswith("sgpr.") or e.name == "elbo.forward":
            split[e.name] = (split.get(e.name, 0.0)
                             + e.device_time_total / reps / 1e3)
    forward = split.pop("elbo.forward", 0.0)
    split["forward_other"] = forward - sum(split.values())
    split["backward"] = busy - forward
    emit(phase="sgpr_profile", N=model._X.shape[0], M=model.Z.shape[0],
         Q=model._X.shape[1], ms_per_eval=ms, device_busy_ms=busy,
         idle_share=1.0 - busy / ms if ms else None,
         profile_has_device_time=busy > 0, split_ms=split)


#: Starting lengthscale of the small sparse fits.  At the default 1.0 in
#: Q=8 on [−3, 3]⁸ two points lie ~7 lengthscales apart, the kernel is
#: ~e⁻²⁴ between them, and a short fit from there ends at the noise-only
#: optimum (signal variance → 0), where a comparison sees no kernel.
SIGNAL_LENGTHSCALE = 2.0


def phase_sgpr_reference(device="cuda", N=2000, M=64, Q=8):
    """SGPR on the card (float32) against the port's CPU float64 model at
    the card fit's parameters (a fit that keeps the signal)."""
    from edrgp_tpu_torch.models.state import SGPRModel
    from edrgp_tpu_torch.ops.cuda import rbf
    from edrgp_tpu_torch.ops.kernels import RBF
    X, y, f = _sgpr_problem(N, Q, np.random.default_rng(1))
    card = SGPRModel(X, y, RBF(Q, ARD=True, lengthscale=SIGNAL_LENGTHSCALE),
                     num_inducing=M, seed=0, device=device)
    card.optimize(max_iters=100, num_restarts=1)
    cpu = SGPRModel(X, y, RBF(Q, ARD=True), num_inducing=M, seed=0,
                    device="cpu")
    cpu.load_state_dict(card.state_dict())
    elbo_card = float(card.log_likelihood()[0][0])
    elbo_cpu = float(cpu.log_likelihood()[0][0])
    rbf.reset_launches()
    dmu_card = card.predictive_gradients(X)[0][:, :, 0]
    launches = dict(rbf.LAUNCHES)
    dmu_cpu = cpu.predictive_gradients(X)[0][:, :, 0]
    elbo_rel = abs(elbo_card - elbo_cpu) / abs(elbo_cpu)
    dmu_rel = float(np.abs(dmu_card - dmu_cpu).max() / np.abs(dmu_cpu).max())
    rmse = float(np.sqrt(np.mean((card.predict(X)[0][:, 0] - f) ** 2)))
    emit(phase="sgpr_reference", N=N, M=M, Q=Q, elbo_card=elbo_card,
         elbo_cpu_f64=elbo_cpu, elbo_rel_diff=elbo_rel,
         dmu_rel_diff=dmu_rel, launches=launches, rmse_vs_truth=rmse,
         signal_variance=card.get_hyperparameters()["['kernel']['variance']"])
    check(elbo_rel < 1e-4, f"card ELBO differs by {elbo_rel:.3g}")
    check(dmu_rel < 1e-4, f"card dμ/dx* differs by {dmu_rel:.3g}")
    check(launches["rbf_grad_mu"] >= 1, f"G did not launch: {launches}")


def phase_sgpr_uncertain_reference(device="cuda", N=5000, M=128, Q=8,
                                   limit_bound=1e-4, limit_grad=1e-3):
    """The uncertain-input bound (``X_variance=0.01``) and its gradients in
    every parameter on the card (float32) against the port's CPU float64
    at the same fixed parameters (ℓ = SIGNAL_LENGTHSCALE, σ² = 1,
    σₙ² = 0.05, the seeded Z); N is past one Psi2 chunk, so the chunked,
    checkpointed sum runs in both directions.  Limits: the bound to 1e-4
    relative, each parameter's gradient to 1e-3 of its largest entry."""
    import torch
    from edrgp_tpu_torch.models.state import SGPRModel
    from edrgp_tpu_torch.ops.exact import grad_batch_size
    from edrgp_tpu_torch.ops.kernels import RBF
    X, y, _ = _sgpr_problem(N, Q, np.random.default_rng(3))
    out = []
    for dev, dtype in ((device, torch.float32), ("cpu", torch.float64)):
        m = SGPRModel(X, y, RBF(Q, ARD=True, lengthscale=SIGNAL_LENGTHSCALE),
                      num_inducing=M, seed=0, X_variance=0.01, noise_var=0.05,
                      device=dev, dtype=dtype)
        m.zero_grad()
        loss = m._objective_fn()()
        loss.backward()
        out.append((-float(loss.detach()),
                    {n: p.grad.detach().cpu().double().numpy()
                     for n, p in m.named_parameters()}))
    (b_card, g_card), (b_cpu, g_cpu) = out
    bound_rel = abs(b_card - b_cpu) / abs(b_cpu)
    grad_rel = {n: float(np.abs(g_card[n] - g_cpu[n]).max()
                         / np.abs(g_cpu[n]).max()) for n in g_cpu}
    chunk = grad_batch_size(N, M * M)
    emit(phase="sgpr_uncertain_reference", N=N, M=M, Q=Q,
         psi2_chunks=-(-N // chunk), bound_card=b_card, bound_cpu_f64=b_cpu,
         bound_rel_diff=bound_rel, grad_rel_diff=grad_rel,
         limits={"bound": limit_bound, "grad": limit_grad})
    check(N > chunk, "the reference does not cross a Psi2 chunk")
    check(bound_rel < limit_bound,
          f"card uncertain bound differs by {bound_rel:.3g}")
    for n, rel in grad_rel.items():
        check(rel < limit_grad,
              f"card uncertain-bound gradient in {n} differs by {rel:.3g}")


def phase_sgpr_uncertain(device="cuda", N=8192, M=128, Q=8, max_iters=50):
    """An uncertain-input SGPR fit (X_variance=0.01) from a lengthscale that
    keeps the signal: the psi statistics' [N, M, M] terms are summed in
    chunks; the peak memory shows it.  The CPU float64 bound at the card
    fit's parameters shows how far float32 rounding moved the bound the
    fit climbed."""
    import torch
    from edrgp_tpu_torch.models.state import SGPRModel
    from edrgp_tpu_torch.ops.exact import grad_batch_size
    from edrgp_tpu_torch.ops.kernels import RBF
    X, y, f = _sgpr_problem(N, Q, np.random.default_rng(2))
    _peak_gb(device, reset=True)
    t0 = time.perf_counter()
    model = SGPRModel(X, y, RBF(Q, ARD=True, lengthscale=SIGNAL_LENGTHSCALE),
                      num_inducing=M, seed=0, X_variance=0.01, device=device)
    model.optimize(max_iters=max_iters)
    fit_s = time.perf_counter() - t0
    peak = _peak_gb(device)
    bound = float(model.log_likelihood()[0][0])
    pred = model.predict(X[:2000])[0][:, 0]
    cpu = SGPRModel(X, y, RBF(Q, ARD=True), num_inducing=M, seed=0,
                    X_variance=0.01, device="cpu", dtype=torch.float64)
    cpu.load_state_dict(model.state_dict())
    bound_cpu = float(cpu.log_likelihood()[0][0])
    emit(phase="sgpr_uncertain", N=N, M=M, Q=Q, max_iters=max_iters,
         fit_seconds=fit_s, elbo=bound, elbo_cpu_f64_at_fit=bound_cpu,
         elbo_rel_diff=abs(bound - bound_cpu) / abs(bound_cpu),
         rmse_vs_truth=float(np.sqrt(np.mean((pred - f[:2000]) ** 2))),
         hyperparameters={k: np.asarray(v).tolist() for k, v in
                          model.get_hyperparameters().items() if k != "['Z']"},
         psi2_chunk_rows=grad_batch_size(N, M * M),
         psi2_terms_gb_unchunked=N * M * M * 4 / 1e9, peak_mem_gb=peak)
    check(math.isfinite(bound), "non-finite uncertain-input bound")
    del model
    torch.cuda.empty_cache()


def phase_sparse_edr(device="cuda", N=100_000, max_iters=200):
    """The slice's main path: EDR over the sparse regressor at N=100k."""
    import torch
    from edrgp_tpu_torch import (EffectiveDimensionalityReduction,
                                 SVDTransformer, discrepancy)
    from edrgp_tpu_torch.datasets import get_beta_inputs, get_edr_target
    from edrgp_tpu_torch.models import SparseGaussianProcessRegressor
    from edrgp_tpu_torch.ops import sgpr
    from edrgp_tpu_torch.ops.cuda import rbf
    Q, D = 10, 3
    rng = np.random.default_rng(0)
    X = get_beta_inputs(N, Q, rng=rng)
    B = np.linalg.qr(rng.normal(size=(Q, D)))[0]
    y = get_edr_target(X @ B, sigma=0.1, rng=rng)
    X_test = get_beta_inputs(2000, Q, rng=rng)
    y_test = get_edr_target(X_test @ B)

    _peak_gb(device, reset=True)
    rbf.reset_launches()
    with count_calls(sgpr, "elbo") as evals:
        t0 = time.perf_counter()
        edr = EffectiveDimensionalityReduction(
            SparseGaussianProcessRegressor(
                kernels="RBF", kernel_options={"ARD": True},
                num_inducing=512, device=device),
            SVDTransformer(), n_components=D).fit(X, y, max_iters=max_iters)
        fit_s = time.perf_counter() - t0
    pred = edr.estimator_.predict(edr._preprocessing_transform(X_test))
    launches = dict(rbf.LAUNCHES)

    disc = discrepancy(B, edr.components_.T)
    rmse = float(np.sqrt(np.mean((pred - y_test) ** 2)))
    emit(phase="sparse_edr", N=N, Q=Q, num_inducing=512, n_components=D,
         max_iters=max_iters, fit_seconds=fit_s, elbo_evaluations=len(evals),
         discrepancy=disc,
         principal_angles_deg=principal_angles_deg(
             B, edr.components_.T).tolist(),
         heldout_rmse=rmse, heldout_y_std=float(np.std(y_test)),
         launches=launches, peak_mem_gb=_peak_gb(device))
    check(launches["rbf_grad_mu"] >= 1 and launches["rbf_kernel_matrix"] >= 1,
          f"G or K did not launch on the sparse EDR path: {launches}")
    check(edr.components_.shape == (D, Q)
          and np.isfinite(edr.components_).all(), "bad components")
    check(np.isfinite(pred).all() and pred.shape == y_test.shape,
          "bad predictions")
    check(disc < 0.1, f"sparse EDR discrepancy {disc:.3g} >= 0.1")
    path = _stash(edr.estimator_.estimator_, "sparse_edr")
    del edr
    torch.cuda.empty_cache()
    return launches, path


#: The reference's notebook workloads whose card and CPU float64 subspaces
#: are reported, not held to agree: chain-PCA's uncorrelated inputs with
#: the PCA preprocessor drop a noise-driven principal direction (per-seed
#: std 0.32 nats in ``tests/parity_baseline.json``); BriefIntro's
#: iterative EDR refits 8 times, and from its 9-D round on a float32 ML-II
#: stops at |g| ~ 0.1 on the float32 NLML's rounding, 0.08 nats above the
#: float64 optimum (flat lengthscales of dropped inputs), so the rounds
#: part ways (card against CPU 0.04, each 0.11–0.12 from the planted B).
NOTEBOOK_REPORT_ONLY = ("chain_pca_uncorr_preprocessed",
                        "brief_intro_iterative")
#: SparsePCA's α for the refit at N=100,000: the lasso's data term grows
#: as √N (unit atoms of length N), and on the CPU (sparse EDR at N=20,000,
#: α scaled by √N) every α in [1, 100] at N=100,000 zeroes at least
#: B_sparse's 13 entries at discrepancy < 0.01; 10 is the middle.
SPARSE_REFIT_ALPHA = 10.0
# The one-shot EDR (Q=10, then the last fit at Q=3: two fits, not four)
# of the phases whose fits take the script's time (PERF.md §4): svgp_edr's
# class pipeline, the classifiers' EDRs and bayes_edr.
EDR_STEP = 7


def _b_sparse():
    """BriefIntro's sparse projector (cell 60; ``benchmarks/parity_runs.py
    :190-191``)."""
    import scipy.sparse
    return np.linalg.qr(scipy.sparse.random(
        10, 2, density=0.2, random_state=11).toarray())[0]


def _notebook_runs(device, restarts=5):
    """The reference's notebook workloads, defined as in
    ``benchmarks/parity_runs.py:150-259``, seed 0, through the port's own
    PCA and SparsePCA on ``device``: {name: (components [k, Q], planted
    subspace [Q, d])}.  Every ML-II fit takes ``restarts`` starts (the
    float32 default, so that a float64 run searches the same basins)."""
    from scipy.linalg import eigh
    from edrgp_tpu_torch import (EffectiveDimensionalityReduction as EDR,
                                 SVDTransformer)
    from edrgp_tpu_torch.datasets import (get_beta_inputs, get_edr_target,
                                          get_gaussian_inputs,
                                          get_tanh_targets)
    from edrgp_tpu_torch.decomposition import PCA, SparsePCA
    from edrgp_tpu_torch.models import GaussianProcessRegressor

    def gpr(ard=False):
        if ard:
            return GaussianProcessRegressor(["RBF"], [{"ARD": True}],
                                            device=device)
        return GaussianProcessRegressor(device=device)

    fit = {"num_restarts": restarts}
    out = {}
    # regression.ipynb: PCA as the DR method
    rng = np.random.default_rng(0)
    X = get_gaussian_inputs(eig_values=[1, 0.3], sample_size=500,
                            eig_vectors=np.array([[1, 1], [-1, 1]]), rng=rng)
    X -= X.mean(0)
    y = get_tanh_targets(X, [0.5, 0.5], rng=rng)
    edr = EDR(gpr(), PCA(n_components=1), n_components=1).fit(X, y, **fit)
    out["regression"] = (edr.components_, np.ones((2, 1)) / math.sqrt(2))

    # BriefIntro.ipynb: one-shot, iterative step=1, the sparse projector
    rng = np.random.default_rng(0)
    X = get_beta_inputs(200, 10, rng=rng)
    B = np.linalg.qr(rng.normal(size=(10, 2)))[0]
    y = get_edr_target(X @ B, sigma=0.1, rng=rng)
    edr = EDR(gpr(True), SVDTransformer(), normalize=False).fit(X, y, **fit)
    out["brief_intro_one_shot"] = (edr.components_[:2], B)
    edr = EDR(gpr(True), SVDTransformer(), n_components=2, step=1,
              normalize=False).fit(X, y, **fit)
    out["brief_intro_iterative"] = (edr.components_, B)
    B_sparse = _b_sparse()
    rng = np.random.default_rng(0)
    X = get_beta_inputs(200, 10, rng=rng)
    y = get_edr_target(X @ B_sparse, sigma=0.1, rng=rng)
    edr = EDR(gpr(True), SVDTransformer(), normalize=False).fit(X, y, **fit)
    out["brief_intro_sparse"] = (edr.components_[:2], B_sparse)
    edr.refit(SparsePCA(n_components=2, alpha=2, random_state=0))
    out["brief_intro_refit"] = (edr.refit_components_, B_sparse)

    # chain_PCA-EDRGP.ipynb: raw and with the PCA preprocessor
    covs = {"corr": [[1, 0.9, 0.01], [0.9, 1, -0.1], [0.01, -0.1, 1]],
            "uncorr": [[1, 0.07, 0.03], [0.07, 1, -0.1], [0.03, -0.1, 1]]}
    for name, cov in covs.items():
        rng = np.random.default_rng(0)
        w, v = eigh(np.array(cov))
        X = get_gaussian_inputs(eig_values=w, sample_size=500,
                                eig_vectors=v, rng=rng)
        X -= X.mean(0)
        y = get_tanh_targets(X, 0.5 * np.ones(3), rng=rng)
        for label, pre in (("raw", None),
                           ("preprocessed", PCA(n_components=2))):
            edr = EDR(gpr(), SVDTransformer(), n_components=1,
                      preprocessor=pre).fit(X, y, **fit)
            out[f"chain_pca_{name}_{label}"] = (edr.components_,
                                                np.ones((3, 1)) / math.sqrt(3))
    return out


def _notebook_reference(queue):
    """The notebook workloads' CPU float64 run with its wall seconds, put on
    ``queue`` as (True, runs, seconds), or (False, traceback, None); run in
    a process of its own, on 4 threads."""
    import traceback
    import torch
    torch.set_num_threads(4)
    try:
        t0 = time.perf_counter()
        out = _notebook_runs("cpu")
        queue.put((True, out, time.perf_counter() - t0))
    except Exception:
        queue.put((False, traceback.format_exc(), None))


def phase_notebooks(device="cuda"):
    """The reference's notebook workloads on the card (float32) against the
    port's CPU float64 run of the same seed: each subspace within
    discrepancy 1e-2 (but ``NOTEBOOK_REPORT_ONLY``), the sparse refit with
    the same zero pattern and within 1e-2 entrywise; each workload's
    discrepancy to its planted direction printed.

    The CPU run takes a daemon process of its own (spawned), started here,
    so that it runs beside the card's phases; the card's runs happen here,
    and the returned ``finish()`` waits for the CPU run, holds the card's
    against it, prints the phase's line and returns its launches."""
    import multiprocessing
    import queue as _queue
    from edrgp_tpu_torch.ops.cuda import rbf
    from edrgp_tpu_torch.utils import _span, discrepancy
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    proc = ctx.Process(target=_notebook_reference, args=(results,),
                       daemon=True)
    proc.start()
    rbf.reset_launches()
    t0 = time.perf_counter()
    card = _notebook_runs(device)
    card_s = time.perf_counter() - t0
    launches = dict(rbf.LAUNCHES)

    def finish():
        t0 = time.perf_counter()
        while True:
            try:
                ok, ref, cpu_s = results.get(timeout=5)
                break
            except _queue.Empty:
                check(proc.is_alive(), "the notebooks' CPU run died")
        proc.join(timeout=60)
        check(ok, f"the notebooks' CPU run failed:\n{ref}")
        rows = {}
        for name, (comps, planted) in card.items():
            rows[name] = {
                "vs_cpu": discrepancy(_span(ref[name][0].T), comps.T),
                "to_planted": discrepancy(planted, comps.T),
                "to_planted_cpu": discrepancy(planted, ref[name][0].T)}
        refit = card["brief_intro_refit"][0]
        refit_cpu = ref["brief_intro_refit"][0]
        same_zeros = (refit.shape == refit_cpu.shape
                      and bool(np.all((refit == 0) == (refit_cpu == 0))))
        refit_err = (float(np.abs(refit - refit_cpu).max()) if same_zeros
                     else float("inf"))
        emit(phase="notebooks", seconds=card_s, cpu_float64_seconds=cpu_s,
             waited_seconds=time.perf_counter() - t0, workloads=rows,
             refit_zeros=int((refit == 0).sum()),
             refit_same_zero_pattern=same_zeros,
             refit_max_abs_vs_cpu=refit_err, launches=launches)
        check(all(v >= 1 for v in launches.values()),
              f"a kernel did not launch in the notebook workloads: {launches}")
        for name, row in rows.items():
            if name not in NOTEBOOK_REPORT_ONLY:
                check(row["vs_cpu"] < 1e-2, f"{name}: card and CPU subspaces "
                      f"differ: {row['vs_cpu']:.3g}")
        check(same_zeros, "the card's sparse refit has another zero pattern")
        check(refit_err < 1e-2, f"sparse refit differs from the CPU's by "
              f"{refit_err:.3g}")
        return launches

    return finish


def phase_sparse_refit(device="cuda", N=100_000, M=512, max_iters=200,
                       alpha=SPARSE_REFIT_ALPHA):
    """The sparse regressor's EDR at N=100,000, Q=10 on BriefIntro's sparse
    projector, then ``refit(SparsePCA(alpha))`` on its cached gradients:
    both discrepancies < 0.1, at least B_sparse's exact zeros; fit seconds,
    the refit's host seconds and iterations."""
    import torch
    from edrgp_tpu_torch import (EffectiveDimensionalityReduction,
                                 SVDTransformer, discrepancy)
    from edrgp_tpu_torch.datasets import get_beta_inputs, get_edr_target
    from edrgp_tpu_torch.decomposition import SparsePCA
    from edrgp_tpu_torch.models import SparseGaussianProcessRegressor
    from edrgp_tpu_torch.ops.cuda import rbf
    Q, B_sparse = 10, _b_sparse()
    rng = np.random.default_rng(0)
    X = get_beta_inputs(N, Q, rng=rng)
    y = get_edr_target(X @ B_sparse, sigma=0.1, rng=rng)
    X_test = get_beta_inputs(2000, Q, rng=rng)
    y_test = get_edr_target(X_test @ B_sparse)

    _peak_gb(device, reset=True)
    rbf.reset_launches()
    t0 = time.perf_counter()
    edr = EffectiveDimensionalityReduction(
        SparseGaussianProcessRegressor(
            kernels="RBF", kernel_options={"ARD": True}, num_inducing=M,
            device=device),
        SVDTransformer(), n_components=2).fit(X, y, max_iters=max_iters)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    edr.refit(SparsePCA(n_components=2, alpha=alpha, random_state=0))
    refit_s = time.perf_counter() - t0
    pred = edr.estimator_.predict(edr._preprocessing_transform(X_test))
    launches = dict(rbf.LAUNCHES)

    svd_disc = discrepancy(B_sparse, edr.components_.T)
    comps = edr.refit_components_
    refit_disc = discrepancy(B_sparse, comps.T)
    zeros, b_zeros = int((comps == 0).sum()), int((B_sparse == 0).sum())
    rmse = float(np.sqrt(np.mean((pred - y_test) ** 2)))
    emit(phase="sparse_refit", N=N, Q=Q, num_inducing=M, alpha=alpha,
         fit_seconds=fit_s, refit_host_seconds=refit_s,
         refit_n_iter=int(edr.refit_transformer_.n_iter_),
         svd_discrepancy=svd_disc, refit_discrepancy=refit_disc,
         refit_zeros=zeros, b_sparse_zeros=b_zeros,
         refit_components=comps.tolist(), heldout_rmse=rmse,
         heldout_y_std=float(np.std(y_test)), launches=launches,
         peak_mem_gb=_peak_gb(device))
    check(launches["rbf_grad_mu"] >= 1 and launches["rbf_kernel_matrix"] >= 1,
          f"G or K did not launch on the sparse refit path: {launches}")
    check(np.isfinite(pred).all(), "bad predictions")
    check(svd_disc < 0.1, f"sparse EDR discrepancy {svd_disc:.3g} >= 0.1")
    check(comps.shape == (2, Q) and np.isfinite(comps).all(),
          f"bad refit components {comps.shape}")
    check(refit_disc < 0.1, f"refit discrepancy {refit_disc:.3g} >= 0.1")
    check(zeros >= b_zeros, f"the refit has {zeros} exact zeros, B_sparse "
          f"{b_zeros}")
    del edr
    _empty_cache(device)
    return launches


def phase_entry(device="cuda"):
    """``entry()`` on the card: the NLML value+grad at N=2,048, Q=8, ms an
    evaluation over 20 queued evaluations (CUDA events), against the same
    function on the CPU in float64 (value 1e-4 relative, gradients 1e-3 of
    their largest entry); K and A must launch."""
    from edrgp_tpu_torch.entry import entry
    from edrgp_tpu_torch.ops.cuda import rbf
    fn, args = entry(device)
    rbf.reset_launches()
    value, grads = fn(*args)
    ms = cuda_ms(lambda: fn(*args), 20)
    launches = dict(rbf.LAUNCHES)
    ref_fn, ref_args = entry("cpu")
    ref_value, ref_grads = ref_fn(*ref_args)
    value_rel = abs(float(value) - float(ref_value)) / abs(float(ref_value))
    grad_rel = {k: _rel_to_max(g.cpu(), ref_grads[k])
                for k, g in grads.items()}
    emit(phase="entry", N=2048, Q=8, value=float(value),
         value_cpu_float64=float(ref_value), value_rel=value_rel,
         grad_rel_to_max=grad_rel, ms=ms, evaluations=20, launches=launches)
    check(math.isfinite(float(value)), "entry() value is not finite")
    check(launches["rbf_kernel_matrix"] >= 1
          and launches["rbf_nlml_adjoint"] >= 1,
          f"K or A did not launch in entry(): {launches}")
    check(value_rel < 1e-4, f"entry() value off by {value_rel:.3g}")
    check(max(grad_rel.values()) < 1e-3, f"entry() gradients off: {grad_rel}")
    return launches


def phase_dryrun():
    """``dryrun_multichip(1)`` in the one-rank group: one step of each
    sharded path with the JAX dry run's checks."""
    from edrgp_tpu_torch.entry import dryrun_multichip
    from edrgp_tpu_torch.ops.cuda import rbf
    rbf.reset_launches()
    t0 = time.perf_counter()
    (out,) = dryrun_multichip(1)
    seconds = time.perf_counter() - t0
    launches = dict(rbf.LAUNCHES)
    emit(phase="dryrun_multichip", world_size=1, seconds=seconds,
         svgp_elbo=out["svgp_elbo"], sharded_nlml=out["sharded_nlml"],
         sharded_fit_nlml=out["sharded_fit_nlml"],
         edr_components=out["edr_components"].tolist(),
         smc_logz_inc=out["smc_logz_inc"], launches=launches)
    check(launches["rbf_kernel_matrix"] >= 1 and launches["rbf_grad_mu"] >= 1,
          f"K or G did not launch in the dry run: {launches}")
    return launches


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _empty_cache(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _rel_to_max(got, want):
    """Largest error relative to the reference's largest entry."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def phase_svgp_reference(device="cuda", N=4096, M=64, Q=8, B=512):
    """SVGP on the card (float32) against the port's CPU float64 at the
    same parameters (ℓ = SIGNAL_LENGTHSCALE, σ² = 1, σₙ² = 0.1, the seeded
    Z), the same q(u) (one full natural-gradient step on the minibatch from
    N(0, I)) and the same minibatch of B rows."""
    import torch
    from edrgp_tpu_torch.models.svgp import SVGPModel
    from edrgp_tpu_torch.ops import svgp
    from edrgp_tpu_torch.ops.cuda import rbf
    from edrgp_tpu_torch.ops.kernels import RBF
    X, y, _ = _sgpr_problem(N, Q, np.random.default_rng(4))
    rng = np.random.default_rng(5)
    idx = np.sort(rng.choice(N, B, replace=False))
    Xs = X[np.sort(rng.choice(N, 1000, replace=False))]
    card, cpu = (SVGPModel(X, y, RBF(Q, ARD=True,
                                     lengthscale=SIGNAL_LENGTHSCALE),
                           num_inducing=M, noise_var=0.1, seed=0, device=dev,
                           dtype=dt)
                 for dev, dt in ((device, torch.float32),
                                 ("cpu", torch.float64)))
    cpu.load_state_dict(card.state_dict())       # the same float32 values
    q = svgp.natural_gradient_update(cpu, cpu.qstate, cpu._X[idx],
                                     cpu._y[idx], N, 1.0)
    card.qstate = svgp.SVGPState(*(t.to(device, torch.float32) for t in q))
    cpu.qstate = svgp.SVGPState(*(t.to("cpu", torch.float64)
                                  for t in card.qstate))
    out = {}
    for name, gp in (("card", card), ("cpu", cpu)):
        m, S = svgp.q_from_natural(gp.qstate)
        gp.zero_grad()
        elbo = svgp.svgp_elbo(gp, m, S, gp._X[idx], gp._y[idx], N)
        elbo.backward()
        step = svgp.natural_gradient_update(gp, gp.qstate, gp._X[idx],
                                            gp._y[idx], N, 0.5)
        rbf.reset_launches()
        mean, var = gp.predict(Xs)
        dmu = gp.predictive_gradients(Xs)[0][:, :, 0]
        out[name] = dict(
            elbo=elbo.item(), launches=dict(rbf.LAUNCHES),
            grads={k: p.grad.cpu().numpy() for k, p in gp.named_parameters()},
            theta=[t.cpu().numpy() for t in step], mean=mean, var=var,
            dmu=dmu)
    c, r = out["card"], out["cpu"]
    errs = {
        "elbo": abs(c["elbo"] - r["elbo"]) / abs(r["elbo"]),
        **{f"grad[{k}]": _rel_to_max(c["grads"][k], r["grads"][k])
           for k in r["grads"]},
        "theta1": _rel_to_max(c["theta"][0], r["theta"][0]),
        "theta2": _rel_to_max(c["theta"][1], r["theta"][1]),
        "predict_mean": _rel_to_max(c["mean"], r["mean"]),
        "predict_var": _rel_to_max(c["var"], r["var"]),
        "dmu": _rel_to_max(c["dmu"], r["dmu"])}
    limits = {k: 1e-4 if k in ("elbo", "predict_mean", "predict_var", "dmu")
              else 1e-3 for k in errs}
    emit(phase="svgp_reference", N=N, M=M, Q=Q, batch=B,
         elbo_card=c["elbo"], elbo_cpu_f64=r["elbo"], rel_err=errs,
         limits=limits, launches=c["launches"])
    for k, err in errs.items():
        check(err < limits[k], f"svgp_reference: {k} differs by {err:.3g}")
    check(c["launches"]["rbf_kernel_matrix"] >= 1
          and c["launches"]["rbf_grad_mu"] >= 1,
          f"K or G did not serve the SVGP prediction: {c['launches']}")


def _svgp_profile(model, batches, n_total, steps, lr):
    """Device busy time, host wall time and the device time under each
    label of ``SVGPModel._step`` and ``optimize_stream`` over ``steps``
    more steps (the backward is the busy time outside the labels)."""
    cpu_ops, wall_ms, busy = _profiled(
        lambda: model.optimize_stream(batches, n_total=n_total, steps=steps,
                                      lr=lr))
    split = {}
    for e in cpu_ops:
        if e.name.startswith("svgp."):
            split[e.name] = split.get(e.name, 0.0) + e.device_time_total / 1e3
    split = {k: v / steps for k, v in split.items()}
    split["backward_and_rest"] = busy / steps - sum(split.values())
    kernels_per_step = sum(len(e.kernels) for e in cpu_ops) / steps
    return dict(steps=steps, step_ms=wall_ms / steps,
                device_busy_ms_per_step=busy / steps,
                idle_share=1.0 - busy / wall_ms,
                device_kernels_per_step=kernels_per_step,
                profile_has_device_time=busy > 0, split_ms_per_step=split)


def _dataset_path(name):
    """A scratch file under the checkout's git-ignored ``build/``."""
    scratch = os.path.join(ROOT, "build")
    os.makedirs(scratch, exist_ok=True)
    return os.path.join(scratch, f"{name}-{os.getpid()}.edrg")


def phase_svgp_stream(device="cuda", N=10_000_000, Q=8, M=512, steps=3000,
                      batch=8192, profile_steps=50):
    """BASELINE config 5's SVGP half in the port: the N=10M streaming fit
    (``run_svgp_10m_smc`` → ``run_svgp_1m``); the SMC half is not ported."""
    import torch
    from edrgp_tpu_torch.data import MMapDataset, write_dataset
    from edrgp_tpu_torch.models.svgp import SVGPModel
    from edrgp_tpu_torch.ops.cuda import rbf
    from edrgp_tpu_torch.ops.kernels import RBF
    rng = np.random.default_rng(1)
    X, y, _ = _sgpr_problem(N, Q, rng)
    path = _dataset_path("svgp_stream")
    t0 = time.perf_counter()
    write_dataset(path, X, y)
    write_s = time.perf_counter() - t0
    file_gb = os.path.getsize(path) / 1e9
    del X, y
    ds = MMapDataset(path)
    try:
        native = ds._handle is not None
        _peak_gb(device, reset=True)
        rbf.reset_launches()
        model = SVGPModel.from_dataset(ds, RBF(Q, ARD=True), num_inducing=M,
                                       device=device)
        t0 = time.perf_counter()
        model.optimize_stream(ds.batches(batch, seed=1), n_total=N,
                              steps=steps, lr=5e-3)
        _sync(device)
        fit_s = time.perf_counter() - t0
        fit_launches = dict(rbf.LAUNCHES)
        elbo = -model._objective
        hyper = {k: np.asarray(v).tolist() for k, v in
                 model.get_hyperparameters().items() if k != "['Z']"}
        idx = np.sort(rng.integers(0, N, 4000))
        Xt, _ = ds.read_rows(idx)
        f = np.sin(Xt[:, 0]) * np.cos(Xt[:, 1]) + 0.5 * np.tanh(Xt[:, 2])
        rbf.reset_launches()
        pred, var = model.predict(Xt)
        launches = dict(rbf.LAUNCHES)
        rmse = float(np.sqrt(np.mean((pred[:, 0] - f) ** 2)))
        peak = _peak_gb(device)
        it = ds.batches(batch, seed=2)    # a second stream: a fresh mapping
        next(it)
        t0 = time.perf_counter()
        for _ in range(100):
            next(it)
        loader_rows_s = 100 * batch / (time.perf_counter() - t0)
        it.close()
        prof = None
        if torch.device(device).type == "cuda":
            it = ds.batches(batch, seed=3)
            prof = _svgp_profile(model, it, N, profile_steps, 5e-3)
            it.close()
    finally:
        ds.close()
        os.unlink(path)
    emit(phase="svgp_stream", N=N, Q=Q, num_inducing=M, steps=steps,
         batch=batch, scan_chunk=16, native_loader=native,
         file_gb=file_gb, write_seconds=write_s, fit_seconds=fit_s,
         steps_per_s=steps / fit_s, rows_per_s_through_elbo=steps * batch
         / fit_s, final_minibatch_elbo=elbo,
         loader_rows_per_s=loader_rows_s, rmse_vs_truth=rmse,
         noise_std_truth=0.1, mean_pred_std=float(np.sqrt(var).mean()),
         launches_fit=fit_launches, launches_predict=launches,
         hyperparameters=hyper, peak_mem_gb=peak, profile=prof)
    check(native, "the native loader did not serve the stream")
    check(np.isfinite(pred).all() and pred.shape == (4000, 1),
          "bad SVGP predictions")
    check(rmse < 0.05, f"SVGP RMSE vs truth {rmse:.4g} >= 0.05")
    check(launches["rbf_kernel_matrix"] >= 1,
          f"K did not serve the SVGP predict: {launches}")
    del model
    _empty_cache(device)
    return {k: fit_launches[k] + launches[k] for k in launches}


def phase_svgp_edr(device="cuda", N=1_048_576, Q=10, M=512, steps=1000,
                   max_iters=500, batch=4096):
    """The north-star capstone (``benchmarks/edr_scale_tpu.py``) in the
    port: its data (``make_data``), the streamed SVGP fit, the gradient
    extraction at every row, the eigenvectors of GᵀG, then the EDR class
    pipeline at the same size and a held-out ``predict``.  The class
    pipeline makes two fits (``EDR_STEP``), not four, of 500 steps each,
    not the benchmark's 1,500, and the streamed fit takes 1,000 steps, not
    2,000: a step takes 13–23 ms on the H100, bound by the host, so the
    four class fits alone took 80–92 s at 1,000–1,500 steps; N, M, Q and
    the batch are not cut."""
    import scipy.sparse
    import torch
    from edrgp_tpu_torch import (EffectiveDimensionalityReduction,
                                 SVDTransformer, discrepancy)
    from edrgp_tpu_torch.data import MMapDataset, write_dataset
    from edrgp_tpu_torch.datasets import get_beta_inputs, get_edr_target
    from edrgp_tpu_torch.models import SVGPRegressor
    from edrgp_tpu_torch.models.svgp import SVGPModel
    from edrgp_tpu_torch.ops.cuda import rbf
    from edrgp_tpu_torch.ops.kernels import RBF
    D = 3
    rng = np.random.default_rng(0)
    X = get_beta_inputs(N, Q, rng=rng).astype(np.float32)
    B = np.linalg.qr(scipy.sparse.random(Q, D, density=0.4,
                                         random_state=0).toarray())[0]
    y = get_edr_target(X @ B, sigma=0.1, rng=rng).astype(np.float32)
    X_test = get_beta_inputs(2000, Q, rng=rng)
    y_test = get_edr_target(X_test @ B)
    path = _dataset_path("svgp_edr")
    write_dataset(path, X, y)
    _peak_gb(device, reset=True)
    rbf.reset_launches()
    ds = MMapDataset(path)
    try:
        t0 = time.perf_counter()
        model = SVGPModel.from_dataset(ds, RBF(Q, ARD=True), num_inducing=M,
                                       seed=0, device=device)
        model.optimize_stream(ds.batches(batch, seed=1), n_total=N,
                              steps=steps, lr=5e-3)
        _sync(device)
        fit_s = time.perf_counter() - t0
    finally:
        ds.close()
        os.unlink(path)
    before = rbf.LAUNCHES["rbf_grad_mu"]
    t0 = time.perf_counter()
    G = model.predictive_gradients(X)[0][:, :, 0]
    grad_s = time.perf_counter() - t0
    grad_launches = rbf.LAUNCHES["rbf_grad_mu"] - before
    t0 = time.perf_counter()
    w, V = np.linalg.eigh(G.astype(np.float64).T @ G)
    comps = V[:, ::-1][:, :D]
    eig_s = time.perf_counter() - t0
    manual = dict(discrepancy=discrepancy(B, comps),
                  principal_angles_deg=principal_angles_deg(B, comps).tolist(),
                  explained_ratio_top3=float(w[::-1][:D].sum() / w.sum()))
    # sharded_edr's Gram at this size takes the model back from a pickle.
    handoff = (_stash(model, "svgp_edr"), X, G)
    del model
    _empty_cache(device)

    with count_calls(SVGPModel, "optimize") as fits:
        t0 = time.perf_counter()
        edr = EffectiveDimensionalityReduction(
            SVGPRegressor(num_inducing=M, batch_size=batch, lr=5e-3,
                          device=device),
            SVDTransformer(), n_components=D,
            step=EDR_STEP).fit(X, y, max_iters=max_iters)
        edr_s = time.perf_counter() - t0
    edr_grad_launches = rbf.LAUNCHES["rbf_grad_mu"] - before - grad_launches
    before_k = rbf.LAUNCHES["rbf_kernel_matrix"]
    pred = edr.estimator_.predict(edr._preprocessing_transform(X_test))
    predict_k = rbf.LAUNCHES["rbf_kernel_matrix"] - before_k
    launches = dict(rbf.LAUNCHES)
    comps_edr = edr.components_.T
    disc_edr = discrepancy(B, comps_edr)
    rmse = float(np.sqrt(np.mean((pred - y_test) ** 2)))
    emit(phase="svgp_edr", N=N, Q=Q, num_inducing=M, n_components=D,
         steps=steps, max_iters=max_iters, batch=batch,
         stream_fit_seconds=fit_s, gradient_seconds=grad_s,
         gradient_rows_per_s=N / grad_s, eigh_seconds=eig_s,
         manual_pipeline=manual, edr_class_seconds=edr_s, edr_fits=len(fits),
         edr_class=dict(discrepancy=disc_edr,
                        principal_angles_deg=principal_angles_deg(
                            B, comps_edr).tolist(),
                        subspace_variance_ratio=np.asarray(
                            edr.subspace_variance_ratio_).tolist()),
         heldout_rmse=rmse, heldout_y_std=float(np.std(y_test)),
         launches=launches, launches_gradient_extraction=grad_launches,
         launches_edr_fits=edr_grad_launches, launches_predict_K=predict_k,
         peak_mem_gb=_peak_gb(device))
    check(np.isfinite(G).all() and G.shape == (N, Q), "bad SVGP gradients")
    check(manual["discrepancy"] < 0.1,
          f"SVGP EDR discrepancy {manual['discrepancy']:.3g} >= 0.1")
    check(disc_edr < 0.1, f"SVGP EDR class discrepancy {disc_edr:.3g} >= 0.1")
    check(np.isfinite(pred).all() and pred.shape == y_test.shape,
          "bad predictions")
    check(grad_launches == 1 and edr_grad_launches == len(fits),
          f"G did not launch once per fit: {grad_launches} in the manual "
          f"extraction, {edr_grad_launches} in {len(fits)} EDR fits")
    check(predict_k >= 1, f"K did not serve predict: {launches}")
    del edr
    _empty_cache(device)
    return launches, handoff


def _edr_problem(N, Q=10, D=3, n_test=2000):
    """main_path's generator: beta inputs, a planted D-dimensional subspace
    B, y = get_edr_target(X·B, σ=0.1); held-out rows with the noise-free
    target."""
    from edrgp_tpu_torch.datasets import get_beta_inputs, get_edr_target
    rng = np.random.default_rng(0)
    X = get_beta_inputs(N, Q, rng=rng)
    B = np.linalg.qr(rng.normal(size=(Q, D)))[0]
    y = get_edr_target(X @ B, sigma=0.1, rng=rng)
    X_test = get_beta_inputs(n_test, Q, rng=rng)
    return X, y, B, X_test, get_edr_target(X_test @ B)


def _cls_problem(N, n_test=4000):
    """Labels 1[f > median f] on main_path's generator (f with its noise),
    and held-out labels of the noise-free target at the same threshold."""
    X, f, B, X_test, f_test = _edr_problem(N, n_test=n_test)
    cut = np.median(f)
    return (X, (f > cut).astype(int), B, X_test,
            (f_test > cut).astype(int))


def _site_stats(calls):
    """EP iterations and host ms per iteration of recorded site loops."""
    iters = [c[0] for c in calls]
    return dict(site_loops=len(calls),
                ep_iters_per_evaluation=dict(
                    mean=float(np.mean(iters)), min=int(min(iters)),
                    max=int(max(iters))),
                ms_per_ep_iteration=sum(c[1] for c in calls) / sum(iters))


def _idle_share(fn, reps=2):
    """(wall ms per call, device busy ms per call, idle share) of ``fn``
    over ``reps`` calls under torch.profiler (host clock around them)."""
    _, wall, busy = _profiled(fn, reps)
    return dict(wall_ms=wall, device_busy_ms=busy,
                idle_share=1.0 - busy / wall,
                profile_has_device_time=busy > 0)


def phase_cls_reference(device="cuda", N_full=1024, N_sparse=2000, M=64,
                        Q=10):
    """The four classifiers on the card (float32) against the port's CPU
    float64 at the same fixed parameters (ℓ = 1, σ² = 1, seeded Z, and for
    VI a seeded m and tril): the bound or log Z_EP (1e-4 relative; 1e-3 for
    EP, whose float32 tolerance stops the sites earlier), each parameter's
    gradient (1e-3 of its largest entry), ``predict`` P(y=1) and dμ/dx*
    (1e-4 of their largest entries)."""
    import torch
    from edrgp_tpu_torch.models import cls_state
    from edrgp_tpu_torch.ops.cuda import rbf
    from edrgp_tpu_torch.ops.kernels import RBF
    cases = [("VGPClassificationModel", N_full, {}),
             ("EPClassificationModel", N_full, {}),
             ("SparseVGPClassificationModel", N_sparse,
              {"num_inducing": M, "likelihood": "probit"}),
             ("SparseVGPClassificationModel", N_sparse,
              {"num_inducing": M, "likelihood": "logit"}),
             ("SparseEPClassificationModel", N_sparse, {"num_inducing": M})]
    rows = []
    for name, N, kw in cases:
        X, y, _, Xs, _ = _cls_problem(N, n_test=1000)
        cls = getattr(cls_state, name)
        card = cls(X, y, RBF(Q, ARD=True), device=device, **kw)
        rng = np.random.default_rng(7)
        with torch.no_grad():
            if hasattr(card, "m"):
                card.m.copy_(torch.as_tensor(
                    0.5 * rng.normal(size=card.m.shape)))
                card.tril.add_(torch.as_tensor(
                    0.05 * rng.normal(size=card.tril.shape),
                    dtype=card.tril.dtype, device=card.tril.device))
        cpu = cls(X, y, RBF(Q, ARD=True), device="cpu", **kw)
        cpu.load_state_dict(card.state_dict())     # the same float32 values
        out = {}
        for label, gp in (("card", card), ("cpu", cpu)):
            gp.zero_grad()
            loss = gp._objective_fn()()
            loss.backward()
            rbf.reset_launches()
            proba = gp.predict(Xs)[0]
            dmu = gp.predictive_gradients(Xs)[0][:, :, 0]
            out[label] = dict(
                value=-loss.item(), launches=dict(rbf.LAUNCHES), proba=proba,
                dmu=dmu, grads={k: p.grad.double().cpu().numpy()
                                for k, p in gp.named_parameters()})
        c, r = out["card"], out["cpu"]
        ep = "EP" in name
        errs = {"value": abs(c["value"] - r["value"]) / abs(r["value"]),
                **{f"grad[{k}]": _rel_to_max(c["grads"][k], r["grads"][k])
                   for k in r["grads"]},
                "predict_proba": _rel_to_max(c["proba"], r["proba"]),
                "dmu": _rel_to_max(c["dmu"], r["dmu"])}
        limits = {k: (1e-3 if ep else 1e-4) if k == "value"
                  else 1e-3 if k.startswith("grad") else 1e-4 for k in errs}
        row = dict(model=name, N=N, **kw, value_card=c["value"],
                   value_cpu_f64=r["value"], rel_err=errs, limits=limits,
                   launches=c["launches"],
                   parameters=sum(p.numel() for p in card.parameters()))
        rows.append(row)
        emit(phase="cls_reference", **row)
        for k, err in errs.items():
            check(err < limits[k], f"cls_reference {name} {kw}: {k} differs "
                  f"by {err:.3g}")
        check(c["launches"]["rbf_grad_mu"] == 1
              and c["launches"]["rbf_kernel_matrix"] >= 1,
              f"cls_reference {name}: G or K did not launch: {c['launches']}")
        del card, cpu
        _empty_cache(device)
    return rows


def phase_cls_ep_edr(device="cuda", N=4096, max_iters=100):
    """EDR over the EP classifier (GPy's inference) at N=4,096, Q=10."""
    from edrgp_tpu_torch import (EffectiveDimensionalityReduction,
                                 SVDTransformer, discrepancy)
    from edrgp_tpu_torch.models import GaussianProcessClassifier
    from edrgp_tpu_torch.models.cls_state import EPClassificationModel
    from edrgp_tpu_torch.ops import ep
    from edrgp_tpu_torch.ops.cuda import rbf
    D = 3
    X, y, B, X_test, y_test = _cls_problem(N)
    _peak_gb(device, reset=True)
    rbf.reset_launches()
    with count_calls(EPClassificationModel, "optimize") as fits, \
            count_calls(ep, "ep_site_loop",
                        keep=lambda state: state.iters) as sites:
        t0 = time.perf_counter()
        edr = EffectiveDimensionalityReduction(
            GaussianProcessClassifier(kernels="RBF",
                                      kernel_options={"ARD": True},
                                      inference="ep", device=device),
            SVDTransformer(), n_components=D,
            step=EDR_STEP).fit(X, y, max_iters=max_iters)
        fit_s = time.perf_counter() - t0
    fit_launches = dict(rbf.LAUNCHES)
    Xt = edr._preprocessing_transform(X_test)
    acc = float(np.mean(edr.estimator_.predict(Xt) == y_test))
    launches = dict(rbf.LAUNCHES)
    disc = discrepancy(B, edr.components_.T)
    model = edr.estimator_.estimator_
    # one objective evaluation (site loop + energy value and gradient) at
    # the last fit's parameters, under the profiler
    obj = model._objective_fn()

    def evaluation():
        model.zero_grad()
        obj().backward()

    idle = _idle_share(evaluation) if device == "cuda" else None
    stats = _site_stats(sites)
    evals = stats["site_loops"] - len(fits)     # one ep_fit per fit's cache
    emit(phase="cls_ep_edr", N=N, Q=X.shape[1], n_components=D,
         max_iters=max_iters, fit_seconds=fit_s, fits=len(fits),
         lbfgs_evaluations_per_fit=evals / max(len(fits), 1), **stats,
         discrepancy=disc,
         principal_angles_deg=principal_angles_deg(
             B, edr.components_.T).tolist(),
         heldout_accuracy=acc, heldout_rows=len(y_test),
         log_z_ep=model.log_likelihood(), profile_one_evaluation=idle,
         launches_fit=fit_launches, launches=launches,
         peak_mem_gb=_peak_gb(device))
    check(edr.components_.shape == (D, X.shape[1])
          and np.isfinite(edr.components_).all(), "bad components")
    check(disc < 0.1, f"EP classifier EDR discrepancy {disc:.3g} >= 0.1")
    check(acc > 0.85, f"EP classifier held-out accuracy {acc:.3g} <= 0.85")
    check(fit_launches["rbf_grad_mu"] == len(fits),
          f"G did not launch once per fit: {fit_launches}, {len(fits)} fits")
    check(fit_launches["rbf_kernel_matrix"] >= stats["site_loops"],
          f"K did not serve every site loop: {fit_launches}, "
          f"{stats['site_loops']} loops")
    del edr, model
    _empty_cache(device)
    return launches


def phase_cls_sparse_edr(device="cuda", N=100_000, M=512, max_iters=200,
                         ep_max_iters=50):
    """EDR over the sparse VI classifier at N=100,000, M=512, Q=10, then one
    EP-DTC fit at the same size: its dμ/dx* at every row (one G launch),
    the eigenvectors of GᵀG, held-out accuracy, ms per EP-DTC iteration and
    a save/load round trip on the card.  The launches are counted over the
    VI EDR with its ``predict_proba`` and over the EP-DTC fit with its
    gradients, predictions and round trip, each from 0; the timed bound
    evaluations between them are not counted."""
    from edrgp_tpu_torch import (EffectiveDimensionalityReduction,
                                 SVDTransformer, discrepancy)
    from edrgp_tpu_torch.models import SparseGaussianProcessClassifier
    from edrgp_tpu_torch.models.cls_state import (
        SparseEPClassificationModel, SparseVGPClassificationModel)
    from edrgp_tpu_torch.ops import ep_dtc, vgp
    from edrgp_tpu_torch.ops.cuda import rbf
    from edrgp_tpu_torch.ops.kernels import RBF
    D = 3
    X, y, B, X_test, y_test = _cls_problem(N)
    _peak_gb(device, reset=True)
    rbf.reset_launches()
    with count_calls(SparseVGPClassificationModel, "optimize") as fits, \
            count_calls(vgp, "svgp_cls_elbo") as evals:
        t0 = time.perf_counter()
        edr = EffectiveDimensionalityReduction(
            SparseGaussianProcessClassifier(
                kernels="RBF", kernel_options={"ARD": True}, num_inducing=M,
                device=device),
            SVDTransformer(), n_components=D,
            step=EDR_STEP).fit(X, y, max_iters=max_iters)
        fit_s = time.perf_counter() - t0
    fit_launches = dict(rbf.LAUNCHES)
    before_k = rbf.LAUNCHES["rbf_kernel_matrix"]
    proba = edr.estimator_.predict_proba(edr._preprocessing_transform(X_test))
    predict_k = rbf.LAUNCHES["rbf_kernel_matrix"] - before_k
    vi_launches = dict(rbf.LAUNCHES)
    acc_vi = float(np.mean((proba > 0.5) == y_test))
    disc_vi = discrepancy(B, edr.components_.T)
    angles_vi = principal_angles_deg(B, edr.components_.T).tolist()
    del edr
    _empty_cache(device)
    # one bound value+gradient at N, M, Q=10 from the default start
    fresh = SparseVGPClassificationModel(X, y, RBF(X.shape[1], ARD=True),
                                         num_inducing=M, device=device)
    bound = fresh._objective_fn()

    def evaluation():
        fresh.zero_grad()
        bound().backward()

    eval_ms = cuda_ms(evaluation, 5) if device == "cuda" else None
    eval_idle = _idle_share(evaluation) if device == "cuda" else None
    del fresh, bound

    rbf.reset_launches()
    with count_calls(ep_dtc, "ep_dtc_site_loop",
                     keep=lambda state: state.iters) as sites:
        t0 = time.perf_counter()
        model = SparseEPClassificationModel(X, y, RBF(X.shape[1], ARD=True),
                                            num_inducing=M, device=device)
        model.optimize(max_iters=ep_max_iters)
        _sync(device)
        ep_fit_s = time.perf_counter() - t0
        before_g = rbf.LAUNCHES["rbf_grad_mu"]
        t0 = time.perf_counter()
        G = model.predictive_gradients(X)[0][:, :, 0]
        grad_s = time.perf_counter() - t0
        ep_grad_launches = rbf.LAUNCHES["rbf_grad_mu"] - before_g
    ep_fit_launches = dict(rbf.LAUNCHES)
    w, V = np.linalg.eigh(G.astype(np.float64).T @ G)
    comps = V[:, ::-1][:, :D]
    disc_ep = discrepancy(B, comps)
    acc_ep = float(np.mean((model.predict(X_test)[0][:, 0] > 0.5) == y_test))
    bitwise = _save_load_bitwise(model, X_test, device)
    ep_launches = dict(rbf.LAUNCHES)
    launches = {k: vi_launches[k] + ep_launches[k] for k in ep_launches}
    emit(phase="cls_sparse_edr", N=N, Q=X.shape[1], num_inducing=M,
         n_components=D, max_iters=max_iters, fit_seconds=fit_s,
         fits=len(fits), bound_evaluations=len(evals),
         bound_value_grad_ms=eval_ms, profile_one_evaluation=eval_idle,
         discrepancy=disc_vi, principal_angles_deg=angles_vi,
         heldout_accuracy=acc_vi, launches_fit=fit_launches,
         launches_predict_proba_K=predict_k, launches_vi_edr=vi_launches,
         ep_dtc=dict(max_iters=ep_max_iters, fit_seconds=ep_fit_s,
                     **_site_stats(sites), log_z_ep_dtc=model.log_likelihood(),
                     gradient_seconds=grad_s, gradient_launches=ep_grad_launches,
                     discrepancy=disc_ep,
                     principal_angles_deg=principal_angles_deg(
                         B, comps).tolist(),
                     heldout_accuracy=acc_ep, save_load_bitwise=bitwise,
                     launches_fit_and_gradients=ep_fit_launches,
                     launches=ep_launches),
         launches=launches, peak_mem_gb=_peak_gb(device))
    check(disc_vi < 0.1, f"sparse VI classifier EDR discrepancy "
          f"{disc_vi:.3g} >= 0.1")
    check(disc_ep < 0.1, f"EP-DTC gradient discrepancy {disc_ep:.3g} >= 0.1")
    check(acc_vi > 0.85 and acc_ep > 0.85,
          f"held-out accuracy {acc_vi:.3g} (VI), {acc_ep:.3g} (EP-DTC)")
    check(fit_launches["rbf_grad_mu"] == len(fits) and ep_grad_launches == 1,
          f"G did not launch once per fit: {fit_launches}, {len(fits)} fits; "
          f"{ep_grad_launches} in the EP-DTC extraction")
    check(predict_k >= 1, f"K did not serve predict_proba: {launches}")
    check(ep_fit_launches["rbf_kernel_matrix"] >= len(sites),
          f"K did not serve every EP-DTC site loop: {ep_fit_launches}, "
          f"{len(sites)} loops")
    check(bitwise, "EP-DTC save/load changed the predictions")
    del model
    _empty_cache(device)
    return launches


#: Noise std of each output_index group of het_edr, in units of std(f).
HET_NOISE = (0.02, 0.05, 0.1, 0.2)


def _het_problem(N):
    """main_path's inputs and subspace with the noise-free target f, and
    y = f + per-group noise (group = row mod 4, std HET_NOISE·std(f))."""
    X, _, B, X_test, f_test = _edr_problem(N)
    from edrgp_tpu_torch.datasets import get_edr_target
    f = get_edr_target(X @ B)
    g = np.arange(N) % len(HET_NOISE)
    sd = np.asarray(HET_NOISE)[g] * np.std(f)
    y = f + sd * np.random.default_rng(1).normal(size=N)
    return X, y, g, B, X_test, f_test, (np.asarray(HET_NOISE)
                                        * np.std(f)) ** 2


def phase_het_reference(device="cuda", N=1000, Q=10):
    """The per-point-noise NLML and its gradients on the card (float32,
    through K forward and A backward) against the port's CPU float64 at the
    same fixed parameters (ℓ = 1, σ² = 1, seeded noises): value 1e-4
    relative, each gradient 1e-3 of its largest entry."""
    import torch
    from edrgp_tpu_torch.models.heteroscedastic import (
        HeteroscedasticGPModel, het_nlml)
    from edrgp_tpu_torch.ops.cuda import rbf
    from edrgp_tpu_torch.ops.kernels import RBF
    X, y, _, _, _, _, _ = _het_problem(N)
    card = HeteroscedasticGPModel(X, y, RBF(Q, ARD=True), device=device)
    with torch.no_grad():
        card.raw_noise.copy_(torch.as_tensor(
            np.random.default_rng(3).uniform(-5.0, -1.0, N)))
    cpu = HeteroscedasticGPModel(X, y, RBF(Q, ARD=True), device="cpu")
    cpu.load_state_dict(card.state_dict())
    out = {}
    for label, gp in (("card", card), ("cpu", cpu)):
        gp.zero_grad()
        rbf.reset_launches()
        loss = het_nlml(gp, gp._X, gp._y, gp._idx)
        loss.backward()
        out[label] = (loss.item(), dict(rbf.LAUNCHES),
                      {k: p.grad.double().cpu().numpy()
                       for k, p in gp.named_parameters()})
    (v_c, launches, g_c), (v_r, _, g_r) = out["card"], out["cpu"]
    errs = {"value": abs(v_c - v_r) / abs(v_r),
            **{f"grad[{k}]": _rel_to_max(g_c[k], g_r[k]) for k in g_r}}
    limits = {k: 1e-4 if k == "value" else 1e-3 for k in errs}
    emit(phase="het_reference", N=N, Q=Q, nlml_card=v_c, nlml_cpu_f64=v_r,
         rel_err=errs, limits=limits, launches=launches)
    for k, err in errs.items():
        check(err < limits[k], f"het_reference: {k} differs by {err:.3g}")
    check(launches["rbf_kernel_matrix"] == 1
          and launches["rbf_nlml_adjoint"] == 1,
          f"the het NLML did not go through K and A: {launches}")


def phase_het_edr(device="cuda", N=8192, max_iters=200):
    """EDR over the heteroscedastic regressor with four noise groups at
    N=8,192, Q=10."""
    from edrgp_tpu_torch import (EffectiveDimensionalityReduction,
                                 SVDTransformer, discrepancy)
    from edrgp_tpu_torch.models import GaussianProcessHeteroscedasticRegressor
    from edrgp_tpu_torch.models import heteroscedastic
    from edrgp_tpu_torch.ops.cuda import rbf
    D = 3
    X, y, g, B, X_test, f_test, true_var = _het_problem(N)
    _peak_gb(device, reset=True)
    rbf.reset_launches()
    with count_calls(heteroscedastic, "het_nlml") as evals, \
            count_calls(heteroscedastic.HeteroscedasticGPModel,
                        "optimize") as fits:
        t0 = time.perf_counter()
        edr = EffectiveDimensionalityReduction(
            GaussianProcessHeteroscedasticRegressor(
                kernels="RBF", kernel_options={"ARD": True},
                Y_metadata={"output_index": g}, device=device),
            SVDTransformer(), n_components=D).fit(X, y, max_iters=max_iters)
        fit_s = time.perf_counter() - t0
    fit_launches = dict(rbf.LAUNCHES)
    pred = edr.estimator_.predict(edr._preprocessing_transform(X_test))
    launches = dict(rbf.LAUNCHES)
    disc = discrepancy(B, edr.components_.T)
    model = edr.estimator_.estimator_
    learned = model.group_noise_variances_
    ratio = learned / true_var
    rmse = float(np.sqrt(np.mean((pred - f_test) ** 2)))
    emit(phase="het_edr", N=N, Q=X.shape[1], n_components=D,
         max_iters=max_iters, fit_seconds=fit_s, fits=len(fits),
         nlml_evaluations=len(evals), discrepancy=disc,
         principal_angles_deg=principal_angles_deg(
             B, edr.components_.T).tolist(),
         group_noise_var_learned=learned.tolist(),
         group_noise_var_true=true_var.tolist(),
         learned_over_true=ratio.tolist(), heldout_rmse=rmse,
         heldout_f_std=float(np.std(f_test)), launches_fit=fit_launches,
         launches=launches, peak_mem_gb=_peak_gb(device))
    check(disc < 0.1, f"heteroscedastic EDR discrepancy {disc:.3g} >= 0.1")
    check(np.all((ratio > 1 / 1.5) & (ratio < 1.5)),
          f"learned group noise off its truth by more than 1.5x: {ratio}")
    check(np.isfinite(pred).all() and pred.shape == f_test.shape,
          "bad predictions")
    check(fit_launches["rbf_nlml_adjoint"] >= len(evals)
          and fit_launches["rbf_kernel_matrix"] >= len(evals),
          f"A or K missed an NLML evaluation: {fit_launches}, "
          f"{len(evals)} evaluations")
    check(fit_launches["rbf_grad_mu"] == len(fits),
          f"G did not launch once per fit: {fit_launches}, {len(fits)} fits")
    del edr, model
    _empty_cache(device)
    return launches


#: The N(0, 3²) prior on the unconstrained hyperparameters of nuts_gp,
#: smc_gp and the Bayesian regressor (``benchmarks/nuts_tpu.py:65``).
PRIOR_SCALE = 3.0


def _nuts_problem(N, Q):
    """BASELINE config 4's data (``benchmarks/nuts_tpu.py:56-60``): X ~
    N(0, I), f = sin(1.3·x₀) + 0.5·cos x₁, y = f + 0.15·noise, y not
    normalized."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(N, Q))
    f = np.sin(1.3 * X[:, 0]) + 0.5 * np.cos(X[:, 1])
    return X, f + 0.15 * rng.normal(size=N)


def _gp_target(device, N, Q):
    """(kernel, log posterior, log likelihood, log prior) of config 4's
    target over flat θ [C, D] on ``device`` (float32 on the card)."""
    import torch
    from edrgp_tpu_torch.config import default_dtype
    from edrgp_tpu_torch.ops import exact
    from edrgp_tpu_torch.ops.kernels import RBF
    X, y = _nuts_problem(N, Q)
    dt = default_dtype(device)
    Xt = torch.as_tensor(X, dtype=dt, device=device)
    yt = torch.as_tensor(y, dtype=dt, device=device)
    kernel = RBF(Q, ARD=True).to(device=device, dtype=dt)

    def loglik(q):
        return -exact.nlml_chains(kernel, q, Xt, yt)

    def logprior(q):
        return -0.5 * ((q / PRIOR_SCALE) ** 2).sum(-1)

    def logprob(q):
        return loglik(q) + logprior(q)

    return kernel, logprob, loglik, logprior


def _map_theta(device, N, Q, logprob):
    """The target's mode as ``benchmarks/nuts_tpu.py:73-105`` finds it:
    ML-II by the port's L-BFGS from σₙ² = 0.1 (one start, 200 iterations,
    tol 3e-4), clipped into the prior's support (±2 prior scales), then
    refined to the MAP of the target itself (100 iterations)."""
    import torch
    from edrgp_tpu_torch.inference.lbfgs import minimize
    from edrgp_tpu_torch.models.state import ExactGPModel
    from edrgp_tpu_torch.ops import exact
    from edrgp_tpu_torch.ops.kernels import RBF
    X, y = _nuts_problem(N, Q)
    m = ExactGPModel(X, y, RBF(Q, ARD=True), normalizer=False,
                     noise_var=0.1, device=device)
    m.optimize(max_iters=200, tol=3e-4, num_restarts=1)
    theta = exact.flatten_theta(m.kernel, m.raw_noise)
    theta = theta.clamp(-2 * PRIOR_SCALE, 2 * PRIOR_SCALE).requires_grad_()
    res = minimize(lambda: -logprob(theta[None])[0], [theta], max_iters=100,
                   tol=3e-4)
    return res.params[0].detach(), float(m._objective), float(res.value)


def phase_sampler_reference(device="cuda", N=500, Q=4, C=16, steps=16,
                            eps=0.01):
    """The samplers' numerics on the card (float32) against the port on
    the CPU in float64, at config 4's target (N=500, Q=4) and 16 fixed θ
    near the MAP (θ̂ + 0.1·N(0, I), seeded): ``nlml_chains`` value (1e-4
    relative) and gradient (1e-3 of each parameter's largest entry); a
    16-step leapfrog trajectory from a fixed momentum (ε = 0.01, unit
    mass: positions 1e-4 of their largest entry, log densities 1e-4
    relative); ``curvature_inv_mass`` at θ̂ (2e-2 relative: float32's
    difference step is 4.9e-3, float64's 6.1e-6); and one chain pushed
    to σ² = inf, which factors on no rung of the jitter ladder: its log
    density is non-finite and every other chain's value and gradient
    keep their bits."""
    import torch
    from edrgp_tpu_torch.inference import hmc
    from edrgp_tpu_torch.ops import exact
    from edrgp_tpu_torch.ops.cuda import rbf
    targets = {dev: _gp_target(dev, N, Q) for dev in (device, "cpu")}
    theta_hat = _map_theta(device, N, Q, targets[device][1])[0]
    D = theta_hat.shape[0]
    rng = np.random.default_rng(11)
    thetas = (theta_hat.double().cpu().numpy()
              + 0.1 * rng.normal(size=(C, D)))
    p0 = rng.normal(size=(C, D))
    out = {}
    for dev, (kernel, logprob, loglik, _) in targets.items():
        dt = torch.float64 if dev == "cpu" else torch.float32
        th = torch.as_tensor(thetas, dtype=dt, device=dev)
        rbf.reset_launches()
        nlml, g = hmc.value_and_grad(lambda q: -loglik(q), th)
        launches = dict(rbf.LAUNCHES)
        lp, grad = hmc.value_and_grad(logprob, th)
        traj = hmc._leapfrog(logprob, th, torch.as_tensor(p0, dtype=dt,
                                                          device=dev),
                             grad, torch.full((C,), eps, dtype=dt,
                                              device=dev),
                             torch.ones_like(th), steps)
        im = hmc.curvature_inv_mass(logprob, theta_hat.to(dev, dt))
        out[dev] = [t.double().cpu().numpy() for t in
                    (nlml, g, traj[0][-1], traj[1][-1], im)] + [launches]
    (v_c, g_c, q_c, lp_c, im_c, launches), (v_r, g_r, q_r, lp_r, im_r, _) \
        = out[device], out["cpu"]
    errs = {"nlml": float(np.abs(v_c - v_r).max() / np.abs(v_r).max()),
            **{f"grad[{d}]": float(np.abs(g_c[:, d] - g_r[:, d]).max()
                                   / np.abs(g_r[:, d]).max())
               for d in range(D)},
            "leapfrog_q": _rel_to_max(q_c, q_r),
            "leapfrog_logp": float(np.abs(lp_c - lp_r).max()
                                   / np.abs(lp_r).max()),
            "curvature_inv_mass": float(np.abs(im_c / im_r - 1).max())}
    limits = {k: (1e-3 if k.startswith("grad") else 2e-2
                  if k == "curvature_inv_mass" else 1e-4) for k in errs}

    kernel, logprob, _, _ = targets[device]
    th = torch.as_tensor(thetas, dtype=torch.float32, device=device)
    bad = th.clone()
    bad[3, Q] = float("inf")
    lp_ok, g_ok = hmc.value_and_grad(logprob, th)
    lp_bad, g_bad = hmc.value_and_grad(logprob, bad)
    keep = torch.arange(C, device=device) != 3
    lane = dict(failed_chain_finite=bool(torch.isfinite(lp_bad[3])),
                others_same_bits=bool(torch.equal(lp_bad[keep], lp_ok[keep])
                                      and torch.equal(g_bad[keep],
                                                      g_ok[keep])))
    emit(phase="sampler_reference", N=N, Q=Q, chains=C, rel_err=errs,
         limits=limits, launches=launches, theta_hat=theta_hat.tolist(),
         inv_mass_card=im_c.tolist(), inv_mass_cpu_f64=im_r.tolist(),
         **lane)
    for k, err in errs.items():
        check(err < limits[k], f"sampler_reference: {k} differs by "
              f"{err:.3g} (limit {limits[k]})")
    check(launches["rbf_kernel_matrix"] == C
          and launches["rbf_nlml_adjoint"] == C,
          f"nlml_chains did not launch K and A once per chain: {launches}")
    check(not lane["failed_chain_finite"] and lane["others_same_bits"],
          f"a failed chain leaked into its batch: {lane}")


def profile_chain_evaluation(logprob, q, reps=3):
    """One chain-batched value+gradient of ``logprob`` at q [C, D]: device
    ms (CUDA events), and a torch.profiler split of its device time by the
    op that launched each kernel, the hand-written kernels' launches
    labelled K and A (their scratch copies stay under the aten ops)."""
    from torch.profiler import record_function
    from edrgp_tpu_torch.inference import hmc
    from edrgp_tpu_torch.ops import exact

    def labelled(label, fn):
        def run(*args):
            with record_function(label):
                return fn(*args)
        return run

    saved = exact.rbf_kernel_matrix, exact.rbf_nlml_adjoint
    exact.rbf_kernel_matrix = labelled("K", saved[0])
    exact.rbf_nlml_adjoint = labelled("A", saved[1])
    try:
        ms = cuda_ms(lambda: hmc.value_and_grad(logprob, q), reps)
        cpu_ops, wall, busy = _profiled(
            lambda: hmc.value_and_grad(logprob, q), reps)
    finally:
        exact.rbf_kernel_matrix, exact.rbf_nlml_adjoint = saved
    split = {}
    for e in cpu_ops:
        t = sum(k.duration for k in e.kernels) / reps / 1e3
        if t > 0:
            split[e.name] = split.get(e.name, 0.0) + t
    top = dict(sorted(split.items(), key=lambda kv: -kv[1])[:10])
    return dict(chains=int(q.shape[0]), ms=ms, wall_ms=wall,
                device_busy_ms=busy, idle_share=1.0 - busy / wall,
                split_ms=top)


class _SegmentClock:
    """``on_segment`` hook: host seconds of each warmup and sampling
    segment (each ends in a host read)."""

    def __init__(self):
        self.last = time.perf_counter()
        self.warm, self.sample = [], []

    def __call__(self, phase, done, total):
        now = time.perf_counter()
        (self.sample if phase == "sample" else self.warm).append(
            now - self.last)
        self.last = now


def _counting(fn, calls):
    """``fn`` that appends the number of chains of every batch it takes."""
    def counted(q):
        calls.append(q.shape[0])
        return fn(q)
    return counted


def phase_nuts_gp(device="cuda", N=1024, Q=4, chains=16, warmup=256,
                  samples=128, max_depth=8, segment=8):
    """BASELINE config 4 (``benchmarks/nuts_tpu.py``'s defaults), one chain
    group: NUTS over the exact-GP posterior of θ = (4 ARD lengthscales,
    variance, noise) at N=1,024, Q=4, prior N(0, 3²); chains start at the
    MAP + 0.05·N(0, I) with the Laplace mass, pooled ε; every leapfrog
    step is one 16-chain NLML value+gradient (K forward and A backward
    once per chain)."""
    import torch
    from edrgp_tpu_torch.inference import hmc
    from edrgp_tpu_torch.inference.nuts import nuts_step, run_nuts_segmented
    from edrgp_tpu_torch.metrics import (effective_sample_size,
                                         potential_scale_reduction)
    from edrgp_tpu_torch.ops.cuda import rbf
    _, logprob, _, _ = _gp_target(device, N, Q)
    t0 = time.perf_counter()
    theta_hat, ml2, neg_map = _map_theta(device, N, Q, logprob)
    inv_mass0 = hmc.curvature_inv_mass(logprob, theta_hat)
    mode_s = time.perf_counter() - t0
    D = theta_hat.shape[0]
    q0 = theta_hat + 0.05 * torch.as_tensor(
        np.random.default_rng(1).normal(size=(chains, D)),
        dtype=theta_hat.dtype, device=theta_hat.device)
    clock, calls = _SegmentClock(), []
    _sync(device)
    rbf.reset_launches()
    t0 = clock.last = time.perf_counter()
    qs, info = run_nuts_segmented(
        _counting(logprob, calls), q0, 0, num_warmup=warmup,
        num_samples=samples, max_depth=max_depth, segment_len=segment,
        pool_eps=True, inv_mass0=inv_mass0.cpu().numpy(),
        on_segment=clock)
    wall = time.perf_counter() - t0
    launches = dict(rbf.LAUNCHES)
    leaps = info["leapfrogs_per_transition"] - 1          # [S, C]
    steady = clock.sample[1:] or clock.sample
    samples_per_s = chains * segment / float(np.median(steady))
    sample_s = float(np.sum(clock.sample))
    chain_evals = sum(calls)
    rhat = potential_scale_reduction(qs)
    ess = effective_sample_size(qs)

    eps = torch.as_tensor(info["step_size"], device=device)
    im = torch.as_tensor(info["inv_mass"], device=device)
    state = hmc.init_state(logprob, torch.as_tensor(qs[:, -1],
                                                    device=device))
    gen = hmc.make_generator(5, device)

    def one_segment():
        st = state
        for _ in range(segment):
            st, _ = nuts_step(logprob, st, gen, eps, im, max_depth)
        st.q[:1].cpu()

    idle = _idle_share(one_segment, reps=1)
    evaluation = profile_chain_evaluation(logprob, q0)
    transitions = chains * samples
    emit(phase="nuts_gp", N=N, Q=Q, chains=chains, warmup=warmup,
         samples=samples, max_depth=max_depth, segment=segment,
         ml2_nlml=ml2, map_neg_log_post=neg_map, mode_and_mass_s=mode_s,
         theta_hat=theta_hat.tolist(), inv_mass0=inv_mass0.tolist(),
         samples_per_s=samples_per_s,
         samples_per_s_incl_warmup=transitions / wall,
         median_sampling_segment_s=float(np.median(steady)),
         warmup_s=float(np.sum(clock.warm)), sampling_s=sample_s,
         wall_s=wall, grad_evals_per_s=float(
             np.sum(leaps) / sample_s),
         batched_evaluations=len(calls), chain_evaluations=chain_evals,
         mean_leapfrogs_per_transition=float(leaps.mean()),
         mean_max_leapfrogs_over_chains=float(leaps.max(1).mean()),
         accept_rate=info["accept_rate"], divergences=info["divergences"],
         step_size=float(info["step_size"][0]),
         max_split_rhat=float(rhat.max()), min_ess=float(ess.min()),
         posterior_mean=qs.reshape(-1, D).mean(0).tolist(),
         posterior_sd=qs.reshape(-1, D).std(0).tolist(),
         leapfrog_wall_ms=1e3 * wall / len(calls),
         sampling_segment_profile=idle, evaluation_profile=evaluation,
         launches=launches)
    check(np.isfinite(qs).all(), "non-finite NUTS draws")
    check(rhat.max() < 1.05, f"split-R-hat {rhat.max():.4f} >= 1.05")
    check(info["divergences"] <= 0.01 * transitions,
          f"{info['divergences']} divergences in {transitions} transitions")
    check(ess.min() >= 100, f"smallest ESS {ess.min():.1f} < 100")
    check(launches["rbf_kernel_matrix"] >= chain_evals
          and launches["rbf_nlml_adjoint"] >= chain_evals,
          f"K or A missed a chain's gradient evaluation: {launches}, "
          f"{chain_evals} chain evaluations in {len(calls)} batches")
    return launches, theta_hat, qs


def phase_smc_gp(theta_hat, nuts_qs, device="cuda", N=1024, Q=4,
                 particles=256, chunk=64, num_mcmc=3, n_leapfrog=10,
                 eps=0.02, max_stages=60):
    """Adaptive-tempering SMC on nuts_gp's identical target, as
    ``benchmarks/baseline_scale_tpu.py:128-231`` runs config 5's SMC:
    particles θ̂ + 0.5·N(0, I), 3 HMC sweeps of 10 leapfrogs a stage, ε
    seeded at 0.02, particle chunks of 64; then the cross-check against
    nuts_gp's draws (``:273-303``): |SMC mean − NUTS mean| / NUTS sd per
    dimension and the ratio of the standard deviations."""
    import torch
    from edrgp_tpu_torch.inference.smc import run_smc_segmented
    from edrgp_tpu_torch.ops.cuda import rbf
    _, _, loglik, logprior = _gp_target(device, N, Q)
    D = theta_hat.shape[0]
    parts0 = theta_hat + 0.5 * torch.as_tensor(
        np.random.default_rng(2).normal(size=(particles, D)),
        dtype=theta_hat.dtype, device=theta_hat.device)
    _sync(device)
    rbf.reset_launches()
    t0 = time.perf_counter()
    parts, info = run_smc_segmented(
        loglik, logprior, parts0, 3, num_mcmc=num_mcmc,
        n_leapfrog=n_leapfrog, eps=eps, max_stages=max_stages,
        particle_chunk=chunk)
    wall = time.perf_counter() - t0
    launches = dict(rbf.LAUNCHES)
    post = parts.double().cpu().numpy()
    nuts = nuts_qs.reshape(-1, D)
    z = (post.mean(0) - nuts.mean(0)) / nuts.std(0)
    ratio = post.std(0) / nuts.std(0)
    uniq = info["unique_particles_after_resample"]
    emit(phase="smc_gp", N=N, Q=Q, particles=particles,
         particle_chunk=chunk, num_mcmc=num_mcmc, n_leapfrog=n_leapfrog,
         converged=info["converged"], n_stages=info["n_stages"],
         beta_ladder=info["beta_trace"], ess_trace=info["ess_trace"],
         unique_particles_after_resample=uniq,
         eps_trace=info["eps_trace"], accept_trace=info["accept_trace"],
         log_evidence=info["log_evidence"], wall_s=wall,
         particle_stages_per_s=particles * info["n_stages"] / wall,
         posterior_mean=post.mean(0).tolist(),
         posterior_sd=post.std(0).tolist(),
         smc_minus_nuts_mean_in_nuts_sd=z.tolist(),
         smc_over_nuts_sd=ratio.tolist(), launches=launches)
    check(info["converged"], f"SMC did not reach beta = 1 in {max_stages} "
          "stages")
    check(min(uniq) >= 0.25 * particles,
          f"a resample kept {min(uniq)} of {particles} particles")
    check(np.all(np.abs(z) < 2), f"SMC and NUTS means differ: z = {z}")
    check(np.all((ratio >= 0.5) & (ratio <= 2)),
          f"SMC and NUTS spreads differ: ratio {ratio}")
    return launches


def phase_bayes_edr(device="cuda", N=1024, num_chains=4, num_warmup=150,
                    num_samples=50, max_depth=6, step=EDR_STEP):
    """EDR over the fully Bayesian regressor on main_path's generator
    (beta inputs, Q=10, a planted 3-D subspace) at N=1,024: NUTS in every
    fit (K and A once per chain per leapfrog step), dμ/dx* averaged over
    the kept samples (G once per sample) and K(X, X*) once per sample in
    ``predict``.  Cut to two fits (``step=7``: Q=10, then Q=3, not
    10/7/4/3), 50 sampling transitions a fit (not 150) and trees of depth
    6 (not 8); the warmup stays at 150 (PERF.md §4, §6): a leapfrog step
    of the 4 chains takes ~10 ms of host time, so the four fits took
    302–368 s of a script that must end within 1,200 s.  Shallower trees
    mix too slowly here: at depth 5 a fit's split-R̂ reached 1.13 (two
    fits) and 1.23 (four), at depth 4 1.61; a warmup cut to 60 made the
    fits slower, since the chains then sampled with a kernel adapted over
    30 + 30 transitions."""
    from edrgp_tpu_torch import (EffectiveDimensionalityReduction,
                                 SVDTransformer, discrepancy)
    from edrgp_tpu_torch.models import BayesianGaussianProcessRegressor
    from edrgp_tpu_torch.models.bayesian import BayesianGPModel
    from edrgp_tpu_torch.ops.cuda import rbf
    D = 3
    X, y, B, X_test, y_test = _edr_problem(N)
    _peak_gb(device, reset=True)
    rbf.reset_launches()
    per_fit = []
    last = dict(rbf.LAUNCHES)

    def record(model):
        """The fit's diagnostics and the K and A launches of its NUTS run
        and posterior caches (G follows each fit, once per kept sample)."""
        now = dict(rbf.LAUNCHES)
        per_fit.append(dict(rhat=float(model.diagnostics_["rhat"].max()),
                            divergences=model.diagnostics_["divergences"],
                            kept=int(model.samples_.shape[0]),
                            Q=int(model._X.shape[1]),
                            launches={k: now[k] - last[k] for k in
                                      ("rbf_kernel_matrix",
                                       "rbf_nlml_adjoint")}))
        last.update(now)
        return None

    with count_calls(BayesianGPModel, "optimize",
                     keep=record) as fits:
        t0 = time.perf_counter()
        edr = EffectiveDimensionalityReduction(
            BayesianGaussianProcessRegressor(
                kernels=["RBF"], kernel_options=[{"ARD": True}],
                num_chains=num_chains, num_warmup=num_warmup,
                num_samples=num_samples, max_depth=max_depth, device=device),
            SVDTransformer(), n_components=D, step=step).fit(X, y)
        fit_s = time.perf_counter() - t0
    fit_launches = dict(rbf.LAUNCHES)
    model = edr.estimator_.estimator_
    Xs = edr._preprocessing_transform(X_test)
    rbf.reset_launches()
    pred = edr.estimator_.predict(Xs)
    predict_launches = dict(rbf.LAUNCHES)
    bitwise = _save_load_bitwise(model, Xs, device)
    disc = discrepancy(B, edr.components_.T)
    rmse = float(np.sqrt(np.mean((pred - y_test) ** 2)))
    kept = sum(f["kept"] for f in per_fit)
    emit(phase="bayes_edr", N=N, Q=X.shape[1], n_components=D,
         num_chains=num_chains, num_warmup=num_warmup,
         num_samples=num_samples, max_depth=max_depth, step=step,
         fit_seconds=fit_s, fits=per_fit,
         discrepancy=disc, principal_angles_deg=principal_angles_deg(
             B, edr.components_.T).tolist(), heldout_rmse=rmse,
         heldout_y_std=float(np.std(y_test)),
         noise_variance=model.noise_variance, launches_fit=fit_launches,
         launches_predict=predict_launches, save_load_bitwise=bitwise,
         peak_mem_gb=_peak_gb(device))
    check(disc < 0.1, f"Bayesian EDR discrepancy {disc:.3g} >= 0.1")
    check(all(f["rhat"] < 1.1 for f in per_fit),
          f"a fit's split-R-hat is 1.1 or more: {per_fit}")
    check(np.isfinite(pred).all() and pred.shape == y_test.shape,
          "bad predictions")
    check(bitwise, "the Bayesian model's save/load round trip changed its "
          "predictions")
    check(fit_launches["rbf_grad_mu"] == kept,
          f"G did not launch once per kept sample: {fit_launches}, "
          f"{kept} kept samples in {len(fits)} fits")
    check(predict_launches["rbf_kernel_matrix"] == model.samples_.shape[0],
          f"K did not serve each kept sample's predict: {predict_launches}")
    launches = {k: fit_launches[k] + predict_launches[k]
                for k in fit_launches}
    del edr, model
    _empty_cache(device)
    return launches


def phase_distributed(device="cuda"):
    """Join a process group on the card (NCCL, one rank a card of this
    machine's first: the world is 1 here) and hold the barrier and the
    replica check; returns the 1-D ``("data",)`` mesh the sharded phases
    run on."""
    import torch
    import torch.distributed as dist
    from edrgp_tpu_torch.parallel import (assert_replicas_agree, barrier,
                                          checksum, initialize, make_mesh)
    t0 = time.perf_counter()
    dev = initialize(device=device)
    init_s = time.perf_counter() - t0
    backend = dist.get_backend()
    barrier()
    params = {"kernel": {"lengthscale": torch.linspace(0.5, 2.0, 8,
                                                       device=dev),
                         "variance": torch.tensor(1.3, device=dev)},
              "raw_noise": torch.tensor(-2.0, device=dev)}
    digest = checksum(params)
    assert_replicas_agree(params)
    mesh = make_mesh(("data",))
    nccl = (".".join(map(str, torch.cuda.nccl.version()))
            if dev.type == "cuda" else None)
    emit(phase="distributed", backend=backend,
         world_size=dist.get_world_size(), nccl_version=nccl,
         device=str(dev), init_seconds=init_s, digest=digest,
         mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)))
    check(backend == ("nccl" if dev.type == "cuda" else "gloo"),
          f"process group backend {backend} on {dev}")
    return mesh


def phase_sharded_nlml(mesh, device="cuda", N=10_000, Q=8):
    """The row-slab-sharded NLML value+grad at the nlml phase's shape on the
    ``data`` dimension: against the single-device NLML on the card (value
    1e-4 relative, each gradient 1e-3 of its largest entry), the same bits
    twice, one K launch a rank an evaluation (the slab), no A; ms an
    evaluation beside the single-device path's in the same run, and a
    torch.profiler split of one evaluation's device time by op."""
    import torch
    from edrgp_tpu_torch.models.state import ExactGPModel
    from edrgp_tpu_torch.ops import exact
    from edrgp_tpu_torch.ops.cuda import rbf
    from edrgp_tpu_torch.ops.kernels import RBF
    from edrgp_tpu_torch.parallel import (make_sharded_nlml_value_and_grad,
                                          shard_rows)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(N, Q))
    y = np.sin(rng.normal(size=N))
    m = ExactGPModel(X, y, RBF(Q, ARD=True), normalizer=False, noise_var=0.1,
                     device=device)
    vg = make_sharded_nlml_value_and_grad(m, mesh, "data")
    X_local, y_local = shard_rows(mesh, "data", m._X, m._y)
    _peak_gb(device, reset=True)
    rbf.reset_launches()
    value, grads = vg(X_local, y_local)
    launches = dict(rbf.LAUNCHES)
    peak = _peak_gb(device)
    again = vg(X_local, y_local)
    same_bits = (torch.equal(again[0], value)
                 and all(torch.equal(again[1][k], g) for k, g in
                         grads.items()))

    def single():
        m.zero_grad()
        v = exact.nlml(m, m._X, m._y)
        v.backward()
        return v

    ref = single()
    ref = float(ref.detach())
    value_rel = abs(float(value) - ref) / abs(ref)
    grad_rel = {k: float((grads[k] - p.grad).abs().max()
                         / p.grad.abs().max())
                for k, p in m.named_parameters()}
    ms = cuda_ms(lambda: vg(X_local, y_local), 5)
    single_ms = cuda_ms(single, 5)
    split = None
    if torch.device(device).type == "cuda":
        cpu_ops, wall, busy = _profiled(lambda: vg(X_local, y_local))
        split = {}
        for e in cpu_ops:
            t = sum(k.duration for k in e.kernels) / 1e3
            if t > 0:
                split[e.name] = split.get(e.name, 0.0) + t
        split = dict(sorted(split.items(), key=lambda kv: -kv[1])[:10])
        split = dict(wall_ms=wall, device_busy_ms=busy, split_ms=split)
    emit(phase="sharded_nlml", N=N, Q=Q, ranks=mesh.size(0),
         nlml=float(value), nlml_single=float(ref), value_rel_diff=value_rel,
         grad_max_rel_diff=grad_rel, same_bits_twice=same_bits,
         ms_per_eval=ms, single_device_ms_per_eval=single_ms,
         profile=split, launches=launches, peak_mem_gb=peak)
    check(np.isfinite(float(value)), "non-finite sharded NLML")
    check(value_rel < 1e-4, f"sharded NLML differs by {value_rel:.3g}")
    check(max(grad_rel.values()) < 1e-3,
          f"sharded NLML gradient differs: {grad_rel}")
    check(same_bits, "two sharded evaluations differ")
    check(launches["rbf_kernel_matrix"] == 1
          and launches["rbf_nlml_adjoint"] == 0,
          f"the sharded NLML did not build its slab by K once: {launches}")
    del m, vg
    _empty_cache(device)
    return launches


def phase_sharded_edr(mesh, main_comps, svgp_handoff, device="cuda", N=8192,
                      max_iters=200):
    """main_path's EDR with ``GaussianProcessRegressor(method=
    "optimize_sharded")`` and ``gradient_mesh``: the sharded NLML in every
    L-BFGS evaluation, the gradients by ``model_gradient_gram`` (G once a
    fit), each staged Gram against GᵀG (1e-4), discrepancy < 0.1, principal
    angles to the planted and to main_path's subspace; then
    ``model_gradient_gram`` at N=1,048,576 on svgp_edr's streamed SVGP
    model (M=512, back from svgp_edr's pickle) against that phase's
    unsharded G: the same bits, one G launch, the Gram 1e-4."""
    from edrgp_tpu_torch import (EffectiveDimensionalityReduction,
                                 SVDTransformer, discrepancy)
    from edrgp_tpu_torch.models import GaussianProcessRegressor
    from edrgp_tpu_torch.models.state import ExactGPModel
    from edrgp_tpu_torch.ops.cuda import rbf
    from edrgp_tpu_torch.parallel import edr_sharded
    D = 3
    X, y, B, X_test, y_test = _edr_problem(N)

    def gram_err(out):
        G, gram = out
        ref = G.T @ G
        return float(np.abs(gram - ref).max() / np.abs(ref).max())

    _peak_gb(device, reset=True)
    rbf.reset_launches()
    with count_calls(ExactGPModel, "optimize_sharded") as fits, \
            count_calls(edr_sharded, "model_gradient_gram",
                        keep=gram_err) as grams:
        t0 = time.perf_counter()
        edr = EffectiveDimensionalityReduction(
            GaussianProcessRegressor(kernels="RBF",
                                     kernel_options={"ARD": True},
                                     method="optimize_sharded",
                                     device=device),
            SVDTransformer(), n_components=D, gradient_mesh=mesh).fit(
                X, y, max_iters=max_iters, mesh=mesh)
        fit_s = time.perf_counter() - t0
    pred = edr.estimator_.predict(edr._preprocessing_transform(X_test))
    launches = dict(rbf.LAUNCHES)
    comps = edr.components_.T
    disc = discrepancy(B, comps)
    rmse = float(np.sqrt(np.mean((pred - y_test) ** 2)))
    gram_errs = [e for e, _ in grams]

    path, X1m, G1m = svgp_handoff
    model = _loaded(path, device)
    rbf.reset_launches()
    t0 = time.perf_counter()
    G, gram = edr_sharded.model_gradient_gram(model, X1m, mesh)
    gram_s = time.perf_counter() - t0
    capstone_launches = dict(rbf.LAUNCHES)
    ref = G1m.astype(np.float64).T @ G1m
    capstone = dict(N=X1m.shape[0], M=int(model.Z.shape[0]), seconds=gram_s,
                    same_bits_as_unsharded=bool(np.array_equal(G, G1m)),
                    gram_rel_err=float(np.abs(gram - ref).max()
                                       / np.abs(ref).max()),
                    launches=capstone_launches)
    emit(phase="sharded_edr", N=N, Q=X.shape[1], n_components=D,
         fit_seconds=fit_s, fits=len(fits), discrepancy=disc,
         principal_angles_deg=principal_angles_deg(B, comps).tolist(),
         angles_to_main_path_deg=principal_angles_deg(main_comps,
                                                      comps).tolist(),
         staged_gram_rel_err=gram_errs, heldout_rmse=rmse,
         heldout_y_std=float(np.std(y_test)), launches=launches,
         svgp_capstone_gram=capstone, peak_mem_gb=_peak_gb(device))
    check(disc < 0.1, f"sharded EDR discrepancy {disc:.3g} >= 0.1")
    check(np.isfinite(pred).all(), "bad sharded EDR predictions")
    check(len(grams) == len(fits) and max(gram_errs) < 1e-4,
          f"a staged Gram is not GᵀG: {gram_errs}")
    check(launches["rbf_grad_mu"] == len(fits),
          f"G did not launch once a fit: {launches}, {len(fits)} fits")
    check(launches["rbf_kernel_matrix"] >= len(fits),
          f"K did not build the sharded slabs: {launches}")
    check(capstone["same_bits_as_unsharded"],
          "the sharded SVGP gradients differ from the unsharded ones")
    check(capstone["gram_rel_err"] < 1e-4,
          f"the SVGP Gram differs by {capstone['gram_rel_err']:.3g}")
    check(capstone_launches["rbf_grad_mu"] == 1,
          f"G did not launch once at N=1,048,576: {capstone_launches}")
    del edr, model
    _empty_cache(device)
    return {k: launches[k] + capstone_launches[k] for k in launches}


def _loaded(path, device):
    """The model pickled at ``path`` by an earlier phase, loaded onto
    ``device``; the file is deleted."""
    from edrgp_tpu_torch.models.state import load_model
    try:
        return load_model(path, device=device)
    finally:
        os.unlink(path)


def _grad_terms(Xnew, C, w, lengthscale, sigma2, rows=8192):
    """For each row x of Xnew, the largest over q of
    Σᵢ |wᵢ| k(x, cᵢ) |cᵢq − xq|/ℓq²: the size of the terms whose sum is
    that row's G.  Where w's entries cancel, the row's float32 rounding is
    a share of this, not of its G."""
    import torch
    from edrgp_tpu_torch.ops.cuda import rbf
    Xs, Cs = Xnew / lengthscale, C / lengthscale
    out = []
    for xs in Xs.split(rows):
        Wk = rbf.rbf_kernel_matrix_plain(xs, Cs, sigma2) * w.abs()[None, :]
        d = (Cs[None] - xs[:, None]).abs() / lengthscale
        out.append(torch.einsum("mn,mnq->mq", Wk, d).amax(1))
    return torch.cat(out).cpu()


def phase_surface(mesh, main_handoff, sparse_path, device="cuda",
                  batch=8192):
    """The routes with no earlier phase of their own:
    ``ops.sgpr.predict_mean_grad_batched`` (batch 8,192) on sparse_edr's
    regressor at its N=100,000 training rows against the unbatched
    ``predict_mean_grad`` and both against the plain version in float64 on
    the card, each row within 1e-6 of the sum of |terms| that its G adds
    (:func:`_grad_terms`), with whether the two are the same bits; ``parallel.edr_sharded.make_sharded_grad_gram`` on
    main_path's GP at its N=8,192 rows against the single-device
    ``exact.predict_mean_grad`` (1e-6) and its Gram against GᵀG (1e-4),
    with the kernel's own parameters and with them passed in (the same
    bits); ``ops.linalg.add_jitter`` on the card against the host (the
    same bits); and PCA's whitening, randomized and ARPACK solvers on
    main_path's gradient matrix on the host, each against the exact
    solver's subspace (< 1e-6), with their host ms."""
    import torch
    from edrgp_tpu_torch import discrepancy
    from edrgp_tpu_torch.decomposition import PCA
    from edrgp_tpu_torch.ops import exact, linalg, sgpr
    from edrgp_tpu_torch.ops.cuda import rbf
    from edrgp_tpu_torch.parallel.edr_sharded import make_sharded_grad_gram
    main_path, G_main = main_handoff
    sparse, gp = _loaded(sparse_path, device), _loaded(main_path, device)
    beta = sparse._posterior()[2]
    Xs = sparse._X
    kernel, C, w = gp._gradient_basis()
    fn = make_sharded_grad_gram(kernel, mesh)
    own = {k: v.detach() for k, v in kernel.named_parameters()}

    rbf.reset_launches()
    t0 = time.perf_counter()
    G_batched = sgpr.predict_mean_grad_batched(sparse, beta, Xs, batch=batch)
    _sync(device)
    batched_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    G_local, gram = fn(None, C, w, gp._X, gp._X.shape[0])
    _sync(device)
    sharded_s = time.perf_counter() - t0
    G_passed, _ = fn(own, C, w, gp._X, gp._X.shape[0])
    launches = dict(rbf.LAUNCHES)

    G_whole = sgpr.predict_mean_grad(sparse, beta, Xs)
    ls, var = exact._scaled_rbf(sparse.kernel, Xs.shape[1])
    args64 = [t.detach().double() for t in (Xs, sparse.Z, beta, ls, var)]
    G64 = rbf.rbf_grad_mu_plain(*args64).cpu()
    terms = _grad_terms(*args64).clamp_min(torch.finfo(torch.float64).tiny)
    G_single = exact.predict_mean_grad(gp, C, w, gp._X)
    Gl = G_local.double()
    gram_err = _rel_to_max(gram.cpu(), (Gl.T @ Gl).cpu())

    gen = torch.Generator(device=device).manual_seed(0)
    A = torch.randn(4, 512, 512, device=device, generator=gen)
    A = A @ A.mT
    jit = torch.rand(4, 1, 1, device=device, generator=gen) * 1e-3
    eye = torch.eye(512)
    jitter_same = (torch.equal(linalg.add_jitter(A, jit).cpu(),
                               A.cpu() + jit.cpu() * eye)
                   and torch.equal(linalg.add_jitter(A, 1e-4).cpu(),
                                   A.cpu() + 1e-4 * eye))

    D = 3
    pca = {}
    for name, kw in (("exact", {"svd_solver": "full"}),
                     ("whiten", {"whiten": True}),
                     ("randomized", {"svd_solver": "randomized"}),
                     ("arpack", {"svd_solver": "arpack"})):
        t0 = time.perf_counter()
        p = PCA(n_components=D, random_state=0, **kw).fit(G_main)
        ms = 1e3 * (time.perf_counter() - t0)
        pca[name] = {"host_ms": ms, "components": p.components_.T}
    for name in ("whiten", "randomized", "arpack"):
        pca[name]["discrepancy_to_exact"] = discrepancy(
            pca["exact"]["components"], pca[name]["components"])
    err_to_terms = {
        name: float(((a.cpu().double() - b.cpu().double()).abs().amax(1)
                     / terms).max())
        for name, a, b in (("batched_unbatched", G_batched, G_whole),
                           ("batched_f64", G_batched, G64),
                           ("unbatched_f64", G_whole, G64))}
    emit(phase="surface",
         sgpr_batched=dict(N=Xs.shape[0], M=int(sparse.Z.shape[0]),
                           Q=Xs.shape[1], batch=batch, seconds=batched_s,
                           rel_err=_rel_to_max(G_batched.cpu(),
                                               G_whole.cpu()),
                           same_bits=bool(torch.equal(G_batched, G_whole)),
                           terms_over_max=float(terms.max()
                                                / G64.abs().max()),
                           err_to_terms=err_to_terms,
                           rel_err_f64={"batched": _rel_to_max(
                               G_batched.cpu(), G64), "unbatched":
                               _rel_to_max(G_whole.cpu(), G64)}),
         sharded_grad_gram=dict(N=gp._X.shape[0], seconds=sharded_s,
                                rel_err=_rel_to_max(G_local.cpu(),
                                                    G_single.cpu()),
                                same_bits=bool(torch.equal(G_local,
                                                           G_single)),
                                params_passed_same_bits=bool(
                                    torch.equal(G_passed, G_local)),
                                gram_rel_err=gram_err),
         add_jitter_same_bits=jitter_same,
         pca={k: {f: v for f, v in d.items() if f != "components"}
              for k, d in pca.items()},
         gradient_matrix=list(G_main.shape), launches=launches)
    chunks = -(-Xs.shape[0] // batch)
    check(launches["rbf_grad_mu"] == chunks + 2,
          f"G did not launch once a chunk and once a sharded call: "
          f"{launches}, {chunks} chunks")
    check(max(err_to_terms.values()) < 1e-6,
          f"the batched SGPR gradients, the unbatched ones and float64 "
          f"differ by more than float32 rounding: {err_to_terms}")
    check(_rel_to_max(G_local.cpu(), G_single.cpu()) < 1e-6
          and torch.equal(G_passed, G_local),
          "make_sharded_grad_gram's G differs from the single-device G")
    check(gram_err < 1e-4, f"the sharded Gram differs by {gram_err:.3g}")
    check(jitter_same, "add_jitter on the card differs from the host")
    for name in ("whiten", "randomized", "arpack"):
        d = pca[name]["discrepancy_to_exact"]
        check(d < 1e-6, f"PCA {name}: subspace {d:.3g} from the exact one")
    del sparse, gp
    _empty_cache(device)
    return launches


def phase_sharded_svgp(mesh, device="cuda", B=8192, M=512, Q=8,
                       n_total=10_000_000, ref_steps=10, steps=200,
                       lr=5e-3):
    """``make_sharded_svgp_step`` at config 5's shapes (8,192-row batches,
    M=512, Q=8, N=10M for the ELBO's scale) on the ``data`` dimension: 10
    steps from the same start and batches as ``SVGPModel``'s own step
    (parameters and natural parameters within 1e-4 of their largest
    entry), then steps/s over 200 steps on batches already on the card;
    the kernel launches are those of the 200 sharded steps alone."""
    import torch
    from edrgp_tpu_torch.models.svgp import SVGPModel, _rho
    from edrgp_tpu_torch.ops.cuda import rbf
    from edrgp_tpu_torch.ops.kernels import RBF
    from edrgp_tpu_torch.parallel import make_sharded_svgp_step, shard_along
    rng = np.random.default_rng(7)
    X0, y0, _ = _sgpr_problem(4096, Q, rng)
    own, sharded = (SVGPModel(X0, y0, RBF(Q, ARD=True), num_inducing=M,
                              seed=0, device=device) for _ in range(2))
    Xb, yb, _ = _sgpr_problem((ref_steps + steps) * B, Q, rng)
    Xb = torch.as_tensor(Xb.reshape(-1, B, Q), dtype=own._X.dtype,
                         device=device)
    yb = torch.as_tensor(own.normalizer.normalize(yb).reshape(-1, B),
                         dtype=own._X.dtype, device=device)
    step, opt_init = make_sharded_svgp_step(sharded, mesh, n_total, lr=lr)
    opt, own_opt = opt_init(), torch.optim.Adam(own.parameters(), lr=lr)
    qstate = sharded.qstate
    for t in range(ref_steps):
        own._step(own_opt, Xb[t], yb[t], n_total, _rho(t))
        qstate, elbo = step(opt, qstate, shard_along(mesh, "data", Xb[t]),
                            shard_along(mesh, "data", yb[t]), _rho(t))
    errs = {k: _rel_to_max(p.detach().cpu(), own.state_dict()[k].cpu())
            for k, p in sharded.state_dict().items()}
    errs["theta1"] = _rel_to_max(qstate.theta1.cpu(),
                                 own.qstate.theta1.cpu())
    errs["theta2"] = _rel_to_max(qstate.theta2.cpu(),
                                 own.qstate.theta2.cpu())
    _sync(device)
    rbf.reset_launches()
    t0 = time.perf_counter()
    for t in range(ref_steps, ref_steps + steps):
        qstate, elbo = step(opt, qstate, shard_along(mesh, "data", Xb[t]),
                            shard_along(mesh, "data", yb[t]), _rho(t))
    elbo = float(elbo)
    wall = time.perf_counter() - t0
    launches = dict(rbf.LAUNCHES)
    emit(phase="sharded_svgp", batch=B, num_inducing=M, Q=Q,
         n_total=n_total, ranks=mesh.size(0), ref_steps=ref_steps,
         rel_err_vs_own_step=errs, steps=steps, steps_per_s=steps / wall,
         rows_per_s=steps * B / wall, final_minibatch_elbo=elbo,
         launches=launches)
    check(all(np.isfinite(v) and v < 1e-4 for v in errs.values()),
          f"sharded SVGP steps differ from the model's own: {errs}")
    check(np.isfinite(elbo), "non-finite sharded SVGP ELBO")
    del own, sharded, Xb, yb
    _empty_cache(device)
    return launches


def phase_sharded_samplers(theta_hat, device="cuda", N=1024, Q=4, chains=16,
                           warmup=128, samples=64, max_depth=8, segment=8,
                           particles=256):
    """``run_sharded_nuts`` on nuts_gp's target over a ``chain`` dimension
    (16 chains from the MAP with the Laplace mass, warmup 128, 64 samples,
    depth 8): split-R̂ < 1.05, divergences ≤ 1%, one pooled ε, samples/s;
    K and A once per chain evaluation.  Then one ``run_sharded_smc_stage``
    on 256 particles (θ̂ + 0.5·N(0, I), β from 0 to the next temperature
    that keeps half the ESS), and ``distributed_systematic_resample``
    against ``inference.smc.systematic_resample`` with the same u0."""
    import torch
    from edrgp_tpu_torch.inference import hmc
    from edrgp_tpu_torch.inference.smc import _next_beta, systematic_resample
    from edrgp_tpu_torch.metrics import (effective_sample_size,
                                         potential_scale_reduction)
    from edrgp_tpu_torch.ops.cuda import rbf
    from edrgp_tpu_torch.parallel import (distributed_systematic_resample,
                                          make_mesh, run_sharded_nuts,
                                          run_sharded_smc_stage, shard_along)
    mesh = make_mesh(("chain",))
    _, logprob, loglik, logprior = _gp_target(device, N, Q)
    inv_mass0 = hmc.curvature_inv_mass(logprob, theta_hat)
    D = theta_hat.shape[0]
    q0 = theta_hat + 0.05 * torch.as_tensor(
        np.random.default_rng(1).normal(size=(chains, D)),
        dtype=theta_hat.dtype, device=theta_hat.device)
    clock, calls = _SegmentClock(), []
    _sync(device)
    rbf.reset_launches()
    t0 = clock.last = time.perf_counter()
    qs, info = run_sharded_nuts(
        _counting(logprob, calls), q0, 0, mesh, chain_axis="chain",
        num_warmup=warmup, num_samples=samples, max_depth=max_depth,
        segment_len=segment, inv_mass0=inv_mass0.cpu().numpy(),
        on_segment=clock)
    wall = time.perf_counter() - t0
    nuts_launches = dict(rbf.LAUNCHES)
    steady = clock.sample[1:] or clock.sample
    rhat = potential_scale_reduction(qs)
    ess = effective_sample_size(qs)
    transitions = chains * samples
    eps = np.asarray(info["step_size"])

    parts0 = theta_hat + 0.5 * torch.as_tensor(
        np.random.default_rng(2).normal(size=(particles, D)),
        dtype=theta_hat.dtype, device=theta_hat.device)
    with torch.no_grad():
        beta = float(_next_beta(loglik(parts0), 0.0, 0.5 * particles))
    stage = run_sharded_smc_stage(loglik, logprior, mesh,
                                  particle_axis="chain", num_mcmc=3,
                                  n_leapfrog=10, eps=0.02)
    rbf.reset_launches()
    t0 = time.perf_counter()
    parts, logz = stage(shard_along(mesh, "chain", parts0), 0.0, beta, 3)
    logz = float(logz)
    stage_s = time.perf_counter() - t0
    smc_launches = dict(rbf.LAUNCHES)
    gen = torch.Generator(device=device).manual_seed(4)
    log_w = torch.randn(particles, generator=gen, device=device)
    cloud = torch.randn(particles, D, generator=gen, device=device)
    mine, _ = distributed_systematic_resample(
        0.37, shard_along(mesh, "chain", log_w),
        shard_along(mesh, "chain", cloud), mesh, "chain")
    want = shard_along(mesh, "chain",
                       cloud[systematic_resample(0.37, log_w)])
    same_ancestors = bool(torch.equal(mine, want))
    emit(phase="sharded_samplers", N=N, Q=Q, chains=chains, warmup=warmup,
         samples=samples, max_depth=max_depth, ranks=mesh.size(0),
         wall_s=wall, samples_per_s=chains * segment
         / float(np.median(steady)),
         samples_per_s_incl_warmup=transitions / wall,
         max_split_rhat=float(rhat.max()), min_ess=float(ess.min()),
         divergences=info["divergences"], accept_rate=info["accept_rate"],
         step_size=eps.tolist(), chain_evaluations=sum(calls),
         nuts_launches=nuts_launches, smc_particles=particles, smc_beta=beta,
         smc_log_evidence_increment=logz, smc_stage_seconds=stage_s,
         smc_launches=smc_launches, resample_same_ancestors=same_ancestors)
    check(np.isfinite(qs).all(), "non-finite sharded NUTS draws")
    check(rhat.max() < 1.05, f"sharded NUTS split-R-hat {rhat.max():.4f}")
    check(info["divergences"] <= 0.01 * transitions,
          f"{info['divergences']} divergences in {transitions} transitions")
    check(np.all(eps == eps[0]), f"step sizes not pooled: {eps}")
    check(nuts_launches["rbf_kernel_matrix"] >= sum(calls)
          and nuts_launches["rbf_nlml_adjoint"] >= sum(calls),
          f"K or A missed a chain evaluation: {nuts_launches}")
    check(bool(torch.isfinite(parts).all()) and np.isfinite(logz)
          and 0.0 < beta <= 1.0, f"bad SMC stage: β {beta}, logZ {logz}")
    check(same_ancestors, "the distributed resample picked other ancestors")
    return {k: nuts_launches[k] + smc_launches[k] for k in nuts_launches}


def _trace_stats(events):
    """Kernel events of a Chrome trace, its runtime launches, each
    kernel's start less its launch's and each launch's start less that of
    the operator that made it (µs)."""
    kernels = [e for e in events if e.get("cat") == "kernel"]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") == "cuda_runtime"
                and "Launch" in e.get("name", "")
                and "correlation" in e.get("args", {})}
    offsets = [k["ts"] - launches[k["args"]["correlation"]]["ts"]
               for k in kernels
               if k.get("args", {}).get("correlation") in launches]
    # A launch's time is on the card's profiling clock, its operator's on
    # the host profiler's: a launch before the operator that made it shows
    # the two clocks apart.
    ops = {e["args"]["External id"]: e for e in events
           if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}
    gaps = [l["ts"] - ops[l["args"]["External id"]]["ts"]
            for l in launches.values()
            if l["args"].get("External id") in ops]
    out = dict(kernel_events=len(kernels), launch_events=len(launches),
               kernel_names=sorted({k.get("name", "") for k in kernels}))
    for key, xs in (("kernel_minus_launch_us", offsets),
                    ("launch_minus_operator_us", gaps)):
        if xs:
            out[key] = dict(min=float(np.min(xs)),
                            median=float(np.median(xs)),
                            max=float(np.max(xs)))
    return out


def _trace_sharded_nlml(mesh, scratch, device="cuda"):
    """``profiling.trace`` around one sharded NLML evaluation (N=2,048,
    Q=8) after a warm one: (the trace's ``_trace_stats``, whether it names
    kernel K, what ``profiling.trace`` reported of lost kernels: its
    warning or error, or None)."""
    import warnings
    from edrgp_tpu_torch import profiling
    from edrgp_tpu_torch.models.state import ExactGPModel
    from edrgp_tpu_torch.ops.kernels import RBF
    from edrgp_tpu_torch.parallel import sharded_nlml_value_and_grad
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2048, 8))
    m = ExactGPModel(X, np.sin(X[:, 0]), RBF(8, ARD=True), device=device)
    sharded_nlml_value_and_grad(m, mesh, m._X, m._y)          # warm
    reported = None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            with profiling.trace(scratch):
                sharded_nlml_value_and_grad(m, mesh, m._X, m._y)
        except RuntimeError as e:
            reported = str(e)
    reported = reported or next((str(w.message) for w in caught
                                 if "kernel launches but" in str(w.message)),
                                None)
    with open(os.path.join(scratch, "trace.json")) as f:
        trace = f.read()
    stats = _trace_stats(json.loads(trace).get("traceEvents", []))
    stats["trace_mb"] = len(trace) / 1e6
    names_k = any("kmat_kernel" in k for k in stats["kernel_names"])
    return stats, names_k, reported


def phase_trace(device="cuda"):
    """``profiling.trace`` of one sharded NLML evaluation (N=2,048, Q=8)
    in a one-rank NCCL group joined for it, right after the build: the
    Chrome trace must name kernel K.  It runs before the sampler phases,
    after which PyTorch's profiler loses kernel records (ROADMAP Queue 3;
    aux checks ``profiling.trace``'s report of that at the end)."""
    import shutil
    import torch.distributed as dist
    from edrgp_tpu_torch.parallel import initialize, make_mesh
    initialize(device=device)
    scratch = os.path.join(ROOT, "build", f"trace-{os.getpid()}")
    try:
        stats, names_k, reported = _trace_sharded_nlml(
            make_mesh(("data",)), scratch, device)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
        dist.destroy_process_group()
    kernels = stats.pop("kernel_names")
    emit(phase="trace", trace_names_kernel_K=names_k, trace=stats,
         lost_kernels_report=reported, trace_kernel_names=len(kernels),
         trace_kernels_sample=[k[:80] for k in kernels[:12]])
    check(names_k, f"the profiler trace does not name kernel K: "
          f"{len(kernels)} kernel names, {kernels[:12]}")


def phase_aux(mesh, theta_hat, device="cuda", N=1024, Q=4, chains=16):
    """A checkpoint of a NUTS chain batch's ``HMCState`` and
    ``AdaptState`` (config 4's target, chains around nuts_gp's MAP) on the
    card round-trips with the same bits, dtype and device;
    ``StallWatchdog`` fires on a 2-second stall past its 1-second deadline
    and stays quiet while beaten; ``profiling.trace`` of one sharded NLML
    evaluation (N=2,048, Q=8), taken last, after the sampler phases, either
    holds a kernel for every launch and names kernel K, or reports the
    kernels the profiler lost (a warning, or an error when none is left):
    it never hands back a partial trace without saying so."""
    import shutil
    import torch
    from edrgp_tpu_torch import checkpoint
    from edrgp_tpu_torch.inference import hmc
    from edrgp_tpu_torch.parallel import StallWatchdog
    _, logprob, _, _ = _gp_target(device, N, Q)
    q0 = theta_hat + 0.05 * torch.as_tensor(
        np.random.default_rng(1).normal(size=(chains, theta_hat.shape[0])),
        dtype=theta_hat.dtype, device=theta_hat.device)
    state = hmc.init_state(logprob, q0)
    adapt = hmc.window_adaptation_update(
        hmc.window_adaptation_init(q0, 0.1), state.q,
        torch.full((chains,), 0.7, dtype=q0.dtype, device=q0.device))
    tree = {"state": state, "adapt": adapt, "step": 5}
    scratch = os.path.join(ROOT, "build", f"aux-{os.getpid()}")
    try:
        checkpoint.save_checkpoint(scratch, tree, 5)
        like = {"state": hmc.HMCState(*(torch.zeros_like(t) for t in state)),
                "adapt": hmc.AdaptState(*(torch.zeros_like(t)
                                          for t in adapt)), "step": 0}
        back, step = checkpoint.load_checkpoint(scratch, like)
        pairs = list(zip((*state, *adapt), (*back["state"], *back["adapt"])))
        roundtrip = (step == 5 and back["step"] == 5 and all(
            b.device == a.device and b.dtype == a.dtype and torch.equal(a, b)
            for a, b in pairs))

        fired = StallWatchdog(timeout_s=1.0, poll_s=0.1,
                              on_stall=lambda *_: None)
        with fired as dog:
            dog.beat(0)
            time.sleep(2.0)
        quiet = StallWatchdog(timeout_s=1.0, poll_s=0.1)
        with quiet as dog:
            for i in range(20):
                time.sleep(0.1)
                dog.beat(i)

        stats, names_k, reported = _trace_sharded_nlml(mesh, scratch, device)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    kernels = stats.pop("kernel_names")
    complete = stats["kernel_events"] >= stats["launch_events"]
    emit(phase="aux", checkpoint_roundtrip_bitwise=roundtrip,
         checkpoint_leaves=len(pairs) + 1, watchdog_fired_on_stall=fired.fired,
         watchdog_quiet_while_beaten=not quiet.fired,
         trace_names_kernel_K=names_k, trace_complete=complete,
         trace=stats, lost_kernels_report=reported,
         trace_kernel_names=len(kernels))
    check(roundtrip, "the NUTS state's checkpoint did not round-trip")
    check(fired.fired and not quiet.fired,
          f"watchdog: fired {fired.fired} on a stall, {quiet.fired} beaten")
    check((complete and names_k) or reported is not None,
          f"profiling.trace handed back a trace without kernel K or with "
          f"{stats['kernel_events']} kernels for {stats['launch_events']} "
          "launches, and did not say so")


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
    phase_trace()
    summary = phase_kernels()
    phase_nlml()
    phase_kinv()
    phase_small_reference()
    launches, main_comps, main_handoff = phase_main_path()
    finish_notebooks = phase_notebooks()
    entry_launches = phase_entry()
    phase_sgpr()
    sparse_launches, sparse_path = phase_sparse_edr()
    refit_launches = phase_sparse_refit()
    notebook_launches = finish_notebooks()
    phase_svgp_reference()
    stream_launches = phase_svgp_stream()
    svgp_edr_launches, handoff = phase_svgp_edr()
    try:
        phase_cls_reference()
        cls_ep_launches = phase_cls_ep_edr()
        cls_sparse_launches = phase_cls_sparse_edr()
        phase_het_reference()
        het_launches = phase_het_edr()
        phase_sampler_reference()
        nuts_launches, theta_hat, nuts_qs = phase_nuts_gp()
        smc_launches = phase_smc_gp(theta_hat, nuts_qs)
        bayes_launches = phase_bayes_edr()
        mesh = phase_distributed()
        try:
            sharded_nlml_launches = phase_sharded_nlml(mesh)
            sharded_edr_launches = phase_sharded_edr(mesh, main_comps,
                                                     handoff)
            surface_launches = phase_surface(mesh, main_handoff,
                                             sparse_path)
            sharded_svgp_launches = phase_sharded_svgp(mesh)
            sharded_sampler_launches = phase_sharded_samplers(theta_hat)
            phase_aux(mesh, theta_hat)
            dryrun_launches = phase_dryrun()
        finally:
            import torch.distributed as dist
            dist.destroy_process_group()
    finally:
        for path in (handoff[0], main_handoff[0], sparse_path):
            if os.path.exists(path):
                os.unlink(path)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": where,
         "launches": launches[name],
         "launches_by_path": {"main_path": launches[name],
                              "notebooks": notebook_launches[name],
                              "entry": entry_launches[name],
                              "sparse_edr": sparse_launches[name],
                              "sparse_refit": refit_launches[name],
                              "svgp_stream": stream_launches[name],
                              "svgp_edr": svgp_edr_launches[name],
                              "cls_ep_edr": cls_ep_launches[name],
                              "cls_sparse_edr": cls_sparse_launches[name],
                              "het_edr": het_launches[name],
                              "nuts_gp": nuts_launches[name],
                              "smc_gp": smc_launches[name],
                              "bayes_edr": bayes_launches[name],
                              "sharded_nlml": sharded_nlml_launches[name],
                              "sharded_edr": sharded_edr_launches[name],
                              "surface": surface_launches[name],
                              "sharded_svgp": sharded_svgp_launches[name],
                              "sharded_samplers":
                                  sharded_sampler_launches[name],
                              "dryrun_multichip": dryrun_launches[name]},
         **summary[name]}
        for name, where in KERNELS.items()]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
