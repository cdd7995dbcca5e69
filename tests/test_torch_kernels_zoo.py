"""The port's kernel zoo (edrgp_tpu_torch.ops.kernels) against the JAX
package, float64 on the CPU.

Every registry kernel, a sum, a product and kernels on ``active_dims`` are
built the same way in both packages, given the same non-default parameters
through ``convert.params_from_jax``, and held to rtol 1e-10 in K, Kdiag and
the gradients of Σ K and Σ Kdiag in the parameters and in X.  An exact GP
with a Matern52 + White kernel (the generic autograd path, no RBF kernel)
is held to the JAX NLML and its gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_ranks import one_torch_thread  # noqa: F401 (autouse)
from edrgp_tpu.models.state import ExactGPModel as JExactGPModel
from edrgp_tpu.ops import exact as jexact
from edrgp_tpu.ops import kernels as jk
from edrgp_tpu_torch.convert import params_from_jax, params_to_numpy
from edrgp_tpu_torch.models.state import ExactGPModel
from edrgp_tpu_torch.ops import exact
from edrgp_tpu_torch.ops import kernels as tk

Q = 3

#: Options per registry name: the canonical names take their ARD forms,
#: the aliases the isotropic defaults, so both shapes are covered.
OPTIONS = {"RBF": {"ARD": True}, "Exponential": {"ARD": True},
           "Matern32": {"ARD": True}, "Matern52": {"ARD": True},
           "RatQuad": {"ARD": True, "power": 1.5},
           "Cosine": {"ARD": True}, "Linear": {"ARD": True},
           "MLP": {"ARD": True}, "Poly": {"order": 2},
           "StdPeriodic": {"ARD1": True, "ARD2": True}}
CASES = sorted(jk.KERNEL_REGISTRY) + ["Sum", "Product", "active_dims"]


def _build(K, case):
    """The same kernel from either package's module ``K``."""
    if case == "Sum":
        return K.make_kernel(["RBF", "Linear", "White"],
                             [{"ARD": True}, {}, {}], Q)
    if case == "Product":
        return K.Matern32(Q) * K.Bias(Q) * K.Linear(Q, ARD=True)
    if case == "active_dims":
        return (K.RBF(Q, ARD=True, active_dims=[0, 2])
                + K.Linear(Q, active_dims=[1]))
    return K.make_kernel(case, OPTIONS.get(case), Q)


def _pair(case, seed=0):
    """(JAX kernel, its params as numpy, the port's kernel at them)."""
    rng = np.random.default_rng(seed)
    jkern = _build(jk, case)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.3 * rng.normal(size=np.shape(a)),
        jkern.init_params())
    tkern = _build(tk, case)
    tkern.load_state_dict(params_from_jax(params))
    return jkern, params, tkern


def _grad(t):
    """A tensor's gradient as numpy; zeros where it got none (a kernel
    that does not depend on it), as JAX gives them."""
    return np.zeros(t.shape) if t.grad is None else t.grad.numpy()


def _backward(total):
    """Backward of a sum; White's cross-covariance and Bias's values are
    constants, which leave every gradient at zero (None here)."""
    if total.requires_grad:
        total.backward()


def _grads(module):
    return {n: _grad(p) for n, p in module.named_parameters()}


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * 1e-3 * max(np.abs(want).max(), 1))


@pytest.mark.parametrize("case", CASES)
def test_kernel_values_and_gradients_match_jax(case):
    jkern, params, tkern = _pair(case)
    rng = np.random.default_rng(1)
    X1, X2 = rng.normal(size=(7, Q)), rng.normal(size=(5, Q))
    jp = jax.tree_util.tree_map(jnp.asarray, params)

    X1t = torch.from_numpy(X1).requires_grad_(True)
    X2t = torch.from_numpy(X2)
    with torch.no_grad():
        _close(tkern.K(X1t, X2t), jkern.K(jp, jnp.asarray(X1),
                                          jnp.asarray(X2)), 1e-10)
        _close(tkern.Kdiag(X2t), jkern.Kdiag(jp, jnp.asarray(X2)), 1e-10)

    g_p, g_x = jax.grad(lambda p, A: jnp.sum(jkern.K(p, A, jnp.asarray(X2))),
                        argnums=(0, 1))(jp, jnp.asarray(X1))
    tkern.zero_grad()
    _backward(tkern.K(X1t, X2t).sum())
    want = {k: v.numpy() for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, g_p)).items()}
    got = _grads(tkern)
    assert got.keys() == want.keys()
    for name in want:
        _close(got[name], want[name], 1e-10)
    _close(_grad(X1t), g_x, 1e-10)

    g_d = jax.grad(lambda p: jnp.sum(jkern.Kdiag(p, jnp.asarray(X2))))(jp)
    tkern.zero_grad()
    _backward(tkern.Kdiag(X2t).sum())
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, g_d))
    got = _grads(tkern)
    for name in want:
        _close(got[name], want[name].numpy(), 1e-10)


#: K(X, X) on one set holds r² ≈ 1e-16 of matmul residue on its diagonal,
#: which each package rounds its own way; a kernel linear in r = √r² near
#: r = 0 turns that into ~1e-8 (ROADMAP Queue 3).
_SQRT_RESIDUE = pytest.mark.xfail(
    strict=True, reason="diagonal r² residue of the matmul distance, "
    "amplified by √ in exp(−r): 6.1e-8 apart at rtol 1e-10")


@pytest.mark.parametrize("case", [
    pytest.param(c, marks=_SQRT_RESIDUE) if c == "Exponential" else c
    for c in CASES])
def test_same_set_kernel_matches_jax(case):
    """K(X, X) with one object as both arguments, as the NLML builds it:
    White and sums holding it put σ² on the diagonal."""
    jkern, params, tkern = _pair(case)
    X = np.random.default_rng(1).normal(size=(12, Q))[7:]
    Xj = jnp.asarray(X)
    Xt = torch.from_numpy(X)
    with torch.no_grad():
        got = tkern.K(Xt, Xt)
    _close(got, jkern.K(jax.tree_util.tree_map(jnp.asarray, params), Xj, Xj),
           1e-10)


@pytest.mark.parametrize("case", CASES)
def test_kernel_spec_and_params_round_trip(case):
    """The structure survives kernel_spec → kernel_from_spec, and the
    parameters params_to_numpy → params_from_jax, bit for bit; the numpy
    layout is the JAX pytree's (tuples for the parts of a sum)."""
    _, params, tkern = _pair(case)
    rebuilt = tk.kernel_from_spec(tk.kernel_spec(tkern))
    assert type(rebuilt) is type(tkern)
    tree = params_to_numpy(tkern)
    assert (jax.tree_util.tree_structure(tree)
            == jax.tree_util.tree_structure(params))
    rebuilt.load_state_dict(params_from_jax(tree))
    for (n, a), (m, b) in zip(tkern.state_dict().items(),
                              rebuilt.state_dict().items()):
        assert n == m and torch.equal(a, b)


def test_white_is_noise_only_on_the_same_set():
    kern = tk.White(2, variance=0.5)
    X = torch.randn(4, 2, dtype=torch.float64)
    kern.requires_grad_(False)
    np.testing.assert_allclose(kern.K(X, X).numpy(), 0.5 * np.eye(4),
                               rtol=1e-12)
    assert not kern.K(X, X.clone()).any()
    assert not (kern + tk.Bias(2)).K(X, X[:3]).sub(1.0).any()


def test_make_kernel_errors_and_composition():
    with pytest.raises(ValueError, match="Unknown kernel"):
        tk.make_kernel("NotAKernel", None, 2)
    with pytest.raises(ValueError, match="same length"):
        tk.make_kernel(["RBF", "Linear"], [{}], 2)
    with pytest.raises(ValueError, match="Unknown kernel class"):
        tk.kernel_from_spec({"class": "NotAKernel", "args": {}})
    k = tk.make_kernel(["RBF", "White"], None, 2)
    assert isinstance(k, tk.Sum) and len(k.kernels) == 2
    assert tk.make_kernel(k, None, 2) is k
    assert isinstance(tk.make_kernel(None, None, 2), tk.RBF)
    p = (tk.RBF(2) * tk.Bias(2)) * tk.Linear(2)
    assert isinstance(p, tk.Product) and len(p.kernels) == 3
    s = p + tk.White(2)
    assert isinstance(s, tk.Sum) and len(s.kernels) == 2
    tk.register_kernel("MyRBF", tk.RBF)
    try:
        assert isinstance(tk.make_kernel("MyRBF", None, 2), tk.RBF)
    finally:
        del tk.KERNEL_REGISTRY["MyRBF"]


def test_register_kernel_builds_by_name_in_both_packages():
    """A class registered through each package's ``ops.register_kernel`` is
    built by ``make_kernel`` by name, with its options, and gives the same
    K at the same parameters (1e-12)."""
    import edrgp_tpu.ops as jops
    import edrgp_tpu_torch.ops as tops
    assert "register_kernel" in tops.__all__
    X = np.random.default_rng(3).normal(size=(9, Q))
    try:
        for ops in (jops, tops):
            ops.register_kernel("RegisteredMatern", ops.kernels.Matern52)
        jkern = jops.make_kernel("RegisteredMatern", {"ARD": True}, Q)
        tkern = tops.make_kernel(["RegisteredMatern"], [{"ARD": True}], Q)
        assert type(jkern) is jk.Matern52 and type(tkern) is tk.Matern52
        params = {"variance": np.array(0.2),
                  "lengthscale": np.array([0.1, -0.4, 0.7])}
        tkern.load_state_dict(params_from_jax(params))
        want = jkern.K(jax.tree_util.tree_map(jnp.asarray, params),
                       jnp.asarray(X), jnp.asarray(X[:4]))
        _close(tkern.K(torch.from_numpy(X), torch.from_numpy(X[:4]))
               .detach(), want, 1e-12)
    finally:
        for ops in (jops, tops):
            ops.KERNEL_REGISTRY.pop("RegisteredMatern", None)


def test_exact_gp_with_matern52_plus_white_matches_jax():
    rng = np.random.default_rng(4)
    n = 60
    X = rng.normal(size=(n, Q))
    y = np.sin(X[:, 0]) + 0.5 * X[:, 1] + 0.1 * rng.normal(size=n)
    jm = JExactGPModel(X, y, jk.Matern52(Q, ARD=True) + jk.White(Q))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.2 * rng.normal(size=np.shape(a)),
        jm.params)
    jm.params = jax.tree_util.tree_map(jnp.asarray, params)
    m = ExactGPModel(X, y, tk.Matern52(Q, ARD=True) + tk.White(Q),
                     device="cpu")
    m.load_state_dict(params_from_jax(params))
    # only a plain full-dimension RBF reaches the CUDA kernels
    for kern in (m.kernel, tk.RBF(Q) + tk.RBF(Q),
                 tk.RBF(Q, active_dims=[0, 1])):
        assert not exact._fused(kern, m._X)
    assert exact._fused(tk.RBF(Q, ARD=True), m._X)

    v_ref, g_ref = jax.value_and_grad(
        lambda p: jexact.nlml(jm.kernel, p, jm._X, jm._y))(jm.params)
    v = exact.nlml(m, m._X, m._y)
    v.backward()
    np.testing.assert_allclose(v.item(), float(v_ref), rtol=1e-9)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, g_ref))
    for name, p in m.named_parameters():
        _close(p.grad.numpy(), want[name].numpy(), 1e-9)

    hyper, jhyper = m.get_hyperparameters(), jm.get_hyperparameters()
    assert hyper.keys() == jhyper.keys()
    for key in hyper:
        np.testing.assert_allclose(hyper[key], jhyper[key], rtol=1e-12)
