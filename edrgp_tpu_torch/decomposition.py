"""Linear DR methods for the EDR layer: PCA and SparsePCA (numpy).

The JAX package takes ``PCA`` and ``SparsePCA`` from scikit-learn as the DR
method, the preprocessor and the sparse refit of its EDR; the port carries
its own, with scikit-learn's parameter names, fitted attributes and
numbers, as it carries ``StandardScaler`` and ``clone`` (:mod:`.estimator`).

* :class:`PCA` follows ``sklearn/decomposition/_pca.py``: centre on
  ``mean_``, take the top right-singular vectors signed as
  ``svd_flip(..., u_based_decision=False)`` signs them, and the variances
  with divisor N − 1, by an exact SVD, scikit-learn's randomized SVD
  (``utils/extmath.py``: ``_randomized_range_finder``, ``_randomized_svd``)
  or ARPACK through SciPy's ``svds``, each drawing from ``random_state`` as
  scikit-learn does; ``whiten`` scales ``transform`` by the variances.
* :class:`SparsePCA` follows ``sklearn/decomposition/_sparse_pca.py``
  (``fit``, ``_fit``, ``transform``) over ``_dict_learning.py``
  (``_dict_learning``, ``_update_dict``, ``_sparse_encode_precomputed``):
  dictionary learning on the centred Xᵀ from an SVD start, alternating a
  lasso per row for the codes with block-coordinate dictionary updates,
  until the cost's relative decrease falls below ``tol``.  scikit-learn
  solves each lasso by LARS; here it is solved to convergence by
  coordinate descent, which reaches the same solution where the lasso's is
  unique (a dictionary of full row rank).  Unused atoms are resampled from
  ``np.random.RandomState(random_state)`` in scikit-learn's order, so a
  seed gives scikit-learn's components.

Both are host code: the EDR layer holds the [N, Q] gradient matrix on the
host, and each iteration here is O(N·Q·k).
"""

from __future__ import annotations

import numpy as np

from .estimator import (BaseEstimator, TransformerMixin, check_array,
                        check_is_fitted)

__all__ = ["PCA", "SparsePCA"]


def svd_flip(u, v, u_based_decision: bool = True):
    """Signs of an SVD made deterministic, as scikit-learn's
    ``utils.extmath.svd_flip``: each column of u (``u_based_decision``) or
    row of v is turned so that its entry of largest magnitude is positive,
    and the matching row of v or column of u with it.  A zero column or row
    has sign 0 and zeroes its partner.  u may be None when v decides."""
    if u_based_decision:
        signs = np.sign(u[np.argmax(np.abs(u), axis=0), np.arange(u.shape[1])])
    else:
        signs = np.sign(v[np.arange(v.shape[0]), np.argmax(np.abs(v), axis=1)])
    if u is not None:
        u = u * signs
    return u, v * signs[:, np.newaxis]


def check_random_state(seed) -> np.random.RandomState:
    """scikit-learn's ``check_random_state``: None → NumPy's global
    ``RandomState``, an int → a new one seeded with it, a ``RandomState``
    → itself."""
    if seed is None:
        return np.random.mtrand._rand
    if isinstance(seed, (int, np.integer)):
        return np.random.RandomState(seed)
    if isinstance(seed, np.random.RandomState):
        return seed
    raise ValueError(f"{seed!r} cannot be used to seed a RandomState")


def _randomized_range_finder(A, size: int, n_iter: int,
                             power_iteration_normalizer: str, random_state):
    """scikit-learn's ``_randomized_range_finder``: an orthonormal basis
    [n, size] of the range of A from a Gaussian sketch ``random_state.
    normal(size=(A.shape[1], size))``, after ``n_iter`` power iterations
    normalised by LU (``"auto"`` above 2 iterations), QR or nothing."""
    from scipy import linalg
    Q = random_state.normal(size=(A.shape[1], size))
    if power_iteration_normalizer == "auto":
        power_iteration_normalizer = "none" if n_iter <= 2 else "LU"
    if power_iteration_normalizer == "QR":
        def normalizer(M):
            return linalg.qr(M, mode="economic", check_finite=False)[0]
    elif power_iteration_normalizer == "LU":
        def normalizer(M):
            return linalg.lu(M, permute_l=True, check_finite=False)[0]
    else:
        def normalizer(M):
            return M
    for _ in range(n_iter):
        Q = normalizer(A @ Q)
        Q = normalizer(A.T @ Q)
    return linalg.qr(A @ Q, mode="economic", check_finite=False)[0]


def _randomized_svd(M, n_components: int, n_oversamples: int, n_iter,
                    power_iteration_normalizer: str, random_state):
    """scikit-learn's ``_randomized_svd`` with ``flip_sign=False``: the
    range of M (of Mᵀ when M is wide) from :func:`_randomized_range_finder`
    with ``n_components + n_oversamples`` columns, an exact SVD of M
    projected on it, the leading ``n_components`` triplets."""
    from scipy import linalg
    if n_iter == "auto":
        n_iter = 7 if n_components < 0.1 * min(M.shape) else 4
    transpose = M.shape[0] < M.shape[1]
    if transpose:
        M = M.T
    Q = _randomized_range_finder(M, n_components + n_oversamples, n_iter,
                                 power_iteration_normalizer, random_state)
    Uhat, S, Vt = linalg.svd(Q.T @ M, full_matrices=False,
                             lapack_driver="gesdd")
    U = Q @ Uhat
    if transpose:
        return Vt[:n_components].T, S[:n_components], U[:, :n_components].T
    return U[:, :n_components], S[:n_components], Vt[:n_components]


class PCA(BaseEstimator, TransformerMixin):
    """Principal component analysis, as ``sklearn.decomposition.PCA``.

    ``n_components``: None keeps min(n_samples, n_features) (one fewer for
    ``"arpack"``); an int keeps that many; a float in (0, 1) keeps the
    fewest whose cumulative explained-variance ratio exceeds it (exact
    solvers only).  ``svd_solver``:

    * ``"full"`` and ``"covariance_eigh"``: the exact SVD of the centred
      data;
    * ``"randomized"``: Halko et al.'s randomized SVD with
      ``n_oversamples``, ``iterated_power`` power iterations and
      ``power_iteration_normalizer``, its sketch drawn from
      ``random_state``;
    * ``"arpack"``: ``scipy.sparse.linalg.svds`` with ``tol`` from
      ``random_state.uniform(-1, 1, min(X.shape))``;
    * ``"auto"``: scikit-learn's choice among them from the shape.

    Components are signed as ``svd_flip(..., u_based_decision=False)``
    signs them.  ``whiten`` divides ``transform``'s output by
    √``explained_variance_``; ``components_`` stay unit rows.  Input is
    taken in float64.

    Attributes: ``components_`` (n_components, n_features), ``mean_``,
    ``explained_variance_`` (divisor N − 1), ``explained_variance_ratio_``,
    ``singular_values_``, ``n_components_``, ``n_samples_``.
    """

    _SOLVERS = ("auto", "full", "covariance_eigh", "randomized", "arpack")
    _NORMALIZERS = ("auto", "QR", "LU", "none")

    def __init__(self, n_components=None, *, whiten=False, svd_solver="auto",
                 tol=0.0, iterated_power="auto", n_oversamples=10,
                 power_iteration_normalizer="auto", random_state=None):
        self.n_components = n_components
        self.whiten = whiten
        self.svd_solver = svd_solver
        self.tol = tol
        self.iterated_power = iterated_power
        self.n_oversamples = n_oversamples
        self.power_iteration_normalizer = power_iteration_normalizer
        self.random_state = random_state

    def _solver(self, n_samples: int, n_features: int) -> str:
        """``svd_solver`` with ``"auto"`` resolved as scikit-learn resolves
        it for dense input."""
        if self.svd_solver not in self._SOLVERS:
            raise ValueError(f"svd_solver={self.svd_solver!r} is not "
                             f"supported: one of {self._SOLVERS}")
        if self.power_iteration_normalizer not in self._NORMALIZERS:
            raise ValueError(
                f"power_iteration_normalizer="
                f"{self.power_iteration_normalizer!r} is not supported: "
                f"one of {self._NORMALIZERS}")
        if self.svd_solver != "auto":
            return self.svd_solver
        nc = min(n_samples, n_features) if self.n_components is None \
            else self.n_components
        if n_features <= 1_000 and n_samples >= 10 * n_features:
            return "covariance_eigh"
        if max(n_samples, n_features) <= 500 or isinstance(nc, str):
            return "full"
        if 1 <= nc < 0.8 * min(n_samples, n_features):
            return "randomized"
        return "full"

    def fit(self, X, y=None):
        X = check_array(X).astype(np.float64, copy=False)
        n_samples, n_features = X.shape
        solver = self._solver(n_samples, n_features)
        self.mean_ = X.mean(axis=0)
        Xc = X - self.mean_
        if solver in ("randomized", "arpack"):
            k = self._n_truncated(solver, n_samples, n_features)
            random_state = check_random_state(self.random_state)
            if solver == "arpack":
                from scipy.sparse.linalg import svds
                v0 = random_state.uniform(-1, 1, min(X.shape))
                _, S, Vt = svds(Xc, k=k, tol=self.tol, v0=v0)
                S, Vt = S[::-1], Vt[::-1]
            else:
                _, S, Vt = _randomized_svd(
                    Xc, k, self.n_oversamples, self.iterated_power,
                    self.power_iteration_normalizer, random_state)
            _, Vt = svd_flip(None, Vt, u_based_decision=False)
            variance = S ** 2 / (n_samples - 1)
            ratio = variance / (np.sum(Xc ** 2) / (n_samples - 1))
        else:
            _, S, Vt = np.linalg.svd(Xc, full_matrices=False)
            _, Vt = svd_flip(None, Vt, u_based_decision=False)
            variance = S ** 2 / max(n_samples - 1, 1)
            total = variance.sum()
            ratio = variance / total if total > 0 else np.zeros_like(variance)
            k = self._n_keep(ratio, n_samples, n_features)
        self.components_ = Vt[:k]
        self.explained_variance_ = variance[:k]
        self.explained_variance_ratio_ = ratio[:k]
        self.singular_values_ = S[:k]
        self.n_components_ = k
        self.n_samples_ = n_samples
        return self

    def _n_truncated(self, solver: str, n_samples: int,
                     n_features: int) -> int:
        """The number of components of a truncated solver, with
        scikit-learn's bounds: an int in [1, min(shape)], below min(shape)
        for ARPACK, whose default is min(shape) − 1."""
        most = min(n_samples, n_features)
        nc = self.n_components
        if nc is None:
            nc = most - 1 if solver == "arpack" else most
        if (isinstance(nc, bool) or not isinstance(nc, (int, np.integer))
                or not 1 <= nc <= most):
            raise ValueError(f"n_components={nc!r} must be an int between 1 "
                             f"and min(n_samples, n_features)={most} with "
                             f"svd_solver={solver!r}")
        if solver == "arpack" and nc == most:
            raise ValueError(f"n_components={nc!r} must be strictly less "
                             f"than min(n_samples, n_features)={most} with "
                             "svd_solver='arpack'")
        return int(nc)

    def _n_keep(self, ratio, n_samples: int, n_features: int) -> int:
        nc, most = self.n_components, min(n_samples, n_features)
        if nc is None:
            return most
        if isinstance(nc, (int, np.integer)) and not isinstance(nc, bool):
            if not 0 <= nc <= most:
                raise ValueError(f"n_components={nc} must be between 0 and "
                                 f"min(n_samples, n_features)={most}")
            return int(nc)
        if isinstance(nc, float) and 0.0 < nc < 1.0:
            return int(np.searchsorted(np.cumsum(ratio), nc,
                                       side="right") + 1)
        raise ValueError(f"n_components={nc!r} is not supported")

    def transform(self, X):
        check_is_fitted(self, "components_")
        Xt = (check_array(X) - self.mean_) @ self.components_.T
        if self.whiten:
            scale = np.sqrt(self.explained_variance_)
            Xt = Xt / np.maximum(scale, np.finfo(scale.dtype).eps)
        return Xt


def _lasso_exact(gram, cov, alpha: float, code):
    """The lasso's solution on the supports and signs of ``code`` when it
    is the solution: each row's equality system G_SS c_S = cov_S − α·s on
    its nonzero set S with signs s, kept only if the signs hold and every
    coordinate off S meets |covⱼ − Gⱼ·c| ≤ α (the optimality conditions).
    None where any row fails."""
    out = np.zeros_like(code)
    slack = alpha * 1e-9 + 1e-12 * float(np.max(np.abs(cov), initial=0.0))
    for i, row in enumerate(code):
        S = np.flatnonzero(row)
        if S.size:
            s = np.sign(row[S])
            try:
                c_S = np.linalg.solve(gram[np.ix_(S, S)],
                                      cov[S, i] - alpha * s)
            except np.linalg.LinAlgError:
                return None
            if np.any(np.sign(c_S) != s):
                return None
            out[i, S] = c_S
        off = np.ones(len(row), dtype=bool)
        off[S] = False
        if np.any(np.abs(cov[off, i] - gram[off] @ out[i]) > alpha + slack):
            return None
    return out


def _lasso_cd(gram, cov, alpha: float, code, tol: float = 1e-15,
              max_sweeps: int = 10_000, check_every: int = 16):
    """Rows c of ``code`` [n, k] minimising ½cᵀGc − cᵀcovᵢ + α‖c‖₁ for
    ``gram`` G [k, k] and ``cov`` [k, n], by cyclic coordinate descent from
    ``code`` (warm start) over all rows at once, until no coordinate moves
    by more than ``tol`` of the largest |c|.  Every ``check_every`` sweeps
    the supports and signs reached are tried for the exact solution
    (:func:`_lasso_exact`), which ends the descent where near-parallel
    atoms would slow it.  An atom with Gⱼⱼ = 0 gets code 0."""
    code = np.array(code, dtype=np.float64, copy=True)
    diag = np.diag(gram)
    live = diag > 0
    code[:, ~live] = 0.0
    for sweep in range(max_sweeps):
        moved = 0.0
        for j in np.flatnonzero(live):
            r = cov[j] - code @ gram[:, j] + code[:, j] * diag[j]
            new = np.sign(r) * np.maximum(np.abs(r) - alpha, 0.0) / diag[j]
            moved = max(moved, float(np.max(np.abs(new - code[:, j]),
                                            initial=0.0)))
            code[:, j] = new
        if moved <= tol * max(float(np.max(np.abs(code), initial=0.0)),
                              1e-300):
            break
        if sweep % check_every == check_every - 1:
            exact = _lasso_exact(gram, cov, alpha, code)
            if exact is not None:
                return exact
    return code


def _update_dict(dictionary, Y, code, random_state) -> None:
    """scikit-learn's ``_update_dict`` in place: one block-coordinate pass
    over the atoms with the statistics A = codeᵀcode, B = Yᵀcode taken
    before it; an atom whose A[k, k] ≤ 1e-6 is replaced by a row of Y plus
    noise (and its code column zeroed); each atom is projected onto the
    unit ball."""
    n_samples, n_components = code.shape
    A = code.T @ code
    B = Y.T @ code
    for k in range(n_components):
        if A[k, k] > 1e-6:
            dictionary[k] += (B[:, k] - A[k] @ dictionary) / A[k, k]
        else:
            newd = Y[random_state.choice(n_samples)]
            noise_level = 0.01 * (newd.std() or 1)
            noise = random_state.normal(0, noise_level, size=len(newd))
            dictionary[k] = newd + noise
            code[:, k] = 0
        dictionary[k] /= max(np.linalg.norm(dictionary[k]), 1)


def dict_learning(Y, n_components: int, alpha: float, max_iter: int,
                  tol: float, random_state):
    """scikit-learn's ``_dict_learning`` with the lasso as the coding step:
    (code [n, k], dictionary [k, m], costs, iterations) with Y ≈ code ·
    dictionary, from the SVD start."""
    code, S, dictionary = np.linalg.svd(Y, full_matrices=False)
    code, dictionary = svd_flip(code, dictionary)
    dictionary = S[:, np.newaxis] * dictionary
    r = len(dictionary)
    if n_components <= r:
        code = code[:, :n_components]
        dictionary = dictionary[:n_components, :]
    else:
        code = np.c_[code, np.zeros((len(code), n_components - r))]
        dictionary = np.r_[dictionary,
                           np.zeros((n_components - r, dictionary.shape[1]))]
    errors = []
    ii = -1
    for ii in range(max_iter):
        code = _lasso_cd(dictionary @ dictionary.T, dictionary @ Y.T, alpha,
                         code)
        _update_dict(dictionary, Y, code, random_state)
        errors.append(0.5 * np.sum((Y - code @ dictionary) ** 2)
                      + alpha * np.sum(np.abs(code)))
        if ii > 0 and errors[-2] - errors[-1] < tol * errors[-1]:
            break
    return code, dictionary, errors, ii + 1


class SparsePCA(BaseEstimator, TransformerMixin):
    """Sparse principal components: scikit-learn's ``SparsePCA`` (see the
    module docstring), with its parameters and defaults.

    Attributes: ``components_`` (n_components, n_features), rows of unit
    norm or zero; ``mean_``; ``n_components_``; ``n_iter_``; ``error_``,
    the cost at each iteration.  ``transform`` is the ridge projection of
    the centred data onto the components with ``ridge_alpha``.
    """

    def __init__(self, n_components=None, *, alpha=1, ridge_alpha=0.01,
                 max_iter=1000, tol=1e-8, random_state=None):
        self.n_components = n_components
        self.alpha = alpha
        self.ridge_alpha = ridge_alpha
        self.max_iter = max_iter
        self.tol = tol
        self.random_state = random_state

    def fit(self, X, y=None):
        random_state = check_random_state(self.random_state)
        X = check_array(X).astype(np.float64, copy=False)
        self.mean_ = X.mean(axis=0)
        n_components = (X.shape[1] if self.n_components is None
                        else int(self.n_components))
        code, dictionary, self.error_, self.n_iter_ = dict_learning(
            (X - self.mean_).T, n_components, alpha=float(self.alpha),
            max_iter=int(self.max_iter), tol=float(self.tol),
            random_state=random_state)
        code, _ = svd_flip(code, dictionary, u_based_decision=True)
        components = code.T
        norms = np.linalg.norm(components, axis=1)[:, np.newaxis]
        norms[norms == 0] = 1
        self.components_ = components / norms
        self.n_components_ = len(self.components_)
        return self

    def transform(self, X):
        check_is_fitted(self, "components_")
        X = check_array(X) - self.mean_
        C = self.components_
        A = C @ C.T + self.ridge_alpha * np.eye(C.shape[0])
        return np.linalg.solve(A, C @ X.T).T
