"""L-BFGS (ML-II) with a best-iterate guard and sequential restarts.

The port of :func:`edrgp_tpu.inference.lbfgs.minimize` on top of
``torch.optim.LBFGS`` with the strong-Wolfe line search.  The loop stops
when the l2 norm of the gradient at the current iterate falls below ``tol``
or after ``max_iters`` iterations, and returns the best finite iterate seen:
in float32 the line search can accept a step into a region where the
objective is non-finite, and the last iterate is then not the answer.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Sequence

import torch

__all__ = ["LBFGSResult", "minimize", "minimize_restarts"]

#: Value a non-finite objective is replaced by, so the line search backs off.
_HUGE = 1e30

#: Evaluations one line search may make.  ``LBFGS.step`` allows
#: ``max_eval − 1`` of them, and its default ``max_eval`` (5/4 of
#: ``max_iter`` = 1) would allow none.
_MAX_LINE_SEARCH = 25


class LBFGSResult(NamedTuple):
    params: list            # best iterate, detached copies
    value: float            # objective there
    grad_norm: float        # l2 gradient norm there
    num_iters: int          # iterations taken


def _guarded_closure(fun: Callable, params: Sequence[torch.Tensor], log):
    """Closure for ``LBFGS.step``: evaluates ``fun`` with gradients; a
    non-finite value or gradient becomes (1e30, 0).  Each evaluation is
    appended to ``log`` as (value, grad l2 norm, params copy).

    ``step`` evaluates its starting point, which is the point the previous
    step's line search accepted and usually evaluated last, bit for bit; that
    evaluation is answered from a one-entry cache instead of recomputed.
    """
    last: dict = {}

    def closure():
        at = [p.detach().clone() for p in params]
        if last and all(torch.equal(a, b) for a, b in zip(at, last["at"])):
            value, gnorm, grads = last["value"], last["gnorm"], last["grads"]
        else:
            for p in params:
                p.grad = None
            with torch.enable_grad():
                loss = fun()
                loss.backward()
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in params]
            value = float(loss.detach())
            gnorm = math.sqrt(sum(float((g * g).sum()) for g in grads))
            if not (math.isfinite(value) and math.isfinite(gnorm)):
                value, gnorm = _HUGE, 0.0
                grads = [torch.zeros_like(p) for p in params]
            last.update(at=at, value=value, gnorm=gnorm, grads=grads)
        for p, g in zip(params, grads):
            p.grad = g.clone()
        log.append((value, gnorm, at))
        return torch.as_tensor(value, dtype=params[0].dtype)

    return closure


def minimize(fun: Callable[[], torch.Tensor],
             params: Sequence[torch.Tensor], *, max_iters: int = 1000,
             tol: float = 1e-6, memory_size: int = 30) -> LBFGSResult:
    """Minimize ``fun() -> scalar`` over the leaf tensors ``params``.

    ``fun`` reads ``params``; on return they hold the best finite iterate.
    """
    params = list(params)
    opt = torch.optim.LBFGS(params, lr=1.0, max_iter=1,
                            max_eval=1 + _MAX_LINE_SEARCH,
                            history_size=memory_size,
                            line_search_fn="strong_wolfe",
                            tolerance_grad=0.0)
    log: list = []
    closure = _guarded_closure(fun, params, log)
    best = (math.inf, math.inf, [p.detach().clone() for p in params])
    it = 0
    while True:
        log.clear()
        if it < max_iters:
            opt.step(closure)       # first evaluation: the current iterate
        else:
            closure()
        value, gnorm, at = log[0]
        if value < best[0]:
            best = (value, gnorm, at)
        if it >= max_iters or gnorm < tol:
            break
        moved = any(not torch.equal(p, a) for p, a in zip(params, at))
        if not moved:               # the line search made no progress
            break
        it += 1
    with torch.no_grad():
        for p, b in zip(params, best[2]):
            p.copy_(b)
    return LBFGSResult(params=best[2], value=best[0], grad_norm=best[1],
                       num_iters=it)


def minimize_restarts(fun: Callable[[], torch.Tensor],
                      params: Sequence[torch.Tensor],
                      inits: Sequence[Sequence[torch.Tensor]], *,
                      max_iters: int = 1000, tol: float = 1e-6,
                      memory_size: int = 30) -> LBFGSResult:
    """Run :func:`minimize` from each of ``inits`` (one tensor per param)
    in turn; the lowest final value wins and is left in ``params``."""
    params = list(params)
    best = None
    for init in inits:
        with torch.no_grad():
            for p, v in zip(params, init):
                p.copy_(v)
        res = minimize(fun, params, max_iters=max_iters, tol=tol,
                       memory_size=memory_size)
        if best is None or res.value < best.value:
            best = res
    with torch.no_grad():
        for p, b in zip(params, best.params):
            p.copy_(b)
    return best
