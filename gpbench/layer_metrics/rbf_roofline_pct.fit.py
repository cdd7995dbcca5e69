"""Share of the roofline bound that the hand-written RBF kernels K and A
reached over the traced window: Σ bound / Σ measured over their launches.
K is ``kmat_kernel``; A is ``contract_kernel`` with its weight (its last
template argument true) and ``adjoint_reduce_kernel``.  Each launch is
over the fit's N × N pairs at the width of the fit running when it was
launched (``counts/rbf_kernels.py``: each input read once, each output
written once).  None where neither launched (layer: the kernels)."""

import re

from counts.rbf_kernels import bound_s

_A = re.compile(r"contract_kernel<[^>]*\btrue>")


def read(rec):
    n = int(rec.config["n_rows"])
    bound = measured = 0.0
    for name, s, e, launch in rec.clipped():
        if "kmat_kernel" in name:
            kind = "K"
        elif "adjoint_reduce_kernel" in name or _A.search(name):
            kind = "A"
        else:
            continue
        measured += (e - s) / 1e9
        if "adjoint_reduce_kernel" not in name:
            q = rec.q_at(launch)
            bound += bound_s(kind, n, n, q)
    return 100.0 * bound / measured if measured > 0 else None
