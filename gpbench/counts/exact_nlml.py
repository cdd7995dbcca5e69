"""Floating-point operations one value+gradient of the exact GP's NLML needs,
whatever computes it, at N rows and Q input columns.

Cholesky of Ky: N³/3.  Ky⁻¹ from the factor (for the trace term of the
gradient): 2N³/3.  α by two triangular solves: 2N².  ααᵀ: N².  K: a
distance of Q subtractions and Q FMAs and the exp around it, (3Q + 2)N².
The kernel adjoint A (the weighting by W∘K, the skinny product with X/ℓ
and the row sums): (5Q + 4)N².  The scalar ends (log-determinant, yᵀα)
are O(N) and left out.
"""


def flops(config: dict, q: int) -> float:
    n = float(config["n_rows"])
    return (n ** 3 / 3.0 + 2.0 * n ** 3 / 3.0 + 2.0 * n * n + n * n
            + (3 * q + 2) * n * n + (5 * q + 4) * n * n)
