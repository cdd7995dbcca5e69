"""Floating-point operations one SVGP step needs, whatever computes it, at
B minibatch rows, M inducing inputs and Q input columns: the minibatch
ELBO, its gradient in the kernel's parameters, the noise and Z, one Adam
update (O(M·Q), left out) and one natural-gradient step of q(u).

    13·M²·B + 13·M³ + (10Q + 16)·M·B + (10Q + 8)·M²

- Products and solves against the batch (M²·B each unit):
  the ELBO's A = L⁻¹Kub (M²B) and (L⁻¹SL⁻ᵀ)·A (2M²B); their backward,
  L⁻ᵀ·dA (M²B), the factor's cotangent −(L⁻ᵀdA)·Aᵀ (2M²B), and both
  cotangents of the product (4M²B); the natural gradient's Kuu⁻¹Kub by two
  solves (2M²B) and A·Aᵀ (M²B, symmetric): 13·M²·B.
- Cubic in M: three Cholesky factors, of Kuu before and after the Adam
  step and of −2θ₂ (M³/3 each); q(u)'s S = L⁻ᵀL⁻¹ from the factor of −2θ₂
  (2M³/3); Kuu⁻¹ for θ̂₂ (2M³/3); the ELBO's L⁻¹SL⁻ᵀ by two solves (2M³)
  and their cotangents in L (6M³); the Cholesky's backward (8M³/3):
  13·M³.
- Linear in M·B: Kub twice, a distance of Q subtractions and Q FMAs and
  the exp around it, (3Q + 2)·M·B each; its backward in Z, ℓ and σ²
  ((4Q + 4)·M·B); μ, the variances and t₁ = A·y (8·M·B).
- Quadratic in M: Kuu twice ((3Q + 2)·M² each) and its backward
  ((4Q + 4)·M²).

log|S| comes from the factor of −2θ₂; the scalar ends are O(M) and left
out.
"""


def flops(config: dict, q: int | None = None) -> float:
    b = float(config["batch_size"])
    m = float(config["num_inducing"])
    q = int(config["n_features"] if q is None else q)
    return (13 * m * m * b + 13 * m ** 3 + (10 * q + 16) * m * b
            + (10 * q + 8) * m * m)
