"""Parameter priors (regularizers) on constrained parameters.

JAX counterpart of the reference's `CDist.{h,cpp}` (CDist.h:134-367).
A prior is a lightweight static description `(kind, hyperparams)` attached to a
parameter index; its log-probability is *added* to the model log-likelihood
(CRegularisable::priorLogProb) so that `jax.grad` of the objective reproduces the
reference's addPriorGrad path (CDist.h:241-367) automatically.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import jax.numpy as jnp

from gpc_tpu import ndlutil


@dataclasses.dataclass(frozen=True)
class Prior:
    """Static prior description; hashable so it can live in jit-static metadata.

    kind: 'gaussian' (hyp = (precision,); CDist.cpp:150-158),
          'gamma'    (hyp = (a, b);      CDist.cpp:217-226),
          'wang'     (hyp = (M,);        CDist.cpp:276-284).
    index: the (constrained) parameter index the prior attaches to.
    """

    kind: str
    hyp: Tuple[float, ...]
    index: int

    def log_prob(self, x):
        x = jnp.asarray(x)
        if self.kind == "gaussian":
            (precision,) = self.hyp
            return -0.5 * precision * x * x - 0.5 * (ndlutil.LOGTWOPI - math.log(precision))
        if self.kind == "gamma":
            a, b = self.hyp
            return a * math.log(b) - math.lgamma(a) + ndlutil.xlogy(a - 1.0, x) - b * x
        if self.kind == "wang":
            (M,) = self.hyp
            return -M * jnp.log(x)
        raise ValueError(f"unknown prior kind {self.kind}")

    def grad_input(self, x):
        """d logProb / dx (parity helper; training uses jax.grad)."""
        x = jnp.asarray(x)
        if self.kind == "gaussian":
            (precision,) = self.hyp
            return -precision * x
        if self.kind == "gamma":
            a, b = self.hyp
            return (a - 1.0) / x - b
        if self.kind == "wang":
            (M,) = self.hyp
            return -M / x
        raise ValueError(f"unknown prior kind {self.kind}")


def gaussian(precision: float = 1.0, index: int = 0) -> Prior:
    return Prior("gaussian", (float(precision),), index)


def gamma(a: float = 1e-6, b: float = 1e-6, index: int = 0) -> Prior:
    return Prior("gamma", (float(a), float(b)), index)


def wang(M: float = 1.0, index: int = 0) -> Prior:
    return Prior("wang", (float(M),), index)


def total_log_prob(priors, params):
    """Σ_i prior_i.logProb(params[prior_i.index]) — zero when no priors."""
    if not priors:
        return jnp.asarray(0.0, dtype=jnp.result_type(params, jnp.float32))
    return sum(p.log_prob(params[p.index]) for p in priors)
