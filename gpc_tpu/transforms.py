"""Constrained ↔ unconstrained parameter reparameterizations.

JAX counterpart of the reference's `CTransform.{h,cpp}` (CTransform.h:20-150,
CTransform.cpp:25-120).  The optimizer always works on the unconstrained vector `a`;
models expose constrained parameters `x = atox(a)`.  Because gradients in this
framework come from `jax.grad` through `atox`, the reference's explicit `gradfact`
chain-rule factor (CTransform.h:296-311) is only needed for parity testing — it is
still provided.

Transforms are identified by small static integer codes so that a whole parameter
vector with per-index transforms can be mapped in one vectorized, jit-friendly
expression (`apply_atox(codes, a)`); the code array is a compile-time constant.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

# Transform codes (static).
LINEAR = 0   # identity by default (m=1, c=0): CTransform.h:88-133
EXP = 1      # default positive transform:     CTransform.cpp:25-53
NEGLOGLOGIT = 2  # softplus (legacy positive): CTransform.cpp:55-88
SIGMOID = 3  # default zero-one transform:     CTransform.cpp:90-112

LIMVAL = 36.0  # clip for exp/softplus (CTransform.h:17)
_EPS = float(np.finfo(np.float64).eps)

_NAMES = {LINEAR: "linear", EXP: "exp", NEGLOGLOGIT: "negLogLogit", SIGMOID: "sigmoid"}
_CODES = {v: k for k, v in _NAMES.items()}


def name_of(code: int) -> str:
    return _NAMES[code]


def code_of(name: str) -> int:
    if name not in _CODES:
        raise ValueError(f"Transform type {name} is currently unknown.")
    return _CODES[name]


def atox(code: int, a):
    """Unconstrained a → constrained x for a single transform code."""
    a = jnp.asarray(a)
    if code == LINEAR:
        return a
    if code == EXP:
        return jnp.exp(jnp.clip(a, -LIMVAL, LIMVAL))
    if code == NEGLOGLOGIT:
        # softplus, clipped below at exp(-36); linear above 36
        return jnp.maximum(jnp.where(a < LIMVAL, jnp.logaddexp(0.0, a), a), np.exp(-LIMVAL))
    if code == SIGMOID:
        s = 1.0 / (1.0 + jnp.exp(-jnp.clip(a, -LIMVAL, LIMVAL)))
        return jnp.clip(s, _EPS, 1.0 - _EPS)
    raise ValueError(f"unknown transform code {code}")


def xtoa(code: int, x):
    """Constrained x → unconstrained a (inverse of atox)."""
    x = jnp.asarray(x)
    if code == LINEAR:
        return x
    if code == EXP:
        return jnp.log(x)
    if code == NEGLOGLOGIT:
        # log(exp(x)−1); for x ≥ 36 identity (CTransform.cpp:70-78)
        xs = jnp.minimum(x, LIMVAL)
        return jnp.where(x < LIMVAL, jnp.log(jnp.expm1(xs)), x)
    if code == SIGMOID:
        return jnp.log(x) - jnp.log1p(-x)
    raise ValueError(f"unknown transform code {code}")


def gradfact(code: int, x):
    """dx/da evaluated at x (CTransform gradfact; CTransform.cpp:48-52, 80-88, 108-112)."""
    x = jnp.asarray(x)
    if code == LINEAR:
        return jnp.ones_like(x)
    if code == EXP:
        return x
    if code == NEGLOGLOGIT:
        return jnp.where(x < LIMVAL, -jnp.expm1(-x), jnp.ones_like(x))
    if code == SIGMOID:
        return x * (1.0 - x)
    raise ValueError(f"unknown transform code {code}")


def _vectorized(fn, codes: np.ndarray, v):
    """Apply per-index transforms over a flat vector. `codes` is static numpy."""
    codes = np.asarray(codes, dtype=np.int32)
    v = jnp.asarray(v)
    out = None
    for code in np.unique(codes):
        mask = codes == code
        # Evaluate the branch only on safe inputs, then select.
        branch = fn(int(code), v)
        out = branch * mask if out is None else jnp.where(mask, branch, out)
    return out


def apply_atox(codes: np.ndarray, a):
    """Vector a → vector x with per-index transform codes (static)."""
    return _vectorized(atox, codes, a)


def apply_xtoa(codes: np.ndarray, x):
    return _vectorized(xtoa, codes, x)


def apply_gradfact(codes: np.ndarray, x):
    return _vectorized(gradfact, codes, x)
