"""Compositional covariance-function DSL, vectorized as batched matmuls.

JAX counterpart of the reference's `CKern.{h,cpp}` (CKern.h:36-1229).  The
reference evaluates kernels through per-element virtual calls in O(N²) loops
(CKern.h:120-144, the hot-loop anti-pattern flagged in CGp.cpp:693-735); here each
kernel is *static metadata* plus a pure tile function over whole cross-covariance
blocks: distance-family kernels ride one `dist2` matmul, inner-product-family
kernels one Gram matmul, and elementwise maps fuse into them under XLA.

Contract mirrored from the reference:
  * `compute(p, X1, X2)` — cross-covariance WITHOUT white noise (CWhiteKern
    contributes zero off its own symmetric diagonal, CKern.cpp:702-728);
  * `diag(p, X)` — diagonal elements (diagComputeElement);
  * symmetric Gram = compute(p, X, X) with the diagonal overwritten by diag(p, X),
    exactly like CKern::compute's symmetric fill (CKern.h:128-144);
  * `white(p)` — the white variance visible on the kernel's own diagonal
    (CKern::getWhite, CKern.h:86-89; the IVM adds it to active columns).

Parameter vector layout, default values, and transform assignment reproduce the
reference's ordering (CKern.cpp _init/setInitParam bodies) so optimizer
trajectories and model files are interoperable.  Hyperparameter gradients are NOT
hand-derived (the reference's ~3k lines of covGrad algebra): models take
`jax.grad` through these functions.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import jax.numpy as jnp

from gpc_tpu import transforms as tr
from gpc_tpu.linalg import dist2
from gpc_tpu.priors import Prior


def _asr(x):
    return jnp.asarray(x)


@dataclasses.dataclass(frozen=True)
class Kern:
    """Base class: static (hashable) kernel metadata."""

    input_dim: int
    priors: Tuple[Prior, ...] = ()

    # --- static descriptors -------------------------------------------------
    @property
    def kind(self) -> str:
        raise NotImplementedError

    @property
    def n_params(self) -> int:
        raise NotImplementedError

    def param_names(self):
        raise NotImplementedError

    def default_params(self) -> np.ndarray:
        raise NotImplementedError

    def transform_codes(self) -> np.ndarray:
        """Per-parameter transform codes (reference _init addTransform calls)."""
        raise NotImplementedError

    @property
    def stationary(self) -> bool:
        return True

    # --- compute ------------------------------------------------------------
    def compute(self, p, X1, X2):
        """Cross covariance (white-free)."""
        raise NotImplementedError

    def diag(self, p, X):
        raise NotImplementedError

    def white(self, p):
        """White variance on own symmetric diagonal (CKern::getWhite)."""
        return jnp.zeros((), dtype=jnp.result_type(p, jnp.float32))

    def gram(self, p, X):
        """Symmetric Gram: compute + diagonal overwrite (CKern.h:128-144)."""
        K = self.compute(p, X, X)
        return _set_diag(K, self.diag(p, X))

    # --- variance scaling (GPDM SNR logic, CKern.h:489-498) -----------------
    def get_variance(self, p):
        raise NotImplementedError(f"getVariance not defined for {self.kind}")

    def set_variance(self, p, val):
        raise NotImplementedError(f"setVariance not defined for {self.kind}")

    def with_priors(self, priors):
        return dataclasses.replace(self, priors=tuple(priors))

    @property
    def priors_global(self):
        """Priors with indices into this kernel's own parameter vector."""
        return self.priors

    def display_names(self):
        """Kind-prefixed parameter names as the reference CLI prints them
        (e.g. rbfinverseWidth, whitevariance — reference README.md:86-107)."""
        return [self.kind + n for n in self.param_names()]


def _set_diag(K, d):
    n = K.shape[0]
    idx = jnp.arange(n)
    return K.at[idx, idx].set(d)


# ---------------------------------------------------------------------------
# Leaf kernels
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class White(Kern):
    """k = δ_ij·σ²; zero everywhere in cross-compute (CKern.cpp:695-728)."""

    @property
    def kind(self):
        return "white"

    @property
    def n_params(self):
        return 1

    def param_names(self):
        return ["variance"]

    def default_params(self):
        return np.array([np.exp(-2.0)])

    def transform_codes(self):
        return np.array([tr.EXP])

    def compute(self, p, X1, X2):
        dt = jnp.result_type(p, X1)
        return jnp.zeros((X1.shape[0], X2.shape[0]), dtype=dt)

    def diag(self, p, X):
        return jnp.full((X.shape[0],), 1.0, jnp.result_type(p, X)) * p[0]

    def white(self, p):
        return p[0]

    def get_variance(self, p):
        return p[0]

    def set_variance(self, p, val):
        return p.at[0].set(val)


@dataclasses.dataclass(frozen=True)
class WhiteFixed(Kern):
    """As white but with a fixed, non-optimized variance (CKern.cpp:798-862)."""

    fixed_variance: float = float(np.exp(-2.0))

    @property
    def kind(self):
        return "whitefixed"

    @property
    def n_params(self):
        return 0

    def param_names(self):
        return []

    def default_params(self):
        return np.zeros((0,))

    def transform_codes(self):
        return np.zeros((0,), dtype=np.int32)

    def compute(self, p, X1, X2):
        dt = jnp.result_type(X1, jnp.float32)
        return jnp.zeros((X1.shape[0], X2.shape[0]), dtype=dt)

    def diag(self, p, X):
        return jnp.full((X.shape[0],), self.fixed_variance, jnp.result_type(X, jnp.float32))

    def white(self, p):
        return jnp.asarray(self.fixed_variance)

    def get_variance(self, p):
        return jnp.asarray(self.fixed_variance)

    def set_variance(self, p, val):
        # the reference mutates the member in place (CKern.h:614-618); here
        # the variance is structural (not in p), so rebuilding is the only
        # functional equivalent — Cmpnd.set_variance routes around this
        raise ValueError(
            "whitefixed variance is structural, not a parameter: rebuild "
            "with dataclasses.replace(kern, fixed_variance=...)")


@dataclasses.dataclass(frozen=True)
class Bias(Kern):
    """k = σ² everywhere (CKern.cpp:918-1000)."""

    @property
    def kind(self):
        return "bias"

    @property
    def n_params(self):
        return 1

    def param_names(self):
        return ["variance"]

    def default_params(self):
        return np.array([np.exp(-2.0)])

    def transform_codes(self):
        return np.array([tr.EXP])

    def compute(self, p, X1, X2):
        dt = jnp.result_type(p, X1)
        return jnp.full((X1.shape[0], X2.shape[0]), 1.0, dt) * p[0]

    def diag(self, p, X):
        return jnp.full((X.shape[0],), 1.0, jnp.result_type(p, X)) * p[0]

    def get_variance(self, p):
        return p[0]

    def set_variance(self, p, val):
        return p.at[0].set(val)


@dataclasses.dataclass(frozen=True)
class Rbf(Kern):
    """k = σ²·exp(−γ/2·‖x−x'‖²); params [inverseWidth γ, variance σ²]
    (CKern.cpp:1147-1154, defaults CKern.cpp:1068-1072)."""

    @property
    def kind(self):
        return "rbf"

    @property
    def n_params(self):
        return 2

    def param_names(self):
        return ["inverseWidth", "variance"]

    def default_params(self):
        return np.array([1.0, 1.0])

    def transform_codes(self):
        return np.array([tr.EXP, tr.EXP])

    def compute(self, p, X1, X2):
        return p[1] * jnp.exp(-0.5 * p[0] * dist2(X1, X2))

    def diag(self, p, X):
        return jnp.full((X.shape[0],), 1.0, jnp.result_type(p, X)) * p[1]

    def get_variance(self, p):
        return p[1]

    def set_variance(self, p, val):
        return p.at[1].set(val)


@dataclasses.dataclass(frozen=True)
class Exp(Kern):
    """Ornstein-Uhlenbeck-style k = σ²·exp(−γ·‖x−x'‖); params [inverseWidth,
    variance] (CKern.cpp:1389-1396; 'no guarantees', CKern.h:742)."""

    @property
    def kind(self):
        return "exp"

    @property
    def n_params(self):
        return 2

    def param_names(self):
        return ["inverseWidth", "variance"]

    def default_params(self):
        return np.array([1.0, 1.0])

    def transform_codes(self):
        return np.array([tr.EXP, tr.EXP])

    def compute(self, p, X1, X2):
        # dtype-aware sqrt guard: 1e-300 underflows to 0 in f32, and
        # sqrt(0)'s infinite derivative turns coincident-point cotangents
        # into NaN on the f32 training path (safe-INPUT discipline)
        d2 = dist2(X1, X2)
        r = jnp.sqrt(d2 + jnp.finfo(jnp.result_type(d2)).tiny)
        return p[1] * jnp.exp(-p[0] * r)

    def diag(self, p, X):
        return jnp.full((X.shape[0],), 1.0, jnp.result_type(p, X)) * p[1]

    def get_variance(self, p):
        return p[1]

    def set_variance(self, p, val):
        return p.at[1].set(val)


@dataclasses.dataclass(frozen=True)
class RatQuad(Kern):
    """k = σ²·(1 + r²/(2αℓ²))^(−α); params [alpha, lengthScale, variance]
    (CKern.cpp:1586-1593, defaults :1578-1584)."""

    @property
    def kind(self):
        return "ratquad"

    @property
    def n_params(self):
        return 3

    def param_names(self):
        return ["alpha", "lengthScale", "variance"]

    def default_params(self):
        return np.array([1.0, 1.0, 1.0])

    def transform_codes(self):
        return np.array([tr.EXP, tr.EXP, tr.EXP])

    def compute(self, p, X1, X2):
        alpha, ell, var = p[0], p[1], p[2]
        z = dist2(X1, X2) * (0.5 / (ell * ell * alpha))
        return var * jnp.power(1.0 + z, -alpha)

    def diag(self, p, X):
        return jnp.full((X.shape[0],), 1.0, jnp.result_type(p, X)) * p[2]

    def get_variance(self, p):
        return p[2]

    def set_variance(self, p, val):
        return p.at[2].set(val)


@dataclasses.dataclass(frozen=True)
class Matern32(Kern):
    """k = σ²·(1+√3r/ℓ)·exp(−√3r/ℓ); params [lengthScale, variance]
    (CKern.cpp:1834-1842)."""

    @property
    def kind(self):
        return "matern32"

    @property
    def n_params(self):
        return 2

    def param_names(self):
        return ["lengthScale", "variance"]

    def default_params(self):
        return np.array([1.0, 1.0])

    def transform_codes(self):
        return np.array([tr.EXP, tr.EXP])

    def compute(self, p, X1, X2):
        wi2 = 3.0 / (p[0] * p[0])
        d2 = dist2(X1, X2) * wi2
        u = jnp.sqrt(d2 + jnp.finfo(jnp.result_type(d2)).tiny)
        return p[1] * (1.0 + u) * jnp.exp(-u)

    def diag(self, p, X):
        return jnp.full((X.shape[0],), 1.0, jnp.result_type(p, X)) * p[1]

    def get_variance(self, p):
        return p[1]

    def set_variance(self, p, val):
        return p.at[1].set(val)


@dataclasses.dataclass(frozen=True)
class Matern52(Kern):
    """k = σ²·(1+u+u²/3)·exp(−u), u = √5·r/ℓ; params [lengthScale, variance]
    (CKern.cpp:2087-2096)."""

    @property
    def kind(self):
        return "matern52"

    @property
    def n_params(self):
        return 2

    def param_names(self):
        return ["lengthScale", "variance"]

    def default_params(self):
        return np.array([1.0, 1.0])

    def transform_codes(self):
        return np.array([tr.EXP, tr.EXP])

    def compute(self, p, X1, X2):
        wi2 = 5.0 / (p[0] * p[0])
        n2 = dist2(X1, X2) * wi2
        u = jnp.sqrt(n2 + jnp.finfo(jnp.result_type(n2)).tiny)
        return p[1] * (1.0 + u + n2 / 3.0) * jnp.exp(-u)

    def diag(self, p, X):
        return jnp.full((X.shape[0],), 1.0, jnp.result_type(p, X)) * p[1]

    def get_variance(self, p):
        return p[1]

    def set_variance(self, p, val):
        return p.at[1].set(val)


@dataclasses.dataclass(frozen=True)
class Lin(Kern):
    """k = σ²·xᵀx' (CKern.cpp:2328-2340); non-stationary."""

    @property
    def kind(self):
        return "lin"

    @property
    def n_params(self):
        return 1

    def param_names(self):
        return ["variance"]

    def default_params(self):
        return np.array([1.0])

    def transform_codes(self):
        return np.array([tr.EXP])

    @property
    def stationary(self):
        return False

    def compute(self, p, X1, X2):
        return p[0] * (X1 @ X2.T)

    def diag(self, p, X):
        return p[0] * jnp.sum(X * X, axis=-1)

    def get_variance(self, p):
        return p[0]

    def set_variance(self, p, val):
        return p.at[0].set(val)


@dataclasses.dataclass(frozen=True)
class Mlp(Kern):
    """Williams' arcsin kernel: σ²·asin((w·xᵀx'+b)/√((w·‖x‖²+b+1)(w·‖x'‖²+b+1)));
    params [weightVariance, biasVariance, variance] (CKern.cpp:2528-2535,
    defaults :2520-2526)."""

    @property
    def kind(self):
        return "mlp"

    @property
    def n_params(self):
        return 3

    def param_names(self):
        return ["weightVariance", "biasVariance", "variance"]

    def default_params(self):
        return np.array([10.0, 10.0, 1.0])

    def transform_codes(self):
        return np.array([tr.EXP, tr.EXP, tr.EXP])

    @property
    def stationary(self):
        return False

    def compute(self, p, X1, X2):
        w, b, var = p[0], p[1], p[2]
        numer = w * (X1 @ X2.T) + b
        d1 = w * jnp.sum(X1 * X1, axis=-1) + b + 1.0
        d2 = w * jnp.sum(X2 * X2, axis=-1) + b + 1.0
        arg = numer / jnp.sqrt(d1[:, None] * d2[None, :])
        # clamp strictly inside [-1, 1]: arg is mathematically < 1 but can
        # ROUND to 1.0 once w·‖x‖² exceeds the mantissa (then d = numer+1
        # == numer), and arcsin'(±1) = ∞ turns the pullback into inf/NaN;
        # 1−epsneg is the largest representable value below 1
        lim = 1.0 - jnp.finfo(jnp.result_type(arg)).epsneg
        return var * jnp.arcsin(jnp.clip(arg, -lim, lim))

    def diag(self, p, X):
        w, b, var = p[0], p[1], p[2]
        numer = w * jnp.sum(X * X, axis=-1) + b
        # same strictly-inside-[−1,1] clamp as compute(): numer/(numer+1)
        # rounds to exactly 1.0 once numer exceeds the mantissa, and
        # arcsin'(1) = ∞ NaNs the gradient of every Gram whose diagonal
        # this overwrites (Kern.gram diag discipline)
        arg = numer / (numer + 1.0)
        lim = 1.0 - jnp.finfo(jnp.result_type(arg)).epsneg
        return var * jnp.arcsin(jnp.clip(arg, -lim, lim))

    def get_variance(self, p):
        return p[2]

    def set_variance(self, p, val):
        return p.at[2].set(val)


@dataclasses.dataclass(frozen=True)
class Poly(Kern):
    """k = σ²·(w·xᵀx'+b)^d; degree d is static (serialized separately, not a
    trainable param); params [weightVariance, biasVariance, variance]
    (CKern.cpp:2815-2820, defaults :2805-2813)."""

    degree: float = 2.0

    @property
    def kind(self):
        return "poly"

    @property
    def n_params(self):
        return 3

    def param_names(self):
        return ["weightVariance", "biasVariance", "variance"]

    def default_params(self):
        return np.array([1.0, 1.0, 1.0])

    def transform_codes(self):
        return np.array([tr.EXP, tr.EXP, tr.EXP])

    @property
    def stationary(self):
        return False

    def compute(self, p, X1, X2):
        arg = p[0] * (X1 @ X2.T) + p[1]
        return p[2] * jnp.power(arg, self.degree)

    def diag(self, p, X):
        arg = p[0] * jnp.sum(X * X, axis=-1) + p[1]
        return p[2] * jnp.power(arg, self.degree)

    def get_variance(self, p):
        return p[2]

    def set_variance(self, p, val):
        return p.at[2].set(val)


# --- ARD variants ----------------------------------------------------------
# ARD scales live in [0,1] via sigmoid transform, init 0.5 (CKern.cpp setInitParam
# bodies for linard/rbfard/mlpard/polyard; base CArdKern, CKern.h:358-372).

class _ArdMixin:
    def _scales(self, p):
        return p[self.n_params - self.input_dim:]


@dataclasses.dataclass(frozen=True)
class Linard(_ArdMixin, Kern):
    """ARD linear: σ²·Σᵢ sᵢ xᵢx'ᵢ; params [variance, inputScale×D]
    (CKern.cpp:3061-3070)."""

    @property
    def kind(self):
        return "linard"

    @property
    def n_params(self):
        return 1 + self.input_dim

    def param_names(self):
        return ["variance"] + ["inputScale"] * self.input_dim

    def default_params(self):
        return np.concatenate([[1.0], 0.5 * np.ones(self.input_dim)])

    def transform_codes(self):
        return np.concatenate([[tr.EXP], tr.SIGMOID * np.ones(self.input_dim, np.int32)]).astype(np.int32)

    @property
    def stationary(self):
        return False

    def compute(self, p, X1, X2):
        s = self._scales(p)
        return p[0] * ((X1 * s) @ X2.T)

    def diag(self, p, X):
        return p[0] * jnp.sum(X * X * self._scales(p), axis=-1)

    def get_variance(self, p):
        return p[0]

    def set_variance(self, p, val):
        return p.at[0].set(val)


@dataclasses.dataclass(frozen=True)
class Rbfard(_ArdMixin, Kern):
    """ARD RBF: σ²·exp(−γ/2·Σᵢ sᵢ(xᵢ−x'ᵢ)²); params [inverseWidth, variance,
    inputScale×D] (CKern.cpp:3305-3316)."""

    @property
    def kind(self):
        return "rbfard"

    @property
    def n_params(self):
        return 2 + self.input_dim

    def param_names(self):
        return ["inverseWidth", "variance"] + ["inputScale"] * self.input_dim

    def default_params(self):
        return np.concatenate([[1.0, 1.0], 0.5 * np.ones(self.input_dim)])

    def transform_codes(self):
        return np.concatenate([[tr.EXP, tr.EXP], tr.SIGMOID * np.ones(self.input_dim, np.int32)]).astype(np.int32)

    def compute(self, p, X1, X2):
        rs = jnp.sqrt(self._scales(p))
        d2 = dist2(X1 * rs, X2 * rs)
        return p[1] * jnp.exp(-0.5 * p[0] * d2)

    def diag(self, p, X):
        return jnp.full((X.shape[0],), 1.0, jnp.result_type(p, X)) * p[1]

    def get_variance(self, p):
        return p[1]

    def set_variance(self, p, val):
        return p.at[1].set(val)


@dataclasses.dataclass(frozen=True)
class Mlpard(_ArdMixin, Kern):
    """ARD arcsin kernel; params [weightVariance, biasVariance, variance,
    inputScale×D] (CKern.cpp:3616-3634)."""

    @property
    def kind(self):
        return "mlpard"

    @property
    def n_params(self):
        return 3 + self.input_dim

    def param_names(self):
        return ["weightVariance", "biasVariance", "variance"] + ["inputScale"] * self.input_dim

    def default_params(self):
        return np.concatenate([[10.0, 10.0, 1.0], 0.5 * np.ones(self.input_dim)])

    def transform_codes(self):
        return np.concatenate([[tr.EXP] * 3, tr.SIGMOID * np.ones(self.input_dim, np.int32)]).astype(np.int32)

    @property
    def stationary(self):
        return False

    def compute(self, p, X1, X2):
        w, b, var = p[0], p[1], p[2]
        s = self._scales(p)
        numer = w * ((X1 * s) @ X2.T) + b
        d1 = w * jnp.sum(X1 * X1 * s, axis=-1) + b + 1.0
        d2 = w * jnp.sum(X2 * X2 * s, axis=-1) + b + 1.0
        arg = numer / jnp.sqrt(d1[:, None] * d2[None, :])
        # clamp strictly inside [-1, 1]: arg is mathematically < 1 but can
        # ROUND to 1.0 once w·‖x‖² exceeds the mantissa (then d = numer+1
        # == numer), and arcsin'(±1) = ∞ turns the pullback into inf/NaN;
        # 1−epsneg is the largest representable value below 1
        lim = 1.0 - jnp.finfo(jnp.result_type(arg)).epsneg
        return var * jnp.arcsin(jnp.clip(arg, -lim, lim))

    def diag(self, p, X):
        w, b, var = p[0], p[1], p[2]
        numer = w * jnp.sum(X * X * self._scales(p), axis=-1) + b
        # same strictly-inside-[−1,1] clamp as compute() (see Mlp.diag)
        arg = numer / (numer + 1.0)
        lim = 1.0 - jnp.finfo(jnp.result_type(arg)).epsneg
        return var * jnp.arcsin(jnp.clip(arg, -lim, lim))

    def get_variance(self, p):
        return p[2]

    def set_variance(self, p, val):
        return p.at[2].set(val)


@dataclasses.dataclass(frozen=True)
class Polyard(_ArdMixin, Kern):
    """ARD polynomial; params [weightVariance, biasVariance, variance,
    inputScale×D]; degree static (CKern.cpp:4035-4045)."""

    degree: float = 2.0

    @property
    def kind(self):
        return "polyard"

    @property
    def n_params(self):
        return 3 + self.input_dim

    def param_names(self):
        return ["weightVariance", "biasVariance", "variance"] + ["inputScale"] * self.input_dim

    def default_params(self):
        return np.concatenate([[1.0, 1.0, 1.0], 0.5 * np.ones(self.input_dim)])

    def transform_codes(self):
        return np.concatenate([[tr.EXP] * 3, tr.SIGMOID * np.ones(self.input_dim, np.int32)]).astype(np.int32)

    @property
    def stationary(self):
        return False

    def compute(self, p, X1, X2):
        s = self._scales(p)
        arg = p[0] * ((X1 * s) @ X2.T) + p[1]
        return p[2] * jnp.power(arg, self.degree)

    def diag(self, p, X):
        arg = p[0] * jnp.sum(X * X * self._scales(p), axis=-1) + p[1]
        return p[2] * jnp.power(arg, self.degree)

    def get_variance(self, p):
        return p[2]

    def set_variance(self, p, val):
        return p.at[2].set(val)


# ---------------------------------------------------------------------------
# Combinators
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Component(Kern):
    """Heterogeneous children with offset parameter indexing
    (CComponentKern, CKern.h:375-473)."""

    components: Tuple[Kern, ...] = ()

    @property
    def n_params(self):
        return sum(c.n_params for c in self.components)

    def param_names(self):
        out = []
        for c in self.components:
            out.extend(c.param_names())
        return out

    def default_params(self):
        if not self.components:
            return np.zeros((0,))
        return np.concatenate([c.default_params() for c in self.components])

    def transform_codes(self):
        if not self.components:
            return np.zeros((0,), dtype=np.int32)
        return np.concatenate([c.transform_codes() for c in self.components]).astype(np.int32)

    @property
    def stationary(self):
        return all(c.stationary for c in self.components)

    def offsets(self):
        off = [0]
        for c in self.components:
            off.append(off[-1] + c.n_params)
        return off

    def child_slices(self, p):
        off = self.offsets()
        return [p[off[i]:off[i + 1]] for i in range(len(self.components))]

    @property
    def priors_global(self):
        """Child priors re-indexed into the compound parameter vector."""
        out = list(self.priors)
        off = self.offsets()
        for i, c in enumerate(self.components):
            for pr in getattr(c, "priors_global", c.priors):
                out.append(dataclasses.replace(pr, index=pr.index + off[i]))
        return tuple(out)

    def display_names(self):
        out = []
        for c in self.components:
            out.extend(c.display_names())
        return out


@dataclasses.dataclass(frozen=True)
class Cmpnd(_Component):
    """Additive combinator: k = Σᵢ kᵢ (CKern.cpp:126-331)."""

    @property
    def kind(self):
        return "cmpnd"

    def compute(self, p, X1, X2):
        parts = self.child_slices(p)
        out = self.components[0].compute(parts[0], X1, X2)
        for c, pp in zip(self.components[1:], parts[1:]):
            out = out + c.compute(pp, X1, X2)
        return out

    def diag(self, p, X):
        parts = self.child_slices(p)
        out = self.components[0].diag(parts[0], X)
        for c, pp in zip(self.components[1:], parts[1:]):
            out = out + c.diag(pp, X)
        return out

    def white(self, p):
        parts = self.child_slices(p)
        w = jnp.zeros((), dtype=jnp.result_type(p, jnp.float32))
        for c, pp in zip(self.components, parts):
            w = w + c.white(pp)
        return w

    def get_variance(self, p):
        parts = self.child_slices(p)
        return sum(c.get_variance(pp) for c, pp in zip(self.components, parts))

    def set_variance(self, p, val):
        """Rescale children proportionally (CKern.h:489-498).

        whitefixed children hold their variance structurally (not in p) and
        cannot be rescaled functionally, so the remaining children absorb
        the change and the compound total still lands exactly on `val`
        (the reference instead mutates the whitefixed variance in place,
        CKern.h:614-618 — a documented deviation)."""
        cur = self.get_variance(p)
        fixed = sum(float(c.fixed_variance) for c in self.components
                    if c.kind == "whitefixed")
        ratio = (val - fixed) / (cur - fixed)
        out = p
        off = self.offsets()
        for i, c in enumerate(self.components):
            if c.kind == "whitefixed":
                continue
            pp = out[off[i]:off[i + 1]]
            pp = c.set_variance(pp, c.get_variance(pp) * ratio)
            out = out.at[off[i]:off[i + 1]].set(pp)
        return out


@dataclasses.dataclass(frozen=True)
class Tensor(_Component):
    """Product combinator: k = Πᵢ kᵢ; white children are rejected
    (CKern.cpp:389-397)."""

    def __post_init__(self):
        for c in self.components:
            if c.kind == "white":
                raise ValueError("Can't have white kernel components in tensor kernels.")

    @property
    def kind(self):
        return "tensor"

    def compute(self, p, X1, X2):
        parts = self.child_slices(p)
        out = self.components[0].compute(parts[0], X1, X2)
        for c, pp in zip(self.components[1:], parts[1:]):
            out = out * c.compute(pp, X1, X2)
        return out

    def diag(self, p, X):
        parts = self.child_slices(p)
        out = self.components[0].diag(parts[0], X)
        for c, pp in zip(self.components[1:], parts[1:]):
            out = out * c.diag(pp, X)
        return out

    def get_variance(self, p):
        parts = self.child_slices(p)
        out = self.components[0].get_variance(parts[0])
        for c, pp in zip(self.components[1:], parts[1:]):
            out = out * c.get_variance(pp)
        return out

    def set_variance(self, p, val):
        """Rescale EVERY child by val/total — the reference's own rule
        (CTensorKern::setVariance, CKern.h:534-542).  With k > 1 children
        the resulting product variance is total·(val/total)^k, not val —
        a replicated reference quirk."""
        cur = self.get_variance(p)
        factor = val / cur
        out = p
        off = self.offsets()
        for i, c in enumerate(self.components):
            pp = out[off[i]:off[i + 1]]
            pp = c.set_variance(pp, c.get_variance(pp) * factor)
            out = out.at[off[i]:off[i + 1]].set(pp)
        return out


# ---------------------------------------------------------------------------
# Factory (readKernFromStream counterpart, CKern.cpp:4192-4259)
# ---------------------------------------------------------------------------

_LEAF_TYPES = {
    "white": White,
    "whitefixed": WhiteFixed,
    "bias": Bias,
    "rbf": Rbf,
    "exp": Exp,
    "ratquad": RatQuad,
    "matern32": Matern32,
    "matern52": Matern52,
    "lin": Lin,
    "mlp": Mlp,
    "poly": Poly,
    "linard": Linard,
    "rbfard": Rbfard,
    "mlpard": Mlpard,
    "polyard": Polyard,
}


def make_kern(kind: str, input_dim: int, **kwargs) -> Kern:
    if kind == "cmpnd":
        return Cmpnd(input_dim=input_dim, components=tuple(kwargs["components"]))
    if kind == "tensor":
        return Tensor(input_dim=input_dim, components=tuple(kwargs["components"]))
    if kind not in _LEAF_TYPES:
        raise ValueError(f"Unknown kernel type {kind}")
    return _LEAF_TYPES[kind](input_dim=input_dim, **kwargs)


def gram(kern: Kern, p, X):
    return kern.gram(p, X)


def cross(kern: Kern, p, X1, X2):
    return kern.compute(p, X1, X2)


def diag(kern: Kern, p, X):
    return kern.diag(p, X)
