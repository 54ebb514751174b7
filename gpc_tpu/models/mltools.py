"""Auxiliary mapping models: linear and one-hidden-layer MLP regression.

JAX counterpart of the reference's `CMltools.{h,cpp}` (CMltools.h:34-209):
CLinearMapping (y = Wᵀx + b) and CMlpMapping (y = W2ᵀtanh(W1ᵀx + b1) + b2),
both with a fixed Gaussian output variance (=1) and the reference's likelihood
L = −½[Σᵢ‖f(xᵢ)−yᵢ‖²/σ² + N·(log2π + log σ²)] (CMltools.cpp:229-246 — note the
reference multiplies log2π by N, not N·D; replicated for parity).  Trained by
SCG with jax.grad; parameter vector layouts mirror getOptParams
(CMltools.cpp:88-147: [W1 col-major][b1][W2 col-major][b2]; linear: [W][b]).

These are the `CMapModel` back-constraint mapping candidates (CGp.h:352) and
are tested against MATLAB golden files in the reference (testMltools.cpp).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from gpc_tpu import ndlutil
from gpc_tpu.optim.scg import scg


class _Base:
    def out(self, Xin):
        raise NotImplementedError

    def log_likelihood(self) -> float:
        return -float(self._objective(self.theta))

    def optimise(self, iters: int = 1000):
        vag = jax.jit(jax.value_and_grad(self._objective))
        res = scg(vag, self.theta, max_iters=iters)
        self.theta = res.x
        return res

    def point_log_likelihood(self, y_out, Xin):
        """Per-point Gaussian log density (CMltools.cpp:275-281)."""
        pred = self.out(Xin)
        d2 = jnp.sum((pred - jnp.asarray(y_out)) ** 2, axis=1)
        return -0.5 * (d2 / self.variance + ndlutil.LOGTWOPI + np.log(self.variance))


class LinearMapping(_Base):
    """y = Wᵀx + b least-squares-style map (CLinearMapping)."""

    def __init__(self, X, y, seed: Optional[int] = None):
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        self.X, self.y = X, y
        self.input_dim, self.output_dim = X.shape[1], y.shape[1]
        self.variance = 1.0
        rng = np.random.RandomState(seed if seed is not None else 0)
        scale = np.sqrt(1.0 / (self.input_dim + 1))
        W = rng.randn(self.input_dim, self.output_dim) * scale
        b = rng.randn(1, self.output_dim) * scale
        self.theta = jnp.asarray(self.pack(W, b))
        Xj, yj = jnp.asarray(X), jnp.asarray(y)
        N = X.shape[0]

        def nlml(theta):
            W_, b_ = self.unpack(theta)
            resid = Xj @ W_ + b_ - yj
            L = jnp.sum(resid * resid) / self.variance
            L = L + N * (ndlutil.LOGTWOPI + np.log(self.variance))
            return 0.5 * L

        self._objective = nlml

    # [W col-major][b] (CLinearMapping::getOptParams)
    def pack(self, W, b):
        return np.concatenate([np.asarray(W).T.ravel(), np.asarray(b).ravel()])

    def unpack(self, theta):
        nw = self.input_dim * self.output_dim
        W = theta[:nw].reshape(self.output_dim, self.input_dim).T
        b = theta[nw:nw + self.output_dim][None, :]
        return W, b

    def out(self, Xin):
        W, b = self.unpack(self.theta)
        return jnp.asarray(Xin) @ W + b


class MlpMapping(_Base):
    """y = W2ᵀ·tanh(W1ᵀx + b1) + b2 (CMlpMapping)."""

    def __init__(self, X, y, hidden_dim: int, seed: Optional[int] = None):
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        self.X, self.y = X, y
        self.input_dim, self.output_dim = X.shape[1], y.shape[1]
        self.hidden_dim = hidden_dim
        self.variance = 1.0
        rng = np.random.RandomState(seed if seed is not None else 0)
        s1 = np.sqrt(1.0 / (self.input_dim + 1))
        s2 = np.sqrt(1.0 / (hidden_dim + 1))
        W1 = rng.randn(self.input_dim, hidden_dim) * s1
        b1 = rng.randn(1, hidden_dim) * s1
        W2 = rng.randn(hidden_dim, self.output_dim) * s2
        b2 = rng.randn(1, self.output_dim) * s2
        self.theta = jnp.asarray(self.pack(W1, b1, W2, b2))
        Xj, yj = jnp.asarray(X), jnp.asarray(y)
        N = X.shape[0]

        def nlml(theta):
            W1_, b1_, W2_, b2_ = self.unpack(theta)
            h = jnp.tanh(Xj @ W1_ + b1_)
            resid = h @ W2_ + b2_ - yj
            L = jnp.sum(resid * resid) / self.variance
            L = L + N * (ndlutil.LOGTWOPI + np.log(self.variance))
            return 0.5 * L

        self._objective = nlml

    # [W1 col-major][b1][W2 col-major][b2] (CMlpMapping::getOptParams)
    def pack(self, W1, b1, W2, b2):
        return np.concatenate([
            np.asarray(W1).T.ravel(), np.asarray(b1).ravel(),
            np.asarray(W2).T.ravel(), np.asarray(b2).ravel()])

    def unpack(self, theta):
        q, h, D = self.input_dim, self.hidden_dim, self.output_dim
        i = 0
        W1 = theta[i:i + q * h].reshape(h, q).T; i += q * h
        b1 = theta[i:i + h][None, :]; i += h
        W2 = theta[i:i + h * D].reshape(D, h).T; i += h * D
        b2 = theta[i:i + D][None, :]
        return W1, b1, W2, b2

    def out(self, Xin):
        W1, b1, W2, b2 = self.unpack(self.theta)
        return jnp.tanh(jnp.asarray(Xin) @ W1 + b1) @ W2 + b2
