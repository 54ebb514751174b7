"""Batch prediction server: factor once, serve padded batches.

The reference recomputes its posterior state lazily behind dirty flags and
serves one request at a time through LAPACK (CGp::posteriorMeanVar +
updateAlpha, /root/reference/CGp.cpp:469-663).  For production serving the
decomposition is explicit:

  factor (once)  — K's Cholesky, α = K⁻¹m, and (with explicit_inverse) the
                   blocked explicit L⁻¹, so every per-batch variance solve is
                   a GEMM;
  serve (per batch) — one jitted program per padded batch shape: cross-Gram
                   tiles + GEMMs/solves.  Requests are padded to power-of-two
                   BUCKETS capped at `chunk` (then split into chunk-sized
                   pieces), so the compiled-program set is bounded at
                   log2(chunk) shapes and a stream of varied small online
                   requests never recompiles per distinct size.

Sparse approximations (DTC/DTCVAR/FITC/PITC) hold (L_uu, L_m, u) — their
per-batch work is M-sized triangular solves, already cheap.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from gpc_tpu import linalg
from gpc_tpu.models.gp import GP, posterior_apply, posterior_state


class GPServer:
    """One-time-factored predictor for a trained `models.gp.GP`.

    `chunk` fixes the compiled batch shape; `explicit_inverse` stores L⁻¹
    at factor time (FTC only).  Off by default: on an H100 at N=16k it
    doubles the factor time and serves large batches slower, winning only
    single-point requests (PERF.md, "Bring-up findings").
    `predict` matches `GP.predict` to numerical precision (pinned in
    tests/test_serving.py) for any request size, including ragged tails.
    """

    def __init__(self, model: GP, chunk: int = 8192,
                 explicit_inverse: bool = False, mesh=None):
        self.spec = model.spec
        self.chunk = int(chunk)
        # multi-chip serving: prediction is embarrassingly parallel over the
        # batch dim — shard each chunk's rows over the mesh and let GSPMD
        # partition the cross-Gram + GEMMs (state replicated; collectives
        # are nothing but the final per-row outputs staying local)
        self._sharding = None
        self._ndev = 1 if mesh is None else int(mesh.size)
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            from gpc_tpu.parallel.mesh import DATA_AXIS
            assert self.chunk % int(mesh.size) == 0, (
                "chunk must be a multiple of the device count")
            self._sharding = NamedSharding(mesh, P(DATA_AXIS, None))

        # bias / fixed_scales / X_u are REFRESH-TIME inputs, not closure
        # captures: refresh(new_model) after a retrain on re-centred data
        # (GP sets bias = column means under centre=True) must serve the
        # new model's offsets, not the construction-time ones
        self._state_fn = jax.jit(lambda theta, X, y, bias, scales, X_u:
                                 posterior_state(
                                     self.spec, theta, X, y, bias, scales,
                                     X_u_fixed=X_u,
                                     explicit_inverse=explicit_inverse))
        self._apply = jax.jit(lambda st, Xt: posterior_apply(
            self.spec, st, Xt))
        self.refresh(model)

    def refresh(self, model: GP):
        """Re-factor in place from the model's CURRENT parameters (after a
        relearn) — the compiled per-batch programs are reused, so a daemon
        can keep serving across training rounds with only the O(N³) factor
        redone.  The reference's equivalent is the dirty-flag lazy
        updateAlpha recompute (CGp.cpp:469-534)."""
        X_u = getattr(model, "X_u_fixed", None)
        self.state = self._state_fn(
            model.theta, jnp.asarray(model.X), jnp.asarray(model.y),
            jnp.asarray(model.bias), jnp.asarray(model.fixed_scales),
            None if X_u is None else jnp.asarray(X_u))

    def _bucket(self, t: int) -> int:
        """Padded batch size for a t-row piece: next power of two, capped at
        `chunk` (and, under a mesh, rounded up to a device-count multiple so
        shards stay even).  Bounds the compiled-program set at ~log2(chunk)
        shapes for arbitrary request-size streams."""
        b = 1
        while b < t:
            b <<= 1
        b = min(b, self.chunk)
        if self._ndev > 1:
            b = -(-b // self._ndev) * self._ndev
        return max(b, 1)

    def predict(self, Xtest):
        """(mu, varsigma) for any number of test rows — served in fixed-size
        chunks against the precomputed state (one compiled program)."""
        Xtest = np.asarray(Xtest)
        T = Xtest.shape[0]
        if T == 0:  # match GP.predict's (0, D) output on empty requests
            D = int(np.asarray(self.state["scales"]).shape[0])
            return np.zeros((0, D)), np.zeros((0, D))
        ch = self.chunk
        mus, vars_ = [], []
        for c0 in range(0, T, ch):
            Xb = Xtest[c0:c0 + ch]
            pad = self._bucket(Xb.shape[0]) - Xb.shape[0]
            if pad:
                Xb = np.concatenate(
                    [Xb, np.zeros((pad, Xb.shape[1]), Xb.dtype)], axis=0)
            Xj = jnp.asarray(Xb)
            if self._sharding is not None:
                Xj = jax.device_put(Xj, self._sharding)
            mu, var = self._apply(self.state, Xj)
            if pad:
                mu, var = mu[:-pad], var[:-pad]
            mus.append(np.asarray(mu))
            vars_.append(np.asarray(var))
        return np.concatenate(mus, axis=0), np.concatenate(vars_, axis=0)


class IvmServer:
    """Factor-once predictor for a trained `models.ivm.IVM`.

    The IVM's serving state is TINY — d active points (d ≪ N), a d×d
    Cholesky per covariance structure, and α = (K+B⁻¹)⁻¹m̃ — so factoring is
    microseconds and every per-batch prediction is one cross-Gram + GEMM
    (CIvm::posteriorMeanVar, /root/reference/CIvm.cpp:126-163, which the
    reference recomputes through LAPACK per request).  Same bucket-padded
    chunking contract as GPServer; `out()` additionally maps (mu, varsigma)
    through the noise model like CIvm::out (CNoise likelihood quantization).
    `refresh(model)` re-factors in place after a relearn so a daemon can
    serve while training continues.
    """

    def __init__(self, model, chunk: int = 8192):
        self.spec = model.spec
        self.chunk = int(chunk)
        self._ndev = 1
        self._sharding = None
        spec = self.spec
        J = 1 if spec.noise.spherical else spec.output_dim

        def apply_fn(st, Xt):
            kX = spec.kern.compute(st["kp"], st["Xa"], Xt)     # (d, T)
            kdiag = spec.kern.diag(st["kp"], Xt)
            from jax.scipy.linalg import solve_triangular as _st_solve
            v = _st_solve(st["L"], kX[None].repeat(J, axis=0)
                          if J > 1 else kX[None], lower=True)  # (J, d, T)
            vs = jnp.maximum(kdiag[None, :] - jnp.sum(v * v, axis=1), 0.0)
            mu = kX.T @ st["alpha"]                            # (T, D)
            var = (jnp.tile(vs[0][:, None], (1, spec.output_dim))
                   if spec.noise.spherical else vs.T)
            return mu, var

        self._apply = jax.jit(apply_fn)
        self.refresh(model)

    def refresh(self, model):
        """Re-factor the d×d serving state from the model's CURRENT
        kernel/site parameters (after optimise/relearn)."""
        spec = self.spec
        st = model.state
        kp = jnp.asarray(model.kern_params)
        Xa = jnp.asarray(model.active_X())
        m_site = jnp.asarray(st.m_site)
        beta = jnp.asarray(st.beta_site)
        K = spec.kern.gram(kp, Xa)
        J = 1 if spec.noise.spherical else spec.output_dim
        Ls, alphas = [], []
        for j in range(J):
            Kb = K + jnp.diag(1.0 / beta[:, j])
            Lc, _ = linalg.jitchol(Kb)
            Ls.append(Lc)
            alphas.append(linalg.chol_solve(
                Lc, m_site if spec.noise.spherical else m_site[:, j:j + 1]))
        self.state = dict(kp=kp, Xa=Xa,
                          L=jnp.stack(Ls, axis=0),
                          alpha=(alphas[0] if spec.noise.spherical
                                 else jnp.concatenate(alphas, axis=1)),
                          noise_params=jnp.asarray(model.noise_params))

    _bucket = GPServer._bucket

    def predict(self, Xtest):
        """(mu, varsigma) ≡ IVM.predict, served in bucket-padded chunks."""
        Xtest = np.asarray(Xtest)
        T = Xtest.shape[0]
        if T == 0:
            D = self.spec.output_dim
            return np.zeros((0, D)), np.zeros((0, D))
        ch = self.chunk
        mus, vars_ = [], []
        for c0 in range(0, T, ch):
            Xb = Xtest[c0:c0 + ch]
            pad = self._bucket(Xb.shape[0]) - Xb.shape[0]
            if pad:
                Xb = np.concatenate(
                    [Xb, np.zeros((pad, Xb.shape[1]), Xb.dtype)], axis=0)
            mu, var = self._apply(self.state, jnp.asarray(Xb))
            if pad:
                mu, var = mu[:-pad], var[:-pad]
            mus.append(np.asarray(mu))
            vars_.append(np.asarray(var))
        return np.concatenate(mus, axis=0), np.concatenate(vars_, axis=0)

    def out(self, Xtest):
        """Predicted outputs through the noise model (CIvm::out)."""
        mu, vs = self.predict(Xtest)
        return np.asarray(self.spec.noise.out(
            self.state["noise_params"], jnp.asarray(mu), jnp.asarray(vs)))
