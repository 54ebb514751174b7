"""Fully distributed FTC evidence + gradient — no N×N object anywhere.

Completes SURVEY.md §7 Phase 6: the dense-GP training path whose Gram matrix,
Cholesky factor, and gradient cotangent are all row-block sharded.  The
`dist_gp.make_dist_objective` FTC path still all_gathers K for a replicated
factorization (O(N²) per-device memory); this module removes that wall.

Structure (round 2 — the sweeps moved into the reusable custom VJP of
`parallel.chol_distributed.evidence_distributed`):

  build    a differentiable shard_map constructs this device's MASKED Gram
           rows + scaled targets from θ (jax transposes the all_gathers);
  evidence `evidence_distributed` fuses factor + forward solve + logdet in
           one panel sweep; its VJP runs the reverse panel sweeps (backward
           solve for α = K⁻¹m, forward+backward solves for the device's K⁻¹
           columns) and emits the classic evidence cotangent
           ∂L/∂K = ½(α·αᵀ − D·K⁻¹) (CGp::updateCovGradient, CGp.cpp:666-679);
  wrapper  plain jax.value_and_grad over the composition.

Per-device memory O(N·B); total communication O(N²) spread over panel gathers
(NVLink between a host's cards); all O(N³) work is local GEMMs/solves.  Gradients match the
AD-based single-chip path to float tolerance (tests/test_dist_ftc.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.linalg import solve_triangular
from jax.sharding import Mesh, PartitionSpec as P

from gpc_tpu import ndlutil
from gpc_tpu import priors as priors_mod
from gpc_tpu.models.gp import GpSpec
from gpc_tpu.parallel.chol_distributed import (
    _backward_solve_sweep, _gather_panel, _local_factor_step,
    evidence_distributed)
from gpc_tpu.parallel.mesh import DATA_AXIS


def make_dist_ftc_value_and_grad(spec: GpSpec, mesh: Mesh, bias, fixed_scales,
                                 n_valid: int):
    """Returns vag(theta, X, y, mask) → (nlml, dnlml/dtheta), fully sharded."""
    assert spec.approx == "ftc"
    n_dev = mesh.shape[DATA_AXIS]
    bias = jnp.asarray(bias)
    fixed_scales = jnp.asarray(fixed_scales)
    N_total, D = spec.n_data, spec.output_dim

    def build_local(theta, X_l, y_l, mask_l):
        """Masked Gram rows + scaled targets (pure in θ — differentiable)."""
        B = X_l.shape[0]
        d = lax.axis_index(DATA_AXIS)
        rows_g = d * B + jnp.arange(B)
        X_g = lax.all_gather(X_l, DATA_AXIS, tiled=True)
        mask_g = lax.all_gather(mask_l, DATA_AXIS, tiled=True)
        _, kp, scales, _ = spec.unpack(theta)
        scales_ = scales if spec.learn_scales else fixed_scales
        K_rows = spec.kern.compute(kp, X_l, X_g)
        diag_l = spec.kern.diag(kp, X_l)
        K_rows = K_rows * (mask_l[:, None] * mask_g[None, :])
        idx = jnp.arange(B)
        K_rows = K_rows.at[idx, rows_g].set(jnp.where(mask_l > 0, diag_l, 1.0))
        m_l = (y_l - bias[None, :]) / scales_[None, :] * mask_l[:, None]
        return K_rows, m_l

    build = jax.shard_map(
        build_local, mesh=mesh,
        in_specs=(P(), P(DATA_AXIS, None), P(DATA_AXIS, None), P(DATA_AXIS)),
        out_specs=(P(DATA_AXIS, None), P(DATA_AXIS, None)), check_vma=False)

    def nlml(theta, X, y, mask):
        K_rows, m_rows = build(theta, X, y, mask)
        # m arrives row-sharded; evidence_distributed's P() in_spec replicates
        logdet, quad = evidence_distributed(mesh, K_rows, m_rows)
        _, kp, scales, _ = spec.unpack(theta)
        scales_ = scales if spec.learn_scales else fixed_scales
        sval = priors_mod.total_log_prob(spec.kern.priors_global, kp)
        if spec.learn_scales:
            sval = sval - jnp.sum(jnp.log(jnp.abs(scales_)))
        L_val = (-0.5 * (quad + D * logdet) + sval
                 - D * N_total * ndlutil.HALFLOGTWOPI)
        return -L_val

    return jax.value_and_grad(nlml)


def make_dist_ftc_posterior(spec: GpSpec, mesh: Mesh, bias, fixed_scales,
                            n_valid: int):
    """Distributed FTC prediction: (mu, var) at T test points, K row-sharded.

    alpha = K⁻¹m from the forward+backward panel sweeps; the predictive
    variance's L⁻¹k* runs a third forward sweep with the T test columns as
    right-hand sides.  Returns posterior(theta, X, y, mask, Xtest) with
    replicated (T, D) outputs — the distributed CGp::posteriorMeanVar.
    """
    assert spec.approx == "ftc"
    n_dev = mesh.shape[DATA_AXIS]
    bias = jnp.asarray(bias)
    fixed_scales = jnp.asarray(fixed_scales)
    D = spec.output_dim

    def local(theta, X_l, y_l, mask_l, Xtest):
        B = X_l.shape[0]
        N = B * n_dev
        d = lax.axis_index(DATA_AXIS)
        zero = jnp.zeros((), jnp.int32)
        rows_g = d * B + jnp.arange(B)
        T = Xtest.shape[0]

        X_g = lax.all_gather(X_l, DATA_AXIS, tiled=True)
        mask_g = lax.all_gather(mask_l, DATA_AXIS, tiled=True)
        _, kp, scales, _ = spec.unpack(theta)
        scales_ = scales if spec.learn_scales else fixed_scales

        K_rows = spec.kern.compute(kp, X_l, X_g)
        diag_l = spec.kern.diag(kp, X_l)
        K_rows = K_rows * (mask_l[:, None] * mask_g[None, :])
        idx = jnp.arange(B)
        K_rows = K_rows.at[idx, rows_g].set(jnp.where(mask_l > 0, diag_l, 1.0))
        m_l = (y_l - bias[None, :]) / scales_[None, :] * mask_l[:, None]
        m_g = lax.all_gather(m_l, DATA_AXIS, tiled=True)

        # test cross-columns for ALL training rows (replicated; T assumed modest)
        kX_l = spec.kern.compute(kp, X_l, Xtest) * mask_l[:, None]   # (B, T)
        kX = lax.all_gather(kX_l, DATA_AXIS, tiled=True)             # (N, T)

        # sweep 1: factor + forward-solve [m | kX] together
        R0 = jnp.concatenate([m_g, kX], axis=1)                      # (N, D+T)

        def body1(j, carry):
            S, r = carry
            S, panel = _local_factor_step(j, S, n_dev, B, N)
            j32 = jnp.asarray(j, jnp.int32)
            L_jj = lax.dynamic_slice(panel, (j32 * B, zero), (B, B))
            r_j = lax.dynamic_slice(r, (j32 * B, zero), (B, R0.shape[1]))
            v_j = solve_triangular(L_jj, r_j, lower=True)
            below = (jnp.arange(N) >= (j + 1) * B)[:, None]
            r = r - jnp.where(below, panel @ v_j, 0.0)
            r = lax.dynamic_update_slice(r, v_j, (j32 * B, zero))
            return S, r

        L_local, V = lax.fori_loop(0, n_dev, body1, (K_rows, R0))
        v_m = V[:, :D]            # L⁻¹m
        v_k = V[:, D:]            # L⁻¹k*

        # sweep 2: backward solve for alpha = L⁻ᵀ (L⁻¹ m) — shared machinery
        alpha = _backward_solve_sweep(L_local, v_m, n_dev, B, N)

        mu0 = kX.T @ alpha                                           # (T, D)
        kstar = spec.kern.diag(kp, Xtest)
        var0 = kstar - jnp.sum(v_k * v_k, axis=0)                    # (T,)
        mu = mu0 * scales_[None, :] + bias[None, :]
        var = var0[:, None] * (scales_ ** 2)[None, :]
        return mu, var

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(DATA_AXIS, None), P(DATA_AXIS, None), P(DATA_AXIS), P()),
        out_specs=(P(), P()), check_vma=False)
