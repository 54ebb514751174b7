"""Distributed GP likelihoods: row-block sharded data, psum-reduced evidence.

The scale-out the reference never had (SURVEY.md §2.15, §5).  Two
mathematically-natural decompositions:

* **Sparse (DTC/DTCVAR/FITC)** — the "TP analogue": inducing inputs X_u (M rows)
  replicated, data rows sharded.  Each device computes its K_uf slab and local
  moments; the L_uu-whitened M×M quantities Am = I/β + V·D⁻¹·Vᵀ (V =
  L_uu⁻¹K_uf), e = V·D⁻¹·m and scalar traces reduce with `psum` over the
  interconnect; the collapsed evidence
  (CGp.cpp:939-988 forms) is then evaluated replicated.  Per-device cost
  O(N_local·M·q + M³), communication O(M²) — weak-scales in N.

* **FTC** — row-block Gram construction sharded (each device computes its
  N_local×N block of K locally), `all_gather` assembles K for a replicated
  Cholesky.  Gram is the O(N²q) term; the O(N³) Cholesky stays replicated in
  round 1 (distributed panel Cholesky is the planned upgrade).

Padded rows (sharding needs equal blocks) are masked: their targets are zero,
their K rows/cols are knocked to identity exactly like the GP-LVM's dynamics
break rows, so logdet and quadratic terms are unaffected.

Gradients flow through `shard_map` + collectives via jax.grad; SCG runs
replicated on the psum-reduced scalars, so every device executes the identical
optimizer trajectory.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gpc_tpu import linalg, ndlutil
from gpc_tpu import priors as priors_mod
from gpc_tpu.models.gp import GpSpec, FTC, DTC, DTCVAR, FITC
from gpc_tpu.parallel.mesh import DATA_AXIS


def _shard_specs(mesh):
    return dict(mesh=mesh,
                in_specs=(P(), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS)),
                out_specs=P(),
                check_vma=False)


def make_dist_objective(spec: GpSpec, mesh: Mesh, bias, fixed_scales,
                        n_valid: int):
    """Returns nlml(theta, X, y, mask) with X/y/mask row-sharded over 'dp'.

    `mask` is 1.0 for real rows, 0.0 for padding; n_valid is the true N
    (= spec.n_data).  theta layout identical to the single-chip model, so
    parameters and optimizer state move freely between paths.
    """
    bias = jnp.asarray(bias)
    fixed_scales = jnp.asarray(fixed_scales)
    N, D = spec.n_data, spec.output_dim
    assert n_valid == N

    if spec.approx == FTC:
        def local(theta, Xl, yl, maskl):
            X_u, kp, scales, beta = spec.unpack(theta)
            scales = scales if spec.learn_scales else fixed_scales
            ml = (yl - bias[None, :]) / scales[None, :] * maskl[:, None]
            # full X via all_gather of row blocks (needed for cross-tiles)
            Xg = lax.all_gather(Xl, DATA_AXIS, tiled=True)
            maskg = lax.all_gather(maskl, DATA_AXIS, tiled=True)
            # this device's row-block of the Gram matrix — local work
            K_rows = spec.kern.compute(kp, Xl, Xg)
            K = lax.all_gather(K_rows, DATA_AXIS, tiled=True)
            # symmetric diagonal discipline + white + padding knockout
            diag = spec.kern.diag(kp, Xg)
            outer = maskg[:, None] * maskg[None, :]
            K = K * outer
            n_idx = jnp.arange(K.shape[0])
            K = K.at[n_idx, n_idx].set(jnp.where(maskg > 0, diag, 1.0))
            m = lax.all_gather(ml, DATA_AXIS, tiled=True)
            L_K, _ = linalg.jitchol(K)
            Lacc = linalg.quad_form(L_K, m) + D * linalg.chol_logdet(L_K)
            if spec.learn_scales:
                Lacc = Lacc + 2.0 * jnp.sum(jnp.log(jnp.abs(scales)))
            L = -0.5 * Lacc
            L = L + priors_mod.total_log_prob(spec.kern.priors_global, kp)
            L = L - D * N * ndlutil.HALFLOGTWOPI
            return -L
    else:
        def local(theta, Xl, yl, maskl):
            X_u, kp, scales, beta = spec.unpack(theta)
            scales = scales if spec.learn_scales else fixed_scales
            ml = (yl - bias[None, :]) / scales[None, :] * maskl[:, None]
            M = spec.num_active
            K_uu = spec.kern.gram(kp, X_u)                 # replicated
            K_ufl = spec.kern.compute(kp, X_u, Xl) * maskl[None, :]
            L_uu, _ = linalg.jitchol(K_uu)

            if spec.approx in (DTC, DTCVAR):
                # the L_uu-whitened form of models/gp.py: A = L_uu·Am·L_uuᵀ
                # with Am = I/β + V·Vᵀ, V = L_uu⁻¹K_uf — the same quantity
                # at cond(Am) ≪ cond(A); factoring A directly loses ~1e-5
                # of the float32 evidence at N=16k, M=1024 (PERF.md)
                Vl = linalg.tri_solve(L_uu, K_ufl)
                Am = (jnp.eye(M, dtype=Vl.dtype) / beta
                      + lax.psum(Vl @ Vl.T, DATA_AXIS))
                e = lax.psum(Vl @ ml, DATA_AXIS)
                mm = lax.psum(jnp.sum(ml * ml), DATA_AXIS)
                L_m, _ = linalg.jitchol(Am)
                quad = jnp.sum(jnp.square(linalg.tri_solve(L_m, e)))
                Lacc = D * ((M - N) * jnp.log(beta)
                            + linalg.chol_logdet(L_m))
                Lacc = Lacc - beta * (quad - mm)
                if spec.approx == DTCVAR:
                    diagKl = spec.kern.diag(kp, Xl) * maskl
                    tr = lax.psum(jnp.sum(Vl * Vl), DATA_AXIS)
                    trK = lax.psum(jnp.sum(diagKl), DATA_AXIS)
                    Lacc = Lacc + D * beta * (trK - tr)
            else:  # FITC
                diagKl = spec.kern.diag(kp, Xl)
                # one whitening solve serves diagQ and V (models/gp.py)
                Wl = linalg.tri_solve(L_uu, K_ufl)
                diagQl = jnp.sum(Wl * Wl, axis=0)
                diagDl = jnp.where(maskl > 0, 1.0 + beta * (diagKl - diagQl), 1.0)
                Dinvl = 1.0 / diagDl
                scaledMl = ml * jnp.sqrt(Dinvl)[:, None]
                Vl = Wl * jnp.sqrt(Dinvl)[None, :]
                Am = jnp.eye(M, dtype=Vl.dtype) / beta + lax.psum(Vl @ Vl.T, DATA_AXIS)
                L_m, _ = linalg.jitchol(Am)
                bet = lax.psum(linalg.tri_solve(L_m, Vl) @ scaledMl, DATA_AXIS)
                Lacc = (M - N) * jnp.log(beta) + N * ndlutil.LOGTWOPI
                Lacc = Lacc + lax.psum(jnp.sum(jnp.log(diagDl)), DATA_AXIS)
                Lacc = Lacc + 2.0 * jnp.sum(jnp.log(jnp.diagonal(L_m)))
                Lacc = Lacc * D
                smm = lax.psum(jnp.sum(scaledMl * scaledMl), DATA_AXIS)
                Lacc = Lacc + beta * (smm - jnp.sum(bet * bet))

            if spec.learn_scales:
                Lacc = Lacc + 2.0 * jnp.sum(jnp.log(jnp.abs(scales)))
            L = -0.5 * Lacc
            L = L + priors_mod.total_log_prob(spec.kern.priors_global, kp)
            L = L - D * N * ndlutil.HALFLOGTWOPI
            return -L

    sm = jax.shard_map(local, **_shard_specs(mesh))

    def nlml(theta, X, y, mask):
        return sm(theta, X, y, mask)

    return nlml


def make_dist_train_step(spec: GpSpec, mesh: Mesh, bias, fixed_scales,
                        n_valid: int):
    """One full SCG training run as a single jitted, sharded computation.

    Returns step(theta, X, y, mask, iters) — the ScgResult of running the
    Møller optimizer on the distributed NLML.  Every device executes the same
    replicated SCG trajectory over psum-reduced objective/gradient values.
    """
    from gpc_tpu.optim.scg import scg

    nlml = make_dist_objective(spec, mesh, bias, fixed_scales, n_valid)

    def step(theta, X, y, mask, iters: int):
        vag = jax.value_and_grad(lambda t: nlml(t, X, y, mask))
        return scg(vag, theta, max_iters=iters)

    return step
