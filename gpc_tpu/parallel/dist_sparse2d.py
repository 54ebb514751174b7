"""Sparse (DTC) evidence on a 2-D mesh: inducing rows × data rows.

The 1-D sparse path (parallel/dist_gp.py) replicates every M-sized object:
each device holds the full (M, N/dp) slab of K_uf and the M×M matrices
A and K_uu.  That caps M at a few thousand.  Here the mesh is

    axes ("mp", "dp")  —  mp shards the M inducing rows, dp the N data rows

and every large object is 2-D-block resident:

    K_uf block   (M/mp, N/dp)   per device — the memory headline: M can grow
                                 with the mp axis instead of being replicated
    K_uu, Am     (M/mp, M)      row-block sharded over mp (replicated over dp)
    factors      row-block sharded, via the distributed panel Cholesky
                                 (parallel/chol_distributed._local_factor_step
                                  running over the "mp" axis)
    e = K_uf·m   (M/mp, D)      psum over dp

The collapsed DTC evidence (CGp::logLikelihood, reference CGp.cpp:939-961)
is taken in the L_uu-whitened form of models/gp.py: logdet(Am) and
‖L_m⁻¹·W·m‖² with Am = I/β + W·Wᵀ, W = L_uu⁻¹·K_uf; the logdet comes from
the distributed factor's diagonal and the quadratic form from a distributed
forward substitution (panel sweep, Θ(M²/mp) per device).

Everything is jax.grad-differentiable: the panel sweeps are fori_loops of
dynamic slices, psums and triangular solves, so one jitted value_and_grad
drives the same SCG used everywhere else (tests/test_dist_sparse2d.py checks
value AND gradient against the single-chip model on a 2×4 CPU mesh).

Transient peak: the A-assembly all_gathers K_uf over mp in M/mp-row chunks
(ring of mp steps), so per-device peak stays O(M/mp·N/dp + M/mp·M).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.linalg import solve_triangular
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gpc_tpu import ndlutil
from gpc_tpu import priors as priors_mod
from gpc_tpu.models.gp import GpSpec
from gpc_tpu.parallel.chol_distributed import _local_factor_step

MP_AXIS = "mp"
DP_AXIS = "dp"


def mesh_2d(n_mp: int, n_dp: int) -> Mesh:
    devs = np.array(jax.devices()[: n_mp * n_dp]).reshape(n_mp, n_dp)
    return Mesh(devs, (MP_AXIS, DP_AXIS))


def _chol_rows(S_rows, n_mp, Mb, M):
    """Distributed Cholesky of an mp-row-sharded (Mb, M) block; returns this
    device's rows of L and the replicated logdet."""
    def body(j, S):
        S_new, _ = _local_factor_step(j, S, n_mp, Mb, M, axis=MP_AXIS)
        return S_new
    L_rows = lax.fori_loop(0, n_mp, body, S_rows, unroll=True)
    r = lax.axis_index(MP_AXIS)
    # my diagonal entries live at columns [r·Mb, (r+1)·Mb)
    mine = lax.dynamic_slice(L_rows, (jnp.zeros((), jnp.int32),
                                      jnp.asarray(r * Mb, jnp.int32)), (Mb, Mb))
    logdet = 2.0 * lax.psum(jnp.sum(jnp.log(jnp.diagonal(mine))), MP_AXIS)
    return L_rows, logdet


def _fwd_solve_rows(L_rows, b_l, n_mp, Mb):
    """Distributed forward substitution L v = b with L row-sharded over mp.

    b_l: this device's (Mb, D) rows of b.  Returns this device's rows of v.
    Panel sweep: rank j solves its diagonal block, the solution is broadcast
    with a psum-mask, ranks below update their residual rows.
    """
    r = lax.axis_index(MP_AXIS)
    D = b_l.shape[1]

    def body(j, carry):
        v_l, b_l = carry
        Lj_mine = lax.dynamic_slice(
            L_rows, (jnp.zeros((), jnp.int32), jnp.asarray(j * Mb, jnp.int32)),
            (Mb, Mb))                       # my rows, columns of block j
        # On ranks r < j this block is upper-triangle zero: solving against it
        # makes NaNs whose 0-masked cotangent still poisons the backward pass
        # (0·NaN leak) — substitute a safe identity INPUT on non-owner ranks.
        eye = jnp.eye(Mb, dtype=L_rows.dtype)
        Lj_safe = jnp.where(r == j, Lj_mine, eye)
        vj_mine = solve_triangular(Lj_safe, b_l, lower=True)
        vj = lax.psum(jnp.where(r == j, vj_mine, jnp.zeros_like(vj_mine)),
                      MP_AXIS)              # replicated (Mb, D)
        b_l = b_l - jnp.where(r > j, 1.0, 0.0) * (Lj_mine @ vj)
        v_l = jnp.where(r == j, vj, v_l)
        return v_l, b_l

    v0 = jnp.zeros_like(b_l)
    v_l, _ = lax.fori_loop(0, n_mp, body, (v0, b_l), unroll=True)
    return v_l


def _ring_gram_rows(V_l, n_mp, Mb, M, r):
    """Row block of V·Vᵀ (psum'd over dp) assembled by an mp-ring so only one
    remote (Mb, Nl) chunk is live at a time."""
    def ring_body(s, carry):
        G_rows, V_remote, src = carry
        block = lax.psum(V_l @ V_remote.T, DP_AXIS)              # (Mb, Mb)
        G_rows = lax.dynamic_update_slice(
            G_rows, block, (jnp.zeros((), jnp.int32),
                            jnp.asarray(src * Mb, jnp.int32)))
        perm = [(i, (i + 1) % n_mp) for i in range(n_mp)]
        V_remote = lax.ppermute(V_remote, MP_AXIS, perm)
        src = (src - 1) % n_mp
        return G_rows, V_remote, src

    G0 = jnp.zeros((Mb, M), V_l.dtype)
    G_rows, _, _ = lax.fori_loop(0, n_mp, ring_body, (G0, V_l, r),
                                 unroll=True)
    return G_rows


def make_dist2d_objective(spec: GpSpec, mesh: Mesh, bias, fixed_scales,
                          n_valid: int):
    """Returns nlml(theta, X, y, mask): theta replicated, X/y/mask sharded
    P('dp') (replicated over mp).  Implements all three sparse evidences
    (DTC / DTCVAR / FITC — reference closed forms CGp.cpp:939-988) with every
    M-sized object 2-D-block resident."""
    assert spec.approx in ("dtc", "dtcvar", "fitc"), \
        "2-D mesh path implements the sparse approximations"
    bias = jnp.asarray(bias)
    fixed_scales = jnp.asarray(fixed_scales)
    N, D, M = spec.n_data, spec.output_dim, spec.num_active
    n_mp, n_dp = mesh.devices.shape
    assert M % n_mp == 0, "num_active must divide the mp axis"
    Mb = M // n_mp
    q = spec.input_dim

    def local(theta, Xl, yl, maskl):
        X_u, kp, scales, beta = spec.unpack(theta)
        scales = scales if spec.learn_scales else fixed_scales
        ml = (yl - bias[None, :]) / scales[None, :] * maskl[:, None]
        r = lax.axis_index(MP_AXIS)
        X_u_l = lax.dynamic_slice(X_u, (jnp.asarray(r * Mb, jnp.int32),
                                        jnp.zeros((), jnp.int32)), (Mb, q))

        K_uu_rows = spec.kern.compute(kp, X_u_l, X_u)            # (Mb, M)
        diag_uu = spec.kern.diag(kp, X_u_l)
        cols = jnp.arange(M)[None, :]
        own = cols == (r * Mb + jnp.arange(Mb)[:, None])
        K_uu_rows = jnp.where(own, diag_uu[:, None], K_uu_rows)  # symmetric diag discipline
        K_ufl = spec.kern.compute(kp, X_u_l, Xl) * maskl[None, :]  # (Mb, Nl)

        L_uu_rows, _logdet_uu = _chol_rows(K_uu_rows, n_mp, Mb, M)

        if spec.approx in ("dtc", "dtcvar"):
            # the L_uu-whitened form of models/gp.py: Am = I/β + W·Wᵀ with
            # W = L_uu⁻¹·K_uf, so logdet A − logdet K_uu = logdet Am at
            # cond(Am) ≪ cond(A) (factoring A directly loses float32 digits)
            W_l = _fwd_solve_rows(L_uu_rows, K_ufl, n_mp, Mb)    # (Mb, Nl)
            Am_rows = (_ring_gram_rows(W_l, n_mp, Mb, M, r)
                       + own.astype(W_l.dtype) / beta)
            L_m_rows, logdet_m = _chol_rows(Am_rows, n_mp, Mb, M)
            e_l = lax.psum(W_l @ ml, DP_AXIS)                    # (Mb, D)
            mm = lax.psum(jnp.sum(ml * ml), DP_AXIS)
            v_l = _fwd_solve_rows(L_m_rows, e_l, n_mp, Mb)
            quad = lax.psum(jnp.sum(v_l * v_l), MP_AXIS)

            Lacc = D * ((M - N) * jnp.log(beta) + logdet_m)
            Lacc = Lacc - beta * (quad - mm)
            if spec.approx == "dtcvar":
                # trace penalty D·β·Σ(diagK − diagQ) (CGp.cpp:954-955)
                diagQ = lax.psum(jnp.sum(W_l * W_l, axis=0), MP_AXIS)
                diagK = spec.kern.diag(kp, Xl)
                dD_l = beta * (diagK - diagQ) * maskl
                Lacc = Lacc + D * lax.psum(jnp.sum(dD_l), DP_AXIS)
        else:  # FITC (CGp.cpp:806-858, 962-988): D-scaled A in L_uu⁻¹ space
            W_l = _fwd_solve_rows(L_uu_rows, K_ufl, n_mp, Mb)    # (Mb, Nl)
            diagQ = lax.psum(jnp.sum(W_l * W_l, axis=0), MP_AXIS)
            diagK = spec.kern.diag(kp, Xl)
            # masked (padding) columns must be exact no-ops: diagD=1 there
            diagD = jnp.where(maskl > 0, 1.0 + beta * (diagK - diagQ), 1.0)
            sqrtDinv = 1.0 / jnp.sqrt(diagD)
            scaledM_l = ml * sqrtDinv[:, None]                   # ml is masked
            V_l = W_l * sqrtDinv[None, :]                        # masked cols 0
            Am_rows = _ring_gram_rows(V_l, n_mp, Mb, M, r)
            eye_rows = (own.astype(V_l.dtype)) / beta            # my I/β rows
            Am_rows = Am_rows + eye_rows
            L_m_rows, logdet_m = _chol_rows(Am_rows, n_mp, Mb, M)
            e_l = lax.psum(V_l @ scaledM_l, DP_AXIS)             # (Mb, D)
            bet_l = _fwd_solve_rows(L_m_rows, e_l, n_mp, Mb)
            quad_bet = lax.psum(jnp.sum(bet_l * bet_l), MP_AXIS)
            sMsM = lax.psum(jnp.sum(scaledM_l * scaledM_l), DP_AXIS)

            Lacc = (M - N) * jnp.log(beta) + N * ndlutil.LOGTWOPI
            Lacc = Lacc + lax.psum(jnp.sum(jnp.log(diagD)), DP_AXIS)
            Lacc = Lacc + logdet_m
            Lacc = Lacc * D
            Lacc = Lacc + beta * (sMsM - quad_bet)
        if spec.learn_scales:
            Lacc = Lacc + 2.0 * jnp.sum(jnp.log(jnp.abs(scales)))
        L = -0.5 * Lacc
        L = L + priors_mod.total_log_prob(spec.kern.priors_global, kp)
        L = L - D * N * ndlutil.HALFLOGTWOPI
        return -L

    sm = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(DP_AXIS), P(DP_AXIS), P(DP_AXIS)),
        out_specs=P(), check_vma=False)

    def nlml(theta, X, y, mask):
        return sm(theta, X, y, mask)

    return nlml


def shard_data_2d(mesh: Mesh, arr):
    """Row-shard over dp, replicate over mp."""
    return jax.device_put(arr, NamedSharding(mesh, P(DP_AXIS)))


def replicated_2d(mesh: Mesh, arr):
    return jax.device_put(arr, NamedSharding(mesh, P()))
