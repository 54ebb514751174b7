"""Distributed right-looking blocked Cholesky over row-block-sharded K.

The scale-out answer to the reference's O(N³) wall (SURVEY.md §5: "blockwise
Gram construction + distributed blocked Cholesky" is this framework's analogue
of ring attention).  K never exists on one chip: device d owns the row block
K[d·B:(d+1)·B, :], so N is bounded by per-device memory at O(N·B) instead of
O(N²).

Panel sweep (W = B columns per panel, nb = n_devices panels):
  for j in 0..nb-1:
    1. every device contributes its B×B slice of column-panel j;
       `all_gather` assembles the full (N, B) panel — the only communication,
       N·B floats per step over the interconnect (Σ = N² total, same volume as gathering K
       once, but peak memory stays O(N·B));
    2. replicated small work: L_jj = chol(panel[jB:(j+1)B]), then
       L_panel = panel · L_jj⁻ᵀ with rows < jB zeroed (they're already final);
    3. each device's trailing update is one local GEMM:
       S_local[:, k>jB] −= L_local_panel · L_panel[k rows]ᵀ
    4. each device writes its rows of the finished panel into its block.

The factor comes back row-block-sharded.  `chol_distributed` is a raw factor
(forward-only); the differentiable surface is `evidence_distributed`, whose
custom VJP runs the reverse panel sweeps (the same three sweeps the FTC
training path uses) so GPLVM and sparse paths can `jax.grad` straight through
the distributed evidence.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.linalg import solve_triangular
from jax.sharding import Mesh, PartitionSpec as P

from gpc_tpu.parallel.mesh import DATA_AXIS


def _local_factor_step(j, S_local, n_dev, B, N, axis=DATA_AXIS):
    """One panel step inside shard_map; S_local is this device's (B, N) rows.

    `axis` names the mesh axis the rows are sharded over — "dp" for the dense
    FTC path, "mp" when the same machinery factors inducing-space matrices on
    a 2-D mesh (parallel/dist_sparse2d.py)."""
    d = lax.axis_index(axis)

    # 1. gather column panel j: my (B, B) slice of columns [jB, (j+1)B)
    j = jnp.asarray(j, jnp.int32)
    zero = jnp.zeros((), jnp.int32)
    my_cols = lax.dynamic_slice(S_local, (zero, j * B), (B, B))
    panel = lax.all_gather(my_cols, axis, tiled=True)             # (N, B)

    # 2. replicated panel factorization.  Deliberately NO jitter rescue
    # here: like every non-dense engine (README env notes), a transiently
    # non-PD K yields NaN evidence that SCG rejects as a failed step —
    # the dense single-chip path is the one that re-jitters
    # (linalg.jitchol); threading an escalation loop through the mesh
    # collectives would buy little and risk the panel schedule.
    diag = lax.dynamic_slice(panel, (j * B, zero), (B, B))
    L_jj = jnp.linalg.cholesky(diag)
    # rows above the diagonal block are already final (zero in this panel)
    rows = jnp.arange(N)[:, None]
    panel = jnp.where(rows >= j * B, panel, 0.0)
    L_panel = solve_triangular(L_jj, panel.T, lower=True).T       # (N, B)
    L_panel = jnp.where(rows > (j + 1) * B - 1, L_panel, 0.0)     # strictly-below part
    L_panel = lax.dynamic_update_slice(L_panel, L_jj, (j * B, zero))

    # 3. local trailing update: my rows × all columns (masked to k > j panels)
    my_Lrows = lax.dynamic_slice(L_panel, (jnp.asarray(d, jnp.int32) * B, zero), (B, B))
    update = my_Lrows @ L_panel.T                                 # (B, N)
    cols = jnp.arange(N)[None, :]
    trailing = cols >= (j + 1) * B
    S_local = S_local - jnp.where(trailing, update, 0.0)

    # 4. write my rows of the finished panel into my block's columns j
    S_local = lax.dynamic_update_slice(S_local, my_Lrows, (zero, j * B))
    return S_local, L_panel


def _gather_panel(L_local, j, B, axis=DATA_AXIS):
    """Replicated (N, B) column panel j of the row-sharded factor."""
    zero = jnp.zeros((), jnp.int32)
    my = lax.dynamic_slice(L_local, (zero, jnp.asarray(j, jnp.int32) * B),
                           (B, B))
    return lax.all_gather(my, axis, tiled=True)


def _forward_solve_sweep(L_local, r, n_dev, B, N):
    """Forward substitution L·v = r over gathered panels (replicated r)."""
    zero = jnp.zeros((), jnp.int32)

    def body(j, r):
        j32 = jnp.asarray(j, jnp.int32)
        panel = _gather_panel(L_local, j, B)
        L_jj = lax.dynamic_slice(panel, (j32 * B, zero), (B, B))
        r_j = lax.dynamic_slice(r, (j32 * B, zero), (B, r.shape[1]))
        v_j = solve_triangular(L_jj, r_j, lower=True)
        below = (jnp.arange(N) >= (j + 1) * B)[:, None]
        r = r - jnp.where(below, panel @ v_j, 0.0)
        return lax.dynamic_update_slice(r, v_j, (j32 * B, zero))

    return lax.fori_loop(0, n_dev, body, r)


def _backward_solve_sweep(L_local, v, n_dev, B, N):
    """Backward substitution Lᵀ·a = v over gathered panels (replicated v)."""
    zero = jnp.zeros((), jnp.int32)

    def body(t, alpha):
        j = n_dev - 1 - t
        j32 = jnp.asarray(j, jnp.int32)
        panel = _gather_panel(L_local, j, B)
        L_jj = lax.dynamic_slice(panel, (j32 * B, zero), (B, B))
        a_j = lax.dynamic_slice(alpha, (j32 * B, zero), (B, alpha.shape[1]))
        below = (jnp.arange(N) >= (j + 1) * B)[:, None]
        rhs = a_j - panel.T @ jnp.where(below, alpha, 0.0)
        a_j = solve_triangular(L_jj.T, rhs, lower=False)
        return lax.dynamic_update_slice(alpha, a_j, (j32 * B, zero))

    return lax.fori_loop(0, n_dev, body, v)


@functools.lru_cache(maxsize=None)
def _evidence_distributed_fn(mesh: Mesh):
    """Differentiable (logdet, quad) = f(K_rows, m) over `mesh`, cached per
    mesh so the custom_vjp identity is stable across jit retraces."""
    n_dev = mesh.shape[DATA_AXIS]

    def fwd_local(S_local, m_rep):
        B, N = S_local.shape
        zero = jnp.zeros((), jnp.int32)

        def body(j, carry):
            S, r, logdet = carry
            S, panel = _local_factor_step(j, S, n_dev, B, N)  # (N, B), replicated
            j32 = jnp.asarray(j, jnp.int32)
            L_jj = lax.dynamic_slice(panel, (j32 * B, zero), (B, B))
            r_j = lax.dynamic_slice(r, (j32 * B, zero), (B, r.shape[1]))
            v_j = solve_triangular(L_jj, r_j, lower=True)
            below = (jnp.arange(N) >= (j + 1) * B)[:, None]
            r = r - jnp.where(below, panel @ v_j, 0.0)
            r = lax.dynamic_update_slice(r, v_j, (j32 * B, zero))
            logdet = logdet + 2.0 * jnp.sum(jnp.log(jnp.diagonal(L_jj)))
            return S, r, logdet

        init = (S_local, m_rep, jnp.zeros((), S_local.dtype))
        L_local, v, logdet = lax.fori_loop(0, n_dev, body, init)
        return logdet, jnp.sum(v * v), L_local, v

    fwd_sharded = jax.shard_map(
        fwd_local, mesh=mesh, in_specs=(P(DATA_AXIS, None), P()),
        out_specs=(P(), P(), P(DATA_AXIS, None), P()), check_vma=False)

    def bwd_local(L_local, v, g_ld, g_quad):
        """Cotangents: ∂logdet/∂K = K⁻¹ (symmetric), ∂quad/∂K = −α·αᵀ,
        ∂quad/∂m = 2α, with α = K⁻¹m = L⁻ᵀv — the reverse panel sweeps of the
        FTC training path (CGp::updateCovGradient form, CGp.cpp:666-679)."""
        B, N = L_local.shape
        d = lax.axis_index(DATA_AXIS)
        zero = jnp.zeros((), jnp.int32)
        rows_g = d * B + jnp.arange(B)

        alpha = _backward_solve_sweep(L_local, v, n_dev, B, N)
        # Z = K⁻¹·E_d (my unit columns): forward then backward sweep
        U0 = jnp.zeros((N, B), L_local.dtype).at[rows_g, jnp.arange(B)].set(1.0)
        Z = _backward_solve_sweep(
            L_local, _forward_solve_sweep(L_local, U0, n_dev, B, N),
            n_dev, B, N)
        alpha_l = lax.dynamic_slice(alpha, (d * B, zero), (B, alpha.shape[1]))
        Kbar_rows = g_ld * Z.T - g_quad * (alpha_l @ alpha.T)
        mbar = 2.0 * g_quad * alpha
        return Kbar_rows, mbar

    bwd_sharded = jax.shard_map(
        bwd_local, mesh=mesh,
        in_specs=(P(DATA_AXIS, None), P(), P(), P()),
        out_specs=(P(DATA_AXIS, None), P()), check_vma=False)

    @jax.custom_vjp
    def evidence(K_rows, m):
        logdet, quad, _L, _v = fwd_sharded(K_rows, m)
        return logdet, quad

    def evidence_fwd(K_rows, m):
        logdet, quad, L_local, v = fwd_sharded(K_rows, m)
        return (logdet, quad), (L_local, v)

    def evidence_bwd(res, cots):
        L_local, v = res
        g_ld, g_quad = cots
        Kbar, mbar = bwd_sharded(L_local, v, jnp.asarray(g_ld),
                                 jnp.asarray(g_quad))
        return Kbar, mbar

    evidence.defvjp(evidence_fwd, evidence_bwd)
    return evidence


def evidence_distributed(mesh: Mesh, K_rows, m):
    """Fused distributed evidence: logdet(K) and Σⱼ mⱼᵀK⁻¹mⱼ in ONE panel
    sweep — differentiable in (K_rows, m) via a custom VJP.

    The forward substitution L·v = m rides the factorization: at panel j the
    replicated (N, B) column panel is already in hand, so v_j = L_jj⁻¹·r_j and
    the residual update r ← r − L_panel·v_j cost no additional communication
    (m and r are (N, D) with small D, kept replicated).  Returns
    (logdet, quad) replicated — exactly the two numbers the FTC NLML needs
    (CGp.cpp:920-937) — without K, L, or any N×N object ever existing on a
    single device.  The VJP runs the reverse panel sweeps (backward solve for
    α, forward+backward solves for this device's K⁻¹ columns), so `jax.grad`
    through a kernel-built K_rows matches the dense single-chip gradient.
    """
    n_dev = mesh.shape[DATA_AXIS]
    N = K_rows.shape[0]
    assert N % n_dev == 0
    return _evidence_distributed_fn(mesh)(K_rows, jnp.asarray(m))


def chol_distributed(mesh: Mesh, K_rows):
    """Factor a row-block-sharded SPD matrix; returns L row-block-sharded.

    K_rows: (N, N) array sharded P(DATA_AXIS, None) over `mesh`; N must divide
    evenly by the device count.
    """
    n_dev = mesh.shape[DATA_AXIS]
    N = K_rows.shape[0]
    assert N % n_dev == 0, "N must be divisible by the device count"
    B = N // n_dev

    def local(S_local):
        def body(j, S):
            S, _panel = _local_factor_step(j, S, n_dev, B, N)
            return S
        S_local = lax.fori_loop(0, n_dev, body, S_local)
        # zero strict upper triangle of my rows
        d = lax.axis_index(DATA_AXIS)
        rows = d * B + jnp.arange(B)[:, None]
        cols = jnp.arange(N)[None, :]
        return jnp.where(cols <= rows, S_local, 0.0)

    return jax.shard_map(local, mesh=mesh, in_specs=P(DATA_AXIS, None),
                         out_specs=P(DATA_AXIS, None), check_vma=False)(K_rows)
