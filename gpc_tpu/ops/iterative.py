"""Matrix-free iterative GP evidence: blockwise MVMs, batched CG, SLQ logdet.

Capability beyond the reference (which tops out where O(N²) memory ends):
the Gram matrix is never materialized — K·v is computed in row blocks straight
from the kernel tile function (each block one GEMM chain), the quadratic
form mᵀK⁻¹m comes from batched conjugate gradients, and log|K| from stochastic
Lanczos quadrature over Rademacher probes.  This is the BBMM/GPyTorch recipe
(PAPERS.md: Gardner et al. 2018, "Blackbox Matrix-Matrix Gaussian Process
Inference") re-expressed with jit/scan-friendly fixed-iteration loops.

Estimator accuracy: quad is exact to CG tolerance; logdet is unbiased with
O(1/√probes) noise — suitable for training-scale evidence evaluation, not for
MATCHTOL parity (use the dense/distributed paths there).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from gpc_tpu.kernels import Kern


def kernel_mvm(kern: Kern, p, X, V, block: int = 2048):
    """K·V without materializing K: row-block tiles × V.

    The only diagonal correction beyond the cross tiles is the white variance
    (diagComputeElement ≡ computeElement(x,x) for every non-white kernel), so
    K·V = Σ_blocks compute(X_b, X)·V + white·V.
    """
    N = X.shape[0]
    nb = -(-N // block)
    pad = nb * block - N
    Xp = jnp.pad(X, ((0, pad), (0, 0)))
    blocks = Xp.reshape(nb, block, X.shape[1])

    @jax.checkpoint
    def one(Xb):
        return kern.compute(p, Xb, X) @ V

    out = lax.map(one, blocks).reshape(nb * block, V.shape[1])[:N]
    return out + kern.white(p) * V


class CgResult(NamedTuple):
    x: jax.Array
    residual: jax.Array
    iters: jax.Array


def cg_solve(mvm, B, max_iters: int = 256, tol: float = 1e-10):
    """Batched conjugate gradients for SPD systems K·X = B (B: (N, D))."""
    X0 = jnp.zeros_like(B)
    R0 = B
    P0 = B
    rs0 = jnp.sum(R0 * R0, axis=0)
    bnorm = jnp.sqrt(jnp.sum(B * B, axis=0)) + 1e-300

    def cond(state):
        _x, _r, _p, rs, it = state
        return jnp.logical_and(it < max_iters,
                               jnp.max(jnp.sqrt(rs) / bnorm) > tol)

    def body(state):
        x, r, p, rs, it = state
        Kp = mvm(p)
        alpha = rs / (jnp.sum(p * Kp, axis=0) + 1e-300)
        x = x + p * alpha[None, :]
        r = r - Kp * alpha[None, :]
        rs_new = jnp.sum(r * r, axis=0)
        beta = rs_new / (rs + 1e-300)
        p = r + p * beta[None, :]
        return x, r, p, rs_new, it + 1

    x, r, _p, rs, it = lax.while_loop(cond, body, (X0, R0, P0, rs0, jnp.array(0)))
    return CgResult(x=x, residual=jnp.sqrt(rs), iters=it)


def _lanczos(mvm, z, k: int):
    """k-step Lanczos with full reorthogonalization; returns (alphas, betas)."""
    N = z.shape[0]
    q0 = z / jnp.linalg.norm(z)

    def body(carry, _):
        Q, q, q_prev, beta_prev, i = carry
        w = mvm(q[:, None])[:, 0] - beta_prev * q_prev
        alpha = jnp.dot(w, q)
        w = w - alpha * q
        # full reorthogonalization against stored basis
        w = w - Q @ (Q.T @ w)
        beta = jnp.linalg.norm(w)
        q_next = w / jnp.where(beta > 0, beta, 1.0)
        Q = Q.at[:, i].set(q)
        return (Q, q_next, q, beta, i + 1), (alpha, beta)

    Q0 = jnp.zeros((N, k), z.dtype)
    (_, _, _, _, _), (alphas, betas) = lax.scan(
        body, (Q0, q0, jnp.zeros_like(q0), jnp.zeros((), z.dtype), 0),
        None, length=k)
    return alphas, betas


def slq_logdet(mvm, N: int, key, probes: int = 16, lanczos_iters: int = 32,
               dtype=jnp.float64):
    """Stochastic Lanczos quadrature estimate of log|K|."""
    def one(key):
        z = jax.random.rademacher(key, (N,), dtype=dtype)
        alphas, betas = _lanczos(mvm, z, lanczos_iters)
        T = (jnp.diag(alphas) + jnp.diag(betas[:-1], 1) + jnp.diag(betas[:-1], -1))
        evals, evecs = jnp.linalg.eigh(T)
        evals = jnp.maximum(evals, 1e-300)
        tau2 = evecs[0, :] ** 2
        return jnp.sum(tau2 * jnp.log(evals)) * N

    keys = jax.random.split(key, probes)
    return jnp.mean(jax.vmap(one)(keys))


@functools.partial(jax.jit, static_argnames=("kern", "block", "probes",
                                             "lanczos_iters", "cg_iters",
                                             "precond_rank"))
def iterative_evidence(kern: Kern, p, X, m, key, block: int = 2048,
                       probes: int = 16, lanczos_iters: int = 32,
                       cg_iters: int = 256, precond_rank: int = 0):
    """Matrix-free (quad, logdet) — the two FTC evidence ingredients.

    quad = Σ_j m_jᵀK⁻¹m_j via (preconditioned) CG; logdet via SLQ.
    precond_rank > 0 builds a pivoted-Cholesky/Woodbury preconditioner —
    required for convergence at large N / small white variance (measured at
    N=65k: plain CG stalls, ROADMAP.md).  O(N·(block+rank)) memory.
    """
    mvm = lambda V: kernel_mvm(kern, p, X, V, block=block)
    if precond_rank > 0:
        Lk = pivoted_cholesky(kern, p, X, precond_rank)
        pre = woodbury_preconditioner(Lk, kern.white(p) + 1e-8)
        sol = pcg_solve(mvm, m, pre, max_iters=cg_iters)
    else:
        sol = cg_solve(mvm, m, max_iters=cg_iters)
    quad = jnp.sum(m * sol.x)
    logdet = slq_logdet(mvm, X.shape[0], key, probes=probes,
                        lanczos_iters=lanczos_iters, dtype=X.dtype)
    return quad, logdet


def pivoted_cholesky(kern: Kern, p, X, rank: int, mask=None):
    """Greedy rank-k pivoted Cholesky of the (white-free) kernel matrix.

    The standard preconditioner for kernel-matrix CG (PAPERS.md: Cutajar et al.
    2016, "Preconditioning Kernel Matrices"): k steps, each picking the largest
    remaining diagonal, evaluating ONE kernel column, and downdating — O(N·k²)
    work and O(N·k) memory, no N×N object.  Returns Lk (N, k).

    With `mask` (pads / sequence breaks), masked-out rows are excluded: their
    residual diagonal is zeroed so they are never picked as pivots, and their
    Lk rows are zeroed so the Woodbury preconditioner never mixes the identity
    subspace with the kernel one — matching the masked operator
    mask·K·mask + (I − mask) of parallel/dist_iterative and the GPDM
    dynamics route.
    """
    N = X.shape[0]
    diag0 = kern.diag(p, X) - kern.white(p)  # white handled by the solve shift
    if mask is not None:
        diag0 = diag0 * mask

    def body(i, carry):
        Lk, d = carry
        piv = jnp.argmax(d)
        col = kern.compute(p, X, lax.dynamic_slice(X, (piv, 0), (1, X.shape[1])))[:, 0]
        if mask is not None:
            col = col * mask
        li = Lk[piv, :]                       # previously accumulated row at pivot
        col = col - Lk @ li
        pivot_val = jnp.maximum(d[piv], 1e-12)
        newcol = col / jnp.sqrt(pivot_val)
        newcol = newcol.at[piv].set(jnp.sqrt(pivot_val))
        if mask is not None:
            newcol = newcol * mask
        Lk = Lk.at[:, i].set(newcol)
        d = jnp.maximum(d - newcol * newcol, 0.0)
        d = d.at[piv].set(0.0)
        return Lk, d

    Lk0 = jnp.zeros((N, rank), X.dtype)
    Lk, _ = lax.fori_loop(0, rank, body, (Lk0, diag0))
    return Lk


def pivoted_cholesky_masked(kern: Kern, p, X, mask, rank: int):
    """Masked-rows variant of `pivoted_cholesky` (see its docstring)."""
    return pivoted_cholesky(kern, p, X, rank, mask=mask)


def woodbury_preconditioner(Lk, sigma2):
    """Solve (Lk·Lkᵀ + σ²I)⁻¹·r via Woodbury, as a closure for PCG."""
    k = Lk.shape[1]
    inner = sigma2 * jnp.eye(k, dtype=Lk.dtype) + Lk.T @ Lk
    Linner = jnp.linalg.cholesky(inner)

    def solve(R):
        t = Lk.T @ R
        t = jax.scipy.linalg.cho_solve((Linner, True), t)
        return (R - Lk @ t) / sigma2

    return solve


def pcg_solve(mvm, B, precond, max_iters: int = 256, tol: float = 1e-10):
    """Preconditioned CG for SPD K·X = B with M⁻¹ ≈ K⁻¹ given by `precond`."""
    X0 = jnp.zeros_like(B)
    R0 = B
    Z0 = precond(R0)
    P0 = Z0
    rz0 = jnp.sum(R0 * Z0, axis=0)
    bnorm = jnp.sqrt(jnp.sum(B * B, axis=0)) + 1e-300

    def cond(state):
        _x, r, _z, _p, rz, it = state
        return jnp.logical_and(
            it < max_iters,
            jnp.max(jnp.sqrt(jnp.sum(r * r, axis=0)) / bnorm) > tol)

    def body(state):
        x, r, z, pdir, rz, it = state
        Kp = mvm(pdir)
        alpha = rz / (jnp.sum(pdir * Kp, axis=0) + 1e-300)
        x = x + pdir * alpha[None, :]
        r = r - Kp * alpha[None, :]
        z = precond(r)
        rz_new = jnp.sum(r * z, axis=0)
        beta = rz_new / (rz + 1e-300)
        pdir = z + pdir * beta[None, :]
        return x, r, z, pdir, rz_new, it + 1

    x, r, _z, _p, _rz, it = lax.while_loop(
        cond, body, (X0, R0, Z0, P0, rz0, jnp.array(0)))
    return CgResult(x=x, residual=jnp.sqrt(jnp.sum(r * r, axis=0)), iters=it)


class IterConfig(NamedTuple):
    """Hashable iterative-engine knobs (env-overridable, see `iter_config`)."""
    block: int = 2048
    probes: int = 16
    lanczos_iters: int = 32
    cg_iters: int = 256
    precond_rank: int = 0
    trace_probes: int = 16
    seed: int = 0


def iter_config() -> IterConfig:
    """GPC_TPU_ITER_{BLOCK,PROBES,LANCZOS,CG,PRECOND,TPROBES,SEED} env knobs
    for the `GPC_TPU_EVIDENCE=iterative` engine."""
    import os
    g = lambda k, d: int(os.environ.get(f"GPC_TPU_ITER_{k}", d))
    return IterConfig(block=g("BLOCK", 2048), probes=g("PROBES", 16),
                      lanczos_iters=g("LANCZOS", 32), cg_iters=g("CG", 256),
                      precond_rank=g("PRECOND", 0),
                      trace_probes=g("TPROBES", 16), seed=g("SEED", 0))


@functools.lru_cache(maxsize=None)
def _iter_evidence_fn(kern: Kern, cfg: IterConfig):
    """custom_vjp'd (logdet, quad) = f(p, X, m) — the matrix-free analogue of
    the (round-2..4) explicit-K⁻¹ custom VJP, cached per (kernel, config) so the
    custom_vjp identity is stable across jit retraces.

    Differentiable in all three arguments (GP-LVM trains its latent X through
    this), BBMM-style (PAPERS.md: Gardner et al. 2018): the backward never
    unrolls the solver —

      quad   = Σⱼ mⱼᵀαⱼ,  α = K⁻¹m by (preconditioned) CG   (exact to CG tol)
      logdet = SLQ over `probes` Rademacher vectors          (unbiased, O(1/√P))
      ∂quad/∂θ   = −Σⱼ αⱼᵀ(∂K/∂θ)αⱼ,            ∂quad/∂m = 2α
      ∂logdet/∂θ = tr(K⁻¹ ∂K/∂θ) ≈ (1/T)Σᵢ wᵢᵀ(∂K/∂θ)zᵢ,  w = K⁻¹z solved
                   alongside m in ONE multi-RHS CG (Hutchinson, unbiased),

    each realized as jax.grad of a blockwise-rematerialized contraction, so
    memory stays O(N·(block + D + T)) and K is never materialized.  Probe
    vectors are FIXED by cfg.seed: the objective is deterministic given the
    seed (SCG line searches stay consistent) and the θ-gradient is the exact
    gradient of a fixed-probe estimator.  The reference dead-ends at dense
    O(N²) memory (/root/reference/CGp.cpp:877-909, README.md:412-414)."""

    def _solve(p, X, B):
        mvm = lambda V: kernel_mvm(kern, p, X, V, block=cfg.block)
        if cfg.precond_rank > 0:
            Lk = pivoted_cholesky(kern, p, X, cfg.precond_rank)
            pre = woodbury_preconditioner(Lk, kern.white(p) + 1e-8)
            return pcg_solve(mvm, B, pre, max_iters=cfg.cg_iters).x
        return cg_solve(mvm, B, max_iters=cfg.cg_iters).x

    def _forward(p, X, m):
        N, D = m.shape
        key = jax.random.PRNGKey(cfg.seed)
        k_tr, k_slq = jax.random.split(jax.random.fold_in(key, N))
        Z = jax.random.rademacher(k_tr, (N, cfg.trace_probes), dtype=X.dtype)
        sols = _solve(p, X, jnp.concatenate([m, Z], axis=1))
        alpha, W = sols[:, :D], sols[:, D:]
        quad = jnp.sum(m * alpha)
        mvm = lambda V: kernel_mvm(kern, p, X, V, block=cfg.block)
        logdet = slq_logdet(mvm, N, k_slq, probes=cfg.probes,
                            lanczos_iters=cfg.lanczos_iters, dtype=X.dtype)
        return (logdet, quad), (p, X, alpha, W, Z)

    @jax.custom_vjp
    def evidence(p, X, m):
        (logdet, quad), _ = _forward(p, X, m)
        return logdet, quad

    def evidence_bwd(res, cots):
        p, X, alpha, W, Z = res
        g_ld, g_quad = cots
        alpha = lax.stop_gradient(alpha)
        W = lax.stop_gradient(W)

        def contracted(p_, X_):
            s_q = jnp.sum(alpha * kernel_mvm(kern, p_, X_, alpha,
                                             block=cfg.block))
            s_tr = jnp.sum(W * kernel_mvm(kern, p_, X_, Z, block=cfg.block))
            return g_ld * s_tr / cfg.trace_probes - g_quad * s_q

        pbar, Xbar = jax.grad(contracted, argnums=(0, 1))(p, X)
        return pbar, Xbar, 2.0 * g_quad * alpha

    evidence.defvjp(_forward, evidence_bwd)
    return evidence


@functools.lru_cache(maxsize=None)
def _iter_evidence_masked_fn(kern: Kern, cfg: IterConfig):
    """Masked twin of `_iter_evidence_fn` for operators of the form
        K̃ = mask·K·mask + (I − mask)      (mask = diag of 0/1)
    — the GP-LVM dynamics Gram with sequence-break rows knocked to identity
    (models/gplvm._dyn_gram, /root/reference/CGplvm.cpp:448-477) and the
    padded-row discipline of the distributed engines share this exact shape.
    Break rows have eigenvalue exactly 1: they add 0 to logdet and (with the
    RHS zeroed there, as Xout is) nothing to the quad, so the masked CG+SLQ
    estimator equals the dense knocked-out evidence.  Differentiable in
    (p, X, m); the mask rides along as a constant."""

    def _mvm(p, X, mask, V):
        Vm = V * mask[:, None]
        out = kernel_mvm(kern, p, X, Vm, block=cfg.block)
        return out * mask[:, None] + (1.0 - mask[:, None]) * V

    def _forward(p, X, m, mask):
        N, D = m.shape
        key = jax.random.PRNGKey(cfg.seed)
        k_tr, k_slq = jax.random.split(jax.random.fold_in(key, N))
        Z = jax.random.rademacher(k_tr, (N, cfg.trace_probes), dtype=X.dtype)
        mvm = lambda V: _mvm(p, X, mask, V)
        B = jnp.concatenate([m, Z], axis=1)
        if cfg.precond_rank > 0:
            # masked pivoted-Cholesky/Woodbury preconditioner: break rows
            # are excluded from the pivot pool and the solve acts as the
            # identity there, matching the masked operator
            Lk = pivoted_cholesky_masked(kern, p, X, mask, cfg.precond_rank)
            wsolve = woodbury_preconditioner(Lk, kern.white(p) + 1e-8)

            def pre(R):
                Rs = wsolve(R * mask[:, None]) * mask[:, None]
                return Rs + (1.0 - mask[:, None]) * R

            sols = pcg_solve(mvm, B, pre, max_iters=cfg.cg_iters).x
        else:
            sols = cg_solve(mvm, B, max_iters=cfg.cg_iters).x
        alpha, W = sols[:, :D], sols[:, D:]
        quad = jnp.sum(m * alpha)
        logdet = slq_logdet(mvm, N, k_slq, probes=cfg.probes,
                            lanczos_iters=cfg.lanczos_iters, dtype=X.dtype)
        return (logdet, quad), (p, X, mask, alpha, W, Z)

    @jax.custom_vjp
    def evidence(p, X, m, mask):
        (logdet, quad), _ = _forward(p, X, m, mask)
        return logdet, quad

    def evidence_bwd(res, cots):
        p, X, mask, alpha, W, Z = res
        g_ld, g_quad = cots
        alpha = lax.stop_gradient(alpha)
        W = lax.stop_gradient(W)
        am = alpha * mask[:, None]
        Wm = W * mask[:, None]
        Zm = Z * mask[:, None]

        def contracted(p_, X_):
            # the identity part is (p, X)-independent — contract only the
            # mask·K·mask piece
            s_q = jnp.sum(am * kernel_mvm(kern, p_, X_, am, block=cfg.block))
            s_tr = jnp.sum(Wm * kernel_mvm(kern, p_, X_, Zm,
                                           block=cfg.block))
            return g_ld * s_tr / cfg.trace_probes - g_quad * s_q

        pbar, Xbar = jax.grad(contracted, argnums=(0, 1))(p, X)
        return pbar, Xbar, 2.0 * g_quad * alpha, None

    evidence.defvjp(_forward, evidence_bwd)
    return evidence


def kern_evidence_iterative_masked(kern: Kern, p, X, m, mask,
                                   cfg: IterConfig | None = None):
    """(logdet, quad) of mask·(kern(X))·mask + (I − mask) — matrix-free.
    The GPC_TPU_EVIDENCE=iterative route for the GP-LVM DYNAMICS term
    (models/gplvm.py), so iterative mode never materializes the N×N dynK
    and GPDM is not capped at dense memory."""
    if cfg is None:
        cfg = iter_config()
    X = jnp.asarray(X)
    return _iter_evidence_masked_fn(kern, cfg)(p, X, jnp.asarray(m),
                                               jnp.asarray(mask))


def kern_evidence_iterative(kern: Kern, p, X, m, cfg: IterConfig | None = None):
    """(logdet, quad) for K = kern(X) — matrix-free, differentiable, O(N·block)
    memory.  The `GPC_TPU_EVIDENCE=iterative` engine for models/gp.py (FTC)
    and models/gplvm.py; no shape-split requirement (kernel_mvm pads row
    blocks internally).  logdet is an SLQ estimate — training-grade, not
    MATCHTOL parity (tests/test_iterative.py pins the small-N tolerance vs
    the dense engine)."""
    if cfg is None:
        cfg = iter_config()
    X = jnp.asarray(X)
    return _iter_evidence_fn(kern, cfg)(p, X, jnp.asarray(m))


def make_iterative_nlml(kern: Kern, X, m, key, *, block: int = 2048,
                        probes: int = 16, lanczos_iters: int = 32,
                        cg_iters: int = 256, precond_rank: int = 0,
                        trace_probes: int = 16):
    """Matrix-free TRAINABLE FTC NLML — BBMM-style (GPyTorch) custom VJP.

    Returns nlml(p) = ½(Σⱼ mⱼᵀK⁻¹mⱼ + D·log|K| + N·D·log 2π) over the fixed
    (X, m), differentiable without materializing K or unrolling the solver —
    a thin wrapper assembling the NLML from the shared `_iter_evidence_fn`
    custom-VJP core (one CG for quad + Hutchinson probes, SLQ logdet,
    blockwise-rematerialized backward contractions).  Probe vectors are
    FIXED by `key` (mapped to the core's config seed), so nlml is
    deterministic given the key and the gradient is the estimator's exact
    gradient.  The reference has no answer at this scale — its FTC is
    O(N³)/O(N²) memory (CGp.cpp:877-909); this trains beyond dense device memory."""
    from gpc_tpu import ndlutil

    X = jnp.asarray(X)
    m = jnp.asarray(m)
    N, D = m.shape
    seed = int(jax.random.randint(key, (), 0, 2 ** 31 - 1))
    cfg = IterConfig(block=block, probes=probes, lanczos_iters=lanczos_iters,
                     cg_iters=cg_iters, precond_rank=precond_rank,
                     trace_probes=trace_probes, seed=seed)
    evidence = _iter_evidence_fn(kern, cfg)

    def nlml(p):
        logdet, quad = evidence(p, X, m)
        return 0.5 * (quad + D * logdet + N * D * ndlutil.LOGTWOPI)

    return nlml
