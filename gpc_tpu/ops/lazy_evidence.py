"""Lazy-Gram fused Cholesky evidence: K tiles materialize inside the recursion.

The bench pipeline (and CGp::logLikelihood's hot block, CGp.cpp:920-937) is
    K = kernel-Gram(X);  L = chol(K + noise·I);  logdet + ‖L⁻¹m‖².
Materializing K first costs a full N² write + read of device memory (1 GB at
N=16k f32) before the factorization even starts.  But the
blocked right-looking recursion (ops/chol_blocked.py) reads every *raw* K
element exactly once — diagonal blocks when their sub-factorization starts,
off-diagonal panels when their triangular solve runs.  So instead of a dense
K we pass a *block thunk* `kfn(i0, j0, bi, bj) -> K-block` and let each block
materialize at its point of first use; XLA fuses the distance map + covariance
elementwise chain straight into the consuming GEMM/solve, and the separate
Gram pass (with its device-memory round trip) disappears from the schedule.

The log-determinant is accumulated from leaf diagonals during the recursion,
so when the caller needs only (logdet, quad) the full assembled L is dead code
and XLA elides its O(N²) final concatenation too.

The engines here are plain jnp and differentiable; models/gp.py and
models/gplvm.py run `kern_evidence_lazy` when GPC_TPU_EVIDENCE=lazy selects
the lazy engine (ops/evidence_mode.py).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax
from jax.scipy.linalg import solve_triangular

from gpc_tpu.ops.chol_blocked import BASE, _base_chol, _mm, _tri_solve_rt


def _chol_solve_lazy(kfn, i0, n, b, A):
    """Fused chol + forward-solve over a lazily materialized SPD matrix.

    kfn(i0, j0, bi, bj) returns the raw K block at static offsets; `A` is the
    concrete trailing matrix once updates have touched it (None while raw).
    Returns (L, v = L⁻¹b, Σ log diag L).
    """
    if n <= BASE:
        Ablk = kfn(i0, i0, n, n) if A is None else A
        L = _base_chol(Ablk)
        return L, solve_triangular(L, b, lower=True), jnp.sum(
            jnp.log(jnp.diagonal(L)))
    h = n // 2
    if A is None:
        A11 = A22 = None
        # trailing block is n-h rows (== h only when n is even)
        A21 = kfn(i0 + h, i0, n - h, h)
    else:
        A11, A21, A22 = A[:h, :h], A[h:, :h], A[h:, h:]
    L11, v1, ld1 = _chol_solve_lazy(kfn, i0, h, b[:h], A11)
    L21 = _tri_solve_rt(A21, L11)
    A22c = (kfn(i0 + h, i0 + h, n - h, n - h) if A22 is None else A22)
    L22, v2, ld2 = _chol_solve_lazy(
        kfn, i0 + h, n - h, b[h:] - _mm(L21, v1),
        A22c - _mm(L21, L21, transpose_b=True))
    top = jnp.concatenate([L11, jnp.zeros((h, n - h), L11.dtype)], axis=1)
    bot = jnp.concatenate([L21, L22], axis=1)
    return (jnp.concatenate([top, bot], axis=0),
            jnp.concatenate([v1, v2], axis=0), ld1 + ld2)


def evidence_fused_lazy(kfn, n, m):
    """(logdet K, Σⱼ mⱼᵀK⁻¹mⱼ) without ever materializing K (or L, if the
    caller drops it) as one dense array."""
    L, v, logdiag = _chol_solve_lazy(kfn, 0, n, m, None)
    return 2.0 * logdiag, jnp.sum(v * v), L


def rbf_block_fn(X, inv_width, variance, noise):
    """Block thunk for the RBF Gram + noise·I.

    Diagonal elements only ever appear in blocks with i0 == j0 (the recursion
    splits diagonally), so the noise ridge is added there alone.
    """
    n2 = jnp.sum(X * X, axis=1)

    def kfn(i0, j0, bi, bj):
        Xi = lax.slice(X, (i0, 0), (i0 + bi, X.shape[1]))
        Xj = lax.slice(X, (j0, 0), (j0 + bj, X.shape[1]))
        d2 = jnp.maximum(
            n2[i0:i0 + bi, None] + n2[None, j0:j0 + bj]
            - 2.0 * _mm(Xi, Xj, transpose_b=True), 0.0)
        K = variance * jnp.exp(-0.5 * inv_width * d2)
        if i0 == j0:
            K = K + noise * jnp.eye(bi, dtype=K.dtype)
        return K

    return kfn


def _chol_solve_left(kfn, n, b, corr=()):
    """Fully lazy (left-looking) variant of `_chol_solve_lazy`: trailing Schur
    corrections are COMPOSED into the block thunk instead of materializing the
    updated trailing matrix, so only lower-triangle blocks of the working
    matrix ever exist — half the raw-Gram element work, at the cost of
    splitting each big trailing syrk into per-descendant panel GEMMs (same
    total FLOPs, smaller shapes).  `corr` is a tuple of ancestor L21 panels;
    block (i0, j0) of the current submatrix equals
        kfn(i0, j0) − Σ_P P[i0:, :]·P[j0:, :]ᵀ.
    All offsets are trace-time constants (recursion unrolled)."""

    def block(i0, j0, bi, bj):
        A = kfn(i0, j0, bi, bj)
        for P in corr:
            A = A - _mm(P[i0:i0 + bi], P[j0:j0 + bj], transpose_b=True)
        return A

    if n <= BASE:
        L = _base_chol(block(0, 0, n, n))
        return L, solve_triangular(L, b, lower=True), jnp.sum(
            jnp.log(jnp.diagonal(L)))
    h = n // 2
    L11, v1, ld1 = _chol_solve_left(kfn, h, b[:h], corr)
    L21 = _tri_solve_rt(block(h, 0, n - h, h), L11)
    kfn22 = lambda i0, j0, bi, bj: kfn(h + i0, h + j0, bi, bj)
    corr22 = tuple(P[h:] for P in corr) + (L21,)
    L22, v2, ld2 = _chol_solve_left(kfn22, n - h, b[h:] - _mm(L21, v1), corr22)
    top = jnp.concatenate([L11, jnp.zeros((h, n - h), L11.dtype)], axis=1)
    bot = jnp.concatenate([L21, L22], axis=1)
    return (jnp.concatenate([top, bot], axis=0),
            jnp.concatenate([v1, v2], axis=0), ld1 + ld2)


def evidence_fused_left(kfn, n, m):
    """As `evidence_fused_lazy` but via the fully lazy left-looking recursion
    (no trailing-matrix materialization at all)."""
    L, v, logdiag = _chol_solve_left(kfn, n, m)
    return 2.0 * logdiag, jnp.sum(v * v), L


def kern_block_fn(kern, p, X, ridge=0.0):
    """Block thunk for ANY kernel-DSL covariance (kernels.py): K-blocks come
    from the kernel's vectorized tile compute (white-free off the diagonal,
    CKern.cpp:695-728 discipline), with the white variance + an optional
    extra ridge added on diagonal blocks only.  Lets `evidence_fused_lazy` /
    `evidence_fused_left` serve the whole kernel zoo, not just RBF.

    Invariant relied on here (and verified per kernel class in
    tests/test_lazy_evidence.py): `kern.diag(p, X)` must equal the diagonal
    of `kern.compute(p, X, X)` plus `kern.white(p)` — i.e. the dense path's
    gram() diagonal overwrite is exactly the white shift.  A kernel whose
    diag() deviates from its compute() diagonal (e.g. distance clamping on
    the diagonal) would make this lazy evidence silently diverge from the
    gram()-based evidence."""
    shift = kern.white(p) + ridge

    def kfn(i0, j0, bi, bj):
        Xi = lax.slice(X, (i0, 0), (i0 + bi, X.shape[1]))
        Xj = lax.slice(X, (j0, 0), (j0 + bj, X.shape[1]))
        K = kern.compute(p, Xi, Xj)
        if i0 == j0:
            K = K + shift * jnp.eye(bi, dtype=K.dtype)
        return K

    return kfn


def bias_split(kern):
    """(kern_without_bias, bias_param_offsets) when the rank-1 Woodbury
    split applies: `kern` is a top-level Cmpnd with ≥1 Bias children AND a
    white/whitefixed child keeping the remainder K₀ positive definite.

    The bias kernel contributes c·𝟙𝟙ᵀ — a rank-1 term whose O(N)
    eigenvalue is exactly what pushes mixed-precision factorizations out of
    their stability region (1-pass bf16 Schur corrections cancel
    catastrophically against it at N≳4k).  Splitting it off analytically
    (Sherman-Morrison/Woodbury) both fixes that and tightens conditioning
    at any precision.  Returns None when the split doesn't apply."""
    import dataclasses

    from gpc_tpu.kernels import Bias, Cmpnd
    if not isinstance(kern, Cmpnd):
        return None
    idxs = [i for i, c in enumerate(kern.components) if isinstance(c, Bias)]
    if not idxs:
        return None
    rest = tuple(c for c in kern.components if not isinstance(c, Bias))
    if not rest or not any(c.kind in ("white", "whitefixed") for c in rest):
        return None  # K₀ PD-ness not structurally guaranteed
    off = kern.offsets()
    slots = tuple(off[i] for i in idxs)  # each Bias holds exactly 1 param
    return dataclasses.replace(kern, components=rest), slots


def _evidence_bias_split(kern0, slots, p, X, m, ridge, pol):
    """Evidence for K = K₀ + c·𝟙𝟙ᵀ via ONE augmented-RHS factorization of
    K₀ and exact Sherman-Morrison corrections:
      logdet K = logdet K₀ + log(1 + c·s),       s  = 𝟙ᵀK₀⁻¹𝟙
      mⱼᵀK⁻¹mⱼ = mⱼᵀK₀⁻¹mⱼ − c·uⱼ²/(1 + c·s),  uⱼ = 𝟙ᵀK₀⁻¹mⱼ
    (one extra solve column; all cross terms from the same v = L₀⁻¹[m|𝟙])."""
    from gpc_tpu.ops.evidence_fast import evidence_left_v

    n = X.shape[0]
    keep = np.setdiff1d(np.arange(p.shape[0]), np.asarray(slots))
    p0 = p[jnp.asarray(keep)]
    c = sum(p[s] for s in slots)
    rhs = jnp.concatenate([m, jnp.ones((n, 1), m.dtype)], axis=1)
    kfn = kern_block_fn(kern0, p0, X, ridge)
    logdet0, v = evidence_left_v(kfn, n, rhs, pol)
    G = lax.dot_general(v, v, (((0,), (0,)), ((), ())),
                        preferred_element_type=v.dtype,
                        precision=lax.Precision.HIGHEST)
    s = G[-1, -1]
    u = G[:-1, -1]
    qm = jnp.diagonal(G)[:-1]
    denom = 1.0 + c * s
    return (logdet0 + jnp.log(denom),
            jnp.sum(qm) - c * jnp.sum(u * u) / denom)


def kern_evidence_lazy(kern, p, X, m, ridge=0.0, force=False):
    """(logdet, quad) for K = kern(X) + ridge·I with Gram tiles fused into
    the factorization — the general-kernel version of `rbf_evidence_lazy`.

    Differentiable (the stacked left-looking engine in ops/evidence_fast
    is pure jnp), so large-N GP-LVM NLMLs can jax.grad
    through it.  GPC_TPU_BF16_EVIDENCE=1 opts the O(N³) update GEMMs into
    bf16-input/f32-accum — with the rank-1 bias component split off
    analytically (see `bias_split`; GPC_TPU_BIAS_SPLIT=0 disables), the
    standard CLI kernel family cmpnd(·, bias, white) stays INSIDE the bf16
    stability region that the unsplit Gram leaves at N≳4k.  Speed runs
    only, never parity."""
    import os

    from gpc_tpu.ops.evidence_mode import evidence_base

    n = X.shape[0]
    base = evidence_base()  # ONE resolution point, shared with the models'
    if force and n > 2 * base and n % base == 0:
        from gpc_tpu.ops.evidence_fast import Policy, evidence_left_fast
        bf16 = os.environ.get("GPC_TPU_BF16_EVIDENCE", "0") == "1"
        # prestack: node-level corr arrays (O(N²·log) AD residuals) instead
        # of per-block stacked operands — the N≫16k headroom knob
        pre = os.environ.get("GPC_TPU_EVIDENCE_PRESTACK", "0") == "1"
        pol = Policy(base=base, bf16=bf16, leafinv=False, stack=True,
                     prestack=pre)
        if os.environ.get("GPC_TPU_BIAS_SPLIT", "1") == "1":
            sp = bias_split(kern)
            if sp is not None:
                return _evidence_bias_split(sp[0], sp[1], jnp.asarray(p), X,
                                            m, ridge, pol)
        kfn = kern_block_fn(kern, p, X, ridge)
        return evidence_left_fast(kfn, n, m, pol)
    from gpc_tpu.ops.chol_blocked import evidence_fused
    K = kern.compute(p, X, X) + (kern.white(p) + ridge) * jnp.eye(
        n, dtype=X.dtype)
    logdet, quad, _L = evidence_fused(K, m, force=force)
    return logdet, quad


def rbf_evidence_lazy(X, m, inv_width, variance, noise, force=False):
    """logdet + quad for K = rbf(X) + noise·I, Gram tiles fused into the
    factorization schedule when forced and the size splits cleanly into
    BASE leaves; otherwise the dense Gram and the library factorization."""
    n = X.shape[0]
    if force and n > 2 * BASE and n % BASE == 0:
        kfn = rbf_block_fn(X, inv_width, variance, noise)
        logdet, quad, _L = evidence_fused_left(kfn, n, m)
        return logdet, quad
    from gpc_tpu.ops.chol_blocked import evidence_fused
    d2 = jnp.maximum(
        jnp.sum(X * X, 1)[:, None] + jnp.sum(X * X, 1)[None, :]
        - 2.0 * (X @ X.T), 0.0)
    K = variance * jnp.exp(-0.5 * inv_width * d2) + noise * jnp.eye(
        n, dtype=X.dtype)
    logdet, quad, _L = evidence_fused(K, m, force=force)
    return logdet, quad
