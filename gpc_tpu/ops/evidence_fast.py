"""Mixed-precision fused lazy-Gram Cholesky evidence.

The pipeline is the hot block of CGp::logLikelihood (CGp.cpp:920-937):
    K = kernel-Gram(X);  L = chol(K + noise·I);  logdet K + Σⱼ mⱼᵀK⁻¹mⱼ.
This module is the GEMM-heavy variant of ops/lazy_evidence.py: a
left-looking blocked factorization where

  * Gram tiles materialize lazily inside the recursion (no N² pass through
    device memory),
  * the O(N³) Schur-correction and panel-solve GEMMs can run with **bf16
    inputs and f32 accumulation** (`Policy.bf16`),
  * finished L21 panels are stored bf16 once under that policy, so later
    corrections read half the bytes,
  * every block's correction against ALL its ancestors is ONE stacked GEMM
    (panels concatenated along the contraction axis) instead of one GEMM per
    ancestor,
  * diagonal leaves can return their explicit inverse (`Policy.leafinv`), so
    triangular solves against leaves become plain GEMMs,
  * only (logdet, quad) survive: L is never assembled, so XLA elides every
    O(N²) concatenation.

Numerical domain: 1-pass bf16 updates carry ~4e-3 relative error into the
Schur complements.  That is safe when the factorization is well conditioned
relative to bf16 rounding (kernel matrices with a noise ridge well above
~1e-2·K_ii, or fast-decaying off-diagonals); it is NOT a parity path.  With
`bf16=False` the schedule is plain jnp and differentiable (the lazy engine
of models/gp.py and models/gplvm.py runs it that way).

Reference: the factorization replaces dpotrf_ + dtrsv (CMatrix.cpp:371-412,
CGp.cpp:920-937); the explicit leaf inverse mirrors the reference's own
dpotri explicit-inverse habit (CMatrix.cpp:421-442) at leaf scope only.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax
from jax.scipy.linalg import solve_triangular


class Policy(NamedTuple):
    """Precision/schedule knobs for the fused evidence sweep."""
    base: int = 256       # leaf block size
    bf16: bool = True     # bf16-input/f32-accum update & panel GEMMs
    # leaf inverse mode — with an explicit L_leaf⁻¹ every panel solve becomes
    # a GEMM (the MAGMA dtrtri trick; the reference's own dpotri habit,
    # CMatrix.cpp:421-442).  "xla": library chol + trsm-vs-identity.
    # False: library chol + triangular solves.  Both differentiable.
    leafinv: object = "xla"
    stack: bool = True    # one stacked corr GEMM per block vs one per ancestor
    # prestack: keep the ancestor corrections as ONE contiguous array per
    # subtree, concatenated ONCE at each recursion node instead of re-stacked
    # per block.  Per-block corrections then read plain leading-dim row
    # slices of that array (no per-block concat copies): the O(N³/base) bytes
    # of stacked-operand materialization drop to O(N²·log(N/base)) node-level
    # copies.  Implies `stack` semantics.
    prestack: bool = False
    # panelhalf (evidence_flat only): materialize the corrected panel R in
    # bf16 between the correction dot and the panel solve — half the bytes,
    # at ~10× the drift of plain bf16 updates (opt-in)
    panelhalf: bool = False


DEFAULT = Policy()


def _mmp(a, b, transpose_b=False, *, bf16):
    """GEMM; bf16 policy casts inputs (already-bf16 operands pass through)."""
    dims = (((1,), (1,)), ((), ())) if transpose_b else (((1,), (0,)), ((), ()))
    if bf16:
        return lax.dot_general(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
                               dims, preferred_element_type=jnp.float32)
    # precision follows jax_default_matmul_precision (gpc_tpu/__init__.py)
    return lax.dot_general(a, b, dims, preferred_element_type=a.dtype)


# A factor is a nested tree:  leaf -> ("leaf", L_f32, inv_or_None)
#                             node -> ("node", left, L21_panel, right)
# L21 panels are stored in the GEMM input dtype (bf16 under the bf16 policy)
# so every downstream read is single-width.


def _leaf(A, b, pol: Policy):
    """Factor one diagonal leaf; returns (tree, v = L⁻¹b, Σ log diag L)."""
    if pol.leafinv not in (False, "xla"):
        raise ValueError(f"Policy.leafinv={pol.leafinv!r} (want False or "
                         f"'xla')")
    if pol.leafinv == "xla":
        L = jnp.linalg.cholesky(A)
        M = solve_triangular(L, jnp.eye(A.shape[0], dtype=A.dtype),
                             lower=True)
    else:
        L = jnp.linalg.cholesky(A)
        return (("leaf", L, None), solve_triangular(L, b, lower=True),
                jnp.sum(jnp.log(jnp.diagonal(L))))
    v = jnp.matmul(M, b, preferred_element_type=A.dtype)
    return ("leaf", L, M), v, jnp.sum(jnp.log(jnp.diagonal(L)))


def _solve_rt(B, tree, pol: Policy):
    """X·Lᵀ = B against a factor tree; leaf solves are GEMMs when the leaf
    inverse is available."""
    kind = tree[0]
    if kind == "leaf":
        _, L, M = tree
        if M is not None:
            return _mmp(B, M, transpose_b=True, bf16=pol.bf16)
        return solve_triangular(L, B.T, lower=True).T
    _, left, L21, right = tree
    h = L21.shape[1]
    X1 = _solve_rt(B[:, :h], left, pol)
    X2 = _solve_rt(B[:, h:] - _mmp(X1, L21, transpose_b=True, bf16=pol.bf16),
                   right, pol)
    return jnp.concatenate([X1, X2], axis=1)


def _corr(kfn, i0, j0, bi, bj, corr, pol: Policy):
    """Raw K block minus the stacked ancestor corrections.

    `corr` entries are (panel, row_offset): the current submatrix's block
    (i0, j0) must subtract panel[row_offset+i0 : +bi] · panel[row_offset+j0 :
    +bj]ᵀ for every ancestor panel.  Under `stack` all ancestors concatenate
    along the contraction axis into ONE GEMM.
    """
    A = kfn(i0, j0, bi, bj)
    if not corr:
        return A
    if pol.stack and len(corr) > 1:
        P = jnp.concatenate(
            [p[off + i0:off + i0 + bi] for p, off in corr], axis=1)
        Q = jnp.concatenate(
            [p[off + j0:off + j0 + bj] for p, off in corr], axis=1)
        return A - _mmp(P, Q, transpose_b=True, bf16=pol.bf16)
    for p, off in corr:
        A = A - _mmp(p[off + i0:off + i0 + bi], p[off + j0:off + j0 + bj],
                     transpose_b=True, bf16=pol.bf16)
    return A


def _chol_left(kfn, n, b, corr, pol: Policy):
    """Left-looking fused factor + forward-solve + logdet accumulation.

    All offsets are trace-time constants (recursion unrolled; the emitted
    graph is a fixed schedule of GEMMs + leaf kernels).  Trace-time op count
    grows O((n/base)² log(n/base)) without `stack`, and
    O((n/base)²) with it.
    """
    if n <= pol.base:
        return _leaf(_corr(kfn, 0, 0, n, n, corr, pol), b, pol)
    h = n // 2
    treeL, v1, ld1 = _chol_left(kfn, h, b[:h], corr, pol)
    A21 = _corr(kfn, h, 0, n - h, h, corr, pol)
    L21 = _solve_rt(A21, treeL, pol)
    store = L21.astype(jnp.bfloat16) if pol.bf16 else L21
    kfn22 = lambda i0, j0, bi, bj: kfn(h + i0, h + j0, bi, bj)
    corr22 = tuple((p, off + h) for p, off in corr) + ((store, 0),)
    treeR, v2, ld2 = _chol_left(
        kfn22, n - h, b[h:] - _mmp(L21, v1, bf16=pol.bf16), corr22, pol)
    return ("node", treeL, store, treeR), jnp.concatenate([v1, v2]), ld1 + ld2


def _corr_pre(kfn, i0, j0, bi, bj, C, off, pol: Policy):
    """Raw K block minus the corrections read from ONE prestacked array.

    `C` holds every finished ancestor panel side by side (rows aligned so the
    current submatrix's row i is C[off + i]); the correction is a single GEMM
    whose operands are plain leading-dim row slices — no per-block concat."""
    A = kfn(i0, j0, bi, bj)
    if C is None:
        return A
    P = lax.slice_in_dim(C, off + i0, off + i0 + bi)
    Q = lax.slice_in_dim(C, off + j0, off + j0 + bj)
    return A - _mmp(P, Q, transpose_b=True, bf16=pol.bf16)


def _chol_left_pre(kfn, n, b, C, off, pol: Policy):
    """`_chol_left` with the prestacked-corr schedule (Policy.prestack).

    Identical math and leaf handling; the only difference is WHERE operand
    stacking happens: once per node (the right subtree's corr array is the
    parent's rows hstacked with the fresh L21 panel) instead of once per
    block.  Trace-time op count O((n/base)²)."""
    if n <= pol.base:
        return _leaf(_corr_pre(kfn, 0, 0, n, n, C, off, pol), b, pol)
    h = n // 2
    treeL, v1, ld1 = _chol_left_pre(kfn, h, b[:h], C, off, pol)
    A21 = _corr_pre(kfn, h, 0, n - h, h, C, off, pol)
    L21 = _solve_rt(A21, treeL, pol)
    store = L21.astype(jnp.bfloat16) if pol.bf16 else L21
    kfn22 = lambda i0, j0, bi, bj: kfn(h + i0, h + j0, bi, bj)
    if C is None:
        C22, off22 = store, 0
    else:
        C22 = jnp.concatenate(
            [lax.slice_in_dim(C, off + h, off + n), store], axis=1)
        off22 = 0
    treeR, v2, ld2 = _chol_left_pre(
        kfn22, n - h, b[h:] - _mmp(L21, v1, bf16=pol.bf16), C22, off22, pol)
    return ("node", treeL, store, treeR), jnp.concatenate([v1, v2]), ld1 + ld2


def evidence_flat(kfn, n, m, pol: Policy = DEFAULT):
    """Left-looking fused evidence over ONE persistent (n, n) factor buffer —
    no stacked-operand copies at all.

    The `stack` schedule concatenates every block's ancestor panels before
    its correction GEMM: a read+write+re-read of ~N³/(3·base) panel bytes
    that triples the ancestor-stream memory traffic (the round-2 residual the
    mega-kernel failed to remove).  Here finished columns land in a single
    (n, n) buffer (bf16 under the policy) via static-index
    dynamic_update_slice — in place under XLA buffer reuse, since each
    iteration's buffer is dead after its update — and every correction
    reads PLAIN strided slices of it:

      per column j:  Vj   = Lbuf[jb:(j+1)b, :jb]          (this row's panel)
                     A    = K(j,j) + ridge − Vj·Vjᵀ;  leaf (L_jj, L_jj⁻¹)
                     v_j  = L_jj⁻¹·(m_j − Vj·v[:jb])
                     Vall = Lbuf[(j+1)b:, :jb]            (strided, no copy)
                     L21  = (K(below,j) − Vall·Vjᵀ)·L_jj⁻ᵀ   ← ONE tall GEMM
                     Lbuf[(j+1)b:, jb:(j+1)b] ← L21

    Ancestor bytes stream exactly once per use (N³/(3·base) total, halved
    again by bf16 storage), and the per-column correction is one big dot
    instead of a per-ancestor or per-block loop.  Differentiable."""
    b = pol.base
    nb = n // b
    assert n % b == 0 and nb >= 2
    store_dt = jnp.bfloat16 if pol.bf16 else m.dtype
    Lbuf = jnp.zeros((n, n), store_dt)
    vs = []
    logdet = jnp.zeros((), m.dtype)
    for j in range(nb):
        A = kfn(j * b, j * b, b, b)
        wj = m[j * b:(j + 1) * b]
        if j > 0:
            Vj = lax.slice(Lbuf, (j * b, 0), ((j + 1) * b, j * b))
            A = A - _mmp(Vj, Vj, transpose_b=True, bf16=pol.bf16)
            wj = wj - _mmp(Vj, jnp.concatenate(vs, axis=0), bf16=pol.bf16)
        tree, v_j, ld_j = _leaf(A, wj, pol)
        _, _Lx, M = tree
        vs.append(v_j)
        logdet = logdet + ld_j
        if j + 1 < nb:
            R = kfn((j + 1) * b, j * b, n - (j + 1) * b, b)
            if j > 0:
                Vall = lax.slice(Lbuf, ((j + 1) * b, 0), (n, j * b))
                R = R - _mmp(Vall, Vj, transpose_b=True, bf16=pol.bf16)
            if pol.bf16 and getattr(pol, "panelhalf", False):
                R = R.astype(jnp.bfloat16)
            if M is not None:
                L21 = _mmp(R, M, transpose_b=True, bf16=pol.bf16)
            else:
                L21 = solve_triangular(_Lx, R.astype(_Lx.dtype).T,
                                       lower=True).T
            Lbuf = lax.dynamic_update_slice(
                Lbuf, L21.astype(store_dt), ((j + 1) * b, j * b))
    v = jnp.concatenate(vs, axis=0)
    return 2.0 * logdet, jnp.sum(v * v)


def evidence_left_fast(kfn, n, m, pol: Policy = DEFAULT):
    """(logdet K, Σⱼ mⱼᵀK⁻¹mⱼ) for the lazily materialized SPD K of size n.

    `kfn(i0, j0, bi, bj)` returns the raw K block at static offsets (see
    lazy_evidence.rbf_block_fn / kern_block_fn).  L is never assembled.
    """
    logdet, v = evidence_left_v(kfn, n, m, pol)
    return logdet, jnp.sum(v * v)


def evidence_left_v(kfn, n, m, pol: Policy = DEFAULT):
    """(logdet K, v = L⁻¹m) — callers needing cross-Gram terms between RHS
    columns (e.g. the rank-1 bias Woodbury split in lazy_evidence) get the
    whole forward-solved block instead of the scalar quad."""
    if getattr(pol, "prestack", False):
        _tree, v, logdiag = _chol_left_pre(kfn, n, m, None, 0, pol)
    else:
        _tree, v, logdiag = _chol_left(kfn, n, m, (), pol)
    return 2.0 * logdiag, v
