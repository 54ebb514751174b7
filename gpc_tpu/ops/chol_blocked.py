"""Recursive blocked Cholesky and triangular solve — GEMM-shaped factorization.

The O(N³) Cholesky dominates every full-GP evidence evaluation (bench.py).
This module provides a divide-and-conquer factorization whose work lands
almost entirely in large static-shape GEMMs:

    chol([[A11, ·], [A21, A22]]):
        L11 = chol(A11)
        L21 = A21 · L11⁻ᵀ          (triangular solve, itself recursive)
        L22 = chol(A22 − L21·L21ᵀ) (syrk as a GEMM)

Recursion is unrolled at trace time (static shapes, log₂(N/base) levels), so
the compiled graph is a fixed schedule of matmuls + base-case factorizations.
`cholesky(A)` takes the recursive path only when forced; otherwise it defers
to jnp.linalg.cholesky, which beats it on the GPU (cuSOLVER, PERF.md) —
numerics are identical up to reassociation (same algorithm, different
blocking).  The lazy-Gram engines
(ops/lazy_evidence, ops/evidence_fast) build on these pieces.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
from jax import lax
from jax.scipy.linalg import solve_triangular

BASE = 256  # leaf block of the recursion (GPC_TPU_EVIDENCE_BASE overrides it
            # for the lazy engine, ops/evidence_mode.evidence_base)

# Mixed precision: run the O(N³) GEMM updates (syrk + panel-solve matmuls) with
# bf16 inputs and f32 accumulation, at a ~1e-3 relative perturbation of the
# factor.  For f32 speed experiments where the kernel's white noise dwarfs
# bf16 rounding; never for f64 parity.
BF16_UPDATES = os.environ.get("GPC_TPU_BF16_CHOL", "0") == "1"


def _mm(a, b, transpose_b=False):
    """GEMM with optional bf16-input/f32-accumulation fast path."""
    dims = (((1,), (1,)), ((), ())) if transpose_b else (((1,), (0,)), ((), ()))
    if BF16_UPDATES and a.dtype == jnp.float32:
        return lax.dot_general(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
                               dims, preferred_element_type=jnp.float32)
    # precision follows jax_default_matmul_precision (gpc_tpu/__init__.py)
    return lax.dot_general(a, b, dims, preferred_element_type=a.dtype)


def _tri_solve_rt(B, L):
    """Solve X·Lᵀ = B for X, L lower-triangular (the L21 panel update),
    recursively so big cases become GEMMs.

    Split L = [[L11, 0], [L21, L22]], B = [B1 | B2]:
        X1·L11ᵀ = B1;  X2·L22ᵀ = B2 − X1·L21ᵀ.
    """
    n = L.shape[0]
    if n <= BASE:
        return solve_triangular(L, B.T, lower=True).T
    h = n // 2
    L11, L21, L22 = L[:h, :h], L[h:, :h], L[h:, h:]
    X1 = _tri_solve_rt(B[:, :h], L11)
    X2 = _tri_solve_rt(B[:, h:] - _mm(X1, L21, transpose_b=True), L22)
    return jnp.concatenate([X1, X2], axis=1)


def _base_chol(A):
    """Base-case factorization: the library cholesky on a leaf block."""
    return jnp.linalg.cholesky(A)


def _chol_recursive(A):
    n = A.shape[0]
    if n <= BASE:
        return _base_chol(A)
    h = n // 2
    A11, A21, A22 = A[:h, :h], A[h:, :h], A[h:, h:]
    L11 = _chol_recursive(A11)
    L21 = _tri_solve_rt(A21, L11)
    L22 = _chol_recursive(A22 - _mm(L21, L21, transpose_b=True))
    top = jnp.concatenate([L11, jnp.zeros((h, n - h), A.dtype)], axis=1)
    bot = jnp.concatenate([L21, L22], axis=1)
    return jnp.concatenate([top, bot], axis=0)


def cholesky(A, force: bool = False):
    """Lower Cholesky: the recursive blocked schedule when forced, else the
    library factorization."""
    if A.ndim == 2 and force:
        return _chol_recursive(A)
    return jnp.linalg.cholesky(A)


def _chol_solve_recursive(A, b):
    """Fused factor+forward-solve: chol(A) and v = L⁻¹b in ONE recursion.

    The RHS updates (b2 − L21·v1) ride the same schedule as the trailing
    matrix updates, so the O(N²·D) forward substitution costs no extra
    serialized pass — at D≪N the separate XLA triangular_solve is pure
    latency (panel-sequential with tiny work per step), which this removes.
    """
    n = A.shape[0]
    if n <= BASE:
        L = _base_chol(A)
        return L, solve_triangular(L, b, lower=True)
    h = n // 2
    A11, A21, A22 = A[:h, :h], A[h:, :h], A[h:, h:]
    L11, v1 = _chol_solve_recursive(A11, b[:h])
    L21 = _tri_solve_rt(A21, L11)
    L22, v2 = _chol_solve_recursive(A22 - _mm(L21, L21, transpose_b=True),
                                    b[h:] - _mm(L21, v1))
    top = jnp.concatenate([L11, jnp.zeros((h, n - h), A.dtype)], axis=1)
    bot = jnp.concatenate([L21, L22], axis=1)
    return jnp.concatenate([top, bot], axis=0), jnp.concatenate([v1, v2], axis=0)


def evidence_fused(K, m, force: bool = False):
    """(logdet K, Σⱼ mⱼᵀK⁻¹mⱼ, L) in one fused blocked sweep — the hot block
    of CGp::logLikelihood (CGp.cpp:920-937) without a separate solve pass."""
    if force:
        L, v = _chol_solve_recursive(K, m)
    else:
        L = jnp.linalg.cholesky(K)
        v = solve_triangular(L, m, lower=True)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))
    quad = jnp.sum(v * v)
    return logdet, quad, L
