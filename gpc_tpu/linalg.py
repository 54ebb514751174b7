"""Positive-definite linear algebra with jitter-escalation, kept on-device.

JAX counterpart of the reference's CMatrix LAPACK layer (CMatrix.cpp:371-503,
767-889).  Differences by design:

* the reference computes explicit inverses via dpotri (`pdinv`, CMatrix.cpp:421-442)
  and caches `invK`; here every invK use is replaced by triangular solves against the
  Cholesky factor (cho_solve), which is both faster and numerically tighter;
* `jitChol`'s retry loop (CMatrix.cpp:767-804: jitter = 1e-6·mean(diag), ×10 per
  failure, up to maxTries) becomes a `lax.while_loop` — a failed jitted Cholesky
  shows up as NaNs in the factor rather than a LAPACK `info` code, so the loop
  condition checks finiteness;
* everything is differentiable and jit-compatible.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.linalg import solve_triangular

# Fast path: skip the jitter-discovery factorization and always add the base
# jitter 1e-6·mean(|diag|) in a single Cholesky.  Halves the dominant O(N³)
# cost per NLML evaluation at the price of a ~1e-6-relative perturbation of the
# objective — appropriate for float32 speed runs, NOT for float64 parity
# tests (which is why the default is the reference-exact discovery loop).
FAST_JITCHOL = os.environ.get("GPC_TPU_FAST_JITCHOL", "0") == "1"


def _phi(X):
    """Lower-triangle projection with halved diagonal (cholesky jvp mask)."""
    return jnp.tril(X) / (1.0 + jnp.eye(X.shape[-1], dtype=X.dtype))


@jax.custom_vjp
def _chol_nansafe(A):
    """Cholesky whose BACKWARD is a no-op when the factor is non-finite.

    Needed by the single-pass jitchol: the first (jitter-free) attempt is the
    differentiable one, and when it fails its NaN factor would poison the
    rescue branch's gradient through the standard cholesky vjp (0·NaN leak,
    see CLAUDE.md).  Sanitizing INPUTS of the backward keeps the failed
    attempt's cotangent contribution exactly zero."""
    from gpc_tpu.ops.chol_blocked import cholesky as _chol
    return _chol(A)


def _chol_nansafe_fwd(A):
    L = _chol_nansafe(A)
    return L, L


def _chol_nansafe_bwd(L, Lbar):
    ok = jnp.all(jnp.isfinite(L))
    n = L.shape[-1]
    L_s = jnp.where(ok, L, jnp.eye(n, dtype=L.dtype))
    Lbar_s = jnp.where(ok, Lbar, jnp.zeros_like(Lbar))
    # Ā = sym(L⁻ᵀ·Φ(Lᵀ L̄)·L⁻¹)  — transpose of the cholesky jvp rule
    P = _phi(L_s.T @ Lbar_s)
    D = solve_triangular(L_s.T, P, lower=False)            # L⁻ᵀ P
    C = solve_triangular(L_s.T, D.T, lower=False).T        # (L⁻ᵀ P) L⁻¹
    Abar = 0.5 * (C + C.T)
    return (jnp.where(ok, Abar, jnp.zeros_like(Abar)),)


_chol_nansafe.defvjp(_chol_nansafe_fwd, _chol_nansafe_bwd)


def jitchol(A, max_tries: int = 10):
    """Lower-Cholesky factor of A, escalating diagonal jitter on failure.

    Returns (L, jitter_used).  Mirrors CMatrix::jitChol (CMatrix.cpp:853-889):
    first attempt with no jitter; on failure add 1e-6·mean(|diag|), then ×10 per
    retry.  After max_tries the (NaN) factor is returned — callers surface NaN in
    the objective, which the SCG/CG optimizers treat as a failed step, mirroring
    the reference's exception-driven pull-back (COptimisable.cpp:481-523).

    Single-pass: the common case (PD at zero jitter) pays exactly ONE
    factorization — the differentiable attempt itself is the PD probe, and the
    jitter-discovery while_loop only runs inside the `lax.cond` rescue branch
    taken on failure.
    """
    A = jnp.asarray(A)
    n = A.shape[-1]
    eye = jnp.eye(n, dtype=A.dtype)

    if FAST_JITCHOL:
        from gpc_tpu.ops.chol_blocked import cholesky as _chol
        jitter = 1e-6 * jnp.abs(jnp.trace(A)) / n
        return _chol(A + jitter * eye), jitter

    L0 = _chol_nansafe(A)
    ok0 = jnp.all(jnp.isfinite(L0))
    zero = jnp.zeros((), A.dtype)

    def fine(A):
        return L0, zero

    def rescue(A):
        # Jitter discovery on a stop-gradient copy (while_loop is not
        # reverse-mode differentiable); the factor is then recomputed once
        # differentiably at the discovered jitter.
        Asg = lax.stop_gradient(A)
        jitter0 = 1e-6 * jnp.abs(jnp.trace(Asg)) / n

        def ok_at(jit_amount):
            L = jnp.linalg.cholesky(Asg + jit_amount * eye)
            return jnp.all(jnp.isfinite(L))

        def cond(state):
            tries, _jit, ok = state
            return jnp.logical_and(~ok, tries < max_tries)

        def body(state):
            tries, jit_amount, _ok = state
            return tries + 1, jit_amount * 10.0, ok_at(jit_amount)

        _, jit_amount, _ = lax.while_loop(
            cond, body, (jnp.array(1), jitter0 * 10.0, ok_at(jitter0)))
        used = jit_amount / 10.0  # the loop pre-multiplies for the next attempt
        return _chol_nansafe(A + used * eye), used

    return lax.cond(ok0, fine, rescue, A)


def evidence_terms(A, m):
    """(logdet A, Σⱼ mⱼᵀA⁻¹mⱼ, L) — the FTC evidence hot block.

    Fast path (GPC_TPU_FAST_JITCHOL): fixed base jitter + ONE fused blocked
    factor+solve sweep (ops/chol_blocked.evidence_fused) — no separate
    latency-bound triangular_solve dispatch.  Exact path: reference jitchol
    escalation, then solve."""
    if FAST_JITCHOL:
        from gpc_tpu.ops.chol_blocked import evidence_fused
        n = A.shape[-1]
        jitter = 1e-6 * jnp.abs(jnp.trace(A)) / n
        return evidence_fused(A + jitter * jnp.eye(n, dtype=A.dtype), m)
    L, _ = jitchol(A)
    return chol_logdet(L), quad_form(L, m), L


def chol_logdet(L):
    """log|A| from its Cholesky factor (CMatrix::logDet, CMatrix.cpp:404-412)."""
    return 2.0 * jnp.sum(jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)))


def chol_solve(L, B):
    """Solve A x = B given lower Cholesky L of A."""
    y = solve_triangular(L, B, lower=True)
    return solve_triangular(L.T, y, lower=False)


def tri_solve(L, B, lower: bool = True, trans: bool = False):
    return solve_triangular(L, B, lower=lower, trans=1 if trans else 0)


def blocked_tri_inv(L, block: int = 2048):
    """Dense L⁻¹ (L lower triangular) by recursive block inversion:
      inv([[A, 0], [B, C]]) = [[A⁻¹, 0], [−C⁻¹·B·A⁻¹, C⁻¹]]
    — everything above the leaf size is GEMMs.  Serving can use this once
    at factor time so every per-batch variance solve becomes a pure GEMM
    (serving.py, GPServer(explicit_inverse=True)).  Mirrors the
    reference's own explicit-inverse habit (dpotri, CMatrix.cpp:421-442) at
    serving scope only — training/evidence paths never build inverses."""
    n = L.shape[0]
    if n <= block:
        return solve_triangular(L, jnp.eye(n, dtype=L.dtype), lower=True)
    h = n // 2
    I1 = blocked_tri_inv(L[:h, :h], block)
    I2 = blocked_tri_inv(L[h:, h:], block)
    B = -I2 @ (L[h:, :h] @ I1)
    top = jnp.concatenate([I1, jnp.zeros((h, n - h), L.dtype)], axis=1)
    return jnp.concatenate([top, jnp.concatenate([B, I2], axis=1)], axis=0)


def pdinv(A):
    """Explicit PD inverse (parity helper; prefer chol_solve in model code)."""
    L, _ = jitchol(A)
    inv = chol_solve(L, jnp.eye(A.shape[-1], dtype=A.dtype))
    return 0.5 * (inv + inv.T)


def quad_form(L, m):
    """mᵀ A⁻¹ m summed over columns of m, given lower Cholesky L of A."""
    v = solve_triangular(L, m, lower=True)
    return jnp.sum(v * v)


def dist2(X1, X2):
    """Pairwise squared Euclidean distances as one matmul.

    Counterpart of CMatrix::dist2Row inner loops (CMatrix.h:553-638): computed as
    ‖x‖² + ‖x'‖² − 2·X1X2ᵀ so the O(N²D) work is one matmul, clamped at 0.
    """
    n1 = jnp.sum(X1 * X1, axis=-1, keepdims=True)
    n2 = jnp.sum(X2 * X2, axis=-1, keepdims=True)
    cross = X1 @ X2.T
    return jnp.maximum(n1 + n2.T - 2.0 * cross, 0.0)
