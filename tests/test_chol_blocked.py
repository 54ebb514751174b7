"""Recursive blocked Cholesky correctness vs jnp.linalg."""

import numpy as np
import jax.numpy as jnp
import pytest

from gpc_tpu.ops import chol_blocked


def _spd(n, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    return (A @ A.T + n * np.eye(n)).astype(np.float64)


@pytest.mark.parametrize("n", [64, 1024, 1536])
def test_matches_reference_cholesky(n):
    A = _spd(n)
    L = np.asarray(chol_blocked.cholesky(jnp.asarray(A), force=True))
    want = np.linalg.cholesky(A)
    np.testing.assert_allclose(L, want, rtol=1e-9, atol=1e-9)
    # strictly lower structure
    assert np.allclose(np.triu(L, 1), 0.0)


def test_tri_solve_rt():
    n = 1024
    A = _spd(n, 1)
    L = np.linalg.cholesky(A)
    rng = np.random.default_rng(2)
    B = rng.standard_normal((300, n))
    X = np.asarray(chol_blocked._tri_solve_rt(jnp.asarray(B), jnp.asarray(L)))
    np.testing.assert_allclose(X @ L.T, B, rtol=1e-8, atol=1e-8)


def test_small_defers_to_xla():
    A = _spd(100, 3)
    L = np.asarray(chol_blocked.cholesky(jnp.asarray(A)))
    np.testing.assert_allclose(L, np.linalg.cholesky(A), rtol=1e-10)


def test_recursive_path_is_differentiable():
    # gradient conventions differ (XLA's cholesky VJP symmetrizes; the recursive
    # composite leaves sensitivity in the lower triangle) but must agree through
    # any symmetric construction A = BBᵀ + nI — which is how every model builds K
    import jax
    n = 1024
    rng = np.random.default_rng(5)
    B = jnp.asarray(rng.standard_normal((n, n)))

    def logdet_via(chol_fn):
        def f(B):
            A = B @ B.T + n * jnp.eye(n, dtype=B.dtype)
            L = chol_fn(A)
            return 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))
        return f

    g = np.asarray(jax.grad(logdet_via(
        lambda A: chol_blocked.cholesky(A, force=True)))(B))
    g_ref = np.asarray(jax.grad(logdet_via(jnp.linalg.cholesky))(B))
    np.testing.assert_allclose(g, g_ref, rtol=1e-7, atol=1e-9)


def test_evidence_fused_matches_plain():
    import jax.numpy as jnp
    from gpc_tpu.ops.chol_blocked import evidence_fused
    rng = np.random.default_rng(11)
    N, D = 512, 3
    B = rng.standard_normal((N, N))
    K = B @ B.T + N * np.eye(N)
    m = rng.standard_normal((N, D))
    logdet, quad, L = evidence_fused(jnp.asarray(K), jnp.asarray(m), force=True)
    sign, want_logdet = np.linalg.slogdet(K)
    want_quad = np.trace(m.T @ np.linalg.solve(K, m))
    np.testing.assert_allclose(float(logdet), want_logdet, rtol=1e-10)
    np.testing.assert_allclose(float(quad), want_quad, rtol=1e-9)
    np.testing.assert_allclose(np.asarray(L) @ np.asarray(L).T, K, rtol=1e-8,
                               atol=1e-8 * N)
