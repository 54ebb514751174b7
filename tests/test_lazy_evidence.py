"""Lazy-Gram fused evidence ≡ dense Gram + Cholesky (ops/lazy_evidence.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gpc_tpu.ops.lazy_evidence import (
    evidence_fused_lazy, rbf_block_fn, rbf_evidence_lazy)


def _dense_reference(X, m, iw, var, noise):
    n2 = np.sum(X * X, axis=1)
    d2 = np.maximum(n2[:, None] + n2[None, :] - 2.0 * X @ X.T, 0.0)
    K = var * np.exp(-0.5 * iw * d2) + noise * np.eye(X.shape[0])
    L = np.linalg.cholesky(K)
    v = np.linalg.solve(L, m)
    return 2.0 * np.sum(np.log(np.diag(L))), float(np.sum(v * v)), K


def test_rbf_lazy_matches_dense():
    rng = np.random.default_rng(0)
    n, q, d = 1024, 5, 3
    X = rng.standard_normal((n, q))
    m = rng.standard_normal((n, d))
    iw, var, noise = 0.3, 1.7, 1e-2
    want_ld, want_quad, _ = _dense_reference(X, m, iw, var, noise)
    ld, quad = rbf_evidence_lazy(jnp.asarray(X), jnp.asarray(m),
                                 iw, var, noise, force=True)
    assert abs(float(ld) - want_ld) < 1e-8 * abs(want_ld)
    assert abs(float(quad) - want_quad) < 1e-8 * abs(want_quad)


def test_lazy_factor_matches_dense_chol():
    rng = np.random.default_rng(1)
    n, q = 768, 4  # non-power-of-two multiple of BASE: odd split shapes
    X = rng.standard_normal((n, q))
    m = rng.standard_normal((n, 1))
    iw, var, noise = 1.0, 1.0, 1e-1
    want_ld, want_quad, K = _dense_reference(X, m, iw, var, noise)
    kfn = rbf_block_fn(jnp.asarray(X), iw, var, noise)
    ld, quad, L = evidence_fused_lazy(kfn, n, jnp.asarray(m))
    assert abs(float(ld) - want_ld) < 1e-8 * abs(want_ld)
    assert abs(float(quad) - want_quad) < 1e-8 * abs(want_quad)
    Lnp = np.asarray(L)
    assert np.allclose(Lnp @ Lnp.T, K, atol=1e-9)
    assert np.allclose(np.triu(Lnp, 1), 0.0)


def test_lazy_diagonal_blocks_only_get_ridge():
    # every diagonal element must receive the noise ridge exactly once
    rng = np.random.default_rng(2)
    n = 768
    X = rng.standard_normal((n, 2))
    kfn = rbf_block_fn(jnp.asarray(X), 1.0, 1.0, 0.5)
    blk = kfn(256, 256, 256, 256)
    assert np.allclose(np.diag(np.asarray(blk)), 1.0 + 0.5)
    off = kfn(512, 256, 256, 256)
    assert float(jnp.max(jnp.abs(jnp.diagonal(off)))) < 1.0  # no ridge added


def test_left_looking_matches_dense():
    # fully lazy variant: trailing corrections composed into the block thunk
    from gpc_tpu.ops.lazy_evidence import evidence_fused_left

    rng = np.random.default_rng(3)
    n, q, d = 768, 4, 2  # non-power-of-two multiple of BASE
    X = rng.standard_normal((n, q))
    m = rng.standard_normal((n, d))
    iw, var, noise = 0.5, 1.2, 5e-2
    want_ld, want_quad, K = _dense_reference(X, m, iw, var, noise)
    kfn = rbf_block_fn(jnp.asarray(X), iw, var, noise)
    ld, quad, L = evidence_fused_left(kfn, n, jnp.asarray(m))
    assert abs(float(ld) - want_ld) < 1e-8 * abs(want_ld)
    assert abs(float(quad) - want_quad) < 1e-8 * abs(want_quad)
    Lnp = np.asarray(L)
    assert np.allclose(Lnp @ Lnp.T, K, atol=1e-9)
    assert np.allclose(np.triu(Lnp, 1), 0.0)


def test_kern_block_fn_general_kernel():
    # compound kernel (rbf+matern52+bias+white): lazy evidence ≡ dense compute
    from gpc_tpu import kernels as K
    from gpc_tpu.ops.lazy_evidence import kern_evidence_lazy

    rng = np.random.default_rng(4)
    n, q, d = 768, 3, 2
    X = jnp.asarray(rng.standard_normal((n, q)))
    m = jnp.asarray(rng.standard_normal((n, d)))
    kern = K.Cmpnd(input_dim=q, components=(
        K.Rbf(input_dim=q), K.Matern52(input_dim=q), K.Bias(input_dim=q),
        K.White(input_dim=q)))
    p = jnp.asarray(kern.default_params())
    Kd = np.asarray(kern.compute(p, X, X)) + float(kern.white(p)) * np.eye(n)
    L = np.linalg.cholesky(Kd)
    want_ld = 2.0 * np.sum(np.log(np.diag(L)))
    want_quad = float(np.sum(np.linalg.solve(L, np.asarray(m)) ** 2))
    ld, quad = kern_evidence_lazy(kern, p, X, m, force=True)
    assert abs(float(ld) - want_ld) < 1e-8 * abs(want_ld)
    assert abs(float(quad) - want_quad) < 1e-8 * abs(want_quad)


def test_kern_diag_invariant_all_kernels():
    """kern_block_fn's invariant: diag(p, X) == diagonal of compute(p, X, X)
    + white(p) for every leaf kernel class — the lazy evidence adds white on
    diagonal blocks only and relies on compute() for the rest."""
    from gpc_tpu import kernels as K

    rng = np.random.default_rng(7)
    q = 3
    X = jnp.asarray(rng.standard_normal((16, q)))
    leaves = [K.White(input_dim=q), K.WhiteFixed(input_dim=q),
              K.Bias(input_dim=q), K.Rbf(input_dim=q), K.Exp(input_dim=q),
              K.RatQuad(input_dim=q), K.Matern32(input_dim=q),
              K.Matern52(input_dim=q), K.Lin(input_dim=q), K.Mlp(input_dim=q),
              K.Poly(input_dim=q), K.Linard(input_dim=q),
              K.Rbfard(input_dim=q), K.Mlpard(input_dim=q),
              K.Polyard(input_dim=q)]
    for leaf in leaves:
        kern = K.Cmpnd(input_dim=q, components=(leaf,))
        p = jnp.asarray(kern.default_params())
        got = np.diag(np.asarray(kern.compute(p, X, X))) + float(kern.white(p))
        want = np.asarray(kern.diag(p, X))
        # Exp (OU) is first-order in r at r=0: the dist2 roundoff (~1e-16)
        # becomes ~1e-8 through the sqrt, so its compute() diagonal deviates
        # from diag() by ~sqrt(eps) — documented slack; all smooth kernels
        # (second-order at r=0) hold the invariant to full precision.
        rtol = 1e-7 if isinstance(leaf, K.Exp) else 1e-10
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-12,
                                   err_msg=type(leaf).__name__)


def test_kern_evidence_lazy_differentiable():
    """jax.grad through the lazy fused evidence (the large-N GP-LVM training
    path) matches the dense-gram gradient — including d/dX."""
    from gpc_tpu import kernels as K
    from gpc_tpu.ops.lazy_evidence import kern_evidence_lazy
    from gpc_tpu import linalg

    rng = np.random.default_rng(8)
    n, q, d = 768, 2, 2
    X0 = jnp.asarray(rng.standard_normal((n, q)))
    m = jnp.asarray(rng.standard_normal((n, d)))
    kern = K.Cmpnd(input_dim=q, components=(
        K.Rbf(input_dim=q), K.Bias(input_dim=q), K.White(input_dim=q)))
    p0 = jnp.asarray(kern.default_params())

    def lazy_obj(p, X):
        ld, quad = kern_evidence_lazy(kern, p, X, m, force=True)
        return quad + d * ld

    def dense_obj(p, X):
        Kd = kern.gram(p, X)
        L, _ = linalg.jitchol(Kd)
        return linalg.quad_form(L, m) + d * linalg.chol_logdet(L)

    gl_p, gl_X = jax.grad(lazy_obj, argnums=(0, 1))(p0, X0)
    gd_p, gd_X = jax.grad(dense_obj, argnums=(0, 1))(p0, X0)
    np.testing.assert_allclose(np.asarray(gl_p), np.asarray(gd_p), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(gl_X), np.asarray(gd_X),
                               rtol=1e-6, atol=1e-10)


def test_evidence_fast_leafinv_modes():
    """All leaf modes of the mixed-precision engine (ops/evidence_fast)
    agree with the dense evidence — incl. the 'xla' explicit-leaf-inverse
    mode."""
    from gpc_tpu.ops.evidence_fast import evidence_left_fast, Policy

    n, q, d = 1024, 4, 2
    rng = np.random.default_rng(11)
    X = jnp.asarray(rng.standard_normal((n, q)), jnp.float32)
    m = jnp.asarray(rng.standard_normal((n, d)), jnp.float32)
    iw = jnp.float32(1.0); var = jnp.float32(1.0); nz = jnp.float32(0.1)
    kfn = rbf_block_fn(X, iw, var, nz)
    K = kfn(0, 0, n, n)
    L = np.linalg.cholesky(np.asarray(K, np.float64))
    want_ld = 2 * np.sum(np.log(np.diag(L)))
    want_q = float(np.sum(np.linalg.solve(L, np.asarray(m, np.float64)) ** 2))
    for mode in (False, "xla"):
        for base in (256, 512):
            for pre in (False, True):
                ld, quad = evidence_left_fast(
                    kfn, n, m, Policy(base=base, bf16=False, leafinv=mode,
                                      stack=True, prestack=pre))
                assert abs(float(ld) - want_ld) < 2e-4 * abs(want_ld), (
                    mode, base, pre)
                assert abs(float(quad) - want_q) < 2e-4 * abs(want_q), (
                    mode, base, pre)
    # bf16 policy: logdet tight; quad amplified by κ(K)≈11 over the ~4e-3
    # bf16 input rounding
    ld, quad = evidence_left_fast(kfn, n, m, Policy(256, True, "xla", True))
    assert abs(float(ld) - want_ld) < 2e-3 * abs(want_ld)
    assert abs(float(quad) - want_q) < 5e-2 * abs(want_q)


def test_fused_lazy_odd_sizes():
    """The right-looking recursion must split odd n as (h, n-h) — the
    trailing thunk/recursion previously used h for both halves and shape-
    errored on any n that turns odd while halving above BASE."""
    rng = np.random.default_rng(3)
    for n in (601, 257):
        X = rng.standard_normal((n, 2))
        K = np.exp(-0.5 * ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)) \
            + 0.1 * np.eye(n)
        m = rng.standard_normal((n, 1))
        kfn = lambda i, j, r, c: jnp.asarray(K[i:i + r, j:j + c])
        ld, qd, _ = evidence_fused_lazy(kfn, n, jnp.asarray(m))
        assert abs(float(ld) - np.linalg.slogdet(K)[1]) < 1e-8
        want = (m.T @ np.linalg.solve(K, m)).item()
        assert abs(float(qd) - want) < 1e-8


def _plain_gram(kinds, kp, X):
    """The covariance from its formulas (rbf, rbfard, bias, white), direct
    differences — independent of kernels.py and the lazy block thunks."""
    q = X.shape[1]
    d = X[:, None, :] - X[None, :, :]
    K = jnp.zeros((X.shape[0],) * 2, X.dtype)
    i = 0
    for kind in kinds:
        if kind == "rbf":
            K = K + kp[i + 1] * jnp.exp(-0.5 * kp[i] * jnp.sum(d * d, -1))
            i += 2
        elif kind == "rbfard":
            s = kp[i + 2:i + 2 + q]
            K = K + kp[i + 1] * jnp.exp(-0.5 * kp[i] * jnp.sum(d * d * s, -1))
            i += 2 + q
        elif kind == "bias":
            K = K + kp[i]
            i += 1
        elif kind == "white":
            K = K + kp[i] * jnp.eye(X.shape[0], dtype=X.dtype)
            i += 1
    return K


@pytest.mark.parametrize("case", ["bias_split", "ard", "no_bias", "ragged"])
def test_lazy_engine_matches_plain_reference(case, monkeypatch):
    """The lazy engine (GPC_TPU_EVIDENCE=lazy through models/gp.py) against
    a plain float64 reference — Gram from the formulas, cholesky,
    triangular solve — in value and in gradient w.r.t. the kernel
    parameters and the inputs: the bias split (Sherman-Morrison), an ARD
    kernel, no bias component, and a ragged N that does not split into
    blocks (visible fallback to dense)."""
    from jax.scipy.linalg import solve_triangular
    from gpc_tpu import kernels as K
    from gpc_tpu.ops.lazy_evidence import kern_evidence_lazy

    n = {"ragged": 700, "no_bias": 1024}.get(case, 768)
    q, D = 3, 2
    rng = np.random.default_rng(21)
    X = jnp.asarray(rng.standard_normal((n, q)))
    m = jnp.asarray(rng.standard_normal((n, D)))
    leaves = {"ard": ("rbfard", "bias", "white"),
              "no_bias": ("rbf", "white")}.get(case, ("rbf", "bias", "white"))
    make = {"rbf": K.Rbf, "rbfard": K.Rbfard, "bias": K.Bias, "white": K.White}
    kern = K.Cmpnd(input_dim=q, components=tuple(
        make[k](input_dim=q) for k in leaves))
    kp = jnp.asarray(kern.default_params())
    if case == "ard":
        kp = kp.at[2:2 + q].set(jnp.asarray([0.5, 1.0, 2.0]))

    def lazy(p, X):
        ld, quad = kern_evidence_lazy(kern, p, X, m, force=True)
        return quad + D * ld

    def plain(p, X):
        L = jnp.linalg.cholesky(_plain_gram(leaves, p, X))
        a = solve_triangular(L, m, lower=True)
        return jnp.sum(a * a) + 2 * D * jnp.sum(jnp.log(jnp.diagonal(L)))

    monkeypatch.setenv("GPC_TPU_EVIDENCE", "lazy")
    if case == "ragged":
        from gpc_tpu.ops.evidence_mode import select_evidence_mode
        with pytest.warns(UserWarning, match="falling back to dense"):
            assert select_evidence_mode(n) == "dense"
    v, (gp, gX) = jax.value_and_grad(lazy, argnums=(0, 1))(kp, X)
    w, (hp, hX) = jax.value_and_grad(plain, argnums=(0, 1))(kp, X)
    np.testing.assert_allclose(float(v), float(w), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(gp), np.asarray(hp), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(np.asarray(gX), np.asarray(hX), rtol=1e-6,
                               atol=1e-9)
