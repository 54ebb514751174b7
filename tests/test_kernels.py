"""Kernel parity tests (reference CKern.cpp formulas, testKern.cpp pattern).

Each kernel's vectorized tile computation is checked against a direct per-element
numpy transcription of the reference computeElement formula, plus gradient
consistency (jax.grad through transforms vs central finite differences — the
checkGradients pattern, COptimisable.cpp:9-44).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gpc_tpu import kernels as K
from gpc_tpu import transforms as tr

rng = np.random.default_rng(42)
X1 = rng.standard_normal((7, 3))
X2 = rng.standard_normal((5, 3))


def _naive(kern, p, X1, X2):
    """Per-element reference formulas (CKern.cpp computeElement bodies)."""
    p = np.asarray(p)
    n, m = X1.shape[0], X2.shape[0]
    out = np.zeros((n, m))
    for i in range(n):
        for j in range(m):
            x, y = X1[i], X2[j]
            d2 = float(((x - y) ** 2).sum())
            if kern == "rbf":
                out[i, j] = p[1] * np.exp(-0.5 * p[0] * d2)
            elif kern == "exp":
                out[i, j] = p[1] * np.exp(-p[0] * np.sqrt(d2))
            elif kern == "ratquad":
                out[i, j] = p[2] * (1 + d2 * 0.5 / (p[1] ** 2 * p[0])) ** (-p[0])
            elif kern == "matern32":
                u = np.sqrt(d2 * 3 / p[0] ** 2)
                out[i, j] = p[1] * (1 + u) * np.exp(-u)
            elif kern == "matern52":
                n2 = d2 * 5 / p[0] ** 2
                u = np.sqrt(n2)
                out[i, j] = p[1] * (1 + u + n2 / 3) * np.exp(-u)
            elif kern == "lin":
                out[i, j] = p[0] * x @ y
            elif kern == "mlp":
                num = p[0] * x @ y + p[1]
                d1 = p[0] * x @ x + p[1] + 1
                dd2 = p[0] * y @ y + p[1] + 1
                out[i, j] = p[2] * np.arcsin(num / np.sqrt(d1 * dd2))
            elif kern == "poly":
                out[i, j] = p[2] * (p[0] * x @ y + p[1]) ** 2.0
            elif kern == "linard":
                s = p[1:]
                out[i, j] = p[0] * (x * s) @ y
            elif kern == "rbfard":
                s = p[2:]
                out[i, j] = p[1] * np.exp(-0.5 * p[0] * ((x - y) ** 2 * s).sum())
            elif kern == "mlpard":
                s = p[3:]
                num = p[0] * (x * s) @ y + p[1]
                d1 = p[0] * (x * x * s).sum() + p[1] + 1
                dd2 = p[0] * (y * y * s).sum() + p[1] + 1
                out[i, j] = p[2] * np.arcsin(num / np.sqrt(d1 * dd2))
            elif kern == "polyard":
                s = p[3:]
                out[i, j] = p[2] * (p[0] * (x * s) @ y + p[1]) ** 2.0
            else:
                raise ValueError(kern)
    return out


ALL_LEAVES = ["rbf", "exp", "ratquad", "matern32", "matern52", "lin", "mlp",
              "poly", "linard", "rbfard", "mlpard", "polyard"]


@pytest.mark.parametrize("kind", ALL_LEAVES)
def test_cross_compute_matches_reference_formula(kind):
    kern = K.make_kern(kind, 3)
    p = kern.default_params() * (0.5 + rng.random(kern.n_params))
    got = np.asarray(kern.compute(jnp.asarray(p), jnp.asarray(X1), jnp.asarray(X2)))
    want = _naive(kind, p, X1, X2)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("kind", ALL_LEAVES + ["white", "bias"])
def test_gram_diag_uses_diag_compute(kind):
    kern = K.make_kern(kind, 3)
    p = jnp.asarray(kern.default_params())
    G = np.asarray(kern.gram(p, jnp.asarray(X1)))
    d = np.asarray(kern.diag(p, jnp.asarray(X1)))
    np.testing.assert_allclose(np.diag(G), d, rtol=1e-12)
    np.testing.assert_allclose(G, G.T, rtol=1e-12)


def test_white_kernel_semantics():
    w = K.White(input_dim=3)
    p = jnp.asarray([0.7])
    # cross compute is identically zero, even for identical inputs (CKern.cpp:718-728)
    C = np.asarray(w.compute(p, jnp.asarray(X1), jnp.asarray(X1)))
    assert np.all(C == 0)
    G = np.asarray(w.gram(p, jnp.asarray(X1)))
    np.testing.assert_allclose(G, 0.7 * np.eye(7), rtol=1e-12)
    assert float(w.white(p)) == pytest.approx(0.7)


def test_whitefixed_has_no_params():
    wf = K.WhiteFixed(input_dim=2, fixed_variance=0.3)
    assert wf.n_params == 0
    G = np.asarray(wf.gram(jnp.zeros((0,)), jnp.asarray(X1[:, :2])))
    np.testing.assert_allclose(G, 0.3 * np.eye(7), rtol=1e-12)


def test_cmpnd_sum_and_param_layout():
    kern = K.Cmpnd(input_dim=3, components=(K.Rbf(input_dim=3), K.Bias(input_dim=3), K.White(input_dim=3)))
    assert kern.n_params == 4
    assert kern.param_names() == ["inverseWidth", "variance", "variance", "variance"]
    p = jnp.asarray([2.0, 1.5, 0.2, 0.05])
    G = np.asarray(kern.gram(p, jnp.asarray(X1)))
    want = _naive("rbf", [2.0, 1.5], X1, X1) + 0.2 + 0.05 * np.eye(7)
    np.testing.assert_allclose(G, want, rtol=1e-9, atol=1e-12)
    # cross: white contributes nothing
    Cx = np.asarray(kern.compute(p, jnp.asarray(X1), jnp.asarray(X2)))
    wantx = _naive("rbf", [2.0, 1.5], X1, X2) + 0.2
    np.testing.assert_allclose(Cx, wantx, rtol=1e-9, atol=1e-12)
    assert float(kern.white(p)) == pytest.approx(0.05)


def test_tensor_product_and_white_rejection():
    kern = K.Tensor(input_dim=3, components=(K.Rbf(input_dim=3), K.Lin(input_dim=3)))
    p = jnp.asarray([1.0, 2.0, 0.5])
    C = np.asarray(kern.compute(p, jnp.asarray(X1), jnp.asarray(X2)))
    want = _naive("rbf", [1.0, 2.0], X1, X2) * _naive("lin", [0.5], X1, X2)
    np.testing.assert_allclose(C, want, rtol=1e-9, atol=1e-12)
    with pytest.raises(ValueError):
        K.Tensor(input_dim=3, components=(K.Rbf(input_dim=3), K.White(input_dim=3)))


def test_ard_transform_codes():
    kern = K.Rbfard(input_dim=3)
    codes = kern.transform_codes()
    assert list(codes) == [tr.EXP, tr.EXP, tr.SIGMOID, tr.SIGMOID, tr.SIGMOID]
    np.testing.assert_allclose(kern.default_params(), [1, 1, 0.5, 0.5, 0.5])


@pytest.mark.parametrize("kind", ["rbf", "ratquad", "matern52", "mlp", "rbfard"])
def test_grad_through_transforms_vs_fd(kind):
    """d(Σ covGrad∘K)/da consistency: jax.grad vs central differences at 1e-6
    (the reference checkGradients pattern, COptimisable.cpp:9-44)."""
    kern = K.make_kern(kind, 3)
    codes = kern.transform_codes()
    x0 = kern.default_params() * (0.5 + rng.random(kern.n_params))
    a0 = np.asarray(tr.apply_xtoa(codes, jnp.asarray(x0)))
    covGrad = rng.standard_normal((7, 7))
    covGrad = covGrad + covGrad.T

    def obj(a):
        p = tr.apply_atox(codes, a)
        return jnp.sum(kern.gram(p, jnp.asarray(X1)) * jnp.asarray(covGrad))

    g = np.asarray(jax.grad(obj)(jnp.asarray(a0)))
    eps = 1e-6
    fd = np.zeros_like(a0)
    for i in range(len(a0)):
        ap = a0.copy(); ap[i] += eps
        am = a0.copy(); am[i] -= eps
        fd[i] = (float(obj(jnp.asarray(ap))) - float(obj(jnp.asarray(am)))) / (2 * eps)
    np.testing.assert_allclose(g, fd, rtol=1e-5, atol=1e-7)


def test_set_variance_rescales_children():
    kern = K.Cmpnd(input_dim=3, components=(K.Rbf(input_dim=3), K.Bias(input_dim=3)))
    p = jnp.asarray([1.0, 2.0, 2.0])
    assert float(kern.get_variance(p)) == pytest.approx(4.0)
    p2 = kern.set_variance(p, 8.0)
    np.testing.assert_allclose(np.asarray(p2), [1.0, 4.0, 4.0], rtol=1e-12)


def test_priors_reindexed_in_compound():
    from gpc_tpu import priors as pr
    rbf = K.Rbf(input_dim=3).with_priors([pr.gamma(1.0, 1.0, index=1)])
    kern = K.Cmpnd(input_dim=3, components=(K.Bias(input_dim=3), rbf))
    g = kern.priors_global
    assert len(g) == 1 and g[0].index == 2  # bias has 1 param before rbf's


def test_f32_gradients_finite_at_coincident_points():
    """The distance-kernel sqrt guard must survive f32: 1e-300 underflows
    to 0 there, and sqrt(0)'s infinite derivative NaN'd the whole gradient
    whenever X contained duplicate rows (the float32 training dtype)."""
    import jax

    X = jnp.asarray(np.array([[0.5, -1.0], [0.5, -1.0], [1.5, 2.0]]),
                    jnp.float32)

    for kern in (K.Exp(input_dim=2), K.Matern32(input_dim=2),
                 K.Matern52(input_dim=2)):
        p = jnp.asarray(kern.default_params(), jnp.float32)

        def scalar(p_):
            return jnp.sum(kern.compute(p_, X, X))

        g = jax.grad(scalar)(p)
        assert np.isfinite(np.asarray(g)).all(), (kern.kind, np.asarray(g))


def test_mlp_gradient_finite_at_rounded_arcsin_edge():
    """Mlp arg = numer/sqrt(d1·d2) rounds to exactly 1.0 in f32 once
    w·‖x‖² exceeds the mantissa; arcsin'(1) = ∞ must not reach the
    pullback (clamp to 1−epsneg)."""
    import jax

    X = jnp.asarray(np.full((2, 2), 1.5e4), jnp.float32)
    kern = K.Mlp(input_dim=2)
    p = jnp.asarray(kern.default_params(), jnp.float32)

    def scalar(p_):
        return jnp.sum(kern.compute(p_, X, X))

    v = scalar(p)
    g = jax.grad(scalar)(p)
    assert np.isfinite(float(v))
    assert np.isfinite(np.asarray(g)).all(), np.asarray(g)


def test_mlp_diag_gradient_finite_at_rounded_arcsin_edge():
    """Same edge through diag(): numer/(numer+1) rounds to exactly 1.0 in
    f32 once numer exceeds the mantissa, and Kern.gram overwrites the Gram
    diagonal with diag() (FITC/DTCVAR consume it directly), so an
    unclamped diag NaNs every mlp-kernel objective gradient even though
    compute() is protected."""
    X = jnp.asarray(np.full((3, 2), 1.5e4), jnp.float32)
    for kern in (K.Mlp(input_dim=2), K.Mlpard(input_dim=2)):
        p = jnp.asarray(kern.default_params(), jnp.float32)

        def scalar(p_, k=kern):
            return jnp.sum(k.diag(p_, X)) + jnp.sum(k.gram(p_, X))

        v = scalar(p)
        g = jax.grad(scalar)(p)
        assert np.isfinite(float(v)), kern.kind
        assert np.isfinite(np.asarray(g)).all(), (kern.kind, np.asarray(g))


def test_set_variance_tensor_and_whitefixed():
    """Tensor.set_variance follows the reference's per-child rescale rule
    (CKern.h:534-542, incl. its k>1 factor quirk); Cmpnd.set_variance
    lands the total exactly on `val` while leaving structural whitefixed
    children untouched."""
    tk = K.Tensor(input_dim=2, components=(K.Rbf(input_dim=2),
                                           K.Lin(input_dim=2)))
    p = jnp.asarray(tk.default_params(), jnp.float64)
    cur = float(tk.get_variance(p))
    p2 = tk.set_variance(p, 2.0 * cur)
    # reference rule: every child scaled by factor=2 -> product scales 4x
    np.testing.assert_allclose(float(tk.get_variance(p2)), 4.0 * cur,
                               rtol=1e-12)

    ck = K.Cmpnd(input_dim=2, components=(
        K.Rbf(input_dim=2), K.Bias(input_dim=2),
        K.WhiteFixed(input_dim=2, fixed_variance=0.25)))
    pc = jnp.asarray(ck.default_params(), jnp.float64)
    pc2 = ck.set_variance(pc, 3.0)
    np.testing.assert_allclose(float(ck.get_variance(pc2)), 3.0, rtol=1e-12)
    with pytest.raises(ValueError):
        K.WhiteFixed(input_dim=2).set_variance(jnp.zeros((0,)), 1.0)
