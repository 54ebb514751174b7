"""f32 certification of the special-function fast path (ndlutil.py).

The parity suite runs float64; on the float32 accelerator path probit/NCNM/ordered
evaluate these functions in float32, where erfcx switches to its 7-term
asymptotic tail at |x| > 5 (vs 25 in f64).  These tests pin the f32 accuracy
against the f64 implementation across the branch thresholds and deep tails.

Measured f32-vs-f64 error table (this suite asserts 2× headroom over it):

  function                     domain            max rel       notes
  erfcx, x ≥ 0                 [0, 30]           5.3e-7        asymptotic
                                                               switch at 5.0
  erfcx, x ∈ [-9, 0)           reflection        1.1e-5        2exp(x²)−erfcx(−x)
                                                               cancellation
  ln_cum_gaussian              [-30, 30]         1e-4 rel      +2e-7 abs where
                                                               lnΦ→0⁻ (x ≫ 0)
  grad_ln_cum_gaussian         [-30, 12]         2e-5          N(x) underflows
                                                               f32 past x≈13 (≈1e-38)
  gauss_over_diff (1 and 2)    u−u' ∈ {.5,2,6},  2.1e-5        ROBUSTADD floors
                               u ∈ [-8, 8]                     are f64-denormal
  probit NLML                  ±8σ tails         ≤1e-5         N=400 sum
  ncnm NLML                    incl. missing     ≤1e-5         N=400 sum

f32 erfcx branch: ndlutil.py:53-65; reference branch structure:
/root/reference/ndlutil.cpp:29-92, ndlfortran.f:1374-1713 (Cody).
"""

import numpy as np
import jax.numpy as jnp

from gpc_tpu import ndlutil as nd
from gpc_tpu import noise as NZ


def _f32_vs_f64(f, *args64):
    v64 = np.asarray(f(*[jnp.asarray(a, jnp.float64) for a in args64]))
    v32 = np.asarray(f(*[jnp.asarray(np.asarray(a, np.float32)) for a in args64]))
    return v32.astype(np.float64), v64


def _check(f, args64, rtol, atol=0.0, name=""):
    v32, v64 = _f32_vs_f64(f, *args64)
    err = np.abs(v32 - v64)
    bound = atol + rtol * np.abs(v64)
    bad = err > bound
    assert not bad.any(), (
        f"{name}: {bad.sum()} points exceed tol; worst err "
        f"{err[bad].max():.3e} at arg {np.asarray(args64[0])[bad][0]}")


def test_erfcx_f32_positive_tail():
    # dense around the f32 asymptotic switch (5.0) and into the deep tail
    x = np.concatenate([np.linspace(0, 4.5, 500), np.linspace(4.5, 6.5, 2000),
                        np.linspace(6.5, 30, 500)])
    _check(nd.erfcx, (x,), rtol=2e-6, name="erfcx pos")


def test_erfcx_f32_negative_reflection():
    # reflection branch 2exp(x²)−erfcx(−x): usable down to x²≈85 in f32
    x = np.linspace(-9, 0, 2000)
    _check(nd.erfcx, (x,), rtol=3e-5, name="erfcx neg")


def test_ln_cum_gaussian_f32():
    x = np.concatenate([np.linspace(-30, 30, 4001),
                        np.linspace(-6, -4, 1000)])
    # abs floor: for x ≫ 0, lnΦ → 0⁻ below f32 resolution (≈1e-7)
    _check(nd.ln_cum_gaussian, (x,), rtol=2e-4, atol=4e-7, name="lnCumGauss")


def test_grad_ln_cum_gaussian_f32():
    # past x≈13, N(x) ≈ 1e-38 underflows f32 — the gradient is zero to any
    # likelihood's precision there, so certify up to 12
    x = np.concatenate([np.linspace(-30, 12, 4001),
                        np.linspace(-6, -4, 1000)])
    _check(nd.grad_ln_cum_gaussian, (x,), rtol=4e-5, atol=1e-30,
           name="gradLnCumGauss")


def test_gauss_over_diff_f32():
    u = np.concatenate([np.linspace(-8, 8, 801)] * 3)
    up = u - np.repeat([0.5, 2.0, 6.0], 801)
    for order in (1, 2):
        _check(lambda a, b: nd.gauss_over_diff_cum_gaussian(a, b, order),
               (u, up), rtol=5e-5, atol=1e-30, name=f"gaussOverDiff{order}")


def _tail_moments(N=400, seed=0):
    rng = np.random.default_rng(seed)
    mu = np.concatenate([rng.standard_normal(N - 100),
                         np.linspace(-8, 8, 100)]).reshape(-1, 1)
    vs = np.abs(rng.standard_normal(mu.shape)) * 0.5 + 0.05
    y = np.sign(rng.standard_normal(mu.shape))
    y[y == 0] = 1.0
    return mu, vs, y


def test_probit_nlml_f32_drift():
    """probit log-likelihood f32-vs-f64 drift incl. ±8σ tails ≤ 1e-5 rel."""
    noise = NZ.ProbitNoise(output_dim=1)
    mu, vs, y = _tail_moments()
    p = np.array([0.1, 1e-6])
    ll64 = float(noise.log_likelihood(jnp.asarray(p), jnp.asarray(mu),
                                      jnp.asarray(vs), jnp.asarray(y)))
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))
    ll32 = float(noise.log_likelihood(f32(p), f32(mu), f32(vs), f32(y)))
    assert abs(ll32 - ll64) / abs(ll64) < 1e-5, (ll32, ll64)


def test_ncnm_nlml_f32_drift():
    """NCNM log-likelihood (labelled + missing mixture) f32 drift ≤ 1e-5."""
    noise = NZ.NcnmNoise(output_dim=1)
    mu, vs, y = _tail_moments(seed=1)
    y[::5] = 0.0  # missing labels → lnCumGaussSum mixture branch
    p = np.asarray(noise.default_params(y))
    ll64 = float(noise.log_likelihood(jnp.asarray(p, jnp.float64),
                                      jnp.asarray(mu), jnp.asarray(vs),
                                      jnp.asarray(y)))
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))
    ll32 = float(noise.log_likelihood(f32(p), f32(mu), f32(vs), f32(y)))
    assert abs(ll32 - ll64) / abs(ll64) < 1e-5, (ll32, ll64)
