"""Special functions with the log-domain stability tricks the likelihoods rely on.

JAX counterpart of the reference's `ndlutil.{h,cpp}` + Cody's CALERF Fortran
(reference: ndlutil.cpp:9-167, ndlfortran.f:1374-1713).  The probit / NCNM / ordered
noise models are numerically viable only because Φ, log Φ, N/Φ and log(Φ(u)−Φ(u'))
are evaluated through the *scaled* complementary error function erfcx in the tails;
this module reproduces those branch structures exactly (ndlutil.cpp:29-92) as
vectorized, differentiable jnp expressions.

Everything here is dtype-polymorphic: float64 for parity tests, float32/bfloat16 on
the float32 path (erfcx switches to an asymptotic tail earlier in float32).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax.scipy import special as jsp

# Constants mirroring reference ndlutil.h:33-41.
MATCHTOL = 1e-10
GRADCHANGE = 1e-6
DISPEPS = 1e-14
LOGTWOPI = math.log(2.0 * math.pi)
HALFLOGTWOPI = 0.5 * LOGTWOPI
HALFSQRTTWO = 0.5 * math.sqrt(2.0)
SQRTTWOPI = math.sqrt(2.0 * math.pi)
ROBUSTADD = 1e-300  # log-of-zero guard (ndlutil.cpp:9)


def _erfcx_asymptotic(x):
    """erfcx(x) ≈ 1/(x√π) Σ (-1)^n (2n-1)!!/(2x²)^n for large positive x."""
    ix2 = 0.5 / (x * x)
    # (2n-1)!! coefficients: 1, -1, 3, -15, 105, -945, 10395
    s = 1.0 + ix2 * (-1.0 + ix2 * (3.0 + ix2 * (-15.0 + ix2 * (105.0 + ix2 * (-945.0 + ix2 * 10395.0)))))
    return s / (x * math.sqrt(math.pi))


def erfcx(x):
    """Scaled complementary error function exp(x²)·erfc(x).

    Counterpart of DERFCX (reference ndlfortran.f:1374-1713, wrapped at
    ndlutil.cpp:29-44).  Branches:
      x <  0           : 2·exp(x²) − erfcx(−x)   (overflows for very negative x,
                                                  matching Cody's XMAX behaviour)
      0 ≤ x ≤ thresh   : exp(x²)·erfc(x) directly (safe: erfc representable)
      x > thresh       : 7-term asymptotic series (direct product would overflow
                         exp(x²) / underflow erfc(x))
    thresh is dtype-aware: erfc underflows near 5.9 in float32, 26.5 in float64.
    """
    x = jnp.asarray(x)
    dt = jnp.result_type(x, jnp.float32)
    thresh = 25.0 if dt == jnp.float64 else 5.0
    ax = jnp.abs(x)
    ax_small = jnp.minimum(ax, thresh)  # keep unused branch finite
    ax_big = jnp.maximum(ax, 1.0)
    direct = jnp.exp(ax_small * ax_small) * jsp.erfc(ax_small)
    tail = _erfcx_asymptotic(ax_big)
    pos = jnp.where(ax <= thresh, direct, tail)
    # Negative arguments: erfcx(x) = 2 exp(x²) − erfcx(−x).
    x2_clip = jnp.minimum(x * x, 700.0 if dt == jnp.float64 else 85.0)
    neg = 2.0 * jnp.exp(x2_clip) - pos
    return jnp.where(x >= 0, pos, neg)


def ngaussian(x):
    """Standard normal density N(x;0,1) (ndlutil.cpp:10-16)."""
    return jnp.exp(-0.5 * x * x) / SQRTTWOPI


def cum_gaussian(x):
    """Φ(x) via erf (ndlutil.cpp:17-24)."""
    return 0.5 * (1.0 + jsp.erf(x * HALFSQRTTWO))


def inv_cum_gaussian(x):
    """Φ⁻¹(x) (ndlutil.cpp:25-28)."""
    return -math.sqrt(2.0) * erfcinv(2.0 * x)


def grad_ln_cum_gaussian(x):
    """d/dx log Φ(x) = N(x)/Φ(x), erfcx-stabilized for x<0 (ndlutil.cpp:29-36)."""
    x = jnp.asarray(x)
    # Branch-arg selection via where (not min/max): maximum() splits the gradient
    # 0.5/0.5 at the x=0 tie, which would halve d/dx at exactly zero.
    xp = jnp.where(x > 0, x, 0.0)
    xn = jnp.where(x > 0, 0.0, x)
    pos = ngaussian(xp) / cum_gaussian(xp)
    neg = 1.0 / (SQRTTWOPI * 0.5 * erfcx(-HALFSQRTTWO * xn))
    return jnp.where(x > 0, pos, neg)


def ln_cum_gaussian(x):
    """log Φ(x), erfcx-stabilized in the left tail (ndlutil.cpp:37-44)."""
    x = jnp.asarray(x)
    xn = jnp.where(x < 0, x, 0.0)
    xp = jnp.where(x < 0, 0.0, x)
    neg = -0.5 * xn * xn + math.log(0.5) + jnp.log(erfcx(-HALFSQRTTWO * xn))
    pos = jnp.log(cum_gaussian(xp))
    return jnp.where(x < 0, neg, pos)


def ln_cum_gauss_sum(u1, u2, w1, w2):
    """log(w1·Φ(u1) + w2·Φ(u2)) — NCNM missing-label mixture (ndlutil.cpp:46-60)."""
    u1, u2 = jnp.asarray(u1), jnp.asarray(u2)
    w1, w2 = jnp.asarray(w1), jnp.asarray(w2)
    both_pos = (u1 > 0) & (u2 > 0)
    direct = jnp.log(w1 * cum_gaussian(u1) + w2 * cum_gaussian(u2) + ROBUSTADD)
    l1 = ln_cum_gaussian(u1)
    l2 = ln_cum_gaussian(u2)
    # branch u1 > u2: log w1 + lnΦ(u1) + log1p(w2/w1 · exp(lnΦ(u2) − lnΦ(u1)));
    # the exponent is ≤ 0 within the branch that uses it — clamp so the
    # unselected branch can't overflow and poison gradients through where
    b1 = jnp.log(w1) + l1 + jnp.log1p(w2 / w1 * jnp.exp(jnp.minimum(l2 - l1, 0.0)))
    b2 = jnp.log(w2) + l2 + jnp.log1p(w1 / w2 * jnp.exp(jnp.minimum(l1 - l2, 0.0)))
    return jnp.where(both_pos, direct, jnp.where(u1 > u2, b1, b2))


def gauss_over_diff_cum_gaussian(x, xp, order):
    """N(x_order)/(Φ(x)−Φ(xp)) with erfcx branches (ndlutil.cpp:69-93).

    order=1 puts N(x) in the numerator, order=2 puts N(xp); `order` is a Python
    int (static), matching the reference's switch.
    """
    x, xp = jnp.asarray(x), jnp.asarray(xp)
    # Evaluate each branch only on arguments that keep it benign: the unselected
    # branch otherwise cancels catastrophically (den → the 1e-300 floor), whose
    # NaN gradient would leak through jnp.where's 0·NaN cotangent product.
    neg_mask = x <= 0
    xn = jnp.where(neg_mask, x, -1.0)
    xpn = jnp.where(neg_mask, xp, -2.0)
    xq = jnp.where(neg_mask, 1.0, x)
    xpq = jnp.where(neg_mask, 0.0, xp)
    if order == 1:
        er_n = jnp.exp(0.5 * (xn * xn - xpn * xpn))
        neg = 2.0 / (SQRTTWOPI * (erfcx(-HALFSQRTTWO * xn) - er_n * erfcx(-HALFSQRTTWO * xpn) + ROBUSTADD))
        er_p = jnp.exp(0.5 * (xq * xq - xpq * xpq))
        pos = 2.0 / (SQRTTWOPI * (er_p * erfcx(HALFSQRTTWO * xpq) - erfcx(HALFSQRTTWO * xq) + ROBUSTADD))
    elif order == 2:
        er_n = jnp.exp(0.5 * (xpn * xpn - xn * xn))
        neg = 2.0 / (SQRTTWOPI * (er_n * erfcx(-HALFSQRTTWO * xn) - erfcx(-HALFSQRTTWO * xpn) + ROBUSTADD))
        er_p = jnp.exp(0.5 * (xpq * xpq - xq * xq))
        pos = 2.0 / (SQRTTWOPI * (erfcx(HALFSQRTTWO * xpq) - er_p * erfcx(HALFSQRTTWO * xq) + ROBUSTADD))
    else:
        raise ValueError("order must be 1 or 2")
    return jnp.where(neg_mask, neg, pos)


def ln_diff_cum_gaussian(u, uprime):
    """log(Φ(u) − Φ(u')) — ordered-noise ladder terms (ndlutil.cpp:62-68)."""
    arg = gauss_over_diff_cum_gaussian(u, uprime, 1) + ROBUSTADD
    return -jnp.log(arg) - 0.5 * u * u - HALFLOGTWOPI


def sigmoid(x):
    return jax.nn.sigmoid(x)


def inv_sigmoid(x):
    return jnp.log(x) - jnp.log1p(-x)


def erfcinv(x):
    """Inverse of erfc.  jax ships ndtri; erfcinv(x) = -Φ⁻¹(x/2)/√2."""
    return -jsp.ndtri(jnp.asarray(x) * 0.5) / math.sqrt(2.0)


def gamma(x):
    """Γ(x) for positive arguments (LGAMA wrapper parity, ndlutil.cpp:142-150)."""
    return jnp.exp(jsp.gammaln(x))


def gammaln(x):
    return jsp.gammaln(x)


def digamma(x):
    return jsp.digamma(x)


def xlogy(x, y):
    return jsp.xlogy(x, y)
