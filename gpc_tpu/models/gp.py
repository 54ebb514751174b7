"""Full and sparse Gaussian-process regression (FTC / DTC / DTCVAR / FITC).

JAX counterpart of the reference's `CGp.{h,cpp}`.  The reference maintains
mutable caches behind a 4-level dirty-flag protocol (CGp.h:281-326) and ~1,500
lines of hand-derived gradient algebra (gpCovGrads, CGp.cpp:1244-1413); here the
negative log marginal likelihood is ONE pure jitted function of the unconstrained
parameter vector and `jax.grad` supplies every hyperparameter / inducing-input /
beta gradient.  All dense algebra (Gram tiles, Cholesky, triangular solves)
stays on the device; there are no explicit matrix inverses.

Parameter-vector layout reproduces CGp::getOptParams (CGp.cpp:330-385):
  [X_u column-major (if sparse & !inducing_fixed)]
  [kernel transformed params]
  [output scales (if learn_scales; linear)]
  [log beta (if sparse; exp transform, CGp.cpp:46-51)]

Likelihood forms mirror CGp::logLikelihood (CGp.cpp:913-1014) exactly, including
the reference's definition A = (1/β)·K_uu + K_uf·D⁻¹·K_fu (updateAD,
CGp.cpp:757-875) and its FITC log-2π accounting.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from gpc_tpu import linalg, ndlutil
from gpc_tpu import transforms as tr
from gpc_tpu import priors as priors_mod
from gpc_tpu.kernels import Kern
from gpc_tpu.optim.scg import scg
from gpc_tpu.optim import run_optimiser

FTC, DTC, DTCVAR, FITC, PITC = "ftc", "dtc", "dtcvar", "fitc", "pitc"
_SPARSE = (DTC, DTCVAR, FITC, PITC)


@dataclasses.dataclass(frozen=True)
class GpSpec:
    """Static model description (hashable; jit-safe to close over)."""

    kern: Kern
    n_data: int
    input_dim: int
    output_dim: int
    approx: str = FTC
    num_active: int = 0
    learn_scales: bool = False      # isOutputScaleLearnt
    inducing_fixed: bool = False
    pitc_block: int = 0             # PITC block size; 0 → num_active

    @property
    def sparse(self) -> bool:
        return self.approx in _SPARSE

    @property
    def block_size(self) -> int:
        return self.pitc_block if self.pitc_block > 0 else max(self.num_active, 1)

    # --- parameter vector layout (CGp.cpp:330-385) -------------------------
    def n_params(self) -> int:
        n = self.kern.n_params
        if self.sparse and not self.inducing_fixed:
            n += self.num_active * self.input_dim
        if self.learn_scales:
            n += self.output_dim
        if self.sparse:
            n += 1
        return n

    def unpack(self, theta):
        """theta (unconstrained) → (X_u, kern_params_constrained, scales, beta)."""
        i = 0
        X_u = None
        if self.sparse and not self.inducing_fixed:
            m = self.num_active * self.input_dim
            # column-major: reference iterates j over dims outer, i over rows inner
            X_u = theta[i:i + m].reshape(self.input_dim, self.num_active).T
            i += m
        nk = self.kern.n_params
        kp = tr.apply_atox(self.kern.transform_codes(), theta[i:i + nk])
        i += nk
        scales = None
        if self.learn_scales:
            scales = theta[i:i + self.output_dim]
            i += self.output_dim
        beta = None
        if self.sparse:
            beta = tr.atox(tr.EXP, theta[i])
            i += 1
        return X_u, kp, scales, beta

    def pack(self, kern_params, X_u=None, scales=None, beta=None):
        """Constrained quantities → unconstrained theta (numpy)."""
        parts = []
        if self.sparse and not self.inducing_fixed:
            parts.append(np.asarray(X_u).T.ravel())  # column-major
        parts.append(np.asarray(tr.apply_xtoa(self.kern.transform_codes(),
                                              jnp.asarray(kern_params))))
        if self.learn_scales:
            parts.append(np.asarray(scales))
        if self.sparse:
            parts.append(np.array([math.log(float(beta))]))
        return np.concatenate(parts) if parts else np.zeros((0,))


def _scaled_targets(y, bias, scales):
    """m = (y − bias)/scale per output (CGp::updateM, CGp.cpp:248-260)."""
    return (y - bias[None, :]) / scales[None, :]


def _pitc_whitened(spec: GpSpec, kp, beta, X, m, K_uf, L_uu):
    """Shared PITC block assembly for evidence AND serving: the correction
    D = blockdiag(I + β·(K_bb − Q_bb)) applied via batched Cholesky solves,
    all block algebra batched over the leading P axis (vmapped Gram +
    batched triangular solves — uniform shapes, ragged tail
    handled by identity padding).  Returns (Am, e, Cb, sMb): the
    L_uu-whitened Am = I/β + W̃·W̃ᵀ, its whitened RHS e, the batched block
    factors Cb (their log-diagonals are the evidence's Σ_b logdet D_b), and
    sMb = C_b⁻¹m_b (the evidence's quadratic ingredient)."""
    M, N = K_uf.shape
    Bp = spec.block_size
    P = -(-N // Bp)
    pad = P * Bp - N
    q = spec.input_dim
    Xp = jnp.pad(jnp.asarray(X), ((0, pad), (0, 0)))
    Kbb = jax.vmap(lambda xb: spec.kern.gram(kp, xb))(
        Xp.reshape(P, Bp, q))                          # (P, Bp, Bp)
    Kuf_p = jnp.pad(K_uf, ((0, 0), (0, pad)))
    Vb = linalg.tri_solve(L_uu, Kuf_p).reshape(M, P, Bp)   # L_uu⁻¹K_uf
    Qbb = jnp.einsum("mpi,mpj->pij", Vb, Vb)
    Db = jnp.eye(Bp, dtype=Kbb.dtype)[None] + beta * (Kbb - Qbb)
    valid = (jnp.arange(P * Bp) < N).reshape(P, Bp)
    vmask = valid[:, :, None] & valid[:, None, :]
    Db = jnp.where(vmask, Db, jnp.eye(Bp, dtype=Db.dtype)[None])
    Cb = jnp.linalg.cholesky(Db)                       # batched (P,Bp,Bp)
    from jax.scipy.linalg import solve_triangular as _st
    m_p = jnp.pad(m, ((0, pad), (0, 0))).reshape(P, Bp, m.shape[1])
    sMb = _st(Cb, m_p, lower=True)                     # C_b⁻¹ m_b
    Wb = _st(Cb, jnp.transpose(Vb, (1, 2, 0)), lower=True)  # (P,Bp,M)
    Am = (jnp.eye(M, dtype=Wb.dtype) / beta
          + jnp.einsum("pbm,pbn->mn", Wb, Wb))
    e = jnp.einsum("pbm,pbd->md", Wb, sMb)
    return Am, e, Cb, sMb


def log_likelihood(spec: GpSpec, theta, X, y, bias, fixed_scales,
                   X_u_fixed=None):
    """logLikelihood(θ) (CGp.cpp:913-1014) — scalar, differentiable.

    X_u_fixed supplies the inducing inputs when spec.inducing_fixed (they are
    then data, not parameters — CGp honors fixInducing the same way)."""
    X_u, kp, scales, beta = spec.unpack(theta)
    if X_u is None and spec.sparse:
        X_u = jnp.asarray(X_u_fixed)
    scales = scales if spec.learn_scales else jnp.asarray(fixed_scales)
    m = _scaled_targets(jnp.asarray(y), jnp.asarray(bias), scales)
    N, D = spec.n_data, spec.output_dim

    if spec.approx == FTC:
        # GPC_TPU_EVIDENCE=lazy|iterative routes the FTC hot block through
        # the fused lazy factorization (autodiff through the blocked
        # schedule) or the matrix-free CG+SLQ engine (past dense memory);
        # unset, the dense engine runs (ops/evidence_mode.py).
        from gpc_tpu.ops.evidence_mode import select_evidence_mode
        mode = select_evidence_mode(N)
        if mode == "lazy":
            from gpc_tpu.ops.lazy_evidence import kern_evidence_lazy
            logdetK, quad = kern_evidence_lazy(spec.kern, kp, jnp.asarray(X),
                                               m, force=True)
        elif mode == "iterative":
            from gpc_tpu.ops.iterative import kern_evidence_iterative
            logdetK, quad = kern_evidence_iterative(spec.kern, kp,
                                                    jnp.asarray(X), m)
        else:
            K = spec.kern.gram(kp, X)
            logdetK, quad, _L = linalg.evidence_terms(K, m)
        Lacc = quad + D * logdetK  # Σ_j m_jᵀK⁻¹m_j + D·logdet
    else:
        M = spec.num_active
        K_uu = spec.kern.gram(kp, X_u)
        K_uf = spec.kern.compute(kp, X_u, X)
        L_uu, _ = linalg.jitchol(K_uu)
        logdet_uu = linalg.chol_logdet(L_uu)

        if spec.approx in (DTC, DTCVAR):
            # A = (1/β)·K_uu + K_uf·K_fu (updateAD, CGp.cpp:770-773),
            # factored through the L_uu-whitened form A = L_uu·Am·L_uuᵀ with
            # Am = I/β + V·Vᵀ, V = L_uu⁻¹K_uf (the same whitening the FITC
            # branch uses): −logdet_uu + logdetA = logdet Am and
            # eᵀA⁻¹e = ‖L_m⁻¹(V·m)‖².  Identical quantity, but cond(Am) ≪
            # cond(A) — the direct factorization hits cond(A) ≈ 1e9 at
            # β=1e3 and loses ~3 digits of gradient agreement vs the MATLAB
            # goldens (tests/test_golden_gp.py).
            V = linalg.tri_solve(L_uu, K_uf)       # (M, N)
            Am = jnp.eye(M, dtype=V.dtype) / beta + V @ V.T
            L_m, _ = linalg.jitchol(Am)
            e = V @ m                              # (M, D)
            quad = jnp.sum(jnp.square(linalg.tri_solve(L_m, e)))
            mm = jnp.sum(m * m)
            Lacc = D * ((M - N) * jnp.log(beta) + linalg.chol_logdet(L_m))
            Lacc = Lacc - beta * (quad - mm)
            if spec.approx == DTCVAR:
                diagK = spec.kern.diag(kp, X)
                diagQ = jnp.sum(V * V, axis=0)     # diag K_fu·K_uu⁻¹·K_uf
                diagD = beta * (diagK - diagQ)
                Lacc = Lacc + D * jnp.sum(diagD)
        elif spec.approx == PITC:
            # PITC — *stubbed in the reference* (CGp.cpp:862-871 throws): the
            # block-diagonal member of the Quiñonero-Candela/Rasmussen family.
            # Generalizes the FITC path; block assembly shared with serving
            # (_pitc_whitened).
            Am, e, Cb, sMb = _pitc_whitened(spec, kp, beta, X, m, K_uf, L_uu)
            L_m, _ = linalg.jitchol(Am)
            bet = linalg.tri_solve(L_m, e)
            # no reference quirk to match here (the C++ throws), so unlike the
            # FITC branch there is NO extra N·log2π — the global
            # −D·N·½log2π below is the correct (and only) constant.
            Lacc = (M - N) * jnp.log(beta)
            Lacc = Lacc + 2.0 * jnp.sum(jnp.log(
                jnp.diagonal(Cb, axis1=1, axis2=2)))       # Σ_b logdet D_b
            Lacc = Lacc + 2.0 * jnp.sum(jnp.log(jnp.diagonal(L_m)))
            Lacc = Lacc * D
            Lacc = Lacc + beta * (jnp.sum(sMb * sMb) - jnp.sum(bet * bet))
        else:  # FITC (CGp.cpp:806-858, 962-988)
            diagK = spec.kern.diag(kp, X)
            # one M×N triangular solve serves both diagQ and V: diagQ =
            # diag(K_ufᵀK_uu⁻¹K_uf) = column norms of W = L_uu⁻¹K_uf
            # (the previous chol_solve+tri_solve pair redid this solve
            # three times per objective evaluation)
            W = linalg.tri_solve(L_uu, K_uf)
            diagQ = jnp.sum(W * W, axis=0)
            diagD = 1.0 + beta * (diagK - diagQ)
            Dinv = 1.0 / diagD
            scaledM = m * jnp.sqrt(Dinv)[:, None]
            V = W * jnp.sqrt(Dinv)[None, :]
            Am = jnp.eye(M, dtype=V.dtype) / beta + V @ V.T
            L_m, _ = linalg.jitchol(Am)
            invLmV = linalg.tri_solve(L_m, V)
            bet = invLmV @ scaledM
            Lacc = (M - N) * jnp.log(beta) + N * ndlutil.LOGTWOPI
            Lacc = Lacc + jnp.sum(jnp.log(diagD))
            Lacc = Lacc + 2.0 * jnp.sum(jnp.log(jnp.diagonal(L_m)))
            Lacc = Lacc * D
            Lacc = Lacc + beta * (jnp.sum(scaledM * scaledM) - jnp.sum(bet * bet))

    if spec.learn_scales:
        Lacc = Lacc + 2.0 * jnp.sum(jnp.log(jnp.abs(scales)))
    L = -0.5 * Lacc
    L = L + priors_mod.total_log_prob(spec.kern.priors_global, kp)
    L = L - D * N * ndlutil.HALFLOGTWOPI
    return L


def make_objective(spec: GpSpec, X, y, bias, fixed_scales, X_u_fixed=None):
    """Returns nlml(θ) = −logLikelihood(θ) for the minimizers."""
    X = jnp.asarray(X)
    y = jnp.asarray(y)
    bias = jnp.asarray(bias)
    fixed_scales = jnp.asarray(fixed_scales)

    def nlml(theta):
        return -log_likelihood(spec, theta, X, y, bias, fixed_scales,
                               X_u_fixed=X_u_fixed)

    return nlml


def posterior_state(spec: GpSpec, theta, X, y, bias, fixed_scales,
                    X_u_fixed=None, explicit_inverse: bool = False):
    """Everything batch-independent of posteriorMeanVar, factored ONCE:
    the serving decomposition (CGp recomputes updateAlpha lazily via dirty
    flags, CGp.cpp:469-534; here the state is an explicit pytree a server
    holds on-device).  `explicit_inverse` stores L⁻¹ (blocked inversion) so
    every FTC per-batch variance solve is a GEMM instead of an N-wide
    triangular solve."""
    X_u, kp, scales, beta = spec.unpack(theta)
    if X_u is None and spec.sparse:
        X_u = jnp.asarray(X_u_fixed)
    scales = scales if spec.learn_scales else jnp.asarray(fixed_scales)
    m = _scaled_targets(jnp.asarray(y), jnp.asarray(bias), scales)
    st = dict(kp=kp, scales=scales, bias=jnp.asarray(bias), beta=beta)

    if spec.approx == FTC:
        K = spec.kern.gram(kp, X)
        L_K, _ = linalg.jitchol(K)
        st.update(X=jnp.asarray(X), L=L_K,
                  alpha=linalg.chol_solve(L_K, m),
                  Linv=linalg.blocked_tri_inv(L_K) if explicit_inverse
                  else None)
        return st
    _sparse_posterior_state(spec, st, kp, X, X_u, m, beta)
    return st


def posterior_apply(spec: GpSpec, st, Xtest):
    """One batch of predictive mean/variance against a `posterior_state`."""
    kp, scales = st["kp"], st["scales"]
    Xtest = jnp.asarray(Xtest)
    kstar_diag = spec.kern.diag(kp, Xtest)
    if spec.approx == FTC:
        kX = spec.kern.compute(kp, st["X"], Xtest)        # (N, T)
        mu0 = kX.T @ st["alpha"]                          # (T, D)
        v = (st["Linv"] @ kX if st["Linv"] is not None
             else linalg.tri_solve(st["L"], kX))          # L⁻¹ kX
        # clamp at 0: near-singular K / test points on training points can
        # round var0 slightly negative (especially the explicit-inverse f32
        # serving GEMM), and clients get the spherical-variance contract
        var0 = jnp.maximum(kstar_diag - jnp.sum(v * v, axis=0), 0.0)  # (T,)
    else:
        beta = st["beta"]
        kX = spec.kern.compute(kp, st["X_u"], Xtest)      # (M, T)
        w1 = linalg.tri_solve(st["L_uu"], kX)             # L_uu⁻¹ k_*
        mu0 = w1.T @ st["u"]                              # k_*ᵀ·A⁻¹·rhs
        # var = k** − k_*ᵀ(invK_uu − A⁻¹/β)k_* + 1/β (CGp.cpp:575-605)
        w2 = linalg.tri_solve(st["L_m"], w1)
        # same ≥0 clamp as the FTC branch: at f32 with large learned β the
        # +1/β floor (~1e-6) is smaller than the cancellation error of
        # kstar_diag − Σw1² for test points near an inducing input, and a
        # negative variance NaNs the client-side sqrt
        var0 = jnp.maximum(kstar_diag - jnp.sum(w1 * w1, axis=0)
                           + jnp.sum(w2 * w2, axis=0) / beta + 1.0 / beta,
                           0.0)
    mu = mu0 * scales[None, :] + st["bias"][None, :]
    var = var0[:, None] * (scales ** 2)[None, :]
    return mu, var


def posterior(spec: GpSpec, theta, X, y, bias, fixed_scales, Xtest,
              X_u_fixed=None):
    """Predictive mean/variance (posteriorMeanVar, CGp.cpp:548-663).

    Returns (mu, varsigma): mu is (T, D) with output scale/bias re-applied;
    varsigma is (T, D) (spherical — same value replicated per output, scaled by
    scale², CGp.cpp:575-625).
    """
    st = posterior_state(spec, theta, X, y, bias, fixed_scales,
                         X_u_fixed=X_u_fixed)
    return posterior_apply(spec, st, Xtest)


def _sparse_posterior_state(spec: GpSpec, st, kp, X, X_u, m, beta):
    """(L_uu, L_m, u) for the sparse family — shared serving form: every
    approximation's mean/var applies the same (w1, w2) formulas; only the
    whitened Am/e assembly differs."""
    # All sparse branches factor A = (1/β)K_uu + K_uf·D⁻¹·K_fu through the
    # L_uu-whitened Am = I/β + Ṽ·Ṽᵀ (Ṽ = L_uu⁻¹K_uf·D^-½), matching the
    # evidence paths: same quantities as the reference's direct A
    # (CGp.cpp:575-625) at cond(Am) ≪ cond(A).
    K_uu = spec.kern.gram(kp, X_u)
    K_uf = spec.kern.compute(kp, X_u, X)
    L_uu, _ = linalg.jitchol(K_uu)
    M_ = K_uf.shape[0]
    if spec.approx == FITC:
        V0 = linalg.tri_solve(L_uu, K_uf)             # L_uu⁻¹ K_uf
        diagQ = jnp.sum(V0 * V0, axis=0)
        diagD = 1.0 + beta * (spec.kern.diag(kp, X) - diagQ)
        sDinv = jnp.sqrt(1.0 / diagD)
        V = V0 * sDinv[None, :]
        Am = jnp.eye(M_, dtype=V.dtype) / beta + V @ V.T
        e = V @ (m * sDinv[:, None])                  # Ṽ·D^-½·m
    elif spec.approx == PITC:
        # block-diagonal D⁻¹ applied via batched Cholesky solves; a test
        # point forms its own block, so mean/var take the FITC form with
        # PITC's A (Quiñonero-Candela & Rasmussen 2005, eq. 24-25).
        # Assembly shared with the evidence path (_pitc_whitened).
        Am, e, _Cb, _sMb = _pitc_whitened(spec, kp, beta, X, m, K_uf, L_uu)
    else:  # DTC / DTCVAR
        V = linalg.tri_solve(L_uu, K_uf)
        Am = jnp.eye(M_, dtype=V.dtype) / beta + V @ V.T
        e = V @ m
    L_m, _ = linalg.jitchol(Am)
    st.update(X_u=X_u, L_uu=L_uu, L_m=L_m,
              u=linalg.chol_solve(L_m, e))            # Am⁻¹·(Ṽ·D^-½·m)


# ---------------------------------------------------------------------------
# Stateful convenience wrapper mirroring the CGp training workflow
# ---------------------------------------------------------------------------

class GP:
    """CGp-equivalent model object: holds data + current parameter vector.

    Construction mirrors `gp learn` (gp.cpp:370-410): bias = column means when
    centring, scale = column std when scaling, β initialized to 1 for sparse
    approximations, inducing inputs a sorted random subset of X
    (CGp::initVals, CGp.cpp:270-285).
    """

    def __init__(self, kern: Kern, X, y, approx: str = FTC, num_active: int = 0,
                 learn_scales: bool = False, centre: bool = True,
                 scale_data: bool = False, beta: float = 1.0,
                 seed: Optional[int] = None, inducing_fixed: bool = False,
                 pitc_block: int = 0):
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        self.X, self.y = X, y
        N, q = X.shape
        D = y.shape[1]
        self.spec = GpSpec(kern=kern, n_data=N, input_dim=q, output_dim=D,
                           approx=approx, num_active=num_active,
                           learn_scales=learn_scales,
                           inducing_fixed=inducing_fixed,
                           pitc_block=pitc_block)
        self.bias = y.mean(axis=0) if centre else np.zeros(D)
        self.fixed_scales = y.std(axis=0, ddof=1) if scale_data else np.ones(D)

        X_u = None
        if self.spec.sparse:
            # Reference-exact selection: MT19937 randpermTrunc then sort
            # (CGp.cpp:273-284) so seeded runs match the reference binaries.
            from gpc_tpu.utils.refrng import RefRng
            rng = RefRng(seed if seed is not None else 0)
            idx = np.sort(rng.randperm_trunc(N, num_active))
            X_u = X[idx]
        self.X_u_fixed = X_u if inducing_fixed else None
        self.theta = jnp.asarray(self.spec.pack(
            kern.default_params(),
            X_u=None if inducing_fixed else X_u,
            scales=self.fixed_scales if learn_scales else None,
            beta=beta if self.spec.sparse else None))
        self._objective = make_objective(self.spec, X, y, self.bias,
                                         self.fixed_scales,
                                         X_u_fixed=self.X_u_fixed)

    # -- CGp API parity ------------------------------------------------------
    def log_likelihood(self) -> float:
        return -float(self._objective(self.theta))

    def optimise(self, iters: int = 1000, param_tol: float = 1e-6,
                 obj_tol: float = 1e-6, optimiser: str = "scg",
                 verbose: int = 0, ckpt_path: str = None,
                 ckpt_every: int = 50, resume: bool = False):
        """SCG by default (runDefaultOptimiser, COptimisable.h:183-203);
        conjgrad/graddesc/quasinew per the reference optimiser names
        (COptimisable.h:153-182).  At verbose>2 with <40 params a
        finite-difference gradient check runs first, as in CGp::optimise
        (CGp.cpp:1544-1545).  ckpt_path enables mid-run preemption
        checkpoints every `ckpt_every` SCG iterations; resume=True continues
        a killed run from the file on the bit-identical trajectory."""
        vag = jax.jit(jax.value_and_grad(self._objective))
        if verbose > 2 and int(np.asarray(self.theta).size) < 40:
            from gpc_tpu.optim.checkgrad import check_gradients
            check_gradients(vag, self.theta)
        res = run_optimiser(optimiser, vag, self.theta, iters,
                            param_tol=param_tol, obj_tol=obj_tol,
                            ckpt_path=ckpt_path, ckpt_every=ckpt_every,
                            resume=resume)
        self.theta = jnp.asarray(res.x)
        return res

    def predict(self, Xtest):
        return posterior(self.spec, self.theta, self.X, self.y, self.bias,
                         self.fixed_scales, Xtest, X_u_fixed=self.X_u_fixed)

    def kern_params(self):
        _, kp, _, _ = self.spec.unpack(self.theta)
        return np.asarray(kp)

    def scales(self):
        _, _, s, _ = self.spec.unpack(self.theta)
        return np.asarray(s) if s is not None else self.fixed_scales

    def beta(self):
        _, _, _, b = self.spec.unpack(self.theta)
        return float(b) if b is not None else None

    def inducing(self):
        xu, _, _, _ = self.spec.unpack(self.theta)
        if xu is None and self.spec.sparse:
            return np.asarray(self.X_u_fixed)
        return np.asarray(xu) if xu is not None else None

    def display(self):
        """Model summary (CGp::display, CGp.cpp:1583-1604)."""
        lines = ["Gaussian process model:",
                 f"  Data dimension: {self.spec.output_dim}",
                 f"  Number of data: {self.spec.n_data}",
                 f"  Approximation type: {self.spec.approx}"]
        kp = self.kern_params()
        for name, val in zip(self.spec.kern.display_names(), kp):
            lines.append(f"  {name}: {val}")
        if self.spec.sparse:
            lines.append(f"  beta: {self.beta()}")
        return "\n".join(lines)
