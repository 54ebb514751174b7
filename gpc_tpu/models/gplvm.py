"""GP-LVM / GPDM: Gaussian-process latent variable model with back constraints
and Wang-style dynamics.

JAX counterpart of the reference's `CGplvm.{h,cpp}`.  The latent
coordinates X (or back-constraint coefficients A with X = bK·A) live inside the
optimizer parameter vector (CGplvm.cpp:257-330 — note the ordering differs from
CGp: kernel params come FIRST here), and the whole objective —

  L = −½ Σ_j^D [m_jᵀK⁻¹m_j + logdet K]
      −½ s·Σ_j^q [XoutᵀdynK⁻¹Xout + logdet dynK]      (if dynamics; s = d/q or 1)
      −½·(latent regularizer) −Σ_j log|scale_j| + priors          (CGplvm.cpp:493-553)

— is one differentiable jitted function; dL/dX, back-constraint chain rule
g_A = bK·g_X, and dynamics shift terms all come from jax.grad (replacing
CGplvm.cpp:555-716).  The reference materializes N gradient matrices of N×q for
getGradX (CGplvm.cpp:569, memory-heavy); autodiff never does.

Dynamics bookkeeping mirrors the reference exactly: Xout is X shifted up one
row with sequence-break rows zeroed (CGplvm::updateX, CGplvm.cpp:231-243), and
dynK has break rows/cols knocked to identity (CGplvm.cpp:448-489).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from gpc_tpu import linalg
from gpc_tpu import transforms as tr
from gpc_tpu import priors as priors_mod
from gpc_tpu.kernels import Kern
from gpc_tpu.optim.scg import scg
from gpc_tpu.optim import run_optimiser


@dataclasses.dataclass(frozen=True)
class GplvmSpec:
    kern: Kern
    n_data: int
    data_dim: int
    latent_dim: int
    dyn_kern: Optional[Kern] = None
    dyn_kern_learnt: bool = True     # false in fixed-SNR GPDM mode (gplvm.cpp:547-548)
    back_constrained: bool = False
    learn_scales: bool = False       # isInputScaleLearnt
    latent_regularised: bool = True
    dynamic_scaling: float = 1.0     # dataDim/latentDim when enabled (CGplvm.h:160-173)
    dyn_breaks: Tuple[int, ...] = (0,)

    @property
    def has_dynamics(self) -> bool:
        return self.dyn_kern is not None

    # --- parameter layout (CGplvm.cpp:257-330) -----------------------------
    def n_params(self) -> int:
        n = self.kern.n_params + self.n_data * self.latent_dim
        if self.has_dynamics and self.dyn_kern_learnt:
            n += self.dyn_kern.n_params
        if self.learn_scales:
            n += self.data_dim
        return n

    def unpack(self, theta):
        """theta → (kern_p, dyn_p, Xvals (N,q), scales)."""
        i = 0
        nk = self.kern.n_params
        kp = tr.apply_atox(self.kern.transform_codes(), theta[i:i + nk])
        i += nk
        dp = None
        if self.has_dynamics and self.dyn_kern_learnt:
            nd = self.dyn_kern.n_params
            dp = tr.apply_atox(self.dyn_kern.transform_codes(), theta[i:i + nd])
            i += nd
        nx = self.n_data * self.latent_dim
        Xvals = theta[i:i + nx].reshape(self.latent_dim, self.n_data).T  # column-major
        i += nx
        scales = None
        if self.learn_scales:
            scales = theta[i:i + self.data_dim]
            i += self.data_dim
        return kp, dp, Xvals, scales

    def pack(self, kern_params, Xvals, dyn_params=None, scales=None):
        parts = [np.asarray(tr.apply_xtoa(self.kern.transform_codes(),
                                          jnp.asarray(kern_params)))]
        if self.has_dynamics and self.dyn_kern_learnt:
            parts.append(np.asarray(tr.apply_xtoa(self.dyn_kern.transform_codes(),
                                                  jnp.asarray(dyn_params))))
        parts.append(np.asarray(Xvals).T.ravel())
        if self.learn_scales:
            parts.append(np.asarray(scales))
        return np.concatenate(parts)

    def break_rows(self):
        """Knocked-out row indices: f = N−1 for break 0, else brk−1
        (CGplvm.cpp:236-242, 466-477)."""
        return np.array([self.n_data - 1 if b == 0 else b - 1
                         for b in self.dyn_breaks], dtype=np.int32)


def _latent_X(spec: GplvmSpec, Xvals, bK):
    """X = bK·A under back constraints (CGplvm::updateX, CGplvm.cpp:224-230)."""
    return bK @ Xvals if spec.back_constrained else Xvals


def _xout(spec: GplvmSpec, X):
    """Up-shifted X with break rows zeroed (CGplvm.cpp:231-243)."""
    Xout = jnp.concatenate([X[1:], jnp.zeros((1, X.shape[1]), X.dtype)], axis=0)
    rows = spec.break_rows()
    return Xout.at[rows].set(0.0)


def _dyn_gram(spec: GplvmSpec, dp, X):
    """Dynamics Gram with break rows/cols → identity (CGplvm.cpp:448-477)."""
    dynK = spec.dyn_kern.gram(dp, X)
    rows = spec.break_rows()
    dynK = dynK.at[rows, :].set(0.0)
    dynK = dynK.at[:, rows].set(0.0)
    dynK = dynK.at[rows, rows].set(1.0)
    return dynK


def log_likelihood(spec: GplvmSpec, theta, y, noise_bias, fixed_scales,
                   dyn_params_fixed=None, bK=None):
    """CGplvm::logLikelihood (CGplvm.cpp:493-553), differentiable in theta."""
    kp, dp, Xvals, scales = spec.unpack(theta)
    if dp is None and spec.has_dynamics:
        dp = jnp.asarray(dyn_params_fixed)
    scales = scales if spec.learn_scales else jnp.asarray(fixed_scales)
    X = _latent_X(spec, Xvals, bK)
    m = (jnp.asarray(y) - jnp.asarray(noise_bias)[None, :]) / scales[None, :]
    N, D, q = spec.n_data, spec.data_dim, spec.latent_dim

    # Large-N paths (the reference GP-LVM stops at ~1k points,
    # README.md:412-414): GPC_TPU_EVIDENCE selects the evidence engine
    # (ops/evidence_mode.py):
    #   dense     — jitchol escalation, the default and the parity route;
    #   lazy      — Gram tiles fused into the blocked factorization
    #               (ops/lazy_evidence), differentiable via autodiff, opt-in;
    #   iterative — matrix-free CG + SLQ (ops/iterative.py), opt-in only.
    # On the lazy path a transiently non-PD K yields a NaN objective, which
    # SCG rejects as a failed step (λ growth — optim/scg.py NaN handling)
    # instead of re-jittering (tests/test_evidence_mode.py pins that
    # rescue behavior).
    from gpc_tpu.ops.evidence_mode import select_evidence_mode
    mode = select_evidence_mode(N)
    if mode == "lazy":
        from gpc_tpu.ops.lazy_evidence import kern_evidence_lazy
        logdet, quad = kern_evidence_lazy(spec.kern, kp, X, m, force=True)
        Lacc = quad + D * logdet
    elif mode == "iterative":
        # matrix-free CG+SLQ engine — trains the latent X through the
        # custom VJP (ops/iterative.py), never materializing the N×N Gram
        from gpc_tpu.ops.iterative import kern_evidence_iterative
        logdet, quad = kern_evidence_iterative(spec.kern, kp, X, m)
        Lacc = quad + D * logdet
    else:
        K = spec.kern.gram(kp, X)
        L_K, _ = linalg.jitchol(K)
        Lacc = linalg.quad_form(L_K, m) + D * linalg.chol_logdet(L_K)

    if spec.has_dynamics:
        Xout = _xout(spec, X)
        s = spec.dynamic_scaling
        if mode == "iterative":
            # GPDM past dense memory: the dynamics Gram is the same
            # knocked-out-rows operator as _dyn_gram, expressed matrix-free
            # as mask·dynK·mask + (I−mask) — break rows have eigenvalue 1
            # (0 logdet) and Xout is zero there, so the masked CG+SLQ
            # estimator matches the dense term (ops/iterative.py; closes
            # the round-4 silent dense-dynK exception to the N=65k story)
            from gpc_tpu.ops.iterative import kern_evidence_iterative_masked
            mask = jnp.ones((N,), X.dtype).at[spec.break_rows()].set(0.0)
            ld_d, quad_d = kern_evidence_iterative_masked(
                spec.dyn_kern, dp, X, Xout, mask)
            Lacc = Lacc + s * (quad_d + q * ld_d)
        else:
            dynK = _dyn_gram(spec, dp, X)
            L_d, _ = linalg.jitchol(dynK)
            Lacc = Lacc + s * (linalg.quad_form(L_d, Xout)
                               + q * linalg.chol_logdet(L_d))
        if spec.latent_regularised:
            # reference regularises norm2Col(0) here (CGplvm.cpp:530-534)
            Lacc = Lacc + jnp.sum(X[:, 0] ** 2)
    elif spec.latent_regularised:
        Lacc = Lacc + jnp.sum(X * X)

    if spec.learn_scales:
        Lacc = Lacc + 2.0 * jnp.sum(jnp.log(jnp.abs(scales)))
    L = -0.5 * Lacc
    L = L + priors_mod.total_log_prob(spec.kern.priors_global, kp)
    if spec.has_dynamics and spec.dyn_kern_learnt:
        L = L + priors_mod.total_log_prob(spec.dyn_kern.priors_global, dp)
    # NO −(N·D/2)·log 2π term: CGplvm::logLikelihood (CGplvm.cpp:493-551)
    # omits the Gaussian normalization constant that CGp::logLikelihood
    # carries — a documented reference quirk replicated for value parity
    # (gradients and SCG trajectories are invariant to it)
    return L


def pca_init(m, latent_dim):
    """PCA initialization X = m·U·Λ^(−1/2), mean-centred (CGplvm.cpp:157-188)."""
    m = np.asarray(m)
    N = m.shape[0]
    cov = m.T @ m / N - np.outer(m.mean(0), m.mean(0))
    vals, vecs = np.linalg.eigh(cov)
    order = np.argsort(vals)[::-1][:latent_dim]
    W = vecs[:, order] / np.sqrt(vals[order])[None, :]
    X = m @ W
    return X - X.mean(0)


def back_constraint_init(bK, latent_dim):
    """X = top eigenvectors of bK; A solves bK·A = X (CGplvm.cpp:189-222)."""
    vals, vecs = np.linalg.eigh(np.asarray(bK))
    order = np.argsort(vals)[::-1][:latent_dim]
    X = vecs[:, order]
    A = np.linalg.solve(np.asarray(bK), X)
    return X, A


def posterior(spec: GplvmSpec, theta, y, noise_bias, fixed_scales, Xtest,
              dyn_params_fixed=None, bK=None):
    """Latent→data posterior (CGplvm::posteriorMeanVar, CGplvm.cpp:340-361).
    NOTE: like the reference, mu/var are in the SCALED m-space (CGplvm::out is
    empty; rescaling to y-space is the noise model's job)."""
    kp, dp, Xvals, scales = spec.unpack(theta)
    scales = scales if spec.learn_scales else jnp.asarray(fixed_scales)
    X = _latent_X(spec, Xvals, bK)
    m = (jnp.asarray(y) - jnp.asarray(noise_bias)[None, :]) / scales[None, :]
    K = spec.kern.gram(kp, X)
    L_K, _ = linalg.jitchol(K)
    kX = spec.kern.compute(kp, X, jnp.asarray(Xtest))
    v = linalg.tri_solve(L_K, kX)
    var = jnp.maximum(
        spec.kern.diag(kp, jnp.asarray(Xtest)) - jnp.sum(v * v, axis=0), 0.0)
    # K⁻¹kX = L⁻ᵀv reuses the variance solve instead of redoing it
    mu = linalg.tri_solve(L_K, v, trans=True).T @ m
    return mu, jnp.tile(var[:, None], (1, spec.data_dim))


class GPLVM:
    """CGplvm-equivalent stateful wrapper."""

    def __init__(self, kern: Kern, y, latent_dim: int = 2,
                 dyn_kern: Optional[Kern] = None, dyn_kern_params=None,
                 dyn_kern_learnt: bool = True, back_kernel_matrix=None,
                 centre: bool = True, scale_data: bool = False,
                 learn_scales: bool = False, latent_regularised: bool = True,
                 dynamic_scaling: bool = False, dyn_breaks=(0,),
                 init: str = "pca", seed: Optional[int] = None):
        y = np.asarray(y, dtype=np.float64)
        self.y = y
        N, D = y.shape
        scaling = (D / latent_dim) if dynamic_scaling else 1.0
        self.spec = GplvmSpec(
            kern=kern, n_data=N, data_dim=D, latent_dim=latent_dim,
            dyn_kern=dyn_kern, dyn_kern_learnt=dyn_kern_learnt,
            back_constrained=back_kernel_matrix is not None,
            learn_scales=learn_scales, latent_regularised=latent_regularised,
            dynamic_scaling=scaling, dyn_breaks=tuple(dyn_breaks))
        # CScaleNoise-style preprocessing (gplvm.cpp:506-519)
        self.noise_bias = y.mean(0) if centre else np.zeros(D)
        self.fixed_scales = (np.maximum(y.std(0, ddof=1), np.finfo(float).eps)
                             if scale_data else np.ones(D))
        self.bK = (jnp.asarray(back_kernel_matrix)
                   if back_kernel_matrix is not None else None)
        self.dyn_params_fixed = (np.asarray(dyn_kern_params)
                                 if dyn_kern_params is not None else
                                 (dyn_kern.default_params() if dyn_kern is not None else None))

        m = (y - self.noise_bias) / self.fixed_scales
        if init == "rand":
            # CGplvm::initXrand fills the latent matrix with variance-0.001
            # normal deviates in column-major memory order via ndlutil::randn
            # (CGplvm.cpp:144-149, CMatrix.cpp:517-526) — reproduce the exact
            # stream so seeded runs match the reference binaries.
            from gpc_tpu.utils.refrng import RefRng
            rng = RefRng(seed if seed is not None else 0)
            Xvals = np.array([rng.randn() for _ in range(N * latent_dim)],
                             dtype=np.float64).reshape(latent_dim, N).T * np.sqrt(0.001)
        elif self.spec.back_constrained:
            _, Xvals = back_constraint_init(np.asarray(self.bK), latent_dim)
        else:
            Xvals = pca_init(m, latent_dim)

        kp0 = kern.default_params()
        self.theta = jnp.asarray(self.spec.pack(
            kp0, Xvals,
            dyn_params=self.dyn_params_fixed if (dyn_kern is not None and dyn_kern_learnt) else None,
            scales=self.fixed_scales if learn_scales else None))

        self._objective = self._make_objective()

    def _make_objective(self):
        spec = self.spec
        y = jnp.asarray(self.y)
        bias = jnp.asarray(self.noise_bias)
        fs = jnp.asarray(self.fixed_scales)
        dpf = (jnp.asarray(self.dyn_params_fixed)
               if self.dyn_params_fixed is not None else None)
        bK = self.bK

        def nlml(theta):
            return -log_likelihood(spec, theta, y, bias, fs,
                                   dyn_params_fixed=dpf, bK=bK)
        return nlml

    def log_likelihood(self) -> float:
        return -float(self._objective(self.theta))

    def optimise(self, iters: int = 1000, param_tol: float = 1e-6,
                 obj_tol: float = 1e-6, optimiser: str = "scg",
                 verbose: int = 0, ckpt_path: str = None,
                 ckpt_every: int = 50, resume: bool = False):
        """ckpt_path enables mid-run preemption checkpoints every
        `ckpt_every` SCG iterations; resume=True continues a killed run
        from the file on the bit-identical trajectory (optim.run_optimiser)."""
        vag = jax.jit(jax.value_and_grad(self._objective))
        # auto gradient check, as in the reference optimise at high verbosity
        # (CGp.cpp:1544-1545 — only for small parameter vectors)
        if verbose > 2 and int(np.asarray(self.theta).size) < 40:
            from gpc_tpu.optim.checkgrad import check_gradients
            check_gradients(vag, self.theta)
        res = run_optimiser(optimiser, vag, self.theta, iters,
                            param_tol=param_tol, obj_tol=obj_tol,
                            ckpt_path=ckpt_path, ckpt_every=ckpt_every,
                            resume=resume)
        self.theta = jnp.asarray(res.x)
        return res

    # -- accessors ----------------------------------------------------------
    def kern_params(self):
        kp, _, _, _ = self.spec.unpack(self.theta)
        return np.asarray(kp)

    def dyn_kern_params(self):
        _, dp, _, _ = self.spec.unpack(self.theta)
        return np.asarray(dp) if dp is not None else self.dyn_params_fixed

    def latent_X(self):
        _, _, Xvals, _ = self.spec.unpack(self.theta)
        X = _latent_X(self.spec, Xvals, self.bK)
        return np.asarray(X)

    def scales(self):
        _, _, _, s = self.spec.unpack(self.theta)
        return np.asarray(s) if s is not None else self.fixed_scales

    def predict_from_latent(self, Xtest):
        mu, var = posterior(self.spec, self.theta, self.y, self.noise_bias,
                            self.fixed_scales, Xtest,
                            dyn_params_fixed=self.dyn_params_fixed, bK=self.bK)
        # rescale to y-space via the scale noise (CScaleNoise::out)
        s = jnp.asarray(self.scales())
        return (mu * s[None, :] + jnp.asarray(self.noise_bias)[None, :],
                var * (s ** 2)[None, :])

    def display(self):
        lines = ["GPLVM Model:",
                 f"  Data dimension: {self.spec.data_dim}",
                 f"  Latent dimension: {self.spec.latent_dim}",
                 f"  Number of data: {self.spec.n_data}",
                 f"  Back constrained: {self.spec.back_constrained}",
                 f"  Dynamics: {self.spec.has_dynamics}"]
        for name, val in zip(self.spec.kern.display_names(), self.kern_params()):
            lines.append(f"  {name}: {val}")
        if self.spec.has_dynamics:
            for name, val in zip(self.spec.dyn_kern.display_names(), self.dyn_kern_params()):
                lines.append(f"  dyn {name}: {val}")
        return "\n".join(lines)
