"""Informative Vector Machine — greedy active-set GP classification.

JAX counterpart of the reference's `CIvm.{h,cpp}` (Lawrence/Seeger/
Herbrich ADF selection).  The greedy selection loop is inherently sequential
(d rank-1 updates, CIvm.cpp:248-365); here it is ONE jitted `lax.scan` over
fixed-size zero-padded buffers so the whole selection runs on-device:

  per step (CIvm::addPoint):
    entropy scores  Δᵢ = −½·log(1 − ςᵢ·νᵢ + 1e-300)   (CIvm.cpp:413-431)
    site update     β = ν/(1−ν·ς), m = μ + g/ν          (CNoise.cpp:40-63)
    rank-1 update   s = k_new − Mᵀa;  M ← [M; s·√ν];  L ← [L 0; aᵀ 1/√ν]
                    ς ← ς − s²·ν;  μ ← μ + g·s           (CIvm.cpp:302-365)
    refresh ν/g for all N points                          (CIvm.cpp:490-494)

Hyperparameters are trained on the ACTIVE-SET marginal likelihood
L = −½Σⱼ[logdet(K+B⁻¹) + mᵀ(K+B⁻¹)⁻¹m] + priors (CIvm.cpp:521-540) via
jax.grad + SCG, alternating with noise-parameter SCG rounds
(CIvm::optimise, CIvm.cpp:685-736).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from gpc_tpu import linalg
from gpc_tpu import transforms as tr
from gpc_tpu import priors as priors_mod
from gpc_tpu.kernels import Kern
from gpc_tpu.noise import Noise
from gpc_tpu.optim.scg import scg

ENTROPY, RENTROPY, RANDOM = "entropy", "rentropy", "random"


@dataclasses.dataclass(frozen=True)
class IvmSpec:
    kern: Kern
    noise: Noise
    n_data: int
    input_dim: int
    output_dim: int
    num_active: int
    selection: str = ENTROPY

    @property
    def n_struct(self) -> int:
        """numCovStruct: 1 for spherical noise else outputDim (CIvm.cpp:166-170)."""
        return 1 if self.noise.spherical else self.output_dim


class IvmState(NamedTuple):
    active_idx: jax.Array   # (d,) int32 — selection order
    active_mask: jax.Array  # (N,) bool
    m_site: jax.Array       # (d, D) site means
    beta_site: jax.Array    # (d, D) site precisions
    mu: jax.Array           # (N, D) ADF posterior means
    varsigma: jax.Array     # (N, D) ADF posterior variances
    nu: jax.Array           # (N, D)
    g: jax.Array            # (N, D)


def select_points(spec: IvmSpec, kern_params, noise_params, X, y,
                  rand_vals) -> IvmState:
    """Greedy active-set selection (CIvm::selectPoints) as a jitted scan.

    `rand_vals` is a (d,) array of U[0,1) draws, one slot per selection step;
    step k consumes rand_vals[k] ONLY on a random pick (RANDOM always,
    RENTROPY at k=0) — the reference draws from its global MT19937 exactly
    then (CIvm::randomPointAdd, CIvm.cpp:402-411), so a caller that fills the
    consumed slots from utils.refrng.RefRng reproduces seeded reference
    binaries bit-for-bit in selection order."""
    N, D, d = spec.n_data, spec.output_dim, spec.num_active
    C = spec.n_struct
    X = jnp.asarray(X)
    y = jnp.asarray(y)
    kp = jnp.asarray(kern_params)
    np_ = jnp.asarray(noise_params)
    dt = jnp.result_type(X, kp)

    diagK = spec.kern.diag(kp, X)
    mu0 = jnp.zeros((N, D), dt)
    vs0 = jnp.tile(diagK[:, None], (1, D))
    nu0, g0 = spec.noise.nu_g(np_, mu0, vs0, y)

    # structure index per output: 0 if spherical else j
    cmap = np.zeros(D, np.int32) if C == 1 else np.arange(D, dtype=np.int32)

    init = dict(
        M=jnp.zeros((C, d, N), dt),
        L=jnp.zeros((C, d, d), dt),
        mu=mu0, vs=vs0, nu=nu0, g=g0,
        m_site=jnp.zeros((d, D), dt),
        beta_site=jnp.zeros((d, D), dt),
        mask=jnp.zeros((N,), bool),
        idx=jnp.zeros((d,), jnp.int32),
    )
    rand_vals = jnp.asarray(rand_vals, dt)

    white = spec.kern.white(kp)

    def body(carry, k):
        nu, g, mask = carry["nu"], carry["g"], carry["mask"]

        # --- selection (CIvm.cpp:366-431) ---------------------------------
        if spec.noise.spherical:
            delta = -0.5 * jnp.log(1.0 - carry["vs"][:, 0] * nu[:, 0] + 1e-300) * D
        else:
            delta = jnp.sum(-0.5 * jnp.log(1.0 - carry["vs"] * nu + 1e-300), axis=1)
        delta = jnp.where(mask, -jnp.inf, delta)
        ent_index = jnp.argmax(delta)
        # random pick from the inactive set: index = (int)(r·|inactive|) into
        # the ascending-ordered inactive list (CIvm.cpp:405-407; erase
        # preserves order, so inactive stays index-sorted)
        r = rand_vals[k]
        n_inactive = N - k
        # clamp like select_point_remove: in f32 a draw ≥ 1−2⁻²⁵ rounds to
        # 1.0 and floor(r·n) == n would match no inactive point
        target = jnp.minimum(jnp.floor(r * n_inactive),
                             n_inactive - 1).astype(jnp.int32)
        rank = jnp.cumsum(~mask) - 1  # rank among inactive
        rand_index = jnp.argmax((rank == target) & ~mask)
        if spec.selection == ENTROPY:
            index = ent_index
        elif spec.selection == RANDOM:
            index = rand_index
        else:  # rentropy: random first point, entropy afterwards
            index = jnp.where(k == 0, rand_index, ent_index)

        # --- site update (CIvm::updateSite, beta clamp CIvm.cpp:283-298) ---
        m_all, beta_all = spec.noise.update_sites(np_, carry["mu"], carry["vs"], y, nu, g)
        m_i = m_all[index]
        beta_i = beta_all[index]
        if not spec.noise.log_concave:
            beta_i = jnp.where(beta_i < 0, 1e-6, beta_i)

        # --- kernel column with white on own diagonal (CIvm.cpp:305-311) ---
        k_col = spec.kern.compute(kp, X, X[index][None, :])[:, 0]
        k_col = k_col.at[index].add(white)

        # --- rank-1 updates per covariance structure (CIvm.cpp:319-349) ----
        M, L = carry["M"], carry["L"]
        a = M[:, :, index]                       # (C, d)
        s = k_col[None, :] - jnp.einsum("cdn,cd->cn", M, a)  # (C, N)
        sqrt_nu = jnp.sqrt(nu[index, jnp.asarray(cmap[:C])])  # (C,)
        M = lax.dynamic_update_index_in_dim(
            M, s * sqrt_nu[:, None], k, axis=1)
        Lrow = a.at[:, k].set(1.0 / sqrt_nu)
        L = lax.dynamic_update_index_in_dim(L, Lrow, k, axis=1)

        # --- posterior moment updates (CIvm.cpp:336-365) -------------------
        s_out = s[cmap, :].T                      # (N, D) structure column per output
        nu_out = nu[index, cmap]                  # (D,)
        vs = carry["vs"] - (s_out ** 2) * nu_out[None, :]
        mu = carry["mu"] + g[index][None, :] * s_out

        mask = mask.at[index].set(True)
        idx = carry["idx"].at[k].set(index.astype(jnp.int32))
        m_site = carry["m_site"].at[k].set(m_i)
        beta_site = carry["beta_site"].at[k].set(beta_i)

        # --- refresh nu/g for all points (updateNuG, CIvm.cpp:490-494) -----
        nu_new, g_new = spec.noise.nu_g(np_, mu, vs, y)

        return dict(M=M, L=L, mu=mu, vs=vs, nu=nu_new, g=g_new, m_site=m_site,
                    beta_site=beta_site, mask=mask, idx=idx), None

    final, _ = lax.scan(body, init, jnp.arange(d))
    return IvmState(active_idx=final["idx"], active_mask=final["mask"],
                    m_site=final["m_site"], beta_site=final["beta_site"],
                    mu=final["mu"], varsigma=final["vs"],
                    nu=final["nu"], g=final["g"])


def select_point_remove(spec: IvmSpec, state: IvmState, r=None):
    """Select an active point to remove (CIvm::selectPointRemove,
    CIvm.cpp:432-489).

    Removal entropy change per active slot k holding data index i:
        Δₖ = −½ Σ_j log(1 − ς_ij·β_kj + 1e-300)
    (spherical noise: j = 0 replicated ×D).  ENTROPY/RENTROPY pick argmax Δ,
    RANDOM picks uniformly via the caller-supplied U[0,1) draw `r`
    (slot = ⌊r·d⌋ — the reference uses libc rand() here, its one departure
    from the seeded MT19937 stream, CIvm.cpp:462-469).

    The upstream implementation of this API is dead code with two indexing
    bugs — `entropyPointRemove` returns `inactiveSet[argmax]` (CIvm.cpp:459)
    and `entropyChangeRemove` reads `beta.getVal(activeSet[index],·)` with
    `index` already a data index (CIvm.cpp:478) — so this implements the
    documented intent, not the broken literal behavior.

    Returns (slot, data_index, entropy_change).
    """
    d = spec.num_active
    vs_active = state.varsigma[state.active_idx]          # (d, D)
    if spec.noise.spherical:
        delta = -0.5 * jnp.log(
            1.0 - vs_active[:, 0] * state.beta_site[:, 0] + 1e-300
        ) * spec.output_dim
    else:
        delta = jnp.sum(
            -0.5 * jnp.log(1.0 - vs_active * state.beta_site + 1e-300), axis=1)
    if spec.selection == RANDOM:
        if r is None:
            raise ValueError("random removal needs a U[0,1) draw")
        slot = jnp.minimum(jnp.floor(r * d), d - 1).astype(jnp.int32)
    else:  # entropy / rentropy
        slot = jnp.argmax(delta)
    return slot, state.active_idx[slot], delta[slot]


def active_log_likelihood(spec: IvmSpec, kern_params, X_active, m_site, beta_site):
    """Active-set marginal likelihood for hyperparameter training
    (CIvm::logLikelihood, CIvm.cpp:521-540)."""
    kp = kern_params
    K = spec.kern.gram(kp, X_active)
    L = 0.0
    n_loops = 1 if spec.noise.spherical else spec.output_dim
    for j in range(n_loops):
        Kb = K + jnp.diag(1.0 / beta_site[:, j])
        Lc, _ = linalg.jitchol(Kb)
        logdet = linalg.chol_logdet(Lc)
        if spec.noise.spherical:
            quad = linalg.quad_form(Lc, m_site)  # all columns share K+B⁻¹
            L = L - 0.5 * (spec.output_dim * logdet + quad)
        else:
            quad = linalg.quad_form(Lc, m_site[:, j:j + 1])
            L = L - 0.5 * (logdet + quad)
    L = L + priors_mod.total_log_prob(spec.kern.priors_global, kp)
    return L


def posterior(spec: IvmSpec, kern_params, X_active, m_site, beta_site, Xtest):
    """Predictive moments from the active set (CIvm::posteriorMeanVar,
    CIvm.cpp:126-163).  Returns (mu, varsigma) of shape (T, D)."""
    kp = kern_params
    K = spec.kern.gram(kp, X_active)
    kX = spec.kern.compute(kp, X_active, Xtest)      # (d, T)
    kdiag = spec.kern.diag(kp, Xtest)
    mus, vss = [], []
    n_loops = 1 if spec.noise.spherical else spec.output_dim
    for j in range(n_loops):
        Kb = K + jnp.diag(1.0 / beta_site[:, j])
        Lc, _ = linalg.jitchol(Kb)
        v = linalg.tri_solve(Lc, kX)
        vs = jnp.maximum(kdiag - jnp.sum(v * v, axis=0), 0.0)
        # Kb⁻¹kX = Lc⁻ᵀv reuses the variance solve (per-output loop for
        # non-spherical noise multiplies the saving by output_dim)
        w = linalg.tri_solve(Lc, v, trans=True)
        if spec.noise.spherical:
            mu = w.T @ m_site                         # (T, D)
            return mu, jnp.tile(vs[:, None], (1, spec.output_dim))
        mus.append(w.T @ m_site[:, j])
        vss.append(vs)
    return jnp.stack(mus, axis=1), jnp.stack(vss, axis=1)


# ---------------------------------------------------------------------------

class IVM:
    """CIvm-equivalent stateful wrapper: data + current parameters + active set."""

    def __init__(self, kern: Kern, noise: Noise, X, y, num_active: int,
                 selection: str = ENTROPY, seed: Optional[int] = None,
                 kern_params=None, noise_params=None):
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        self.X, self.y = X, y
        N, q = X.shape
        D = y.shape[1]
        if num_active > N:
            raise ValueError("Number of active points has to be less than number of data.")
        self.spec = IvmSpec(kern=kern, noise=noise, n_data=N, input_dim=q,
                            output_dim=D, num_active=num_active, selection=selection)
        self.kern_params = jnp.asarray(kern_params if kern_params is not None
                                       else kern.default_params())
        self.noise_params = jnp.asarray(noise_params if noise_params is not None
                                        else noise.default_params(y))
        # The reference seeds ONE global MT19937 from the CLI -s flag and
        # random/rentropy selection draws from it (CIvm.cpp:402-411 via
        # ndlutil::rand); owning a RefRng here reproduces those streams.
        from gpc_tpu.utils.refrng import RefRng
        self.ref_rng = RefRng(seed if seed is not None else 0)
        self.state: Optional[IvmState] = None
        self._select = jax.jit(lambda kp, npar, rv: select_points(
            self.spec, kp, npar, self.X, self.y, rv))
        # Jitted once with the site state as ARGUMENTS (not closure captures):
        # CIvm::optimise re-selects every external iteration, and re-tracing
        # the objectives each round dominated wall-clock before this.
        codes = self.spec.kern.transform_codes()
        ncodes = self.spec.noise.transform_codes()

        def _kern_obj(a, Xa, m_site, beta_site):
            kp = tr.apply_atox(codes, a)
            return -active_log_likelihood(self.spec, kp, Xa, m_site, beta_site)

        def _noise_obj(a, mu, varsigma):
            npar = tr.apply_atox(ncodes, a)
            return -self.spec.noise.log_likelihood(npar, mu, varsigma,
                                                   jnp.asarray(self.y))

        self._kern_vag = jax.jit(jax.value_and_grad(_kern_obj))
        self._noise_vag = jax.jit(jax.value_and_grad(_noise_obj))

    # -- CIvm API parity -----------------------------------------------------
    def init_and_select(self):
        # draw exactly the uniforms the reference consumes this pass:
        # d for RANDOM, one (step 0) for RENTROPY, none for ENTROPY
        d = self.spec.num_active
        rv = np.zeros(d)
        if self.spec.selection == RANDOM:
            rv[:] = [self.ref_rng.rand() for _ in range(d)]
        elif self.spec.selection == RENTROPY:
            rv[0] = self.ref_rng.rand()
        self.state = self._select(self.kern_params, self.noise_params,
                                  jnp.asarray(rv))
        return self.state

    def active_X(self):
        return self.X[np.asarray(self.state.active_idx)]

    def log_likelihood(self) -> float:
        st = self.state
        return float(active_log_likelihood(
            self.spec, self.kern_params, jnp.asarray(self.active_X()),
            st.m_site, st.beta_site))

    def optimise(self, ext_iters: int = 15, kern_iters: int = 100,
                 noise_iters: int = 100, verbose: int = 0,
                 ckpt_path: str = None, resume: bool = False):
        """Alternating reselect/SCG rounds (CIvm::optimise, CIvm.cpp:685-736).
        At verbose>2 with <40 kernel params a finite-difference gradient check
        runs before each kernel round (CIvm.cpp:704-705).

        ckpt_path enables phase-boundary preemption checkpoints — the
        alternation state is tiny (kernel θ, noise θ, MT19937 stream, phase
        counter), and each [reselect → SCG] phase is deterministic given it,
        so a killed run resumed with resume=True replays the IDENTICAL
        remaining trajectory (the reference's longest tutorial workload
        restarts from scratch on preemption, CIvm.cpp:685-736)."""
        import os as _os

        from gpc_tpu.utils import checkpoint as ckpt_mod

        codes = self.spec.kern.transform_codes()
        ncodes = self.spec.noise.transform_codes()
        start_phase = 0
        if resume and ckpt_path and _os.path.exists(ckpt_path):
            step, kp, extra, _ = ckpt_mod.load(ckpt_path)
            self.kern_params = jnp.asarray(kp)
            self.noise_params = jnp.asarray(extra["noise_params"])
            self.ref_rng.set_state(extra["rng_mt"], int(extra["rng_mti"]),
                                   float(extra["rng_stored"]))
            start_phase = step

        def save(phase):
            if not ckpt_path:
                return
            mt, mti, stored = self.ref_rng.get_state()
            ckpt_mod.save(ckpt_path, phase, np.asarray(self.kern_params),
                          extra=dict(noise_params=np.asarray(self.noise_params),
                                     rng_mt=mt, rng_mti=np.asarray(mti),
                                     rng_stored=np.asarray(stored)))

        phase = 0
        for _ in range(max(ext_iters, 0)):
            if phase >= start_phase and kern_iters > 0:
                self.init_and_select()
                st = self.state
                Xa = jnp.asarray(self.active_X())
                a0 = tr.apply_xtoa(codes, self.kern_params)
                if verbose > 2 and a0.size < 40:
                    from gpc_tpu.optim.checkgrad import check_gradients
                    check_gradients(
                        lambda a: self._kern_vag(a, Xa, st.m_site,
                                                 st.beta_site), a0)
                res = scg(self._kern_vag, a0, max_iters=kern_iters,
                          args=(Xa, st.m_site, st.beta_site))
                self.kern_params = tr.apply_atox(codes, res.x)
                save(phase + 1)
            phase += 1
            if phase >= start_phase and noise_iters > 0:
                self.init_and_select()
                st = self.state
                a0 = tr.apply_xtoa(ncodes, self.noise_params)
                res = scg(self._noise_vag, a0, max_iters=noise_iters,
                          args=(st.mu, st.varsigma))
                self.noise_params = tr.apply_atox(ncodes, res.x)
                save(phase + 1)
            phase += 1
        self.init_and_select()

    def predict(self, Xtest):
        st = self.state
        mu, vs = posterior(self.spec, self.kern_params,
                           jnp.asarray(self.active_X()), st.m_site,
                           st.beta_site, jnp.asarray(Xtest))
        return mu, vs

    def out(self, Xtest):
        mu, vs = self.predict(Xtest)
        return self.spec.noise.out(self.noise_params, mu, vs)

    def display(self):
        lines = ["IVM Model:",
                 f"  Active set size: {self.spec.num_active}",
                 f"  Data size: {self.spec.n_data}",
                 f"  Selection criterion: {self.spec.selection}"]
        for name, val in zip(self.spec.kern.display_names(), np.asarray(self.kern_params)):
            lines.append(f"  {name}: {val}")
        for i, val in enumerate(np.asarray(self.noise_params)):
            lines.append(f"  noise param {i}: {val}")
        return "\n".join(lines)
