"""Distributed IVM: the greedy active-set selection scan sharded over N.

The reference IVM's hot loop is O(d·N) — an entropy scan over all N points
plus a rank-1 refresh of every posterior moment per added point
(/root/reference/CIvm.cpp:302-365, 366-431).  N is the scaling axis the
reference has no answer for; here every O(N) quantity (X/y rows, posterior
mu/varsigma, ADF nu/g, the growing M = (C, d, N) store, the inactive mask)
is row-sharded over the "dp" mesh axis, while the O(d) site state
(m/beta sites, the selection order) stays replicated:

  entropy argmax  — local argmax per shard, then an all_gather of n_dev
                    (max, global-arg) pairs; first-max-device tie-breaking
                    reproduces the single-chip jnp.argmax exactly (device
                    order == global row order);
  selected-row pulls (x*, y*, mu*, vs*, nu*, g*, M column a) — psum of
                    owner-masked rows: O(q + D + C·d) bytes over the interconnect
                    per step, the only communication besides the argmax;
  s-column + moment refresh — pure local rank-1 work on each shard's rows;
  nu/g refresh    — local (the noise models are row-elementwise).

Selection order is bit-identical to models/ivm.select_points (pinned in
tests/test_dist_ivm.py), so hyperparameter training — SCG on the ACTIVE-SET
likelihood, a d×d problem (CIvm.cpp:521-540) — proceeds replicated exactly
as single-chip once the selection returns.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gpc_tpu.models.ivm import ENTROPY, RANDOM, RENTROPY, IvmSpec, IvmState
from gpc_tpu.parallel.mesh import DATA_AXIS


def _psum_row(x, cond):
    """Replicate the (single) row where `cond` holds: owner-masked psum."""
    return lax.psum(jnp.where(cond, x, jnp.zeros_like(x)), DATA_AXIS)


def make_select_points_dist(spec: IvmSpec, mesh: Mesh):
    """Returns select(kp, noise_p, X_l, y_l, valid_l, rand_vals) for
    shard_map-free calling: inputs row-sharded over `mesh`'s dp axis
    (pad with valid=0 rows to split evenly), output IvmState with GLOBAL
    (replicated) active_idx/sites and row-sharded moment arrays."""
    n_dev = mesh.shape[DATA_AXIS]
    D, d, C = spec.output_dim, spec.num_active, spec.n_struct
    kern, noise = spec.kern, spec.noise
    cmap = np.zeros(D, np.int32) if C == 1 else np.arange(D, dtype=np.int32)

    def local(kp, np_, X_l, y_l, valid_l, rand_vals):
        valid_l = valid_l.astype(bool)
        B = X_l.shape[0]
        dev = lax.axis_index(DATA_AXIS)
        offset = dev * B
        rows_l = offset + jnp.arange(B)
        dt = jnp.result_type(X_l, kp)

        diagK_l = kern.diag(kp, X_l)
        mu0 = jnp.zeros((B, D), dt)
        vs0 = jnp.tile(diagK_l[:, None], (1, D))
        nu0, g0 = noise.nu_g(np_, mu0, vs0, y_l)
        white = kern.white(kp)

        # NOTE: unlike the single-chip scan, no L factor rides the carry —
        # nothing downstream reads it (training refactors from the sites),
        # and in the sharded scan its replicated per-step update would be
        # pure overhead on every device
        init = dict(
            M=jnp.zeros((C, d, B), dt),          # sharded on the last axis
            mu=mu0, vs=vs0, nu=nu0, g=g0,        # sharded rows
            m_site=jnp.zeros((d, D), dt),        # replicated
            beta_site=jnp.zeros((d, D), dt),
            mask=jnp.zeros((B,), bool),
            idx=jnp.zeros((d,), jnp.int32),
        )

        def body(carry, k):
            nu, g, mask = carry["nu"], carry["g"], carry["mask"]
            dead = mask | ~valid_l

            # --- entropy scores, global argmax (CIvm.cpp:366-431) ----------
            if noise.spherical:
                delta = -0.5 * jnp.log(
                    1.0 - carry["vs"][:, 0] * nu[:, 0] + 1e-300) * D
            else:
                delta = jnp.sum(
                    -0.5 * jnp.log(1.0 - carry["vs"] * nu + 1e-300), axis=1)
            delta = jnp.where(dead, -jnp.inf, delta)
            loc_arg = jnp.argmax(delta)
            loc_max = delta[loc_arg]
            maxs = lax.all_gather(loc_max, DATA_AXIS)          # (n_dev,)
            args = lax.all_gather(loc_arg + offset, DATA_AXIS)
            # first-max device + first-max within device ≡ global jnp.argmax
            ent_index = args[jnp.argmax(maxs)]

            # --- random pick over the globally index-ordered inactive set --
            r = rand_vals[k]
            inact_l = jnp.sum(~dead)
            counts = lax.all_gather(inact_l, DATA_AXIS)        # (n_dev,)
            n_inact = jnp.sum(counts)
            target = jnp.minimum(
                jnp.floor(r * n_inact), n_inact - 1).astype(jnp.int32)
            prev = jnp.sum(jnp.where(jnp.arange(n_dev) < dev, counts, 0))
            rank_l = jnp.cumsum(~dead) - 1 + prev
            hit = (rank_l == target) & ~dead
            cand = jnp.where(jnp.any(hit), jnp.argmax(hit) + offset, 0)
            rand_index = lax.psum(cand, DATA_AXIS).astype(jnp.int32)
            if spec.selection == ENTROPY:
                index = ent_index
            elif spec.selection == RANDOM:
                index = rand_index
            else:  # rentropy
                index = jnp.where(k == 0, rand_index, ent_index)

            # --- pull the selected row's quantities (owner-masked psums) ---
            li = jnp.clip(index - offset, 0, B - 1)
            own = (index >= offset) & (index < offset + B)
            ownc = own[None]                                    # broadcasting
            x_i = _psum_row(X_l[li], ownc)                      # (q,)
            y_i = _psum_row(y_l[li], ownc)                      # (D,)
            mu_i = _psum_row(carry["mu"][li], ownc)
            vs_i = _psum_row(carry["vs"][li], ownc)
            nu_i = _psum_row(nu[li], ownc)
            g_i = _psum_row(g[li], ownc)
            a = _psum_row(carry["M"][:, :, li], ownc[None])     # (C, d)

            # --- site update on the selected point (CIvm.cpp:283-298) ------
            m_row, beta_row = noise.update_sites(
                np_, mu_i[None, :], vs_i[None, :], y_i[None, :],
                nu_i[None, :], g_i[None, :])
            m_i, beta_i = m_row[0], beta_row[0]
            if not noise.log_concave:
                beta_i = jnp.where(beta_i < 0, 1e-6, beta_i)

            # --- local rank-1 updates (CIvm.cpp:302-365) -------------------
            k_col = kern.compute(kp, X_l, x_i[None, :])[:, 0]   # (B,)
            k_col = jnp.where(own & (jnp.arange(B) == li),
                              k_col + white, k_col)
            s_l = k_col[None, :] - jnp.einsum("cdb,cd->cb", carry["M"], a)
            sqrt_nu = jnp.sqrt(nu_i[jnp.asarray(cmap[:C])])     # (C,)
            M = lax.dynamic_update_index_in_dim(
                carry["M"], s_l * sqrt_nu[:, None], k, axis=1)

            s_out = s_l[cmap, :].T                              # (B, D)
            nu_out = nu_i[cmap]                                 # (D,)
            vs = carry["vs"] - (s_out ** 2) * nu_out[None, :]
            mu = carry["mu"] + g_i[None, :] * s_out

            mask = mask | (own & (jnp.arange(B) == li))
            idx = carry["idx"].at[k].set(index.astype(jnp.int32))
            m_site = carry["m_site"].at[k].set(m_i)
            beta_site = carry["beta_site"].at[k].set(beta_i)
            nu_new, g_new = noise.nu_g(np_, mu, vs, y_l)

            return dict(M=M, mu=mu, vs=vs, nu=nu_new, g=g_new,
                        m_site=m_site, beta_site=beta_site, mask=mask,
                        idx=idx), None

        final, _ = lax.scan(body, init, jnp.arange(d))
        return (final["idx"], final["mask"], final["m_site"],
                final["beta_site"], final["mu"], final["vs"], final["nu"],
                final["g"])

    sharded = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(), P(DATA_AXIS, None), P(DATA_AXIS, None),
                  P(DATA_AXIS), P()),
        out_specs=(P(), P(DATA_AXIS), P(), P(), P(DATA_AXIS, None),
                   P(DATA_AXIS, None), P(DATA_AXIS, None),
                   P(DATA_AXIS, None)),
        check_vma=False)

    def select(kp, noise_p, X_s, y_s, valid_s, rand_vals):
        idx, mask, m_site, beta_site, mu, vs, nu, g = sharded(
            jnp.asarray(kp), jnp.asarray(noise_p), X_s, y_s, valid_s,
            jnp.asarray(rand_vals))
        return IvmState(active_idx=idx, active_mask=mask, m_site=m_site,
                        beta_site=beta_site, mu=mu, varsigma=vs, nu=nu, g=g)

    return select


def dryrun(mesh: Mesh, n_devices: int) -> None:
    """Distributed IVM selection on tiny shapes vs the single-chip scan
    (used by __graft_entry__.dryrun_multichip)."""
    from gpc_tpu import kernels as K
    from gpc_tpu.models.ivm import select_points
    from gpc_tpu.noise import ProbitNoise
    from gpc_tpu.parallel.mesh import replicated, shard_rows

    N, q, d = 8 * n_devices, 2, 12
    rng = np.random.default_rng(7)
    X = rng.standard_normal((N, q))
    y = np.sign(rng.standard_normal((N, 1)))
    kern = K.Cmpnd(input_dim=q, components=(
        K.Rbf(input_dim=q), K.Bias(input_dim=q), K.White(input_dim=q)))
    noise = ProbitNoise(output_dim=1)
    spec = IvmSpec(kern=kern, noise=noise, n_data=N, input_dim=q,
                   output_dim=1, num_active=d, selection=ENTROPY)
    kp = jnp.asarray(kern.default_params())
    npar = jnp.asarray(noise.default_params(y))
    rv = jnp.zeros((d,))

    sel = jax.jit(make_select_points_dist(spec, mesh))
    st = sel(kp, npar, shard_rows(mesh, X), shard_rows(mesh, y),
             shard_rows(mesh, np.ones(N)), replicated(mesh, np.zeros(d)))
    ref = select_points(spec, kp, npar, X, y, rv)
    assert np.array_equal(np.asarray(st.active_idx),
                          np.asarray(ref.active_idx)), (
        np.asarray(st.active_idx), np.asarray(ref.active_idx))
    # f32 under the driver (x64 is test-conftest-only): reduction-order noise
    np.testing.assert_allclose(np.asarray(st.m_site), np.asarray(ref.m_site),
                               rtol=1e-5, atol=1e-6)
    print(f"dryrun_multichip({n_devices}): OK — distributed IVM selection "
          f"order ≡ single-chip ({d} points over {N} rows)")
