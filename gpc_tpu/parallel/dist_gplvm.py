"""Distributed GP-LVM / GPDM training step — latent rows sharded with the
evidence.

The reference GP-LVM is explicitly capped at ~1k points (no sparsification in
the C++ GP-LVM, /root/reference/README.md:412-414).  This module removes the
wall by sharding: the latent coordinates live in the replicated θ vector
(CGplvm's own layout, CGplvm.cpp:257-330), each device builds the Gram ROWS
for its slice of latent points, and the row-sharded evidence runs through
`parallel.chol_distributed.evidence_distributed`, whose custom VJP returns
the row-sharded cotangent — so one `jax.value_and_grad` yields ∂NLML/∂θ
including all N·q latent gradients, with no N×N object on any device.

Full GPDM support (round 3):
  * dynamics (/root/reference/CGplvm.cpp:448-489): the dynamics Gram is over
    the SAME sharded latent rows — a second row-sharded distributed evidence
    with the sequence-break rows/cols knocked to identity per shard, and the
    up-shifted Xout (break rows zeroed, CGplvm.cpp:231-243) as its replicated
    RHS; the shift term −Pᵀ·invDynK·Xout of the reference's hand gradient
    (CGplvm.cpp:643-658) falls out of the evidence VJP's m̄ cotangent;
  * back constraints X = bK·A (/root/reference/CGplvm.cpp:683-701): bK is
    row-sharded with the data, each device computes its X rows as one local
    (N/P, N)×(N, q) GEMM and the full X is one small all_gather; the chain
    rule g_A = bKᵀ·g_X is jax.grad through that GEMM — bK never exists
    whole on any device.

Like the other distributed paths, non-PD transients yield NaN objectives
that SCG rejects (no jitter escalation inside the panel sweep).  N must
divide the device count (pad data AND latent init together if needed).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from gpc_tpu import priors as priors_mod
from gpc_tpu.models.gplvm import GplvmSpec, _xout
from gpc_tpu.parallel.chol_distributed import evidence_distributed
from gpc_tpu.parallel.mesh import DATA_AXIS


def make_dist_gplvm_value_and_grad(spec: GplvmSpec, mesh: Mesh, noise_bias,
                                   fixed_scales, dyn_params_fixed=None):
    """Returns vag(theta, y_sharded[, bK_sharded]) → (nlml, dnlml/dθ) — the
    distributed CGplvm::logLikelihood(Gradient) (CGplvm.cpp:493-716),
    covering plain, dynamics (GPDM), and back-constrained models.

    When spec.back_constrained the returned vag takes a third argument: the
    back-constraint kernel matrix bK, row-sharded over the mesh;
    `dyn_params_fixed` is required iff spec.has_dynamics and not
    spec.dyn_kern_learnt."""
    n_dev = mesh.shape[DATA_AXIS]
    N, D, q = spec.n_data, spec.data_dim, spec.latent_dim
    assert N % n_dev == 0, "n_data must divide the device count"
    B = N // n_dev
    noise_bias = jnp.asarray(noise_bias)
    fixed_scales = jnp.asarray(fixed_scales)
    dpf = (jnp.asarray(dyn_params_fixed)
           if dyn_params_fixed is not None else None)
    br = jnp.asarray(spec.break_rows()) if spec.has_dynamics else None

    def build_local(theta, y_l, bK_l):
        kp, dp, Xvals, scales = spec.unpack(theta)
        scales_ = scales if spec.learn_scales else fixed_scales
        d = lax.axis_index(DATA_AXIS)
        zero = jnp.zeros((), jnp.int32)
        if spec.back_constrained:
            # X = bK·A, one local row-block GEMM + a small all_gather
            X_l = bK_l @ Xvals
            X = lax.all_gather(X_l, DATA_AXIS, tiled=True)
        else:
            X_l = lax.dynamic_slice(Xvals, (d * B, zero), (B, q))
            X = Xvals
        rows_g = d * B + jnp.arange(B)
        own = jnp.arange(N)[None, :] == rows_g[:, None]

        K_rows = spec.kern.compute(kp, X_l, X)
        # gram() diagonal discipline: diag(p, X) overwrites the compute diag
        K_rows = jnp.where(own, spec.kern.diag(kp, X_l)[:, None], K_rows)
        m_l = (y_l - noise_bias[None, :]) / scales_[None, :]
        if not spec.has_dynamics:
            return K_rows, m_l, X_l
        dp_ = dp if dp is not None else dpf
        K2 = spec.dyn_kern.compute(dp_, X_l, X)
        K2 = jnp.where(own, spec.dyn_kern.diag(dp_, X_l)[:, None], K2)
        # break rows/cols → identity (CGplvm.cpp:448-477), per shard
        isbr_r = jnp.isin(rows_g, br)[:, None]
        isbr_c = jnp.isin(jnp.arange(N), br)[None, :]
        K2 = jnp.where(isbr_r | isbr_c, 0.0, K2)
        K2 = jnp.where(isbr_r & own, 1.0, K2)
        return K_rows, m_l, X_l, K2

    n_out = 4 if spec.has_dynamics else 3
    build = jax.shard_map(
        build_local, mesh=mesh,
        in_specs=(P(), P(DATA_AXIS, None),
                  P(DATA_AXIS, None) if spec.back_constrained else P()),
        out_specs=(P(DATA_AXIS, None),) * n_out, check_vma=False)

    def nlml(theta, y, bK=None):
        bK_arg = bK if bK is not None else jnp.zeros((), theta.dtype)
        outs = build(theta, y, bK_arg)
        K_rows, m_rows, X = outs[0], outs[1], outs[2]
        logdet, quad = evidence_distributed(mesh, K_rows, m_rows)
        kp, dp, Xvals, scales = spec.unpack(theta)
        scales_ = scales if spec.learn_scales else fixed_scales
        Lacc = quad + D * logdet
        if spec.has_dynamics:
            Xout = _xout(spec, X)
            ld2, quad2 = evidence_distributed(mesh, outs[3], Xout)
            s = spec.dynamic_scaling
            Lacc = Lacc + s * (quad2 + q * ld2)
            if spec.latent_regularised:
                # dynamics regularises column 0 only (CGplvm.cpp:530-534)
                Lacc = Lacc + jnp.sum(X[:, 0] ** 2)
        elif spec.latent_regularised:
            Lacc = Lacc + jnp.sum(X * X)
        if spec.learn_scales:
            Lacc = Lacc + 2.0 * jnp.sum(jnp.log(jnp.abs(scales_)))
        L = -0.5 * Lacc
        L = L + priors_mod.total_log_prob(spec.kern.priors_global, kp)
        if spec.has_dynamics and spec.dyn_kern_learnt:
            L = L + priors_mod.total_log_prob(spec.dyn_kern.priors_global, dp)
        # no 2π constant — CGplvm quirk, must match models/gplvm.py
        return -L

    if spec.back_constrained:
        def vag(theta, y, bK):
            return jax.value_and_grad(nlml)(theta, y, bK)
        return vag

    def vag(theta, y):
        return jax.value_and_grad(nlml)(theta, y)
    return vag


def _check_case(mesh, n_devices, model, tag, bK=None, rtol=2e-3, atol=5e-4):
    # smoke tolerances: the driver dryrun runs f32 (reduction-order noise
    # through two chained evidences); exact f64 parity is pinned in
    # tests/test_dist_gplvm.py
    from gpc_tpu.models.gplvm import log_likelihood
    from gpc_tpu.parallel.mesh import shard_rows

    vag = jax.jit(make_dist_gplvm_value_and_grad(
        model.spec, mesh, model.noise_bias, model.fixed_scales,
        dyn_params_fixed=model.dyn_params_fixed))
    ys = shard_rows(mesh, jnp.asarray(model.y))
    args = (model.theta, ys)
    if bK is not None:
        args += (shard_rows(mesh, jnp.asarray(bK)),)
    val, grad = vag(*args)

    def single(t):
        return -log_likelihood(
            model.spec, t, model.y, model.noise_bias, model.fixed_scales,
            dyn_params_fixed=model.dyn_params_fixed,
            bK=None if bK is None else jnp.asarray(bK))
    want = float(single(model.theta))
    assert abs(float(val) - want) / max(abs(want), 1.0) < 1e-4, (
        tag, float(val), want)
    g_single = np.asarray(jax.grad(single)(model.theta))
    # atol covers f32 reduction-order noise on near-zero latent gradients
    np.testing.assert_allclose(np.asarray(grad), g_single, rtol=rtol,
                               atol=atol, err_msg=tag)
    print(f"dryrun_multichip({n_devices}): OK — distributed GP-LVM [{tag}] "
          f"value+grad {float(val):.6f} matches single-chip {want:.6f}")


def dryrun(mesh: Mesh, n_devices: int) -> None:
    """Distributed GP-LVM value+grad on tiny shapes vs the single-chip
    objective — plain, GPDM dynamics, and back-constrained cases
    (used by __graft_entry__.dryrun_multichip)."""
    from gpc_tpu import kernels as K
    from gpc_tpu.models.gplvm import GPLVM

    N, D, q = 8 * n_devices, 3, 2
    rng = np.random.default_rng(4)
    y = rng.standard_normal((N, D))
    kern = K.Cmpnd(input_dim=q, components=(
        K.Rbf(input_dim=q), K.Bias(input_dim=q), K.White(input_dim=q)))
    _check_case(mesh, n_devices, GPLVM(kern, y, latent_dim=q), "plain")

    dyn = K.Cmpnd(input_dim=q, components=(
        K.Rbf(input_dim=q), K.White(input_dim=q)))
    model_dyn = GPLVM(kern, y, latent_dim=q, dyn_kern=dyn,
                      dyn_breaks=(0, N // 2))
    _check_case(mesh, n_devices, model_dyn, "dynamics")

    back = K.Rbf(input_dim=D)
    bK = np.asarray(back.gram(jnp.asarray(back.default_params()),
                              jnp.asarray(y)))
    bK = bK + 1e-4 * np.eye(N)
    model_bc = GPLVM(kern, y, latent_dim=q, back_kernel_matrix=bK)
    _check_case(mesh, n_devices, model_bc, "back-constrained", bK=bK)
