"""Row-sharded matrix-free evidence: distributed kernel MVM + CG + SLQ.

The matrix-free engine (ops/iterative.py — BBMM-style CG quad + SLQ logdet)
alone is capped at one card's memory and FLOPs.  This module row-shards the
kernel MVM over the "dp" mesh so the ceiling multiplies by the mesh size with
zero new math:

  * each device holds a row block X_l (N/P, q) and computes its rows of
    K·V — the O(N²·block) GEMM work — against the all-gathered X;
  * one `all_gather` of the (N/P, D′) partial result per MVM reassembles
    the replicated vector (O(N·D′) bytes — negligible next to the local
    O(N²/P) FLOPs, and it rides the interconnect);
  * CG/Lanczos vector arithmetic runs REPLICATED on every device from the
    mesh-deterministic gathered results (the same replicated-scalar
    discipline as the SCG trajectory, parallel/mesh.py), so the iteration
    is bit-identical across devices;
  * padded rows (sharding needs equal blocks) are masked to the identity:
    the operator is mask·K·mask + (I − mask), whose pad eigenvalues are
    exactly 1 — they add 0 to logdet and nothing to the quad.

Training: same custom-VJP shape as ops/iterative (quad/trace cotangents as
blockwise-rematerialized contractions), with the backward contraction
computed LOCALLY per device and psum-reduced; jax.grad flows through the
shard_map from outside (the dist_gp.py pattern).

The reference dead-ends at dense O(N²) single-process memory
(/root/reference/CGp.cpp:877-909, README.md:412-414); this is the N ≫ 65k
story: per-device memory O(N·(block + D′)/1) and per-device compute
O(N²·/P) per MVM.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from gpc_tpu.kernels import Kern
from gpc_tpu.ops.iterative import (IterConfig, cg_solve, iter_config,
                                   pcg_solve, pivoted_cholesky_masked,
                                   slq_logdet, woodbury_preconditioner)
from gpc_tpu.parallel.mesh import DATA_AXIS


def _rows_mvm(kern: Kern, p, Xrows, Xfull, V, block: int):
    """This device's rows of (white-free) K·V: blockwise cross tiles against
    the full X, rematerialized under checkpoint (the kernel_mvm discipline,
    ops/iterative.py:28-46)."""
    nl = Xrows.shape[0]
    nb = -(-nl // block)
    pad = nb * block - nl
    Xp = jnp.pad(Xrows, ((0, pad), (0, 0)))
    blocks = Xp.reshape(nb, block, Xrows.shape[1])

    @jax.checkpoint
    def one(Xb):
        return kern.compute(p, Xb, Xfull) @ V

    return lax.map(one, blocks).reshape(nb * block, V.shape[1])[:nl]


def _local_mvm_fn(kern: Kern, p, Xl, maskl, block: int):
    """Builds V ↦ all_gather(local rows of (mask·K·mask + (I−mask))·V):
    the replicated-in/replicated-out distributed MVM."""
    nl = Xl.shape[0]
    i = lax.axis_index(DATA_AXIS)
    Xg = lax.all_gather(Xl, DATA_AXIS, tiled=True)
    maskg = lax.all_gather(maskl, DATA_AXIS, tiled=True)
    white = kern.white(p)

    def mvm(V):
        Vm = V * maskg[:, None]
        Vl = lax.dynamic_slice_in_dim(Vm, i * nl, nl)
        out_l = _rows_mvm(kern, p, Xl, Xg, Vm, block) + white * Vl
        out_l = out_l * maskl[:, None]
        out_l = out_l + (1.0 - maskl[:, None]) * lax.dynamic_slice_in_dim(
            V, i * nl, nl)
        return lax.all_gather(out_l, DATA_AXIS, tiled=True)

    return mvm


def make_dist_iterative_evidence(kern: Kern, mesh: Mesh,
                                 cfg: IterConfig | None = None):
    """Returns evidence(p, Xs, ms, masks) → (logdet, quad) with X/m/mask
    row-sharded over 'dp' — the distributed twin of
    ops.iterative.kern_evidence_iterative (same fixed-probe estimator, same
    seed semantics, so single-chip and distributed agree to CG tolerance;
    pinned in tests/test_dist_iterative.py).  Differentiable in (p, Xs, ms)
    through a custom VJP whose contractions are computed locally and
    psum-reduced."""
    if cfg is None:
        cfg = iter_config()

    def local_fwd(p, Xl, ml, maskl):
        mvm = _local_mvm_fn(kern, p, Xl, maskl, cfg.block)
        mg = lax.all_gather(ml, DATA_AXIS, tiled=True)
        N = mg.shape[0]
        D = mg.shape[1]
        key = jax.random.PRNGKey(cfg.seed)
        k_tr, k_slq = jax.random.split(jax.random.fold_in(key, N))
        Z = jax.random.rademacher(k_tr, (N, cfg.trace_probes), dtype=Xl.dtype)
        B = jnp.concatenate([mg, Z], axis=1)
        if cfg.precond_rank > 0:
            # pivoted-Cholesky/Woodbury preconditioner (required at large
            # N / small white variance — ops/iterative.py), built on the
            # gathered X REPLICATED (the greedy pivot scan is inherently
            # sequential; O(N·k) memory, identical on every device so the
            # PCG trajectory stays mesh-deterministic).  Pad rows are
            # masked out of the pivot pool and of Lk, and the solve acts
            # as the identity there — matching the masked operator.
            Xg = lax.all_gather(Xl, DATA_AXIS, tiled=True)
            maskg = lax.all_gather(maskl, DATA_AXIS, tiled=True)
            Lk = pivoted_cholesky_masked(kern, p, Xg, maskg,
                                         cfg.precond_rank)
            wsolve = woodbury_preconditioner(Lk, kern.white(p) + 1e-8)

            def pre(R):
                Rs = wsolve(R * maskg[:, None]) * maskg[:, None]
                return Rs + (1.0 - maskg[:, None]) * R

            sols = pcg_solve(mvm, B, pre, max_iters=cfg.cg_iters).x
        else:
            sols = cg_solve(mvm, B, max_iters=cfg.cg_iters).x
        alpha, W = sols[:, :D], sols[:, D:]
        quad = jnp.sum(mg * alpha)
        logdet = slq_logdet(mvm, N, k_slq, probes=cfg.probes,
                            lanczos_iters=cfg.lanczos_iters, dtype=Xl.dtype)
        return logdet, quad, alpha, W

    fwd_sm = jax.shard_map(
        local_fwd, mesh=mesh,
        in_specs=(P(), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=(P(), P(), P(), P()), check_vma=False)

    def local_contract(p, Xl, maskl, alpha, W, Z, g_ld, g_quad):
        """psum(g_ld·tr̂ − g_quad·αᵀKα) contribution of this device's rows —
        the identity part of the masked operator is θ/X-independent and
        drops out of the contraction."""
        nl = Xl.shape[0]
        i = lax.axis_index(DATA_AXIS)
        Xg = lax.all_gather(Xl, DATA_AXIS, tiled=True)
        maskg = lax.all_gather(maskl, DATA_AXIS, tiled=True)
        D = alpha.shape[1]
        V = jnp.concatenate([alpha, Z], axis=1) * maskg[:, None]
        Vl = lax.dynamic_slice_in_dim(V, i * nl, nl)
        out_l = (_rows_mvm(kern, p, Xl, Xg, V, cfg.block)
                 + kern.white(p) * Vl) * maskl[:, None]
        al = lax.dynamic_slice_in_dim(alpha, i * nl, nl)
        Wl = lax.dynamic_slice_in_dim(W, i * nl, nl)
        s_q = jnp.sum(al * out_l[:, :D])
        s_tr = jnp.sum(Wl * out_l[:, D:])
        return lax.psum(g_ld * s_tr / cfg.trace_probes - g_quad * s_q,
                        DATA_AXIS)

    contract_sm = jax.shard_map(
        local_contract, mesh=mesh,
        in_specs=(P(), P(DATA_AXIS), P(DATA_AXIS), P(), P(), P(), P(), P()),
        out_specs=P(), check_vma=False)

    @jax.custom_vjp
    def evidence(p, Xs, ms, masks):
        logdet, quad, _a, _w = fwd_sm(p, Xs, ms, masks)
        return logdet, quad

    def evidence_fwd(p, Xs, ms, masks):
        logdet, quad, alpha, W = fwd_sm(p, Xs, ms, masks)
        return (logdet, quad), (p, Xs, ms, masks, alpha, W)

    def evidence_bwd(res, cots):
        p, Xs, ms, masks, alpha, W = res
        g_ld, g_quad = cots
        alpha = lax.stop_gradient(alpha)
        W = lax.stop_gradient(W)
        N = alpha.shape[0]
        key = jax.random.PRNGKey(cfg.seed)
        k_tr, _ = jax.random.split(jax.random.fold_in(key, N))
        Z = jax.random.rademacher(k_tr, (N, cfg.trace_probes),
                                  dtype=alpha.dtype)
        pbar, Xbar = jax.grad(
            lambda p_, X_: contract_sm(p_, X_, masks, alpha, W, Z,
                                       g_ld, g_quad),
            argnums=(0, 1))(p, Xs)
        # m̄ = 2·g_quad·α, delivered against the sharded m layout (pad rows
        # of α are exactly 0 because mask·B keeps CG inactive there)
        mbar = 2.0 * g_quad * alpha
        return pbar, Xbar, mbar, None

    evidence.defvjp(evidence_fwd, evidence_bwd)
    return evidence


def dist_iterative_nlml(kern: Kern, mesh: Mesh, bias, fixed_scales,
                        n_valid: int, cfg: IterConfig | None = None):
    """nlml(theta, Xs, ys, masks) for a distributed FTC GP over the
    matrix-free engine — the N ≫ 65k training objective.  theta layout is
    the single-chip GpSpec FTC layout (kernel transParams only), so
    parameters move freely between paths."""
    from gpc_tpu import ndlutil
    from gpc_tpu import priors as priors_mod
    from gpc_tpu import transforms as tr

    bias = jnp.asarray(bias)
    fixed_scales = jnp.asarray(fixed_scales)
    if cfg is None:
        cfg = iter_config()
    evidence = make_dist_iterative_evidence(kern, mesh, cfg)
    codes = kern.transform_codes()

    def nlml(theta, Xs, ys, masks):
        kp = tr.apply_atox(codes, theta)
        ms = (ys - bias[None, :]) / fixed_scales[None, :] * masks[:, None]
        logdet, quad = evidence(kp, Xs, ms, masks)
        D = ys.shape[1]
        L = -0.5 * (quad + D * logdet)
        L = L + priors_mod.total_log_prob(kern.priors_global, kp)
        L = L - D * n_valid * ndlutil.HALFLOGTWOPI
        return -L

    return nlml
