"""Weak-scaling measurement harness for the distributed GP evidence.

This harness measures time-per-evidence-evaluation for the sharded DTC
objective with N proportional to device count (weak scaling: constant
per-device rows).  It uses however many devices the backend exposes (the
cards of one host, or virtual CPU devices in tests), which exercises the
identical pjit/shard_map program and collectives.

Run: python -m gpc_tpu.parallel.scaling_bench [rows_per_device] [num_active]
Prints one JSON line per device count: {devices, n, t_ms, efficiency}.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import jax
import jax.numpy as jnp

from gpc_tpu import kernels as K
from gpc_tpu.models.gp import GP
from gpc_tpu.parallel.mesh import data_mesh, pad_rows, shard_rows
from gpc_tpu.parallel.dist_gp import make_dist_objective
from gpc_tpu.utils.profiling import time_fn


_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s32": 4, "u32": 4,
                "s64": 8, "u64": 8, "s8": 1, "u8": 1, "pred": 1, "c64": 8}


def collective_stats(fn, *args):
    """Static collective census of a jitted function's optimized HLO.

    Returns {op_name: {"count": n, "bytes": output_bytes_summed}} for every
    cross-device collective (all-gather / all-reduce / collective-permute /
    reduce-scatter / all-to-all).  Counts are STATIC occurrences — a
    collective inside a `while` body counts once; report the trip count
    alongside when the schedule loops (e.g. the n_dev panel sweeps of
    chol_distributed).  This is a checkable weak-scaling proxy that needs no
    cards: communication volume and collective mix are mesh-shape properties
    the virtual CPU mesh shares with a multi-card mesh."""
    import re

    txt = jax.jit(fn).lower(*args).compile().as_text()
    stats = {}
    # match the whole result-shape prefix, THEN extract every shape in it —
    # XLA's all-reduce combiner merges collectives into TUPLE-shaped ops
    # ("= (f32[8], f32[]) all-reduce(...)"), which a single-shape regex
    # silently skips (undercounting the census)
    # "-start" variants: accelerator post-optimization HLO wraps collectives
    # as async start/done pairs — count the starts (dropping them would
    # report an empty census on exactly the hardware this characterizes)
    line_pat = re.compile(
        r"=\s+(\([^)]*\)|\S+)\s+"
        r"(all-gather|all-reduce|collective-permute|reduce-scatter|"
        r"all-to-all)(?:-start)?\(")
    shape_pat = re.compile(r"(\w+)\[([\d,]*)\]")
    for shapes, op in line_pat.findall(txt):
        nbytes = 0
        for dtype, dims in shape_pat.findall(shapes):
            numel = 1
            for d in dims.split(","):
                if d:
                    numel *= int(d)
            nbytes += numel * _DTYPE_BYTES.get(dtype, 4)
        ent = stats.setdefault(op, {"count": 0, "bytes": 0})
        ent["count"] += 1
        ent["bytes"] += nbytes
    return stats


def weak_scaling_artifact(n_devices: int, rows_per_device: int = 128,
                          q: int = 4) -> dict:
    """One JSON-able weak-scaling proxy record for the round artifact:
    static collective census + analytic communication model of the
    distributed-Cholesky FTC evidence at N = rows_per_device · n_devices.

    Analytic model (parallel/chol_distributed.py): the factorization's only
    communication is one (N, B) panel all_gather per panel step × n_dev
    steps = N² elements per evidence; the forward-solve rides those panels
    for free.  The VJP adds backward panel sweeps ≈ 3× that volume."""
    from gpc_tpu.parallel.dist_ftc import make_dist_ftc_value_and_grad

    N = rows_per_device * n_devices
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, q))
    y = np.sin(X[:, :1])
    kern = K.Cmpnd(input_dim=q, components=(
        K.Rbf(input_dim=q), K.Bias(input_dim=q), K.White(input_dim=q)))
    model = GP(kern, X, y, approx="ftc", centre=True)
    mesh = data_mesh(n_devices)
    mask = np.ones(N)
    Xs, ys, ms = (shard_rows(mesh, a) for a in (X, y, mask))
    vag = make_dist_ftc_value_and_grad(model.spec, mesh, model.bias,
                                       model.fixed_scales, N)
    stats = collective_stats(vag, model.theta, Xs, ys, ms)
    dtype_bytes = 4 if model.theta.dtype == jnp.float32 else 8
    return {
        "weak_scaling_proxy": {
            "n_devices": n_devices,
            "n": N,
            "rows_per_device": rows_per_device,
            "program": "dist_ftc value+grad (chol_distributed panel sweeps)",
            "collectives_static": stats,
            "panel_trip_count": n_devices,
            "analytic_allgather_elems_per_forward": N * N,
            "analytic_bytes_per_forward": N * N * dtype_bytes,
            "analytic_bytes_per_value_and_grad": 4 * N * N * dtype_bytes,
            "note": ("collectives inside the panel while-loop count once "
                     "statically and execute panel_trip_count times; "
                     "communication volume scales as N^2 = (rows_per_device"
                     "*n_devices)^2 while per-device compute scales as "
                     "N^3/n_devices - the comm:compute ratio falls as "
                     "3/rows_per_device"),
        },
        "iterative_weak_scaling_proxy": _iterative_proxy(
            n_devices, rows_per_device, q, kern, model, mesh, Xs, ys, ms),
    }


def _iterative_proxy(n_devices, rows_per_device, q, kern, model, mesh,
                     Xs, ys, ms):
    """Collective census for the round-5 sharded matrix-free engine
    (parallel/dist_iterative): per MVM the only communication is ONE
    (N/P, D') result all_gather (O(N·D') bytes) against O(N²·/P) local
    FLOPs — the comm:compute ratio falls as P/N, far below the dense
    panel sweep's, so the matrix-free path weak-scales at least as well."""
    from gpc_tpu.ops.iterative import IterConfig
    from gpc_tpu.parallel.dist_iterative import dist_iterative_nlml

    N = rows_per_device * n_devices
    cfg = IterConfig(block=max(rows_per_device // 2, 16), probes=2,
                     lanczos_iters=8, cg_iters=20, trace_probes=2, seed=0)
    nlml = dist_iterative_nlml(kern, mesh, model.bias, model.fixed_scales,
                               N, cfg)
    stats = collective_stats(
        lambda t, X_, y_, m_: jax.value_and_grad(nlml)(t, X_, y_, m_),
        model.theta, Xs, ys, ms)
    return {
        "program": "dist_iterative value+grad (row-sharded CG+SLQ)",
        "collectives_static": stats,
        "mvm_allgather_elems": N,
        "note": ("one (N/P, D') all_gather per MVM; MVMs execute "
                 "cg_iters + probes*lanczos_iters times per evidence; "
                 "comm:compute falls as n_devices/N"),
    }


def run(rows_per_device: int = 2048, num_active: int = 256, q: int = 8,
        device_counts=None):
    all_devs = len(jax.devices())
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= all_devs]
    rng = np.random.default_rng(0)
    results = []
    t1 = None
    for nd in device_counts:
        N = rows_per_device * nd
        X = rng.standard_normal((N, q))
        y = np.sin(X[:, :1])
        kern = K.Cmpnd(input_dim=q, components=(
            K.Rbf(input_dim=q), K.Bias(input_dim=q), K.White(input_dim=q)))
        model = GP(kern, X, y, approx="dtc", num_active=num_active,
                   centre=True, seed=0)
        mesh = data_mesh(nd)
        Xp, _ = pad_rows(X, nd)
        yp, _ = pad_rows(y, nd)
        mask = np.ones(Xp.shape[0])
        mask[N:] = 0.0
        Xs, ys, ms = (shard_rows(mesh, a) for a in (Xp, yp, mask))
        nlml = jax.jit(jax.value_and_grad(make_dist_objective(
            model.spec, mesh, model.bias, model.fixed_scales, N)))
        reps = 5
        t = time_fn(nlml, model.theta, Xs, ys, ms, reps=reps)
        if t1 is None:
            t1 = t
        eff = t1 / t  # weak scaling: ideal is equal time per step
        results.append(dict(devices=nd, n=N, t_ms=round(t * 1e3, 2),
                            efficiency=round(eff, 4)))
        print(json.dumps(results[-1]))
    return results


if __name__ == "__main__":
    rpd = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
    na = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    run(rpd, na)
