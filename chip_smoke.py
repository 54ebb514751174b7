#!/usr/bin/env python3
"""Bring-up smoke run: gp / gplvm / ivm training and serving on one GPU.

Drives the main path once through the entry points a user calls — the
`gpc_tpu.cli.{gp,gplvm,ivm}.main(argv)` tools, run in this one process the
way cli/daemon.py runs them, and `serving.GPServer` — at full width, and
checks each result against a plain float64 reference that shares no code
with gpc_tpu/ops or gpc_tpu/linalg: the Gram built from the kernel formula,
then `cholesky` and triangular solves, run on the card under scoped x64.

    python chip_smoke.py               # one GPU: phases 1-6
    python chip_smoke.py --devices 4   # four GPUs: the sharded paths only

Phases on one GPU:
  1 device    the card, JAX, XLA_FLAGS, nvidia-smi, and what each f32 matmul
              precision setting computes
  2 ftc       `gp learn -# 5`, N=16384, q=8, rbf+bias+white
  3 serving   GPServer on the phase-2 model, batches of 4096, 1000 and 1
  4 dtc       `gp learn -A dtc -a 1024 -# 5` on the phase-2 data
  5 gplvm     `gplvm learn -# 3`, N=16384, D=4, q=2
  6 ivm       `ivm learn -a 512`, N=4096 two-class data with 2 inputs
With --devices 4: the sharded FTC value+grad (parallel/dist_ftc, the sharded
Cholesky), a sharded DTC value+grad (parallel/dist_gp) and sharded IVM
selection (parallel/dist_ivm), each against the single-card result.

Data is generated from --seed into a temporary directory as SVM-light files.
Times printed here are smoke timings of one cold process, compilation
included — not benchmark numbers.  With no GPU, or when any phase fails, the
script exits non-zero and prints no result line; otherwise its last line is
one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import tempfile
import time

import numpy as np

LOG2PI = math.log(2.0 * math.pi)

# Drift tolerances, each relative, each with its reason:
#  * NLML 1e-5: f32 evaluation of an N=16k evidence accumulates rounding
#    over N log-diagonal terms and an N-long solve; 1e-5 is ~100 f32 ulps,
#    far below any change SCG acts on.
#  * GP-LVM NLML 5e-5: the f32 Cholesky's log-diagonal dominates the drift.
#    Each L_jj² is K_jj minus a sum of j squares that nearly cancels it
#    (16k latent points in 2-D make K smooth, so K_jj/L_jj² is large); at
#    N=4096 on the CPU the f32 factorization of the exact float64 Gram
#    gives 2.4e-6 of the 2.9e-6 drift, the f32 Gram build 3e-7, and on an
#    H100 at N=16384 the drift is 1.7e-5 (PERF.md).  A tighter bound needs
#    more than f32 arithmetic in the factorization.
#  * gradient 1e-3 (norm of the difference over the norm): the gradient
#    goes through a second factorization-sized solve and is only used for a
#    search direction.
#  * serving mean and variance 1e-4 of their largest magnitude: a
#    prediction is one more solve against the same factor as the NLML.
#  * IVM: the first pick that differs from the reference must be an f32
#    tie — its entropy gap below 1e-3 of the best entropy change at that
#    step, which has by then been through k rank-one f32 updates.
#  * matmul: the precision the library runs at ("highest" by default,
#    gpc_tpu/__init__.py) must give f32 accuracy, 1e-5 relative.
TOL = dict(nlml=1e-5, gplvm_nlml=5e-5, grad=1e-3, mean=1e-4, var=1e-4,
           ivm_gap=1e-3, matmul=1e-5)


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Problem sizes: the defaults are the full-width smoke run; the CPU
    tests call the phases with tiny ones."""

    n_ftc: int = 16384
    q_ftc: int = 8
    ftc_iters: int = 5
    serve_batches: tuple = (4096, 1000, 1)
    dtc_active: int = 1024
    dtc_iters: int = 5
    n_gplvm: int = 16384
    d_gplvm: int = 4
    q_gplvm: int = 2
    gplvm_iters: int = 3
    n_ivm: int = 4096
    ivm_active: int = 512
    ivm_ext_iters: int = 1
    ivm_kern_iters: int = 5
    ivm_noise_iters: int = 3
    multi_devices: int = 4


class CompileClock:
    """Sums JAX's trace/lower/compile event durations, so each phase can
    report its compile time beside its wall time."""

    def __init__(self):
        self.seconds = 0.0

    def install(self):
        import jax.monitoring

        def on_duration(event, duration, **_kw):
            if event.startswith("/jax/core/compile/"):
                self.seconds += duration

        jax.monitoring.register_event_duration_secs_listener(on_duration)
        return self


@dataclasses.dataclass
class Context:
    tmp: str
    seed: int
    sizes: Sizes
    models: dict = dataclasses.field(default_factory=dict)

    def say(self, tag, msg):
        print(f"[{tag}] {msg}", flush=True)


# --------------------------------------------------------------- device ---


def matmul_precision_probe(n=2048, seed=0):
    """Relative error of an f32 (n×n)·(n×n) product at each precision
    setting against float64: 'highest' is full f32 (~1e-7); a TF32 product
    (10-bit mantissa) shows ~1e-4..1e-3; a bf16 product ~1e-2."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)).astype(np.float32)
    B = rng.standard_normal((n, n)).astype(np.float32)
    want = A.astype(np.float64) @ B.astype(np.float64)
    scale = np.abs(want).max()
    errs = {}
    for prec in ("default", "high", "highest"):
        f = jax.jit(lambda a, b, p=prec: jnp.matmul(a, b, precision=p))
        got = np.asarray(f(A, B), np.float64)
        errs[prec] = float(np.abs(got - want).max() / scale)
    got = np.asarray(jax.jit(jnp.matmul)(A, B), np.float64)
    errs["library default"] = float(np.abs(got - want).max() / scale)
    return errs


def phase_device(ctx):
    import jax
    from gpc_tpu.utils.profiling import device_record
    rec = device_record()
    ctx.say("device", f"platform {rec['platform']}, device_kind "
                      f"{rec['kind']}, count {rec['count']}")
    ctx.say("device", f"jax {jax.__version__}, XLA_FLAGS="
                      f"{os.environ.get('XLA_FLAGS', '')!r}")
    prec = jax.config.jax_default_matmul_precision
    errs = matmul_precision_probe()
    for k, v in errs.items():
        ctx.say("device", f"f32 matmul at precision {k!r}: relative error "
                          f"{v:.3e} vs float64")
    return [("matmul rel err at the library default "
             f"({prec})", errs["library default"], TOL["matmul"])]


# ----------------------------------------------------------------- data ---


def regression_data(seed, n, q):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, q))
    y = np.sin(X[:, :1]) + 0.5 * np.cos(X[:, 1:2]) \
        + 0.1 * rng.standard_normal((n, 1))
    return X, y


def latent_data(seed, n, d, q):
    """tanh of a random linear map of q latent dims, plus noise."""
    rng = np.random.default_rng(seed)
    Z = rng.standard_normal((n, q))
    W = rng.standard_normal((q, d))
    return np.tanh(Z @ W) + 0.1 * rng.standard_normal((n, d))


def class_data(seed, n):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 2))
    f = np.sin(2.0 * X[:, :1]) + X[:, 1:2] + 0.3 * rng.standard_normal((n, 1))
    return X, np.where(f > 0, 1.0, -1.0)


def write_data(ctx, name, X, y):
    from gpc_tpu.io.svml import write_svml
    path = os.path.join(ctx.tmp, name + ".svml")
    write_svml(path, X, y)
    return path


def run_cli(tool, argv):
    """One CLI command in this process, as cli/daemon.py runs it."""
    import importlib
    mod = importlib.import_module(f"gpc_tpu.cli.{tool}")
    try:
        mod.main(list(argv))
    except SystemExit as e:  # the tools exit through ExitError
        if e.code:
            raise RuntimeError(f"{tool} {' '.join(argv)}: {e.code}") from e


# ------------------------------------------------------------ reference ---
# Plain float64 formulas: Gram from the kernel formula, cholesky, triangular
# solves.  Only the parameter layout (spec.unpack, the model's θ → kernel
# parameters map) is shared with the system under test.


def _kern_params(kern, kp):
    """(inverse width, rbf variance, bias variance, white variance) of the
    cmpnd(rbf, bias, white) kernel every phase trains."""
    kinds = [c.kind for c in kern.components]
    if kinds != ["rbf", "bias", "white"]:
        raise ValueError(f"reference covers rbf+bias+white, got {kinds}")
    if kern.priors_global:
        raise ValueError("reference covers kernels without priors")
    return kp[0], kp[1], kp[2], kp[3]


def ref_cross(kern, kp, X1, X2):
    """rbf + bias cross-covariance (white is zero off the diagonal)."""
    import jax.numpy as jnp
    g, v, b, _w = _kern_params(kern, kp)
    d2 = (jnp.sum(X1 * X1, 1)[:, None] + jnp.sum(X2 * X2, 1)[None, :]
          - 2.0 * X1 @ X2.T)
    return v * jnp.exp(-0.5 * g * jnp.maximum(d2, 0.0)) + b


def ref_gram(kern, kp, X):
    import jax.numpy as jnp
    return ref_cross(kern, kp, X, X) + _kern_params(kern, kp)[3] * jnp.eye(
        X.shape[0], dtype=X.dtype)


def _gauss_nlml(C, m):
    """−log N(m; 0, C) summed over the columns of m."""
    import jax.numpy as jnp
    from jax.scipy.linalg import solve_triangular
    L = jnp.linalg.cholesky(C)
    a = solve_triangular(L, m, lower=True)
    N, D = m.shape
    return (0.5 * jnp.sum(a * a) + D * jnp.sum(jnp.log(jnp.diagonal(L)))
            + 0.5 * D * N * LOG2PI)


def ref_gp_nlml(spec, theta, X, y, bias, scales):
    """FTC or DTC negative log marginal likelihood of a GP (models/gp.py
    semantics: targets m = (y − bias)/scale), as a dense N×N Gaussian."""
    import jax.numpy as jnp
    from jax.scipy.linalg import solve_triangular
    X_u, kp, _s, beta = spec.unpack(theta)
    m = (y - bias[None, :]) / scales[None, :]
    if spec.approx == "ftc":
        C = ref_gram(spec.kern, kp, X)
    elif spec.approx == "dtc":
        # Q + I/β with Q = K_fu K_uu⁻¹ K_uf
        Luu = jnp.linalg.cholesky(ref_gram(spec.kern, kp, X_u))
        V = solve_triangular(Luu, ref_cross(spec.kern, kp, X_u, X),
                             lower=True)
        C = V.T @ V + jnp.eye(X.shape[0], dtype=X.dtype) / beta
    else:
        raise ValueError(spec.approx)
    return _gauss_nlml(C, m)


def ref_gplvm_nlml(spec, theta, y, bias, scales):
    """GP-LVM negative log likelihood (models/gplvm.py semantics: no
    N·D/2·log 2π term, ½ΣX² latent regulariser)."""
    import jax.numpy as jnp
    if spec.has_dynamics or spec.back_constrained or spec.learn_scales:
        raise ValueError("reference covers the plain GP-LVM")
    kp, _dp, X, _s = spec.unpack(theta)
    m = (y - bias[None, :]) / scales[None, :]
    N, D = m.shape
    nl = _gauss_nlml(ref_gram(spec.kern, kp, X), m) - 0.5 * D * N * LOG2PI
    if spec.latent_regularised:
        nl = nl + 0.5 * jnp.sum(X * X)
    return nl


def ref_posterior(spec, theta, X, y, bias, scales, Xt):
    """FTC predictive mean and variance (models/gp.posterior semantics)."""
    import jax.numpy as jnp
    from jax.scipy.linalg import solve_triangular
    _, kp, _s, _b = spec.unpack(theta)
    m = (y - bias[None, :]) / scales[None, :]
    L = jnp.linalg.cholesky(ref_gram(spec.kern, kp, X))
    Ks = ref_cross(spec.kern, kp, X, Xt)
    alpha = solve_triangular(L.T, solve_triangular(L, m, lower=True),
                             lower=False)
    v = solve_triangular(L, Ks, lower=True)
    g, var_rbf, b, w = _kern_params(spec.kern, kp)
    var = jnp.maximum(var_rbf + b + w - jnp.sum(v * v, axis=0), 0.0)
    return (Ks.T @ alpha * scales[None, :] + bias[None, :],
            var[:, None] * (scales ** 2)[None, :])


def as_f64(a):
    """The float32 values the system saw, widened to float64."""
    return np.asarray(np.asarray(a, np.float32), np.float64)


def ref_value_and_grad(f, theta, *args):
    """f64 value and gradient of a reference objective on the card."""
    import jax
    import jax.numpy as jnp
    with jax.enable_x64(True):
        t = jnp.asarray(as_f64(theta))
        a = [jnp.asarray(as_f64(x)) for x in args]
        v, g = jax.jit(jax.value_and_grad(f))(t, *a)
        return float(v), np.asarray(g)


def drift_checks(tag, v, g, v_ref, g_ref, nlml_tol=TOL["nlml"]):
    g = np.asarray(g, np.float64)
    return [(f"{tag} nlml rel drift", abs(float(v) - v_ref) / abs(v_ref),
             nlml_tol),
            (f"{tag} grad rel drift (norm)",
             float(np.linalg.norm(g - g_ref) / np.linalg.norm(g_ref)),
             TOL["grad"])]


def system_value_and_grad(model):
    """The library's own objective and gradient at the model's θ."""
    import jax
    v, g = jax.jit(jax.value_and_grad(model._objective))(model.theta)
    return float(v), np.asarray(g)


# -------------------------------------------------------------- phases ---


def phase_ftc(ctx):
    from gpc_tpu.io import model_io
    s = ctx.sizes
    X, y = regression_data(ctx.seed, s.n_ftc, s.q_ftc)
    data = write_data(ctx, "ftc", X, y)
    path = os.path.join(ctx.tmp, "ftc.model")
    run_cli("gp", ["-s", str(ctx.seed), "-v", "1", "learn", "-#",
                   str(s.ftc_iters), data, path])
    model = model_io.read_gp(path, X=X, y=y)
    ctx.models["ftc"] = (model, data)
    v, g = system_value_and_grad(model)
    v_ref, g_ref = ref_value_and_grad(
        lambda t, X_, y_, b_, s_: ref_gp_nlml(model.spec, t, X_, y_, b_, s_),
        model.theta, model.X, model.y, model.bias, model.fixed_scales)
    ctx.say("ftc", f"nlml {v:.10g} (reference {v_ref:.10g})")
    return drift_checks("ftc", v, g, v_ref, g_ref)


def phase_serving(ctx):
    import jax
    import jax.numpy as jnp
    from gpc_tpu.serving import GPServer
    s = ctx.sizes
    model, _data = ctx.models["ftc"]
    t0 = time.perf_counter()
    server = GPServer(model)
    jax.block_until_ready(server.state)
    ctx.say("serving", f"factor {time.perf_counter() - t0:.3f} s "
                       f"(explicit inverse: "
                       f"{server.state['Linv'] is not None})")
    rng = np.random.default_rng(ctx.seed + 1)
    checks = []
    for T in s.serve_batches:
        Xt = rng.standard_normal((T, s.q_ftc))
        t0 = time.perf_counter()
        mu, var = server.predict(Xt)
        dt = time.perf_counter() - t0
        with jax.enable_x64(True):
            mu_r, var_r = jax.jit(
                lambda *a: ref_posterior(model.spec, *a))(
                *[jnp.asarray(as_f64(a)) for a in (
                    model.theta, model.X, model.y, model.bias,
                    model.fixed_scales, Xt)])
            mu_r, var_r = np.asarray(mu_r), np.asarray(var_r)
        ctx.say("serving", f"batch {T}: {dt:.4f} s (first call of its "
                           f"bucket compiles)")
        checks.append((f"serving batch {T} mean rel drift",
                       float(np.abs(mu - mu_r).max() / np.abs(mu_r).max()),
                       TOL["mean"]))
        checks.append((f"serving batch {T} var rel drift",
                       float(np.abs(var - var_r).max() / np.abs(var_r).max()),
                       TOL["var"]))
    return checks


def phase_dtc(ctx):
    from gpc_tpu.io import model_io
    s = ctx.sizes
    if "ftc" in ctx.models:
        _m, data = ctx.models["ftc"]
    else:
        data = write_data(ctx, "ftc",
                          *regression_data(ctx.seed, s.n_ftc, s.q_ftc))
    from gpc_tpu.io.svml import read_svml
    X, y = read_svml(data)
    path = os.path.join(ctx.tmp, "dtc.model")
    run_cli("gp", ["-s", str(ctx.seed), "-v", "1", "learn", "-A", "dtc",
                   "-a", str(s.dtc_active), "-#", str(s.dtc_iters), data,
                   path])
    model = model_io.read_gp(path, X=X, y=y)
    v, g = system_value_and_grad(model)
    v_ref, g_ref = ref_value_and_grad(
        lambda t, X_, y_, b_, s_: ref_gp_nlml(model.spec, t, X_, y_, b_, s_),
        model.theta, model.X, model.y, model.bias, model.fixed_scales)
    ctx.say("dtc", f"nlml {v:.10g} (reference {v_ref:.10g}), beta "
                   f"{model.beta():.6g}")
    return drift_checks("dtc", v, g, v_ref, g_ref)


def phase_gplvm(ctx):
    from gpc_tpu.io import model_io
    s = ctx.sizes
    Y = latent_data(ctx.seed, s.n_gplvm, s.d_gplvm, s.q_gplvm)
    data = write_data(ctx, "gplvm", Y, np.ones((s.n_gplvm, 1)))
    path = os.path.join(ctx.tmp, "gplvm.model")
    run_cli("gplvm", ["-s", str(ctx.seed), "-v", "1", "learn", "-x",
                      str(s.q_gplvm), "-#", str(s.gplvm_iters), data, path])
    model, _labels = model_io.read_gplvm(path)
    v, g = system_value_and_grad(model)
    v_ref, g_ref = ref_value_and_grad(
        lambda t, y_, b_, s_: ref_gplvm_nlml(model.spec, t, y_, b_, s_),
        model.theta, model.y, model.noise_bias, model.fixed_scales)
    ctx.say("gplvm", f"nlml {v:.10g} (reference {v_ref:.10g})")
    return drift_checks("gplvm", v, g, v_ref, g_ref, TOL["gplvm_nlml"])


def ref_ivm_select(kern, kp, noise_bias, X, y, d):
    """Greedy entropy selection with probit ADF moments (CIvm::selectPoints)
    in float64 numpy.  Returns the pick order and, per step, the entropy
    changes of every point (−inf on the active set)."""
    from scipy.special import log_ndtr
    g_, v_, b_, w_ = (float(a) for a in _kern_params(kern, kp))
    N = X.shape[0]
    sigma2 = 1e-6  # probit noise's fixed variance (noise.py)
    sq = np.sum(X * X, 1)

    def nu_g(mu, vs):
        c = y / np.sqrt(sigma2 + vs)
        u = c * (mu + noise_bias)
        ratio = np.exp(-0.5 * u * u - 0.5 * LOG2PI - log_ndtr(u))
        gmu = ratio * c
        gvs = -0.5 * c * u * gmu
        nu = gmu * gmu - 2.0 * gvs
        nu = np.where(np.abs(nu) < 1e-6, np.finfo(np.float64).eps, nu)
        return nu, gmu

    mu = np.zeros(N)
    vs = np.full(N, v_ + b_ + w_)
    nu, g = nu_g(mu, vs)
    M = np.zeros((d, N))
    active = np.zeros(N, bool)
    picks, scores = [], []
    for k in range(d):
        delta = -0.5 * np.log(1.0 - vs * nu + 1e-300)
        delta[active] = -np.inf
        i = int(np.argmax(delta))
        picks.append(i)
        scores.append(delta)
        d2 = np.maximum(sq + sq[i] - 2.0 * X @ X[i], 0.0)
        kcol = v_ * np.exp(-0.5 * g_ * d2) + b_
        kcol[i] += w_
        s = kcol - M[:k].T @ M[:k, i]
        M[k] = s * np.sqrt(nu[i])
        vs = vs - s * s * nu[i]
        mu = mu + g[i] * s
        active[i] = True
        nu, g = nu_g(mu, vs)
    return np.asarray(picks), scores


def phase_ivm(ctx):
    from gpc_tpu.io import model_io
    s = ctx.sizes
    X, y = class_data(ctx.seed, s.n_ivm)
    data = write_data(ctx, "ivm", X, y)
    path = os.path.join(ctx.tmp, "ivm.model")
    run_cli("ivm", ["-s", str(ctx.seed), "-v", "1", "learn", "-k", "rbf",
                    "-a", str(s.ivm_active), "-e", str(s.ivm_ext_iters),
                    "-#", str(s.ivm_kern_iters), "-n",
                    str(s.ivm_noise_iters), data, path])
    model = model_io.read_ivm(path, X=X, y=y)
    got = np.asarray(model.state.active_idx)
    return ivm_checks(ctx, "ivm", got, model.spec.kern,
                      np.asarray(model.kern_params),
                      float(np.asarray(model.noise_params)[0]), X, y)


def ivm_checks(ctx, tag, got, kern, kp, noise_bias, X, y):
    want, scores = ref_ivm_select(kern, as_f64(kp), as_f64(noise_bias),
                                  as_f64(X), y[:, 0], len(got))
    diff = np.nonzero(got != want)[0]
    if diff.size == 0:
        ctx.say(tag, f"all {len(got)} picks equal the reference")
        return [(f"{tag} active-set entropy gap", 0.0, TOL["ivm_gap"])]
    k = int(diff[0])
    sc = scores[k]
    gap = float((sc[want[k]] - sc[got[k]]) / abs(sc[want[k]]))
    ctx.say(tag, f"first pick differing from the reference: step {k} of "
                 f"{len(got)} (system {got[k]}, reference {want[k]}), "
                 f"relative entropy gap {gap:.3e}")
    return [(f"{tag} active-set entropy gap at first differing pick", gap,
             TOL["ivm_gap"])]


# --------------------------------------------------------- four cards ---


def _spread_check(ctx, tag, devs, min_bytes):
    """Every card of the mesh did real work: its peak memory passed
    `min_bytes` (all work on device 0 would leave the others near 0)."""
    from gpc_tpu.utils.profiling import peak_bytes
    peaks = [peak_bytes(d) for d in devs]
    ctx.say(tag, "peak bytes per device: " + ", ".join(map(str, peaks)))
    if any(p is None for p in peaks):
        return []  # backend keeps no statistics (virtual CPU devices)
    return [(f"{tag} min per-device peak / expected", min(peaks) / min_bytes,
             None)]


def _mesh(ctx):
    import jax
    from gpc_tpu.parallel.mesh import data_mesh
    n = ctx.sizes.multi_devices
    if len(jax.devices()) < n:
        raise RuntimeError(f"need {n} devices, JAX sees "
                           f"{len(jax.devices())}")
    mesh = data_mesh(n)
    ctx.say("mesh", "devices " + ", ".join(
        f"{d.id}:{d.device_kind}" for d in mesh.devices.flat))
    return mesh


def _sharded_inputs(mesh, X, y):
    from gpc_tpu.parallel.mesh import pad_rows, shard_rows
    nd = mesh.devices.size
    Xp, _ = pad_rows(X, nd)
    yp, _ = pad_rows(y, nd)
    mask = np.zeros(Xp.shape[0])
    mask[:X.shape[0]] = 1.0
    return tuple(shard_rows(mesh, a) for a in (Xp, yp, mask))


def _vs_single(ctx, tag, v, g, model):
    v1, g1 = system_value_and_grad(model)
    ctx.say(tag, f"sharded nlml {float(v):.10g}, single-card {v1:.10g}")
    return drift_checks(tag + " vs single-card", v, g, v1, g1)


def phase_multi_ftc(ctx):
    import jax
    from gpc_tpu import kernels as K
    from gpc_tpu.models.gp import GP
    from gpc_tpu.parallel.dist_ftc import make_dist_ftc_value_and_grad
    s = ctx.sizes
    mesh = _mesh(ctx)
    X, y = regression_data(ctx.seed, s.n_ftc, s.q_ftc)
    kern = K.Cmpnd(input_dim=s.q_ftc, components=(
        K.Rbf(input_dim=s.q_ftc), K.Bias(input_dim=s.q_ftc),
        K.White(input_dim=s.q_ftc)))
    model = GP(kern, X, y, centre=True)
    vag = jax.jit(make_dist_ftc_value_and_grad(
        model.spec, mesh, model.bias, model.fixed_scales, s.n_ftc))
    v, g = vag(model.theta, *_sharded_inputs(mesh, X, y))
    checks = _vs_single(ctx, "multi ftc", v, g, model)
    # each card factors its N/P rows of K, f32: expect at least half that
    return checks + _spread_check(ctx, "multi ftc", list(mesh.devices.flat),
                                  2 * s.n_ftc * s.n_ftc // mesh.devices.size)


def phase_multi_dtc(ctx):
    import jax
    from gpc_tpu import kernels as K
    from gpc_tpu.models.gp import GP
    from gpc_tpu.parallel.dist_gp import make_dist_objective
    s = ctx.sizes
    mesh = _mesh(ctx)
    X, y = regression_data(ctx.seed, s.n_ftc, s.q_ftc)
    kern = K.Cmpnd(input_dim=s.q_ftc, components=(
        K.Rbf(input_dim=s.q_ftc), K.Bias(input_dim=s.q_ftc),
        K.White(input_dim=s.q_ftc)))
    model = GP(kern, X, y, approx="dtc", num_active=s.dtc_active,
               centre=True, seed=ctx.seed)
    nlml = make_dist_objective(model.spec, mesh, model.bias,
                               model.fixed_scales, s.n_ftc)
    v, g = jax.jit(jax.value_and_grad(nlml))(
        model.theta, *_sharded_inputs(mesh, X, y))
    return _vs_single(ctx, "multi dtc", v, g, model)


def phase_multi_ivm(ctx):
    import jax
    import jax.numpy as jnp
    from gpc_tpu import kernels as K
    from gpc_tpu.models.ivm import ENTROPY, IvmSpec, select_points
    from gpc_tpu.noise import ProbitNoise
    from gpc_tpu.parallel.dist_ivm import make_select_points_dist
    from gpc_tpu.parallel.mesh import replicated, shard_rows
    s = ctx.sizes
    mesh = _mesh(ctx)
    nd = mesh.devices.size
    X, y = class_data(ctx.seed, s.n_ivm)
    if s.n_ivm % nd:
        raise ValueError("n_ivm must split over the devices")
    kern = K.Cmpnd(input_dim=2, components=(
        K.Rbf(input_dim=2), K.Bias(input_dim=2), K.White(input_dim=2)))
    noise = ProbitNoise(output_dim=1)
    spec = IvmSpec(kern=kern, noise=noise, n_data=s.n_ivm, input_dim=2,
                   output_dim=1, num_active=s.ivm_active, selection=ENTROPY)
    kp = jnp.asarray(kern.default_params(), jnp.float32)
    npar = jnp.asarray(noise.default_params(y), jnp.float32)
    Xf, yf = X.astype(np.float32), y.astype(np.float32)
    sel = jax.jit(make_select_points_dist(spec, mesh))
    st = sel(kp, npar, shard_rows(mesh, Xf), shard_rows(mesh, yf),
             shard_rows(mesh, np.ones(s.n_ivm, np.float32)),
             replicated(mesh, np.zeros(s.ivm_active, np.float32)))
    ref = jax.jit(lambda a, b: select_points(
        spec, a, b, Xf, yf, jnp.zeros(s.ivm_active, jnp.float32)))(kp, npar)
    got, want = np.asarray(st.active_idx), np.asarray(ref.active_idx)
    same = int(np.sum(np.cumprod(got == want)))
    ctx.say("multi ivm", f"sharded selection equals single-card for the "
                         f"first {same} of {len(got)} picks")
    # where they part, the sharded pick must be an f32 tie in the f64
    # reference's entropy at that step
    return ivm_checks(ctx, "multi ivm", got, kern, np.asarray(kp),
                      float(npar[0]), X, y) + [
        ("multi ivm single-card picks vs f64 reference",
         ivm_checks(ctx, "single-card ivm", want, kern, np.asarray(kp),
                    float(npar[0]), X, y)[0][1], TOL["ivm_gap"])]


ONE_CARD = (("device", phase_device), ("ftc", phase_ftc),
            ("serving", phase_serving), ("dtc", phase_dtc),
            ("gplvm", phase_gplvm), ("ivm", phase_ivm))
FOUR_CARDS = (("multi ftc", phase_multi_ftc),
              ("multi dtc", phase_multi_dtc), ("multi ivm", phase_multi_ivm))


def run_phase(ctx, clock, name, fn):
    """Run one phase; print its timings and every check beside its
    tolerance.  Returns True when every check is inside its tolerance."""
    import jax
    from gpc_tpu.utils.profiling import peak_bytes
    c0, t0 = clock.seconds, time.perf_counter()
    checks = fn(ctx)
    wall = time.perf_counter() - t0
    peak = peak_bytes()
    peak_s = "n/a" if peak is None else f"{peak / 2 ** 30:.3f} GiB"
    ctx.say(name, f"wall {wall:.3f} s, compile {clock.seconds - c0:.3f} s, "
                  f"peak device memory so far {peak_s} "
                  f"(smoke timings, not benchmark numbers)")
    prec = jax.config.jax_default_matmul_precision
    ok = True
    for what, val, tol in checks:
        if tol is None:  # a ratio that must reach 1
            good = val >= 1.0
            ctx.say(name, f"{what} {val:.3f} (must be >= 1): "
                          f"{'ok' if good else 'FAIL'}")
        else:
            good = bool(np.isfinite(val)) and val <= tol
            ctx.say(name, f"{what} {val:.3e} (tol {tol:.0e}) at matmul "
                          f"precision {prec}: {'ok' if good else 'FAIL'}")
        ok = ok and good
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="4: run only the sharded paths, on four cards")
    args = ap.parse_args(argv)

    from gpc_tpu.cli.common import setup_jax
    from gpc_tpu.utils.profiling import device_record, nvidia_smi
    setup_jax()
    import jax
    if jax.devices()[0].platform != "gpu":
        print(f"chip_smoke: JAX finds no GPU (backend "
              f"{jax.devices()[0].platform}); nothing was run",
              file=sys.stderr)
        return 2
    print(f"nvidia-smi: {nvidia_smi()}", flush=True)
    print(f"device: {json.dumps(device_record())}", flush=True)
    clock = CompileClock().install()
    phases = FOUR_CARDS if args.devices == 4 else ONE_CARD
    failed = []
    with tempfile.TemporaryDirectory(prefix="gpc_smoke_") as tmp:
        ctx = Context(tmp=tmp, seed=args.seed, sizes=Sizes(
            multi_devices=args.devices))
        for name, fn in phases:
            try:
                if not run_phase(ctx, clock, name, fn):
                    failed.append(name)
            except Exception as e:  # report, run the rest, exit non-zero
                import traceback
                traceback.print_exc()
                ctx.say(name, f"FAIL: {type(e).__name__}: {e}")
                failed.append(name)
    print(f"nvidia-smi: {nvidia_smi()}", flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    rec = device_record()
    print(json.dumps({"ok": True, "device": rec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
