"""Bring-up measurements on one NVIDIA GPU: each default schedule against the
alternative it rejects.

The library keeps one default per decision on every backend: the library
Cholesky (cuSOLVER) over the recursive schedule (`force=True`), the dense
evidence engine over the lazy one (GPC_TPU_EVIDENCE=lazy), and triangular
solves over the explicit inverse in GPServer (`explicit_inverse=True`).
This script times each default against its alternative at the smoke run's
sizes (chip_smoke.py) and prints one JSON line per measurement; every line names
the device (platform, device_kind, count) and the card's nvidia-smi name and
power limit.  With no GPU it exits non-zero: it never continues on the CPU.
A measurement that fails prints an error line, the rest still run, and the
script exits non-zero.

  matmul    f32 GEMM time and error against float64 at each precision
  evidence  Gram + Cholesky + solve → (logdet, quad) at N=4096 and 16384:
            the library cholesky (cuSOLVER) against the recursive schedule
            (ops/chol_blocked) and the fused lazy schedules
            (ops/lazy_evidence, ops/evidence_fast left and flat)
  vag       FTC and GP-LVM value+grad through the models at N=16384: dense
            (library cholesky) at "highest" and at TF32 ("high"), lazy
  serving   GPServer at N=16384 with and without the explicit inverse

Run on a machine with a GPU:  python bench.py [section ...]
Times are medians over repeated calls after a compiling warm-up call, each
call closed by block_until_ready; drift is relative to a float64 reference
computed on the card.
"""

import contextlib
import json
import os
import sys
import time

import numpy as np

N_BIG, N_SMALL, Q = 16384, 4096, 8
# a trained-looking rbf(+noise) evidence: length scale ~3, noise 1e-2
INV_WIDTH, VARIANCE, NOISE = 0.1, 1.0, 1e-2


def emit(rec):
    from gpc_tpu.utils.profiling import device_record, nvidia_smi
    rec = dict(rec, device=device_record(), nvidia_smi=nvidia_smi())
    print(json.dumps(rec), flush=True)


def timed(fn, *args, reps=5):
    """(first-call seconds, median seconds of `reps` later calls)."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return first, float(np.median(ts)), out


def data(n, q=Q, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, q))
    y = np.sin(X[:, :1]) + 0.1 * rng.standard_normal((n, 1))
    return X, y


@contextlib.contextmanager
def env(**kv):
    saved = {k: os.environ.get(k) for k in kv}
    os.environ.update({k: str(v) for k, v in kv.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def bench_matmul():
    import jax
    import jax.numpy as jnp
    n = 8192
    rng = np.random.default_rng(0)
    A = rng.standard_normal((n, n)).astype(np.float32)
    B = rng.standard_normal((n, n)).astype(np.float32)
    k = 1024  # error probe on a block: the float64 product is host work
    want = A[:k].astype(np.float64) @ B.astype(np.float64)
    A, B = jax.device_put(A), jax.device_put(B)  # time the product alone
    for prec in ("default", "high", "highest"):
        f = jax.jit(lambda a, b, p=prec: jnp.matmul(a, b, precision=p))
        first, t, C = timed(f, A, B)
        err = float(np.abs(np.asarray(C[:k], np.float64) - want).max()
                    / np.abs(want).max())
        emit({"bench": "matmul_f32", "precision": prec, "n": n,
              "median_s": t, "tflops": 2 * n ** 3 / t / 1e12,
              "rel_err_vs_f64": err})
    Ab, Bb = jax.block_until_ready((A.astype(jnp.bfloat16),
                                    B.astype(jnp.bfloat16)))
    f = jax.jit(lambda a, b: jnp.matmul(a, b,
                                        preferred_element_type=jnp.float32))
    _first, t, _ = timed(f, Ab, Bb)
    emit({"bench": "matmul_bf16", "n": n, "median_s": t,
          "tflops": 2 * n ** 3 / t / 1e12})


def _evidence_ref(X, m):
    """float64 (logdet + quad) of rbf(X) + noise·I on the card."""
    import jax
    import jax.numpy as jnp
    from jax.scipy.linalg import solve_triangular
    with jax.enable_x64(True):
        X = jnp.asarray(np.asarray(X, np.float64))
        m = jnp.asarray(np.asarray(m, np.float64))
        sq = jnp.sum(X * X, 1)
        d2 = jnp.maximum(sq[:, None] + sq[None, :] - 2 * X @ X.T, 0.0)
        K = VARIANCE * jnp.exp(-0.5 * INV_WIDTH * d2) + NOISE * jnp.eye(
            X.shape[0])
        L = jnp.linalg.cholesky(K)
        v = solve_triangular(L, m, lower=True)
        return float(2 * jnp.sum(jnp.log(jnp.diagonal(L))) + jnp.sum(v * v))


def evidence_candidates(n):
    """name → f(X, m) returning (logdet, quad), f32 on the card."""
    import jax.numpy as jnp
    from jax.scipy.linalg import solve_triangular
    from gpc_tpu.ops import chol_blocked, evidence_fast, lazy_evidence
    base = 1024 if n >= N_BIG else 256  # 16 leaves at either size

    def dense_K(X):
        sq = jnp.sum(X * X, 1)
        d2 = jnp.maximum(sq[:, None] + sq[None, :] - 2 * X @ X.T, 0.0)
        return VARIANCE * jnp.exp(-0.5 * INV_WIDTH * d2) + NOISE * jnp.eye(
            X.shape[0], dtype=X.dtype)

    def library(X, m):
        L = jnp.linalg.cholesky(dense_K(X))
        v = solve_triangular(L, m, lower=True)
        return 2 * jnp.sum(jnp.log(jnp.diagonal(L))), jnp.sum(v * v)

    def recursive(X, m):
        ld, quad, _L = chol_blocked.evidence_fused(dense_K(X), m, force=True)
        return ld, quad

    def kfn(X):
        return lazy_evidence.rbf_block_fn(X, INV_WIDTH, VARIANCE, NOISE)

    def lazy_right(X, m):
        ld, quad, _L = lazy_evidence.evidence_fused_lazy(kfn(X), n, m)
        return ld, quad

    pol = evidence_fast.Policy(base=base, bf16=False, leafinv=False,
                               stack=True)
    polx = evidence_fast.Policy(base=base, bf16=False, leafinv="xla",
                                stack=True)
    return {
        "library_cholesky": library,
        f"recursive_b{chol_blocked.BASE}": recursive,
        f"lazy_right_b{chol_blocked.BASE}": lazy_right,
        f"left_b{base}": lambda X, m: evidence_fast.evidence_left_fast(
            kfn(X), n, m, pol),
        f"flat_b{base}_xla_leafinv": lambda X, m: evidence_fast.evidence_flat(
            kfn(X), n, m, polx),
    }


def bench_evidence():
    import jax
    failures = 0
    for n in (N_SMALL, N_BIG):
        X, y = data(n)
        m = y - y.mean()
        Xf, mf = X.astype(np.float32), m.astype(np.float32)
        ref = _evidence_ref(Xf, mf)
        # every schedule at the library default precision, then what TF32
        # ("high"; "default" lowers the same) does to the library schedule
        default = jax.config.jax_default_matmul_precision
        cands = [(name, fn, default)
                 for name, fn in evidence_candidates(n).items()]
        cands += [("library_cholesky", cands[0][1], "high")]
        for name, fn, prec in cands:
            try:
                with jax.default_matmul_precision(prec):
                    first, t, (ld, quad) = timed(jax.jit(fn), Xf, mf)
                val = float(ld) + float(quad)
                emit({"bench": "evidence", "n": n, "q": Q, "schedule": name,
                      "matmul_precision": prec,
                      "median_s": t, "first_call_s": first,
                      "rel_drift_vs_f64": abs(val - ref) / abs(ref)})
            except Exception as e:  # noqa: BLE001 - report, exit non-zero
                failures += 1
                emit({"bench": "evidence", "n": n, "schedule": name,
                      "error": f"{type(e).__name__}: {e}"[:500]})
    return failures


def _models(n):
    from gpc_tpu import kernels as K
    from gpc_tpu.models.gp import GP
    from gpc_tpu.models.gplvm import GPLVM
    X, y = data(n)
    kern = K.Cmpnd(input_dim=Q, components=(
        K.Rbf(input_dim=Q), K.Bias(input_dim=Q), K.White(input_dim=Q)))
    rng = np.random.default_rng(1)
    Z = rng.standard_normal((n, 2))
    Y = np.tanh(Z @ rng.standard_normal((2, 4))) \
        + 0.1 * rng.standard_normal((n, 4))
    kern2 = K.Cmpnd(input_dim=2, components=(
        K.Rbf(input_dim=2), K.Bias(input_dim=2), K.White(input_dim=2)))
    return {"ftc": GP(kern, X, y, centre=True),
            "gplvm": GPLVM(kern2, Y, latent_dim=2)}


def bench_vag():
    import jax
    from gpc_tpu.utils.profiling import peak_bytes
    failures = 0
    models = _models(N_BIG)
    variants = {
        "dense_library_cholesky": (contextlib.nullcontext,),
        "dense_library_cholesky@high": (
            lambda: jax.default_matmul_precision("high"),),
        "lazy_b1024": (lambda: env(GPC_TPU_EVIDENCE="lazy",
                                   GPC_TPU_EVIDENCE_BASE=1024),),
    }
    for mname, model in models.items():
        nlml0 = None
        for vname, (ctx,) in variants.items():
            try:
                with ctx():
                    vag = jax.jit(jax.value_and_grad(model._objective))
                    first, t, (v, _g) = timed(vag, model.theta, reps=3)
                nlml0 = float(v) if nlml0 is None else nlml0
                emit({"bench": "value_and_grad", "model": mname,
                      "n": N_BIG, "variant": vname, "median_s": t,
                      "first_call_s": first, "nlml": float(v),
                      "nlml_rel_diff_vs_first_variant":
                          abs(float(v) - nlml0) / abs(nlml0),
                      "peak_bytes_so_far": peak_bytes()})
            except Exception as e:  # noqa: BLE001 - report, exit non-zero
                failures += 1
                emit({"bench": "value_and_grad", "model": mname,
                      "variant": vname,
                      "error": f"{type(e).__name__}: {e}"[:500]})
    return failures


def bench_serving():
    import jax
    from gpc_tpu.serving import GPServer
    model = _models(N_BIG)["ftc"]
    rng = np.random.default_rng(2)
    batches = {T: rng.standard_normal((T, Q)) for T in (4096, 1000, 1)}
    outs = {}
    for inv in (False, True):
        srv = GPServer(model, explicit_inverse=inv)
        jax.block_until_ready(srv.state)
        first, t_factor, _ = timed(
            lambda: (srv.refresh(model), srv.state)[1], reps=3)
        rec = {"bench": "serving", "n": N_BIG, "explicit_inverse": inv,
               "factor_median_s": t_factor}
        for T, Xt in batches.items():
            _f, t, out = timed(srv.predict, Xt, reps=5)
            rec[f"batch_{T}_median_s"] = t
            outs[(inv, T)] = out
        emit(rec)
    for T in batches:
        (mu0, v0), (mu1, v1) = outs[(False, T)], outs[(True, T)]
        emit({"bench": "serving_agreement", "batch": T,
              "mean_rel_diff": float(np.abs(mu1 - mu0).max()
                                     / np.abs(mu0).max()),
              "var_rel_diff": float(np.abs(v1 - v0).max()
                                    / np.abs(v0).max())})


SECTIONS = {"matmul": bench_matmul, "evidence": bench_evidence,
            "vag": bench_vag, "serving": bench_serving}


def main(argv):
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gpc_tpu.cli.common import setup_jax
    setup_jax()
    import jax
    if jax.devices()[0].platform != "gpu":
        print(f"bench.py: JAX finds no GPU (backend "
              f"{jax.devices()[0].platform}); nothing was measured",
              file=sys.stderr)
        return 2
    names = argv or list(SECTIONS)
    unknown = [s for s in names if s not in SECTIONS]
    if unknown:
        print(f"bench.py: unknown section(s) {unknown}; have "
              f"{list(SECTIONS)}", file=sys.stderr)
        return 2
    failures = 0
    for name in names:
        try:
            failures += SECTIONS[name]() or 0
        except Exception as e:  # noqa: BLE001 - report, exit non-zero
            failures += 1
            emit({"bench": name, "error": f"{type(e).__name__}: {e}"[:500]})
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
