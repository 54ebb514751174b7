"""Bring-up surface on the CPU: the smoke run's phases at tiny sizes, the
backend resolver, the default schedules and the options that reach their
alternatives, the compile-cache placement, timing helpers, and the GPU-only
entry points' refusal to run without a card."""

import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

from gpc_tpu import backend  # noqa: E402
from gpc_tpu import kernels as K  # noqa: E402

TINY = chip_smoke.Sizes(
    n_ftc=96, q_ftc=3, ftc_iters=2, serve_batches=(16, 5, 1), dtc_active=8,
    dtc_iters=2, n_gplvm=64, d_gplvm=3, q_gplvm=2, gplvm_iters=2, n_ivm=64,
    ivm_active=12, ivm_ext_iters=1, ivm_kern_iters=2, ivm_noise_iters=2,
    multi_devices=4)

# phase → phases it needs first (serving serves the ftc phase's model)
PHASES = {"device": (), "ftc": (), "serving": ("ftc",), "dtc": (),
          "gplvm": (), "ivm": (), "multi ftc": (), "multi dtc": (),
          "multi ivm": ()}


@pytest.mark.parametrize("phase", list(PHASES))
def test_smoke_phase_tiny(phase, tmp_path, capsys):
    fns = dict(chip_smoke.ONE_CARD + chip_smoke.FOUR_CARDS)
    ctx = chip_smoke.Context(tmp=str(tmp_path), seed=3, sizes=TINY)
    clock = chip_smoke.CompileClock()
    for dep in PHASES[phase]:
        assert chip_smoke.run_phase(ctx, clock, dep, fns[dep])
    assert chip_smoke.run_phase(ctx, clock, phase, fns[phase])
    out = capsys.readouterr().out
    assert f"[{phase}] wall" in out and "FAIL" not in out


def test_smoke_reference_catches_a_wrong_value():
    """The drift check is live: a perturbed system value fails it."""
    checks = chip_smoke.drift_checks("x", 1.0 + 1e-3, np.ones(3), 1.0,
                                     np.ones(3))
    assert checks[0][1] > chip_smoke.TOL["nlml"]


def test_ref_ivm_matches_library_selection():
    """The float64 numpy selection reference picks what the library's
    jitted scan picks (x64 on the CPU)."""
    from gpc_tpu.models.ivm import ENTROPY, IvmSpec, select_points
    from gpc_tpu.noise import ProbitNoise
    X, y = chip_smoke.class_data(5, 80)
    kern = K.Cmpnd(input_dim=2, components=(
        K.Rbf(input_dim=2), K.Bias(input_dim=2), K.White(input_dim=2)))
    noise = ProbitNoise(output_dim=1)
    spec = IvmSpec(kern=kern, noise=noise, n_data=80, input_dim=2,
                   output_dim=1, num_active=15, selection=ENTROPY)
    kp = kern.default_params()
    npar = noise.default_params(y)
    st = select_points(spec, kp, npar, X, y, np.zeros(15))
    want, _ = chip_smoke.ref_ivm_select(kern, kp, npar[0], X, y[:, 0], 15)
    np.testing.assert_array_equal(np.asarray(st.active_idx), want)


def _run(args, cwd, **env):
    e = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    e.update(JAX_PLATFORMS="cpu", **env)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=e,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_entry_points_refuse_cpu(script):
    res = _run([script], cwd=REPO)
    assert res.returncode != 0
    assert "no GPU" in res.stderr
    assert '"ok"' not in res.stdout


def test_smoke_alone_fails(tmp_path):
    """chip_smoke.py without the rest of the repo exits non-zero, printing
    no result."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    res = _run(["chip_smoke.py"], cwd=tmp_path,
               PYTHONPATH="")
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


# ------------------------------------------------------ backend resolver ---


def test_select_platform_unset(monkeypatch):
    monkeypatch.delenv("GPC_TPU_PLATFORM", raising=False)
    assert backend.select_platform() is None


def test_select_platform_cpu(monkeypatch):
    calls = []
    monkeypatch.setenv("GPC_TPU_PLATFORM", "cpu")
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    assert backend.select_platform() == "cpu"
    assert ("jax_platforms", "cpu") in calls
    assert ("jax_enable_x64", True) in calls


def test_select_platform_gpu_absent_is_an_error(monkeypatch):
    calls = []
    monkeypatch.setenv("GPC_TPU_PLATFORM", "gpu")
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    with pytest.raises(RuntimeError, match="no GPU"):
        backend.select_platform()
    assert calls == []  # JAX's own backend choice, never "gpu" (cuda+rocm)


def test_select_platform_gpu_present(monkeypatch):
    monkeypatch.setenv("GPC_TPU_PLATFORM", "gpu")
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert backend.select_platform() == "gpu"


@pytest.mark.parametrize("value", ["rocm", "metal", "cuda"])
def test_select_platform_unknown_value(monkeypatch, value):
    monkeypatch.setenv("GPC_TPU_PLATFORM", value)
    with pytest.raises(ValueError, match="GPC_TPU_PLATFORM"):
        backend.select_platform()


def test_platform_rejects_unknown_backend(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="unsupported JAX backend"):
        backend.platform()


@pytest.mark.parametrize("plat", ["cpu", "gpu"])
def test_platform_per_backend(monkeypatch, plat):
    monkeypatch.setattr(jax, "default_backend", lambda: plat)
    assert backend.platform() == plat


# ------------------------------------- default schedules and their options ---


def _spd(n, seed):
    B = np.random.default_rng(seed).standard_normal((n, n))
    return jnp.asarray(B @ B.T + n * np.eye(n))


@pytest.mark.parametrize("force", [False, True])
def test_cholesky_recursive_only_when_forced(monkeypatch, force):
    from gpc_tpu.ops import chol_blocked
    used = []
    real = chol_blocked._chol_recursive
    monkeypatch.setattr(chol_blocked, "_chol_recursive",
                        lambda A: used.append(1) or real(A))
    A = _spd(768, 0)
    L = chol_blocked.cholesky(A, force=force)
    assert bool(used) == force
    np.testing.assert_allclose(np.asarray(L), np.linalg.cholesky(A),
                               atol=1e-8)


@pytest.mark.parametrize("force", [False, True])
def test_evidence_fused_recursive_only_when_forced(monkeypatch, force):
    from gpc_tpu.ops import chol_blocked
    used = []
    real = chol_blocked._chol_solve_recursive
    monkeypatch.setattr(chol_blocked, "_chol_solve_recursive",
                        lambda A, b: used.append(1) or real(A, b))
    A = _spd(768, 1)
    m = jnp.asarray(np.random.default_rng(1).standard_normal((768, 2)))
    ld, quad, _L = chol_blocked.evidence_fused(A, m, force=force)
    assert bool(used) == force
    np.testing.assert_allclose(float(ld), np.linalg.slogdet(A)[1],
                               rtol=1e-10)
    np.testing.assert_allclose(float(quad), float(
        np.sum(np.asarray(m) * np.linalg.solve(A, m))), rtol=1e-10)


@pytest.mark.parametrize("force,n,fused", [
    (False, 768, False),
    (True, 768, True),
    (True, 700, False),   # does not split into BASE leaves
])
def test_rbf_lazy_fused_only_when_forced(monkeypatch, force, n, fused):
    from gpc_tpu.ops import lazy_evidence
    used = []
    real = lazy_evidence.evidence_fused_left
    monkeypatch.setattr(lazy_evidence, "evidence_fused_left",
                        lambda *a: used.append(1) or real(*a))
    rng = np.random.default_rng(2)
    X = rng.standard_normal((n, 3))
    m = rng.standard_normal((n, 1))
    ld, quad = lazy_evidence.rbf_evidence_lazy(
        jnp.asarray(X), jnp.asarray(m), 0.5, 1.0, 0.1, force=force)
    assert bool(used) == fused
    sq = np.sum(X * X, 1)
    K = np.exp(-0.25 * (sq[:, None] + sq[None, :] - 2 * X @ X.T)) \
        + 0.1 * np.eye(n)
    np.testing.assert_allclose(float(ld) + float(quad),
                               np.linalg.slogdet(K)[1]
                               + np.sum(m * np.linalg.solve(K, m)),
                               rtol=1e-9)


@pytest.mark.parametrize("flag,n,want", [
    (None, 1024, "dense"),
    (None, 1 << 16, "dense"),      # no size switch: dense at every N
    ("lazy", 1024, "lazy"),
    ("dense", 1024, "dense"),
    ("iterative", 1000, "iterative"),
])
def test_select_evidence_mode(monkeypatch, flag, n, want):
    from gpc_tpu.ops.evidence_mode import select_evidence_mode
    monkeypatch.delenv("GPC_TPU_EVIDENCE_BASE", raising=False)
    if flag is None:
        monkeypatch.delenv("GPC_TPU_EVIDENCE", raising=False)
    else:
        monkeypatch.setenv("GPC_TPU_EVIDENCE", flag)
    assert select_evidence_mode(n) == want


def test_select_evidence_mode_lazy_falls_back_with_warning(monkeypatch):
    from gpc_tpu.ops.evidence_mode import select_evidence_mode
    monkeypatch.delenv("GPC_TPU_EVIDENCE_BASE", raising=False)
    monkeypatch.setenv("GPC_TPU_EVIDENCE", "lazy")
    with pytest.warns(UserWarning, match="falling back to dense"):
        assert select_evidence_mode(1000) == "dense"


@pytest.mark.parametrize("kw,inverse", [({}, False),
                                        ({"explicit_inverse": True}, True)])
def test_serving_explicit_inverse_opt_in(kw, inverse):
    from gpc_tpu.models.gp import GP
    from gpc_tpu.serving import GPServer
    rng = np.random.default_rng(3)
    X = rng.standard_normal((40, 2))
    y = np.sin(X[:, :1])
    kern = K.Cmpnd(input_dim=2, components=(
        K.Rbf(input_dim=2), K.Bias(input_dim=2), K.White(input_dim=2)))
    srv = GPServer(GP(kern, X, y), chunk=16, **kw)
    assert (srv.state["Linv"] is not None) == inverse


def test_policy_rejects_removed_leaf_modes():
    from gpc_tpu.ops.evidence_fast import Policy, evidence_left_fast
    from gpc_tpu.ops.lazy_evidence import rbf_block_fn
    X = jnp.asarray(np.random.default_rng(4).standard_normal((1024, 2)))
    kfn = rbf_block_fn(X, 1.0, 1.0, 0.1)
    for mode in ("pallas", True):
        with pytest.raises(ValueError, match="leafinv"):
            evidence_left_fast(kfn, 1024, jnp.ones((1024, 1)),
                               Policy(base=256, bf16=False, leafinv=mode))


# ------------------------------------------------------- compile cache ---


def test_cache_env_var_wins(monkeypatch):
    from gpc_tpu.cli import common
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    monkeypatch.delenv("GPC_TPU_CACHE_DIR", raising=False)
    monkeypatch.delenv("GPC_TPU_PLATFORM", raising=False)
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    assert common.compile_cache_dir() is None
    common.setup_jax()
    assert not [c for c in calls if c[0] == "jax_compilation_cache_dir"]


def test_cache_default_is_in_checkout(monkeypatch):
    from gpc_tpu.cli import common
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("GPC_TPU_CACHE_DIR", raising=False)
    path = pathlib.Path(common.compile_cache_dir())
    assert path == REPO / ".jax_cache"
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_cache_off_switch(monkeypatch):
    from gpc_tpu.cli import common
    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("GPC_TPU_PLATFORM", raising=False)
    monkeypatch.setenv("GPC_TPU_CACHE_DIR", "0")
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    assert common.compile_cache_dir() is None
    common.setup_jax()
    assert calls == []


# ----------------------------------------------------------------- timing ---


def test_sync_waits_and_returns_tree():
    from gpc_tpu.utils.profiling import sync
    tree = {"a": jnp.ones(3) * 2.0, "b": (jnp.zeros(2),)}
    out = sync(tree)
    assert out is tree
    assert all(x.is_ready() for x in jax.tree_util.tree_leaves(out))


def test_time_fn_counts_warmup_and_reps():
    from gpc_tpu.utils.profiling import time_fn
    calls = []

    def f(x):
        calls.append(1)
        return x + 1.0
    t = time_fn(f, jnp.ones(4), reps=3, warmup=2)
    assert len(calls) == 5 and t >= 0.0


# ------------------------------- no Pallas, no "not CPU" backend branches ---


def _sources():
    return sorted((REPO / "gpc_tpu").rglob("*.py"))


def test_no_module_uses_pallas():
    """No hand-written kernel remains: no module imports or calls Pallas."""
    bad = [str(p) for p in _sources() if "pallas" in p.read_text()]
    assert bad == []


def test_no_not_cpu_branches():
    bad = [str(p) for p in _sources()
           if 'default_backend() != "cpu"' in p.read_text()]
    assert bad == []
