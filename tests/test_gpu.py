"""Tests that need an NVIDIA GPU (marker `gpu`); they skip without one.

The suite's conftest pins the test process to the CPU, so each test runs
its GPU work in a child process.  Run them on the card with
`python -m pytest tests -m gpu`.
"""

import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu_env():
    """Environment for a child process on the GPU; skips without a card."""
    try:
        subprocess.run(["nvidia-smi", "-L"], check=True, capture_output=True,
                       timeout=60)
    except (OSError, subprocess.SubprocessError):
        pytest.skip("no NVIDIA GPU on this machine")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS", "JAX_ENABLE_X64")}
    env["GPC_TPU_PLATFORM"] = "gpu"
    return env


SMOKE_TINY = """
import sys, tempfile
sys.path.insert(0, {repo!r})
import chip_smoke as cs
from gpc_tpu.cli.common import setup_jax
setup_jax()
sizes = cs.Sizes(n_ftc=512, q_ftc=4, ftc_iters=2, serve_batches=(64, 5, 1),
                 dtc_active=32, dtc_iters=2, n_gplvm=256, gplvm_iters=2,
                 n_ivm=256, ivm_active=32, ivm_ext_iters=1, ivm_kern_iters=2,
                 ivm_noise_iters=2, multi_devices=1)
clock = cs.CompileClock().install()
ok = True
with tempfile.TemporaryDirectory() as tmp:
    ctx = cs.Context(tmp=tmp, seed=1, sizes=sizes)
    for name, fn in cs.ONE_CARD:
        ok = cs.run_phase(ctx, clock, name, fn) and ok
sys.exit(0 if ok else 1)
"""


def test_smoke_phases_small_on_gpu(gpu_env):
    """Every smoke phase at a small size, float32 on the card, within the
    smoke run's tolerances."""
    res = subprocess.run([sys.executable, "-c", SMOKE_TINY.format(
        repo=str(REPO))], env=gpu_env, capture_output=True, text=True,
        timeout=900)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
