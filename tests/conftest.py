"""Test configuration: CPU backend with 8 virtual devices, float64 enabled.

Parity tests against the reference (MATCHTOL-style tolerances, SURVEY.md §4) need
float64; multi-device sharding tests (tests/test_parallel.py) need a virtual mesh.
Both must be configured before jax initializes its backends, hence the env vars at
import time.  The GPU runs (chip_smoke.py, bench.py) are separate scripts that
run in float32 on the card; tests that need a card carry the `gpu` marker and
skip here.
"""

import os

# Force CPU, also when a GPU is present: the suite pins float64 parity on the
# CPU.  The config is re-updated after importing jax in case site
# customization changed it at interpreter start.
os.environ["JAX_PLATFORMS"] = "cpu"
# No persistent compilation cache inside the test process: this image's
# XLA:CPU executable (de)serialization is fragile — observed as a
# nondeterministic hard abort in put_executable_and_time (and a SIGILL
# reading entries compiled on a wider-ISA pool host) once a CLI test calls
# cli/common.setup_jax and enables the cache PROCESS-WIDE.  Within one
# pytest process the in-memory jit cache already dedups, so the persistent
# cache buys nothing here; the CLIs keep it (cli/common.py, machine-keyed).
os.environ.setdefault("GPC_TPU_CACHE_DIR", "0")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables between test MODULES.

    This image's XLA:CPU JIT segfaults inside backend_compile after a few
    hundred accumulated compiled programs in one process (reproduced at the
    same suite position across runs, with the persistent cache disabled;
    the same tests pass in a fresh process).  Dropping executables at
    module boundaries keeps the live-program count bounded; cross-module
    cache reuse is negligible, so the runtime cost is small."""
    yield
    import jax as _jax
    _jax.clear_caches()


# --------------------------------------------------------------------------
# Seeded stand-ins for the reference's example data sets, in their shapes,
# for tests that need some data of that kind (not the exact draw).  Tests
# that pin the reference's own published numbers read the reference tree.


def _write(tmp_path_factory, name, X, y):
    from gpc_tpu.io.svml import write_svml
    path = tmp_path_factory.mktemp("data") / name
    write_svml(path, X, y)
    return str(path)


@pytest.fixture(scope="session")
def sinc_svml(tmp_path_factory):
    """The sinc tutorial's shape: 40 noisy sin(x)/x samples on [-3, 3]."""
    import numpy as np
    rng = np.random.default_rng(0)
    X = rng.uniform(-3.0, 3.0, (40, 1))
    y = np.sinc(X / np.pi) + 0.1 * rng.standard_normal((40, 1))
    return _write(tmp_path_factory, "sinc.svml", X, y)


@pytest.fixture(scope="session")
def oil100_svml(tmp_path_factory):
    """oilTrain100's shape: 100 points, 12 features, integer class labels
    1-3 (three noisy clusters)."""
    import numpy as np
    rng = np.random.default_rng(1)
    labels = np.repeat([1, 2, 3], [34, 33, 33])
    centres = rng.standard_normal((3, 12))
    X = centres[labels - 1] + 0.3 * rng.standard_normal((100, 12))
    return _write(tmp_path_factory, "oil100.svml", X, labels)


@pytest.fixture(scope="session")
def twoclass_svml(tmp_path_factory):
    """unitsquaregp's shape: 502 points in the unit square, labels ±1."""
    import numpy as np
    rng = np.random.default_rng(2)
    X = rng.uniform(0.0, 1.0, (502, 2))
    f = np.sin(6.0 * X[:, 0]) - 4.0 * (X[:, 1] - 0.5)
    y = np.where(f + 0.3 * rng.standard_normal(502) > 0, 1.0, -1.0)
    return _write(tmp_path_factory, "twoclass.svml", X, y)
