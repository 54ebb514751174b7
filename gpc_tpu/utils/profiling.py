"""Tracing / profiling utilities.

The reference has no profiling beyond verbosity-gated cout (SURVEY.md §5);
this module supplies the replacements: jax.profiler trace capture, per-step
wall timing that waits for the device, and achieved-FLOPs accounting for the
standard GP pipelines.
"""

from __future__ import annotations

import contextlib
import subprocess
import time
from typing import Callable

import jax


def sync(x):
    """Wait until every array in the pytree `x` is computed; returns `x`.

    JAX dispatch is asynchronous, so a timer stopped without this measures
    the enqueue, not the work."""
    return jax.block_until_ready(x)


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context; view with TensorBoard or xprof."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def time_fn(fn: Callable, *args, reps: int = 10, warmup: int = 1):
    """Mean wall seconds per call over `reps` back-to-back calls, after
    `warmup` untimed calls (which absorb compilation).  The timed window
    closes when the last call's outputs are ready."""
    for _ in range(warmup):
        sync(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    sync(out)
    return (time.perf_counter() - t0) / reps


def device_record() -> dict:
    """The devices JAX runs on, as every measurement names them."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def nvidia_smi() -> str:
    """The card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them (one line per card)."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip()


def peak_bytes(device=None):
    """Peak device memory of this process so far, or None where the backend
    keeps no statistics (the CPU)."""
    stats = (device or jax.devices()[0]).memory_stats()
    return None if not stats else stats.get("peak_bytes_in_use")


def evidence_flops(n: int, q: int, d: int) -> float:
    """FLOPs of the FTC evidence pipeline: Gram (2N²q) + Cholesky (N³/3) +
    solves (2N²D)."""
    return 2.0 * n * n * q + n ** 3 / 3.0 + 2.0 * n * n * d


def step_report(name: str, seconds: float, flops: float | None = None) -> str:
    msg = f"[gpc_tpu] {name}: {seconds * 1e3:.2f} ms"
    if flops:
        msg += f" ({flops / seconds / 1e9:.1f} GFLOP/s)"
    return msg
