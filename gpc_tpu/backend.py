"""Backend resolution: the one place that asks which device runs the program.

`select_platform()` applies the user's GPC_TPU_PLATFORM request before JAX
starts its backends; `platform()` names the backend that is running ("cpu" or
"gpu").  No schedule depends on the backend: the library factorization
(LAPACK on the CPU, cuSOLVER on the GPU), the dense evidence engine and the
triangular-solve serving path are the defaults on both, each measured on an
H100 against its alternative (PERF.md, "Bring-up findings").  The
alternatives stay reachable by option: `force=True` (ops/chol_blocked,
ops/lazy_evidence), GPC_TPU_EVIDENCE=lazy, GPServer(explicit_inverse=True).
"""

from __future__ import annotations

import os

import jax

PLATFORMS = ("cpu", "gpu")


def select_platform() -> str | None:
    """Apply GPC_TPU_PLATFORM=cpu|gpu (unset: JAX's own default).

    `cpu` also enables float64, matching the double-precision reference.
    `gpu` with no card is an error: the run stops instead of continuing on
    the CPU.  Must run before JAX initializes its backends."""
    plat = os.environ.get("GPC_TPU_PLATFORM")
    if not plat:
        return None
    if plat not in PLATFORMS:
        raise ValueError(
            f"GPC_TPU_PLATFORM={plat!r} (want {' or '.join(PLATFORMS)})")
    if plat == "cpu":
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        return plat
    # gpu: JAX's own default picks the card when there is one.  Setting
    # jax_platforms="gpu" would not do: JAX expands it to cuda AND rocm and
    # fails loudly on whichever the machine lacks.
    if jax.default_backend() != "gpu":
        raise RuntimeError("GPC_TPU_PLATFORM=gpu but JAX finds no GPU "
                           f"(backend {jax.default_backend()!r})")
    return plat


def platform() -> str:
    """The running JAX backend, "cpu" or "gpu"; anything else is an error."""
    b = jax.default_backend()
    if b not in PLATFORMS:
        raise RuntimeError(f"unsupported JAX backend {b!r} "
                           f"(want {' or '.join(PLATFORMS)})")
    return b
