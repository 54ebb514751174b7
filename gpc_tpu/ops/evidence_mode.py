"""Evidence-engine selection: the ONE resolution point for GPC_TPU_EVIDENCE.

The framework ships three evidence engines, each with one job:

  dense     — jitchol escalation (linalg.py), f64-capable: the PARITY route
              and the default at every N.
  lazy      — Gram tiles fused into the blocked factorization
              (ops/lazy_evidence + ops/evidence_fast), differentiable via
              plain autodiff; never materializes the N×N Gram.  Opt-in:
              faster per value+grad on an H100 at N=16k but slower to
              compile (PERF.md), and a non-PD K gives NaN, not jitter.
  iterative — matrix-free CG + SLQ (ops/iterative): O(N·block) memory, for
              N past what a dense Gram fits in device memory
              (parallel/dist_iterative multiplies that by the mesh).
              Stochastic logdet — opt-in only.
"""

from __future__ import annotations

ENGINES = ("dense", "lazy", "iterative")


def evidence_base() -> int:
    """The effective lazy-evidence base block (GPC_TPU_EVIDENCE_BASE
    override, else ops.chol_blocked.BASE) — the models' shape guards and
    the engines must agree on this so the documented fall-back-with-warning
    contract holds for every base."""
    import os

    from gpc_tpu.ops.chol_blocked import BASE
    return int(os.environ.get("GPC_TPU_EVIDENCE_BASE", BASE))


def evidence_splits(n: int) -> bool:
    """Whether the lazy engine accepts size n at the effective base (its
    shape requirement)."""
    b = evidence_base()
    return n % b == 0 and n > 2 * b


def evidence_mode(default: str = "dense") -> str:
    """Explicit engine selection — GPC_TPU_EVIDENCE = dense | lazy |
    iterative (see module docstring).  Callers should resolve through
    `select_evidence_mode(n)`, which handles the shape fallback."""
    import os
    v = os.environ.get("GPC_TPU_EVIDENCE", default).lower()
    if v not in ENGINES:
        raise ValueError(
            f"GPC_TPU_EVIDENCE={v!r} (want {'|'.join(ENGINES)})")
    return v


def select_evidence_mode(n: int) -> str:
    """Resolve the evidence engine for problem size n (models/gp.py FTC and
    models/gplvm.py call this).  An explicit GPC_TPU_EVIDENCE always wins —
    with a visible warning + dense fallback when the lazy engine's shape
    requirement (n splits into `evidence_base()` blocks) is unmet.  When
    the flag is UNSET the engine is `dense`.  Note lazy's failure semantics
    differ: transiently non-PD K yields a NaN objective (SCG step
    rejection) instead of dense's jitter re-escalation.  `iterative` has
    no split requirement."""
    import warnings

    mode = evidence_mode()
    if mode == "lazy" and not evidence_splits(n):
        warnings.warn(
            f"GPC_TPU_EVIDENCE={mode} needs n_data to split into "
            f"{evidence_base()} blocks (got N={n}); falling back to dense")
        return "dense"
    return mode
