"""Multi-host process-group entry + host-sharded data loading.

The reference has no distributed backend of any kind (SURVEY.md §2.15); this
module supplies the multi-HOST half of the rebuild's communication stack (the
multi-chip half is parallel/mesh.py + the shard_map kernels):

* `initialize_from_env()` — `jax.distributed.initialize` driven by env vars,
  so the same CLI invocation works in every process of the group:
      GPC_TPU_COORDINATOR=host0:8476 GPC_TPU_NUM_PROCS=4 GPC_TPU_PROC_ID=$i
  All three are required: nothing detects a cluster on its own.  When
  several processes share one host's GPUs, GPC_TPU_LOCAL_DEVICES pins each
  to its own cards (a comma list of local device ids, e.g. `0` for the
  first process and `1` for the second): a JAX process reserves most of
  every card it opens.
* `load_svml_sharded(path, mesh)` — each process parses ONLY its own row
  slice of an SVM-light file and contributes it to a single global row-sharded
  `jax.Array` via `make_array_from_process_local_data`; no host ever
  materializes the full dataset.

Verified by tests/test_multihost.py, which spawns two real OS processes with a
localhost coordinator and checks the sharded NLML against single-process.
"""

from __future__ import annotations

import os

import numpy as np
import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from gpc_tpu.parallel.mesh import DATA_AXIS, data_mesh

_INITIALIZED = False


def initialize_from_env() -> bool:
    """Start the jax.distributed process group if env vars request it.

    Returns True if a multi-process group is (now) active.  Safe to call
    multiple times and in single-process runs (no-op).
    """
    global _INITIALIZED
    if _INITIALIZED:
        return jax.process_count() > 1
    coord = os.environ.get("GPC_TPU_COORDINATOR")
    nproc = os.environ.get("GPC_TPU_NUM_PROCS")
    pid = os.environ.get("GPC_TPU_PROC_ID")
    if coord is None and nproc is None:
        return False  # single-process
    if coord is None or nproc is None or pid is None:
        raise ValueError("GPC_TPU_COORDINATOR, GPC_TPU_NUM_PROCS and "
                         "GPC_TPU_PROC_ID must all be set")
    local = os.environ.get("GPC_TPU_LOCAL_DEVICES")
    jax.distributed.initialize(
        coordinator_address=coord,
        num_processes=int(nproc),
        process_id=int(pid),
        local_device_ids=(None if local is None
                          else [int(i) for i in local.split(",")]),
    )
    _INITIALIZED = True
    return jax.process_count() > 1


def process_row_range(n_rows: int, n_devices: int | None = None):
    """Row slice [lo, hi) owned by this process under equal row-block sharding
    of `n_rows` (already padded to a device multiple) over all devices."""
    n_dev = n_devices if n_devices is not None else jax.device_count()
    assert n_rows % n_dev == 0, "pad rows to a device multiple first"
    block = n_rows // n_dev
    local = jax.local_device_count()
    lo = jax.process_index() * local * block
    return lo, lo + local * block


def _clean_svml_line(ln):
    """Comment-stripped, whitespace-trimmed content of one SVM-light line —
    the SAME semantics as io/svml.read_svml_py (a `#` ANYWHERE starts a
    comment, CR stripped; CClctrl.cpp:55-171), shared here so the sharded
    loader cannot diverge from the single-host parser on e.g. `2:3#c`."""
    return ln.split("#", 1)[0].strip()


def _parse_svml_lines(lines, input_dim):
    """Parse already-cleaned SVM-light lines (label idx:val ..., 1-based)."""
    X = np.zeros((len(lines), input_dim))
    y = np.zeros((len(lines), 1))
    for r, ln in enumerate(lines):
        toks = ln.split()
        y[r, 0] = float(toks[0])
        for tok in toks[1:]:
            i, v = tok.split(":")
            X[r, int(i) - 1] = float(v)
    return X, y


def load_svml_sharded(path, mesh=None):
    """Host-sharded SVM-light load.

    Every process STREAMS the file once, tracking only the row count, the
    max feature index, and the text of its own row block — no host ever
    materializes all N parsed rows (or all N raw lines).  Returns
    (X_global, y_global, n_valid): global row-sharded jax.Arrays padded to
    the device count, plus the true row count.
    """
    if mesh is None:
        mesh = data_mesh()
    n_dev = int(np.prod(mesh.devices.shape))

    # pass 1 (streaming): row count + feature dimension
    n_valid = 0
    input_dim = 0
    with open(path) as f:
        for ln in f:
            ln = _clean_svml_line(ln)
            if not ln:
                continue
            n_valid += 1
            for tok in ln.split()[1:]:
                input_dim = max(input_dim, int(tok.split(":")[0]))

    n_pad = -(-n_valid // n_dev) * n_dev
    lo, hi = process_row_range(n_pad, n_dev)
    lo_v, hi_v = min(lo, n_valid), min(hi, n_valid)
    # pass 2 (streaming): keep only this host's [lo, hi) slice of lines
    local_lines = []
    row = 0
    with open(path) as f:
        for ln in f:
            ln = _clean_svml_line(ln)
            if not ln:
                continue
            if lo_v <= row < hi_v:
                local_lines.append(ln)
            row += 1
            if row >= hi_v:
                break
    X_l, y_l = _parse_svml_lines(local_lines, input_dim)
    rows_needed = hi - lo
    if X_l.shape[0] < rows_needed:  # tail padding rows live on the last hosts
        extra = rows_needed - X_l.shape[0]
        X_l = np.concatenate([X_l, np.zeros((extra, input_dim))], axis=0)
        y_l = np.concatenate([y_l, np.zeros((extra, 1))], axis=0)

    x_sh = NamedSharding(mesh, P(DATA_AXIS))
    X = jax.make_array_from_process_local_data(x_sh, X_l, (n_pad, input_dim))
    y = jax.make_array_from_process_local_data(x_sh, y_l, (n_pad, 1))
    return X, y, n_valid
