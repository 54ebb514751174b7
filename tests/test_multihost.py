"""Real multi-PROCESS distributed test (2 OS processes, localhost coordinator).

The virtual-8-device tests in test_parallel.py exercise the collectives inside
one process; this spawns two actual jax.distributed processes — what a
multi-host group does over the network — and checks the host-sharded data
loading plus the psum-reduced FTC NLML against the single-process value.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

WORKER = os.path.join(os.path.dirname(__file__), "helpers", "multihost_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.skipif(os.environ.get("GPC_TPU_SKIP_MULTIPROC") == "1",
                    reason="multi-process test disabled")
def test_two_process_ftc_nlml_matches_single_process(sinc_svml):
    SINC = sinc_svml
    port = _free_port()
    procs = []
    for pid in range(2):
        env = {k: v for k, v in os.environ.items()
               if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "JAX_NUM_CPU_DEVICES")}
        env |= {"GPC_TPU_COORDINATOR": f"127.0.0.1:{port}",
                "GPC_TPU_NUM_PROCS": "2",
                "GPC_TPU_PROC_ID": str(pid),
                "GPC_TPU_REPO": os.path.dirname(os.path.dirname(__file__)),
                "GPC_TPU_DATA": SINC}
        procs.append(subprocess.Popen([sys.executable, WORKER],
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True,
                                      env=env))
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        outs.append(out)
    line = [ln for ln in outs[0].splitlines() if ln.startswith("NLML=")]
    assert line, outs[0]
    got = float(line[0].split("=")[1])

    # single-process expected value (this process: 8 virtual devices, x64)
    from gpc_tpu import kernels as K
    from gpc_tpu.io.svml import read_svml
    from gpc_tpu.models.gp import GP
    X, y = read_svml(SINC)
    kern = K.Cmpnd(input_dim=1, components=(
        K.Rbf(input_dim=1), K.Bias(input_dim=1), K.White(input_dim=1)))
    model = GP(kern, X, y, centre=False)
    want = -model.log_likelihood()
    np.testing.assert_allclose(got, want, rtol=1e-9)
