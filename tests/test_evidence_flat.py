"""Flat-buffer fused evidence (ops/evidence_fast.evidence_flat).

One persistent (n, n) factor buffer, strided-slice corrections, a single
tall dot per column.  Pins CPU parity so schedule edits can't silently pass
the suite.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gpc_tpu.ops.evidence_fast import Policy, evidence_flat
from gpc_tpu.ops.lazy_evidence import kern_block_fn, rbf_block_fn


def _dense_ref(X, m, iw, noise):
    Xs = np.asarray(X, np.float64)
    n2 = (Xs * Xs).sum(1)
    d2 = np.maximum(n2[:, None] + n2[None, :] - 2.0 * Xs @ Xs.T, 0.0)
    K = np.exp(-0.5 * iw * d2) + noise * np.eye(X.shape[0])
    L = np.linalg.cholesky(K)
    v = np.linalg.solve(L, np.asarray(m, np.float64))
    return 2.0 * np.log(np.diag(L)).sum(), float((v * v).sum())


@pytest.mark.parametrize("leafinv", [False, "xla"])
@pytest.mark.parametrize("n,b", [(768, 256), (1024, 512)])
def test_flat_f64_exact(n, b, leafinv):
    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.standard_normal((n, 4)))
    m = jnp.asarray(rng.standard_normal((n, 2)))
    kfn = rbf_block_fn(X, jnp.float64(1.0), jnp.float64(1.0),
                       jnp.float64(0.1))
    ld, q = evidence_flat(kfn, n, m, Policy(b, False, leafinv, True))
    wld, wq = _dense_ref(X, m, 1.0, 0.1)
    assert abs(float(ld) - wld) < 1e-10 * abs(wld)
    assert abs(float(q) - wq) < 1e-10 * abs(wq)


@pytest.mark.parametrize("panelhalf", [False, True])
def test_flat_bf16_drift(panelhalf):
    """bf16 policy (and the opt-in panelhalf knob) stay inside the bench's
    1e-2 drift gate on the bench problem family."""
    rng = np.random.default_rng(1)
    n = 1024
    X = jnp.asarray(rng.standard_normal((n, 4)), jnp.float32)
    m = jnp.asarray(rng.standard_normal((n, 2)), jnp.float32)
    kfn = rbf_block_fn(X, jnp.float32(1.0), jnp.float32(1.0),
                       jnp.float32(0.1))
    ld, q = evidence_flat(kfn, n, m,
                          Policy(256, True, False, True,
                                 panelhalf=panelhalf))
    wld, wq = _dense_ref(X, m, 1.0, 0.1)
    assert abs(float(ld) - wld) < 1e-2 * abs(wld)
    assert abs(float(q) - wq) < 1e-2 * abs(wq)


def test_flat_general_kernel_thunk():
    """evidence_flat over the kernel-DSL block thunk (kern_block_fn), not
    just the bench RBF closure."""
    from gpc_tpu import kernels as K

    rng = np.random.default_rng(2)
    n, qdim = 768, 3
    X = jnp.asarray(rng.standard_normal((n, qdim)))
    m = jnp.asarray(rng.standard_normal((n, 1)))
    kern = K.Cmpnd(input_dim=qdim, components=(
        K.Matern32(input_dim=qdim), K.White(input_dim=qdim)))
    p = jnp.asarray(kern.default_params())
    ld, q = evidence_flat(kern_block_fn(kern, p, X), n, m,
                          Policy(256, False, "xla", True))
    Kd = kern.compute(p, X, X) + kern.white(p) * jnp.eye(n, dtype=X.dtype)
    L = jnp.linalg.cholesky(Kd)
    v = jax.scipy.linalg.solve_triangular(L, m, lower=True)
    wld = 2.0 * float(jnp.sum(jnp.log(jnp.diagonal(L))))
    wq = float(jnp.sum(v * v))
    assert abs(float(ld) - wld) < 1e-10 * abs(wld)
    assert abs(float(q) - wq) < 1e-10 * abs(wq)


def test_flat_gradient_flows():
    """The xla/noinv-leaf flat schedule is differentiable (it may serve
    training through the evidence-mode machinery)."""
    rng = np.random.default_rng(3)
    n = 768
    X = jnp.asarray(rng.standard_normal((n, 3)))
    m = jnp.asarray(rng.standard_normal((n, 1)))

    def obj(X):
        kfn = rbf_block_fn(X, jnp.float64(1.0), jnp.float64(1.0),
                           jnp.float64(0.1))
        ld, q = evidence_flat(kfn, n, m, Policy(256, False, "xla", True))
        return ld + q

    g = jax.grad(obj)(X)
    assert bool(jnp.all(jnp.isfinite(g)))
    # FD spot check on one coordinate
    e = 1e-6
    Xp = X.at[5, 1].add(e)
    Xm = X.at[5, 1].add(-e)
    fd = (float(obj(Xp)) - float(obj(Xm))) / (2 * e)
    assert abs(fd - float(g[5, 1])) < 1e-4 * max(1.0, abs(fd))
