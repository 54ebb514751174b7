"""Evidence-engine selection (ops/evidence_mode) + lazy-path behavior.

Pins the engine contract (three engines: dense/lazy/iterative):
  * GPC_TPU_EVIDENCE=lazy on GP/GPLVM objectives ≡ dense at f64,
  * visible-warning dense fallback on non-splitting N,
  * NaN-objective SCG step rejection on a singular K (the lazy path's
    replacement for dense's jitter escalation).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gpc_tpu import kernels as K


def _cli_kern(q):
    return K.Cmpnd(input_dim=q, components=(
        K.Rbf(input_dim=q), K.Bias(input_dim=q), K.White(input_dim=q)))


def test_bad_mode_rejected(monkeypatch):
    from gpc_tpu.ops.evidence_mode import evidence_mode
    monkeypatch.setenv("GPC_TPU_EVIDENCE", "fastgrad")   # removed round 5
    with pytest.raises(ValueError, match="GPC_TPU_EVIDENCE"):
        evidence_mode()


def test_gplvm_lazy_mode_flag(monkeypatch):
    """GPC_TPU_EVIDENCE=lazy: GPLVM
    NLML value+grad ≡ dense at f64 — through the bias-split fast path."""
    from gpc_tpu.models.gplvm import GPLVM

    rng = np.random.default_rng(6)
    y = rng.standard_normal((768, 3))
    kern = _cli_kern(2)
    model = GPLVM(kern, y, latent_dim=2)
    obj = model._make_objective()
    v_dense, g_dense = jax.value_and_grad(obj)(model.theta)
    monkeypatch.setenv("GPC_TPU_EVIDENCE", "lazy")
    v_lazy, g_lazy = jax.value_and_grad(obj)(model.theta)
    assert abs(float(v_lazy) - float(v_dense)) < 1e-8 * abs(float(v_dense))
    np.testing.assert_allclose(np.asarray(g_lazy), np.asarray(g_dense),
                               rtol=1e-6, atol=1e-8)

    # non-splitting N falls back to dense with a VISIBLE warning, not silently
    y_odd = rng.standard_normal((100, 3))
    model_odd = GPLVM(kern, y_odd, latent_dim=2)
    with pytest.warns(UserWarning, match="falling back"):
        jax.value_and_grad(model_odd._make_objective())(model_odd.theta)


def test_gp_ftc_lazy_mode_flag(monkeypatch):
    """Same flag on the GP FTC hot block (models/gp.py)."""
    from gpc_tpu.models.gp import GP

    rng = np.random.default_rng(3)
    X = rng.standard_normal((768, 2))
    y = np.sin(X[:, :1]) + 0.1 * rng.standard_normal((768, 1))
    model = GP(_cli_kern(2), X, y, centre=True)
    obj = model._objective
    v_dense, g_dense = jax.value_and_grad(obj)(model.theta)
    monkeypatch.setenv("GPC_TPU_EVIDENCE", "lazy")
    v_lazy, g_lazy = jax.value_and_grad(obj)(model.theta)
    assert abs(float(v_lazy) - float(v_dense)) < 1e-7 * abs(float(v_dense))
    np.testing.assert_allclose(np.asarray(g_lazy), np.asarray(g_dense),
                               rtol=1e-5, atol=1e-7)


def test_nan_objective_scg_rescue():
    """Singular K (duplicate inputs, white → 0) must yield a NaN evidence —
    not a crash — and SCG must reject the NaN step and return finite params
    (optim/scg.py NaN handling; replaces jitter escalation on lazy paths)."""
    from gpc_tpu.ops.lazy_evidence import kern_evidence_lazy
    from gpc_tpu.optim.scg import scg

    rng = np.random.default_rng(4)
    q = 2
    Xb = rng.standard_normal((384, q))
    X = jnp.asarray(np.concatenate([Xb, Xb], axis=0))   # duplicated rows
    m = jnp.asarray(rng.standard_normal((768, 1)))
    kern = K.Cmpnd(input_dim=q, components=(
        K.Rbf(input_dim=q), K.White(input_dim=q)))
    base_p = kern.default_params()

    def obj(a):
        # a = log white variance; duplicates make K exactly singular at
        # white → 0, so sufficiently negative steps produce NaN
        p = jnp.asarray(base_p).at[-1].set(jnp.exp(a[0]))
        ld, qd = kern_evidence_lazy(kern, p, X, m, force=True)
        return ld + qd

    vag = jax.value_and_grad(obj)
    v_bad, _ = vag(jnp.asarray([-80.0]))
    assert not np.isfinite(float(v_bad))

    res = scg(vag, jnp.asarray([0.0]), max_iters=25)
    assert np.all(np.isfinite(np.asarray(res.x)))
    assert np.isfinite(float(res.obj))
    v0 = float(obj(jnp.asarray([0.0])))
    assert float(res.obj) <= v0 + 1e-9
