"""Mid-run checkpoint/resume (SURVEY §5): kill-and-resume ≡ uninterrupted.

The reference's only warm start is the coarse model-file `relearn`
(/root/reference/gp.cpp:439-534); gpc_tpu adds preemption-grade mid-run
checkpoints: optim.scg_checkpointed surfaces the FULL SCG state (w/r/p/s/
delta/λ/λ̄/success/iter) between jitted segments, utils/checkpoint writes it
atomically, and resume continues the bit-identical trajectory.
"""

import os

import numpy as np
import jax
import pytest

from gpc_tpu import kernels as K
from gpc_tpu.models.gp import GP
from gpc_tpu.optim import run_optimiser
from gpc_tpu.optim.scg import scg, scg_checkpointed


def _problem(N=60, seed=5):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, 2))
    y = np.sin(X[:, :1]) + 0.1 * rng.standard_normal((N, 1))
    kern = K.Cmpnd(input_dim=2, components=(
        K.Rbf(input_dim=2), K.Bias(input_dim=2), K.White(input_dim=2)))
    return kern, X, y


class _Kill(RuntimeError):
    pass


def test_kill_and_resume_bit_identical(tmp_path):
    """Abort mid-run right after a checkpoint lands (the preemption model),
    resume from the file: the final parameter vector is BIT-IDENTICAL to the
    uninterrupted checkpointed run, and agrees with plain scg()."""
    kern, X, y = _problem()
    gp = GP(kern, X, y)
    vag = jax.jit(jax.value_and_grad(gp._objective))
    x0 = gp.theta
    path = str(tmp_path / "run.npz")

    from gpc_tpu.utils import checkpoint as ckpt

    # uninterrupted reference trajectory (segmented exactly the same way)
    full = scg_checkpointed(vag, x0, max_iters=60, ckpt_every=20)

    # killed run: checkpoint saved, then the process "dies"
    def save_then_die(step, state):
        st = dict(state)
        ckpt.save(path, step, st.pop("w"), extra=st)
        if step >= 20:
            raise _Kill()

    with pytest.raises(_Kill):
        scg_checkpointed(vag, x0, max_iters=60, ckpt_every=20,
                         on_checkpoint=save_then_die)

    # resume: a fresh process would reload and continue
    step, theta, extra, _ = ckpt.load(path)
    assert step == 20
    resumed = scg_checkpointed(vag, x0, max_iters=60, ckpt_every=20,
                               resume_state=dict(extra, w=theta))
    np.testing.assert_array_equal(np.asarray(resumed.x), np.asarray(full.x))
    assert int(resumed.iters) == int(full.iters)

    # and the segmented trajectory is the monolithic scg() trajectory
    plain = scg(vag, x0, max_iters=60)
    np.testing.assert_allclose(np.asarray(full.x), np.asarray(plain.x),
                               rtol=1e-10, atol=1e-12)
    assert int(full.iters) == int(plain.iters)


def test_run_optimiser_checkpoint_roundtrip(tmp_path):
    """run_optimiser(ckpt_path=..., resume=True) continues a truncated run:
    30 iters + resumed 30 ≡ one 60-iter run (same segment boundaries)."""
    kern, X, y = _problem(seed=7)
    gp = GP(kern, X, y)
    vag = jax.jit(jax.value_and_grad(gp._objective))
    x0 = gp.theta
    p1 = str(tmp_path / "a.npz")

    r_full = run_optimiser("scg", vag, x0, 60, ckpt_path=str(tmp_path / "b.npz"),
                           ckpt_every=30)
    r_half = run_optimiser("scg", vag, x0, 30, ckpt_path=p1, ckpt_every=30)
    assert os.path.exists(p1)
    r_res = run_optimiser("scg", vag, x0, 60, ckpt_path=p1, ckpt_every=30,
                          resume=True)
    np.testing.assert_array_equal(np.asarray(r_res.x), np.asarray(r_full.x))
    del r_half


def test_cli_checkpoint_resume_matches_single_run(tmp_path, sinc_svml):
    """CLI-level: `gp learn --checkpoint f -# 30` then `--resume -# 60`
    writes the same learned hyperparameters as one 60-iteration run."""
    import contextlib
    import io

    from gpc_tpu.cli import gp as gp_cli

    def run(args):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            gp_cli.main(args)
        return buf.getvalue()

    data = sinc_svml
    one = str(tmp_path / "one.model")
    two = str(tmp_path / "two.model")
    ck = str(tmp_path / "ck.npz")
    run(["-s", "1042", "-v", "0", "learn", "-#", "60", data, one])
    run(["-s", "1042", "-v", "0", "learn", "-#", "30", "-c", ck,
         "--checkpoint-every", "30", data, str(tmp_path / "half.model")])
    run(["-s", "1042", "-v", "0", "learn", "-#", "60", "-c", ck,
         "--checkpoint-every", "30", "-r", data, two])

    def model_floats(path):
        vals = []
        for line in open(path):
            if line.startswith("#"):
                continue
            for tok in line.replace("=", " ").split():
                try:
                    vals.append(float(tok))
                except ValueError:
                    pass
        return np.array(vals)

    np.testing.assert_allclose(model_floats(two), model_floats(one),
                               rtol=1e-9, atol=1e-12)


def test_ivm_kill_and_resume_matches_uninterrupted(tmp_path):
    """IVM alternation checkpoint/resume (VERDICT r4 ask #6): kill after the
    first full round's checkpoints, resume from the file — final kernel AND
    noise parameters are bit-identical to the uninterrupted run, because
    each [reselect → SCG] phase is deterministic given (θ, MT19937 state)
    and both are captured at the phase boundary."""
    from gpc_tpu import noise as NZ
    from gpc_tpu.models.ivm import IVM, RENTROPY

    rng = np.random.default_rng(13)
    N = 80
    X = rng.standard_normal((N, 2))
    y = np.sign(X[:, :1] + 0.3 * rng.standard_normal((N, 1)))
    kern, _, _ = _problem()

    def fresh():
        # rentropy consumes MT19937 draws each reselect — the harshest case
        # for stream-state capture
        return IVM(kern, NZ.ProbitNoise(output_dim=1), X, y, num_active=20,
                   selection=RENTROPY, seed=7)

    full = fresh()
    full.optimise(ext_iters=3, kern_iters=8, noise_iters=8)

    path = str(tmp_path / "ivm.npz")
    killed = fresh()
    # "killed" after round 1 (phases 0-1 complete, checkpoints written)
    killed.optimise(ext_iters=1, kern_iters=8, noise_iters=8, ckpt_path=path)
    assert os.path.exists(path)

    resumed = fresh()   # fresh process: virgin RNG, default params
    resumed.optimise(ext_iters=3, kern_iters=8, noise_iters=8,
                     ckpt_path=path, resume=True)
    np.testing.assert_array_equal(np.asarray(resumed.kern_params),
                                  np.asarray(full.kern_params))
    np.testing.assert_array_equal(np.asarray(resumed.noise_params),
                                  np.asarray(full.noise_params))
    np.testing.assert_array_equal(np.asarray(resumed.state.active_idx),
                                  np.asarray(full.state.active_idx))


def test_ivm_cli_checkpoint_resume(tmp_path, twoclass_svml):
    """CLI-level `ivm learn -c f` then `-c f -r`: the resumed model file
    equals the uninterrupted one."""
    import contextlib
    import io

    from gpc_tpu.cli import ivm as ivm_cli

    def run(args):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ivm_cli.main(args)
        return buf.getvalue()

    data = twoclass_svml
    one = str(tmp_path / "one.model")
    two = str(tmp_path / "two.model")
    ck = str(tmp_path / "ck.npz")
    base = ["-s", "7", "-v", "0"]
    run(base + ["learn", "-a", "20", "-e", "2", "-#", "6", "-n", "6", data, one])
    run(base + ["learn", "-a", "20", "-e", "1", "-#", "6", "-n", "6",
                "-c", ck, data, str(tmp_path / "half.model")])
    run(base + ["learn", "-a", "20", "-e", "2", "-#", "6", "-n", "6",
                "-c", ck, "-r", data, two])

    def model_floats(path):
        vals = []
        for line in open(path):
            if line.startswith("#"):
                continue
            for tok in line.replace("=", " ").split():
                try:
                    vals.append(float(tok))
                except ValueError:
                    pass
        return np.array(vals)

    np.testing.assert_allclose(model_floats(two), model_floats(one),
                               rtol=1e-12, atol=0)
