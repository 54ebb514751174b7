"""In-process CLI tests: the reference's end-to-end command surface."""

import os

import numpy as np
import pytest

from gpc_tpu.cli import gp as gp_cli
from gpc_tpu.cli import gplvm as gplvm_cli
from gpc_tpu.cli import ivm as ivm_cli

import sys

SINC = OIL100 = None  # seeded stand-ins, set per test by _data below


@pytest.fixture(autouse=True)
def _data(sinc_svml, oil100_svml, monkeypatch):
    mod = sys.modules[__name__]
    monkeypatch.setattr(mod, "SINC", sinc_svml)
    monkeypatch.setattr(mod, "OIL100", oil100_svml)


@pytest.fixture()
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_gp_learn_display_gnuplot_relearn(in_tmp, capsys):
    gp_cli.main(["-s", "42", "-v", "1", "learn", "-#", "30", SINC, "m1"])
    out = capsys.readouterr().out
    assert "Gaussian process model" in out
    gp_cli.main(["display", "m1"])
    assert "inverseWidth" in capsys.readouterr().out
    gp_cli.main(["gnuplot", SINC, "m1", "t"])
    for f in ("t_line_data.dat", "t_error_bar_data.dat", "t_scatter_data.dat", "t_plot.gp"):
        assert os.path.exists(f), f
    before = open("m1").read()
    gp_cli.main(["-v", "1", "relearn", "-#", "5", SINC, "m1", "m1_re"])
    assert "Final objective" in capsys.readouterr().out
    # the retrained model goes to the THIRD positional; the input model is
    # untouched (gp.cpp:446-447, 515)
    assert os.path.exists("m1_re")
    assert open("m1").read() == before


def test_gp_sparse_learn(in_tmp, capsys):
    gp_cli.main(["-s", "1", "-v", "1", "learn", "-A", "dtc", "-a", "8", "-#", "15",
                 SINC, "m2"])
    assert "beta" in capsys.readouterr().out
    gp_cli.main(["gnuplot", SINC, "m2", "s"])
    assert os.path.exists("s_active_set.dat")


def test_gp_error_paths(in_tmp):
    with pytest.raises(SystemExit):
        gp_cli.main(["learn", "-A", "dtc", SINC])  # no -a
    with pytest.raises(SystemExit):
        gp_cli.main(["learn", "-Z", SINC])
    with pytest.raises(SystemExit):
        gp_cli.main(["display", "missing_model"])
    with pytest.raises(SystemExit):
        gp_cli.main(["bogus-command"])


def test_gp_relearn_dimension_check(in_tmp):
    """relearn/gnuplot reject data whose feature count differs from the
    stored model's inputDim (gp.cpp:502-503).  The check must run against
    the FILE's inputDim inside read_gp — the rebuilt spec always matches
    the attached X, so a post-hoc spec-vs-X comparison is vacuous."""
    from gpc_tpu.io.svml import write_svml
    gp_cli.main(["-s", "1", "-v", "0", "learn", "-#", "2", SINC, "md"])
    rng = np.random.default_rng(5)
    write_svml("wide.svml", rng.standard_normal((10, 2)),
               rng.standard_normal(10))
    with pytest.raises(SystemExit):
        gp_cli.main(["relearn", "-#", "2", "wide.svml", "md", "md2"])
    with pytest.raises(SystemExit):
        gp_cli.main(["gnuplot", "wide.svml", "md", "tt"])


def test_ivm_learn_and_friends(in_tmp, capsys):
    # tiny classification set
    rng = np.random.default_rng(0)
    X = np.vstack([rng.standard_normal((15, 2)) + 2, rng.standard_normal((15, 2)) - 2])
    y = np.concatenate([np.ones(15), -np.ones(15)])
    from gpc_tpu.io.svml import write_svml
    write_svml("train.svml", X, y)
    ivm_cli.main(["-s", "3", "-v", "0", "learn", "-a", "10", "-k", "rbf",
                  "-e", "1", "-#", "20", "-n", "10", "train.svml", "im"])
    ivm_cli.main(["test", "train.svml", "im"])
    out = capsys.readouterr().out
    assert "Classification error" in out
    ivm_cli.main(["predict", "train.svml", "im", "preds"])
    assert os.path.exists("preds")
    ivm_cli.main(["class-one-probabilities", "train.svml", "im", "probs"])
    probs = np.loadtxt("probs")
    assert probs.shape[0] == 30 and np.all((probs >= 0) & (probs <= 1))
    ivm_cli.main(["log-likelihood", "train.svml", "im"])
    assert "log likelihood" in capsys.readouterr().out
    ivm_cli.main(["gnuplot", "train.svml", "im", "iv"])
    assert os.path.exists("iv_prob_matrix.dat") and os.path.exists("iv_plot.gp")


def test_ivm_regression_mode(in_tmp, capsys):
    from gpc_tpu.io.svml import write_svml
    rng = np.random.default_rng(1)
    X = rng.standard_normal((25, 2))
    y = np.sin(X[:, 0])
    write_svml("r.svml", X, y)
    ivm_cli.main(["-s", "1", "-v", "0", "learn", "-o", "regression", "-a", "10",
                  "-k", "rbf", "-e", "1", "-#", "15", "-n", "5", "r.svml", "rm"])
    ivm_cli.main(["test", "r.svml", "rm"])
    assert "Mean Squared Error" in capsys.readouterr().out


def test_gplvm_learn_display_gnuplot(in_tmp, capsys):
    gplvm_cli.main(["-s", "2", "-v", "1", "learn", "-#", "15", OIL100, "gm"])
    assert "GPLVM Model" in capsys.readouterr().out
    gplvm_cli.main(["display", "gm"])
    assert "Latent dimension: 2" in capsys.readouterr().out
    gplvm_cli.main(["gnuplot", "gm", "gl"])
    assert os.path.exists("gl_variance_matrix.dat") and os.path.exists("gl_plot.gp")
    # oil labels {1,2,3} produce per-label latent scatters
    assert os.path.exists("gl_latent_data1.dat")


def test_gplvm_bad_init_type(in_tmp):
    with pytest.raises(SystemExit):
        gplvm_cli.main(["learn", "-I", "magic", OIL100, "x"])


def test_ivm_ratquad_alpha_flag(in_tmp):
    from gpc_tpu.io.svml import write_svml
    rng = np.random.default_rng(2)
    X = np.vstack([rng.standard_normal((10, 2)) + 2, rng.standard_normal((10, 2)) - 2])
    y = np.concatenate([np.ones(10), -np.ones(10)])
    write_svml("t.svml", X, y)
    ivm_cli.main(["-s", "1", "-v", "0", "learn", "-a", "8", "-k", "ratquad",
                  "-@", "2.5", "-e", "1", "-#", "5", "-n", "2", "t.svml", "rq"])
    assert os.path.exists("rq")


def test_gp_relearn_optimiser_flag(in_tmp):
    gp_cli.main(["-s", "1", "-v", "0", "learn", "-#", "10", SINC, "ro"])
    gp_cli.main(["-v", "0", "relearn", "-O", "quasinew", "-#", "5", SINC,
                 "ro", "ro2"])
    assert os.path.exists("ro2")


def test_ivm_relearn_active_size_flag(in_tmp):
    from gpc_tpu.io.svml import write_svml
    rng = np.random.default_rng(3)
    X = np.vstack([rng.standard_normal((12, 2)) + 2, rng.standard_normal((12, 2)) - 2])
    y = np.concatenate([np.ones(12), -np.ones(12)])
    write_svml("t2.svml", X, y)
    ivm_cli.main(["-s", "1", "-v", "0", "learn", "-a", "8", "-k", "rbf",
                  "-e", "1", "-#", "5", "-n", "2", "t2.svml", "ra"])
    ivm_cli.main(["-s", "1", "-v", "0", "relearn", "-a", "12", "-e", "1",
                  "-#", "5", "-n", "2", "t2.svml", "ra", "ra2"])
    from gpc_tpu.io import model_io as mio
    m = mio.read_ivm("ra2")
    assert m.spec.num_active == 12
    assert mio.read_ivm("ra").spec.num_active == 8  # input model untouched
    # -a is REQUIRED on relearn (ivm.cpp:143-144)
    with pytest.raises(SystemExit):
        ivm_cli.main(["relearn", "t2.svml", "ra"])
    # dimension mismatch is rejected (ivm.cpp:178-179)
    rngb = np.random.default_rng(9)
    write_svml("bad_dim.svml", rngb.standard_normal((10, 3)),
               np.sign(rngb.standard_normal(10)))
    with pytest.raises(SystemExit):
        ivm_cli.main(["relearn", "-a", "8", "bad_dim.svml", "ra"])


def test_gp_learn_matlab_format(in_tmp, capsys):
    """-f 1 reads MATLAB data files (CClctrl.cpp:179-189 _NDLMATLAB path)."""
    import scipy.io
    from gpc_tpu.io.svml import read_svml
    X, y = read_svml(SINC)
    scipy.io.savemat("sinc.mat", {"X": X, "y": y.reshape(-1, 1)})
    gp_cli.main(["-s", "42", "-v", "1", "learn", "-f", "1", "-#", "30",
                 "sinc.mat", "mmat"])
    out = capsys.readouterr().out
    assert "rbfinverseWidth" in out
    with pytest.raises(SystemExit):
        gp_cli.main(["learn", "-f", "2", SINC])
    with pytest.raises(SystemExit):
        scipy.io.savemat("bad.mat", {"X": X})
        gp_cli.main(["learn", "-f", "1", "bad.mat"])


def test_ivm_gnuplot_regression_2d(in_tmp):
    """Gaussian-noise IVM gnuplot, 2-D branch (ivm.cpp:1108-1156)."""
    from gpc_tpu.io.svml import write_svml
    rng = np.random.default_rng(1)
    X = rng.standard_normal((25, 2))
    y = np.sin(X[:, 0])
    write_svml("r2.svml", X, y)
    ivm_cli.main(["-s", "1", "-v", "0", "learn", "-o", "regression", "-a", "10",
                  "-k", "rbf", "-e", "1", "-#", "15", "-n", "5", "r2.svml", "rg"])
    ivm_cli.main(["gnuplot", "r2.svml", "rg", "rv"])
    for f in ("rv_active_set.dat", "rv_scatter_data.dat",
              "rv_output_matrix.dat", "rv_plot.gp"):
        assert os.path.exists(f), f
    # active-set file carries the target column (ivm.cpp:1089-1095)
    act = np.loadtxt("rv_active_set.dat")
    assert act.shape == (10, 3)
    assert not np.allclose(act[:, 2], 0.0)
    assert "splot" in open("rv_plot.gp").read()


def test_ivm_gnuplot_regression_1d(in_tmp):
    """Gaussian-noise IVM gnuplot, 1-D line + ±1σ error bars (ivm.cpp:1157-1202)."""
    from gpc_tpu.io.svml import write_svml
    rng = np.random.default_rng(2)
    X = rng.standard_normal((20, 1))
    y = np.sin(2 * X[:, 0])
    write_svml("r1.svml", X, y)
    ivm_cli.main(["-s", "1", "-v", "0", "learn", "-o", "regression", "-a", "8",
                  "-k", "rbf", "-e", "1", "-#", "15", "-n", "5", "r1.svml", "rg1"])
    ivm_cli.main(["-v", "0", "gnuplot", "-r", "40", "r1.svml", "rg1", "rw"])
    for f in ("rw_line_data.dat", "rw_error_bar_data.dat",
              "rw_scatter_data.dat", "rw_active_set.dat", "rw_plot.gp"):
        assert os.path.exists(f), f
    line = np.loadtxt("rw_line_data.dat")
    assert line.shape == (40, 2)
    # error bars are mean ± ONE predictive std (ivm.cpp:1177-1180)
    bars = np.loadtxt("rw_error_bar_data.dat")
    assert bars.shape == (80, 2)
    plus, minus = bars[:40, 1], bars[40:, 1]
    np.testing.assert_allclose((plus + minus) / 2.0, line[:, 1], atol=1e-10)
    assert np.all(plus > minus)
    assert "error_bar_data" in open("rw_plot.gp").read()


def test_gplvm_dynamics_cli(in_tmp, capsys):
    """GPDM via the CLI: -D dynamics kernel, -ds scale, -dr fixed SNR
    (gplvm.cpp:452-501 — SNR mode sets the dynamics white variance to
    scale/ratio² and freezes the dynamics kernel parameters)."""
    gplvm_cli.main(["-s", "4", "-v", "1", "learn", "-D", "rbf", "-ds", "0.5",
                    "-dr", "10", "-#", "8", OIL100, "gd"])
    assert "GPLVM Model" in capsys.readouterr().out
    from gpc_tpu.io import model_io as mio
    m, _ = mio.read_gplvm("gd")
    assert m.spec.has_dynamics
    gplvm_cli.main(["display", "gd"])
    assert "Latent dimension: 2" in capsys.readouterr().out
    # -dr / -ds before any -D kernel is declared is an error (gplvm.cpp:163+)
    with pytest.raises(SystemExit):
        gplvm_cli.main(["learn", "-dr", "10", OIL100, "x"])
    with pytest.raises(SystemExit):
        gplvm_cli.main(["learn", "-ds", "0.5", OIL100, "x"])
    # -D WITHOUT -dr still applies the reference's DEFAULT fixed SNR of 20
    # (gplvm.cpp:115, 499-500, 547): dynamics white variance pinned to
    # scale/ratio² = 0.5/400 and the dynamics kernel params frozen
    gplvm_cli.main(["-s", "4", "-v", "0", "learn", "-D", "rbf", "-#", "3",
                    OIL100, "gd2"])
    m2, _ = mio.read_gplvm("gd2")
    dp = np.asarray(m2.dyn_kern_params())
    np.testing.assert_allclose(dp[-1], 0.5 / 400.0, rtol=1e-12)


def test_gplvm_back_constraint_cli(in_tmp, capsys):
    """Kernel back constraints via the CLI: -c computes bK on Y and optimises
    A with X = bK·A (gplvm.cpp:373-376, 527-537)."""
    gplvm_cli.main(["-s", "5", "-v", "0", "learn", "-c", "rbf", "-#", "8",
                    OIL100, "gb"])
    from gpc_tpu.io import model_io as mio
    m, _ = mio.read_gplvm("gb")
    # back-constraint info is not serialized (the reference leaves a 'goes
    # here' placeholder, CGplvm.cpp) — the latent coordinates themselves are
    assert m.latent_X().shape == (100, 2)


def test_ivm_labelled_indices_ncnm(in_tmp, capsys):
    """-l with NCNM blanks the labels of unlisted points (ivm.cpp:492-504)."""
    from gpc_tpu.io.svml import write_svml
    rng = np.random.default_rng(6)
    X = np.vstack([rng.standard_normal((12, 2)) + 2,
                   rng.standard_normal((12, 2)) - 2])
    y = np.concatenate([np.ones(12), -np.ones(12)])
    write_svml("l.svml", X, y)
    with open("lab.idx", "w") as f:
        f.write("".join(f"{i}\n" for i in range(1, 9)))  # 1-based indices
    ivm_cli.main(["-s", "1", "-v", "1", "learn", "-o", "ncnm", "-a", "10",
                  "-k", "rbf", "-e", "1", "-#", "5", "-n", "2",
                  "-l", "lab.idx", "l.svml", "nm"])
    out = capsys.readouterr().out
    assert "Removed labels from 16 points" in out
    from gpc_tpu.io import model_io as mio
    m = mio.read_ivm("nm")
    assert type(m.spec.noise).__name__ == "NcnmNoise"
    # relearn with -l on an NCNM model keeps ALL rows and blanks unlisted
    # labels (ivm.cpp:183-206 branches on the noise type)
    ivm_cli.main(["-s", "1", "-v", "1", "relearn", "-a", "10", "-e", "1",
                  "-#", "5", "-n", "2", "-l", "lab.idx", "l.svml",
                  "nm", "nm2"])
    out = capsys.readouterr().out
    assert "Removed labels from 16 points" in out
    assert mio.read_ivm("nm2").spec.n_data == 24
    # out-of-range index is rejected
    with open("bad.idx", "w") as f:
        f.write("40\n")
    with pytest.raises(SystemExit):
        ivm_cli.main(["-s", "1", "learn", "-o", "ncnm", "-a", "5", "-k", "rbf",
                      "-l", "bad.idx", "l.svml", "x"])


def test_ivm_labelled_indices_probit_subset(in_tmp, capsys):
    """-l without NCNM reduces the data to the labelled subset
    (ivm.cpp: probit branch — train on indexed rows only)."""
    from gpc_tpu.io.svml import write_svml
    rng = np.random.default_rng(7)
    X = np.vstack([rng.standard_normal((12, 2)) + 2,
                   rng.standard_normal((12, 2)) - 2])
    y = np.concatenate([np.ones(12), -np.ones(12)])
    write_svml("l2.svml", X, y)
    with open("lab2.idx", "w") as f:
        f.write("".join(f"{i}\n" for i in list(range(1, 7)) + list(range(13, 19))))
    ivm_cli.main(["-s", "1", "-v", "1", "learn", "-a", "8", "-k", "rbf",
                  "-e", "1", "-#", "5", "-n", "2",
                  "-l", "lab2.idx", "l2.svml", "pm"])
    out = capsys.readouterr().out
    assert "contains 12 points" in out
    from gpc_tpu.io import model_io as mio
    m = mio.read_ivm("pm")
    assert type(m.spec.noise).__name__ == "ProbitNoise"
    assert m.spec.n_data == 12


def test_probit_on_labelled_crescent(in_tmp, capsys):
    """The reference README's comparison run: probit IVM on the
    labelled-only crescent subset (semisupercrescent_labelled.svml,
    reference README.md:367 bottom plot)."""
    data = "/root/reference/examples/semisupercrescent_labelled.svml"
    ivm_cli.main(["-s", "1", "-v", "0", "learn", "-a", "20", "-k", "rbf",
                  "-e", "2", "-#", "30", "-n", "10", data, "sl"])
    ivm_cli.main(["test", data, "sl"])
    out = capsys.readouterr().out
    assert "Classification error" in out
    # the 39 labelled points are linearly separated crescents — training
    # error should be low
    err = float(out.split("Classification error on output 1:")[1].split("%")[0])
    assert err <= 10.0


def test_gp_gnuplot_classification(in_tmp):
    """probit/ncnm gp gnuplot branch (gp.cpp:635-750): probability grid,
    class scatter files, decision/contour script, inducing-set file."""
    from gpc_tpu.io import model_io as mio
    from gpc_tpu.io.svml import write_svml
    rng = np.random.default_rng(0)
    X = np.vstack([rng.standard_normal((15, 2)) + 2,
                   rng.standard_normal((15, 2)) - 2])
    y = np.concatenate([np.ones(15), -np.ones(15)])
    write_svml("c.svml", X, y)
    gp_cli.main(["-s", "7", "-v", "0", "learn", "-A", "dtc", "-a", "6",
                 "-#", "10", "c.svml", "cm"])
    # retag the stored model as a probit classifier (classification gp model
    # files come from outside the gp CLI in the reference too — its learn
    # only ever builds CGaussianNoise, gp.cpp:379-388)
    model = mio.read_gp("cm")
    model.noise_type = "probit"
    model.noise_params = np.array([0.0, 1e-6])
    mio.write_gp("cm_probit", model)
    gp_cli.main(["gnuplot", "-r", "20", "c.svml", "cm_probit", "cp"])
    for f in ("cp_inducing_set.dat", "cp_positive.dat", "cp_negative.dat",
              "cp_prob_matrix.dat", "cp_plot.gp"):
        assert os.path.exists(f), f
    probs = np.loadtxt("cp_prob_matrix.dat")
    assert probs.shape == (400, 3)
    assert np.all((probs[:, 2] >= 0) & (probs[:, 2] <= 1))
    assert probs[:, 2].max() > 0.8 and probs[:, 2].min() < 0.2
    gp_script = open("cp_plot.gp").read()
    assert "cntrparam levels discrete 0.5" in gp_script
    assert "0.25, 0.75" in gp_script
    # 1-D classification model must be rejected (gp.cpp:624-626)
    rng = np.random.default_rng(1)
    X1 = rng.standard_normal((10, 1))
    write_svml("c1.svml", X1, np.sign(X1[:, 0]))
    gp_cli.main(["-s", "7", "-v", "0", "learn", "-#", "5", "c1.svml", "g1"])
    m1 = mio.read_gp("g1")
    m1.noise_type = "probit"
    m1.noise_params = np.array([0.0, 1e-6])
    mio.write_gp("g1p", m1)
    with pytest.raises(SystemExit):
        gp_cli.main(["gnuplot", "c1.svml", "g1p", "x"])
