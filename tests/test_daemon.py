"""Warm-process CLI daemon (cli/daemon.py): spawn, run, parity, stop.

The daemon must produce byte-identical model files to the one-shot CLI for
the same seed, survive error requests, and shut down on command."""

import os
import subprocess
import sys

import numpy as np
import pytest

from gpc_tpu.cli import daemon



@pytest.fixture
def daemon_env(tmp_path, monkeypatch):
    sock = tmp_path / "d.sock"
    monkeypatch.setenv("GPC_TPU_DAEMON_SOCKET", str(sock))
    monkeypatch.setenv("GPC_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("GPC_TPU_DAEMON_IDLE", "120")
    monkeypatch.setenv(
        "PYTHONPATH", os.pathsep.join(
            [p for p in (os.environ.get("PYTHONPATH", ""),) if p] +
            [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]))
    yield tmp_path
    daemon.stop()


def test_daemon_learn_matches_oneshot(daemon_env, sinc_svml, capsys):
    SINC = sinc_svml
    tmp = daemon_env
    mdl_d = tmp / "model_daemon"
    mdl_s = tmp / "model_oneshot"
    rc = daemon.client_run(
        "gp", ["-s", "17", "learn", "-#", "20", SINC, str(mdl_d)])
    assert rc == 0, capsys.readouterr().err
    out = capsys.readouterr().out
    assert "Final objective" in out

    env = dict(os.environ)
    res = subprocess.run(
        [sys.executable, "-m", "gpc_tpu.cli.gp", "-s", "17", "learn",
         "-#", "20", SINC, str(mdl_s)],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr

    def strip_comment(p):
        return [l for l in p.read_text().splitlines()
                if not l.startswith("#")]
    assert strip_comment(mdl_d) == strip_comment(mdl_s)

    # warm second request reuses the live process: display round-trip
    rc = daemon.client_run("gp", ["display", str(mdl_d)])
    assert rc == 0
    assert "rbfvariance" in capsys.readouterr().out


def test_daemon_survives_errors(daemon_env, capsys):
    rc = daemon.client_run("gp", ["learn", "/nonexistent.svml", "x"])
    assert rc != 0
    assert "Error" in capsys.readouterr().err
    # daemon still alive and serving
    rc = daemon.client_run("gp", ["display", "/nonexistent_model"])
    assert rc != 0
