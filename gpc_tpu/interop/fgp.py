"""fGP-equivalent stateful convenience API (reference mex/fGP.mex.cpp:1-318).

The reference ships a MATLAB mex gateway holding ONE global CGp model with
four commands — train / retrain / query / clear — used for embedding GP
regression in a larger MATLAB program (reference README.md:805-819).  The
JAX equivalent is this module-level API (callable from Python or via
the dispatch function `fgp(command, *args)`), with the same semantics:

* ``train(kernels, X, Y, verbose=1)`` — kernels is the mex's letter string
  (``r`` RBF, ``e`` exponential/OU, ``w`` white, ``l`` linear, ``B`` bias,
  fGP.mex.cpp:121-146; NOTE: unlike the `gp` CLI, bias+white are NOT
  auto-appended), Y single-column; builds an FTC CGp with Gaussian noise,
  bias = column mean, scale = 1, β = 1, scales not learnt, and runs SCG for
  100 iterations (fGP.mex.cpp:160-174).
* ``retrain(X, Y, verbose=1)`` — new data, same kernel object: the learned
  hyperparameters warm-start the next 100 SCG iterations
  (fGP.mex.cpp:176-254 constructs a new CGp around the surviving
  globalKern).
* ``query(X, want_variance=False)`` — posterior mean (and variance) at X
  (fGP.mex.cpp:279-318).
* ``clear()`` — drop the global state (fGP.mex.cpp:256-277).
"""

from __future__ import annotations

import numpy as np

from gpc_tpu import kernels as K
from gpc_tpu.models.gp import GP

_KERNEL_LETTERS = {
    "r": K.Rbf,
    "e": K.Exp,
    "w": K.White,
    "l": K.Lin,
    "B": K.Bias,
}

_state: dict = {"model": None, "kern": None, "server": None}


def _build_kern(kernels: str, input_dim: int):
    comps = []
    for i, ch in enumerate(kernels):
        if ch not in _KERNEL_LETTERS:
            raise ValueError(
                f"The kernel string ('{kernels}') contains illegal character "
                f"'{ch}' at position {i + 1} (unrecognised kernel type)!")
        comps.append(_KERNEL_LETTERS[ch](input_dim=input_dim))
    return K.Cmpnd(input_dim=input_dim, components=tuple(comps))


def _check_xy(X, Y):
    X = np.asarray(X, dtype=np.float64)
    Y = np.asarray(Y, dtype=np.float64)
    if X.ndim != 2 or X.size == 0:
        raise ValueError("X data: expected non-empty 2-D array")
    if Y.ndim == 1:
        Y = Y[:, None]
    if Y.shape != (X.shape[0], 1):
        raise ValueError(
            f"Y data: expected vector {X.shape[0]}x1, got {Y.shape}")
    return X, Y


def train(kernels: str, X, Y, verbose: int = 1, iters: int = 100):
    """fGP('train', kernels, X, Y[, verbose]) (fGP.mex.cpp:57-174)."""
    X, Y = _check_xy(X, Y)
    kern = _build_kern(kernels, X.shape[1])
    model = GP(kern, X, Y, approx="ftc", centre=True, scale_data=False,
               learn_scales=False)
    res = model.optimise(iters=iters)
    _state["model"] = model
    _state["kern"] = kern
    _state["server"] = None          # posterior state re-factors lazily
    return float(res.obj)


def retrain(X, Y, verbose: int = 1, iters: int = 100):
    """fGP('retrain', X, Y[, verbose]) — new data, hyperparameters
    warm-started from the surviving kernel (fGP.mex.cpp:176-254)."""
    prev = _state["model"]
    if prev is None:
        raise RuntimeError(
            "Model was not previously trained and thus cannot be retrained!")
    X, Y = _check_xy(X, Y)
    if X.shape[1] != prev.spec.input_dim:
        raise ValueError(
            f"X data: expected non-empty Mx{prev.spec.input_dim} array")
    model = GP(_state["kern"], X, Y, approx="ftc", centre=True,
               scale_data=False, learn_scales=False)
    # FTC θ layout is [kernel transParams] — carry the trained values over
    model.theta = prev.theta
    res = model.optimise(iters=iters)
    _state["model"] = model
    _state["server"] = None          # posterior state re-factors lazily
    return float(res.obj)


def query(X, want_variance: bool = False):
    """fGP('query', X) → mean [, variance] (fGP.mex.cpp:279-318)."""
    model = _state["model"]
    if model is None:
        raise RuntimeError(
            "Model was not previously trained and thus cannot be queried!")
    X = np.asarray(X, dtype=np.float64)
    if X.ndim != 2 or X.shape[1] != model.spec.input_dim:
        raise ValueError(
            f"X data: expected non-empty Mx{model.spec.input_dim} array")
    # factor once, serve repeatedly: the fGP use case is a stream of
    # queries from a host program, and GP.predict would re-run the O(N³)
    # posterior Cholesky on every call (serving.GPServer pins prediction
    # parity with GP.predict in tests/test_serving.py)
    if _state["server"] is None:
        from gpc_tpu.serving import GPServer
        _state["server"] = GPServer(model)
    mu, var = _state["server"].predict(X)
    if want_variance:
        return np.asarray(mu), np.asarray(var)
    return np.asarray(mu)


def clear():
    """fGP('clear') (fGP.mex.cpp:256-277)."""
    _state["model"] = None
    _state["kern"] = None
    _state["server"] = None


def fgp(command: str, *args, **kwargs):
    """String-dispatch gateway mirroring mexFunction (fGP.mex.cpp:18-54)."""
    table = {"train": train, "retrain": retrain, "query": query,
             "clear": clear}
    if command in ("", "help") or command not in table:
        raise ValueError(
            "Usage: fgp(command, *inputs) — commands: train, retrain, "
            "clear, query")
    return table[command](*args, **kwargs)
