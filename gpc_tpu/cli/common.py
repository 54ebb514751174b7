"""Shared CLI machinery (counterpart of CClctrl.{h,cpp}).

Arg-cursor helpers, `-v` verbosity / `-s` seed handling (seed defaults to time,
CClctrl.cpp:3-12), SVM-light data loading, and the kernel-spec accumulation
grammar shared by the gp/gplvm/ivm tools (gp.cpp:150-250): repeatable `-k TYPE`
followed by per-kernel parameter flags (`-g` gamma stores 2γ as the inverse
width, gp.cpp:162-169; `-v/-w/-b/-d/-i`).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np

from gpc_tpu import kernels as KM
from gpc_tpu.io.svml import read_svml


class ExitError(SystemExit):
    def __init__(self, msg):
        super().__init__(f"Error: {msg}")


REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def compile_cache_dir():
    """Where setup_jax points JAX's persistent compilation cache, or None to
    leave JAX's own setting alone.

    JAX_COMPILATION_CACHE_DIR, when set, is JAX's own setting and wins: the
    program then sets no cache path.  GPC_TPU_CACHE_DIR=0 turns the cache
    off (the tests do this).  Otherwise the cache lives in one fixed
    directory of the checkout, `.jax_cache` (listed in .gitignore): the
    path is part of the cache key, so a fixed path is what lets a later
    run find what an earlier one compiled."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    if os.environ.get("GPC_TPU_CACHE_DIR") == "0":
        return None
    return REPO_CACHE_DIR


def setup_jax():
    """Select the backend and the compile cache for CLI runs.

    GPC_TPU_PLATFORM=cpu|gpu picks the backend (gpc_tpu/backend.py); on CPU
    float64 is enabled to match the double-precision reference, and asking
    for gpu with no card present is an error.

    A persistent XLA compilation cache makes warm CLI runs compile-free: at
    reference-tutorial sizes the numeric work is milliseconds and XLA
    compilation is the entire wall clock (`compile_cache_dir` says where it
    lives)."""
    import jax

    from gpc_tpu import backend

    backend.select_platform()
    cache = compile_cache_dir()
    if cache is not None:
        os.makedirs(cache, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache)
    if jax.config.jax_compilation_cache_dir:
        # cache every compile, not just the >1s ones — tutorial-size
        # programs are small but numerous
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)


class CommandLine:
    def __init__(self, argv):
        self.argv = list(argv)
        self.pos = 0
        self.verbosity = 2
        self.seed = int(time.time())
        self.file_format = 0
        self.mode = ""

    # --- cursor helpers (CClctrl.h:74-120) ---------------------------------
    def current(self):
        if self.pos >= len(self.argv):
            raise ExitError("There are not enough input parameters.")
        return self.argv[self.pos]

    def advance(self):
        self.pos += 1

    def next_value(self):
        self.advance()
        return self.current()

    def has_more(self):
        return self.pos < len(self.argv)

    def is_flag(self):
        return self.has_more() and self.current().startswith("-")

    def get_bool(self):
        v = self.next_value()
        if v in ("1", "true", "True"):
            return True
        if v in ("0", "false", "False"):
            return False
        raise ExitError(f"Current argument {v} is not boolean.")

    def get_int(self):
        return int(self.next_value())

    def get_double(self):
        return float(self.next_value())

    def get_string(self):
        return self.next_value()

    # --- global flags (-v, -s) --------------------------------------------
    def eat_global_flags(self):
        """Consume leading -v/-s flags before the command word (CClctrl)."""
        while self.is_flag():
            if self.current() in ("-v", "--verbosity"):
                self.verbosity = self.get_int()
                self.advance()
            elif self.current() in ("-s", "--seed"):
                self.seed = self.get_int()
                self.advance()
            else:
                break


class KernelSpecParser:
    """Accumulates -k/-g/-d/-w/-b/-v/-i kernel specs (gp.cpp:150-250)."""

    def __init__(self):
        self.types = []
        self.usage = []            # 'fwd' | 'back' | 'dyn'
        self.ratquad_alphas = []
        self.inv_widths = []
        self.weight_vars = []
        self.bias_vars = []
        self.variances = []
        self.degrees = []
        self.select_inputs = []

    def _check_last(self, what, allowed):
        if not self.types:
            raise ExitError(f"{what} specification must come after covariance function type is specified.")
        if allowed is not None and self.types[-1] not in allowed:
            raise ExitError(f"{what} parameter not valid for {self.types[-1]} covariance function.")

    def add_type(self, kern_type: str, usage="fwd"):
        """Append a kernel leaf with unset (-1.0) per-kernel parameters —
        the ONE place the parallel lists grow in lockstep (the gp/gplvm
        CLIs route -k/-c/-D through this)."""
        self.types.append(kern_type)
        self.usage.append(usage)
        for lst in (self.ratquad_alphas, self.inv_widths, self.weight_vars,
                    self.bias_vars, self.variances, self.degrees):
            lst.append(-1.0)
        self.select_inputs.append(False)

    def handle(self, cl: CommandLine, usage="fwd") -> bool:
        """Try to consume the current flag; returns True if consumed."""
        arg = cl.current()
        if arg in ("-k", "--kernel"):
            self.add_type(cl.get_string(), usage)
        elif arg in ("-g", "--gamma"):
            self._check_last("Inverse width", ("rbf", "exp", "ratquad"))
            self.inv_widths[-1] = 2 * cl.get_double()  # stores 2γ (gp.cpp:168)
        elif arg in ("-@", "--alpha"):
            # the reference's -@ handler mistakenly writes rbfInvWidths
            # (ivm.cpp:312-319) so alpha was never actually settable; we route
            # it to the ratquad alpha parameter as documented
            self._check_last("Alpha", ("ratquad",))
            self.ratquad_alphas[-1] = cl.get_double()
        elif arg in ("-d", "--degree"):
            self._check_last("Polynomial degree", ("poly",))
            self.degrees[-1] = cl.get_double()
        elif arg in ("-w", "--weight"):
            self._check_last("`Weight variance'", ("poly", "mlp"))
            self.weight_vars[-1] = cl.get_double()
        elif arg in ("-b", "--bias"):
            self._check_last("`Bias variance'", ("poly", "mlp"))
            self.bias_vars[-1] = cl.get_double()
        elif arg in ("-v", "--variance"):
            self._check_last("Variance", None)
            self.variances[-1] = cl.get_double()
        elif arg in ("-i", "--input-select"):
            self._check_last("Input selection flag", None)
            self.select_inputs[-1] = cl.get_bool()
        else:
            return False
        cl.advance()
        return True

    # per-kind variance parameter index for NCNM gamma priors (ivm.cpp:516-616;
    # ratquad's index-1 — the lengthScale — replicates the reference literally)
    _VAR_PRIOR_INDEX = {"lin": 0, "linard": 0, "poly": 2, "polyard": 2,
                        "rbf": 1, "rbfard": 1, "ratquad": 1, "mlp": 2,
                        "mlpard": 2, "bias": 0, "white": 0}

    def build(self, input_dim: int, usage="fwd", default_type=None,
              add_bias_white=True, variance_prior=None):
        """Assemble the compound kernel + params (gp.cpp:240-349).

        variance_prior: optional Prior attached to each component's variance
        (the NCNM L1-style regularizer, ivm.cpp:422-425, 516-616)."""
        comps = []
        params = []
        for i, t in enumerate(self.types):
            if self.usage[i] != usage:
                continue
            sel = self.select_inputs[i]
            if t == "lin":
                k = KM.Linard(input_dim=input_dim) if sel else KM.Lin(input_dim=input_dim)
                p = k.default_params()
                if self.variances[i] != -1.0:
                    p[0] = self.variances[i]
            elif t == "poly":
                deg = self.degrees[i] if self.degrees[i] != -1.0 else 2.0
                k = (KM.Polyard(input_dim=input_dim, degree=deg) if sel
                     else KM.Poly(input_dim=input_dim, degree=deg))
                p = k.default_params()
                for j, v in enumerate((self.weight_vars[i], self.bias_vars[i], self.variances[i])):
                    if v != -1.0:
                        p[j] = v
            elif t == "rbf":
                k = KM.Rbfard(input_dim=input_dim) if sel else KM.Rbf(input_dim=input_dim)
                p = k.default_params()
                if self.inv_widths[i] != -1.0:
                    p[0] = self.inv_widths[i]
                if self.variances[i] != -1.0:
                    p[1] = self.variances[i]
            elif t == "exp":
                if sel:
                    raise ExitError("Exponential covariance function not available with input selection yet.")
                k = KM.Exp(input_dim=input_dim)
                p = k.default_params()
                if self.inv_widths[i] != -1.0:
                    p[0] = self.inv_widths[i]
                if self.variances[i] != -1.0:
                    p[1] = self.variances[i]
            elif t == "ratquad":
                if sel:
                    raise ExitError("Rational quadratic covariance function not available with input selection yet.")
                k = KM.RatQuad(input_dim=input_dim)
                p = k.default_params()
                if self.ratquad_alphas[i] != -1.0:
                    p[0] = self.ratquad_alphas[i]
                if self.inv_widths[i] != -1.0:
                    p[1] = 1.0 / np.sqrt(self.inv_widths[i])  # gp.cpp:296
                if self.variances[i] != -1.0:
                    p[2] = self.variances[i]
            elif t == "mlp":
                k = KM.Mlpard(input_dim=input_dim) if sel else KM.Mlp(input_dim=input_dim)
                p = k.default_params()
                for j, v in enumerate((self.weight_vars[i], self.bias_vars[i], self.variances[i])):
                    if v != -1.0:
                        p[j] = v
            elif t in ("matern32", "matern52"):
                # extension beyond the reference CLI grammar (the model layer
                # and BASELINE.json configs use these; gp.cpp never exposed them)
                if sel:
                    raise ExitError(f"{t} covariance function not available with input selection yet.")
                k = (KM.Matern32(input_dim=input_dim) if t == "matern32"
                     else KM.Matern52(input_dim=input_dim))
                p = k.default_params()
                if self.variances[i] != -1.0:
                    p[1] = self.variances[i]
            elif t == "bias" and usage != "fwd":
                k = KM.Bias(input_dim=input_dim)
                p = k.default_params()
                if self.variances[i] != -1.0:
                    p[0] = self.variances[i]
            elif t == "white" and usage != "fwd":
                k = KM.White(input_dim=input_dim)
                p = k.default_params()
                if self.variances[i] != -1.0:
                    p[0] = self.variances[i]
            else:
                raise ExitError(f"Unknown covariance function type: {t}")
            if variance_prior is not None and t in self._VAR_PRIOR_INDEX and t != "exp":
                k = k.with_priors([dataclasses.replace(
                    variance_prior, index=self._VAR_PRIOR_INDEX[t])])
            comps.append(k)
            params.append(p)

        if not comps and default_type is not None:
            k = KM.make_kern(default_type, input_dim)
            if variance_prior is not None and default_type in self._VAR_PRIOR_INDEX:
                k = k.with_priors([dataclasses.replace(
                    variance_prior, index=self._VAR_PRIOR_INDEX[default_type])])
            comps.append(k)
            params.append(k.default_params())
        if add_bias_white:
            # fwd kernels always get bias + white appended (gp.cpp:346-349)
            for k in (KM.Bias(input_dim=input_dim), KM.White(input_dim=input_dim)):
                if variance_prior is not None:
                    k = k.with_priors([dataclasses.replace(variance_prior, index=0)])
                comps.append(k)
                params.append(k.default_params())
        kern = KM.Cmpnd(input_dim=input_dim, components=tuple(comps))
        return kern, np.concatenate(params) if params else np.zeros(0)


def load_data(path, file_format: int = 0):
    """CClctrl::readData (CClctrl.cpp:173-199): format 0 = SVM-light, format 1
    = MATLAB .mat with variables X and y (the reference's _NDLMATLAB path,
    here via scipy.io so GPmat-produced data files interoperate)."""
    if file_format == 0:
        return read_svml(path)
    if file_format == 1:
        import scipy.io
        try:
            mat = scipy.io.loadmat(path)
        except Exception as e:  # noqa: BLE001 - map to the CLI error discipline
            raise ExitError(f"Unable to read MATLAB file {path}: {e}")
        missing = [k for k in ("X", "y") if k not in mat]
        if missing:
            raise ExitError(f"MATLAB file {path} lacks variable(s): "
                            + ", ".join(missing))
        X = np.atleast_2d(np.asarray(mat["X"], dtype=np.float64))
        y = np.asarray(mat["y"], dtype=np.float64)
        if y.ndim == 1:
            y = y.reshape(-1, 1)  # match read_svml's (N, D) convention
        return X, y
    raise ExitError("Unrecognised file format number.")


def write_unheaded(path, M, comment=None):
    """CMatrix::toUnheadedFile equivalent: rows of 17-digit scientific values."""
    M = np.atleast_2d(np.asarray(M))
    with open(path, "w") as f:
        if comment:
            f.write(f"# {comment}\n")
        for row in M:
            f.write(" ".join(f"{v:.17e}" for v in row) + "\n")
