"""gpc_tpu — a Gaussian-process framework in JAX, run on NVIDIA GPUs.

A from-scratch JAX/XLA re-design of the capability surface of the
SheffieldML/GPc C++ toolkit: compositional covariance functions,
Gaussian/probit/ordered/NCNM likelihoods, full and sparse GP regression
(FTC/DTC/DTCVAR/FITC), GP-LVM / GPDM latent-variable models, the IVM
active-set classifier, and a Scaled Conjugate Gradient trainer — all expressed
as pure, jit-compiled, differentiable functions that shard over device meshes.

Unlike the reference (single-threaded C++ on BLAS/LAPACK, hand-derived gradients),
gpc_tpu computes the negative log marginal likelihood as one differentiable graph:
Gram matrices are built by fused XLA kernels, Cholesky factorizations stay
on-device, and hyperparameter gradients come from `jax.grad`.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# On a Hopper GPU an f32 matmul below "highest" runs on the tensor cores in
# TF32 (10-bit mantissa): against a float64 product, "high" and "default"
# both give 3e-4 relative error on an 8192-deep product, "highest" 4e-6
# (measured on an H100, PERF.md "Bring-up findings").  In GP algebra that
# error enters the squared distances of every Gram entry: against float64,
# an rbf evidence (logdet + quad) drifts 5.2e-5 at N=4096 at "high" against
# 5.8e-7 at "highest", and the NLML of an N=16384 GP-LVM trained for 100
# SCG iterations drifts 1.2e-1 at "high" against 3.4e-5 at "highest".  A
# GP library must factor a PD matrix accurately, so the default is full-f32
# "highest"; opt into TF32/bf16 speed per op (explicit casts,
# GPC_TPU_BF16_CHOL) or globally via the env var.
_prec = _os.environ.get("GPC_TPU_MATMUL_PRECISION", "highest")
if _prec != "unset":
    _jax.config.update("jax_default_matmul_precision", _prec)

from gpc_tpu import ndlutil, transforms, priors, linalg  # noqa: F401
