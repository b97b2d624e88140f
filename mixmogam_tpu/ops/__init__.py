"""Device compute ops (JAX/XLA): the device replacements for the
reference's numpy/scipy hot paths (SURVEY.md L0/L3/L4)."""

import os as _os

import jax as _jax

#: the persistent compile cache's directory when JAX_COMPILATION_CACHE_DIR
#: is not set: fixed inside the checkout, because the path is part of the
#: cache key and a moving directory never hits
CHECKOUT_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__)))), ".jax_cache")

if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)

# Float matmuls run in true fp32 unless a tier asks for less: without the
# pin, a float32 dot on an NVIDIA GPU may run in TF32 (~10 mantissa bits),
# which breaks the exact tier's fp32 envelope
# (tests/test_kernels.py::TestFp32Characterization). bf16 and int8 dots
# pin precision=DEFAULT per dot.
_jax.config.update("jax_default_matmul_precision", "highest")

from mixmogam_tpu.ops.eigen import eigen_k, projected_spectrum
from mixmogam_tpu.ops.reml import (reml_from_spectrum, NullModel,
                                   fit_null_model, h2_profile_ci)
from mixmogam_tpu.ops.scan import emmax_scan_stats, RotatedNull, build_rotated_null

__all__ = [
    "eigen_k", "projected_spectrum", "reml_from_spectrum", "NullModel",
    "fit_null_model", "h2_profile_ci", "emmax_scan_stats", "RotatedNull", "build_rotated_null",
]
