"""Test configuration.

Correctness tests run on CPU with 8 virtual devices (standard JAX practice
for testing sharding without a pod — SURVEY.md §4.3) and float64 enabled so
oracle parity can be checked to ~1e-10. The float32 production path is
exercised by explicit-float32 tests (same code path, dtype-parametric).

JAX_PLATFORMS defaults to cpu here. Tests marked `gpu` need the card and
skip elsewhere (the `gpu` fixture decides, never the import); run them
on a GPU machine with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest


@pytest.fixture
def gpu():
    """The first JAX device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX found {dev.platform!r}); run "
                    "JAX_PLATFORMS=cuda python -m pytest -m gpu tests/")
    return dev


@pytest.fixture(scope="session")
def small_dataset():
    """200 samples x 500 SNPs structured binary genotypes + LMM phenotype."""
    from mixmogam_tpu.data.simulate import simulate_genotypes, simulate_phenotype

    G, chroms, poss = simulate_genotypes(200, 500, ploidy=1, seed=42)
    Gf = G.astype(np.float64)
    y, causal = simulate_phenotype(G, h2=0.6, n_causal=5, seed=42)
    return {"G": Gf, "G_int": G, "chromosomes": chroms, "positions": poss,
            "y": y, "causal": causal}


@pytest.fixture(scope="session")
def tiny_dataset():
    """50 samples x 60 SNPs — small enough for the O(M n^3) oracle EMMA."""
    from mixmogam_tpu.data.simulate import simulate_genotypes, simulate_phenotype

    G, chroms, poss = simulate_genotypes(50, 60, ploidy=1, seed=7)
    y, causal = simulate_phenotype(G, h2=0.5, n_causal=3, seed=7)
    return {"G": G.astype(np.float64), "G_int": G, "chromosomes": chroms,
            "positions": poss, "y": y, "causal": causal}


@pytest.fixture(scope="session")
def kinship_small(small_dataset):
    from mixmogam_tpu.oracle import ibs_kinship, scale_k

    return scale_k(ibs_kinship(small_dataset["G"]))


@pytest.fixture(scope="session")
def kinship_tiny(tiny_dataset):
    from mixmogam_tpu.oracle import ibs_kinship, scale_k

    return scale_k(ibs_kinship(tiny_dataset["G"]))
