"""Checks that only a GPU can make: what XLA's GPU compiler does with the
int8 grams and the precision pins. They skip elsewhere; on a GPU machine
run them with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest

from mixmogam_tpu import oracle
from mixmogam_tpu.data.simulate import simulate_genotypes, simulate_phenotype
from mixmogam_tpu.models import emmax
from mixmogam_tpu.ops import kinship as dk

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("ploidy", [1, 2])
def test_int8_kinship_exact_on_card(gpu, ploidy):
    """The diploid update once miscompiled through XLA's Triton GEMM at
    DEFAULT precision; the int8 grams must stay integer-exact."""
    G, _, _ = simulate_genotypes(200, 5000, ploidy=ploidy, seed=3)
    Ko = oracle.ibs_kinship(G.astype(np.float64), ploidy=ploidy)
    np.testing.assert_array_equal(dk.kinship(G, ploidy=ploidy), Ko)


def test_int8_gram_is_a_cublas_integer_gemm(gpu):
    S = jnp.zeros((256, 256), jnp.int32)
    C = jnp.zeros((2048, 256), jnp.int8)
    text = dk._ibs_int8_update.lower(S, C, 1).compile().as_text()
    calls = [ln for ln in text.splitlines()
             if 'custom_call_target="__cublas$gemm"' in ln]
    assert calls and all(re.search(r"s8\[", ln) for ln in calls)


def test_exact_tier_f32_envelope_on_card(gpu, small_dataset, kinship_small):
    G, y, K = small_dataset["G"], small_dataset["y"], kinship_small
    full = emmax(G, y, K=K)                 # float64 (tests enable x64)
    f32 = emmax(G, y, K=K, dtype=np.float32)
    lp = -np.log10(np.maximum(full["ps"], 1e-300))
    lp32 = -np.log10(np.maximum(f32["ps"], 1e-300))
    assert np.max(np.abs(lp - lp32)) < 0.05
    assert abs(full["pseudo_heritability"]
               - f32["pseudo_heritability"]) < 1e-4


@pytest.mark.parametrize("tier", ["int8x3", "int8x2", "bf16", "high"])
def test_tier_drift_within_bound_on_card(gpu, tier):
    from mixmogam_tpu.ops.scan import TIER_P_DRIFT

    G, _, _ = simulate_genotypes(1024, 4096, seed=4)
    y, _ = simulate_phenotype(G, seed=4)
    K = oracle.scale_k(oracle.ibs_kinship(G.astype(np.float64)))
    ex = emmax(G, y, K=K, dtype=np.float32, precision="exact")
    out = emmax(G, y, K=K, dtype=np.float32, precision=tier)
    assert np.max(np.abs(out["ps"] - ex["ps"])) <= TIER_P_DRIFT[tier]
