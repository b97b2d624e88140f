"""precision='fast' plumbing added after the round-3 resident work:
the f32 host eigh (ssyevd) fast tier (ops/eigen.py factor_dtype,
fit_null_model eigh_dtype) and its routing from the facades. The f32
eigh keeps p-values inside the fp32 device envelope, and 'fast'
rescores reported hits exactly anyway.
"""

import numpy as np
import pytest

from mixmogam_tpu import oracle
from mixmogam_tpu.data.simulate import simulate_genotypes, simulate_phenotype
from mixmogam_tpu.models.emmax import emmax
from mixmogam_tpu.ops.eigen import eigen_k
from mixmogam_tpu.ops.reml import fit_null_model


@pytest.fixture(scope="module")
def small():
    G, ch, po = simulate_genotypes(128, 600, seed=21)
    y, causal = simulate_phenotype(G, h2=0.6, n_causal=3, seed=21)
    K = oracle.scale_k(oracle.ibs_kinship(G.astype(np.float64)))
    return G, y, K


class TestF32Eigh:
    def test_factor_dtype_values(self, small):
        _, _, K = small
        phi64, U64 = eigen_k(K)
        phi32, U32 = eigen_k(K, factor_dtype=np.float32)
        phi64, phi32 = np.asarray(phi64), np.asarray(phi32)
        assert phi32.shape == phi64.shape
        scale = np.abs(phi64).max()
        assert np.abs(phi32 - phi64).max() / scale < 1e-5
        # eigenvectors: compare the reconstructed K (basis may flip sign)
        U64, U32 = np.asarray(U64, np.float64), np.asarray(U32, np.float64)
        K64 = (U64 * phi64) @ U64.T
        K32 = (U32 * phi32.astype(np.float64)) @ U32.T
        assert np.abs(K32 - K64).max() / scale < 1e-5

    def test_null_fit_eigh_dtype(self, small):
        _, y, K = small
        n = len(y)
        n64 = fit_null_model(y, np.ones((n, 1)), K=K)
        n32 = fit_null_model(y, np.ones((n, 1)), K=K,
                             eigh_dtype=np.float32)
        d64, d32 = float(n64.delta), float(n32.delta)
        assert abs(d32 - d64) / max(d64, 1e-12) < 1e-3
        assert abs(float(n32.ll) - float(n64.ll)) < 1e-3

    def test_fast_precision_routes_f32_eigh_and_stays_exact_grade(
            self, small):
        G, y, K = small
        exact = emmax(G, y, K=K)
        fast = emmax(G, y, K=K, precision="fast")
        assert fast["precision_tier"] != ""
        idx = fast["rescored_idx"]
        if len(idx):
            # a fast tier ran: every rescored (reported) hit exact-grade
            lp_f = -np.log10(np.maximum(fast["ps"][idx], 1e-300))
            lp_e = -np.log10(np.maximum(exact["ps"][idx], 1e-300))
            assert np.abs(lp_f - lp_e).max() < 1e-6
        # on CPU 'fast' resolves to the exact tier (resolve_precision),
        # so the whole scan — not just rescored hits — is exact-grade;
        # either way the body stays inside the fast-tier envelope
        lp_all_f = -np.log10(np.maximum(fast["ps"], 1e-300))
        lp_all_e = -np.log10(np.maximum(exact["ps"], 1e-300))
        assert np.abs(lp_all_f - lp_all_e).max() < 0.1
        assert (np.argmin(fast["ps"]) == np.argmin(exact["ps"]))
