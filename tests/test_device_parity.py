"""Device (JAX) vs oracle parity — SURVEY.md §4.2: kinship, REML delta,
EMMAX p-values to <=1e-6 (these run on CPU x64 where parity lands ~1e-10;
the float32 production path is covered by looser-tolerance envelope
tests, e.g. test_kernels.py TestFp32Characterization)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mixmogam_tpu import oracle
from mixmogam_tpu.ops import kinship as dkinship
from mixmogam_tpu.ops.reml import fit_null_model, reml_from_spectrum
from mixmogam_tpu.ops.scan import build_rotated_null, emmax_scan_all, emmax_scan_stats
from mixmogam_tpu.ops.stats import f_sf, f_sf_host
from mixmogam_tpu.models import emmax, linear_model, anova, kruskal_wallis


class TestDeviceKinship:
    def test_ibs_binary_parity(self, small_dataset):
        G = small_dataset["G"]
        Ko = oracle.ibs_kinship(G)
        Kd = dkinship.kinship(G, method="ibs", chunk=128, dtype=jnp.float64)
        np.testing.assert_allclose(Kd, Ko, atol=1e-10)

    def test_ibs_binary_with_missing(self):
        from mixmogam_tpu.data.simulate import simulate_genotypes

        G, _, _ = simulate_genotypes(60, 300, missing_rate=0.05, seed=9)
        Gf = G.astype(np.float64)
        Gf[G < 0] = np.nan
        Ko = oracle.ibs_kinship(Gf)
        Kd = dkinship.kinship(G, method="ibs", chunk=77, dtype=jnp.float64)
        np.testing.assert_allclose(Kd, Ko, atol=1e-10)

    def test_ibs_diploid_parity(self):
        from mixmogam_tpu.data.simulate import simulate_genotypes

        G, _, _ = simulate_genotypes(50, 200, ploidy=2, seed=4)
        Ko = oracle.ibs_kinship(G.astype(np.float64), ploidy=2)
        Kd = dkinship.kinship(G, method="ibs", ploidy=2, chunk=64,
                              dtype=jnp.float64)
        np.testing.assert_allclose(Kd, Ko, atol=1e-10)

    def test_vanraden_parity(self, small_dataset):
        G = small_dataset["G"]
        Ko = oracle.vanraden_kinship(G, ploidy=1)
        Kd = dkinship.kinship(G, method="vanraden", ploidy=1, chunk=100,
                              dtype=jnp.float64)
        np.testing.assert_allclose(Kd, Ko, atol=1e-9)


class TestDeviceReml:
    def test_reml_delta_parity(self, small_dataset, kinship_small):
        y = small_dataset["y"]
        X0 = np.ones((len(y), 1))
        ro = oracle.reml(y, X0, K=kinship_small)
        null = fit_null_model(y, X0, K=kinship_small)
        assert abs(float(null.log_delta) - ro["log_delta"]) < 1e-6
        assert np.isclose(float(null.ll), ro["ll"], atol=1e-8)
        assert np.isclose(float(null.sigma_g2), ro["sigma_g2"], rtol=1e-6)
        assert np.isclose(float(null.pseudo_heritability),
                          ro["pseudo_heritability"], atol=1e-7)

    def test_reml_with_cofactors(self, small_dataset, kinship_small):
        y, G = small_dataset["y"], small_dataset["G"]
        X0 = np.hstack([np.ones((len(y), 1)), G[3][:, None], G[77][:, None]])
        ro = oracle.reml(y, X0, K=kinship_small)
        null = fit_null_model(y, X0, K=kinship_small)
        assert abs(float(null.log_delta) - ro["log_delta"]) < 1e-6

    def test_ml_parity(self, small_dataset, kinship_small):
        y = small_dataset["y"]
        X0 = np.ones((len(y), 1))
        mo = oracle.ml(y, X0, kinship_small)
        null = fit_null_model(y, X0, K=kinship_small, ml=True)
        assert abs(float(null.log_delta) - mo["log_delta"]) < 1e-6
        assert np.isclose(float(null.ll), mo["ll"], atol=1e-8)

    def test_reml_boundary_solution(self):
        """Pure-noise phenotype on identity-ish K drives delta to the upper
        grid bound — both implementations must agree at the boundary."""
        rng = np.random.default_rng(0)
        n = 80
        A = rng.normal(size=(n, 2 * n))
        K = oracle.scale_k(A @ A.T / (2 * n))
        y = rng.normal(size=n)  # no genetic signal
        X0 = np.ones((n, 1))
        ro = oracle.reml(y, X0, K=K)
        null = fit_null_model(y, X0, K=K)
        assert abs(float(null.log_delta) - ro["log_delta"]) < 1e-5


class TestDeviceEmmaxScan:
    def test_pvalue_parity_1e6(self, small_dataset, kinship_small):
        """The headline BASELINE gate: p-values match the reference
        algorithm (oracle) to <=1e-6."""
        G, y, K = small_dataset["G"], small_dataset["y"], kinship_small
        o = oracle.emmax_scan(G, y, K, with_betas=True)
        d = emmax(G, y, K=K, with_betas=True)
        assert np.max(np.abs(d["ps"] - o["ps"])) < 1e-6
        assert np.allclose(d["f_stats"], o["f_stats"], rtol=1e-6, atol=1e-8)
        assert np.allclose(d["betas"], o["betas"], atol=1e-6)
        assert np.allclose(d["var_perc"], o["var_perc"], atol=1e-8)
        assert np.isclose(d["delta"], o["delta"], rtol=1e-5)

    def test_parity_with_cofactors(self, small_dataset, kinship_small):
        G, y, K = small_dataset["G"], small_dataset["y"], kinship_small
        X0 = np.hstack([np.ones((len(y), 1)), G[11][:, None]])
        o = oracle.emmax_scan(G, y, K, X0=X0)
        d = emmax(G, y, K=K, X0=X0)
        assert np.max(np.abs(d["ps"] - o["ps"])) < 1e-6

    def test_tile_invariance(self, small_dataset, kinship_small):
        G, y, K = small_dataset["G"], small_dataset["y"], kinship_small
        d1 = emmax(G, y, K=K, tile=64)
        d2 = emmax(G, y, K=K, tile=512)
        np.testing.assert_allclose(d1["ps"], d2["ps"], atol=1e-12)

    def test_pre_rotated_equivalence(self, small_dataset, kinship_small):
        G, y, K = small_dataset["G"], small_dataset["y"], kinship_small
        null = fit_null_model(y, np.ones((len(y), 1)), K=K)
        rot = build_rotated_null(null)
        a = emmax_scan_stats(jnp.asarray(G), rot)
        G_rot = jnp.asarray(G) @ null.U
        b = emmax_scan_stats(G_rot, rot, pre_rotated=True)
        np.testing.assert_allclose(np.asarray(a["f_stats"]),
                                   np.asarray(b["f_stats"]), atol=1e-8)

    def test_degenerate_snps_masked(self, small_dataset, kinship_small):
        y, K = small_dataset["y"], kinship_small
        n = len(y)
        G = np.vstack([np.zeros((1, n)), np.ones((1, n)),
                       small_dataset["G"][:5]])
        d = emmax(G, y, K=K)
        assert not d["mask"][0] and not d["mask"][1]
        assert d["ps"][0] == 1.0 and d["ps"][1] == 1.0
        assert d["mask"][2:].all()

    def test_duplicate_of_cofactor_masked(self, small_dataset, kinship_small):
        """A SNP identical to a cofactor is collinear -> masked, p=1."""
        G, y, K = small_dataset["G"][:10], small_dataset["y"], kinship_small
        X0 = np.hstack([np.ones((len(y), 1)), G[4][:, None]])
        d = emmax(G, y, K=K, X0=X0)
        assert d["ps"][4] == 1.0


class TestDeviceGlm:
    def test_linear_model_parity(self, small_dataset):
        G, y = small_dataset["G"][:100], small_dataset["y"]
        o = oracle.ols_scan(G, y)
        d = linear_model(G, y)
        assert np.max(np.abs(d["ps"] - o["ps"])) < 1e-6
        assert np.allclose(d["betas"], o["betas"], atol=1e-7)

    def test_anova_parity(self, small_dataset):
        G, y = small_dataset["G_int"][:100], small_dataset["y"]
        o = oracle.anova_scan(G, y)
        d = anova(G, y)
        assert np.max(np.abs(d["ps"] - o["ps"])) < 1e-8

    def test_kruskal_parity(self, small_dataset):
        G, y = small_dataset["G_int"][:60], small_dataset["y"]
        o = oracle.kruskal_wallis_scan(G, y)
        d = kruskal_wallis(G, y)
        assert np.max(np.abs(d["ps"] - o["ps"])) < 1e-8

    def test_kruskal_with_missing(self):
        from mixmogam_tpu.data.simulate import simulate_genotypes

        rng = np.random.default_rng(1)
        G, _, _ = simulate_genotypes(40, 20, missing_rate=0.1, seed=2)
        y = rng.normal(size=40)
        d = kruskal_wallis(G, y)
        import scipy.stats

        keep = G[0] >= 0
        groups = [y[keep][G[0][keep] == v] for v in np.unique(G[0][keep])]
        h, p = scipy.stats.kruskal(*groups)
        assert np.isclose(d["ps"][0], p)


class TestStats:
    def test_f_sf_matches_scipy(self):
        import scipy.stats

        f = np.array([0.0, 0.5, 3.3, 25.0, 80.0])
        dev = np.asarray(f_sf(jnp.asarray(f), 1.0, 197.0))
        ref = scipy.stats.f.sf(f, 1, 197)
        np.testing.assert_allclose(dev, ref, rtol=1e-10)

    def test_f_sf_host_tails(self):
        # deep tails survive the host float64 path
        p = f_sf_host(np.array([400.0]), 1.0, 500.0)
        assert 0 < p[0] < 1e-60
