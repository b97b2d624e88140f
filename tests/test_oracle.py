"""Oracle self-consistency properties (SURVEY.md §4.1).

These pin the oracle's correctness via mathematical identities that any
correct EMMA/EMMAX implementation must satisfy — they are the foundation
the device-path parity tests stand on.
"""

import numpy as np
import pytest
import scipy.stats

from mixmogam_tpu import oracle


class TestKinship:
    def test_ibs_binary_properties(self, small_dataset):
        K = oracle.ibs_kinship(small_dataset["G"])
        n = K.shape[0]
        assert np.allclose(np.diag(K), 1.0)           # self-sharing = 1
        assert np.allclose(K, K.T)
        w = np.linalg.eigvalsh(K)
        assert w.min() > -1e-8                        # PSD
        assert K.min() >= 0.0 and K.max() <= 1.0 + 1e-12

    def test_ibs_identical_samples(self):
        rng = np.random.default_rng(0)
        Z = rng.integers(0, 2, size=(100, 5)).astype(float)
        Z = np.hstack([Z, Z[:, :1]])  # duplicate sample 0
        K = oracle.ibs_kinship(Z)
        assert np.isclose(K[0, -1], 1.0)

    def test_vanraden_properties(self, small_dataset):
        K = oracle.vanraden_kinship(small_dataset["G"], ploidy=1)
        assert np.allclose(K, K.T)
        w = np.linalg.eigvalsh(K)
        assert w.min() > -1e-8

    def test_scale_k(self, small_dataset):
        K = oracle.vanraden_kinship(small_dataset["G"], ploidy=1)
        Ks = oracle.scale_k(K)
        assert np.isclose(np.mean(np.diag(Ks)), 1.0)

    def test_prepare_k(self):
        K = np.arange(16, dtype=float).reshape(4, 4)
        K = K + K.T
        out = oracle.prepare_k(K, ["a", "b", "c", "d"], ["d", "b"])
        assert out.shape == (2, 2)
        assert out[0, 0] == K[3, 3] and out[0, 1] == K[3, 1]

    def test_chunking_invariance(self, small_dataset):
        G = small_dataset["G"]
        K1 = oracle.ibs_kinship(G, chunk=64)
        K2 = oracle.ibs_kinship(G, chunk=10_000)
        assert np.allclose(K1, K2, atol=1e-12)

    def test_mean_imputation_rule(self):
        rng = np.random.default_rng(3)
        Z = rng.integers(0, 2, size=(50, 20)).astype(float)
        Zm = Z.copy()
        Zm[0, 0] = np.nan
        K = oracle.ibs_kinship(Zm)
        # manually impute and compare
        Zi = Zm.copy()
        Zi[0, 0] = np.nanmean(Zm[0])
        K2 = oracle.ibs_kinship(Zi)
        assert np.allclose(K, K2)


class TestReml:
    def test_reml_identity_kinship_matches_ols_variance(self, small_dataset):
        """With K=I, H = (1+delta)I: GLS == OLS and sg2+se2 == residual
        variance of OLS (up to REML dof scaling)."""
        y = small_dataset["y"]
        n = len(y)
        X = np.ones((n, 1))
        K = np.eye(n)
        r = oracle.reml(y, X, K=K)
        resid = y - y.mean()
        s2 = (resid @ resid) / (n - 1)
        total = r["sigma_g2"] + r["sigma_e2"]
        assert np.isclose(total, s2, rtol=1e-4)

    def test_reml_recovers_heritability(self, small_dataset, kinship_small):
        y = small_dataset["y"]
        X = np.ones((len(y), 1))
        r = oracle.reml(y, X, K=kinship_small)
        # IBS kinship's high baseline sharing inflates h2 estimates; this is
        # a wide sanity band, not a calibration test.
        assert 0.05 < r["pseudo_heritability"] < 0.999

    def test_reml_scale_invariance(self, small_dataset, kinship_small):
        """delta is invariant to scaling y (variance ratio)."""
        y = small_dataset["y"]
        X = np.ones((len(y), 1))
        r1 = oracle.reml(y, X, K=kinship_small)
        r2 = oracle.reml(3.7 * y, X, K=kinship_small)
        assert np.isclose(r1["delta"], r2["delta"], rtol=1e-4)
        assert np.isclose(r2["sigma_g2"], 3.7**2 * r1["sigma_g2"], rtol=1e-4)

    def test_ml_le_reml_relationship(self, small_dataset, kinship_small):
        """Sanity: both optimizers find finite optima in range."""
        y = small_dataset["y"]
        X = np.ones((len(y), 1))
        r = oracle.reml(y, X, K=kinship_small)
        m = oracle.ml(y, X, kinship_small)
        assert np.isfinite(r["ll"]) and np.isfinite(m["ll"])
        assert -10 <= r["log_delta"] <= 10

    def test_projected_spectrum_determinant_identity(self, tiny_dataset,
                                                     kinship_tiny):
        """Pins the identity the device EMMA path relies on:
        prod(xi_i + d) == |H| * |X'H^-1X| / |X'X| with H = K + d I."""
        K = kinship_tiny
        n = K.shape[0]
        X = np.hstack([np.ones((n, 1)),
                       tiny_dataset["G"][0][:, None]])
        xi, V = oracle.eigen_R(K, X)
        for d in (0.01, 1.0, 57.0):
            H = K + d * np.eye(n)
            Hi = np.linalg.inv(H)
            lhs = np.sum(np.log(xi + d))
            (sH, ldH) = np.linalg.slogdet(H)
            (s1, ld1) = np.linalg.slogdet(X.T @ Hi @ X)
            (s2, ld2) = np.linalg.slogdet(X.T @ X)
            assert np.isclose(lhs, ldH + ld1 - ld2, atol=1e-8)

    def test_projected_quadratic_identity(self, tiny_dataset, kinship_tiny):
        """sum eta_i^2/(xi_i+d) == y'P(d)y (the other EMMA identity)."""
        K = kinship_tiny
        y = tiny_dataset["y"]
        n = K.shape[0]
        X = np.hstack([np.ones((n, 1)), tiny_dataset["G"][1][:, None]])
        xi, V = oracle.eigen_R(K, X)
        eta2 = (V.T @ y) ** 2
        for d in (0.05, 2.0):
            Hi = np.linalg.inv(K + d * np.eye(n))
            P = Hi - Hi @ X @ np.linalg.solve(X.T @ Hi @ X, X.T @ Hi)
            assert np.isclose(np.sum(eta2 / (xi + d)), y @ P @ y, rtol=1e-8)


class TestEmmax:
    def test_emmax_equals_ols_when_k_identity(self, small_dataset):
        """EMMAX p-values == OLS p-values when K = I (whitening is a scalar
        multiple of identity, which cancels in the F statistic)."""
        G, y = small_dataset["G"][:50], small_dataset["y"]
        K = np.eye(len(y))
        em = oracle.emmax_scan(G, y, K)
        ols = oracle.ols_scan(G, y)
        assert np.allclose(em["ps"], ols["ps"], atol=1e-6)
        assert np.allclose(em["f_stats"], ols["f_stats"], rtol=1e-5)

    def test_emmax_sample_permutation_invariance(self, small_dataset,
                                                 kinship_small):
        """Consistently permuting samples in (y, G, K) must not change
        p-values (SURVEY.md §4.1 property list)."""
        G, y, K = small_dataset["G"][:40], small_dataset["y"], kinship_small
        r1 = oracle.emmax_scan(G, y, K)
        rng = np.random.default_rng(0)
        perm = rng.permutation(len(y))
        r2 = oracle.emmax_scan(G[:, perm], y[perm], K[np.ix_(perm, perm)])
        assert np.allclose(r1["ps"], r2["ps"], atol=1e-6)

    def test_emmax_finds_causal(self, small_dataset, kinship_small):
        G, y = small_dataset["G"], small_dataset["y"]
        r = oracle.emmax_scan(G, y, kinship_small, with_betas=True)
        top = np.argsort(r["ps"])[:20]
        assert len(set(top) & set(small_dataset["causal"])) >= 1

    def test_monomorphic_snp_p_is_one(self, small_dataset, kinship_small):
        y = small_dataset["y"]
        G = np.vstack([np.ones((1, len(y))), small_dataset["G"][:3]])
        r = oracle.emmax_scan(G, y, kinship_small)
        assert r["ps"][0] == 1.0 and r["f_stats"][0] == 0.0

    def test_cofactor_regression(self, small_dataset, kinship_small):
        """Conditioning on the top SNP must drive its own p to 1."""
        G, y, K = small_dataset["G"][:60], small_dataset["y"], kinship_small
        r = oracle.emmax_scan(G, y, K)
        j = int(np.argmin(r["ps"]))
        X0 = np.hstack([np.ones((len(y), 1)), G[j][:, None]])
        r2 = oracle.emmax_scan(G, y, K, X0=X0)
        assert r2["ps"][j] == 1.0


class TestEmma:
    def test_emma_close_to_emmax_and_exact_at_null_delta(self, tiny_dataset,
                                                         kinship_tiny):
        G, y, K = tiny_dataset["G"][:20], tiny_dataset["y"], kinship_tiny
        em = oracle.emma_scan(G, y, K)
        ex = oracle.emmax_scan(G, y, K)
        # deltas differ per SNP but p-values strongly agree on null SNPs
        r = scipy.stats.pearsonr(np.log10(em["ps"]), np.log10(ex["ps"]))[0]
        assert r > 0.95

    def test_emma_fixed_delta_equals_emmax(self, tiny_dataset, kinship_tiny):
        """If a SNP's REML delta happens to equal the null delta, the EMMA
        F-test must equal the EMMAX F-test — verified by direct GLS."""
        G, y, K = tiny_dataset["G"], tiny_dataset["y"], kinship_tiny
        null = oracle.reml(y, np.ones((len(y), 1)), K=K)
        phi, U = oracle.eigen_K(K)
        from mixmogam_tpu.oracle.lmm import _h_inv_sqrt, gls_f_test
        Hi = _h_inv_sqrt(phi, U, null["delta"])
        out = gls_f_test(Hi @ y, Hi @ np.ones((len(y), 1)), Hi @ G[0])
        ex = oracle.emmax_scan(G[:1], y, K)
        assert np.isclose(out["p"], ex["ps"][0], atol=1e-10)


class TestGlm:
    def test_anova_equals_ols_for_binary_snp(self, small_dataset):
        """Two-group one-way ANOVA F == OLS F on a 0/1 regressor."""
        G, y = small_dataset["G"][:30], small_dataset["y"]
        an = oracle.anova_scan(G, y)
        ols = oracle.ols_scan(G, y)
        assert np.allclose(an["ps"], ols["ps"], atol=1e-8)

    def test_kruskal_wallis_matches_scipy(self, small_dataset):
        G, y = small_dataset["G"][:10], small_dataset["y"]
        r = oracle.kruskal_wallis_scan(G, y)
        h, p = scipy.stats.kruskal(y[G[0] == 0], y[G[0] == 1])
        assert np.isclose(r["ps"][0], p)


class TestStepwise:
    def test_stepwise_first_pick_is_scan_argmin(self, tiny_dataset,
                                                kinship_tiny):
        G, y, K = tiny_dataset["G"], tiny_dataset["y"], kinship_tiny
        sw = oracle.mlmm_step_wise(G, y, K, max_steps=2)
        scan = oracle.emmax_scan(G, y, K, with_betas=False)
        assert sw["steps"][0]["min_p_snp"] == int(np.argmin(scan["ps"]))
        assert sw["steps"][1]["cofactors"] == [sw["steps"][0]["min_p_snp"]]

    def test_stepwise_path_and_criteria(self, tiny_dataset, kinship_tiny):
        G, y, K = tiny_dataset["G"], tiny_dataset["y"], kinship_tiny
        sw = oracle.mlmm_step_wise(G, y, K, max_steps=3)
        # forward adds one cofactor per step; backward removes one per step
        sizes = [len(s["cofactors"]) for s in sw["steps"]]
        assert sizes == [0, 1, 2, 3, 2, 1, 0]
        for s in sw["steps"]:
            assert np.isfinite(s["bic"]) and np.isfinite(s["ebic"])
            assert s["ebic"] >= s["bic"] - 1e-9
        for c in ("bic", "ebic", "mbic", "mbonf"):
            assert c in sw["selected"]
