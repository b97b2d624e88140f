"""The X-explicit null-model REML path (ops.reml._explicit_reml_host).

Round-3 change: fit_null_model's default method='explicit' computes the
(RE)ML optimum from eigh(K) ALONE (float64 host moments), replacing the
projected-spectrum path's second O(n^3) host eigh (reference
_get_eigen_R_). These tests pin that the
two formulations find the SAME optimum (the determinant/quadratic
identities of ops.xreml), including the ML variant, cofactor designs and
the eig_k-without-K entry that previously reconstructed K on host.
"""

import numpy as np
import pytest

from mixmogam_tpu.ops.reml import fit_null_model


def _sim(seed, n=160, q=1, m=400):
    rng = np.random.default_rng(seed)
    Z = rng.integers(0, 2, (m, n)).astype(np.float64)
    K = (Z.T @ Z + (1 - Z).T @ (1 - Z)) / m
    X0 = np.hstack([np.ones((n, 1)), rng.normal(size=(n, q - 1))]) \
        if q > 1 else np.ones((n, 1))
    u = rng.multivariate_normal(np.zeros(n), K)
    y = X0 @ rng.normal(size=q) + u + 0.7 * rng.normal(size=n)
    return y, X0, K


class TestExplicitNull:
    @pytest.mark.parametrize("seed,q,ml", [(0, 1, False), (1, 3, False),
                                           (2, 1, True), (3, 2, True)])
    def test_matches_projected_spectrum(self, seed, q, ml):
        y, X0, K = _sim(seed, q=q)
        a = fit_null_model(y, X0, K=K, method="explicit", ml=ml)
        b = fit_null_model(y, X0, K=K, method="spectrum", ml=ml)
        assert abs(float(a.log_delta) - float(b.log_delta)) < 1e-6
        assert abs(float(a.ll) - float(b.ll)) < 1e-8
        assert abs(float(a.sigma_g2) - float(b.sigma_g2)) < 1e-8
        assert abs(float(a.pseudo_heritability)
                   - float(b.pseudo_heritability)) < 1e-9

    def test_eig_k_without_K(self):
        """eig_k-only entry must NOT need K (the spectrum path used to
        reconstruct it on host — the CLAUDE.md n^3 footgun)."""
        import scipy.linalg

        y, X0, K = _sim(7)
        w, v = scipy.linalg.eigh(K)
        phi, U = w[::-1].copy(), v[:, ::-1].copy()
        a = fit_null_model(y, X0, eig_k=(phi, U))
        b = fit_null_model(y, X0, K=K, method="spectrum")
        assert abs(float(a.log_delta) - float(b.log_delta)) < 1e-6

    def test_default_is_explicit(self):
        """method='auto' (the default) routes to the explicit path —
        bitwise-equal result to method='explicit'."""
        y, X0, K = _sim(11)
        a = fit_null_model(y, X0, K=K)
        b = fit_null_model(y, X0, K=K, method="explicit")
        assert float(a.delta) == float(b.delta)
        assert float(a.ll) == float(b.ll)

    def test_boundary_solution(self):
        """Pure-noise trait drives delta to the ulim endpoint in both
        formulations (no bracket: argmax falls back to the grid ends)."""
        rng = np.random.default_rng(5)
        y, X0, K = _sim(5)
        y = rng.normal(size=len(y))          # h2 ~ 0
        a = fit_null_model(y, X0, K=K, method="explicit")
        b = fit_null_model(y, X0, K=K, method="spectrum")
        assert abs(float(a.log_delta) - float(b.log_delta)) < 1e-6

    def test_unknown_method_raises(self):
        y, X0, K = _sim(0)
        with pytest.raises(ValueError):
            fit_null_model(y, X0, K=K, method="nope")


class TestMultiTraitExplicit:
    def test_deltas_match_single_trait(self):
        """emmax_multi_trait's per-trait explicit REML equals per-trait
        fit_null_model (spectrum) deltas."""
        from mixmogam_tpu.models.multitrait import emmax_multi_trait

        rng = np.random.default_rng(3)
        n, m, t = 120, 300, 4
        Z = rng.integers(0, 2, (m, n)).astype(np.float64)
        K = (Z.T @ Z + (1 - Z).T @ (1 - Z)) / m
        Y = np.stack([
            Z[rng.integers(0, m)] * 0.8 + rng.normal(size=n)
            for _ in range(t)])
        out = emmax_multi_trait(Z.astype(np.int8), Y, K=K)
        for i in range(t):
            ref = fit_null_model(Y[i], np.ones((n, 1)), K=K,
                                 method="spectrum")
            assert abs(out["deltas"][i] - float(ref.delta)) < 1e-5 * (
                1.0 + out["deltas"][i])
