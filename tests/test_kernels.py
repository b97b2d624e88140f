"""Kernel-level tests: the integer-exact int8 kinship path, the bf16 and
int8 rotation tiers, precision routing (SURVEY.md §4.2 'kernel
parity')."""

import jax.numpy as jnp
import numpy as np
import pytest

from mixmogam_tpu import oracle
from mixmogam_tpu.data.simulate import simulate_genotypes
from mixmogam_tpu.models import emmax
from mixmogam_tpu.ops import kinship as dk
from mixmogam_tpu.ops.kinship import _ibs_int8_streamed


class TestInt8Path:
    @pytest.mark.parametrize("n, M, ploidy, chunk", [
        (100, 777, 1, 128),    # n off every tile, M off the chunk
        (300, 700, 1, 256),    # both axes pad
        (3, 4, 1, 2048),       # one short chunk
        (130, 333, 2, 128),    # diploid, M off the chunk
        (257, 129, 2, 64),     # diploid, one row past a chunk
    ])
    def test_int8_kinship_padding_edges(self, n, M, ploidy, chunk):
        """The XLA int8 gram is integer-exact against the oracle where
        the sample and SNP counts leave padded tiles and chunks."""
        G, _, _ = simulate_genotypes(n, M, ploidy=ploidy, seed=n + M)
        Ko = oracle.ibs_kinship(G.astype(np.float64), ploidy=ploidy)
        K = dk.kinship(G, method="ibs", ploidy=ploidy, chunk=chunk)
        np.testing.assert_array_equal(K, Ko)

    def test_streamed_int8_exact(self):
        G, _, _ = simulate_genotypes(64, 500, seed=2)
        Ko = oracle.ibs_kinship(G.astype(np.float64))
        Ks = _ibs_int8_streamed(G, chunk=128)
        assert np.max(np.abs(Ks - Ko)) == 0.0

    def test_kinship_router_picks_int8(self):
        """int8 binary fully-observed input routes through the exact
        integer path automatically."""
        G, _, _ = simulate_genotypes(40, 300, seed=3)
        K = dk.kinship(G, method="ibs", chunk=64)
        Ko = oracle.ibs_kinship(G.astype(np.float64))
        assert np.max(np.abs(K - Ko)) == 0.0

    def test_diploid_int8_exact(self):
        from mixmogam_tpu.data.simulate import simulate_genotypes
        from mixmogam_tpu.ops.kinship import _ibs_diploid_int8_streamed

        G, _, _ = simulate_genotypes(40, 333, ploidy=2, seed=5)  # odd M
        Ko = oracle.ibs_kinship(G.astype(np.float64), ploidy=2)
        Ks = _ibs_diploid_int8_streamed(G, chunk=128)
        assert np.max(np.abs(Ks - Ko)) == 0.0
        # router picks it automatically
        Kr = dk.kinship(G, method="ibs", ploidy=2, chunk=128)
        assert np.max(np.abs(Kr - Ko)) == 0.0

    def test_kinship_router_missing_falls_back(self):
        G, _, _ = simulate_genotypes(40, 300, missing_rate=0.05, seed=3)
        K = dk.kinship(G, method="ibs", chunk=64, dtype=jnp.float64)
        Gf = G.astype(np.float64)
        Gf[G < 0] = np.nan
        Ko = oracle.ibs_kinship(Gf)
        np.testing.assert_allclose(K, Ko, atol=1e-10)


class TestBf16Rotation:
    def test_bf16_scan_close_and_rank_stable(self, small_dataset,
                                             kinship_small):
        G, y, K = small_dataset["G"], small_dataset["y"], kinship_small
        exact = emmax(G, y, K=K, dtype=np.float32)
        fast = emmax(G, y, K=K, dtype=np.float32, rotate_in_bf16=True)
        lp_e = -np.log10(np.maximum(exact["ps"], 1e-300))
        lp_f = -np.log10(np.maximum(fast["ps"], 1e-300))
        # bf16 rotation: small absolute error, identical leaders
        assert np.max(np.abs(lp_e - lp_f)) < 0.35
        assert np.argmin(exact["ps"]) == np.argmin(fast["ps"])
        # regression: dof must NOT round through bf16 (198 != bf16(198))
        assert fast["dof"] == exact["dof"] == len(y) - 2

    def test_split_w_tiers_accuracy_ladder(self, small_dataset,
                                           kinship_small):
        """Split-W tiers (W = sum of K bf16 terms, integer G exact in
        bf16): each extra term adds ~8 mantissa bits, so p-drift vs fp32
        drops ~1e-3 -> ~1e-5 -> ~1e-7."""
        G = small_dataset["G_int"]
        y, K = small_dataset["y"], kinship_small
        ex = emmax(G, y, K=K, dtype=np.float32)
        drifts = []
        for tier in (True, "x2", "x3"):
            f = emmax(G, y, K=K, dtype=np.float32, rotate_in_bf16=tier)
            drifts.append(np.max(np.abs(f["ps"] - ex["ps"])))
            assert np.argmin(f["ps"]) == np.argmin(ex["ps"])
        assert drifts[0] < 5e-2
        assert drifts[1] < 1e-4
        assert drifts[2] < 1e-6
        assert drifts[2] < drifts[1] < drifts[0]
        # concatenated variants (one wide matmul) match their stacked
        # twins to float-add reassociation level
        for tier, ref_drift in (("x2c", drifts[1]), ("x3c", drifts[2])):
            f = emmax(G, y, K=K, dtype=np.float32, rotate_in_bf16=tier)
            d = np.max(np.abs(f["ps"] - ex["ps"]))
            assert d < 10 * ref_drift + 1e-7

    def test_int8_digit_tiers_accuracy_ladder(self, small_dataset,
                                              kinship_small):
        """int8 digit-plane tiers ('int8xK'): W fixed-pointed per column
        to 8K-2 bits and split into K signed int8 digit planes; integer
        dosages make each digit matmul EXACT (int32 accumulation), so the
        only error is W's quantization + one final f32 recombine.
        Expected ladder: int8x2 (14 bits) ~1e-4, int8x3 (22 bits)
        fp32-grade <=1e-6, int8x4 (30 bits) at or below int8x3."""
        G = small_dataset["G_int"]
        y, K = small_dataset["y"], kinship_small
        ex = emmax(G, y, K=K, dtype=np.float32)
        drifts = {}
        for tier in ("int8x2", "int8x3", "int8x4"):
            f = emmax(G, y, K=K, dtype=np.float32, rotate_in_bf16=tier)
            drifts[tier] = np.max(np.abs(f["ps"] - ex["ps"]))
            assert np.argmin(f["ps"]) == np.argmin(ex["ps"])
        assert drifts["int8x2"] < 1e-3
        assert drifts["int8x3"] < 2e-6
        assert drifts["int8x4"] < 2e-6
        assert drifts["int8x4"] <= drifts["int8x3"] < drifts["int8x2"]

    def test_int8_tier_rejects_fractional_dosages(self, small_dataset,
                                                  kinship_small):
        """Mean-imputed fractional dosages would be silently rounded by
        the digit-plane tier — the facade must refuse instead."""
        G = small_dataset["G"].astype(np.float64).copy()
        G[0, 0] = 0.37  # imputed-looking fractional dosage
        y, K = small_dataset["y"], kinship_small
        with pytest.raises(ValueError, match="integer dosages"):
            emmax(G, y, K=K, dtype=np.float32, rotate_in_bf16="int8x3")


class TestFp32Characterization:
    def test_fp32_vs_f64_accuracy_envelope(self, small_dataset,
                                           kinship_small):
        """Pin the fp32 (production dtype) accuracy envelope vs the
        float64 path: -log10 p within 0.05, ranks of the leaders stable.
        (The 1e-6 parity gate is the float64 path; this documents what
        fp32 delivers — see docs/ALGORITHMS.md precision policy.)"""
        G, y, K = small_dataset["G"], small_dataset["y"], kinship_small
        full = emmax(G, y, K=K)  # float64 under the test config
        f32 = emmax(G, y, K=K, dtype=np.float32)
        lp_a = -np.log10(np.maximum(full["ps"], 1e-300))
        lp_b = -np.log10(np.maximum(f32["ps"], 1e-300))
        assert np.max(np.abs(lp_a - lp_b)) < 0.05
        top_a = np.argsort(full["ps"])[:10]
        top_b = np.argsort(f32["ps"])[:10]
        assert set(top_a) == set(top_b)
        assert abs(full["pseudo_heritability"]
                   - f32["pseudo_heritability"]) < 1e-4


class TestInputHandling:
    def test_int8_device_path_matches_float(self, small_dataset,
                                            kinship_small):
        G_int = small_dataset["G_int"]
        y, K = small_dataset["y"], kinship_small
        a = emmax(G_int, y, K=K, dtype=np.float32)
        b = emmax(G_int.astype(np.float32), y, K=K, dtype=np.float32)
        np.testing.assert_allclose(a["ps"], b["ps"], atol=1e-12)

    def test_float_nan_imputed_like_int8(self):
        from mixmogam_tpu.data.simulate import simulate_genotypes

        G, _, _ = simulate_genotypes(50, 200, missing_rate=0.05, seed=8)
        Gf = G.astype(np.float64)
        Gf[G < 0] = np.nan
        Ki = dk.kinship(G, method="ibs", chunk=64, dtype=jnp.float64)
        Kf = dk.kinship(Gf, method="ibs", chunk=64, dtype=jnp.float64)
        np.testing.assert_allclose(Kf, Ki, atol=1e-12)
        assert np.isfinite(Kf).all()

    def test_1d_covariate_becomes_column(self, small_dataset,
                                         kinship_small):
        G, y, K = small_dataset["G"][:20], small_dataset["y"], kinship_small
        cov = np.random.default_rng(0).normal(size=len(y))
        X0 = np.hstack([np.ones((len(y), 1)), cov[:, None]])
        ref = emmax(G, y, K=K, X0=X0)
        # passing the intercept-free 1-D covariate must raise nothing and
        # produce a (n, 1) design
        from mixmogam_tpu.models.emmax import _as_design

        assert _as_design(cov, len(y)).shape == (len(y), 1)
        with pytest.raises(ValueError):
            _as_design(cov[:-1], len(y))
        with pytest.raises(ValueError):
            _as_design(np.ones((3, len(y), 1)), len(y))


class TestPrecisionRouting:
    """Unified precision= kwarg + 'auto'/'fast' tier routing (ops.scan
    resolve_precision): the tiers come from PRECISION_ROUTES per
    platform; a platform not listed runs exact."""

    DOSAGES = {
        "integer": np.array([[0, 1, 2], [1, 0, 1]], np.int8),
        "fractional": np.array([[0.0, 0.37, 1.0]]),
        "integer_valued_float": np.array([[0.0, 1.0, 2.0]], np.float32),
    }

    def test_resolve_auto_tier(self):
        from mixmogam_tpu.ops.scan import (PRECISION_ROUTES,
                                           is_integer_dosage,
                                           resolve_precision)

        Gi = self.DOSAGES["integer"]
        Gfrac = self.DOSAGES["fractional"]
        int_tier, frac_tier = PRECISION_ROUTES["gpu"]["auto"]
        assert resolve_precision("auto", Gi, backend="gpu")[2] == int_tier
        assert resolve_precision("auto", Gi, backend="cpu")[2] == "exact"
        assert resolve_precision("auto", Gfrac,
                                 backend="gpu")[2] == frac_tier
        # integer-VALUED floats are safe for the digit planes
        assert resolve_precision("auto", Gi.astype(np.float32),
                                 backend="gpu")[2] == int_tier
        # out-of-int8-range integers are not
        assert not is_integer_dosage(np.array([[300]], np.int16))
        assert not is_integer_dosage(np.array([[np.nan, 1.0]]))
        with pytest.raises(ValueError, match="unknown precision"):
            resolve_precision("int9", Gi)

    @pytest.mark.parametrize("precision", ["auto", "fast"])
    @pytest.mark.parametrize("backend", ["gpu", "cpu"])
    @pytest.mark.parametrize("kind", sorted(DOSAGES))
    def test_routes_follow_table(self, precision, backend, kind):
        from mixmogam_tpu.ops.scan import (PRECISION_ROUTES,
                                           PRECISION_TIERS,
                                           resolve_precision)

        int_tier, frac_tier = PRECISION_ROUTES.get(backend, {}).get(
            precision, ("exact", "exact"))
        want = frac_tier if kind == "fractional" else int_tier
        rb, mp, name = resolve_precision(precision, self.DOSAGES[kind],
                                         backend=backend)
        assert name == want
        assert (rb, mp) == PRECISION_TIERS[want]
        # the int8 digit planes round dosages: never a fractional route
        assert not str(frac_tier).startswith("int8")

    def test_normalize_rotate_tier(self):
        from mixmogam_tpu.ops.scan import normalize_rotate_tier

        assert normalize_rotate_tier(False) is None
        assert normalize_rotate_tier(None) is None
        assert normalize_rotate_tier(True) == jnp.bfloat16
        assert normalize_rotate_tier("x2") == "bf16x2"
        assert normalize_rotate_tier("bf16x3") == "bf16x3"
        assert normalize_rotate_tier("int8x3") == "int8x3"

    def test_precision_kwarg_routes_and_reports(self, small_dataset,
                                                kinship_small):
        G, y, K = small_dataset["G_int"], small_dataset["y"], kinship_small
        ex = emmax(G, y, K=K, dtype=np.float32, precision="exact")
        assert ex["precision_tier"] == "exact"
        f = emmax(G, y, K=K, dtype=np.float32, precision="int8x3")
        assert f["precision_tier"] == "int8x3"
        assert np.max(np.abs(f["ps"] - ex["ps"])) < 2e-6
        # 'auto' on the CPU test backend resolves to exact (the CPU has
        # no routes) and is bit-identical to the exact tier
        a = emmax(G, y, K=K, dtype=np.float32, precision="auto")
        assert a["precision_tier"] == "exact"
        np.testing.assert_array_equal(a["ps"], ex["ps"])
        # legacy kwargs still report their tier
        leg = emmax(G, y, K=K, dtype=np.float32, rotate_in_bf16="int8x2")
        assert leg["precision_tier"] == "int8x2"

    def test_precision_conflicts_with_legacy_kwargs(self, small_dataset,
                                                    kinship_small):
        G, y, K = small_dataset["G_int"], small_dataset["y"], kinship_small
        with pytest.raises(ValueError, match="not both"):
            emmax(G, y, K=K, precision="bf16", rotate_in_bf16=True)


class TestPrecisionPins:
    """The exact tier must never run a float32 dot below fp32: on an
    NVIDIA GPU an unpinned f32 dot may run in TF32."""

    @staticmethod
    def _rot(n=16, rotate_dtype=None):
        from mixmogam_tpu.ops.reml import fit_null_model
        from mixmogam_tpu.ops.scan import build_rotated_null

        rng = np.random.default_rng(0)
        Z = rng.normal(size=(n, 3 * n)).astype(np.float32)
        K = Z @ Z.T / (3 * n)
        y = rng.normal(size=n).astype(np.float32)
        null = fit_null_model(y, np.ones((n, 1), np.float32), K=K)
        return build_rotated_null(null, rotate_dtype=rotate_dtype)

    @pytest.mark.parametrize("path", ["in_core", "resident_packed"])
    def test_exact_tier_f32_dots_are_highest(self, path):
        from mixmogam_tpu.models.resident import emmax_scan_packed
        from mixmogam_tpu.ops.scan import emmax_scan_stats

        n = 16
        rot = self._rot(n)
        assert rot.W.dtype == jnp.float32
        if path == "in_core":
            text = emmax_scan_stats.lower(
                jnp.zeros((8, n), jnp.float32), rot).as_text()
        else:
            text = emmax_scan_packed.lower(
                jnp.zeros((8, n // 4), jnp.uint8), rot, n, 8).as_text()
        dots = [ln for ln in text.splitlines() if "dot_general" in ln]
        assert dots
        assert all("precision = [HIGHEST, HIGHEST]" in ln for ln in dots), \
            dots
