"""ResidentGenome: the device-resident 2-bit packed genome (round 3).

Parity is pinned against the in-core paths: scan (exact + int8 tier +
rescore), kinship (ibs binary/diploid/vanraden, with and without
missing), rotation, row indexing, and the emmax() auto-routing rules.
Runs on the CPU test backend — 'device-resident' is backend-agnostic
(the packed array simply lives wherever jax puts it).
"""

import numpy as np
import pytest

from mixmogam_tpu.models.emmax import emmax
from mixmogam_tpu.models.resident import (RESIDENT_BUDGET_BYTES,
                                          ResidentGenome, emmax_resident,
                                          kinship_resident,
                                          rotate_resident_to_device)
from mixmogam_tpu.ops.kinship import kinship
from mixmogam_tpu.oracle.kinship import scale_k


def _data(seed=0, n=96, m=500, ploidy=1, missing=0.0):
    rng = np.random.default_rng(seed)
    G = rng.integers(0, ploidy + 1, (m, n)).astype(np.int8)
    if missing:
        G[rng.random((m, n)) < missing] = -1
    Gf = G.astype(np.float64)
    Gf[G < 0] = np.nan
    mu = np.nanmean(Gf, axis=1)
    imp = np.where(np.isnan(Gf), np.where(np.isnan(mu), 0, mu)[:, None], Gf)
    y = imp[3] * 0.9 + rng.normal(size=n)
    return G, imp, y


class TestContainer:
    def test_roundtrip_and_indexing(self):
        G, _, _ = _data(1, missing=0.05)
        rg = ResidentGenome.from_source(G, tile=128)
        assert rg.shape == G.shape and rg.has_missing
        np.testing.assert_array_equal(rg[10:30], G[10:30])
        idx = np.array([0, 7, 499, 123])
        np.testing.assert_array_equal(rg[idx], G[idx])

    def test_row_padding(self):
        G, _, _ = _data(2, m=300)          # 300 % 128 != 0
        rg = ResidentGenome.from_source(G, tile=128)
        assert rg.packed.shape[0] == 384 and rg.M == 300
        np.testing.assert_array_equal(rg[295:300], G[295:300])

    def test_rejects_float(self):
        with pytest.raises(TypeError):
            ResidentGenome.from_source(np.zeros((4, 4), np.float32))


class TestResidentScan:
    def test_scan_parity_exact(self):
        G, imp, y = _data(3)
        K = scale_k(kinship(G, method="ibs"))
        ref = emmax(imp, y, K=K, stream=False)
        rg = ResidentGenome.from_source(G, tile=128)
        res = emmax_resident(rg, y, K=K)
        np.testing.assert_allclose(res["ps"], ref["ps"], rtol=0, atol=1e-9)
        np.testing.assert_allclose(res["betas"], ref["betas"], atol=1e-9)
        assert res["dof"] == ref["dof"]

    def test_scan_parity_missing_imputed(self):
        G, imp, y = _data(4, missing=0.04)
        K = scale_k(kinship(G, method="ibs"))
        ref = emmax(imp, y, K=K, stream=False)
        rg = ResidentGenome.from_source(G, tile=128)
        res = emmax_resident(rg, y, K=K)
        np.testing.assert_allclose(res["ps"], ref["ps"], rtol=0, atol=1e-9)

    def test_int8_tier_refused_with_missing(self):
        G, _, y = _data(5, missing=0.04)
        K = scale_k(kinship(G, method="ibs"))
        rg = ResidentGenome.from_source(G, tile=128)
        with pytest.raises(ValueError, match="fully-observed"):
            emmax_resident(rg, y, K=K, rotate_in_bf16="int8x2")

    def test_fast_precision_with_rescore(self):
        """'fast' resolves to a tier + rescore; on CPU it resolves to
        exact (no routes for the CPU), so just pin the auto path runs and
        reports a tier."""
        G, _, y = _data(6)
        K = scale_k(kinship(G, method="ibs"))
        rg = ResidentGenome.from_source(G, tile=128)
        res = emmax_resident(rg, y, K=K, precision="fast")
        assert res["precision_tier"] in ("exact", "bf16", "int8x2")

    def test_int8_tier_parity_fully_observed(self):
        G, imp, y = _data(7)
        K = scale_k(kinship(G, method="ibs"))
        rg = ResidentGenome.from_source(G, tile=128)
        ref = emmax(imp, y, K=K, stream=False)
        res = emmax_resident(rg, y, K=K, rotate_in_bf16="int8x3",
                             rescore_top=16)
        lp = -np.log10(np.maximum(res["ps"], 1e-300))
        lr = -np.log10(np.maximum(ref["ps"], 1e-300))
        assert np.abs(lp - lr).max() < 1e-4
        assert len(res["rescored_idx"]) >= 16


class TestResidentKinship:
    @pytest.mark.parametrize("ploidy,missing,method", [
        (1, 0.0, "ibs"), (2, 0.0, "ibs"),
        (1, 0.05, "ibs"), (2, 0.05, "ibs"),
        (2, 0.0, "vanraden"), (2, 0.05, "vanraden"),
    ])
    def test_kinship_parity(self, ploidy, missing, method):
        G, _, _ = _data(8 + ploidy, n=64, m=300, ploidy=ploidy,
                        missing=missing)
        rg = ResidentGenome.from_source(G, tile=128)
        K_res = kinship_resident(rg, method=method, dtype=np.float64)
        K_ref = kinship(G, method=method, ploidy=ploidy, dtype=np.float64)
        np.testing.assert_allclose(K_res, K_ref, atol=1e-9)

    def test_kinship_dispatch(self):
        G, _, _ = _data(10, n=64, m=300)
        rg = ResidentGenome.from_source(G, tile=128)
        np.testing.assert_allclose(kinship(rg), kinship(G), atol=1e-9)


class TestResidentRotate:
    def test_rotation_parity(self):
        from mixmogam_tpu.ops.eigen import eigen_k

        G, imp, _ = _data(11, n=64, m=200, missing=0.03)
        K = scale_k(kinship(G, method="ibs"))
        _, U = eigen_k(K)
        rg = ResidentGenome.from_source(G, tile=128)
        R = np.asarray(rotate_resident_to_device(rg, U))
        np.testing.assert_allclose(R, imp @ np.asarray(U), atol=1e-8)
        assert R.shape == (200, 64)


class TestRouting:
    def test_resident_true_forces(self):
        G, imp, y = _data(12)
        K = scale_k(kinship(G, method="ibs"))
        ref = emmax(imp, y, K=K, stream=False)
        res = emmax(G, y, K=K, resident=True)
        np.testing.assert_allclose(res["ps"], ref["ps"], atol=1e-9)

    def test_resident_genome_as_G(self):
        G, _, y = _data(13)
        K = scale_k(kinship(G, method="ibs"))
        rg = ResidentGenome.from_source(G, tile=128)
        res = emmax(rg, y, K=K)
        assert res["ps"].shape == (500,)

    def test_auto_promotion_decision(self):
        """Auto-promotion requires: int8, over the in-core budget,
        packed under the resident budget, non-CPU backend. On the CPU
        test backend auto must NOT promote (falls back to streaming)."""
        G, _, y = _data(14, n=48, m=200)
        K = scale_k(kinship(G, method="ibs"))
        # tiny budget forces the over-incore condition; CPU backend
        # means auto -> streamed, and the result must still be right
        ref = emmax(G, y, K=K, stream=False)
        res = emmax(G, y, K=K, stream_budget_bytes=1024)
        np.testing.assert_allclose(res["ps"], ref["ps"], atol=1e-9)

    def test_checkpoint_dir_rejected(self):
        G, _, y = _data(15)
        K = scale_k(kinship(G, method="ibs"))
        with pytest.raises(ValueError, match="resident"):
            emmax(G, y, K=K, resident=True, checkpoint_dir="/tmp/x")

    def test_budget_constant_sane(self):
        assert RESIDENT_BUDGET_BYTES >= (1 << 30)

    @pytest.mark.parametrize("stats", [{"bytes_limit": 64 << 30}, {}, None])
    def test_budgets_follow_device_limit(self, monkeypatch, stats):
        """Each budget is its stated fraction of the device's memory
        limit; a backend that reports none (the CPU) keeps the fixed
        fallback."""
        import importlib

        import jax

        from mixmogam_tpu.models.source import device_budget

        # (the package re-exports emmax the function under the module name)
        emmax_mod = importlib.import_module("mixmogam_tpu.models.emmax")
        resident_mod = importlib.import_module("mixmogam_tpu.models.resident")

        class FakeDevice:
            def memory_stats(self):
                return stats

        monkeypatch.setattr(jax, "devices", lambda *a: [FakeDevice()])
        limit = (stats or {}).get("bytes_limit")
        for got, frac, fallback in [
                (resident_mod.default_resident_budget(),
                 resident_mod.RESIDENT_FRACTION, RESIDENT_BUDGET_BYTES),
                (emmax_mod.default_stream_budget(),
                 emmax_mod.STREAM_FRACTION, emmax_mod.STREAM_BUDGET_BYTES),
                (device_budget(0.5, 123), 0.5, 123)]:
            assert got == (int(frac * limit) if limit else fallback)


class TestResidentStepwise:
    def test_stepwise_parity_stored_and_packed(self):
        from mixmogam_tpu.models.stepwise import emmax_step_wise

        G, imp, y = _data(20, n=64, m=220)
        K = scale_k(kinship(G, method="ibs"))
        rg = ResidentGenome.from_source(G, tile=128)
        ref = emmax_step_wise(imp, y, K=K, max_steps=3)
        # stored-rotation path sourced from packed HBM
        a = emmax_step_wise(rg, y, K=K, max_steps=3)
        # over-budget path: per-step scans straight off packed HBM
        b = emmax_step_wise(rg, y, K=K, max_steps=3, rot_budget_bytes=1024)
        for res in (a, b):
            assert [s["cofactors"] for s in res["steps"]] == \
                [s["cofactors"] for s in ref["steps"]]
            np.testing.assert_allclose(
                [s["min_p"] for s in res["steps"] if s["phase"] == "forward"
                 and np.isfinite(s["min_p"])],
                [s["min_p"] for s in ref["steps"] if s["phase"] == "forward"
                 and np.isfinite(s["min_p"])], rtol=1e-6)

    def test_stepwise_packed_identity_k(self):
        """K=None (fixed-effects-only lm_step_wise) over packed HBM:
        pre-rotated semantics, no rotation matmul."""
        from mixmogam_tpu.models.stepwise import emmax_step_wise

        G, imp, y = _data(21, n=64, m=200, missing=0.03)
        rg = ResidentGenome.from_source(G, tile=128)
        ref = emmax_step_wise(imp, y, K=None, max_steps=2)
        res = emmax_step_wise(rg, y, K=None, max_steps=2,
                              rot_budget_bytes=1024)
        assert [s["cofactors"] for s in res["steps"]] == \
            [s["cofactors"] for s in ref["steps"]]


class TestResidentMultiTrait:
    def test_multitrait_parity(self):
        from mixmogam_tpu.models.multitrait import emmax_multi_trait

        G, imp, _ = _data(22, n=64, m=260, missing=0.02)
        K = scale_k(kinship(G, method="ibs"))
        rng = np.random.default_rng(22)
        Y = np.stack([imp[5] + rng.normal(size=64) * 0.5 for _ in range(3)])
        ref = emmax_multi_trait(imp, Y, K=K)
        rg = ResidentGenome.from_source(G, tile=128)
        res = emmax_multi_trait(rg, Y, K=K)
        np.testing.assert_allclose(res["ps"], ref["ps"], atol=1e-9)
        np.testing.assert_allclose(res["deltas"], ref["deltas"], rtol=1e-9)

    def test_multitrait_missing_y_resident(self):
        """VERDICT r3 #7: per-trait missing phenotypes on a
        ResidentGenome — pattern groups gather their sample columns on
        device; parity vs the host grouped path."""
        from mixmogam_tpu.models.multitrait import emmax_multi_trait

        G, imp, _ = _data(23, n=64, m=200, missing=0.02)
        K = scale_k(kinship(G, method="ibs"))
        rng = np.random.default_rng(23)
        Y = np.stack([imp[5] + rng.normal(size=64) * 0.5
                      for _ in range(4)])
        # two distinct missingness patterns + one fully observed trait
        Y[0, [3, 17]] = np.nan
        Y[1, [3, 17]] = np.nan
        Y[2, 40] = np.nan
        # reference = the host grouped path on the RAW int8 source, so
        # both sides mean-impute within each pattern's sample subset
        ref = emmax_multi_trait(G, Y, K=K)
        rg = ResidentGenome.from_source(G, tile=64)
        res = emmax_multi_trait(rg, Y, K=K)
        np.testing.assert_allclose(res["ps"], ref["ps"], atol=1e-9)
        np.testing.assert_allclose(res["deltas"], ref["deltas"],
                                   rtol=1e-9)
        np.testing.assert_array_equal(res["dof"], ref["dof"])

    def test_multitrait_missing_y_resident_fully_observed_genome(self):
        from mixmogam_tpu.models.multitrait import emmax_multi_trait

        G, imp, _ = _data(24, n=48, m=150)
        K = scale_k(kinship(G, method="ibs"))
        rng = np.random.default_rng(24)
        Y = np.stack([imp[3] + rng.normal(size=48) for _ in range(2)])
        Y[1, :5] = np.nan
        ref = emmax_multi_trait(imp, Y, K=K)
        rg = ResidentGenome.from_source(G, tile=64)
        res = emmax_multi_trait(rg, Y, K=K)
        np.testing.assert_allclose(res["ps"], ref["ps"], atol=1e-9)


class TestResidentEmma:
    def test_emma_parity(self):
        from mixmogam_tpu.models.emma import emma

        G, imp, y = _data(24, n=64, m=180, missing=0.02)
        K = scale_k(kinship(G, method="ibs"))
        ref = emma(imp, y, K=K, tile=64)
        rg = ResidentGenome.from_source(G, tile=64)
        res = emma(rg, y, K=K)
        np.testing.assert_allclose(res["ps"], ref["ps"], atol=1e-9)
        np.testing.assert_allclose(res["deltas"], ref["deltas"], rtol=1e-7)

    def test_as_dosage_materializes(self):
        """permutation/twosnp/linear take ResidentGenome through
        _as_dosage (host materialization with the normative imputation)."""
        from mixmogam_tpu.models.emmax import _as_dosage

        G, imp, _ = _data(25, n=48, m=150, missing=0.04)
        rg = ResidentGenome.from_source(G, tile=64)
        np.testing.assert_allclose(_as_dosage(rg, np.float64), imp,
                                   atol=1e-12)


class TestResidentDistributed:
    def test_sharded_packed_scan_mesh_invariance(self):
        """SNP-sharded packed genome via shard_map: bit-identical to the
        single-device resident scan across mesh shapes (8 virtual CPU
        devices from conftest)."""
        import jax

        from mixmogam_tpu.parallel.distributed import (
            distributed_emmax_resident)
        from mixmogam_tpu.parallel.mesh import make_mesh

        G, imp, y = _data(30, n=64, m=333)
        K = scale_k(kinship(G, method="ibs"))
        rg = ResidentGenome.from_source(G, tile=64)
        ref = emmax_resident(rg, y, K=K)
        devs = jax.devices()
        for nd in (1, 4, 8):
            if len(devs) < nd:
                continue
            mesh = make_mesh((nd, 1), devices=devs[:nd])
            res = distributed_emmax_resident(rg, y, K=K, mesh=mesh)
            np.testing.assert_array_equal(res["ps"], ref["ps"])
            np.testing.assert_array_equal(res["f_stats"], ref["f_stats"])

    def test_sample_tp_mesh_parity(self):
        """Round 5 (VERDICT r4 #3): the packed container's byte axis
        shards over 'sample' too — each device holds whole bytes (4
        samples/byte), W shards its contraction rows, partial rotations
        psum. Exact-tier f64 matches to partial-sum rounding; the DP
        mesh and single device stay bit-identical."""
        import jax

        from mixmogam_tpu.parallel.distributed import (
            distributed_emmax_resident)
        from mixmogam_tpu.parallel.mesh import make_mesh

        G, imp, y = _data(30, n=64, m=333)
        K = scale_k(kinship(G, method="ibs"))
        rg = ResidentGenome.from_source(G, tile=64)
        ref = emmax_resident(rg, y, K=K)
        devs = jax.devices()
        if len(devs) < 8:
            pytest.skip("needs 8 devices")
        for shape in ((4, 2), (2, 4), (1, 8)):
            mesh = make_mesh(shape, devices=devs[:8])
            res = distributed_emmax_resident(rg, y, K=K, mesh=mesh)
            np.testing.assert_allclose(res["ps"], ref["ps"], atol=1e-10,
                                       err_msg=f"mesh {shape}")
            np.testing.assert_array_equal(res["mask"], ref["mask"])

    def test_sample_tp_int8_bit_identical(self):
        """int8 digit planes psum their int32 accumulators BEFORE the
        float conversion, so the TP scan is BIT-identical to the
        single-device one (and to the DP-only mesh)."""
        import jax

        from mixmogam_tpu.parallel.distributed import (
            distributed_emmax_resident)
        from mixmogam_tpu.parallel.mesh import make_mesh

        G, imp, y = _data(33, n=64, m=256)
        K = scale_k(kinship(G, method="ibs"))
        rg = ResidentGenome.from_source(G, tile=64)
        ref = emmax_resident(rg, y, K=K, precision="int8x3")
        devs = jax.devices()
        if len(devs) < 8:
            pytest.skip("needs 8 devices")
        for shape in ((4, 2), (8, 1)):
            mesh = make_mesh(shape, devices=devs[:8])
            res = distributed_emmax_resident(rg, y, K=K, mesh=mesh,
                                             rotate_in_bf16="int8x3")
            np.testing.assert_array_equal(res["ps"], ref["ps"],
                                          err_msg=f"mesh {shape}")
            np.testing.assert_array_equal(res["f_stats"], ref["f_stats"],
                                          err_msg=f"mesh {shape}")

    def test_sample_tp_unaligned_n_and_missing(self):
        """n not divisible by 4*S exercises the byte-axis padding (pad
        samples = zero bytes x zero W rows); missing data exercises the
        cross-shard psum'd imputation moments."""
        import jax

        from mixmogam_tpu.parallel.distributed import (
            distributed_emmax_resident)
        from mixmogam_tpu.parallel.mesh import make_mesh

        devs = jax.devices()
        if len(devs) < 4:
            pytest.skip("needs 4 devices")
        G, imp, y = _data(34, n=66, m=128, missing=0.05)
        K = scale_k(kinship(G, method="ibs"))
        rg = ResidentGenome.from_source(G, tile=32)
        ref = emmax_resident(rg, y, K=K)
        mesh = make_mesh((2, 2), devices=devs[:4])
        res = distributed_emmax_resident(rg, y, K=K, mesh=mesh)
        np.testing.assert_allclose(res["ps"], ref["ps"], atol=1e-10)


class TestPackedCache:
    def test_from_source_cache_roundtrip(self, tmp_path):
        G, _, _ = _data(40, n=48, m=200, missing=0.03)
        cp = str(tmp_path / "packed.bin")
        a = ResidentGenome.from_source(G, tile=64, cache_path=cp)
        import os
        assert os.path.exists(cp) and os.path.exists(cp + ".json")
        b = ResidentGenome.from_source(None, tile=64, cache_path=cp)
        assert (b.M, b.n, b.ploidy, b.has_missing) == \
            (a.M, a.n, a.ploidy, a.has_missing)
        np.testing.assert_array_equal(np.asarray(b.packed),
                                      np.asarray(a.packed))

    def test_cache_tile_mismatch_repacks(self, tmp_path):
        G, _, _ = _data(41, n=32, m=100)
        cp = str(tmp_path / "packed.bin")
        ResidentGenome.from_source(G, tile=64, cache_path=cp)
        c = ResidentGenome.from_source(G, tile=32, cache_path=cp)
        assert c.tile == 32
        np.testing.assert_array_equal(c[0:100], G)

    def test_cache_same_shape_different_content_repacks(self, tmp_path):
        """VERDICT r3 weak #5: a regenerated genotype source with the
        SAME shape must not silently reuse stale packed rows — the cache
        is keyed on content, not shape."""
        G1, _, _ = _data(42, n=32, m=128)
        G2, _, _ = _data(43, n=32, m=128)
        assert G1.shape == G2.shape and not np.array_equal(G1, G2)
        cp = str(tmp_path / "p.bin")
        ResidentGenome.from_source(G1, tile=64, cache_path=cp)
        rg2 = ResidentGenome.from_source(G2, tile=64, cache_path=cp)
        np.testing.assert_array_equal(rg2[0:128], G2)

    def test_cache_trust_cache_skips_content_check(self, tmp_path):
        """trust_cache=True: shape/tile/ploidy only (the documented
        escape hatch for multi-GB memmaps the caller owns)."""
        G1, _, _ = _data(44, n=32, m=128)
        G2, _, _ = _data(45, n=32, m=128)
        cp = str(tmp_path / "p.bin")
        ResidentGenome.from_source(G1, tile=64, cache_path=cp)
        rg2 = ResidentGenome.from_source(G2, tile=64, cache_path=cp,
                                         trust_cache=True)
        # stale rows returned by design under trust_cache
        np.testing.assert_array_equal(rg2[0:128], G1)

    def test_cache_missing_src_hash_repacks(self, tmp_path):
        """Pre-round-4 caches carry no src_hash: treat as stale when a
        source is given (repack), still loadable with G=None."""
        import json

        G, _, _ = _data(46, n=32, m=128)
        cp = str(tmp_path / "p.bin")
        ResidentGenome.from_source(G, tile=64, cache_path=cp)
        with open(cp + ".json") as f:
            meta = json.load(f)
        meta.pop("src_hash")
        with open(cp + ".json", "w") as f:
            json.dump(meta, f)
        rg = ResidentGenome.from_source(G, tile=64, cache_path=cp)
        np.testing.assert_array_equal(rg[0:128], G)
        with open(cp + ".json") as f:
            assert "src_hash" in json.load(f)
        rg2 = ResidentGenome.from_source(None, tile=64, cache_path=cp)
        np.testing.assert_array_equal(rg2[0:128], G)


class TestResidentClassTests:
    """VERDICT r3 #1: anova/KW must source class sums from packed HBM
    instead of decoding the container to host. Parity vs the host
    (in-core) paths, which are themselves scipy-pinned elsewhere."""

    def test_anova_parity(self):
        from mixmogam_tpu.models.linear import anova

        G, _, y = _data(70, n=64, m=300, ploidy=2)
        rg = ResidentGenome.from_source(G, tile=64)
        ref = anova(G, y, ploidy=2)
        res = anova(rg, y)
        np.testing.assert_allclose(res["f_stats"], ref["f_stats"],
                                   rtol=1e-9)
        np.testing.assert_allclose(res["ps"], ref["ps"], rtol=1e-9)

    def test_anova_parity_missing(self):
        from mixmogam_tpu.models.linear import anova

        G, _, y = _data(71, n=64, m=300, ploidy=2, missing=0.06)
        rg = ResidentGenome.from_source(G, tile=64)
        ref = anova(G, y, ploidy=2)
        res = anova(rg, y)
        np.testing.assert_allclose(res["ps"], ref["ps"], rtol=1e-9)

    def test_kw_parity(self):
        from mixmogam_tpu.models.linear import kruskal_wallis

        G, _, y = _data(72, n=64, m=300, ploidy=2)
        rg = ResidentGenome.from_source(G, tile=64)
        ref = kruskal_wallis(G, y, ploidy=2)
        res = kruskal_wallis(rg, y)
        np.testing.assert_allclose(res["stats"], ref["stats"], rtol=1e-9)
        np.testing.assert_allclose(res["ps"], ref["ps"], rtol=1e-9)

    def test_kw_parity_missing(self):
        from mixmogam_tpu.models.linear import kruskal_wallis

        G, _, y = _data(73, n=64, m=300, ploidy=2, missing=0.06)
        rg = ResidentGenome.from_source(G, tile=64)
        ref = kruskal_wallis(G, y, ploidy=2)
        res = kruskal_wallis(rg, y)
        np.testing.assert_allclose(res["stats"], ref["stats"], rtol=1e-9)
        np.testing.assert_allclose(res["ps"], ref["ps"], rtol=1e-9)

    def test_kw_parity_haploid_missing(self):
        from mixmogam_tpu.models.linear import kruskal_wallis

        G, _, y = _data(74, n=48, m=200, ploidy=1, missing=0.1)
        rg = ResidentGenome.from_source(G, tile=64)
        ref = kruskal_wallis(G, y, ploidy=1)
        res = kruskal_wallis(rg, y)
        np.testing.assert_allclose(res["ps"], ref["ps"], rtol=1e-9)

    def test_anova_scipy_direct(self):
        """Anchor the packed path against scipy.stats.f_oneway on a
        handful of SNPs (not just the host-path implementation)."""
        import scipy.stats

        from mixmogam_tpu.models.linear import anova

        G, _, y = _data(75, n=80, m=60, ploidy=2, missing=0.05)
        rg = ResidentGenome.from_source(G, tile=64)
        res = anova(rg, y)
        for j in [0, 7, 33]:
            groups = [y[G[j] == g] for g in range(3)
                      if (G[j] == g).sum() > 0]
            if len(groups) < 2:
                continue
            f, p = scipy.stats.f_oneway(*groups)
            assert res["ps"][j] == pytest.approx(p, rel=1e-8)


class TestResidentPermutation:
    def test_perm_parity(self):
        from mixmogam_tpu.models.permutation import emmax_perm_test

        G, imp, y = _data(50, n=64, m=260, missing=0.03)
        K = scale_k(kinship(G, method="ibs"))
        rg = ResidentGenome.from_source(G, tile=64)
        ref = emmax_perm_test(imp, y, K=K, num_perm=16, seed=3, tile=64)
        res = emmax_perm_test(rg, y, K=K, num_perm=16, seed=3)
        np.testing.assert_allclose(res["min_ps"], ref["min_ps"],
                                   rtol=1e-8)
        assert res["threshold"] == pytest.approx(ref["threshold"],
                                                 rel=1e-8)

    def test_perm_identity_k(self):
        from mixmogam_tpu.models.permutation import emmax_perm_test

        G, imp, y = _data(51, n=48, m=150)
        rg = ResidentGenome.from_source(G, tile=64)
        ref = emmax_perm_test(imp, y, K=None, num_perm=8, seed=1, tile=64)
        res = emmax_perm_test(rg, y, K=None, num_perm=8, seed=1)
        np.testing.assert_allclose(res["min_ps"], ref["min_ps"],
                                   rtol=1e-8)


class TestReviewFixes:
    def test_cache_shape_mismatch_repacks(self, tmp_path):
        """Finding 3: a cached pack that does not match the source's
        shape must be ignored (repacked), not silently returned."""
        G1, _, _ = _data(60, n=32, m=128)
        G2, _, _ = _data(61, n=32, m=192)
        cp = str(tmp_path / "p.bin")
        ResidentGenome.from_source(G1, tile=64, cache_path=cp)
        rg2 = ResidentGenome.from_source(G2, tile=64, cache_path=cp)
        assert rg2.M == 192
        np.testing.assert_array_equal(rg2[0:192], G2)

    def test_cache_without_source_mismatch_raises(self, tmp_path):
        G1, _, _ = _data(62, n=32, m=128)
        cp = str(tmp_path / "p.bin")
        ResidentGenome.from_source(G1, tile=64, cache_path=cp)
        with pytest.raises(ValueError, match="does not match"):
            ResidentGenome.from_source(None, tile=32, cache_path=cp)

    def test_resident_genome_stream_true_conflict(self):
        """Finding 7: stream=True with a ResidentGenome G must refuse."""
        G, _, y = _data(63, n=32, m=64)
        rg = ResidentGenome.from_source(G, tile=32)
        with pytest.raises(ValueError, match="mutually exclusive"):
            emmax(rg, y, K=np.eye(32), stream=True)

    def test_host_packed_retained(self):
        """Finding 6: construction keeps the host-side packed copy."""
        G, _, _ = _data(64, n=32, m=64)
        rg = ResidentGenome.from_source(G, tile=32)
        assert rg.host_packed is not None
        np.testing.assert_array_equal(rg.host_packed,
                                      np.asarray(rg.packed))


class TestResidentLinear:
    def test_linear_model_parity(self):
        from mixmogam_tpu.models.linear import linear_model

        G, imp, y = _data(70, n=64, m=220, missing=0.03)
        rg = ResidentGenome.from_source(G, tile=64)
        ref = linear_model(imp, y)
        res = linear_model(rg, y)
        np.testing.assert_allclose(res["ps"], ref["ps"], atol=1e-9)
        np.testing.assert_allclose(res["betas"], ref["betas"], atol=1e-9)

    def test_anova_kw_via_array_protocol(self):
        from mixmogam_tpu.models.linear import anova, kruskal_wallis

        G, imp, y = _data(71, n=48, m=120)
        rg = ResidentGenome.from_source(G, tile=64)
        np.testing.assert_array_equal(np.asarray(rg), G)
        a = anova(rg, y)
        b = anova(G, y)
        np.testing.assert_allclose(a["ps"], b["ps"], atol=1e-12)
        ka = kruskal_wallis(rg, y)
        kb = kruskal_wallis(G, y)
        np.testing.assert_allclose(ka["ps"], kb["ps"], atol=1e-12)


class TestResidentPermFused:
    """Round 4: the resident perm sweep is ONE fused dispatch with
    optional rotation tiers."""

    def test_int8_tier_close_to_exact(self):
        from mixmogam_tpu.models.permutation import emmax_perm_test

        G, imp, y = _data(55, n=64, m=260)
        K = scale_k(kinship(G, method="ibs"))
        rg = ResidentGenome.from_source(G, tile=64)
        ref = emmax_perm_test(rg, y, K=K, num_perm=24, seed=5)
        res = emmax_perm_test(rg, y, K=K, num_perm=24, seed=5,
                              precision="int8x3")
        np.testing.assert_allclose(res["min_ps"], ref["min_ps"],
                                   rtol=1e-4)
        assert res["threshold"] == pytest.approx(ref["threshold"],
                                                 rel=1e-4)

    def test_tier_refuses_missing(self):
        from mixmogam_tpu.models.permutation import emmax_perm_test

        G, imp, y = _data(56, n=48, m=150, missing=0.05)
        K = scale_k(kinship(G, method="ibs"))
        rg = ResidentGenome.from_source(G, tile=64)
        with pytest.raises(ValueError, match="int8"):
            emmax_perm_test(rg, y, K=K, num_perm=8, precision="int8x2")

    def test_incore_refuses_precision(self):
        from mixmogam_tpu.models.permutation import emmax_perm_test

        G, imp, y = _data(57, n=48, m=100)
        with pytest.raises(ValueError, match="ResidentGenome"):
            emmax_perm_test(imp, y, K=None, num_perm=8,
                            precision="bf16")


class TestHostOnlyContainer:
    def test_upload_false_keeps_rows_host_side(self):
        """from_source(upload=False): the mesh flows shard per-chip from
        host_packed; no eager whole-genome device upload (review r5 #2)."""
        import jax

        from mixmogam_tpu.parallel.distributed import (
            distributed_emmax_resident)
        from mixmogam_tpu.parallel.mesh import make_mesh

        G, imp, y = _data(50, n=48, m=128)
        K = scale_k(kinship(G, method="ibs"))
        rg = ResidentGenome.from_source(G, tile=32, upload=False)
        assert isinstance(rg.packed, np.ndarray)  # host-side
        ref = emmax_resident(ResidentGenome.from_source(G, tile=32),
                             y, K=K)
        if len(jax.devices()) >= 4:
            mesh = make_mesh((4, 1), devices=jax.devices()[:4])
            d = distributed_emmax_resident(rg, y, K=K, mesh=mesh)
            np.testing.assert_allclose(d["ps"], ref["ps"], atol=1e-12)

    def test_shard_cache_reused_across_calls(self):
        """shard_packed_rows memoizes placement per (mesh, pads) so
        per-chromosome LOCO / repeated sweeps upload once (review r5 #1)."""
        import jax

        from mixmogam_tpu.parallel.distributed import shard_packed_rows
        from mixmogam_tpu.parallel.mesh import make_mesh

        if len(jax.devices()) < 4:
            pytest.skip("needs 4 devices")
        G, _, _ = _data(51, n=48, m=128)
        rg = ResidentGenome.from_source(G, tile=32)
        mesh = make_mesh((4, 1), devices=jax.devices()[:4])
        a = shard_packed_rows(rg, mesh, 32)
        b = shard_packed_rows(rg, mesh, 32)
        assert a is b
        mesh2 = make_mesh((2, 2), devices=jax.devices()[:4])
        c = shard_packed_rows(rg, mesh2, 32, sample_axis=True)
        assert c is not a
