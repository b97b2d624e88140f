"""Regression tests for the round-5 continuation review findings
(results/plotting/utils/cli/compat/phenotype pass)."""

import numpy as np
import pytest


class TestPhenotypeRawAlignment:
    """transform() rebuilds values from raw_values; filter/averaging
    must keep that base aligned or values silently land on the WRONG
    ecotypes (the verified review repro)."""

    def _pd(self):
        from mixmogam_tpu.data.phenotype import PhenotypeData

        return PhenotypeData.from_arrays(
            1, "t", ["a", "b", "c", "d"], [1.0, 2.0, 3.0, 4.0])

    def test_transform_after_filter_stays_aligned(self):
        pd = self._pd()
        assert pd.transform(1, "log")
        pd.filter_ecotypes(1, ["b", "d"])
        assert pd.transform(1, "sqrt")
        d = pd.value_dict(1)
        assert set(d) == {"b", "d"}
        np.testing.assert_allclose(d["b"], [np.sqrt(2.0)])
        np.testing.assert_allclose(d["d"], [np.sqrt(4.0)])

    def test_most_normal_after_filter(self):
        pd = self._pd()
        pd.filter_ecotypes(1, ["a", "c", "d"])
        pd.most_normal_transformation(1)
        assert len(pd.get_values(1)) == 3
        assert pd.get_ecotypes(1) == ["a", "c", "d"]

    def test_transform_after_averaging_uses_averaged_base(self):
        from mixmogam_tpu.data.phenotype import PhenotypeData

        pd = PhenotypeData.from_arrays(
            1, "t", ["a", "a", "b"], [1.0, 3.0, 9.0])
        pd.convert_to_averages()
        assert pd.transform(1, "sqrt")
        d = pd.value_dict(1)
        np.testing.assert_allclose(d["a"], [np.sqrt(2.0)])
        np.testing.assert_allclose(d["b"], [3.0])

    def test_filter_before_any_transform(self):
        pd = self._pd()
        pd.filter_ecotypes(1, ["a", "b"])
        assert pd.transform(1, "sqrt")
        np.testing.assert_allclose(pd.get_values(1),
                                   np.sqrt([1.0, 2.0]))


class TestCRLFHeader:
    def test_crlf_phenotype_file(self, tmp_path):
        from mixmogam_tpu.data.phenotype import PhenotypeData

        p = tmp_path / "phen.csv"
        p.write_bytes(b"ecotype_id,trait_a,trait_b\r\n"
                      b"s1,1.0,2.0\r\ns2,3.0,4.0\r\n")
        pd = PhenotypeData.parse_phenotype_file(str(p))
        assert pd.get_name(1) == "trait_a"
        assert pd.get_name(2) == "trait_b"       # no trailing \r
        np.testing.assert_allclose(pd.get_values(2), [2.0, 4.0])


class TestPlottingGuards:
    def test_qq_plot_no_finite_pvalues(self, tmp_path):
        from mixmogam_tpu.plotting.plots import qq_plot

        with pytest.raises(ValueError, match="finite"):
            qq_plot(np.array([np.nan, np.inf]),
                    str(tmp_path / "qq.png"))

    def test_agg_not_forced_over_loaded_backend(self):
        import sys

        import matplotlib

        from mixmogam_tpu.plotting.plots import _plt

        plt = _plt()  # pyplot now definitely loaded
        assert "matplotlib.pyplot" in sys.modules
        before = matplotlib.get_backend()
        _plt()  # second call must not force-switch the backend
        assert matplotlib.get_backend() == before
        assert plt is not None


class TestResultPickle:
    def test_only_pickled_roundtrip(self, tmp_path):
        from mixmogam_tpu.results.result import Result

        r = Result([0.5, 1e-8, 0.02], [1, 1, 2], [10, 20, 30],
                   mafs=[0.1, 0.2, 0.3],
                   additional={"betas": [0.0, 1.5, -0.4]})
        path = str(tmp_path / "res.pkl")
        r.write_to_file(path, only_pickled=True)
        r2 = Result.from_pickle(path)
        # ranked (best p first) like the CSV writer
        np.testing.assert_allclose(r2.scores, [1e-8, 0.02, 0.5])
        np.testing.assert_array_equal(r2.positions, [20, 30, 10])
        np.testing.assert_allclose(r2.additional["betas"],
                                   [1.5, -0.4, 0.0])
        assert r2.score_type == "pvals"


class TestGblupCvValidation:
    def test_folds_one_rejected(self):
        from mixmogam_tpu.models.gblup import gblup_cv

        rng = np.random.default_rng(0)
        G = (rng.random((40, 30)) < 0.5).astype(np.int8)
        y = rng.normal(size=30)
        with pytest.raises(ValueError, match="n_folds >= 2"):
            gblup_cv(G.astype(np.float64), y, n_folds=1)
        with pytest.raises(ValueError, match="exceeds"):
            gblup_cv(G.astype(np.float64), y, n_folds=31)


class TestCompatEigenCache:
    def test_same_k_keeps_cached_eigh(self, monkeypatch):
        from mixmogam_tpu import compat
        from mixmogam_tpu.ops import eigen

        rng = np.random.default_rng(1)
        n = 24
        A = rng.normal(size=(n, n))
        K = A @ A.T / n + np.eye(n)
        y = rng.normal(size=n)
        lmm = compat.LinearMixedModel(y)
        calls = {"n": 0}
        real = eigen.eigen_k

        def counting(*a, **kw):
            calls["n"] += 1
            return real(*a, **kw)

        monkeypatch.setattr(eigen, "eigen_k", counting)
        e1 = lmm._get_eigen_L_(K)
        e2 = lmm._get_eigen_L_(K)              # same object
        e3 = lmm._get_eigen_L_(K.copy())       # same content
        assert calls["n"] == 1
        np.testing.assert_allclose(e2["values"], e1["values"])
        np.testing.assert_allclose(e3["vectors"], e1["vectors"])
        # a DIFFERENT K must invalidate
        lmm._get_eigen_L_(K + np.eye(n) * 0.5)
        assert calls["n"] == 2


class TestLoggerPropagation:
    def test_no_double_logging(self):
        import logging

        from mixmogam_tpu.utils import profiling

        assert profiling.logger.propagate is False
        assert isinstance(profiling.logger.handlers[0],
                          logging.StreamHandler)


class TestOpsReviewFixes:
    """Second review pass over ops/ + resident/streaming (round-5
    continuation)."""

    def test_float_source_not_mutated_by_streaming_impute(self):
        """_host_float_tile must copy: imputing in place would silently
        overwrite the CALLER's NaNs (or crash on read-only memmaps)."""
        from mixmogam_tpu.models.streaming import _host_float_tile

        G = np.array([[1.0, np.nan, 3.0], [np.nan, 2.0, 2.0]])
        G_orig = G.copy()
        out = _host_float_tile(G[0:2], np.float64)
        assert np.isfinite(out).all()
        np.testing.assert_array_equal(np.isnan(G), np.isnan(G_orig))

    def test_readonly_float_memmap_streams(self, tmp_path):
        from mixmogam_tpu.models.source import fetch_tile

        rng = np.random.default_rng(2)
        G = rng.random((8, 12))
        G[1, 3] = np.nan
        path = tmp_path / "g.npy"
        np.save(path, G)
        mm = np.load(path, mmap_mode="r")     # read-only view
        t = fetch_tile(mm, 0, 8, 8, 12, np.float64)
        assert np.isfinite(np.asarray(t)).all()

    def test_truncated_manifest_restarts_instead_of_crashing(
            self, tmp_path, small_dataset, kinship_small):
        from mixmogam_tpu.models.streaming import emmax_streamed

        G = small_dataset["G_int"][:64]
        y, K = small_dataset["y"], kinship_small
        ck = str(tmp_path / "ck")
        ref = emmax_streamed(G, y, K=K, tile=32, checkpoint_dir=ck)
        # corrupt the manifest the way a mid-write SIGKILL would
        import glob

        mpath = glob.glob(f"{ck}/manifest_*.json")[0]
        with open(mpath, "w") as f:
            f.write('{"done": [0, 1')       # truncated JSON
        d = emmax_streamed(G, y, K=K, tile=32, checkpoint_dir=ck)
        np.testing.assert_allclose(d["ps"], ref["ps"], atol=1e-12)

    def test_from_source_missing_cache_clear_error(self, tmp_path):
        from mixmogam_tpu.models.resident import ResidentGenome

        with pytest.raises(ValueError, match="missing"):
            ResidentGenome.from_source(
                None, cache_path=str(tmp_path / "nope.bin"))

    def test_h2_ci_profiles_the_fitted_objective(self, small_dataset,
                                                 kinship_small):
        """An ML-fitted null must profile the ML curve (its own optimum
        sits ON the profiled likelihood)."""
        from mixmogam_tpu.ops.reml import fit_null_model, h2_profile_ci

        y, K = small_dataset["y"], kinship_small
        X0 = np.ones((len(y), 1))
        null_ml = fit_null_model(y, X0, K=K, ml=True)
        lo, hi = h2_profile_ci(null_ml)
        h2 = float(null_ml.pseudo_heritability)
        assert lo - 1e-9 <= h2 <= hi + 1e-9, (lo, h2, hi)
        null_reml = fit_null_model(y, X0, K=K)
        lo_r, hi_r = h2_profile_ci(null_reml)
        assert lo_r - 1e-9 <= float(null_reml.pseudo_heritability) \
            <= hi_r + 1e-9

    def test_finalize_scan_shared_output_contract(self, small_dataset,
                                                  kinship_small):
        """The three EMMAX paths now share ONE finalize/rescore
        epilogue: identical keys and identical rescored values."""
        from mixmogam_tpu.models import emmax
        from mixmogam_tpu.models.resident import ResidentGenome

        G, y, K = (small_dataset["G_int"][:128], small_dataset["y"],
                   kinship_small)
        d_in = emmax(G.astype(np.float64), y, K=K, stream=False)
        d_st = emmax(G, y, K=K, stream=True)
        rg = ResidentGenome.from_source(G, tile=32)
        d_rg = emmax(rg, y, K=K)
        assert set(d_in) == set(d_st) == set(d_rg)
        np.testing.assert_allclose(d_st["ps"], d_in["ps"], atol=1e-10)
        np.testing.assert_allclose(d_rg["ps"], d_in["ps"], atol=1e-10)


class TestDataPlaneReviewFixes:
    """Third review pass (data/ + native/)."""

    def test_crlf_vcf_last_sample_clean(self, tmp_path):
        from mixmogam_tpu.data.vcf import read_vcf

        body = ("##fileformat=VCFv4.2\r\n"
                "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT"
                "\tS1\tS2\r\n"
                "1\t100\t.\tA\tT\t.\tPASS\t.\tGT\t0/1\t1/1\r\n"
                "1\t200\t.\tG\tC\t.\tPASS\t.\tGT\t0/0\t0/1\r\n")
        p = tmp_path / "crlf.vcf"
        p.write_bytes(body.encode())
        gd = read_vcf(str(p))
        assert gd.accessions == ["S1", "S2"]     # no trailing \r
        np.testing.assert_array_equal(gd.matrix,
                                      [[1, 2], [0, 1]])

    def test_hdf5_dosage_dispatch(self, tmp_path):
        from mixmogam_tpu.data.genotype import DosageData, GenotypeData

        D = np.array([[0.25, np.nan, 1.75], [2.0, 0.0, 1.0]])
        dd = DosageData(D, [1, 1], [10, 20], ["a", "b", "c"], ploidy=2)
        h5 = str(tmp_path / "dos.h5")
        dd.write_hdf5(h5)
        back = GenotypeData.read_hdf5(h5)
        assert isinstance(back, DosageData)
        np.testing.assert_allclose(back.matrix, D)  # NaN preserved

    def test_pack_2bit_rejects_fractional_floats(self):
        from mixmogam_tpu import native

        with pytest.raises(ValueError, match="fractional|NaN"):
            native.pack_2bit(np.array([[0.7, 1.0], [np.nan, 2.0]]))
        # integral floats still pack (round-trips as hard calls)
        out = native.pack_2bit(np.array([[0.0, 1.0, 2.0, -1.0]]))
        np.testing.assert_array_equal(
            native.unpack_2bit(out, 4), [[0, 1, 2, -1]])

    def test_negative_dosage_token_is_missing(self, tmp_path):
        """Python parser matches the C++ rule: negative tokens are the
        missing sentinel, never observed dosages."""
        from mixmogam_tpu.data.parsers import parse_snp_data

        p = tmp_path / "g.csv"
        p.write_text("Chromosome,Position,a,b,c\n"
                     "1,100,0,-5,1\n1,200,1,1,-1\n")
        gd = parse_snp_data(str(p), data_format="binary")
        np.testing.assert_array_equal(gd.matrix,
                                      [[0, -1, 1], [1, 1, -1]])

    def test_bim_extra_contig_codes_above_numeric_max(self, tmp_path):
        from mixmogam_tpu.data.plink import read_bim

        p = tmp_path / "x.bim"
        p.write_text("27\ts1\t0\t100\tA\tT\n"
                     "Un\ts2\t0\t200\tG\tC\n"
                     "42\ts3\t0\t300\tA\tC\n"
                     "Un2\ts4\t0\t400\tT\tG\n")
        chroms, poss, ids, a1, a2 = read_bim(str(p))
        # 'Un'/'Un2' must NOT collide with numeric chromosomes 27/42
        assert chroms[0] == 27 and chroms[2] == 42
        assert chroms[1] > 42 and chroms[3] > 42
        assert chroms[1] != chroms[3]

    def test_write_packed_suffixless_roundtrip(self, tmp_path):
        from mixmogam_tpu.data.genotype import GenotypeData

        gd = GenotypeData(np.array([[0, 1, 2, -1]], np.int8), [1], [5],
                          ["a", "b", "c", "d"], ploidy=2)
        path = str(tmp_path / "genome.packed")   # no .npz suffix
        gd.write_packed(path)
        back = GenotypeData.read_packed(path)
        np.testing.assert_array_equal(back.matrix, gd.matrix)

    def test_dosage_content_hash_inherited(self):
        from mixmogam_tpu.data.genotype import DosageData, GenotypeData

        dd = DosageData(np.array([[0.5, 1.0]]), [1], [10], ["a", "b"],
                        ploidy=2)
        assert DosageData.content_hash is GenotypeData.content_hash
        assert len(dd.content_hash()) == 16


class TestModelsReviewFixes:
    """Fourth review pass (campaign models + api + caching)."""

    def test_covariates_compose_with_user_x0(self, tmp_path):
        """run_gwas(covariate_pids=..., X0=...) must fit BOTH designs
        (setdefault used to silently drop the covariates)."""
        from mixmogam_tpu.api import run_gwas
        from mixmogam_tpu.data.genotype import GenotypeData
        from mixmogam_tpu.data.phenotype import PhenotypeData
        from mixmogam_tpu.data.simulate import (simulate_genotypes,
                                                simulate_phenotype)
        from mixmogam_tpu.models import emmax
        from mixmogam_tpu.oracle import ibs_kinship, scale_k

        rng = np.random.default_rng(51)
        G, ch, po = simulate_genotypes(80, 300, seed=51)
        y, _ = simulate_phenotype(G, h2=0.5, n_causal=3, seed=51)
        cov = rng.normal(size=80)
        acc = [f"a{i}" for i in range(80)]
        gd = GenotypeData(G, ch, po, acc)
        gfile = str(tmp_path / "g.csv")
        pfile = str(tmp_path / "p.csv")
        gd.write_csv(gfile)
        pd = PhenotypeData()
        pd.add_phenotype(1, "trait", acc, y)
        pd.add_phenotype(2, "cov", acc, cov)
        pd.write_to_file(pfile)
        extra = rng.normal(size=(80, 1))     # user column (e.g. a PC)
        out = run_gwas(gfile, pfile, pid=1, covariate_pids=[2],
                       min_mac=1, plots=False,
                       X0=np.hstack([np.ones((80, 1)), extra]))
        gd2 = out["genotype"]
        keep = [acc.index(a) for a in gd2.accessions]
        X_full = np.hstack([np.ones((len(keep), 1)), extra[keep],
                            cov[keep][:, None]])
        K = scale_k(ibs_kinship(gd2.dosage_f64()))
        ref = emmax(gd2.dosage_f64(), out["y"], K=K, X0=X_full)
        # kinship differs (run_gwas caches its own) — compare via the
        # design's effect: same dof means the covariate really entered
        assert out["scan"]["dof"] == ref["dof"] == len(keep) - 3 - 1

    def test_stepwise_resident_sample_mismatch(self, small_dataset,
                                               kinship_small):
        from mixmogam_tpu.models.resident import ResidentGenome
        from mixmogam_tpu.models.stepwise import emmax_step_wise

        rg = ResidentGenome.from_source(small_dataset["G_int"], tile=50)
        y = small_dataset["y"][:150]         # wrong sample count
        with pytest.raises(ValueError, match="resident genome"):
            emmax_step_wise(rg, y, K=kinship_small[:150, :150],
                            max_steps=1)

    def test_cached_kinship_tolerates_corrupt_entry(self, tmp_path,
                                                    small_dataset):
        from mixmogam_tpu.data.genotype import GenotypeData
        from mixmogam_tpu.utils.caching import cached_kinship

        G = small_dataset["G_int"][:60]
        gd = GenotypeData(G, small_dataset["chromosomes"][:60],
                          small_dataset["positions"][:60],
                          [f"a{i}" for i in range(G.shape[1])])
        cd = str(tmp_path)
        K1 = cached_kinship(gd, cache_dir=cd, use_device=False)
        import glob

        p = glob.glob(f"{cd}/kinship_*.npz")[0]
        with open(p, "wb") as f:
            f.write(b"PK\x03\x04truncated")  # corrupt zip
        K2 = cached_kinship(gd, cache_dir=cd, use_device=False)
        np.testing.assert_allclose(K2, K1, atol=1e-12)
        # and the rewrite healed the entry
        K3 = cached_kinship(gd, cache_dir=cd, use_device=False)
        np.testing.assert_allclose(K3, K1, atol=1e-12)
