"""Round-2 third review pass: h5py-safe exact rescore, tiled/capped
rescore dispatch, float-streamed-source tier resolution, batched
run_gwas_multi facade kwargs, shared prefetch generator."""

import numpy as np
import pytest


class TestExactRescoreSources:
    def test_rescore_h5py_source(self, small_dataset, kinship_small,
                                 tmp_path):
        """h5py fancy selection rejects duplicate/non-monotone index
        lists; the rescore row fetch must stay strictly increasing
        unique (regression: padding used to repeat idx[0])."""
        h5py = pytest.importorskip("h5py")
        from mixmogam_tpu.models import emmax
        from mixmogam_tpu.models.streaming import emmax_streamed

        G_int = small_dataset["G_int"]
        y, K = small_dataset["y"], kinship_small
        f = h5py.File(tmp_path / "g.h5", "w")
        dset = f.create_dataset("g", data=G_int)
        exact = emmax(G_int, y, K=K, stream=False)
        fast = emmax_streamed(dset, y, K=K, tile=128,
                              rotate_in_bf16="int8x2", rescore_top=10)
        f.close()
        idx = fast["rescored_idx"]
        assert len(idx) >= 10
        np.testing.assert_allclose(fast["ps"][idx], exact["ps"][idx],
                                   rtol=1e-10)

    def test_rescore_tiled_dispatch(self, small_dataset, kinship_small):
        """_exact_rescore splits the candidate set at the scan tile size
        (one unbounded (|idx|, n) dispatch could exceed HBM at n=10k);
        tiling must not change any statistic."""
        from mixmogam_tpu.models.streaming import _exact_rescore
        from mixmogam_tpu.ops.reml import fit_null_model

        G_int = small_dataset["G_int"]
        y, K = small_dataset["y"], kinship_small
        null = fit_null_model(y, np.ones((len(y), 1)), K=K)
        idx = np.arange(0, 300, 2)
        i_one, d_one = _exact_rescore(G_int, idx, null, np.float64,
                                      tile=1 << 20)
        i_tile, d_tile = _exact_rescore(G_int, idx, null, np.float64,
                                        tile=64)
        np.testing.assert_array_equal(i_one, i_tile)
        for k in d_one:
            np.testing.assert_allclose(d_tile[k], d_one[k], atol=0)

    def test_incore_rescore_threshold_complete(self):
        """Round 5 SUPERSEDES the old 8*rescore_top cap (VERDICT r4 #2):
        a strong-signal genome (here: 128 near-copies of the causal SNP,
        every p far below the Bonferroni cut) must have EVERY sub-cut
        SNP in the rescore set — the cap silently left hits at tier
        drift; the set is bounded by the drift-widened cut instead."""
        from mixmogam_tpu.models import emmax
        from mixmogam_tpu.ops.scan import rescore_p_cut

        rng = np.random.default_rng(5)
        n = 64
        x = (rng.random(n) < 0.5).astype(np.int8)
        G = np.vstack([np.tile(x, (128, 1)),
                       (rng.random((32, n)) < 0.5).astype(np.int8)])
        y = x.astype(np.float64) + 0.01 * rng.normal(size=n)
        out = emmax(G, y, K=np.eye(n), stream=False,
                    precision="int8x2", rescore_top=2)
        # all 128 copies are sub-threshold -> all rescored (old cap: 16)
        assert len(out["rescored_idx"]) >= 128
        cut = rescore_p_cut(G.shape[0], "int8x2")
        assert set(np.flatnonzero(out["ps"] <= cut)) <= \
            set(out["rescored_idx"].tolist())


class TestStreamedFloatTierResolution:
    def test_fast_float_source_never_int8(self, small_dataset,
                                          kinship_small, monkeypatch):
        """'auto'/'fast' must not pick an int8 tier from a float
        streamed source (integrality of a prefix proves nothing about
        later tiles; the old 4096-row probe could crash mid-scan)."""
        import jax

        from mixmogam_tpu.models.streaming import emmax_streamed
        from mixmogam_tpu.ops.scan import PRECISION_ROUTES

        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        Gf = small_dataset["G_int"].astype(np.float64)
        # fractional dosages ONLY past the old probe window
        Gf[-1, 0] = 0.5
        y, K = small_dataset["y"], kinship_small
        out = emmax_streamed(Gf, y, K=K, tile=128, precision="fast")
        # the fractional route, never int8x2
        assert out["precision_tier"] == PRECISION_ROUTES["gpu"]["fast"][1]
        out2 = emmax_streamed(Gf, y, K=K, tile=128, precision="auto")
        assert out2["precision_tier"] == PRECISION_ROUTES["gpu"]["auto"][1]

    def test_explicit_int8_float_source_still_validates(
            self, small_dataset, kinship_small):
        from mixmogam_tpu.models.streaming import emmax_streamed

        Gf = small_dataset["G_int"].astype(np.float64)
        Gf[-1, 0] = 0.5
        with pytest.raises(ValueError, match="integer dosages"):
            emmax_streamed(Gf, small_dataset["y"], K=kinship_small,
                           tile=128, precision="int8x2")


class TestBatchedFacadeKwargs:
    def _files(self, tmp_path):
        from mixmogam_tpu.data.genotype import GenotypeData
        from mixmogam_tpu.data.simulate import (simulate_genotypes,
                                                simulate_phenotype)

        G, ch, po = simulate_genotypes(60, 300, seed=9)
        gd = GenotypeData(G, ch, po, [f"a{i}" for i in range(60)])
        g = str(tmp_path / "g.csv")
        gd.write_csv(g)
        y1, _ = simulate_phenotype(G, h2=0.6, n_causal=3, seed=9)
        rows = ["ecotype_id,t1"]
        for i in range(60):
            rows.append(f"a{i},{np.exp(y1[i] / 4):.6f}")
        p = str(tmp_path / "p.csv")
        with open(p, "w") as f:
            f.write("\n".join(rows) + "\n")
        return g, p

    def test_facade_kwargs_accepted(self, tmp_path):
        """batched=True must accept the facade kwargs batched=False
        takes (regression: method/esp/transform/plots raised
        TypeError deep inside emmax_multi_trait)."""
        from mixmogam_tpu.api import run_gwas_multi

        g, p = self._files(tmp_path)
        out = run_gwas_multi(g, p, batched=True, method="emmax",
                             esp=1e-6, transform="log", plots=False,
                             min_mac=5)
        assert np.isfinite(out[1]["scan"]["ps"]).all()

    def test_transform_matches_loop(self, tmp_path):
        from mixmogam_tpu.api import run_gwas_multi

        g, p = self._files(tmp_path)
        loop = run_gwas_multi(g, p, transform="log", min_mac=5,
                              plots=False)
        bat = run_gwas_multi(g, p, transform="log", min_mac=5,
                             batched=True, plots=False)
        np.testing.assert_allclose(bat[1]["scan"]["ps"],
                                   loop[1]["scan"]["ps"],
                                   rtol=1e-5, atol=1e-8)

    def test_unsupported_method_raises(self, tmp_path):
        from mixmogam_tpu.api import run_gwas_multi

        g, p = self._files(tmp_path)
        with pytest.raises(ValueError, match="batched=False"):
            run_gwas_multi(g, p, batched=True, method="kw")

    def test_unknown_kwarg_raises_clearly(self, tmp_path):
        from mixmogam_tpu.api import run_gwas_multi

        g, p = self._files(tmp_path)
        with pytest.raises(ValueError, match="not supported with "
                                             "batched=True"):
            run_gwas_multi(g, p, batched=True, num_steps=5)

    def test_batched_plots_rendered(self, tmp_path):
        from mixmogam_tpu.api import run_gwas_multi

        g, p = self._files(tmp_path)
        out = run_gwas_multi(g, p, batched=True, min_mac=5,
                             out_prefix=str(tmp_path / "o"))
        assert (tmp_path / "o.pid1.manhattan.png").exists()
        assert (tmp_path / "o.pid1.qq.png").exists()
        assert "manhattan" in out[1]["files"]


class TestPrefetchIter:
    def test_order_and_lookahead(self):
        from mixmogam_tpu.models.source import prefetch_iter

        calls = []

        def prep(k):
            calls.append(k)
            return k * 10

        got = list(prefetch_iter(range(5), prep))
        assert got == [(i, i * 10) for i in range(5)]
        assert sorted(calls) == list(range(5))

    def test_prep_exception_propagates(self):
        from mixmogam_tpu.models.source import prefetch_iter

        def prep(k):
            if k == 2:
                raise RuntimeError("boom")
            return k

        out = []
        with pytest.raises(RuntimeError, match="boom"):
            for k, v in prefetch_iter(range(5), prep):
                out.append(k)
        assert out == [0, 1]
