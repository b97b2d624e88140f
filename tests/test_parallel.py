"""Distributed tests on the 8-virtual-CPU-device mesh (SURVEY.md §4.3):
numerical invariance to mesh shape, psum kinship parity, graft entries."""

import importlib
import os
import sys

import jax
import numpy as np
import pytest

from mixmogam_tpu import oracle
from mixmogam_tpu.models import emmax
from mixmogam_tpu.parallel.distributed import (distributed_emmax,
                                               distributed_kinship,
                                               distributed_train_step)
from mixmogam_tpu.parallel.mesh import make_mesh


@pytest.fixture(scope="module")
def meshes():
    devs = jax.devices()
    assert len(devs) >= 8, "conftest should provide 8 virtual devices"
    return {
        "one": make_mesh((1, 1), devices=devs[:1]),
        "snp8": make_mesh((8, 1), devices=devs[:8]),
        "mix": make_mesh((4, 2), devices=devs[:8]),
    }


class TestDistributedKinship:
    def test_psum_matches_oracle(self, small_dataset, meshes):
        G = small_dataset["G"]
        Ko = oracle.ibs_kinship(G)
        for name, mesh in meshes.items():
            Kd = distributed_kinship(G, mesh=mesh, method="ibs")
            np.testing.assert_allclose(Kd, Ko, atol=1e-10,
                                       err_msg=f"mesh {name}")

    def test_vanraden_psum(self, small_dataset, meshes):
        G = small_dataset["G"]
        Ko = oracle.vanraden_kinship(G, ploidy=1)
        Kd = distributed_kinship(G, mesh=meshes["snp8"], method="vanraden")
        np.testing.assert_allclose(Kd, Ko, atol=1e-9)

    def test_uneven_shard_padding(self, meshes):
        """M not divisible by the shard count must still be exact."""
        rng = np.random.default_rng(0)
        G = (rng.random((101, 40)) < 0.5).astype(np.float64)
        Ko = oracle.ibs_kinship(G)
        Kd = distributed_kinship(G, mesh=meshes["snp8"], method="ibs")
        np.testing.assert_allclose(Kd, Ko, atol=1e-10)


class TestDistributedEmmax:
    def test_mesh_shape_invariance(self, small_dataset, kinship_small,
                                   meshes):
        """1 chip == 8 chips == 4x2 (SURVEY §4.3: the distributed test
        pyramid's core invariant)."""
        G, y, K = small_dataset["G"], small_dataset["y"], kinship_small
        ref = emmax(G, y, K=K)
        for name, mesh in meshes.items():
            d = distributed_emmax(G, y, K=K, mesh=mesh)
            np.testing.assert_allclose(d["ps"], ref["ps"], atol=1e-10,
                                       err_msg=f"mesh {name}")
            np.testing.assert_allclose(d["f_stats"], ref["f_stats"],
                                       rtol=1e-9, err_msg=f"mesh {name}")

    def test_precision_tier_on_mesh(self, small_dataset, kinship_small,
                                    meshes):
        """The split-W bf16x3 tier also runs sharded and stays close to
        the exact path (fp32-grade — CPU bf16 emulation is looser than
        a tensor-core bf16 GEMM, hence the modest tolerance)."""
        G, y, K = small_dataset["G"], small_dataset["y"], kinship_small
        ref = emmax(G, y, K=K)
        d = distributed_emmax(G, y, K=K, mesh=meshes["snp8"],
                              dtype=np.float32, rotate_in_bf16="x3")
        assert np.argmin(d["ps"]) == np.argmin(ref["ps"])
        assert np.max(np.abs(d["ps"] - ref["ps"])) < 1e-4

    def test_int8_digit_tier_on_mesh(self, small_dataset, kinship_small,
                                     meshes):
        """The int8 digit-plane tier ('int8x3', fp32-grade) also runs
        sharded: exact int32 accumulation is device-count invariant."""
        G, y, K = small_dataset["G"], small_dataset["y"], kinship_small
        ref = emmax(G, y, K=K)
        d = distributed_emmax(G, y, K=K, mesh=meshes["snp8"],
                              dtype=np.float32, rotate_in_bf16="int8x3")
        assert np.argmin(d["ps"]) == np.argmin(ref["ps"])
        assert np.max(np.abs(d["ps"] - ref["ps"])) < 1e-4

    def test_uneven_snp_count(self, small_dataset, kinship_small, meshes):
        G, y, K = small_dataset["G"][:37], small_dataset["y"], kinship_small
        ref = emmax(G, y, K=K)
        d = distributed_emmax(G, y, K=K, mesh=meshes["snp8"])
        assert d["ps"].shape == (37,)
        np.testing.assert_allclose(d["ps"], ref["ps"], atol=1e-10)

    def test_uneven_sample_count_tp(self, small_dataset, kinship_small,
                                    meshes):
        """n not divisible by the 'sample' axis width: sample columns +
        W contraction rows zero-pad (round-5 fix — the TP device_put
        used to reject odd n outright)."""
        keep = np.arange(199)
        G = small_dataset["G"][:, keep]
        y = small_dataset["y"][keep]
        K = kinship_small[np.ix_(keep, keep)]
        ref = emmax(G, y, K=K)
        d = distributed_emmax(G, y, K=K, mesh=meshes["mix"])
        np.testing.assert_allclose(d["ps"], ref["ps"], atol=1e-10)
        # tiered W pads per-plane rows the same way
        d8 = distributed_emmax(G, y, K=K, mesh=meshes["mix"],
                               dtype=np.float32, rotate_in_bf16="int8x3")
        assert np.argmin(d8["ps"]) == np.argmin(ref["ps"])
        # concat bf16 tier: row-padding must not defeat apply_rotation's
        # k-from-shape heuristic (n_out disambiguates — review fix)
        dc = distributed_emmax(G, y, K=K, mesh=meshes["mix"],
                               dtype=np.float32, rotate_in_bf16="x3c")
        assert np.argmin(dc["ps"]) == np.argmin(ref["ps"])
        assert np.max(np.abs(dc["ps"] - ref["ps"])) < 1e-4


class TestTrainStep:
    def test_train_step_runs_and_is_mesh_invariant(self, meshes):
        rng = np.random.default_rng(5)
        n, M, T = 24, 48, 2
        G = (rng.random((M, n)) < 0.4).astype(np.float32)
        Y = rng.normal(size=(T, n)).astype(np.float32)
        outs = {}
        for name in ("one", "snp8", "mix"):
            outs[name] = distributed_train_step(meshes[name], G, Y, top_k=4)
        for name in ("snp8", "mix"):
            np.testing.assert_allclose(outs[name]["K"], outs["one"]["K"],
                                       atol=1e-5)
            np.testing.assert_allclose(outs[name]["top_f"],
                                       outs["one"]["top_f"], rtol=2e-4)
            np.testing.assert_array_equal(outs[name]["top_idx"],
                                          outs["one"]["top_idx"])


class TestGraftEntry:
    def test_entry_compiles(self):
        sys.path.insert(0, os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        ge = importlib.import_module("__graft_entry__")
        fn, args = ge.entry()
        out = jax.jit(fn)(*args)
        assert np.isfinite(np.asarray(out)).all()

    def test_dryrun_multichip(self):
        sys.path.insert(0, os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        ge = importlib.import_module("__graft_entry__")
        ge.dryrun_multichip(8)


class TestSampleAxisTP:
    """VERDICT r1 #7: the 'sample' mesh axis does real work — the (n, n)
    rotate+whiten operator W is sharded over its contraction rows, so W
    (the HBM hog at large n) occupies 1/S of each chip; XLA psums the
    partial rotations. Exactness checked on pure-TP and mixed meshes."""

    def test_pure_tp_mesh_parity(self, small_dataset, kinship_small):
        devs = jax.devices()
        mesh_tp = make_mesh((1, 8), devices=devs[:8])
        G, y, K = small_dataset["G"], small_dataset["y"], kinship_small
        ref = emmax(G, y, K=K, stream=False)
        d = distributed_emmax(G, y, K=K, mesh=mesh_tp)
        np.testing.assert_allclose(d["ps"], ref["ps"], atol=1e-10)

    def test_w_is_sharded_over_samples(self, small_dataset, kinship_small):
        from jax.sharding import PartitionSpec as P

        from mixmogam_tpu.ops.reml import fit_null_model
        from mixmogam_tpu.ops.scan import build_rotated_null
        from mixmogam_tpu.parallel.distributed import rot_shardings
        from mixmogam_tpu.parallel.mesh import put_global

        devs = jax.devices()
        mesh = make_mesh((2, 4), devices=devs[:8])
        G, y, K = small_dataset["G"], small_dataset["y"], kinship_small
        n = len(y)
        null = fit_null_model(y, np.ones((n, 1)), K=K)
        rot = build_rotated_null(null)
        shd = rot_shardings(mesh, rot)
        Wd = put_global(rot.W, shd.W)
        # each device holds an (n/4, n) row block of W, not the full W
        shard_shapes = {s.data.shape for s in Wd.addressable_shards}
        assert shard_shapes == {(n // 4, n)}

    def test_tp_mixed_mesh_int8_tier(self, small_dataset, kinship_small):
        """The (k, n, n) int8 digit-plane W also shards over 'sample'."""
        devs = jax.devices()
        mesh = make_mesh((2, 4), devices=devs[:8])
        G, y, K = (small_dataset["G_int"], small_dataset["y"],
                   kinship_small)
        ref = emmax(G, y, K=K, stream=False)
        d = distributed_emmax(G, y, K=K, mesh=mesh, dtype=np.float64,
                              rotate_in_bf16="int8x4")
        assert np.argmin(d["ps"]) == np.argmin(ref["ps"])
        assert np.max(np.abs(d["ps"] - ref["ps"])) < 1e-4


class TestDistributedCampaign:
    """VERDICT r4 #4: the campaign workloads — stepwise MLMM, LOCO,
    GxE, permutation — run SNP-sharded on a mesh with parity against
    the single-device paths (not just the core train step)."""

    def test_stepwise_mesh_parity(self, small_dataset, kinship_small):
        from mixmogam_tpu.models.stepwise import emmax_step_wise

        G, y, K = small_dataset["G"], small_dataset["y"], kinship_small
        ref = emmax_step_wise(G, y, K=K, max_steps=3)
        devs = jax.devices()
        for shape in ((8, 1), (4, 2)):
            mesh = make_mesh(shape, devices=devs[:8])
            d = emmax_step_wise(G, y, K=K, max_steps=3, mesh=mesh)
            for sr, sd_ in zip(ref["steps"], d["steps"]):
                assert sr["cofactors"] == sd_["cofactors"], shape
                if np.isfinite(sr["min_p"]):
                    np.testing.assert_allclose(sd_["min_p"], sr["min_p"],
                                               rtol=1e-8)
                np.testing.assert_allclose(sd_["bic"], sr["bic"],
                                           rtol=1e-8)
            assert d["selected"] == ref["selected"]

    def test_loco_mesh_parity(self, small_dataset):
        from mixmogam_tpu.models.loco import emmax_loco

        G, ch, y = (small_dataset["G_int"],
                    small_dataset["chromosomes"], small_dataset["y"])
        ref = emmax_loco(G, y, chromosomes=ch, ploidy=1)
        devs = jax.devices()
        mesh = make_mesh((4, 2), devices=devs[:8])
        d = emmax_loco(G, y, chromosomes=ch, ploidy=1, mesh=mesh)
        np.testing.assert_allclose(d["ps"], ref["ps"], atol=1e-10)
        assert set(d["loco"]) == set(ref["loco"])
        for c in ref["loco"]:
            np.testing.assert_allclose(d["loco"][c]["delta"],
                                       ref["loco"][c]["delta"],
                                       rtol=1e-10)

    def test_loco_mesh_resident_source(self, small_dataset):
        from mixmogam_tpu.models.loco import emmax_loco
        from mixmogam_tpu.models.resident import ResidentGenome

        G, ch, y = (small_dataset["G_int"],
                    small_dataset["chromosomes"], small_dataset["y"])
        rg = ResidentGenome.from_source(G, tile=50)
        ref = emmax_loco(rg, y, chromosomes=ch, ploidy=1)
        mesh = make_mesh((2, 4), devices=jax.devices()[:8])
        d = emmax_loco(rg, y, chromosomes=ch, ploidy=1, mesh=mesh)
        np.testing.assert_allclose(d["ps"], ref["ps"], atol=1e-10)

    def test_gxe_mesh_parity(self, small_dataset, kinship_small):
        from mixmogam_tpu.models.gxe import emmax_gxe

        G, y, K = small_dataset["G"], small_dataset["y"], kinship_small
        rng = np.random.default_rng(11)
        env = (rng.random(len(y)) < 0.5).astype(np.float64)
        ref = emmax_gxe(G, y, env, K=K)
        devs = jax.devices()
        for shape in ((8, 1), (4, 2)):
            mesh = make_mesh(shape, devices=devs[:8])
            d = emmax_gxe(G, y, env, K=K, mesh=mesh)
            for k in ("marginal_ps", "inter_ps", "joint_ps"):
                np.testing.assert_allclose(d[k], ref[k], atol=1e-10,
                                           err_msg=f"{k} mesh {shape}")

    def test_perm_mesh_parity(self, small_dataset, kinship_small):
        from mixmogam_tpu.models.permutation import emmax_perm_test

        G, y, K = small_dataset["G"], small_dataset["y"], kinship_small
        ref = emmax_perm_test(G, y, K=K, num_perm=16, seed=3, tile=64)
        devs = jax.devices()
        mesh = make_mesh((4, 2), devices=devs[:8])
        d = emmax_perm_test(G, y, K=K, num_perm=16, seed=3, mesh=mesh)
        np.testing.assert_allclose(d["min_ps"], ref["min_ps"],
                                   atol=1e-10)
        np.testing.assert_allclose(d["threshold"], ref["threshold"],
                                   rtol=1e-8)

    def test_perm_mesh_identity_k(self, small_dataset):
        from mixmogam_tpu.models.permutation import emmax_perm_test

        G, y = small_dataset["G"], small_dataset["y"]
        ref = emmax_perm_test(G, y, K=None, num_perm=8, seed=1, tile=64)
        mesh = make_mesh((8, 1), devices=jax.devices()[:8])
        d = emmax_perm_test(G, y, K=None, num_perm=8, seed=1, mesh=mesh)
        np.testing.assert_allclose(d["min_ps"], ref["min_ps"],
                                   atol=1e-12)

    def test_gxe_mesh_resident_source(self, small_dataset, kinship_small):
        from mixmogam_tpu.models.gxe import emmax_gxe
        from mixmogam_tpu.models.resident import ResidentGenome

        G, y, K = (small_dataset["G_int"], small_dataset["y"],
                   kinship_small)
        rng = np.random.default_rng(12)
        env = (rng.random(len(y)) < 0.5).astype(np.float64)
        rg = ResidentGenome.from_source(G, tile=50)
        ref = emmax_gxe(rg, y, env, K=K)
        mesh = make_mesh((8, 1), devices=jax.devices()[:8])
        d = emmax_gxe(rg, y, env, K=K, mesh=mesh)
        for k in ("marginal_ps", "inter_ps", "joint_ps"):
            np.testing.assert_allclose(d[k], ref[k], atol=1e-10)
        with pytest.raises(ValueError, match="snp"):
            emmax_gxe(rg, y, env, K=K,
                      mesh=make_mesh((4, 2), devices=jax.devices()[:8]))

    def test_perm_mesh_resident_source(self, small_dataset,
                                       kinship_small):
        from mixmogam_tpu.models.permutation import emmax_perm_test
        from mixmogam_tpu.models.resident import ResidentGenome

        G, y, K = (small_dataset["G_int"], small_dataset["y"],
                   kinship_small)
        rg = ResidentGenome.from_source(G, tile=50)
        ref = emmax_perm_test(rg, y, K=K, num_perm=12, seed=4)
        mesh = make_mesh((8, 1), devices=jax.devices()[:8])
        d = emmax_perm_test(rg, y, K=K, num_perm=12, seed=4, mesh=mesh)
        np.testing.assert_allclose(d["min_ps"], ref["min_ps"],
                                   atol=1e-10)

    def test_perm_mesh_resident_identity_k(self, small_dataset):
        from mixmogam_tpu.models.permutation import emmax_perm_test
        from mixmogam_tpu.models.resident import ResidentGenome

        G, y = small_dataset["G_int"], small_dataset["y"]
        rg = ResidentGenome.from_source(G, tile=50)
        ref = emmax_perm_test(rg, y, K=None, num_perm=8, seed=2)
        mesh = make_mesh((8, 1), devices=jax.devices()[:8])
        d = emmax_perm_test(rg, y, K=None, num_perm=8, seed=2,
                            mesh=mesh)
        np.testing.assert_allclose(d["min_ps"], ref["min_ps"],
                                   atol=1e-12)

    def test_emmax_mesh_kwarg(self, small_dataset, kinship_small):
        """The core emmax() facade routes mesh= through the sharded
        paths (API uniformity with the campaign entry points)."""
        from mixmogam_tpu.models.emmax import emmax
        from mixmogam_tpu.models.resident import ResidentGenome

        G, y, K = small_dataset["G"], small_dataset["y"], kinship_small
        ref = emmax(G, y, K=K, stream=False)
        mesh = make_mesh((4, 2), devices=jax.devices()[:8])
        d = emmax(G, y, K=K, mesh=mesh)
        np.testing.assert_allclose(d["ps"], ref["ps"], atol=1e-10)
        assert abs(d["sigma_g2"] - ref["sigma_g2"]) < 1e-10
        # resident source routes to the packed sharded path
        rg = ResidentGenome.from_source(small_dataset["G_int"], tile=50)
        dr = emmax(rg, y, K=K, mesh=mesh)
        np.testing.assert_allclose(dr["ps"], ref["ps"], atol=1e-10)
        # tier names resolve; single-device-only features are rejected
        di = emmax(rg, y, K=K, mesh=mesh, precision="int8x3")
        assert np.argmin(di["ps"]) == np.argmin(ref["ps"])
        with pytest.raises(ValueError, match="single-device"):
            emmax(G, y, K=K, mesh=mesh, rescore_top=8)
        with pytest.raises(ValueError, match="fast"):
            emmax(G, y, K=K, mesh=mesh, precision="fast")

    def test_multitrait_mesh_parity(self, small_dataset, kinship_small):
        """emmax_multi_trait(mesh=): in-core sources shard 'snp' (and
        contraction-row-shard the rotation on 2-D meshes); missing-Y
        pattern groups each run sharded."""
        from mixmogam_tpu.models.multitrait import emmax_multi_trait

        G, y, K = small_dataset["G"], small_dataset["y"], kinship_small
        rng = np.random.default_rng(21)
        Y = np.stack([y, y + rng.normal(size=len(y)),
                      rng.normal(size=len(y))])
        ref = emmax_multi_trait(G, Y, K=K)
        devs = jax.devices()
        for shape in ((8, 1), (4, 2)):
            mesh = make_mesh(shape, devices=devs[:8])
            d = emmax_multi_trait(G, Y, K=K, mesh=mesh)
            np.testing.assert_allclose(d["ps"], ref["ps"], atol=1e-10,
                                       err_msg=f"mesh {shape}")
            np.testing.assert_allclose(d["betas"], ref["betas"],
                                       atol=1e-10)
            np.testing.assert_allclose(d["deltas"], ref["deltas"],
                                       rtol=1e-12)
        # per-trait missing phenotypes: grouped path, each group sharded
        Ym = Y.copy()
        Ym[1, :11] = np.nan
        Ym[2, 5:9] = np.nan
        ref_m = emmax_multi_trait(G, Ym, K=K)
        d_m = emmax_multi_trait(
            G, Ym, K=K, mesh=make_mesh((8, 1), devices=devs[:8]))
        np.testing.assert_allclose(d_m["ps"], ref_m["ps"], atol=1e-10)

    def test_multitrait_mesh_resident_source(self, small_dataset,
                                             kinship_small):
        """Packed-container multi-trait scan sharded over 'snp',
        including the int8 digit-plane tier and the missing-Y
        column-gather groups (device gather is shard-local)."""
        from mixmogam_tpu.models.multitrait import emmax_multi_trait
        from mixmogam_tpu.models.resident import ResidentGenome

        G, y, K = (small_dataset["G_int"], small_dataset["y"],
                   kinship_small)
        rng = np.random.default_rng(22)
        Y = np.stack([y, rng.normal(size=len(y))])
        rg = ResidentGenome.from_source(G, tile=50)
        mesh = make_mesh((8, 1), devices=jax.devices()[:8])
        ref = emmax_multi_trait(rg, Y, K=K)
        d = emmax_multi_trait(rg, Y, K=K, mesh=mesh)
        np.testing.assert_allclose(d["ps"], ref["ps"], atol=1e-10)
        ref_i8 = emmax_multi_trait(rg, Y, K=K, precision="int8x3")
        d_i8 = emmax_multi_trait(rg, Y, K=K, precision="int8x3",
                                 mesh=mesh)
        # int8 planes are exact int32 accumulations: bit-identical
        np.testing.assert_array_equal(d_i8["f_stats"], ref_i8["f_stats"])
        Ym = Y.copy()
        Ym[1, 3:17] = np.nan
        ref_m = emmax_multi_trait(rg, Ym, K=K)
        d_m = emmax_multi_trait(rg, Ym, K=K, mesh=mesh)
        np.testing.assert_allclose(d_m["ps"], ref_m["ps"], atol=1e-10)
        # SAMPLE-TP packed multi-trait: byte-axis shards, RU rows psum
        mesh42 = make_mesh((4, 2), devices=jax.devices()[:8])
        d_tp = emmax_multi_trait(rg, Y, K=K, mesh=mesh42)
        np.testing.assert_allclose(d_tp["ps"], ref["ps"], atol=1e-10)
        d_tp8 = emmax_multi_trait(rg, Y, K=K, precision="int8x3",
                                  mesh=mesh42)
        np.testing.assert_array_equal(d_tp8["f_stats"],
                                      ref_i8["f_stats"])
        # a packed missing-Y pattern SUBSET stays DP-only (column
        # gathers need full byte rows)
        with pytest.raises(ValueError, match="snp"):
            emmax_multi_trait(rg, Ym, K=K, mesh=mesh42)
        # missing GENOTYPES on the TP mesh: cross-shard moment psum
        Gm = G.copy()
        Gm[::9, ::7] = -1
        rgm = ResidentGenome.from_source(Gm, tile=50)
        ref_gm = emmax_multi_trait(rgm, Y, K=K)
        d_gm = emmax_multi_trait(rgm, Y, K=K, mesh=mesh42)
        np.testing.assert_allclose(d_gm["ps"], ref_gm["ps"], atol=1e-10)

    def test_emma_mesh_parity(self, small_dataset, kinship_small):
        """emma(mesh=): the batched per-SNP REML scan shards 'snp'
        (in-core and packed sources; f- and LRT-tests)."""
        from mixmogam_tpu.models.emma import emma
        from mixmogam_tpu.models.resident import ResidentGenome

        G, y, K = small_dataset["G"], small_dataset["y"], kinship_small
        ref = emma(G, y, K=K, tile=64)
        mesh = make_mesh((8, 1), devices=jax.devices()[:8])
        d = emma(G, y, K=K, tile=64, mesh=mesh)
        np.testing.assert_allclose(d["ps"], ref["ps"], atol=1e-10)
        np.testing.assert_allclose(d["deltas"], ref["deltas"],
                                   rtol=1e-10)
        rg = ResidentGenome.from_source(small_dataset["G_int"], tile=50)
        ref_r = emma(rg, y, K=K)
        d_r = emma(rg, y, K=K, mesh=mesh)
        np.testing.assert_allclose(d_r["ps"], ref_r["ps"], atol=1e-10)
        ref_l = emma(G, y, K=K, tile=64, test="lrt")
        d_l = emma(G, y, K=K, tile=64, test="lrt", mesh=mesh)
        np.testing.assert_allclose(d_l["ps"], ref_l["ps"], atol=1e-10)
        with pytest.raises(ValueError, match="snp"):
            emma(G, y, K=K,
                 mesh=make_mesh((4, 2), devices=jax.devices()[:8]))

    def test_class_tests_mesh_parity(self, small_dataset):
        """linear_model / anova / kruskal_wallis take mesh= (round-5
        continuation: every scan entry point shards): in-core + packed
        sources, fully-observed + missing, odd sizes."""
        from mixmogam_tpu.models.linear import (anova, kruskal_wallis,
                                                linear_model)
        from mixmogam_tpu.models.resident import ResidentGenome

        rng = np.random.default_rng(31)
        n, M = 53, 101                       # odd on purpose
        G = rng.integers(0, 3, size=(M, n)).astype(np.int8)
        Gm = G.copy()
        Gm[rng.random(G.shape) < 0.05] = -1
        y = G[7].astype(np.float64) + rng.normal(size=n)
        y[3] = y[5]                          # ties for KW
        devs = jax.devices()
        mesh = make_mesh((8, 1), devices=devs[:8])
        rg = ResidentGenome.from_source(G, tile=16)
        rgm = ResidentGenome.from_source(Gm, tile=16)

        ref = linear_model(G, y)
        d = linear_model(G, y, mesh=mesh)
        np.testing.assert_allclose(d["ps"], ref["ps"], atol=1e-12)
        d42 = linear_model(G, y,
                           mesh=make_mesh((4, 2), devices=devs[:8]))
        np.testing.assert_allclose(d42["ps"], ref["ps"], atol=1e-12)
        np.testing.assert_allclose(
            linear_model(rgm, y, mesh=mesh)["ps"],
            linear_model(rgm, y)["ps"], atol=1e-12)

        for fn in (anova, kruskal_wallis):
            for src in (G, Gm, rg, rgm):
                r0 = fn(src, y)
                r1 = fn(src, y, mesh=mesh)
                np.testing.assert_allclose(
                    r1["ps"], r0["ps"], atol=1e-12,
                    err_msg=f"{fn.__name__} {type(src).__name__}")
        # packed class sums are DP-only (documented)
        with pytest.raises(ValueError, match="snp"):
            anova(rg, y, mesh=make_mesh((4, 2), devices=devs[:8]))

    def test_emmax_anova_mesh_parity(self, kinship_small, small_dataset):
        """emmax_anova's diploid joint-indicator scan takes mesh= (the
        binary path forwards to emmax's mesh routing)."""
        from mixmogam_tpu.models.emmax import emmax_anova
        from mixmogam_tpu.oracle import ibs_kinship, scale_k

        rng = np.random.default_rng(41)
        n, M = 120, 150
        G2 = rng.integers(0, 3, size=(M, n)).astype(np.int8)
        y = G2[11].astype(np.float64) + rng.normal(size=n)
        K2 = scale_k(ibs_kinship(G2.astype(np.float64), ploidy=2))
        ref = emmax_anova(G2, y, K=K2)
        devs = jax.devices()
        for shape in ((8, 1), (4, 2)):
            d = emmax_anova(G2, y, K=K2,
                            mesh=make_mesh(shape, devices=devs[:8]))
            np.testing.assert_allclose(d["ps"], ref["ps"], atol=1e-10,
                                       err_msg=f"mesh {shape}")

    def test_twosnp_mesh_parity(self, small_dataset, kinship_small):
        """emmax_two_snps(mesh=): the partner axis shards; conditional
        and pairwise-interaction kernels are row-parallel."""
        from mixmogam_tpu.models.twosnp import emmax_two_snps

        G, y, K = small_dataset["G"], small_dataset["y"], kinship_small
        focal = [3, 41, 100]
        ref = emmax_two_snps(G, y, K=K, focal_idx=focal)
        devs = jax.devices()
        for shape in ((8, 1), (4, 2)):
            d = emmax_two_snps(G, y, K=K, focal_idx=focal,
                               mesh=make_mesh(shape, devices=devs[:8]))
            np.testing.assert_allclose(d["cond_ps"], ref["cond_ps"],
                                       atol=1e-10, err_msg=f"{shape}")
            np.testing.assert_allclose(d["inter_ps"], ref["inter_ps"],
                                       atol=1e-10, err_msg=f"{shape}")
