"""Worker process for the REAL 2-process jax.distributed test
(tests/test_multihost_real.py). Each process owns 4 virtual CPU devices;
together they form an 8-device global mesh over localhost.

Run: python multihost_worker.py <process_id> <num_processes> <port>
Prints 'WORKER_OK <pid>' on success; any assertion failure exits nonzero.
"""

import os
import sys

# must precede first backend use
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4"
                           ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402


def main() -> None:
    pid = int(sys.argv[1])
    nproc = int(sys.argv[2])
    port = sys.argv[3]

    from mixmogam_tpu.parallel.multihost import (
        host_snp_range, initialize_multihost, make_global_snp_array)

    initialize_multihost(coordinator_address=f"localhost:{port}",
                         num_processes=nproc, process_id=pid)
    assert jax.process_count() == nproc, jax.process_count()
    assert len(jax.devices()) == 4 * nproc, len(jax.devices())

    from mixmogam_tpu.data.simulate import simulate_genotypes, simulate_phenotype
    from mixmogam_tpu.parallel.distributed import (
        distributed_emmax, distributed_kinship)
    from mixmogam_tpu.parallel.mesh import make_mesh, replicated

    n, M = 64, 256
    G, ch, po = simulate_genotypes(n, M, seed=33)  # (M, n), deterministic
    Gf = G.astype(np.float64)
    y, _ = simulate_phenotype(G, h2=0.5, n_causal=4, seed=33)

    mesh = make_mesh()  # (8, 1) over both processes

    # ---- 1) kinship psum across processes vs host oracle ----
    from mixmogam_tpu.ops.kinship import kinship as host_kinship

    Kd = distributed_kinship(Gf, mesh=mesh, method="vanraden")
    Kh = host_kinship(G, method="vanraden", use_device=False)
    np.testing.assert_allclose(Kd, Kh, atol=1e-10)

    # ---- 2) per-host loading: each process assembles the global array
    # from ONLY its own row block ----
    lo, hi = host_snp_range(M, nproc, pid, tile=M // (4 * nproc))
    arr = make_global_snp_array(Gf[lo:hi], M, mesh)
    assert arr.shape == (M, n)
    gathered = jax.jit(lambda x: x, out_shardings=replicated(mesh))(arr)
    np.testing.assert_array_equal(np.asarray(gathered), Gf)

    # ---- 3) distributed EMMAX across 2 processes vs single-device ----
    from mixmogam_tpu.models.emmax import emmax

    K = Kh / np.diag(Kh).mean()
    d = distributed_emmax(Gf, y, K=K, mesh=mesh)
    ref = emmax(Gf, y, K=K, stream=False)
    np.testing.assert_allclose(d["ps"], ref["ps"], atol=1e-9)
    np.testing.assert_array_equal(d["mask"], ref["mask"])
    assert abs(d["delta"] - ref["delta"]) < 1e-9

    # ---- 4) the full train step (kinship psum + vmapped REML + sharded
    # multi-trait scan + device top-k) across processes ----
    from mixmogam_tpu.parallel.distributed import distributed_train_step

    Y = np.stack([y, np.roll(y, 3)])
    out = distributed_train_step(mesh, Gf.astype(np.float32), Y, top_k=4)
    assert out["top_f"].shape == (2, 4)
    assert np.isfinite(out["top_f"]).all()

    # ---- 5) SNP-sharded 2-bit resident genome across processes
    # (round 3: shard_map over packed shards, replicated result) ----
    from mixmogam_tpu.models.resident import ResidentGenome
    from mixmogam_tpu.parallel.distributed import distributed_emmax_resident

    rg = ResidentGenome.from_source(G, tile=16)
    dr = distributed_emmax_resident(rg, y, K=K, mesh=mesh)
    np.testing.assert_allclose(dr["ps"], ref["ps"], atol=1e-9)

    # ---- 6) SAMPLE-sharded packed scan across processes (round 5):
    # byte axis over 'sample', W row-sharded, int32-psum'd digit planes
    # — on a (4, 2) mesh spanning both processes ----
    mesh2 = make_mesh((4, 2))
    dt2 = distributed_emmax_resident(rg, y, K=K, mesh=mesh2)
    np.testing.assert_allclose(dt2["ps"], ref["ps"], atol=1e-9)
    dt2i = distributed_emmax_resident(rg, y, K=K, mesh=mesh2,
                                      rotate_in_bf16="int8x3")
    ref_i = emmax(G, y, K=K, stream=False, precision="int8x3")
    np.testing.assert_allclose(dt2i["ps"], ref_i["ps"], atol=1e-9)

    # ---- 7) round-5 continuation: the NEW mesh entry points gather
    # their sharded outputs across processes (multitrait incl. a
    # missing-Y pattern group, EMMA exact, and the A.6 class tests) ----
    from mixmogam_tpu.models.emma import emma
    from mixmogam_tpu.models.linear import (anova, kruskal_wallis,
                                            linear_model)
    from mixmogam_tpu.models.multitrait import emmax_multi_trait

    Ym = np.stack([y, np.roll(y, 5)])
    Ym[1, :7] = np.nan
    mt = emmax_multi_trait(Gf, Ym, K=K, mesh=mesh)
    mt_ref = emmax_multi_trait(Gf, Ym, K=K)
    np.testing.assert_allclose(mt["ps"], mt_ref["ps"], atol=1e-9)
    em = emma(Gf, y, K=K, tile=32, mesh=mesh)
    em_ref = emma(Gf, y, K=K, tile=32)
    np.testing.assert_allclose(em["ps"], em_ref["ps"], atol=1e-9)
    Gm = G.copy()
    Gm[::7, ::5] = -1
    for fn in (linear_model, anova, kruskal_wallis):
        r = fn(Gm, y, mesh=mesh)
        r_ref = fn(Gm, y)
        np.testing.assert_allclose(r["ps"], r_ref["ps"], atol=1e-9,
                                   err_msg=fn.__name__)
    # GxE gathers its sharded outputs across processes too (review
    # r5-cont: the one sharded scan that never gathered)
    from mixmogam_tpu.models.gxe import emmax_gxe

    rng2 = np.random.default_rng(44)
    env = (rng2.random(n) < 0.5).astype(np.float64)
    gx = emmax_gxe(Gf, y, env, K=K, mesh=mesh)
    gx_ref = emmax_gxe(Gf, y, env, K=K)
    np.testing.assert_allclose(gx["inter_ps"], gx_ref["inter_ps"],
                               atol=1e-9)

    print(f"WORKER_OK {pid}", flush=True)


if __name__ == "__main__":
    main()
