"""Benchmark driver hook: prints ONE JSON line
{"metric": ..., "value": N, "unit": ..., "vs_baseline": N}.

Headline metric (BASELINE.json): SNP-tests/sec/chip for the EMMAX scan
at n = 10,240 samples, measured on the fp32-grade tier (exact or
int8x3, whichever is faster). The genome is DEVICE-RESIDENT 2-bit
packed (models/resident.py), so the scan is ONE dispatch off device
memory. The REML eigh wall-time at n=10k (the other BASELINE metric) is
measured and logged when not cached.

The baseline is the reference's estimated Python-loop throughput of
~1e4 SNP-tests/s on one CPU core (BASELINE.md; the repo publishes no
numbers).

Needs a GPU: without one it exits non-zero. Artifacts cache under
~/.cache/mixmogam_bench (the 10k x 1M campaign genome, kinship,
eigendecomposition) and are rebuilt when absent."""

import json
import os
import sys
import time

import numpy as np

CACHE = os.path.expanduser("~/.cache/mixmogam_bench")
N = 10_240          # BASELINE-defined sample count
M_FALLBACK = 65_536  # SNPs when the 1M campaign cache is absent


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def get_data():
    """(G int8 host source (M, N) fully observed, y, K or None)."""
    big_g = os.path.join(CACHE, "simbig_10240x1048576.npy")
    big_y = os.path.join(CACHE, "simbig_10240x1048576_y.npz")
    if os.path.exists(big_g) and os.path.exists(big_y):
        G = np.load(big_g, mmap_mode="r")
        with np.load(big_y) as z:
            y = z["y"]
        log(f"using 10k x 1M campaign cache ({G.shape[0]:,} SNPs)")
        return G, y
    os.makedirs(CACHE, exist_ok=True)
    cache = os.path.join(CACHE, f"sim_{N}x{M_FALLBACK}.npz")
    if os.path.exists(cache):
        with np.load(cache) as z:
            return z["G"], z["y"]
    from mixmogam_tpu.data.simulate import simulate_genotypes, simulate_phenotype

    t0 = time.time()
    G, _, _ = simulate_genotypes(N, M_FALLBACK, seed=0)
    y, _ = simulate_phenotype(G, h2=0.5, n_causal=20, seed=0)
    log(f"simulate {M_FALLBACK}x{N}: {time.time()-t0:.0f}s")
    np.savez(cache, G=G, y=y)
    return G, y


def main():
    import subprocess

    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {dev.platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    log(f"card: {card.strip()}; device_kind {dev.device_kind}; "
        f"devices {len(jax.devices())}")

    G, y = get_data()
    M = G.shape[0]

    from mixmogam_tpu.models.resident import (ResidentGenome,
                                              emmax_scan_packed,
                                              kinship_resident)
    from mixmogam_tpu.oracle.kinship import scale_k

    t0 = time.time()
    # trust_cache: the bench owns both the source memmap and the packed
    # cache; content-hash validation would re-read the 10.7 GB source
    # every run (the exact cost the cache exists to avoid)
    rg = ResidentGenome.from_source(
        G, cache_path=os.path.join(CACHE, f"packed_{N}x{M}.bin"),
        trust_cache=True)
    log(f"pack+upload {rg.nbytes_packed/1e9:.2f} GB packed "
        f"({M:,} x {N}): {time.time()-t0:.1f}s (one-time; packed rows "
        "disk-cached)")

    kpath = os.path.join(CACHE, f"K_{N}x{M}.npy")
    if os.path.exists(kpath):
        K = np.load(kpath)
        log("kinship from cache")
    else:
        t0 = time.time()
        K = scale_k(kinship_resident(rg))
        log(f"kinship (device-resident int8 GEMM): {time.time()-t0:.1f}s "
            f"= {M/(time.time()-t0):,.0f} SNPs/s")
        np.save(kpath, K)

    # ---- BASELINE metric: REML eigh wall-time at n=10k (host) ----
    epath = os.path.join(CACHE, f"eig_{N}x{M}.npz")
    if os.path.exists(epath):
        with np.load(epath) as z:
            phi, U = z["phi"], z["U"]
        log("eigendecomposition from cache")
    else:
        from mixmogam_tpu.ops.eigen import eigen_k

        t0 = time.time()
        phi, U = eigen_k(K.astype(np.float32), host=True)
        phi, U = np.asarray(phi), np.asarray(U)
        log(f"REML eigh wall-time (host numpy dsyevd, n={N}): "
            f"{time.time()-t0:.1f}s")
        np.savez(epath, phi=phi, U=U)

    from mixmogam_tpu.ops.reml import fit_null_model
    from mixmogam_tpu.ops.scan import build_rotated_null

    t0 = time.time()
    null = fit_null_model(y.astype(np.float32), np.ones((N, 1), np.float32),
                          eig_k=(phi, U))
    log(f"REML null fit (X-explicit, f64 host): {time.time()-t0:.1f}s "
        f"delta={float(null.delta):.4g} "
        f"h2={float(null.pseudo_heritability):.3f}")

    from mixmogam_tpu.models.resident import subdivide_tile

    def rate(rd, label, repeats=2):
        # tier-dependent granularity, the same routing as emmax_resident
        scan_tile = (rg.tile if rd is None
                     else subdivide_tile(rg.tile, 8192))
        rot = build_rotated_null(null, rotate_dtype=rd)
        jax.block_until_ready(emmax_scan_packed(
            rg.packed, rot, rg.n, scan_tile)["f_stats"])  # compile
        best = np.inf
        for _ in range(repeats):
            t0 = time.time()
            jax.block_until_ready(emmax_scan_packed(
                rg.packed, rot, rg.n, scan_tile)["f_stats"])
            best = min(best, time.time() - t0)
        r = M / best
        fl = 2 * M * N * N / best
        log(f"scan {label}: {best:.2f}s FULL {M:,} from HBM -> "
            f"{r:,.0f} SNP-tests/s/chip (n={N}; {fl/1e12:.0f} eff. TFLOP/s)")
        return r

    r_exact = rate(None, "exact fp32")
    r_x3 = rate("int8x3", "int8x3 (fp32-grade)")
    r_x2 = rate("int8x2", "int8x2 (+ exact rescore of top "
                "hits = exact-grade reported p-values)")
    r_b16 = rate(jnp.bfloat16, "bf16 1-pass")

    headline = max(r_exact, r_x3)
    # headline `value` counts fp32-grade tiers only (exact and int8x3);
    # the `tiers` dict records every accuracy contract: exact-grade
    # REPORTED p-values ship at the int8x2+rescore rate
    # (precision='fast'), bf16 is the exploratory ceiling
    baseline = 1.0e4
    result = json.dumps({
        "metric": "emmax_scan_tests_per_s_chip_n10k",
        "value": round(headline),
        "unit": "SNP-tests/s",
        "vs_baseline": round(headline / baseline, 2),
        "tiers": {
            "fp32_grade": round(headline),
            "exact_grade_reported_int8x2_rescore": round(r_x2),
            "bf16": round(r_b16),
            "exact_fp32": round(r_exact),
        },
    })
    print(result, flush=True)


if __name__ == "__main__":
    main()
