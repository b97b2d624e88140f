"""Runnable end-to-end examples (reference: examples.py, SURVEY.md L8).

The reference ships Arabidopsis data we cannot redistribute; these examples
simulate a structured cohort of the same shape and drive every major
analysis through the facade API. Run:

    PYTHONPATH=.. python examples.py [example_name ...]

Examples write outputs under ./example_out/.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

OUT = os.path.join(os.path.dirname(__file__), "example_out")
os.makedirs(OUT, exist_ok=True)


def _simulate_files(n=300, m=5000, h2=0.6, n_causal=5, seed=17,
                    missing_rate=0.01, tag="sim"):
    """Write a simulated genotype/phenotype pair (like the bundled
    at_data/ of the reference)."""
    from mixmogam_tpu.data.genotype import GenotypeData
    from mixmogam_tpu.data.phenotype import PhenotypeData
    from mixmogam_tpu.data.simulate import (simulate_genotypes,
                                            simulate_phenotype)

    gfile = os.path.join(OUT, f"{tag}.genotypes.csv")
    pfile = os.path.join(OUT, f"{tag}.phenotypes.csv")
    if not (os.path.exists(gfile) and os.path.exists(pfile)):
        G, ch, po = simulate_genotypes(n, m, missing_rate=missing_rate,
                                       seed=seed)
        gd = GenotypeData(G, ch, po, [f"acc{i}" for i in range(n)])
        y, causal = simulate_phenotype(G, h2=h2, n_causal=n_causal,
                                       causal_effect=1.0, seed=seed)
        gd.write_csv(gfile)
        PhenotypeData.from_arrays(1, "flowering_time", gd.accessions,
                                  y).write_to_file(pfile)
        np.savetxt(os.path.join(OUT, f"{tag}.causal.txt"), causal,
                   fmt="%d")
    return gfile, pfile


def example_emmax():
    """Standard single-trait EMMAX mixed-model GWAS with plots."""
    from mixmogam_tpu.api import run_gwas

    g, p = _simulate_files()
    out = run_gwas(g, p, method="emmax", min_mac=5,
                   out_prefix=os.path.join(OUT, "emmax"),
                   cache_dir=os.path.join(OUT, "cache"))
    top = out["result"].get_top_snps(5)
    print("EMMAX pseudo-heritability:",
          round(out["scan"]["pseudo_heritability"], 3))
    print("top-5 positions:", list(top.positions))
    print("files:", out["files"])


def example_precision_tiers():
    """Opt-in fast scan tiers (GPU; runs fine on CPU too): the int8x3
    digit-plane tier gives fp32-grade p-values from exact int8 GEMMs;
    int8x2/bf16 trade more accuracy for speed. The
    int8 tiers require fully-observed (integer) genotypes — on
    mean-imputed data they refuse rather than silently round."""
    from mixmogam_tpu.api import run_gwas

    # fully-observed cohort: int8 tiers apply
    g, p = _simulate_files(missing_rate=0.0, tag="sim_complete")
    exact = run_gwas(g, p, method="emmax", min_mac=5,
                     cache_dir=os.path.join(OUT, "cache"))
    fast = run_gwas(g, p, method="emmax", min_mac=5,
                    cache_dir=os.path.join(OUT, "cache"),
                    rotate_in_bf16="int8x3")
    dp = float(np.max(np.abs(exact["scan"]["ps"] - fast["scan"]["ps"])))
    print(f"int8x3 vs exact: max |dp| = {dp:.2e} (expect ~1e-6)")

    # imputed cohort: the guard refuses the int8 tier
    g2, p2 = _simulate_files()
    try:
        run_gwas(g2, p2, method="emmax", min_mac=5,
                 rotate_in_bf16="int8x3")
    except ValueError as e:
        print("imputed dosages correctly refused:", str(e)[:60], "...")


def example_linear_model():
    """OLS scan (no kinship) — shows population-structure inflation on the
    QQ plot compared to EMMAX."""
    from mixmogam_tpu.api import run_gwas

    g, p = _simulate_files()
    out = run_gwas(g, p, method="lm", min_mac=5,
                   out_prefix=os.path.join(OUT, "lm"))
    print("LM min p:", out["scan"]["ps"].min())


def example_transformations():
    """Phenotype transformations incl. Shapiro-driven most-normal pick."""
    from mixmogam_tpu.api import parse_phenotype_file

    _, p = _simulate_files()
    phend = parse_phenotype_file(p)
    phend.convert_to_averages()
    best = phend.most_normal_transformation(1)
    print("most-normal transformation:", best,
          "W =", round(phend.shapiro_wilk(1), 4))
    phend.plot_histogram(1, os.path.join(OUT, "phen_hist.png"))


def example_stepwise():
    """Stepwise MLMM (forward/backward, eBIC/mBIC/mbonf selection)."""
    from mixmogam_tpu.api import (calc_ibs_kinship, emmax_step_wise,
                                  parse_phenotype_file, parse_snp_data)

    g, p = _simulate_files()
    gd = parse_snp_data(g)
    phend = parse_phenotype_file(p)
    gd2, y, _ = gd.coordinate_with_phenotype(phend, 1)
    gd2 = gd2.filter_mac_snps(5)
    K = calc_ibs_kinship(gd2)
    sw = emmax_step_wise(gd2, y, K=K, max_steps=4)
    for s in sw["steps"]:
        print(f"  {s['phase']:8s} cof={s['cofactors']} "
              f"h2={s['pseudo_heritability']:.3f} ebic={s['ebic']:.1f}")
    print("selected:", {k: v["cofactors"]
                        for k, v in sw["selected"].items()})


def example_multi_trait():
    """50 phenotypes sharing one eigenbasis (BASELINE config #4 shape)."""
    from mixmogam_tpu.api import calc_ibs_kinship, emmax_multi_trait, parse_snp_data

    g, _ = _simulate_files()
    gd = parse_snp_data(g).filter_mac_snps(5)
    rng = np.random.default_rng(0)
    Y = rng.normal(size=(50, gd.num_samples))
    K = calc_ibs_kinship(gd)
    mt = emmax_multi_trait(gd, Y, K=K)
    print("per-trait h2 range:",
          round(mt["pseudo_heritabilities"].min(), 3), "-",
          round(mt["pseudo_heritabilities"].max(), 3))
    print("ps shape:", mt["ps"].shape)


def example_permutation():
    """Empirical genome-wide threshold via permutation."""
    from mixmogam_tpu.api import (calc_ibs_kinship, emmax_perm_test,
                                  parse_phenotype_file, parse_snp_data)

    g, p = _simulate_files()
    gd = parse_snp_data(g)
    phend = parse_phenotype_file(p)
    gd2, y, _ = gd.coordinate_with_phenotype(phend, 1)
    gd2 = gd2.filter_mac_snps(5)
    K = calc_ibs_kinship(gd2)
    r = emmax_perm_test(gd2, y, K=K, num_perm=50)
    print(f"5% empirical threshold over {r['num_perm']} perms:",
          f"{r['threshold']:.2e}")


def example_reference_classes():
    """The reference's class-based workflow, unchanged (compat layer):
    LinearMixedModel + add_random_effect + get_expedited_REMLE +
    emmax_f_test — mixmogam scripts port line-for-line."""
    from mixmogam_tpu.api import (calc_ibs_kinship, parse_phenotype_file,
                                  parse_snp_data)
    from mixmogam_tpu.compat import LinearMixedModel

    g, p = _simulate_files()
    gd = parse_snp_data(g)
    phend = parse_phenotype_file(p)
    gd2, y, _ = gd.coordinate_w_phenotype_data(phend, 1)
    gd2 = gd2.filter_mac_snps(5)
    K = calc_ibs_kinship(gd2)

    lmm = LinearMixedModel(y)
    lmm.add_random_effect(K)
    reml = lmm.get_expedited_REMLE()
    print("REML: h2 =", round(reml["pseudo_heritability"], 3),
          "delta =", round(reml["delta"], 4))
    res = lmm.emmax_f_test(gd2.get_snps())
    print("min p =", f"{res['ps'].min():.2e}")


def example_streaming_at_scale():
    """Round-2 scale features on a small cohort: (a) emmax streams SNP
    tiles from host with checkpoint/resume when the device budget is
    exceeded (here forced), (b) a fast int8 tier with exact rescoring of
    the top hits, (c) per-trait missing phenotypes in the multi-trait
    batch (grouped by missingness pattern, exact)."""
    import numpy as np

    from mixmogam_tpu.data.parsers import parse_snp_data
    from mixmogam_tpu.models import emmax
    from mixmogam_tpu.models.multitrait import emmax_multi_trait
    from mixmogam_tpu.oracle.kinship import scale_k
    from mixmogam_tpu.ops.kinship import kinship

    g, p = _simulate_files(missing_rate=0.0, tag="scale")
    gd = parse_snp_data(g)
    K = scale_k(kinship(gd))
    rng = np.random.default_rng(0)
    y = rng.normal(size=gd.num_samples) + gd.matrix[7].astype(float)

    # (a) force streamed mode + checkpointing (auto-triggers at ~4 GiB)
    ck = os.path.join(OUT, "scale_ck")
    st = emmax(gd, y, K=K, stream=True, checkpoint_dir=ck)
    print("streamed scan min p:", f"{st['ps'].min():.2e}",
          "(resume manifest in", ck + ")")

    # (b) fast int8x2 tier + exact rescore: the reported hits' p-values
    # are exact-grade, the genome-wide pass ran at fast-tier cost
    fast = emmax(gd, y, K=K, precision="int8x2", rescore_top=50)
    ex = emmax(gd, y, K=K)
    idx = fast["rescored_idx"]
    print(f"rescored {len(idx)} hits; max |p - exact| on them:",
          f"{np.abs(fast['ps'][idx] - ex['ps'][idx]).max():.2e}")

    # (c) multi-trait with per-trait missing phenotypes
    Y = np.stack([y, y + rng.normal(size=len(y))])
    Y[1, rng.random(len(y)) < 0.2] = np.nan
    mt = emmax_multi_trait(gd, Y, K=K)
    print("multi-trait dofs (per-trait sample subsets):", mt["dof"])


def example_resident_genome():
    """Round-3: the device-resident 2-bit genome. Pack the cohort once
    into (device) memory and run the whole study off it — repeated
    scans, kinship, stepwise — with zero per-scan host traffic. At the
    1M x 10,240 flagship scale the packed genome is 2.7 GB."""
    import numpy as np

    from mixmogam_tpu.data.parsers import parse_snp_data
    from mixmogam_tpu.models import emmax
    from mixmogam_tpu.models.resident import ResidentGenome
    from mixmogam_tpu.models.stepwise import emmax_step_wise
    from mixmogam_tpu.ops.kinship import kinship
    from mixmogam_tpu.oracle.kinship import scale_k

    g, p = _simulate_files(missing_rate=0.0, tag="resident")
    gd = parse_snp_data(g)
    rng = np.random.default_rng(0)
    y = rng.normal(size=gd.num_samples) + gd.matrix[7].astype(float)

    rg = ResidentGenome.from_source(gd)       # one upload
    K = scale_k(kinship(rg))                  # kinship from device memory
    res = emmax(rg, y, K=K)                   # scan from device memory
    print("resident scan min p:", f"{res['ps'].min():.2e}",
          f"(packed {rg.nbytes_packed/1e6:.1f} MB for "
          f"{rg.M}x{rg.n} genotypes)")
    sw = emmax_step_wise(rg, y, K=K, max_steps=2)
    print("stepwise over the same container:",
          sw["selected"]["mbonf"]["cofactors"])


def example_plink_and_clumping():
    """Round-3: PLINK .bed/.bim/.fam in, LD-clumped hits out. The bed
    payload is already the package's 2-bit layout, so
    resident_from_plink uploads it to device memory without decoding."""
    import numpy as np

    from mixmogam_tpu.data.genotype import GenotypeData
    from mixmogam_tpu.data.plink import (read_plink, resident_from_plink,
                                         write_plink)
    from mixmogam_tpu.models.resident import emmax_resident
    from mixmogam_tpu.ops.kinship import kinship
    from mixmogam_tpu.oracle.kinship import scale_k
    from mixmogam_tpu.results import Result

    rng = np.random.default_rng(2)
    G = rng.integers(0, 3, (2000, 150)).astype(np.int8)
    G[101] = np.clip(G[100] + (rng.random(150) < 0.05), 0, 2)  # LD proxy
    gd = GenotypeData(G, np.repeat([1, 2], 1000),
                      np.tile(np.arange(1000) * 500, 2),
                      [f"iid{i}" for i in range(150)], ploidy=2)
    prefix = os.path.join(OUT, "cohort")
    write_plink(prefix, gd)                       # export a fileset

    gd2 = read_plink(prefix)                      # ...and read it back
    y = gd2.matrix[100].astype(float) + rng.normal(size=150) * 0.8
    rg, chroms, poss, ids = resident_from_plink(prefix)  # zero-decode
    K = scale_k(kinship(rg))
    res = emmax_resident(rg, y, K=K)
    r = Result.from_scan(res, chroms, poss)
    clumps = r.clump(rg, p_threshold=1e-5, window_bp=5000)
    print("clumps (lead <- members):",
          [(c["lead"], c["members"]) for c in clumps[:3]])


def example_loco():
    """Round-3: leave-one-chromosome-out association. Per-chromosome
    kinships recombine from ONE extra pass (additive gram identity);
    each chromosome is scanned under the null that excludes it."""
    import numpy as np

    from mixmogam_tpu.data.simulate import (simulate_genotypes,
                                            simulate_phenotype)
    from mixmogam_tpu.models import emmax, emmax_loco
    from mixmogam_tpu.ops.kinship import kinship
    from mixmogam_tpu.oracle.kinship import scale_k

    G, ch, po = simulate_genotypes(250, 4000, seed=5)
    y, causal = simulate_phenotype(G, h2=0.6, n_causal=4,
                                   causal_effect=1.2, seed=5)
    res = emmax_loco(G, y, ch, ploidy=1)
    glob = emmax(G, y, K=scale_k(kinship(G, ploidy=1)))
    top = np.argsort(res["ps"])[:6]
    print("LOCO top hits:", sorted(top.tolist()), "causal:",
          sorted(causal.tolist()))
    print("per-chrom h2:", {c: round(v["pseudo_heritability"], 3)
                            for c, v in res["loco"].items()},
          "| global h2:", round(glob["pseudo_heritability"], 3))


def example_vcf_and_gblup():
    """Round-3: VCF in, association + genomic prediction out. gBLUP
    reuses the association machinery's eigenbasis: the same fitted null
    model that whitens the scan IS the breeding-value predictor."""
    import numpy as np

    from mixmogam_tpu.data.genotype import GenotypeData
    from mixmogam_tpu.data.vcf import read_vcf, write_vcf
    from mixmogam_tpu.models.gblup import gblup_cv, gblup_predict
    from mixmogam_tpu.data.simulate import (simulate_genotypes,
                                            simulate_phenotype)

    G, ch, po = simulate_genotypes(200, 2000, seed=8)
    y, _ = simulate_phenotype(G, h2=0.8, n_causal=200, seed=8)
    gd = GenotypeData(G, ch, po, [f"s{i}" for i in range(200)], ploidy=1)
    path = os.path.join(OUT, "cohort.vcf.gz")
    write_vcf(gd, path)                      # export VCF (gzipped)
    gd2 = read_vcf(path)                     # ...and read it back

    cv = gblup_cv(gd2, y, n_folds=5, seed=0)
    print(f"gBLUP 5-fold CV: r = {cv['r']:.3f} (polygenic h2=0.8 trait)")
    train = np.arange(150)
    new = np.arange(150, 200)                # "unphenotyped" candidates
    y_hat, model = gblup_predict(gd2, y, train, new)
    r = np.corrcoef(y_hat, y[new])[0, 1]
    print(f"predicted 50 unphenotyped samples: r = {r:.3f}, "
          f"h2_hat = {model.pseudo_heritability:.2f}")


def example_gxe():
    """Round-3: SNP x environment interaction under the mixed model.
    The environment is forced into the null; the ranked p-values are
    the 1-dof interaction tests (marginal and joint 2-dof alongside)."""
    import numpy as np

    from mixmogam_tpu.data.simulate import (simulate_genotypes,
                                            simulate_phenotype)
    from mixmogam_tpu.models.gxe import emmax_gxe
    from mixmogam_tpu.ops.kinship import kinship
    from mixmogam_tpu.oracle.kinship import scale_k

    G, ch, po = simulate_genotypes(250, 3000, seed=4)
    rng = np.random.default_rng(4)
    env = rng.normal(size=250)                   # e.g. temperature
    y, _ = simulate_phenotype(G, h2=0.5, n_causal=8, seed=4)
    y = y + 1.2 * G[1500].astype(float) * env    # plant a GxE effect
    K = scale_k(kinship(G, ploidy=1))
    res = emmax_gxe(G, y, env, K=K)
    j = int(np.argmin(res["inter_ps"]))
    print(f"top GxE hit: SNP {j} (planted 1500), "
          f"p_inter = {res['inter_ps'][j]:.2e}, "
          f"p_marginal = {res['marginal_ps'][j]:.2e}, "
          f"p_joint = {res['joint_ps'][j]:.2e}")


def example_multi_env_gxe():
    """Round-4: multi-environment GxE batch. env is (n, E); the
    genotype rotation is computed once per tile and shared across
    environments (E+1 matmuls instead of 2E), each environment gets
    its own exact null fit. Precision tiers apply to BOTH rotations
    (the environment folds into the weight side of the matmul)."""
    import numpy as np

    from mixmogam_tpu.data.simulate import (simulate_genotypes,
                                            simulate_phenotype)
    from mixmogam_tpu.models.gxe import emmax_gxe
    from mixmogam_tpu.ops.kinship import kinship
    from mixmogam_tpu.oracle.kinship import scale_k

    G, ch, po = simulate_genotypes(250, 3000, seed=9)
    rng = np.random.default_rng(9)
    envs = np.column_stack([rng.normal(size=250),          # temperature
                            (rng.random(250) > 0.5) * 1.0,  # site A/B
                            rng.normal(size=250)])          # rainfall
    y, _ = simulate_phenotype(G, h2=0.5, n_causal=8, seed=9)
    # plant a site-dependent QTL on a common SNP
    mafs = G.mean(axis=1)
    j_qtl = int(np.argmin(np.abs(mafs - 0.5)))
    y = y + 1.6 * G[j_qtl].astype(float) * envs[:, 1]
    K = scale_k(kinship(G, ploidy=1))
    res = emmax_gxe(G, y, envs, K=K)
    print(f"inter_ps shape (E, M) = {res['inter_ps'].shape}; "
          f"per-env deltas = {np.round(res['deltas'], 3)}")
    for e in range(3):
        j = int(np.argmin(res["inter_ps"][e]))
        print(f"  env {e}: top GxE SNP {j} "
              f"p = {res['inter_ps'][e][j]:.2e}"
              + ("  <- the planted site QTL" if j == j_qtl else ""))


def example_many_phenotypes_missing():
    """Round-4: a reference-style many-phenotype study (107-phenotype
    pattern) with per-trait MISSING phenotype coverage, batched over
    one device-resident genome. Traits are grouped by missingness
    pattern; each group gathers its sample columns ON DEVICE from the
    packed 2-bit rows — no host decode, exact per-group eigenbases."""
    import numpy as np

    from mixmogam_tpu.data.simulate import (simulate_genotypes,
                                            simulate_phenotype)
    from mixmogam_tpu.models.multitrait import emmax_multi_trait
    from mixmogam_tpu.models.resident import ResidentGenome
    from mixmogam_tpu.ops.kinship import kinship
    from mixmogam_tpu.oracle.kinship import scale_k

    n, m, T = 200, 2000, 12
    G, ch, po = simulate_genotypes(n, m, seed=12)
    rng = np.random.default_rng(12)
    Y = np.stack([simulate_phenotype(G, h2=0.5, n_causal=5,
                                     seed=12 + t)[0] for t in range(T)])
    # three field seasons -> three missingness patterns over the traits
    Y[0:4, :30] = np.nan
    Y[4:8, 150:] = np.nan
    K = scale_k(kinship(G, ploidy=1))
    rg = ResidentGenome.from_source(G)       # one upload
    res = emmax_multi_trait(rg, Y, K=K)
    n_pat = len({tuple(np.isnan(Y[t])) for t in range(T)})
    print(f"{T} traits, {n_pat} missingness patterns, genome resident "
          f"2-bit in HBM; ps shape = {res['ps'].shape}")
    n_sig = int((np.min(res["ps"], axis=1) < 0.05 / m).sum())
    print(f"{n_sig}/{T} traits carry a Bonferroni-significant hit")


def example_cohort_vcf_packed():
    """Round-4: cohort-scale VCF -> device-resident container without
    ever materializing the (M, n) int8 matrix (RAM ~ M*n/4): the
    streaming C++ parser (plain/gzip/bgzip) feeds the 2-bit packer
    chunk by chunk. Also: read_vcf(field='DS') for imputed dosages."""
    import numpy as np

    from mixmogam_tpu.data.genotype import GenotypeData
    from mixmogam_tpu.data.simulate import (simulate_genotypes,
                                            simulate_phenotype)
    from mixmogam_tpu.data.vcf import read_vcf, read_vcf_packed, write_vcf
    from mixmogam_tpu.models.emmax import emmax
    from mixmogam_tpu.ops.kinship import kinship
    from mixmogam_tpu.oracle.kinship import scale_k

    G, ch, po = simulate_genotypes(150, 3000, seed=21)
    y, causal = simulate_phenotype(G, h2=0.6, n_causal=4, seed=21)
    gd = GenotypeData(G, ch, po, [f"s{i}" for i in range(150)], ploidy=1)
    path = os.path.join(OUT, "cohort_big.vcf.gz")
    write_vcf(gd, path)

    rg, meta = read_vcf_packed(path, tile=1024)  # streaming -> HBM
    print(f"packed container: {rg.shape}, "
          f"{rg.nbytes_packed / 1e3:.0f} KB packed "
          f"(int8 would be {rg.M * rg.n / 1e3:.0f} KB)")
    K = scale_k(kinship(rg))
    res = emmax(rg, y, K=K)
    top = np.argsort(res["ps"])[:6]
    hits = len(set(po[causal]) & set(meta["positions"][top]))
    print(f"EMMAX off the VCF-packed container: {hits}/4 causal in "
          f"top 6")

    # DS (imputed dosage) read: fractional dosages -> float container
    ds_path = os.path.join(OUT, "dosages.vcf")
    with open(ds_path, "w") as f:
        f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL"
                "\tFILTER\tINFO\tFORMAT\t"
                + "\t".join(f"s{i}" for i in range(4)) + "\n")
        f.write("1\t100\t.\tA\tG\t.\t.\t.\tDS\t0.12\t1.40\t1.96\t.\n")
    dd = read_vcf(ds_path, field="DS")
    print(f"DS read -> {type(dd).__name__}, dosages {dd.matrix[0]} "
          "(NaN = missing; routed to the non-int8 tiers)")


def example_mesh_campaign():
    """Round 5: the whole campaign surface runs mesh-sharded via mesh=
    kwargs on the real entry points — stepwise MLMM, LOCO, GxE and the
    permutation sweep (SNP-sharded scans, replicated nulls, one gather).
    Uses however many devices this process sees (the test suite runs it
    on 8 virtual CPU devices; on a pod slice the same code spans chips)."""
    import jax

    from mixmogam_tpu.data.simulate import (simulate_genotypes,
                                            simulate_phenotype)
    from mixmogam_tpu.models.gxe import emmax_gxe
    from mixmogam_tpu.models.loco import emmax_loco
    from mixmogam_tpu.models.permutation import emmax_perm_test
    from mixmogam_tpu.models.stepwise import emmax_step_wise
    from mixmogam_tpu.oracle import ibs_kinship, scale_k
    from mixmogam_tpu.parallel.mesh import make_mesh

    devs = jax.devices()
    mesh = make_mesh((len(devs), 1), devices=devs)
    G, ch, po = simulate_genotypes(96, 600, seed=30)
    y, causal = simulate_phenotype(G, h2=0.6, n_causal=3, seed=30)
    K = scale_k(ibs_kinship(G.astype(np.float64)))
    sw = emmax_step_wise(G, y, K=K, max_steps=3, mesh=mesh)
    print(f"mesh {dict(mesh.shape)}: stepwise selected "
          f"{sw['selected']['ebic']['cofactors']} (causal: "
          f"{sorted(causal)})")
    lc = emmax_loco(G, y, chromosomes=ch, ploidy=1, mesh=mesh)
    print(f"LOCO min p {np.min(lc['ps']):.2e} over "
          f"{len(lc['loco'])} chromosomes")
    rng = np.random.default_rng(1)
    env = (rng.random(96) < 0.5).astype(np.float64)
    gx = emmax_gxe(G, y, env, K=K, mesh=mesh)
    pm = emmax_perm_test(G, y, K=K, num_perm=16, seed=2, mesh=mesh)
    print(f"GxE min interaction p {np.min(gx['inter_ps']):.2e}; "
          f"permutation threshold {pm['threshold']:.2e}")
    # round-5 continuation: multi-trait (with a missing-Y pattern),
    # EMMA exact and the class tests shard through the same kwarg
    from mixmogam_tpu.models.emma import emma
    from mixmogam_tpu.models.linear import kruskal_wallis
    from mixmogam_tpu.models.multitrait import emmax_multi_trait

    Y = np.stack([y, y * 0.5 + rng.normal(size=96)])
    Y[1, :9] = np.nan
    mt = emmax_multi_trait(G, Y, K=K, mesh=mesh)
    em = emma(G, y, K=K, tile=64, mesh=mesh)
    kw = kruskal_wallis(G, y, mesh=mesh)
    print(f"multi-trait min p {np.min(mt['ps']):.2e} (T=2, one trait "
          f"9 samples missing); EMMA exact min p {np.min(em['ps']):.2e}; "
          f"KW min p {np.min(kw['ps']):.2e} — all mesh-sharded")


EXAMPLES = {
    "emmax": example_emmax,
    "mesh_campaign": example_mesh_campaign,
    "multi_env_gxe": example_multi_env_gxe,
    "many_phenotypes_missing": example_many_phenotypes_missing,
    "cohort_vcf_packed": example_cohort_vcf_packed,
    "loco": example_loco,
    "vcf_and_gblup": example_vcf_and_gblup,
    "gxe": example_gxe,
    "streaming_at_scale": example_streaming_at_scale,
    "resident_genome": example_resident_genome,
    "plink_and_clumping": example_plink_and_clumping,
    "precision_tiers": example_precision_tiers,
    "lm": example_linear_model,
    "transforms": example_transformations,
    "stepwise": example_stepwise,
    "multitrait": example_multi_trait,
    "permutation": example_permutation,
    "reference_classes": example_reference_classes,
}


if __name__ == "__main__":
    names = sys.argv[1:] or list(EXAMPLES)
    for name in names:
        print(f"=== {name} ===")
        EXAMPLES[name]()
