"""Drive the EMMAX main path once on a GPU and check what comes out.

    python3 chip_smoke.py [--seed S]        # one card: phases A and B
    python3 chip_smoke.py --devices 4       # four cards: phase C only

Phase A  BASELINE config #1 (200 samples x 10,000 diploid SNPs) through
         the CLI (`simulate`, then `run --method emmax`), in float32 and
         float64, checked against the float64 oracle.
Phase B  the flagship width (10,240 samples x 65,536 binary SNPs) in
         float32: integer-exact kinship, host and device eigh, the
         resident packed EMMAX scan at every precision tier, the exact
         tier against the oracle and every fast tier against its
         TIER_P_DRIFT bound. Prints each stage's wall time, the scan
         rates and what the int8 dots lowered to.
Phase C  phase B's genome on ('snp', 'sample') meshes of (4, 1) and
         (2, 2) against the one-card result, then the campaign phases
         of __graft_entry__.run_mesh_phases on the four cards.

Every line but the last is a report. The last line is one JSON object
naming the device; it is printed only when every check held. Without a
GPU the script exits non-zero before doing any work. A failed check
raises, so the exit code is non-zero and no result line is printed.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np

# the f32 envelope of the exact tier (tests/test_kernels.py
# TestFp32Characterization): -log10 p within 0.05, same top-10 set
LOGP_TOL = 0.05
H2_TOL = 1e-4
F64_P_TOL = 1e-6


def log(*a):
    print(*a, flush=True)


def require_gpu(count: int):
    """The visible devices when the first is a GPU and there are at least
    `count`; otherwise exit non-zero (there is no CPU fallback)."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU (JAX found {devs[0].platform!r})")
    if len(devs) < count:
        sys.exit(f"chip_smoke: needs {count} GPUs, found {len(devs)}")
    return devs[:count]


def report_card(devs):
    import jax

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    for line in card.strip().splitlines():
        log(f"card: {line.strip()}")
    import mixmogam_tpu.ops  # noqa: F401  (compile cache, matmul pin)
    from mixmogam_tpu import native

    stats = devs[0].memory_stats() or {}
    log(f"jax {jax.__version__}; device_kind {devs[0].device_kind}; "
        f"bytes_limit {stats.get('bytes_limit')}; devices {len(devs)}; "
        f"compile cache {jax.config.jax_compilation_cache_dir}; native "
        f"C++ data plane {'built' if native.get_lib() else 'absent'}")


def _logp(p):
    return -np.log10(np.maximum(np.asarray(p, np.float64), 1e-300))


def check_f32_envelope(name, p32, p_ref, h2_32=None, h2_ref=None,
                       top: int = 10):
    """Raise unless p32 is inside the f32 envelope around p_ref."""
    d = float(np.max(np.abs(_logp(p32) - _logp(p_ref))))
    same_top = (set(np.argsort(p32, kind="stable")[:top])
                == set(np.argsort(p_ref, kind="stable")[:top]))
    msg = f"{name}: max|d -log10 p| {d:.3e}, top-{top} same {same_top}"
    if h2_32 is not None:
        dh = abs(h2_32 - h2_ref)
        msg += f", |d h2| {dh:.3e}"
        if dh >= H2_TOL:
            raise AssertionError(msg)
    log(msg)
    if d >= LOGP_TOL or not same_top:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# phase A: BASELINE config #1 through the CLI
# ---------------------------------------------------------------------------

def _read_pvals(path):
    """[((chromosome, position), p)] from a ranked pvals CSV."""
    with open(path) as f:
        header = f.readline().strip().split(",")
        rows = [line.split(",") for line in f.read().splitlines() if line]
    ic, ip, isc = (header.index(k)
                   for k in ("chromosomes", "positions", "scores"))
    return [((int(r[ic]), int(r[ip])), float(r[isc])) for r in rows]


def _cli_run(prefix, out):
    from mixmogam_tpu.cli import main

    t0 = time.perf_counter()
    rc = main(["run", f"{prefix}.genotypes.csv", f"{prefix}.phenotypes.csv",
               "--method", "emmax", "--no-plots", "-o", out])
    if rc != 0:
        raise RuntimeError(f"mixmogam-tpu run exited {rc}")
    wall = time.perf_counter() - t0
    with open(f"{out}.summary.json") as f:
        summary = json.load(f)
    return _read_pvals(f"{out}.pvals.csv"), summary, wall


def phase_a(workdir: str, seed: int, n: int = 200, m: int = 10_000):
    import jax

    from mixmogam_tpu import oracle
    from mixmogam_tpu.cli import main
    from mixmogam_tpu.data.parsers import parse_snp_data
    from mixmogam_tpu.data.phenotype import PhenotypeData

    prefix = os.path.join(workdir, "cfg1")
    if main(["simulate", "-n", str(n), "-m", str(m), "--ploidy", "2",
             "--seed", str(seed), "-o", prefix]) != 0:
        raise RuntimeError("mixmogam-tpu simulate failed")

    jax.config.update("jax_enable_x64", False)
    p32, s32, w32 = _cli_run(prefix, os.path.join(workdir, "f32"))
    jax.config.update("jax_enable_x64", True)
    try:
        p64, s64, w64 = _cli_run(prefix, os.path.join(workdir, "f64"))
    finally:
        jax.config.update("jax_enable_x64", False)
    log(f"phase A: CLI emmax {len(p64)} SNPs x {n} samples: "
        f"f32 {w32:.2f} s, f64 {w64:.2f} s (walls include compilation)")

    # the float64 oracle on the same coordinated, MAC-filtered data
    gd = parse_snp_data(f"{prefix}.genotypes.csv", ploidy=2)
    phend = PhenotypeData.parse_phenotype_file(f"{prefix}.phenotypes.csv")
    gd2, y, _ = gd.coordinate_with_phenotype(phend, 1)
    gd2 = gd2.filter_mac_snps(15)
    Gf = gd2.dosage_f64()
    K = oracle.scale_k(oracle.ibs_kinship(Gf, ploidy=2))
    ref = oracle.emmax_scan(Gf, y, K)
    keys = list(zip(gd2.chromosomes.tolist(), gd2.positions.tolist()))
    count = Counter(keys)
    for rows in (p32, p64):
        if Counter(k for k, _ in rows) != count:
            raise AssertionError("CLI and oracle scanned different SNP sets")
    # the simulator may draw one position twice; such SNPs cannot be told
    # apart in the ranked output, so they are left out of the comparison
    keep = [i for i, k in enumerate(keys) if count[k] == 1]
    p_or = ref["ps"][keep]
    by64, by32 = dict(p64), dict(p32)
    p_64 = np.array([by64[keys[i]] for i in keep])
    p_32 = np.array([by32[keys[i]] for i in keep])
    if len(keep) < len(keys):
        log(f"phase A: {len(keys) - len(keep)} SNPs share a position and "
            f"are left out of the comparison")
    d64 = float(np.max(np.abs(p_64 - p_or)))
    log(f"phase A: f64 max|dp| vs oracle {d64:.3e} (limit {F64_P_TOL:g}); "
        f"h2 device {s64['pseudo_heritability']:.6f} "
        f"oracle {ref['pseudo_heritability']:.6f}")
    if d64 > F64_P_TOL:
        raise AssertionError(f"phase A f64 parity {d64:.3e}")
    check_f32_envelope("phase A: f32 vs f64", p_32, p_64,
                       s32["pseudo_heritability"],
                       s64["pseudo_heritability"])


# ---------------------------------------------------------------------------
# phase B: the flagship width
# ---------------------------------------------------------------------------

#: fast tiers whose drift against the exact tier is held to TIER_P_DRIFT
FAST_TIERS = ("int8x3", "int8x2", "bf16", "high", "bf16x2", "bf16x3",
              "bf16x2c", "bf16x3c", "int8x4")


def simulate_flagship(n: int, m: int, seed: int):
    from mixmogam_tpu.data.simulate import (simulate_genotypes,
                                            simulate_phenotype)

    t0 = time.perf_counter()
    G, _, _ = simulate_genotypes(n, m, ploidy=1, seed=seed)
    y, _ = simulate_phenotype(G, h2=0.5, n_causal=20, seed=seed)
    log(f"simulate {m} x {n} binary int8: {time.perf_counter() - t0:.2f} s")
    return G, y


def _timed(fn, *a, **kw):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*a, **kw))
    return out, time.perf_counter() - t0


def dot_lowering(compiled_text: str, limit: int = 4):
    """What the dots of an optimized HLO module became: the library
    calls (custom-call targets) and the fusions that hold a dot."""
    import re

    targets = sorted(set(re.findall(r'custom_call_target="([^"]+)"',
                                    compiled_text)))
    lines = [ln.strip()[:220] for ln in compiled_text.splitlines()
             if ("s8[" in ln and ("custom-call" in ln or " dot(" in ln))]
    return targets, lines[:limit]


def gram_forms(C_host, reps: int):
    """Time one streamed kinship chunk's gram in the int8 form the
    package uses and in bf16 with float32 accumulation (exact for 0/1/2
    dosages at this chunk size), and name what each lowered to."""
    import jax
    import jax.numpy as jnp

    from mixmogam_tpu.ops.kinship import _INT8_PREC

    dims = (((0,), (0,)), ((), ()))
    m, n = C_host.shape
    C = jnp.asarray(C_host)
    forms = {
        "int8 -> int32": jax.jit(lambda c: jax.lax.dot_general(
            c, c, dims, preferred_element_type=jnp.int32,
            precision=_INT8_PREC)),
        "bf16 -> float32": jax.jit(lambda c: jax.lax.dot_general(
            c.astype(jnp.bfloat16), c.astype(jnp.bfloat16), dims,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.DEFAULT)),
    }
    for name, f in forms.items():
        _timed(f, C)
        best = min(_timed(f, C)[1] for _ in range(reps))
        targets, lines = dot_lowering(f.lower(C).compile().as_text())
        log(f"gram {name} ({m} x {n}): {best * 1e3:.3f} ms = "
            f"{2 * m * n * n / best / 1e12:.1f} TOP/s; custom calls "
            f"{targets}")
        for ln in lines:
            log(f"  gram {name} HLO: {ln}")


def check_kinship_exact(G, m_sub: int):
    """The API's IBS kinship of the first m_sub SNPs, element for element,
    against an integer gram built on the host."""
    from mixmogam_tpu import api

    sub = np.ascontiguousarray(G[:m_sub])
    Ks = api.calc_ibs_kinship(sub, scale=False)
    C = sub.astype(np.float32)        # 0/1 counts <= m_sub < 2**24: exact
    CtC = (C.T @ C).astype(np.int64)
    s = sub.sum(axis=0, dtype=np.int64)
    S = 2 * CtC - s[:, None] - s[None, :] + m_sub   # IBS sharing counts
    exact = np.array_equal(Ks, S / m_sub)
    log(f"kinship integer-exact on {m_sub} SNPs: {exact}")
    if not exact:
        bad = int(np.sum(Ks != S / m_sub))
        raise AssertionError(f"kinship differs from the integer gram in "
                             f"{bad} entries")


def oracle_rotated_ps(G_sub, y, phi, U, delta):
    """Oracle p-values of the rows G_sub for the null (phi, U, delta):
    the GLS F-test (oracle.gls_f_test) in the eigenbasis, where
    H^-1/2 = U diag(1/sqrt(phi + delta)) U' reduces to diag(sd) U'."""
    from mixmogam_tpu import oracle

    phi = np.asarray(phi, np.float64)
    U = np.asarray(U, np.float64)
    sd = 1.0 / np.sqrt(phi + delta)
    y_star = sd * (U.T @ np.asarray(y, np.float64))
    X0_star = (sd * U.sum(axis=0))[:, None]     # U' @ 1
    Xs = (np.asarray(G_sub, np.float64) @ U) * sd[None, :]
    return np.array([oracle.gls_f_test(y_star, X0_star, x)["p"]
                     for x in Xs])


def phase_b(seed: int, n: int = 10_240, m: int = 65_536,
            m_kin: int = 4_096, m_oracle: int = 2_048, reps: int = 3):
    import jax

    from mixmogam_tpu import api
    from mixmogam_tpu.models.resident import (ResidentGenome,
                                              emmax_scan_packed,
                                              subdivide_tile)
    from mixmogam_tpu.ops.eigen import eigen_k
    from mixmogam_tpu.ops.reml import fit_null_model
    from mixmogam_tpu.ops.scan import (TIER_P_DRIFT, build_rotated_null,
                                       normalize_rotate_tier,
                                       resolve_precision)

    G, y = simulate_flagship(n, m, seed)
    y32 = y.astype(np.float32)

    # ---- kinship ----
    K, t_kin = _timed(api.calc_ibs_kinship, G)
    log(f"kinship (api.calc_ibs_kinship, {m} SNPs): {t_kin:.3f} s "
        f"= {m / t_kin:,.0f} SNPs/s")
    gram_forms(G[:2048], reps)
    check_kinship_exact(G, m_kin)

    # ---- eigh: host LAPACK (float64) vs device (cuSOLVER, float32) ----
    K32 = K.astype(np.float32)
    eig_host, t_host = _timed(eigen_k, K32, host=True)
    log(f"eigh host (float64 LAPACK, n={n}): {t_host:.2f} s")
    dev_walls = []
    for _ in range(2):
        eig_dev, t = _timed(eigen_k, K32, host=False)
        dev_walls.append(t)
    phi_h = np.asarray(eig_host[0], np.float64)
    dphi = float(np.max(np.abs(np.asarray(eig_dev[0], np.float64) - phi_h))
                 / np.max(np.abs(phi_h)))
    log(f"eigh device (float32, n={n}): "
        + " ".join(f"{t:.2f}" for t in dev_walls)
        + f" s (first includes compilation); max|d phi|/max phi {dphi:.3e}")
    phi, U = eig_host           # the default (ops.eigen: host=True)

    # ---- null fit ----
    X0 = np.ones((n, 1), np.float32)
    null, t_null = _timed(fit_null_model, y32, X0, eig_k=(phi, U))
    delta = float(null.delta)
    log(f"null fit (X-explicit REML, eig given): {t_null:.2f} s, "
        f"delta {delta:.6g}, h2 {float(null.pseudo_heritability):.6f}")

    # ---- resident packed scan through the API, every tier ----
    rg, t_up = _timed(ResidentGenome.from_source, G)
    log(f"pack + upload {rg.nbytes_packed / 1e6:.1f} MB packed: "
        f"{t_up:.2f} s")
    res = {}
    for tier in ("exact", "auto", "fast") + FAST_TIERS:
        t0 = time.perf_counter()
        res[tier] = api.emmax(rg, y, K=K, eig_k=(phi, U), precision=tier)
        log(f"emmax precision={tier!r} -> {res[tier]['precision_tier']}: "
            f"{time.perf_counter() - t0:.2f} s (with compilation)")
    ex = res["exact"]
    if not (np.isfinite(ex["ps"]).all() and ex["ps"].shape == (m,)):
        raise AssertionError("exact-tier p-values malformed")
    dev = api.emmax(rg, y, K=K, eig_k=eig_dev, precision="exact")
    log(f"exact tier with the device eigh instead: max|dp| "
        f"{np.max(np.abs(dev['ps'] - ex['ps'])):.3e}, max|d -log10 p| "
        f"{np.max(np.abs(_logp(dev['ps']) - _logp(ex['ps']))):.3e}, "
        f"h2 {dev['pseudo_heritability']:.6f} vs "
        f"{ex['pseudo_heritability']:.6f}")

    # ---- scan kernel alone: steady-state rate per tier ----
    scan_lines = {}
    for tier in ("exact",) + FAST_TIERS:
        rb, mp, _ = resolve_precision(tier)
        rd = normalize_rotate_tier(rb)
        rot = build_rotated_null(null, rotate_dtype=rd)
        tile = rg.tile if rd is None and not mp else subdivide_tile(
            rg.tile, 8192)
        ctx = (jax.default_matmul_precision(mp) if mp
               else contextlib.nullcontext())
        with ctx:
            run = lambda: emmax_scan_packed(rg.packed, rot, rg.n, tile)
            _timed(run)
            best = min(_timed(run)[1] for _ in range(reps))
            if tier in ("exact", "int8x3"):
                text = emmax_scan_packed.lower(
                    rg.packed, rot, rg.n, tile).compile().as_text()
                scan_lines[tier] = dot_lowering(text)
        log(f"scan kernel {tier}: {best * 1e3:.2f} ms for {m} SNPs = "
            f"{m / best:,.0f} SNP-tests/s "
            f"({2 * m * n * n / best / 1e12:.1f} effective TFLOP/s)")
    for tier, (targets, lines) in scan_lines.items():
        log(f"scan {tier} lowered to custom calls {targets}")
        for ln in lines:
            log(f"  scan {tier} HLO: {ln}")

    # ---- fast tiers against the exact tier, then the exact tier against
    # the float64 oracle on a subset (checked last, after every number
    # is printed) ----
    failed = []
    for tier in FAST_TIERS:
        d = float(np.max(np.abs(res[tier]["ps"] - ex["ps"])))
        bound = TIER_P_DRIFT[tier]
        log(f"drift {tier}: max|dp| vs exact {d:.3e} (bound {bound:.1e})")
        if d > bound:
            failed.append(tier)
    t0 = time.perf_counter()
    p_or = oracle_rotated_ps(G[:m_oracle], y, phi, U, delta)
    log(f"oracle on {m_oracle} SNPs: {time.perf_counter() - t0:.2f} s")
    check_f32_envelope(f"phase B: exact tier vs oracle ({m_oracle} SNPs)",
                       ex["ps"][:m_oracle], p_or)
    if failed:
        raise AssertionError(f"tiers over their TIER_P_DRIFT bound: {failed}")


# ---------------------------------------------------------------------------
# phase C: four cards
# ---------------------------------------------------------------------------

MESH_TIERS = ("exact", "int8x3", "int8x2")
#: exact float32 on a sample-sharded mesh against one card: twice the
#: reading on the (2, 2) mesh (4.59e-6, PERF.md), rounded up to one digit
MESH_F32_P_TOL = 1e-5


def _mesh_parity(devs, rg, y, K, eig, tier, x64: bool):
    """emmax on one card and on ('snp', 'sample') meshes of (4, 1) and
    (2, 2): the int8 tiers must agree bit for bit (their partial
    rotations reduce as int32); the exact tier to 1e-6 in float64. In
    float32 the exact tier's sample-sharded psum reassociates float
    sums, so it is held to MESH_F32_P_TOL and the f32 envelope."""
    from mixmogam_tpu import api
    from mixmogam_tpu.parallel.mesh import make_mesh

    name = f"{tier} ({'float64' if x64 else 'float32'})"
    t0 = time.perf_counter()
    one = api.emmax(rg, y, K=K, eig_k=eig, precision=tier)
    log(f"one card {name}: {time.perf_counter() - t0:.2f} s")
    for shape in ((4, 1), (2, 2)):
        mesh = make_mesh(shape, devices=devs)
        t0 = time.perf_counter()
        out = api.emmax(rg, y, K=K, eig_k=eig, precision=tier, mesh=mesh)
        wall = time.perf_counter() - t0
        d = float(np.max(np.abs(out["ps"] - one["ps"])))
        same = bool(np.array_equal(out["ps"], one["ps"]))
        log(f"mesh {shape} {name}: {wall:.2f} s, max|dp| vs one card "
            f"{d:.3e}, bit-identical {same}")
        if tier != "exact" and not same:
            raise AssertionError(f"mesh {shape} {name} not bit-identical")
        if tier == "exact" and d > (F64_P_TOL if x64 else MESH_F32_P_TOL):
            raise AssertionError(f"mesh {shape} {name} delta {d:.3e}")
        if tier == "exact" and not x64:
            check_f32_envelope(f"mesh {shape} {name} vs one card",
                               out["ps"], one["ps"])


def phase_c(devs, seed: int, n: int = 10_240, m: int = 65_536):
    import jax

    from mixmogam_tpu import api
    from mixmogam_tpu.models.resident import ResidentGenome
    from mixmogam_tpu.ops.eigen import eigen_k

    from __graft_entry__ import run_mesh_phases

    G, y = simulate_flagship(n, m, seed)
    K, t = _timed(api.calc_ibs_kinship, G)
    log(f"kinship: {t:.2f} s")
    rg = ResidentGenome.from_source(G)
    eig, t = _timed(eigen_k, K.astype(np.float32), host=False)
    log(f"eigh (device, float32): {t:.2f} s")
    for tier in MESH_TIERS:
        _mesh_parity(devs, rg, y, K, eig, tier, x64=False)
    jax.config.update("jax_enable_x64", True)
    try:
        eig64, t = _timed(eigen_k, K, host=False)
        log(f"eigh (device, float64): {t:.2f} s")
        _mesh_parity(devs, rg, y, K, eig64, "exact", x64=True)
    finally:
        jax.config.update("jax_enable_x64", False)
    deltas = run_mesh_phases(devs)
    log("campaign phases on 4 cards, parity deltas: "
        + ", ".join(f"{k}={v:.2e}" for k, v in deltas.items()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--devices", type=int, default=1, choices=[1, 4],
                    help="4 runs the four-card mesh phase (C) only")
    args = ap.parse_args(argv)
    devs = require_gpu(args.devices)
    report_card(devs)
    t0 = time.perf_counter()
    if args.devices == 4:
        phase_c(devs, args.seed)
    else:
        with tempfile.TemporaryDirectory() as workdir:
            phase_a(workdir, args.seed)
        phase_b(args.seed)
    log(f"chip_smoke wall {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
