"""Facade API (reference: mixmogam.py — SURVEY.md L7: convenience functions
gluing parse -> coordinate -> kinship -> scan -> results/plots).

The reference's names are kept (emmax, emma, emmax_step_wise,
calc_ibs_kinship, ...) so a mixmogam user finds everything in one place;
each delegates to the device models layer."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np

from mixmogam_tpu.data.genotype import GenotypeData
from mixmogam_tpu.data.parsers import parse_snp_data
from mixmogam_tpu.data.phenotype import PhenotypeData
from mixmogam_tpu.models.emmax import emmax, emmax_anova
from mixmogam_tpu.models.emma import emma
from mixmogam_tpu.models.linear import linear_model, anova, kruskal_wallis
from mixmogam_tpu.models.stepwise import emmax_step_wise
from mixmogam_tpu.models.multitrait import emmax_multi_trait
from mixmogam_tpu.models.permutation import emmax_perm_test
from mixmogam_tpu.models.twosnp import emmax_two_snps
from mixmogam_tpu.results.result import Result
from mixmogam_tpu.results.mtcorr import (
    bonferroni_threshold, get_bh_thres, get_bhy_thres,
)
from mixmogam_tpu.utils.caching import (
    cached_kinship, save_kinship_to_file, load_kinship_from_file,
)

__all__ = [
    "parse_snp_data", "parse_phenotype_file", "calc_ibs_kinship",
    "calc_ibd_kinship", "emmax", "emma", "emmax_step_wise", "emmax_anova",
    "emmax_multi_trait", "emmax_perm_test", "emmax_two_snps",
    "linear_model", "anova", "kruskal_wallis", "run_gwas", "run_gwas_multi",
    "save_kinship_to_file", "load_kinship_from_file",
]


def parse_phenotype_file(path: str, delimiter: str = ",") -> PhenotypeData:
    return PhenotypeData.parse_phenotype_file(path, delimiter=delimiter)


def _calc_kinship(gd_or_snps, method: str, use_device: bool,
                  cache_dir: Optional[str], scale: bool) -> np.ndarray:
    if isinstance(gd_or_snps, GenotypeData):
        return cached_kinship(gd_or_snps, method, cache_dir=cache_dir,
                              use_device=use_device, scale=scale)
    from mixmogam_tpu.ops import kinship as dk
    from mixmogam_tpu.oracle.kinship import scale_k

    K = dk.kinship(np.asarray(gd_or_snps), method=method,
                   use_device=use_device)
    return scale_k(K) if scale else K


def calc_ibs_kinship(gd_or_snps, use_device: bool = True,
                     cache_dir: Optional[str] = None,
                     scale: bool = True) -> np.ndarray:
    """IBS kinship (reference: mixmogam.calculate_ibs_kinship)."""
    return _calc_kinship(gd_or_snps, "ibs", use_device, cache_dir, scale)


def calc_ibd_kinship(gd_or_snps, use_device: bool = True,
                     cache_dir: Optional[str] = None,
                     scale: bool = True) -> np.ndarray:
    """VanRaden/'IBD' kinship (reference: calc_ibd_kinship)."""
    return _calc_kinship(gd_or_snps, "vanraden", use_device, cache_dir,
                         scale)


def run_gwas(genotype_file: str, phenotype_file: str, pid: int = 1,
             method: str = "emmax", out_prefix: Optional[str] = None,
             data_format: str = "binary", transform: Optional[str] = None,
             min_mac: int = 15, kinship_method: str = "ibs",
             kinship_file: Optional[str] = None,
             cache_dir: Optional[str] = None, plots: bool = True,
             num_steps: int = 10, dtype=None,
             profile_dir: Optional[str] = None,
             covariate_pids: Optional[Sequence[int]] = None,
             env_pid: Optional[int] = None,
             ploidy: Optional[int] = None,
             config: Optional["GwasConfig"] = None, **model_kw) -> Dict:
    """End-to-end GWAS (reference: examples.py flow, SURVEY.md §3.1):
    parse -> transform -> coordinate -> MAC filter -> kinship (cached) ->
    scan -> ranked CSV + Manhattan/QQ plots + JSON run summary.

    method: 'emmax' | 'emma' | 'lm' | 'anova' | 'kw' | 'emmax_stepwise'
            | 'emmax_loco' (LOCO builds per-chromosome kinships itself)
            | 'emmax_gxe' (SNP x environment interaction; env_pid names
            the phenotype column holding the environment — its ranked
            p-values are the INTERACTION tests, with marginal/joint
            p-values alongside in the scan dict).
    transform: None | 'log' | 'sqrt' | 'box_cox' | 'exp' | 'arcsin_sqrt'
               | 'most_normal'.
    model_kw['X0'] (a user-supplied fixed-effects design) must have its
    rows in the COORDINATED sample order — the genotype/phenotype
    intersection order established by coordinate_with_phenotype (the
    order of the emitted result's samples). When covariate_pids/env_pid
    drop further samples, X0 rows are subset by position; only the row
    COUNT is verifiable, so a same-sized design in a different sample
    order would be silently misaligned.
    Returns {'result': Result, 'scan': scan dict, 'files': {...}}.
    """
    from mixmogam_tpu.config import GwasConfig, DEFAULT
    from mixmogam_tpu.utils.profiling import RunMetrics, device_trace

    cfg = config or DEFAULT
    if method in ("emmax", "emma", "emmax_stepwise", "emmax_loco",
                  "emmax_gxe"):
        # REML defaults from config (mirror the reference's numeric
        # defaults; explicit model_kw wins)
        for k, v in (("ngrids", cfg.reml.ngrids), ("llim", cfg.reml.llim),
                     ("ulim", cfg.reml.ulim), ("esp", cfg.reml.esp)):
            model_kw.setdefault(k, v)
    if method in ("emmax", "emma", "emmax_stepwise", "lm"):
        model_kw.setdefault("tile", cfg.tiles.scan_snp_tile)

    rm = RunMetrics(run_name=f"{method}_pid{pid}")
    with rm.phase("parse"):
        # ploidy: None infers 2 iff any dosage exceeds 1 — pass 2
        # explicitly for diploid data with no homozygous-alt calls
        # (e.g. an F1 cross), which the heuristic would call haploid
        gd = parse_snp_data(genotype_file, data_format=data_format,
                            ploidy=ploidy)
        phend = parse_phenotype_file(phenotype_file)

    if transform == "most_normal":
        phend.most_normal_transformation(pid)
    elif transform:
        phend.transform(pid, transform)

    with rm.phase("coordinate"):
        gd2, y, sample_ids = gd.coordinate_with_phenotype(phend, pid)
        cov_maps = []
        if covariate_pids:
            if method not in ("emmax", "emma", "lm", "emmax_stepwise",
                              "emmax_loco", "emmax_gxe"):
                # the class tests (anova/kw) have no covariate design —
                # refuse rather than silently run an unadjusted scan
                raise ValueError(
                    f"covariate_pids is not supported by method "
                    f"{method!r} (anova/kw are covariate-free class "
                    "tests); use emmax/emma/lm/emmax_stepwise")
            cov_maps = [phend.value_dict(c) for c in covariate_pids]
        env_map = None
        if method == "emmax_gxe":
            if env_pid is None:
                raise ValueError(
                    "method='emmax_gxe' needs env_pid (the phenotype "
                    "column holding the per-sample environment)")
            env_map = phend.value_dict(env_pid)
        # ONE coordinated sample drop across covariates AND environment —
        # subsetting after X0 is built would leave a stale-row design in
        # model_kw (ADVICE r3: covariates + incomplete env coverage made
        # emmax_gxe unusable)
        req_maps = cov_maps + ([env_map] if env_map is not None else [])
        if req_maps:
            keep = [i for i, a in enumerate(sample_ids)
                    if all(a in m for m in req_maps)]
            if len(keep) < len(sample_ids):
                gd2 = gd2.select_samples(keep).filter_monomorphic_snps()
                y = y[keep]
                if "X0" in model_kw and np.shape(
                        model_kw["X0"])[0] == len(sample_ids):
                    # a user-supplied design built on the pre-drop
                    # coordinated set: keep its rows aligned.
                    # CONTRACT (ADVICE r4): X0's rows must be in the
                    # COORDINATED sample order (the genotype/phenotype
                    # intersection order — what run_gwas callers get
                    # from coordinate_with_phenotype); the row-count
                    # match is all that can be verified here, a
                    # same-sized design in a different order would be
                    # silently mis-subset. Documented on run_gwas.
                    model_kw["X0"] = np.asarray(model_kw["X0"])[keep]
                sample_ids = [sample_ids[i] for i in keep]
        if cov_maps:
            cov_cols = [np.array([np.mean(m[a])
                                  for a in sample_ids])[:, None]
                        for m in cov_maps]
            if "X0" in model_kw:
                # a user design + covariate_pids COMPOSE: append the
                # covariate columns (review r5-cont: setdefault let the
                # user X0 win and silently dropped the requested
                # covariates — an unadjusted scan with no warning)
                X0u = np.asarray(model_kw["X0"], dtype=np.float64)
                if X0u.ndim == 1:
                    X0u = X0u[:, None]
                if X0u.shape[0] != len(sample_ids):
                    raise ValueError(
                        f"model_kw['X0'] has {X0u.shape[0]} rows but "
                        f"{len(sample_ids)} coordinated samples remain")
                model_kw["X0"] = np.hstack([X0u] + cov_cols)
            else:
                model_kw["X0"] = np.hstack(
                    [np.ones((len(sample_ids), 1))] + cov_cols)
        env = None
        if env_map is not None:
            env = np.array([np.mean(env_map[a]) for a in sample_ids])
        if min_mac:
            gd2 = gd2.filter_mac_snps(min_mac)

    scan: Dict = {}
    K = None
    if method in ("emmax", "emma", "emmax_stepwise", "emmax_gxe"):
        with rm.phase("kinship"):
            if kinship_file and os.path.exists(kinship_file):
                K, acc = load_kinship_from_file(kinship_file)
                from mixmogam_tpu.oracle.kinship import prepare_k

                K = prepare_k(K, acc, gd2.accessions)
            else:
                K = cached_kinship(gd2, kinship_method, cache_dir=cache_dir)
        rm.throughput("kinship_snps_per_s", gd2.num_snps, "kinship")

    with rm.phase("scan"), device_trace(profile_dir):
        if method == "emmax":
            scan = emmax(gd2, y, K=K, dtype=dtype, **model_kw)
        elif method == "emma":
            scan = emma(gd2, y, K=K, dtype=dtype, **model_kw)
        elif method == "lm":
            scan = linear_model(gd2, y, dtype=dtype, **model_kw)
        elif method == "anova":
            scan = anova(gd2, y, **model_kw)
        elif method == "kw":
            scan = kruskal_wallis(gd2, y, **model_kw)
        elif method == "emmax_stepwise":
            sw = emmax_step_wise(gd2, y, K=K, max_steps=num_steps,
                                 dtype=dtype, save_scans=False, **model_kw)
            scan = {"stepwise": sw, "ps": None}
        elif method == "emmax_gxe":
            from mixmogam_tpu.models.gxe import emmax_gxe

            model_kw.pop("esp", None)  # fixed-iteration bisection
            scan = emmax_gxe(gd2, y, env, K=K, dtype=dtype, **model_kw)
            # ranked output = the interaction tests (the scan's point)
            scan["ps"] = scan["inter_ps"]
        elif method == "emmax_loco":
            # LOCO builds its own per-chromosome kinships (global K
            # would be wasted work and scale_k breaks gram additivity)
            from mixmogam_tpu.models.loco import emmax_loco

            # the kinship cache_dir doubles as the LOCO eigen cache
            # (per-chromosome (phi, U) keyed on content — a repeated
            # campaign resumes scan-bound)
            model_kw.setdefault("cache_dir", cache_dir)
            scan = emmax_loco(gd2, y, method=kinship_method,
                              dtype=dtype, **model_kw)
        else:
            raise ValueError(f"unknown method {method!r}")
    rm.throughput("scan_snp_tests_per_s", gd2.num_snps, "scan")
    timings = dict(rm.phases)

    files = {}
    result = None
    if scan.get("ps") is not None:
        result = Result.from_scan(scan, gd2.chromosomes, gd2.positions,
                                  mafs=gd2.get_mafs(), macs=gd2.get_macs())
        if out_prefix:
            csv = f"{out_prefix}.pvals.csv"
            result.write_to_file(csv)
            files["pvals"] = csv
            if plots:
                from mixmogam_tpu.plotting import manhattan_plot, qq_plot

                man = f"{out_prefix}.manhattan.png"
                qq = f"{out_prefix}.qq.png"
                manhattan_plot(result, man,
                               threshold=bonferroni_threshold(len(result)))
                qq_plot(scan["ps"], qq)
                files.update(manhattan=man, qq=qq)
    timings["total"] = time.time() - rm._t0

    if out_prefix:
        rm.set("n_samples", gd2.num_samples)
        rm.set("n_snps", gd2.num_snps)
        rm.write(f"{out_prefix}.metrics.json")
        files["metrics"] = f"{out_prefix}.metrics.json"
        summary = {
            "method": method, "pid": pid,
            "n_samples": gd2.num_samples, "n_snps": gd2.num_snps,
            "timings_s": {k: round(v, 3) for k, v in timings.items()},
        }
        for k in ("pseudo_heritability", "delta", "sigma_g2", "sigma_e2"):
            if k in scan:
                summary[k] = scan[k]
        if scan.get("ps") is not None:
            summary["min_p"] = float(np.min(scan["ps"]))
            summary["bonferroni"] = bonferroni_threshold(gd2.num_snps)
            summary["bh_thres"] = get_bh_thres(scan["ps"])
            summary["bhy_thres"] = get_bhy_thres(scan["ps"])
        sj = f"{out_prefix}.summary.json"
        with open(sj, "w") as f:
            json.dump(summary, f, indent=2, default=float)
        files["summary"] = sj

    return {"result": result, "scan": scan, "genotype": gd2, "y": y,
            "files": files, "timings": timings}


def run_gwas_multi(genotype_file: str, phenotype_file: str,
                   pids: Optional[Sequence[int]] = None,
                   out_prefix: Optional[str] = None,
                   batched: bool = False, data_format: str = "binary",
                   min_mac: int = 15, kinship_method: str = "ibs",
                   cache_dir: Optional[str] = None,
                   **kw) -> Dict[int, Dict]:
    """Run a scan for every phenotype id in the file (reference pattern:
    looping the facade over a multi-phenotype file). The kinship cache
    keys on genotype content, so K is computed once across traits that
    share the sample set.

    batched=True runs ONE shared-eigenbasis multi-trait scan instead
    (emmax_multi_trait): genotypes are coordinated once against the
    union of phenotyped samples, per-trait missing phenotypes become
    NaN rows (handled exactly by missingness-pattern grouping), and the
    per-tile rotation is shared by all traits."""
    phend = parse_phenotype_file(phenotype_file)
    # pids=[] means "no phenotypes", not "all" (an empty filter result
    # must not fan out a full GWAS per phenotype in the file)
    pid_list = list(pids if pids is not None else phend.phenotype_ids())
    if not batched:
        out = {}
        for pid in pid_list:
            prefix = f"{out_prefix}.pid{pid}" if out_prefix else None
            out[pid] = run_gwas(genotype_file, phenotype_file, pid=pid,
                                out_prefix=prefix,
                                data_format=data_format, min_mac=min_mac,
                                kinship_method=kinship_method,
                                cache_dir=cache_dir, **kw)
        return out

    # batched=True: accept the same facade kwargs as batched=False and
    # translate them for emmax_multi_trait — flipping the switch on an
    # existing run_gwas_multi call site must not TypeError. Facade-only
    # kwargs are handled here; anything neither handled nor accepted by
    # emmax_multi_trait raises a clear ValueError up front.
    import inspect

    method = kw.pop("method", "emmax")
    if method != "emmax":
        raise ValueError(
            f"batched=True runs one shared-eigenbasis EMMAX scan; "
            f"method={method!r} is only available with batched=False")
    transform = kw.pop("transform", None)
    # same default as run_gwas: plots render per pid when out_prefix is
    # set, so batched=True produces the same artifact set as a loop
    plots = kw.pop("plots", True)
    ploidy = kw.pop("ploidy", None)
    kinship_file = kw.pop("kinship_file", None)
    mt_params = set(inspect.signature(emmax_multi_trait).parameters)
    unknown = sorted(set(kw) - mt_params)
    if unknown:
        raise ValueError(
            f"kwargs {unknown} are not supported with batched=True "
            "(the shared-eigenbasis scan accepts "
            f"{sorted(mt_params - {'G', 'Y', 'K'})}); use batched=False")
    if transform:
        for pid in pid_list:
            if transform == "most_normal":
                phend.most_normal_transformation(pid)
            else:
                phend.transform(pid, transform)
    gd = parse_snp_data(genotype_file, data_format=data_format,
                        ploidy=ploidy)
    maps = {pid: phend.value_dict(pid) for pid in pid_list}
    keep = [i for i, a in enumerate(gd.accessions)
            if any(a in m for m in maps.values())]
    if not keep:
        raise ValueError("no sample overlaps any requested phenotype")
    gd2 = gd.select_samples(keep).filter_monomorphic_snps()
    if min_mac:
        gd2 = gd2.filter_mac_snps(min_mac)
    Y = np.full((len(pid_list), gd2.num_samples), np.nan)
    for t, pid in enumerate(pid_list):
        m = maps[pid]
        for j, a in enumerate(gd2.accessions):
            if a in m:
                Y[t, j] = np.mean(m[a])
    if kinship_file and os.path.exists(kinship_file):
        from mixmogam_tpu.oracle.kinship import prepare_k

        K, acc = load_kinship_from_file(kinship_file)
        K = prepare_k(K, acc, gd2.accessions)
    else:
        K = cached_kinship(gd2, kinship_method, cache_dir=cache_dir)
    mt = emmax_multi_trait(gd2, Y, K=K, **kw)
    out = {}
    dofs = np.broadcast_to(np.asarray(mt["dof"]), (len(pid_list),))
    for t, pid in enumerate(pid_list):
        result = Result(mt["ps"][t], gd2.chromosomes, gd2.positions,
                        mafs=gd2.get_mafs(), macs=gd2.get_macs(),
                        additional={"betas": mt["betas"][t],
                                    "f_stats": mt["f_stats"][t]},
                        score_type="pvals")
        files = {}
        if out_prefix:
            csv = f"{out_prefix}.pid{pid}.pvals.csv"
            result.write_to_file(csv)
            files["pvals"] = csv
            if plots:
                from mixmogam_tpu.plotting import manhattan_plot, qq_plot

                man = f"{out_prefix}.pid{pid}.manhattan.png"
                qq = f"{out_prefix}.pid{pid}.qq.png"
                manhattan_plot(result, man,
                               threshold=bonferroni_threshold(len(result)))
                qq_plot(mt["ps"][t], qq)
                files.update(manhattan=man, qq=qq)
        out[pid] = {
            "result": result, "files": files,
            "scan": {"ps": mt["ps"][t], "f_stats": mt["f_stats"][t],
                     "betas": mt["betas"][t], "mask": mt["mask"][t],
                     "delta": float(mt["deltas"][t]),
                     "pseudo_heritability":
                         float(mt["pseudo_heritabilities"][t]),
                     "dof": int(dofs[t])},
        }
    return out
