"""EMMAX: one REML fit + fully vectorized per-SNP rotated-GLS F-tests
(SURVEY.md A.3, §3.1; reference: linear_models.emmax / emmax_f_test).

Pipeline (device unless noted):
  host   parse/impute -> float tiles
  host   eigh(K)                         [one-time; see ops.eigen]
  host   X-explicit REML (f64 moments)   [ops.reml; no second eigh]
  device scan: tiles of (G @ W) + epilogue  [ops.scan]
  host   float64 p-values from F stats   [ops.stats]
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from mixmogam_tpu.ops.reml import fit_null_model
from mixmogam_tpu.ops.scan import build_rotated_null, emmax_scan_all
from mixmogam_tpu.ops.stats import f_sf_host


def _as_dosage(G, dtype) -> np.ndarray:
    """GenotypeData or array -> (M, n) float array with the normative
    per-SNP mean imputation (int8: -1 = missing; float: NaN = missing)."""
    from mixmogam_tpu.data.genotype import GenotypeData
    from mixmogam_tpu.models.resident import ResidentGenome

    if isinstance(G, ResidentGenome):
        G = G[0:G.M]  # host int8 rows, -1 = missing (imputed below)
    if isinstance(G, GenotypeData):
        return G.dosage_f64().astype(dtype)
    G = np.asarray(G)
    if G.dtype == np.int8:
        if not (G < 0).any():
            return G.astype(dtype)
        Gf = G.astype(np.float64)
        Gf[G < 0] = np.nan
    elif np.issubdtype(G.dtype, np.floating) and np.isnan(G).any():
        Gf = G.astype(np.float64)
    else:
        return G.astype(dtype)
    mu = np.nanmean(Gf, axis=1)
    mu = np.where(np.isnan(mu), 0.0, mu)
    idx = np.where(np.isnan(Gf))
    Gf[idx] = mu[idx[0]]
    return Gf.astype(dtype)


def _as_design(X0, n: int) -> np.ndarray:
    """Normalize a fixed-effects design: 1-D covariates become a column;
    shape is validated against the sample count (np.atleast_2d would turn
    an (n,) covariate into a (1, n) ROW and crash far away)."""
    X0 = np.asarray(X0, dtype=np.float64)
    if X0.ndim == 1:
        X0 = X0[:, None]
    if X0.ndim != 2 or X0.shape[0] != n:
        raise ValueError(f"X0 must be (n_samples={n}, q); got {X0.shape}")
    return X0


#: in-core device footprint (G plus the rotated G @ W), as a fraction of
#: the device memory limit, above which emmax() leaves the in-core path
#: (VERDICT r1 #6; at BASELINE config #3, 1M x 10k, it is 40+ GB): the
#: rest leaves room for the epilogue, donation double-buffers and the
#: n^2 null-model matrices
STREAM_FRACTION = 1 / 4
#: the budget on a backend that reports no memory limit (the CPU)
STREAM_BUDGET_BYTES = 4 << 30


def default_stream_budget() -> int:
    from mixmogam_tpu.models.source import device_budget

    return device_budget(STREAM_FRACTION, STREAM_BUDGET_BYTES)


def emmax(G, y, K=None, X0=None, eig_k: Optional[Tuple] = None,
          ngrids: int = 100, llim: float = -10.0, ulim: float = 10.0,
          esp: float = 1e-6, with_betas: bool = True,
          dtype=None, tile: int = 16_384, host_eigh: bool = True,
          rotate_in_bf16: bool = False, matmul_precision: str = None,
          precision: str = None, stream: Optional[bool] = None,
          stream_budget_bytes: Optional[int] = None,
          checkpoint_dir: Optional[str] = None,
          rescore_top: int = 0,
          resident: Optional[bool] = None,
          mesh=None) -> Dict[str, np.ndarray]:
    """EMMAX scan. G: GenotypeData or (M, n) dosages; y: (n,) phenotype;
    K: (n, n) kinship (or pass eig_k=(phi, U)); X0: (n, q) null design
    (default intercept; append cofactor columns for conditioned scans).

    Returns {'ps','f_stats','betas','var_perc','mask',
             'pseudo_heritability','delta','sigma_g2','sigma_e2','dof'}
    with float64 host p-values. esp (the reference's root tolerance on
    log delta) maps to the bisection iteration count.

    Precision tiers for the SCAN phase (null fit always runs exact):
    default (None) = the package's pinned true-fp32 ('highest'); pass
    matmul_precision='high' for the reduced-precision f32 matmul (TF32
    on a GPU), rotate_in_bf16=True for the 1-pass bf16 tier,
    'x2'/'x3' for split-W bf16 tiers, or 'int8x2'/'int8x3'/'int8x4' for
    int8 digit-plane tiers (integer dosages only). Each tier's measured
    p-drift bound is ops.scan.TIER_P_DRIFT.

    precision: unified tier name ('exact', 'auto', 'fast', 'high',
    'bf16', 'bf16x2', 'bf16x3', 'int8x2', 'int8x3', 'int8x4') that
    supersedes the two legacy kwargs above. 'auto' and 'fast' resolve
    per platform from ops.scan.PRECISION_ROUTES (on a GPU, integer
    dosages go to int8x3 resp. int8x2; exact wherever no route is
    listed). The resolved name is returned as out['precision_tier'].

    stream: None (default) transparently streams SNP tiles from host
    when the scan's device footprint (G + rotated G @ W) would exceed
    stream_budget_bytes — the in-core path would OOM at BASELINE
    config #3 sizes; True/False force. checkpoint_dir enables
    tile-granular resume in streamed mode.

    resident: None (default) auto-promotes big int8 genomes that exceed
    the in-core budget but FIT 2-bit packed in device memory
    (models.resident.default_resident_budget) to a device-resident
    packed container: one upload, then every scan is device compute with
    no host traffic. True forces it, False disables (falls back to
    streaming).

    mesh: a ('snp', 'sample') device mesh routes the scan through the
    sharded paths (parallel.distributed) — a ResidentGenome source (or
    a big int8 source auto-packed HOST-side, never uploaded whole)
    shards its packed rows per chip (incl. sample-TP meshes), anything
    else goes SNP-sharded in-core; same numerics, mesh-shape-invariant
    (tests). Tier names resolve as usual; streaming/checkpoint/rescore
    are single-device features and are rejected with a mesh; `tile` is
    a single-device tuning knob with no effect on the whole-matrix
    sharded dispatch.
    """
    from mixmogam_tpu.ops.reml import esp_to_refine_iters

    y = np.asarray(y, dtype=np.float64).ravel()
    n = y.shape[0]
    if dtype is None:
        dtype = jnp.zeros(0).dtype  # respects jax_enable_x64
    if str(precision) == "fast" and not rescore_top:
        # 'fast' = highest-throughput tier + THRESHOLD-COMPLETE exact
        # rescore (the measured >10M-aggregate configuration): every
        # returned p below the drift-widened Bonferroni cut is re-tested
        # at the exact tier (ops.scan.select_rescore_idx, uncapped);
        # rescore_top is only the floor of that set
        rescore_top = 1024

    # ---- big-M routing: decide BEFORE _as_dosage materializes a full
    # float copy (40 GB at 1M x 10k); lazy sources (np.memmap, h5py
    # datasets) are left unmaterialized for the streamed path ----
    from mixmogam_tpu.models.resident import (ResidentGenome,
                                              emmax_resident,
                                              default_resident_budget)
    from mixmogam_tpu.models.source import resolve_source, should_stream

    if stream_budget_bytes is None:
        stream_budget_bytes = default_stream_budget()

    G_src = resolve_source(G)
    if isinstance(G, ResidentGenome) or isinstance(G_src, ResidentGenome):
        rg = G if isinstance(G, ResidentGenome) else G_src
        resident = True
    else:
        rg = None
    if resident is True and stream is True:
        raise ValueError("stream=True and resident=True are mutually "
                         "exclusive (a resident genome never streams)")
    if mesh is not None:
        # route through the sharded paths (parallel.distributed) —
        # checked BEFORE the single-device auto-promotion so a big host
        # source is packed HOST-side only (upload=False): the sharded
        # path uploads per-chip shards; an eager whole-genome upload to
        # the default device would waste the link and pin HBM on one
        # chip (review r5 #2)
        if str(precision) == "fast":
            # checked FIRST: 'fast' implies rescore_top above, and the
            # rescore message would mask the real cause
            raise ValueError(
                "'fast' pairs a tier with the single-device rescore "
                "pass; pick an explicit tier for mesh scans")
        if stream is True:
            raise ValueError("stream=True is a single-device feature; "
                             "the mesh path shards in-core/packed")
        if checkpoint_dir is not None or rescore_top:
            raise ValueError(
                "checkpoint_dir/rescore_top are single-device features; "
                "drop mesh= or rescore the gathered result")
        if matmul_precision:
            raise ValueError("matmul_precision is not supported on the "
                             "mesh path; use a precision= tier name")
        if rg is None and resident is not False:
            over_incore = should_stream(G_src, n, dtype,
                                        stream_budget_bytes)
            packed_fits = (np.dtype(G_src.dtype) == np.int8
                           and G_src.shape[0] * ((n + 3) // 4)
                           <= default_resident_budget())
            if resident is True or (over_incore and packed_fits):
                rg = ResidentGenome.from_source(G_src, upload=False)
        rb = rotate_in_bf16
        if precision is not None:
            if rotate_in_bf16:
                raise ValueError("pass either precision= or "
                                 "rotate_in_bf16, not both")
            from mixmogam_tpu.ops.scan import (probe_for_source,
                                               resolve_precision)

            rb, mp, _tier = resolve_precision(
                precision, G=probe_for_source(
                    rg, G.matrix if hasattr(G, "matrix")
                    else np.asarray(G)))
            if mp:
                raise ValueError("the 'high' matmul tier is not "
                                 "supported on the mesh path")
        from mixmogam_tpu.parallel.distributed import (
            distributed_emmax, distributed_emmax_resident)

        if rg is not None:
            res = distributed_emmax_resident(
                rg, y, K=K, X0=X0, eig_k=eig_k, mesh=mesh,
                ngrids=ngrids, llim=llim, ulim=ulim, esp=esp,
                dtype=dtype, rotate_in_bf16=rb, host_eigh=host_eigh)
        else:
            res = distributed_emmax(
                G, y, K=K, X0=X0, eig_k=eig_k, mesh=mesh, ngrids=ngrids,
                llim=llim, ulim=ulim, esp=esp, dtype=dtype,
                rotate_in_bf16=rb, host_eigh=host_eigh)
        if not with_betas:
            res.pop("betas", None)
            res.pop("var_perc", None)
        return res
    if rg is None and resident is not False:
        over_incore = should_stream(G_src, n, dtype, stream_budget_bytes)
        packed_fits = (np.dtype(G_src.dtype) == np.int8
                       and G_src.shape[0] * ((n + 3) // 4)
                       <= default_resident_budget())
        import jax as _jx

        if resident is True or (resident is None and over_incore
                                and packed_fits and stream is not True
                                and _jx.default_backend() != "cpu"):
            rg = ResidentGenome.from_source(G_src)
    if rg is not None:
        if checkpoint_dir is not None:
            raise ValueError("checkpoint_dir applies to streamed mode; "
                             "the resident path has no resume (scans "
                             "are single-dispatch device compute)")
        if matmul_precision:
            raise ValueError("matmul_precision is not supported on the "
                             "resident path; use precision='high'")
        return emmax_resident(rg, y, K=K, X0=X0, eig_k=eig_k,
                              ngrids=ngrids, llim=llim, ulim=ulim,
                              esp=esp, with_betas=with_betas, dtype=dtype,
                              precision=precision,
                              rotate_in_bf16=rotate_in_bf16,
                              rescore_top=rescore_top)
    if stream is None:
        stream = should_stream(G_src, n, dtype, stream_budget_bytes)
    if stream:
        from mixmogam_tpu.models.streaming import emmax_streamed

        if matmul_precision:
            # legacy 'high' knob: streamed mode takes the unified name
            raise ValueError(
                "matmul_precision is not supported in streamed mode; "
                "use precision='high'")
        return emmax_streamed(
            G_src, y, K=K, X0=X0, eig_k=eig_k, tile=max(tile, 8192),
            checkpoint_dir=checkpoint_dir, ngrids=ngrids, llim=llim,
            ulim=ulim, esp=esp, dtype=dtype, host_eigh=host_eigh,
            with_betas=with_betas, precision=precision,
            rescore_top=rescore_top,
            rotate_in_bf16=(rotate_in_bf16 if precision is None else False))
    if checkpoint_dir is not None:
        raise ValueError("checkpoint_dir requires streamed mode "
                         "(stream=True or a source over the budget)")
    # int8 fully-observed genotypes ship to the device AS int8 (4x less
    # transfer + HBM; the scan kernel casts tiles on the fly)
    G_raw = G.matrix if hasattr(G, "matrix") else np.asarray(G)
    if (isinstance(G_raw, np.ndarray) and G_raw.dtype == np.int8
            and not (G_raw < 0).any()):
        Gf = G_raw
    else:
        Gf = _as_dosage(G, dtype)
    if X0 is None:
        X0 = np.ones((n, 1))
    X0 = _as_design(X0, n)
    null = fit_null_model(y.astype(dtype), X0.astype(dtype), K=K,
                          eig_k=eig_k, ngrids=ngrids, llim=llim, ulim=ulim,
                          refine_iters=esp_to_refine_iters(
                              esp, ngrids, llim, ulim),
                          host_eigh=host_eigh,
                          eigh_dtype=(np.float32
                                      if str(precision) == "fast"
                                      else None))
    import contextlib

    import jax as _jax

    from mixmogam_tpu.ops.scan import normalize_rotate_tier, resolve_precision

    int8_verified = False
    if precision is not None:
        if rotate_in_bf16 or matmul_precision:
            raise ValueError("pass either precision= or the legacy "
                             "rotate_in_bf16/matmul_precision kwargs, "
                             "not both")
        rotate_in_bf16, matmul_precision, tier_name = resolve_precision(
            precision, G=Gf)
        # 'auto'/'fast' only resolve to an int8 tier after
        # is_integer_dosage passed — don't re-scan the whole matrix below
        int8_verified = (str(precision) in ("auto", "fast")
                         and tier_name.startswith("int8"))
    else:
        tier_name = None
    rd = normalize_rotate_tier(rotate_in_bf16)
    from mixmogam_tpu.ops.scan import is_integer_dosage

    if (isinstance(rd, str) and rd.startswith("int8")
            and not int8_verified and not is_integer_dosage(Gf)):
        raise ValueError(
            f"rotate_in_bf16={rotate_in_bf16!r} requires integer dosages "
            "(the digit-plane matmuls round genotypes to int8; "
            "mean-imputed fractional dosages would be silently altered). "
            "Use the exact/bf16 tiers for imputed float dosages.")
    rot = build_rotated_null(null, rotate_dtype=rd)
    ctx = (_jax.default_matmul_precision(matmul_precision)
           if matmul_precision else contextlib.nullcontext())
    with ctx:
        d = emmax_scan_all(jnp.asarray(Gf), rot, tile=tile)
    # np.array (not asarray): jax outputs are zero-copy READ-ONLY views
    # on CPU and finalize_scan's rescore pass mutates these in place
    from mixmogam_tpu.models.streaming import finalize_scan

    return finalize_scan(
        Gf, null, dtype,
        np.array(d["f_stats"], dtype=np.float64),
        np.array(d["mask"]),
        betas=(np.array(d["betas"], dtype=np.float64)
               if with_betas else None),
        var_perc=(np.array(d["var_perc"], dtype=np.float64)
                  if with_betas else None),
        with_betas=with_betas, rescore_top=rescore_top, rd=rd,
        matmul_precision=matmul_precision, tier_name=tier_name,
        dof=int(rot.dof))


import jax as _jax_mod


@_jax_mod.jit
def _anova_pair_f(A_tile, B_tile, rot):
    """Joint F-test of the two whitened genotype-class indicator
    columns (module-level so repeated emmax_anova calls share ONE
    trace; also the shard_map mesh kernel's tile body)."""
    dt = rot.sd.dtype
    Wt = rot.W
    Aw = jnp.dot(A_tile.astype(Wt.dtype), Wt, preferred_element_type=dt)
    Bw = jnp.dot(B_tile.astype(Wt.dtype), Wt, preferred_element_type=dt)
    Q0 = rot.Q0
    Ar = Aw - (Aw @ Q0) @ Q0.T
    Br = Bw - (Bw @ Q0) @ Q0.T
    eps = 100.0 * jnp.finfo(dt).eps
    tiny = jnp.finfo(dt).tiny
    aa = jnp.sum(Ar * Ar, axis=1)
    maska = aa > eps * jnp.maximum(jnp.sum(Aw * Aw, axis=1), tiny)
    aa_s = jnp.where(maska, aa, 1.0)
    ab = jnp.sum(Ar * Br, axis=1)
    Br2 = Br - (ab / aa_s)[:, None] * Ar
    bb = jnp.sum(Br2 * Br2, axis=1)
    maskb = bb > eps * jnp.maximum(jnp.sum(Bw * Bw, axis=1), tiny)
    bb_s = jnp.where(maskb, bb, 1.0)
    ay = Ar @ rot.y_res
    by = Br2 @ rot.y_res
    expl = (jnp.where(maska, ay * ay / aa_s, 0.0)
            + jnp.where(maskb, by * by / bb_s, 0.0))
    d1 = maska.astype(dt) + maskb.astype(dt)
    mask = d1 > 0
    expl = jnp.minimum(expl, rot.rss0)
    dof2 = jnp.asarray(rot.dof, dt) + 1.0 - d1  # n - q - d1
    rss1 = jnp.maximum(rot.rss0 - expl, tiny)
    f = jnp.where(mask, (expl / jnp.maximum(d1, 1.0))
                  / (rss1 / jnp.maximum(dof2, 1.0)), 0.0)
    return f, d1, dof2, mask


#: jitted mesh programs for the diploid indicator scan, keyed on the
#: trace shape (repeated calls share one trace)
_ANOVA_MESH_CACHE: Dict = {}


def _anova_pair_jit(mesh, tile: int):
    """SNP-sharded diploid indicator scan: lax.map over (tile, n)
    blocks inside each shard bounds the ~6 float intermediates
    _anova_pair_f holds live (whole-shard at once would blow HBM at
    campaign scale — review r5-cont #7)."""
    from jax.sharding import PartitionSpec as P

    import jax

    key = (mesh, tile)
    fn = _ANOVA_MESH_CACHE.get(key)
    if fn is not None:
        return fn
    from mixmogam_tpu.ops.scan import RotatedNull

    def body(A_loc, B_loc, rot):
        nt = A_loc.shape[0] // tile
        At = A_loc.reshape(nt, tile, A_loc.shape[1])
        Bt = B_loc.reshape(nt, tile, B_loc.shape[1])
        f, d1, d2, mk = jax.lax.map(
            lambda ab: _anova_pair_f(ab[0], ab[1], rot), (At, Bt))
        return tuple(v.reshape(nt * tile) for v in (f, d1, d2, mk))

    rot_spec = RotatedNull(W=P(), sd=P(), Q0=P(), y_res=P(), rss0=P(),
                           dof=P(), w_scale=None)
    row = P("snp", None)
    fn = jax.jit(jax.shard_map(body, mesh=mesh,
                               in_specs=(row, row, rot_spec),
                               out_specs=(P("snp"),) * 4))
    _ANOVA_MESH_CACHE[key] = fn
    return fn


def emmax_anova(G, y, K=None, X0=None, eig_k=None, ngrids: int = 100,
                llim: float = -10.0, ulim: float = 10.0, esp: float = 1e-6,
                host_eigh: bool = True, dtype=None,
                tile: int = 4096, mesh=None, **kw) -> Dict[str, np.ndarray]:
    """EMMAX with the SNP coded as CATEGORICAL genotype-class means
    (reference: emmax_anova). Binary coding reduces to emmax(); diploid
    coding tests the two indicator columns [I(g==1), I(g==2)] jointly
    (F with d1 = #classes - 1), so dominance is not assumed additive.

    Vectorized: both whitened indicator columns are residualized against
    the null design and Gram-Schmidt'ed against each other — elementwise
    over the SNP axis (same trick as the pairwise interaction test).
    mesh: SNP-shard the indicator scan over a device mesh (the whitened
    null replicates; the pair kernel is row-parallel)."""
    import jax

    from mixmogam_tpu.data.genotype import GenotypeData

    if isinstance(G, GenotypeData):
        ploidy = G.ploidy
        G_int = G.matrix
    else:
        G_int = np.asarray(G)
        mx = (np.nanmax(G_int, initial=0)
              if np.issubdtype(G_int.dtype, np.floating)
              else G_int.max(initial=0))
        ploidy = 2 if mx > 1 else 1
    if ploidy == 1:
        return emmax(G_int, y, K=K, X0=X0, eig_k=eig_k, ngrids=ngrids,
                     llim=llim, ulim=ulim, esp=esp, host_eigh=host_eigh,
                     dtype=dtype, tile=tile, mesh=mesh, **kw)
    if kw:
        # refuse rather than silently drop: the diploid joint-indicator
        # test has no precision tiers / with_betas (unlike the binary
        # path above, which forwards them to emmax)
        raise TypeError(
            f"emmax_anova diploid path does not accept {sorted(kw)}; "
            "supported kwargs: K/X0/eig_k/ngrids/llim/ulim/esp/"
            "host_eigh/dtype/tile/mesh")

    from mixmogam_tpu.ops.reml import esp_to_refine_iters

    y = np.asarray(y, dtype=np.float64).ravel()
    n = y.shape[0]
    if dtype is None:
        dtype = jnp.zeros(0).dtype
    if X0 is None:
        X0 = np.ones((n, 1))
    X0 = _as_design(X0, n)
    q = X0.shape[1]
    null = fit_null_model(y.astype(np.dtype(dtype).name), X0, K=K,
                          eig_k=eig_k, ngrids=ngrids, llim=llim, ulim=ulim,
                          refine_iters=esp_to_refine_iters(
                              esp, ngrids, llim, ulim),
                          host_eigh=host_eigh)
    rot = build_rotated_null(null)
    # indicator dosage rows (missing -> excluded from both classes after
    # mean-imputation-free indicator coding: impute to class of the mean)
    Gf = _as_dosage(G_int, np.float64)
    I1 = (np.abs(Gf - 1.0) < 0.5).astype(np.dtype(dtype).name)
    I2 = (Gf >= 1.5).astype(np.dtype(dtype).name)

    M = Gf.shape[0]
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from mixmogam_tpu.parallel.mesh import (gather_if_multiprocess,
                                                put_global, replicated)

        rep = replicated(mesh)
        rot_d = jax.tree.map(lambda v: put_global(v, rep), rot)
        spec = NamedSharding(mesh, P("snp", None))
        nshard = mesh.shape["snp"]
        tile_m = min(tile, max(-(-M // nshard), 8))
        mult = nshard * tile_m
        target = -(-M // mult) * mult
        A, B = I1, I2
        if target != M:
            A = np.vstack([A, np.zeros((target - M, n), A.dtype)])
            B = np.vstack([B, np.zeros((target - M, n), B.dtype)])
        fn = _anova_pair_jit(mesh, tile_m)
        out = fn(put_global(A, spec), put_global(B, spec), rot_d)
        f, d1, d2, mk = gather_if_multiprocess(out, mesh)
        fs = np.asarray(f, dtype=np.float64)[:M]
        d1s = np.asarray(d1, dtype=np.float64)[:M]
        d2s = np.asarray(d2, dtype=np.float64)[:M]
        masks = np.asarray(mk).astype(bool)[:M]
    else:
        fs = np.empty(M)
        d1s = np.empty(M)
        d2s = np.empty(M)
        masks = np.empty(M, dtype=bool)
        for s in range(0, M, tile):
            e = min(s + tile, M)
            A = I1[s:e]
            B = I2[s:e]
            if e - s < tile:
                A = np.vstack([A,
                               np.zeros((tile - (e - s), n), A.dtype)])
                B = np.vstack([B,
                               np.zeros((tile - (e - s), n), B.dtype)])
            f, d1, d2, mk = _anova_pair_f(jnp.asarray(A),
                                          jnp.asarray(B), rot)
            m = e - s
            fs[s:e] = np.asarray(f)[:m]
            d1s[s:e] = np.asarray(d1)[:m]
            d2s[s:e] = np.asarray(d2)[:m]
            masks[s:e] = np.asarray(mk)[:m]
    ps = np.where(masks, f_sf_host(fs, np.maximum(d1s, 1.0),
                                   np.maximum(d2s, 1.0)), 1.0)
    return {"ps": ps, "f_stats": fs, "dof1": d1s, "dof2": d2s,
            "mask": masks, "delta": float(null.delta),
            "pseudo_heritability": float(null.pseudo_heritability)}
