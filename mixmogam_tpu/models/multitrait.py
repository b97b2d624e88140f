"""Multi-trait batched EMMAX (BASELINE config #4; SURVEY.md §2.3 maps the
reference's absent 'expert parallelism' to the TRAIT axis).

All traits share eigh(K) — the only O(n^3) step; per-trait REML runs
through the X-explicit float64 host path (ops.reml._explicit_reml_host,
O(n q^2) per likelihood evaluation, no projected-spectrum eigh); the
scan shares each rotated genotype tile across traits — the rotation
matmul is paid once, the per-trait work is elementwise + (m,q) matmuls.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mixmogam_tpu.models.emmax import (_as_design, _as_dosage,
                                       default_stream_budget)
from mixmogam_tpu.ops.eigen import eigen_k
from mixmogam_tpu.ops.stats import f_sf_host
from mixmogam_tpu.ops.xreml import chol_small, chol_solve_small


@jax.jit
def _trait_nulls(Y_rot, X0_rot, phi, deltas):
    """Per-trait whitened null quantities, batched: sd (T,n), P0-applied
    residual y_res (T,n), rss0 (T,), and the GLS projector pieces."""
    sd = 1.0 / jnp.sqrt(phi[None, :] + deltas[:, None])          # (T, n)
    Ys = Y_rot * sd                                               # (T, n)
    X0s = X0_rot[None, :, :] * sd[:, :, None]                     # (T, n, q)
    A = jnp.einsum("tnp,tnq->tpq", X0s, X0s)                      # (T, q, q)
    L = chol_small(A)
    b = jnp.einsum("tnp,tn->tp", X0s, Ys)
    coef = chol_solve_small(L, b)                                 # (T, q)
    y_res = Ys - jnp.einsum("tnp,tp->tn", X0s, coef)
    rss0 = jnp.sum(y_res * y_res, axis=1)
    return sd, X0s, L, y_res, rss0


#: jitted packed mesh programs keyed on everything that shapes the
#: trace — pattern-group recursions and repeated campaigns trace once
#: per shape, not per call (review r5-cont #4)
_MT_MESH_CACHE: Dict = {}


def _mt_packed_jit(mesh, n: int, tile: int, impute: bool,
                   with_cols: bool, wscale_none: bool,
                   S: int = 1, w_ndim: int = 2):
    """Jitted shard_map program for the SNP-sharded packed multi-trait
    scan (mesh= on emmax_multi_trait): each device holds a block of
    packed rows and the replicated trait nulls; per tile it unpacks,
    optionally gathers a sample-column subset (missingness-pattern
    groups), imputes, rotates ONCE (shared by all traits — the whole
    point of the batch) and runs the per-trait epilogue. Outputs are
    (T, rows_local).

    S > 1 additionally SAMPLE-SHARDS the packed byte axis (same TP
    treatment as distributed_emmax_resident): the rotation operator RU
    row-shards over its contraction axis with zero rows for the byte
    padding, each tile's partial rotation reduces over 'sample'
    (apply_rotation_psum — int8 planes reduce in int32, bit-identical),
    and the per-trait epilogue runs on the full rotated rows,
    replicated over 'sample'. Missing data imputes via psum'd
    cross-shard moments. Column-gather groups (with_cols) need full
    byte rows and stay DP-only."""
    from jax.sharding import PartitionSpec as P

    key = (mesh, n, tile, impute, with_cols, wscale_none, S, w_ndim)
    fn = _MT_MESH_CACHE.get(key)
    if fn is not None:
        return fn
    from mixmogam_tpu.models.streaming import _impute_tile
    from mixmogam_tpu.ops.pack2 import unpack_2bit_device
    from mixmogam_tpu.ops.scan import apply_rotation, apply_rotation_psum

    if S == 1:
        def body(p_loc, RU, ru_scale, sd, X0s, L, y_res, rss0, dof,
                 cols):
            nt = p_loc.shape[0] // tile
            tiles = p_loc.reshape(nt, tile, p_loc.shape[1])

            def kern(pt):
                Gt = unpack_2bit_device(pt, n)
                if with_cols:
                    Gt = jnp.take(Gt, cols, axis=1)
                if impute:
                    Gt = _impute_tile(Gt, sd.dtype)
                Xs = apply_rotation(Gt, RU, ru_scale, sd.dtype)
                return _scan_tile_multitrait(Xs, sd, X0s, L, y_res,
                                             rss0, dof)

            f, b, mk = jax.lax.map(kern, tiles)      # (nt, T, tile)
            T = f.shape[1]
            return tuple(jnp.swapaxes(v, 0, 1).reshape(T, nt * tile)
                         for v in (f, b, mk))

        row_spec = P("snp", None)
        ru_spec = P()
    else:
        def body(p_loc, RU, ru_scale, sd, X0s, L, y_res, rss0, dof,
                 cols):
            dt = sd.dtype
            rb_local = p_loc.shape[1]
            n_local = 4 * rb_local
            col0 = jax.lax.axis_index("sample") * n_local
            nt = p_loc.shape[0] // tile
            tiles = p_loc.reshape(nt, tile, rb_local)
            n_out = sd.shape[1]

            def kern(pt):
                Gt = unpack_2bit_device(pt, n_local)
                if impute:
                    # cross-shard mean imputation (same moments psum as
                    # the single-trait TP kernel, _tp_resident_kernel)
                    valid = (col0 + jnp.arange(n_local)) < n
                    miss = Gt < 0
                    obs = jnp.where(miss | ~valid[None, :], 0.0,
                                    Gt.astype(dt))
                    cnt = jax.lax.psum(
                        jnp.sum((~miss) & valid[None, :], axis=1),
                        "sample")
                    mu = (jax.lax.psum(jnp.sum(obs, axis=1), "sample")
                          / jnp.maximum(cnt, 1).astype(dt))
                    Gf_ = jnp.where(valid[None, :],
                                    jnp.where(miss, mu[:, None],
                                              Gt.astype(dt)), 0.0)
                    Xs = apply_rotation_psum(Gf_, RU, ru_scale, dt,
                                             "sample", n_out)
                else:
                    Xs = apply_rotation_psum(Gt, RU, ru_scale, dt,
                                             "sample", n_out)
                return _scan_tile_multitrait(Xs, sd, X0s, L, y_res,
                                             rss0, dof)

            f, b, mk = jax.lax.map(kern, tiles)
            T = f.shape[1]
            return tuple(jnp.swapaxes(v, 0, 1).reshape(T, nt * tile)
                         for v in (f, b, mk))

        row_spec = P("snp", "sample")
        ru_spec = (P(None, "sample", None) if w_ndim == 3
                   else P("sample", None))
    spec = (ru_spec, None if wscale_none else P()) + (P(),) * 7
    fn = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(row_spec,) + spec,
        out_specs=(P(None, "snp"),) * 3))
    _MT_MESH_CACHE[key] = fn
    return fn


@jax.jit
def _mt_scan_whole(Gd, RU, ru_scale, sd, X0s, L, y_res, rss0, dof):
    """Whole-matrix multi-trait scan for the SNP-sharded in-core mesh
    path: with Gd row-sharded (P('snp', 'sample')) and the trait nulls
    replicated (RU contraction-row-sharded on TP meshes), GSPMD
    partitions the rotation + per-trait epilogue row-wise — zero
    communication until readback (psum inside the rotation on TP)."""
    from mixmogam_tpu.ops.scan import apply_rotation

    Xs = apply_rotation(Gd, RU, ru_scale, sd.dtype, n_out=sd.shape[1])
    return _scan_tile_multitrait(Xs, sd, X0s, L, y_res, rss0, dof)


@jax.jit
def _scan_tile_multitrait(G_rot_tile, sd, X0s, L, y_res, rss0, dof):
    """F stats for one rotated tile across all traits.
    G_rot_tile: (m, n); returns (T, m) f_stats + mask."""
    def per_trait(sd_t, X0s_t, L_t, y_res_t, rss0_t):
        Xs = G_rot_tile * sd_t[None, :]                           # (m, n)
        c = Xs @ X0s_t                                            # (m, q)
        # xx = ||Xs||^2 - c' A^-1 c   (A = X0s'X0s, non-orthonormal basis)
        s = chol_solve_small(L_t, c)                              # (m, q)
        ss = jnp.sum(Xs * Xs, axis=1)
        xx = ss - jnp.sum(c * s, axis=1)
        xy = Xs @ y_res_t
        eps = 100.0 * jnp.finfo(Xs.dtype).eps
        mask = xx > eps * jnp.maximum(ss, jnp.finfo(Xs.dtype).tiny)
        xx_safe = jnp.where(mask, xx, 1.0)
        expl = jnp.where(mask, jnp.minimum(xy * xy / xx_safe, rss0_t), 0.0)
        rss1 = jnp.maximum(rss0_t - expl, jnp.finfo(Xs.dtype).tiny)
        f = expl * dof / rss1
        beta = jnp.where(mask, xy / xx_safe, 0.0)
        return f, beta, mask

    return jax.vmap(per_trait)(sd, X0s, L, y_res, rss0)


def emmax_multi_trait(G, Y, K=None, X0: Optional[np.ndarray] = None,
                      eig_k: Optional[Tuple] = None, ngrids: int = 100,
                      llim: float = -10.0, ulim: float = 10.0,
                      esp: float = 1e-6,
                      dtype=None, tile: Optional[int] = None,
                      tile_budget: int = 1 << 27,
                      stream_budget_bytes: Optional[int] = None,
                      precision: Optional[str] = None,
                      _keep_cols: Optional[np.ndarray] = None,
                      mesh=None) -> Dict[str, np.ndarray]:
    """EMMAX over T phenotypes sharing one kinship/eigenbasis.

    mesh: a ('snp', 'sample') device mesh SNP-shards the scan — the
    trait nulls replicate, genotypes shard row-wise (a ResidentGenome
    shards its PACKED rows via shard_map; a big int8 source auto-packs
    HOST-side), and each chip rotates + tests its shard for all traits
    with one gather on readback. 2-D ('snp', 'sample') meshes
    additionally shard the rotation operator over its contraction rows
    (in-core via GSPMD psum; packed via the byte-axis sample shards +
    apply_rotation_psum — int8 planes reduce in int32, bit-identical).
    Missing-Y pattern groups each run sharded; a packed pattern
    SUBSET (column-gather) is DP-only. Parity-tested
    mesh-shape-invariant.

    precision (round 5): tier name for the SHARED rotation matmul —
    the per-tile cost all T traits amortize ('exact'/'auto'/'high'/
    'bf16*'/'int8x*', same semantics as emmax; int8 tiers need
    fully-observed integer dosages). 'fast' is refused: multi-trait
    has no rescore pass, so pick a fp32-grade tier ('auto' resolves per
    ops.scan.PRECISION_ROUTES: int8x3 for integer data on a GPU) or the
    default exact.
    In-core and resident sources only; per-trait REML always runs
    exact (f64 host).

    Y: (T, n) trait matrix (rows = traits, aligned to G's samples).
    Missing phenotype values (NaN) are supported: traits are grouped by
    missingness pattern, each group runs on its observed sample subset
    with the kinship sub-block (prepare_k semantics) and its own
    eigenbasis — exact, one host eigh per DISTINCT pattern (the
    reference's multi-phenotype files typically have few). Fully
    observed input keeps the single shared eigenbasis. A ResidentGenome
    works with missing phenotypes too: each pattern group gathers its
    sample columns on device per tile (no host decode of the packed
    container).

    Returns ps/f_stats/betas of shape (T, M) + per-trait deltas and h2;
    'dof' is a scalar when all traits share the sample set, else a (T,)
    per-trait array.
    """
    Y = np.atleast_2d(np.asarray(Y, dtype=np.float64))
    T, n = Y.shape
    from mixmogam_tpu.models.resident import ResidentGenome

    rg = G if isinstance(G, ResidentGenome) else None
    if np.isnan(Y).any():
        # per-trait missing phenotypes: group by missingness pattern;
        # a ResidentGenome's pattern groups gather their SAMPLE subset
        # on device per tile (no host decode)
        return _multi_trait_grouped(G, Y, K=K, X0=X0, ngrids=ngrids,
                                    llim=llim, ulim=ulim, esp=esp,
                                    dtype=dtype,
                                    tile=tile, tile_budget=tile_budget,
                                    precision=precision, mesh=mesh)
    if dtype is None:
        dtype = jnp.zeros(0).dtype
    # big-M routing (mirrors models.emmax): stream SNP tiles from host
    # instead of materializing G (+ its float copy) on device — config #4
    # is 1M x 10k x 50 traits, where the rotation is paid ONCE per tile
    # and shared by every trait (the whole point of the shared-eigenbasis
    # batch: 50 traits for ~1.07x the single-trait scan cost). A
    # ResidentGenome sources tiles straight from packed HBM instead.
    from mixmogam_tpu.models.source import resolve_source, should_stream

    G_src = resolve_source(G)
    M = G_src.shape[0]
    keep_cols_dev = None
    if rg is not None:
        if _keep_cols is not None:
            _keep_cols = np.asarray(_keep_cols)
            if _keep_cols.shape[0] != n:
                raise ValueError("_keep_cols must list one container "
                                 "column per Y column")
            keep_cols_dev = jnp.asarray(_keep_cols, jnp.int32)
        elif rg.n != n:
            raise ValueError(f"Y has {n} samples but the resident "
                             f"genome holds {rg.n}")
    if stream_budget_bytes is None:
        stream_budget_bytes = default_stream_budget()
    streamed = (False if rg is not None
                else should_stream(G_src, n, dtype, stream_budget_bytes))
    if mesh is not None:
        if streamed:
            from mixmogam_tpu.models.source import pack_for_mesh

            rg = pack_for_mesh(G_src, n, "multi-trait")
            streamed = False
        # AFTER the auto-pack: column-gather groups need FULL byte rows
        # per device, so a missing-Y pattern subset of a packed source
        # is DP-only; fully-observed-Y packed sources take 2-D meshes
        # (sample-TP, same treatment as distributed_emmax_resident)
        if (rg is not None and _keep_cols is not None
                and mesh.shape["sample"] != 1):
            raise ValueError(
                "a missing-Y pattern group over a packed container "
                "gathers sample columns per tile and shards 'snp' "
                "only; use a ('snp', 1) mesh")
    if streamed or rg is not None:
        Gf = None
    else:
        # fully-observed int8 ships AS int8 (4-8x less transfer/HBM
        # than a float copy; the kernels cast per tile) — same rule as
        # models.emmax
        G_raw = G.matrix if hasattr(G, "matrix") else np.asarray(G)
        if (isinstance(G_raw, np.ndarray) and G_raw.dtype == np.int8
                and not (G_raw < 0).any()):
            Gf = G_raw
        else:
            Gf = _as_dosage(G, dtype)
    if X0 is None:
        X0 = np.ones((n, 1))
    X0 = _as_design(X0, n)
    q = X0.shape[1]

    # ---- tier resolution BEFORE the O(n^3) eigh + T REML fits: a
    # refused tier must fail in milliseconds, not minutes (review r5) ----
    import contextlib

    from mixmogam_tpu.ops.scan import (apply_rotation, is_integer_dosage,
                                       normalize_rotate_tier,
                                       probe_for_source,
                                       quantize_rotation,
                                       resolve_precision)

    matmul_precision = None
    rd = None
    tier_name = "exact"
    if precision is not None:
        if str(precision) == "fast":
            raise ValueError(
                "multi-trait has no rescore pass; pick an explicit "
                "tier ('auto'/'int8x3' are fp32-grade) or leave exact")
        if streamed:
            raise ValueError("precision tiers on the multi-trait path "
                             "need an in-core or resident source")
        rb, matmul_precision, tier_name = resolve_precision(
            precision, G=probe_for_source(rg, Gf))
        rd = normalize_rotate_tier(rb)
        # 'auto' only resolves int8 after is_integer_dosage passed on
        # the full in-core matrix — don't re-scan it below
        int8_verified = (str(precision) == "auto"
                         and tier_name.startswith("int8"))
        if isinstance(rd, str) and rd.startswith("int8"):
            if rg is not None and rg.has_missing:
                raise ValueError(
                    "int8 digit-plane tiers need fully-observed "
                    "dosages (this container has missing genotypes)")
            if (rg is None and not int8_verified
                    and not is_integer_dosage(Gf)):
                raise ValueError(
                    "int8 digit-plane tiers need exact integer "
                    "dosages; these are fractional (imputed)")

    if eig_k is None:
        phi, U = eigen_k(K, host=True)
    else:
        phi, U = eig_k
    # per-trait REML via the X-explicit path (float64 host, needs only
    # eigh(K)): identical optimum to the projected-spectrum formulation
    # (identities pinned by tests) without its second O(n^3) host eigh
    # (~200 s at the config-#4 n=10k scale)
    from mixmogam_tpu.ops.reml import _explicit_reml_host, esp_to_refine_iters

    ri = esp_to_refine_iters(esp, ngrids, llim, ulim)
    U64 = np.asarray(U, np.float64)
    phi64 = np.asarray(phi, np.float64)
    X_rot64 = U64.T @ np.asarray(X0, np.float64)
    Yr64 = Y @ U64                                                # (T, n)
    fits = [_explicit_reml_host(phi64, Yr64[t], X_rot64, ngrids=ngrids,
                                llim=llim, ulim=ulim, refine_iters=ri)
            for t in range(T)]
    phi = jnp.asarray(phi, dtype=dtype)
    U = jnp.asarray(U, dtype=dtype)
    Yd = jnp.asarray(Y, dtype=dtype)
    deltas = jnp.asarray([f["delta"] for f in fits], dtype=dtype)
    Y_rot = Yd @ U
    X0_rot = U.T @ jnp.asarray(X0, dtype=dtype)
    sd, X0s, L, y_res, rss0 = _trait_nulls(Y_rot, X0_rot, phi, deltas)
    dof = n - q - 1

    if tile is None:
        tile = max(64, min(8192, tile_budget // max(T * n, 1)))
    if rg is not None:
        tile = rg.tile  # packed rows are padded to this granularity
    Gd = (None if (streamed or rg is not None or mesh is not None)
          else jnp.asarray(Gf))

    # ---- tiered SHARED rotation (resolved above, before the eigh) ----
    if rd is not None:
        RU, ru_scale = quantize_rotation(U, rd, sd_dtype=phi.dtype)
        rotate = jax.jit(
            lambda t, W, ws: apply_rotation(t, W, ws, phi.dtype))
    else:
        RU, ru_scale = U, None
        rotate = jax.jit(
            lambda t, W, ws: jnp.dot(t.astype(W.dtype), W,
                                     preferred_element_type=W.dtype))
    mp_ctx = (jax.default_matmul_precision(matmul_precision)
              if matmul_precision else contextlib.nullcontext())

    if mesh is not None:
        # ---- SNP-sharded scan over the device mesh: trait nulls
        # replicate, rows shard; one gather on readback ----
        from jax.sharding import NamedSharding, PartitionSpec as P

        from mixmogam_tpu.parallel.mesh import (pad_to_multiple,
                                                put_global, replicated,
                                                snp_sharding)

        rep = replicated(mesh)
        dof_d = jnp.asarray(float(dof), phi.dtype)

        def place(v):
            return None if v is None else put_global(v, rep)

        with mp_ctx:
            if rg is not None:
                from mixmogam_tpu.parallel.distributed import (
                    _pad_w_rows, shard_packed_rows)

                S = mesh.shape["sample"]
                packed = shard_packed_rows(rg, mesh, tile,
                                           sample_axis=S > 1)
                with_cols = keep_cols_dev is not None
                cols = (keep_cols_dev if with_cols
                        else jnp.zeros(1, jnp.int32))
                if S > 1:
                    # TP: RU contraction rows pad to the byte-padded
                    # sample count and row-shard over 'sample'
                    RU_use = _pad_w_rows(RU, 4 * packed.shape[1])
                    ru_spec = (P(None, "sample", None)
                               if RU_use.ndim == 3
                               else P("sample", None))
                    RU_pl = put_global(
                        RU_use, NamedSharding(mesh, ru_spec))
                else:
                    RU_pl = place(RU)
                fn = _mt_packed_jit(mesh, rg.n, tile,
                                    bool(rg.has_missing), with_cols,
                                    ru_scale is None, S,
                                    getattr(RU, "ndim", 2))
                args = (RU_pl, place(ru_scale), place(sd),
                        place(X0s), place(L), place(y_res), place(rss0),
                        place(dof_d), place(cols))
                f, b, mk = fn(packed, *args)
            else:
                Gp, _ = pad_to_multiple(np.asarray(Gf),
                                        mesh.shape["snp"], axis=0)
                RU_use = RU
                if mesh.shape["sample"] > 1:
                    # TP: the rotation operator contraction-row-shards
                    # against G's sample columns; GSPMD psums partials.
                    # Zero-pad sample cols + W rows when n doesn't
                    # split evenly (zero x zero contributes nothing)
                    from mixmogam_tpu.parallel.distributed import \
                        _pad_w_rows

                    Gp, _ = pad_to_multiple(Gp, mesh.shape["sample"],
                                            axis=1)
                    RU_use = _pad_w_rows(RU, Gp.shape[1])
                    ru_spec = (P(None, "sample", None)
                               if RU_use.ndim == 3
                               else P("sample", None))
                    RU_sh = put_global(RU_use,
                                       NamedSharding(mesh, ru_spec))
                else:
                    RU_sh = place(RU)
                Gd_sh = put_global(Gp, snp_sharding(mesh))
                f, b, mk = _mt_scan_whole(
                    Gd_sh, RU_sh, place(ru_scale), place(sd), place(X0s),
                    place(L), place(y_res), place(rss0), place(dof_d))
        from mixmogam_tpu.parallel.mesh import gather_if_multiprocess

        f, b, mk = gather_if_multiprocess((f, b, mk), mesh)
        fs = np.array(f, np.float64)[:, :M]
        betas = np.array(b, np.float64)[:, :M]
        masks = np.array(mk).astype(bool)[:, :M]
        ps = np.where(masks, f_sf_host(fs, 1.0, dof), 1.0)
        return {
            "ps": ps, "f_stats": fs, "betas": betas, "mask": masks,
            "deltas": np.array([f_["delta"] for f_ in fits]),
            "pseudo_heritabilities": np.array(
                [f_["pseudo_heritability"] for f_ in fits]),
            "dof": dof, "precision_tier": tier_name,
        }

    fs = np.empty((T, M))
    betas = np.empty((T, M))
    masks = np.empty((T, M), dtype=bool)
    pending = []

    def drain(s, e, out):
        f, b, mk = jax.device_get(out)
        m = e - s
        fs[:, s:e] = np.asarray(f)[:, :m]
        betas[:, s:e] = np.asarray(b)[:, :m]
        masks[:, s:e] = np.asarray(mk)[:, :m]

    with mp_ctx:
        for s in range(0, M, tile):
            e = min(s + tile, M)
            if rg is not None:
                from mixmogam_tpu.models.resident import (
                    _tile_from_packed, _tile_from_packed_cols)
                from mixmogam_tpu.models.streaming import _impute_tile

                if _keep_cols is not None:
                    Gt = _tile_from_packed_cols(
                        rg.packed, jnp.asarray(s, jnp.int32), rg.tile,
                        rg.n, keep_cols_dev)
                else:
                    Gt = _tile_from_packed(rg.packed,
                                           jnp.asarray(s, jnp.int32),
                                           rg.tile, n)
                if rg.has_missing:
                    Gt = _impute_tile(Gt, dtype)
            elif streamed:
                from mixmogam_tpu.models.source import fetch_tile

                Gt = fetch_tile(G_src, s, e, tile, n, dtype)
            else:
                Gt = Gd[s:e]
                if e - s < tile:
                    Gt = jnp.pad(Gt, ((0, tile - (e - s)), (0, 0)))
            G_rot_tile = rotate(Gt, RU, ru_scale)
            out = _scan_tile_multitrait(G_rot_tile, sd, X0s, L, y_res,
                                        rss0, float(dof))
            pending.append((s, e, out))
            if len(pending) >= 4:
                drain(*pending.pop(0))
    for item in pending:
        drain(*item)

    ps = np.where(masks, f_sf_host(fs, 1.0, dof), 1.0)
    return {
        "ps": ps, "f_stats": fs, "betas": betas, "mask": masks,
        "deltas": np.array([f["delta"] for f in fits]),
        "pseudo_heritabilities": np.array(
            [f["pseudo_heritability"] for f in fits]),
        "dof": dof, "precision_tier": tier_name,
    }


def _multi_trait_grouped(G, Y, K=None, X0=None, ngrids: int = 100,
                         llim: float = -10.0, ulim: float = 10.0,
                         esp: float = 1e-6, dtype=None, tile=None,
                         tile_budget: int = 1 << 27,
                         precision=None, mesh=None) -> Dict[str, np.ndarray]:
    """Per-trait missing phenotypes: group traits by missingness pattern;
    each group = one sample subset, one kinship sub-block, one shared
    eigenbasis, one batched scan. SNP degeneracy on a subset is handled by
    the kernel's per-SNP mask (p = 1), matching the package-wide rule.
    A ResidentGenome group recurses with the container + a device
    column-gather index (VERDICT r3 #7) instead of decoding to host."""
    from mixmogam_tpu.models.resident import ResidentGenome

    T, n = Y.shape
    if dtype is None:
        dtype = jnp.zeros(0).dtype
    # keep the source in its native dtype (int8 at scale); each group
    # subsets COLUMNS and recurses — a full float64 copy here would be
    # 80 GB at the 1M x 10k configuration
    from mixmogam_tpu.models.source import resolve_source

    rg = G if isinstance(G, ResidentGenome) else None
    G_src = resolve_source(G)
    M = G_src.shape[0]
    if X0 is None:
        X0 = np.ones((n, 1))
    X0 = _as_design(X0, n)
    q = X0.shape[1]
    if K is None:
        raise ValueError("per-trait missing phenotypes need an explicit "
                         "(n, n) kinship matrix (eig_k cannot be shared "
                         "across different sample subsets)")
    K = np.asarray(K, dtype=np.float64)

    groups: Dict[bytes, list] = {}
    obs = ~np.isnan(Y)
    for t in range(T):
        groups.setdefault(obs[t].tobytes(), []).append(t)

    ps = np.ones((T, M))
    fs = np.zeros((T, M))
    betas = np.zeros((T, M))
    masks = np.zeros((T, M), dtype=bool)
    deltas = np.empty(T)
    h2s = np.empty(T)
    dofs = np.empty(T, dtype=np.int64)
    for key, tids in groups.items():
        keep = np.frombuffer(key, dtype=bool)
        ns = int(keep.sum())
        if ns < q + 3:
            raise ValueError(
                f"traits {tids} have only {ns} observed samples "
                f"(need at least q+3 = {q + 3})")
        if rg is not None:
            sub = emmax_multi_trait(
                rg, Y[np.ix_(tids, np.flatnonzero(keep))],
                K=K[np.ix_(keep, keep)], X0=X0[keep], ngrids=ngrids,
                llim=llim, ulim=ulim, esp=esp, dtype=dtype, tile=tile,
                tile_budget=tile_budget, precision=precision, mesh=mesh,
                _keep_cols=(np.flatnonzero(keep)
                            if not keep.all() else None))
        else:
            sub = emmax_multi_trait(
                np.ascontiguousarray(np.asarray(G_src)[:, keep]),
                Y[np.ix_(tids, np.flatnonzero(keep))],
                K=K[np.ix_(keep, keep)], X0=X0[keep], ngrids=ngrids,
                llim=llim, ulim=ulim, esp=esp, dtype=dtype, tile=tile,
                tile_budget=tile_budget, precision=precision, mesh=mesh)
        ps[tids] = sub["ps"]
        fs[tids] = sub["f_stats"]
        betas[tids] = sub["betas"]
        masks[tids] = sub["mask"]
        deltas[tids] = sub["deltas"]
        h2s[tids] = sub["pseudo_heritabilities"]
        dofs[tids] = sub["dof"]
        tier = sub.get("precision_tier", "exact")
    one = len(groups) == 1
    return {"ps": ps, "f_stats": fs, "betas": betas, "mask": masks,
            "deltas": deltas, "pseudo_heritabilities": h2s,
            "dof": int(dofs[0]) if one else dofs,
            "precision_tier": tier}
