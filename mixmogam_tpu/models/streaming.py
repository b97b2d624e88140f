"""Streaming EMMAX for genotype matrices larger than device HBM
(BASELINE config #3: 10k samples x 1M SNPs) with tile-granular
checkpoint/resume (SURVEY.md §5 'failure detection / resume': the scan is
deterministic and restartable at SNP-tile granularity).

Design:
- the genotype source stays on host (numpy array, np.memmap, or an h5py
  dataset — anything sliceable row-wise) as int8;
- tiles transfer as int8 (4x less host-link and device-memory traffic
  than fp32) and are mean-imputed ON DEVICE (missing = -1), matching the
  oracle's rule;
- each tile's F statistics land in a checkpoint directory with a
  manifest; a killed run resumes from the last completed tile;
- dispatches are issued ASYNC several tiles deep so transfers and
  compute overlap.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from mixmogam_tpu.models.emmax import _as_design

from mixmogam_tpu.ops.reml import fit_null_model
from mixmogam_tpu.ops.scan import build_rotated_null, emmax_scan_stats


@functools.partial(jax.jit, static_argnames=("dtype",))
def _impute_tile(t_i8: jnp.ndarray, dtype=jnp.float32) -> jnp.ndarray:
    """int8 tile (m, n) with -1 missing -> float (dtype), per-SNP mean
    imputed (device-side; same rule as oracle.kinship.mean_impute)."""
    t = t_i8.astype(dtype)
    miss = t_i8 < 0
    obs = jnp.where(miss, 0.0, t)
    cnt = jnp.maximum(jnp.sum(~miss, axis=1, keepdims=True), 1)
    mu = jnp.sum(obs, axis=1, keepdims=True) / cnt
    return jnp.where(miss, mu, t)


@jax.jit
def _scan_tile_i8(t_i8, rot):
    return emmax_scan_stats(_impute_tile(t_i8, rot.sd.dtype), rot)


def rotate_streamed_to_device(G_src, U, dtype=None,
                              tile: int = 16_384) -> jnp.ndarray:
    """Build the rotated genotype matrix G_rot = impute(G) @ U ON DEVICE,
    tile-by-tile from a host source — the 'rotate once, scan many' asset
    for stepwise/EMMA/permutation at scale (BASELINE config #5). Peak
    device footprint = G_rot (M x n x itemsize) + one tile + U; the float
    G is never materialized on device (a full Gf + G_rot would be 2x).

    G_src: (M, n) sliceable host source, int8 (-1 missing, device
    imputation) or float (NaN missing, host per-tile imputation)."""
    if dtype is None:
        dtype = jnp.zeros(0).dtype
    M, n = G_src.shape
    int8_source = np.dtype(getattr(G_src, "dtype", np.int8)) == np.int8
    out = jnp.zeros((M, n), dtype=dtype)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def upd(out, td, U, s):
        rot = jnp.dot(td.astype(U.dtype), U,
                      preferred_element_type=out.dtype)
        return jax.lax.dynamic_update_slice(
            out, rot, (s, jnp.zeros((), s.dtype)))

    U = jnp.asarray(U, dtype=dtype)
    # single compiled shape: when M % tile != 0 the FINAL window is
    # [M - tile, M), overlapping the previous tile — recomputing the
    # overlap is idempotent (same inputs -> same rotated rows) and
    # avoids a second minutes-slow remote compile of the big matmul
    if M <= tile:
        starts = [0]
        tile = M
    else:
        starts = list(range(0, M - tile + 1, tile))
        if starts[-1] + tile < M:
            starts.append(M - tile)
    for s in starts:
        e = s + tile
        if int8_source:
            chunk = np.ascontiguousarray(np.asarray(G_src[s:e],
                                                    dtype=np.int8))
            td = _impute_tile(jnp.asarray(chunk), np.dtype(dtype).name)
        else:
            td = jnp.asarray(_host_float_tile(G_src[s:e], np.dtype(dtype)))
        out = upd(out, td, U, jnp.asarray(s, jnp.int32))
    return out


def _host_float_tile(chunk: np.ndarray, dtype) -> np.ndarray:
    """Float-source tile: NaN = missing, per-SNP mean imputed on host
    (tiles hold COMPLETE SNP rows, so per-SNP imputation is tile-local).

    np.array COPY, not asarray: a float64 source slice arrives as a
    no-copy VIEW, and imputing in place would silently overwrite the
    CALLER's NaNs with means (or crash on a read-only memmap) —
    review finding."""
    C = np.array(chunk, dtype=np.float64)
    miss = np.isnan(C)
    if miss.any():
        mu = np.nanmean(C, axis=1)
        mu = np.where(np.isnan(mu), 0.0, mu)
        idx = np.where(miss)
        C[idx] = mu[idx[0]]
    return C.astype(dtype)


def finalize_scan(matrix_source, null, dtype, f_stats, mask,
                  betas=None, var_perc=None, with_betas: bool = True,
                  rescore_top: int = 0, rd=None, matmul_precision=None,
                  tier_name=None, dof: int = 0):
    """p-value finalize + threshold-complete exact rescore + output
    dict — the ONE definition shared by the in-core, resident and
    streamed EMMAX paths (review r5-cont: three drifting copies).

    f_stats/mask (and betas/var_perc when given) are float64/bool host
    arrays, PATCHED IN PLACE by the rescore pass. rescore_top only
    engages on an approximate tier (rd/matmul_precision set), where
    every returned p below the drift-widened Bonferroni cut is
    re-tested at the exact tier, uncapped (VERDICT r4 #2 contract)."""
    from mixmogam_tpu.ops.stats import f_sf_host as _fsf

    dof = int(dof)
    ps = np.where(mask, _fsf(f_stats, 1.0, dof), 1.0)
    rescored = np.zeros(0, dtype=np.int64)
    if rescore_top and (rd is not None or matmul_precision):
        from mixmogam_tpu.ops.scan import (select_rescore_idx,
                                           tier_drift_name)

        idx = select_rescore_idx(ps, rescore_top,
                                 tier_drift_name(rd, matmul_precision))
        idx, d_ex = _exact_rescore(matrix_source, idx, null, dtype)
        f_stats[idx] = np.asarray(d_ex["f_stats"], dtype=np.float64)
        mask[idx] = np.asarray(d_ex["mask"])
        ps[idx] = np.where(mask[idx], _fsf(f_stats[idx], 1.0, dof), 1.0)
        if betas is not None:
            betas[idx] = np.asarray(d_ex["betas"], dtype=np.float64)
            var_perc[idx] = np.asarray(d_ex["var_perc"],
                                       dtype=np.float64)
        rescored = idx
    out = {
        "ps": ps, "f_stats": f_stats, "mask": mask,
        "rescored_idx": rescored,
        "pseudo_heritability": float(null.pseudo_heritability),
        "delta": float(null.delta), "sigma_g2": float(null.sigma_g2),
        "sigma_e2": float(null.sigma_e2), "dof": dof,
        "ll_null": float(null.ll),
        "precision_tier": tier_name if tier_name is not None else (
            matmul_precision or (rd if isinstance(rd, str)
                                 else ("bf16" if rd is not None
                                       else "exact"))),
    }
    if with_betas and betas is not None:
        out["betas"] = betas
        out["var_perc"] = var_perc
    return out


def _exact_rescore(matrix_source, idx, null, dtype, tile: int = 16_384):
    """Re-test SNP rows `idx` at the EXACT fp32+ tier (two-stage scan:
    a fast tier ranks the genome, the exact tier re-scores everything
    that will be reported). Returns the exact per-row stats dict.

    Rows are fetched with STRICTLY INCREASING UNIQUE indices (h5py fancy
    selection rejects duplicates/non-monotone lists) and any shape
    padding happens on the fetched host array. The device dispatch is
    tiled at the normal scan tile size — the candidate set is bounded by
    the callers' 8*rescore_top cap, but a single untiled (|idx|, n)
    dispatch could still exceed HBM at n = 10k."""
    from mixmogam_tpu.ops.scan import build_rotated_null, emmax_scan_stats

    idx = np.unique(np.asarray(idx, dtype=np.int64))  # sorted unique
    k = len(idx)
    rot_ex = build_rotated_null(null)  # exact tier, same null/delta
    scan = jax.jit(emmax_scan_stats)
    outs = []
    for s in range(0, k, tile):
        rows = np.asarray(matrix_source[idx[s:s + tile]])
        m = rows.shape[0]
        # pad the row count to a power-of-two bucket: static shapes
        # under jit (repo convention), so varying hit counts reuse a
        # handful of compiled programs instead of retracing per run
        bucket = min(max(256, 1 << (m - 1).bit_length()), tile)
        if m < bucket:
            rows = np.concatenate(
                [rows, np.repeat(rows[:1], bucket - m, axis=0)])
        if rows.dtype == np.int8:
            rows_d = _impute_tile(jnp.asarray(rows), np.dtype(dtype).name)
        else:
            rows_d = jnp.asarray(_host_float_tile(rows, np.dtype(dtype)))
        out = jax.device_get(scan(rows_d, rot_ex))
        outs.append({kk: v[:m] for kk, v in out.items()})
    merged = {kk: np.concatenate([o[kk] for o in outs])
              for kk in outs[0]}
    return idx, merged


def emmax_streamed(matrix_source, y, K=None, X0: Optional[np.ndarray] = None,
                   eig_k=None, tile: int = 32_768, inflight: int = 4,
                   checkpoint_dir: Optional[str] = None,
                   ngrids: int = 100, llim: float = -10.0, ulim: float = 10.0,
                   esp: float = 1e-6, rotate_in_bf16=False,
                   precision: Optional[str] = None, dtype=None,
                   host_eigh: bool = True, with_betas: bool = True,
                   rescore_top: int = 0,
                   ) -> Dict[str, np.ndarray]:
    """EMMAX over a host-resident genotype source.

    matrix_source: (M, n), sliceable by [start:stop] (numpy, memmap,
    h5py dataset). int8 sources transfer as int8 (-1 = missing, imputed
    on DEVICE); float sources are mean-imputed per tile on host (NaN =
    missing). Returns the same dict as models.emmax.

    rotate_in_bf16 selects the same scan precision tiers as models.emmax
    (False | True | 'x2' | 'x3' | 'int8x2' | 'int8x3' | 'int8x4'), or
    pass the unified precision= name ('exact'/'auto'/'high'/...). The
    int8 digit-plane tiers require a fully-observed source
    (missing dosages are mean-imputed to fractions the digit cast would
    round; tiles are checked host-side and refused).

    rescore_top > 0 with an approximate tier re-tests the top-k SNPs
    (a floor) plus EVERY SNP below the drift-widened Bonferroni cut
    (ops.scan.select_rescore_idx — threshold-complete, uncapped) at the
    exact tier and overwrites their stats — the fast tier's p-drift
    then only affects SNPs nowhere near significance, so any p a user
    would threshold as significant is exact-grade at fast-tier scan
    cost ('rescored_idx' lists the re-tested rows)."""
    import contextlib

    from mixmogam_tpu.ops.reml import esp_to_refine_iters
    from mixmogam_tpu.ops.scan import normalize_rotate_tier, resolve_precision

    y = np.asarray(y, dtype=np.float64).ravel()
    n = y.shape[0]
    M = matrix_source.shape[0]
    if str(precision) == "fast" and not rescore_top:
        rescore_top = 1024  # see models.emmax: 'fast' implies rescore
    if matrix_source.shape[1] != n:
        raise ValueError(
            f"matrix_source is (M={M}, {matrix_source.shape[1]}) but y has "
            f"{n} samples — expected an (M, n_samples) SNP-major source")
    if dtype is None:
        dtype = jnp.zeros(0).dtype  # respects jax_enable_x64
    dtype = np.dtype(dtype)
    if X0 is None:
        X0 = np.ones((n, 1))
    X0 = _as_design(X0, n)
    q = X0.shape[1]
    matmul_precision = None
    tier_name = None
    if precision is not None:
        if rotate_in_bf16:
            raise ValueError("pass either precision= or the legacy "
                             "rotate_in_bf16 kwarg, not both")
        probe = None
        if str(precision) in ("auto", "fast"):
            # 'auto'/'fast' + int8 source: the int8 tiers are only usable when
            # the WHOLE source is fully observed (mean imputation makes
            # fractions the digit cast would round), so check for the
            # missing sentinel in chunks — one sequential pass over data
            # we are about to read anyway; any hit resolves to 'exact'
            # instead of crashing mid-scan
            if np.dtype(getattr(matrix_source, "dtype",
                                np.float64)) == np.int8:
                has_missing = False
                for s0 in range(0, M, 65_536):
                    if (np.asarray(matrix_source[s0:s0 + 65_536])
                            < 0).any():
                        has_missing = True
                        break
                probe = (np.full((1, 1), np.nan)  # forces 'exact'
                         if has_missing
                         else np.zeros((1, 1), dtype=np.int8))
            else:
                # float streamed source: integrality of the first rows
                # proves nothing about the rest, and verifying the WHOLE
                # multi-GB float source on host would double the disk
                # traffic — so 'auto'/'fast' never resolve to an int8
                # tier here (probe=None => the fractional route of
                # ops.scan.PRECISION_ROUTES). Explicitly requesting
                # precision='int8x*' still works and is validated per
                # tile.
                probe = None
        rotate_in_bf16, matmul_precision, tier_name = resolve_precision(
            precision, G=probe)
    null = fit_null_model(y.astype(dtype), X0.astype(dtype),
                          K=K, eig_k=eig_k, ngrids=ngrids, llim=llim,
                          ulim=ulim,
                          refine_iters=esp_to_refine_iters(
                              esp, ngrids, llim, ulim),
                          host_eigh=host_eigh,
                          eigh_dtype=(np.float32
                                      if str(precision) == "fast"
                                      else None))
    rd = normalize_rotate_tier(rotate_in_bf16)
    int8_tier = isinstance(rd, str) and rd.startswith("int8")
    rot = build_rotated_null(null, rotate_dtype=rd)
    dof = n - q - 1
    int8_source = np.dtype(getattr(matrix_source, "dtype", np.int8)) == np.int8
    mp_ctx = (jax.default_matmul_precision(matmul_precision)
              if matmul_precision else contextlib.nullcontext())

    # ---- checkpoint manifest ----
    # the key must change when the GENOTYPES change, not just the model:
    # fingerprint a deterministic sample of source rows (hashing the full
    # multi-GB source every run would defeat the streaming design).
    # y and X0 content are hashed too (they're only n-sized): delta alone
    # does not identify the trait — it clamps to the same grid endpoint
    # for any near-zero/near-total-heritability phenotype, so two traits
    # sharing a checkpoint_dir could otherwise collide.
    h = hashlib.sha256(f"{M}:{n}:{tile}:{float(null.delta):.10g}:{q}:"
                       f"{rd}:{matmul_precision}:{dtype}".encode())
    h.update(np.ascontiguousarray(y).tobytes())
    h.update(np.ascontiguousarray(np.asarray(X0, np.float64)).tobytes())
    for r in sorted({0, M - 1, *range(0, M, max(M // 32, 1))}):
        h.update(np.ascontiguousarray(
            np.asarray(matrix_source[r:r + 1])).tobytes())
    run_key = h.hexdigest()[:12]
    done = set()
    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)
        mpath = os.path.join(checkpoint_dir, f"manifest_{run_key}.json")
        if os.path.exists(mpath):
            # tolerate a manifest truncated by a mid-write kill (the
            # exact event checkpointing exists for): restart from the
            # tile files alone rather than crash (review finding)
            try:
                with open(mpath) as f:
                    done = set(json.load(f)["done"])
            except (json.JSONDecodeError, KeyError, ValueError):
                done = set()

    n_tiles = -(-M // tile)
    f_stats = np.zeros(M, dtype=np.float64)
    betas = np.zeros(M, dtype=np.float64)
    var_perc = np.zeros(M, dtype=np.float64)
    mask = np.zeros(M, dtype=bool)

    def tile_path(t):
        return os.path.join(checkpoint_dir, f"tile_{run_key}_{t}.npz")

    def store(t, out):
        s, e = t * tile, min((t + 1) * tile, M)
        m = e - s
        f_stats[s:e] = np.asarray(out["f_stats"], dtype=np.float64)[:m]
        betas[s:e] = np.asarray(out["betas"], dtype=np.float64)[:m]
        var_perc[s:e] = np.asarray(out["var_perc"], dtype=np.float64)[:m]
        mask[s:e] = np.asarray(out["mask"])[:m]
        if checkpoint_dir:
            # atomic writes (tmp + os.replace): a SIGKILL mid-dump must
            # not leave a truncated manifest/tile that poisons the very
            # resume this checkpointing provides (review finding)
            tpath = tile_path(t)
            np.savez(tpath + ".tmp.npz", f_stats=f_stats[s:e],
                     betas=betas[s:e], var_perc=var_perc[s:e],
                     mask=mask[s:e])
            os.replace(tpath + ".tmp.npz", tpath)
            done.add(t)
            with open(mpath + ".tmp", "w") as f:
                json.dump({"done": sorted(done), "n_tiles": n_tiles,
                           "delta": float(null.delta)}, f)
            os.replace(mpath + ".tmp", mpath)

    # restore completed tiles
    todo = []
    for t in range(n_tiles):
        if checkpoint_dir and t in done and os.path.exists(tile_path(t)):
            s, e = t * tile, min((t + 1) * tile, M)
            with np.load(tile_path(t)) as z:
                f_stats[s:e] = z["f_stats"]
                betas[s:e] = z["betas"]
                var_perc[s:e] = z["var_perc"]
                mask[s:e] = z["mask"]
        else:
            todo.append(t)

    # ---- async pipelined streaming ----
    # host-side tile prep (memmap read, validation, imputation) runs in a
    # PREFETCH thread (models.source.prefetch_iter) so it overlaps the
    # previous tile's host->device transfer
    from mixmogam_tpu.models.source import prefetch_iter

    def prep(t):
        s, e = t * tile, min((t + 1) * tile, M)
        if int8_source:
            chunk = np.ascontiguousarray(
                np.asarray(matrix_source[s:e], dtype=np.int8))
            if int8_tier and chunk.min() < 0:
                raise ValueError(
                    f"rotate_in_bf16={rotate_in_bf16!r} requires a "
                    f"fully-observed genotype source (tile {t} has "
                    "missing dosages; mean-imputed fractions would be "
                    "rounded by the digit-plane cast). Use the "
                    "exact/bf16 tiers.")
            if e - s < tile:
                chunk = np.vstack(
                    [chunk, np.zeros((tile - (e - s), n), np.int8)])
            return "int8", chunk
        # float source: host-side per-SNP mean imputation (NaN = missing);
        # tiles hold complete SNP rows so the rule is tile-local
        chunk = _host_float_tile(matrix_source[s:e], dtype)
        if int8_tier and not np.array_equal(chunk, np.round(chunk)):
            raise ValueError(
                f"rotate_in_bf16={rotate_in_bf16!r} requires integer "
                f"dosages (tile {t} has fractional values). Use the "
                "exact/bf16 tiers.")
        if e - s < tile:
            chunk = np.vstack(
                [chunk, np.zeros((tile - (e - s), n), dtype)])
        return "float", chunk

    scan_jit = jax.jit(emmax_scan_stats)
    pending = []  # (tile_idx, device_out)
    with mp_ctx:
        for t, (kind, host_arr) in prefetch_iter(todo, prep):
            td = jnp.asarray(host_arr)
            if kind == "float":
                out = scan_jit(td, rot)
            else:
                out = (scan_jit(td, rot) if int8_tier
                       else _scan_tile_i8(td, rot))
            pending.append((t, out))
            if len(pending) >= inflight:
                t0, o0 = pending.pop(0)
                store(t0, jax.device_get(o0))
    for t0, o0 in pending:
        store(t0, jax.device_get(o0))

    return finalize_scan(matrix_source, null, dtype, f_stats, mask,
                         betas=betas, var_perc=var_perc,
                         with_betas=with_betas, rescore_top=rescore_top,
                         rd=rd, matmul_precision=matmul_precision,
                         tier_name=tier_name, dof=dof)
