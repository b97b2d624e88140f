"""EMMA exact scan: per-SNP variance-component re-estimation
(SURVEY.md A.4, §3.3; reference: linear_models.emma — the per-SNP
eigh+REML Python loop, here a batched grid/bisection over SNP tiles with
NO per-SNP eigendecomposition; see ops.xreml for the algebra).

Per SNP j the model is y = [X0, g_j] b + u + e with its OWN delta_j:
  1. delta_j by REML (grid + refine, reference defaults),
  2. F-test of g_j at delta_j: F = (rss0_j - rss1_j)/(rss1_j/(n-q-1))
     with both RSS evaluated by GLS at delta_j,
  3. optionally an LRT against the null ML fit (test='lrt').
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mixmogam_tpu.models.emmax import (_as_design, _as_dosage,
                                       default_stream_budget)
from mixmogam_tpu.ops.eigen import eigen_k
from mixmogam_tpu.ops.reml import fit_null_model
from mixmogam_tpu.ops.stats import f_sf_host, chi2_sf_host
from mixmogam_tpu.ops.xreml import (
    chol_small, chol_solve_small, chol_logdet_small, emma_delta_scan,
    _snp_moments, _assemble,
)


@jax.jit
def _logdet_xtx_tile(Gt, X0_rot):
    """ln|[X0 g]'[X0 g]| per SNP (U orthogonal => computable rotated)."""
    q = X0_rot.shape[1]
    A00 = X0_rot.T @ X0_rot
    a01 = Gt @ X0_rot
    a11 = jnp.sum(Gt * Gt, axis=1)
    A, _, _ = _assemble(A00, jnp.zeros(q, Gt.dtype), jnp.zeros((), Gt.dtype),
                        a01, a11, jnp.zeros_like(a11))
    return chol_logdet_small(chol_small(A))


@jax.jit
def _f_stats_at_delta(Gt, X0_rot, y_rot, phi, log_delta, ypy):
    """rss0 at the per-SNP delta (null GLS) + collinearity mask."""
    d = jnp.exp(log_delta)[:, None]
    w = 1.0 / (phi[None, :] + d)
    A00, b0, c, a01, a11, b1 = _snp_moments(Gt, X0_rot, y_rot, w)
    L0 = chol_small(A00)
    t = chol_solve_small(L0, b0)
    rss0 = c - jnp.sum(b0 * t, axis=-1)
    s = chol_solve_small(L0, a01)
    xx = a11 - jnp.sum(a01 * s, axis=-1)
    eps = 100.0 * jnp.finfo(Gt.dtype).eps
    mask = xx > eps * jnp.maximum(a11, jnp.finfo(Gt.dtype).tiny)
    return rss0, mask


def _emma_tile_stats(Gt_raw, U, X0_rot, y_rot, phi, ngrids: int,
                     llim: float, ulim: float, reml: bool,
                     refine_iters: int, n: int, q: int):
    """One tile of the EMMA exact pipeline (rotate -> grid+refine
    delta_j -> F at delta_j) — the SINGLE definition shared by the
    single-device host loop and the shard_map mesh kernel (review
    r5-cont #5: the two copies would silently diverge)."""
    Gt = Gt_raw @ U
    ld_xtx = _logdet_xtx_tile(Gt, X0_rot)
    r = emma_delta_scan(Gt, X0_rot, y_rot, phi, ld_xtx,
                        ngrids=ngrids, llim=llim, ulim=ulim,
                        reml=reml, refine_iters=refine_iters)
    rss0, mask = _f_stats_at_delta(Gt, X0_rot, y_rot, phi,
                                   r["log_delta"], r["ypy"])
    rss1 = r["ypy"]
    dof = n - q - 1
    f = ((rss0 - rss1) * dof
         / jnp.maximum(rss1, jnp.finfo(Gt.dtype).tiny))
    f = jnp.where(mask, jnp.maximum(f, 0.0), 0.0)
    return {"delta": r["delta"], "ll": r["ll"], "f": f,
            "beta": r["beta"][:, -1], "mask": mask}


#: jitted mesh programs, keyed on everything shaping the trace — a
#: repeated-call campaign traces once, not per call (review r5-cont #4)
_EMMA_MESH_CACHE: Dict = {}


def _emma_mesh_jit(mesh, n: int, q: int, tile: int, ngrids: int,
                   llim: float, ulim: float, reml: bool,
                   refine_iters: int, resident: bool, impute: bool, dt):
    """Jitted shard_map program for the SNP-sharded EMMA exact scan
    (mesh= on emma): the eigenbasis + null quantities replicate, each
    device runs the batched per-SNP REML pipeline over its row shard,
    tile by tile under lax.map (the grid evaluation holds (tile, n)
    weight intermediates — whole-shard at once would blow HBM). Per-SNP
    REML is embarrassingly parallel: zero communication until the
    result gather."""
    from jax.sharding import PartitionSpec as P

    key = (mesh, n, q, tile, ngrids, llim, ulim, reml, refine_iters,
           resident, impute, jnp.dtype(dt).name)
    fn = _EMMA_MESH_CACHE.get(key)
    if fn is not None:
        return fn
    from mixmogam_tpu.models.streaming import _impute_tile
    from mixmogam_tpu.ops.pack2 import unpack_2bit_device

    def body(rows_loc, U, X0_rot, y_rot, phi):
        nt = rows_loc.shape[0] // tile
        tiles = rows_loc.reshape(nt, tile, rows_loc.shape[1])

        def kern(rt):
            if resident:
                Gt_raw = unpack_2bit_device(rt, n)
                Gt_raw = (_impute_tile(Gt_raw, dt) if impute
                          else Gt_raw.astype(dt))
            else:
                Gt_raw = rt
            return _emma_tile_stats(Gt_raw, U, X0_rot, y_rot, phi,
                                    ngrids, llim, ulim, reml,
                                    refine_iters, n, q)

        out = jax.lax.map(kern, tiles)
        return {k: v.reshape(nt * tile) for k, v in out.items()}

    fn = jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P("snp", None), P(), P(), P(), P()),
        out_specs=P("snp")))
    _EMMA_MESH_CACHE[key] = fn
    return fn


def emma(G, y, K=None, X0: Optional[np.ndarray] = None,
         eig_k: Optional[Tuple] = None, ngrids: int = 100,
         llim: float = -10.0, ulim: float = 10.0, esp: float = 1e-6,
         tile: int = 2048, dtype=None, test: str = "f",
         stream_budget_bytes: Optional[int] = None,
         mesh=None) -> Dict[str, np.ndarray]:
    """EMMA exact scan. Same signature family as emmax(); additionally
    returns per-SNP 'deltas' and 'pseudo_heritabilities'. Sources larger
    than stream_budget_bytes stream SNP tiles from host (the per-tile
    cost is rotation-dominated, so streaming costs the same matmuls).

    mesh: a ('snp', 1) device mesh SNP-shards the scan — per-SNP REML
    is embarrassingly parallel, so each chip runs the batched
    grid+refine over its row shard (in-core rows, or packed shards for
    a ResidentGenome / big int8 source auto-packed host-side) with one
    gather at the end. Parity-tested against the single-device scan."""
    from mixmogam_tpu.ops.reml import esp_to_refine_iters

    refine_iters = esp_to_refine_iters(esp, ngrids, llim, ulim)
    y = np.asarray(y, dtype=np.float64).ravel()
    n = y.shape[0]
    if dtype is None:
        dtype = jnp.zeros(0).dtype
    from mixmogam_tpu.models.resident import ResidentGenome
    from mixmogam_tpu.models.source import resolve_source, should_stream

    rg = G if isinstance(G, ResidentGenome) else None
    G_src = resolve_source(G)
    M = G_src.shape[0]
    if stream_budget_bytes is None:
        stream_budget_bytes = default_stream_budget()
    streamed = (False if rg is not None
                else should_stream(G_src, n, dtype, stream_budget_bytes))
    if mesh is not None:
        # validate the mesh BEFORE any whole-genome host pack (a 2-D
        # mesh must fail in milliseconds, not after packing 2.7 GB)
        if mesh.shape["sample"] != 1:
            raise ValueError("mesh-distributed EMMA shards 'snp' only; "
                             "use a ('snp', 1) mesh")
        if streamed:
            from mixmogam_tpu.models.source import pack_for_mesh

            rg = pack_for_mesh(G_src, n, "EMMA")
            streamed = False
    Gf = None if (streamed or rg is not None) else _as_dosage(G, dtype)
    if X0 is None:
        X0 = np.ones((n, 1))
    X0 = _as_design(X0, n)
    q = X0.shape[1]
    if eig_k is None:
        phi, U = eigen_k(K, host=True)
    else:
        phi, U = eig_k
    phi = jnp.asarray(phi, dtype=dtype)
    U = jnp.asarray(U, dtype=dtype)
    y_rot = U.T @ jnp.asarray(y, dtype=dtype)
    X0_rot = U.T @ jnp.asarray(X0, dtype=dtype)
    reml = test != "lrt"
    if test == "lrt":
        null = fit_null_model(y.astype(np.dtype(dtype).name), X0, eig_k=(phi, U),
                              ngrids=ngrids, llim=llim, ulim=ulim, ml=True)
        ll_null = float(null.ll)

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from mixmogam_tpu.parallel.mesh import (gather_if_multiprocess,
                                                pad_to_multiple,
                                                put_global, replicated)

        if rg is not None:
            from mixmogam_tpu.parallel.distributed import shard_packed_rows

            tile = rg.tile
            rows = shard_packed_rows(rg, mesh, tile)
        else:
            # cap the per-shard tile at the shard's row count (a tiny M
            # must not pad to nshard * default-tile rows of dead work)
            tile = min(tile, max(-(-M // mesh.shape["snp"]), 8))
            Gp, _ = pad_to_multiple(np.asarray(Gf),
                                    mesh.shape["snp"] * tile, axis=0)
            rows = put_global(Gp, NamedSharding(mesh, P("snp", None)))
        fn = _emma_mesh_jit(
            mesh, n, q, tile, ngrids, llim, ulim, reml, refine_iters,
            rg is not None,
            bool(rg.has_missing) if rg is not None else False, dtype)
        rep = replicated(mesh)
        args = tuple(put_global(v, rep)
                     for v in (U, X0_rot, y_rot, phi))
        d = gather_if_multiprocess(fn(rows, *args), mesh)
        deltas = np.asarray(d["delta"], dtype=np.float64)[:M]
        lls = np.asarray(d["ll"], dtype=np.float64)[:M]
        fstats = np.asarray(d["f"], dtype=np.float64)[:M]
        betas = np.asarray(d["beta"], dtype=np.float64)[:M]
        masks = np.asarray(d["mask"])[:M].astype(bool)
    else:
        deltas = np.empty(M)
        lls = np.empty(M)
        fstats = np.empty(M)
        betas = np.empty(M)
        masks = np.empty(M, dtype=bool)
        Gd = None if (streamed or rg is not None) else jnp.asarray(Gf)
        if rg is not None:
            tile = rg.tile  # packed rows pad to this granularity
        for s in range(0, M, tile):
            e = min(s + tile, M)
            if rg is not None:
                from mixmogam_tpu.models.resident import _tile_from_packed
                from mixmogam_tpu.models.streaming import _impute_tile

                Gt_raw = _tile_from_packed(rg.packed,
                                           jnp.asarray(s, jnp.int32),
                                           rg.tile, n)
                Gt_raw = (_impute_tile(Gt_raw, dtype) if rg.has_missing
                          else Gt_raw.astype(dtype))
            elif streamed:
                from mixmogam_tpu.models.source import fetch_tile

                Gt_raw = fetch_tile(G_src, s, e, tile, n, dtype)
            else:
                Gt_raw = Gd[s:e]
                if e - s < tile:  # pad to the static tile shape
                    Gt_raw = jnp.pad(Gt_raw,
                                     ((0, tile - (e - s)), (0, 0)))
            r = _emma_tile_stats(Gt_raw, U, X0_rot, y_rot, phi, ngrids,
                                 llim, ulim, reml, refine_iters, n, q)
            m = e - s
            deltas[s:e] = np.asarray(r["delta"])[:m]
            lls[s:e] = np.asarray(r["ll"])[:m]
            fstats[s:e] = np.asarray(r["f"])[:m]
            betas[s:e] = np.asarray(r["beta"])[:m]
            masks[s:e] = np.asarray(r["mask"])[:m]

    out = {"f_stats": fstats, "deltas": deltas, "betas": betas,
           "mask": masks, "lls": lls,
           "pseudo_heritabilities": 1.0 / (1.0 + deltas)}
    if test == "lrt":
        lrt = np.maximum(2.0 * (lls - ll_null), 0.0)
        out["ps"] = np.where(masks, chi2_sf_host(lrt, 1.0), 1.0)
        out["lrt_stats"] = lrt
    else:
        out["ps"] = np.where(masks, f_sf_host(fstats, 1.0, n - q - 1), 1.0)
    return out
