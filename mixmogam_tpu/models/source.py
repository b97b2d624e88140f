"""Shared host-genotype-source plumbing for the streamed model paths
(emmax/emma/multi-trait/rotation): source normalization, the
device-footprint streaming decision, and per-tile fetch+impute —
extracted so the big-M routing cannot drift between entry points."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def resolve_source(G):
    """GenotypeData -> its int8 matrix; lazy array-likes (ndarray,
    np.memmap, h5py datasets) pass through unmaterialized."""
    if hasattr(G, "matrix"):
        return G.matrix
    if hasattr(G, "shape") and hasattr(G, "dtype"):
        return G
    return np.asarray(G)


def device_budget(fraction: float, fallback: int) -> int:
    """`fraction` of the default device's memory limit
    (memory_stats()['bytes_limit']), or `fallback` bytes on a backend
    that reports no limit (the CPU)."""
    import jax

    limit = (jax.devices()[0].memory_stats() or {}).get("bytes_limit")
    return int(fraction * limit) if limit else fallback


def should_stream(G_src, n: int, dtype, budget_bytes: int) -> bool:
    """True when the in-core scan's device footprint (G + the rotated
    G @ W at compute dtype) would exceed the budget."""
    g_item = (1 if np.dtype(G_src.dtype) == np.int8
              else np.dtype(dtype).itemsize)
    return (G_src.shape[0] * n * (np.dtype(dtype).itemsize + g_item)
            > budget_bytes)


def pack_for_mesh(G_src, n: int, what: str):
    """Big-source routing for mesh= paths (mirrors models.emmax): an
    int8 source within the 2-bit resident budget packs HOST-side
    (upload=False — the sharded path uploads per-chip shards, never the
    whole genome to one device); anything else is refused. Shared by
    emmax_multi_trait and emma (review r5-cont #6)."""
    from mixmogam_tpu.models.resident import (ResidentGenome,
                                              default_resident_budget)

    if (np.dtype(G_src.dtype) == np.int8
            and G_src.shape[0] * ((n + 3) // 4) <= default_resident_budget()):
        return ResidentGenome.from_source(G_src, upload=False)
    raise ValueError(
        f"the mesh {what} path shards in-core or packed sources; this "
        "source exceeds both the in-core and the 2-bit resident budgets")


def prefetch_iter(keys, prep, lookahead: int = 2):
    """Yield (key, prep(key)) in order with prep running `lookahead`
    items ahead in ONE worker thread — host-side tile prep (memmap read,
    padding, 2-bit pack) overlaps the consumer's host->device transfer
    because numpy and the ctypes packer release the GIL. Shared by the
    streamed scan and kinship paths so the lookahead/ordering logic
    cannot drift between them. A prep exception propagates at the
    corresponding yield; remaining submitted futures are drained by the
    executor's context exit."""
    from concurrent.futures import ThreadPoolExecutor

    keys = list(keys)
    with ThreadPoolExecutor(max_workers=1) as ex:
        futs = {k: ex.submit(prep, k) for k in keys[:lookahead]}
        for i, k in enumerate(keys):
            for k_next in keys[i + lookahead:i + lookahead + 1]:
                futs[k_next] = ex.submit(prep, k_next)
            yield k, futs.pop(k).result()


def fetch_tile(G_src, s: int, e: int, tile: int, n: int,
               dtype) -> jnp.ndarray:
    """One (tile, n) float tile on device from a host source: int8
    sources ship as int8 and mean-impute ON DEVICE; float sources
    mean-impute per tile on host (NaN = missing). Rows past e are
    zero-padded to the static tile shape."""
    from mixmogam_tpu.models.streaming import _host_float_tile, _impute_tile

    if np.dtype(G_src.dtype) == np.int8:
        chunk = np.ascontiguousarray(np.asarray(G_src[s:e], dtype=np.int8))
        if e - s < tile:
            chunk = np.vstack(
                [chunk, np.zeros((tile - (e - s), n), np.int8)])
        return _impute_tile(jnp.asarray(chunk), np.dtype(dtype).name)
    chunk = _host_float_tile(G_src[s:e], np.dtype(dtype))
    if e - s < tile:
        chunk = np.vstack(
            [chunk, np.zeros((tile - (e - s), n), np.dtype(dtype))])
    return jnp.asarray(chunk)
