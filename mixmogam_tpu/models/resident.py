"""Device-resident 2-bit genome container.

At BASELINE config #3 (1,048,576 SNPs x 10,240 samples) the int8 genome
is 10.7 GB; 2-bit packed it is 2.7 GB. ResidentGenome uploads the packed
rows ONCE; every subsequent phase (kinship, EMMAX scan, rescore,
repeated scans) is pure device compute: the per-tile unpack is a few
shift/masks fused ahead of the rotation matmul, so scans run at GEMM
rates instead of the host link's.

Reference equivalent: none (mixmogam is a single-process numpy library
— kinship.py re-reads its arrays from RAM each pass); this is the
device answer to SURVEY §2.3's SNP-axis streaming row at 4x
density, and the reason the 'rotate once, scan many' workloads
(stepwise forward steps, permutation rounds, EMMA grid) stop paying
the host link entirely.

Missing genotypes are stored as code 3 (-1 after unpack) and
mean-imputed ON DEVICE per tile (same rule as the streamed path);
fully-observed genomes keep the int8 digit-plane tiers available.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mixmogam_tpu.ops.pack2 import unpack_2bit_device
from mixmogam_tpu.ops.scan import emmax_scan_stats

#: packed-genome budget for auto-promotion, as a fraction of the device
#: memory limit: the scan additionally holds W (n^2 f32), one unpacked
#: int8 tile and its rotated f32 image (~1.5 GB at n=10k, tile=16k), and
#: the rescore and null model need room beside them
RESIDENT_FRACTION = 3 / 8
#: the budget on a backend that reports no memory limit (the CPU)
RESIDENT_BUDGET_BYTES = 6 << 30


def default_resident_budget() -> int:
    from mixmogam_tpu.models.source import device_budget

    return device_budget(RESIDENT_FRACTION, RESIDENT_BUDGET_BYTES)


def subdivide_tile(tile: int, target: int = 2048) -> int:
    """Largest divisor of `tile` <= target. Packed rows fix the outer
    tile granularity; kernels that hold several (tile, n) float
    intermediates per map step (anova/KW class sums, multi-env GxE)
    re-view the packed rows at this finer granularity to bound HBM."""
    sub = tile
    while sub > target and sub % 2 == 0:
        sub //= 2
    return sub


class ResidentGenome:
    """(M, n) int8 dosages held 2-bit packed in device HBM.

    Quacks like a read-only SNP-major matrix source: `.shape`, `.dtype`
    (int8), slicing/fancy row indexing return HOST int8 rows (with -1
    for missing) — so the rescore/stepwise utilities that fetch rows by
    index work unchanged.
    """

    def __init__(self, packed: jax.Array, M: int, n: int, ploidy: int,
                 tile: int, has_missing: bool,
                 host_packed: Optional[np.ndarray] = None):
        if packed.shape[0] % tile:
            raise ValueError("packed rows must be padded to the tile size")
        self.packed = packed
        self.M = int(M)
        self.n = int(n)
        self.ploidy = int(ploidy)
        self.tile = int(tile)
        self.has_missing = bool(has_missing)
        # host-side copy of the packed rows, kept when construction had
        # one anyway: lets multi-chip sharding re-distribute without a
        # device->host readback. Set to None to free the host RAM.
        self.host_packed = host_packed
        self._content_key: Optional[str] = None

    def content_key(self) -> str:
        """Stable content identity: sha256 of the packed rows (pad rows
        are deterministic zeros) + shape/tile. Keys the LOCO eigen cache
        and any other derived-artifact cache. One full pass over the
        packed bytes (~2.7 GB at 1M x 10k, a few seconds host CPU),
        computed lazily and memoized; prefers the retained host copy —
        without one the packed rows read back through the device link."""
        if self._content_key is None:
            import hashlib

            hp = (self.host_packed if self.host_packed is not None
                  else np.asarray(self.packed))
            h = hashlib.sha256()
            h.update(f"{self.M}:{self.n}:{self.tile}:".encode())
            h.update(np.ascontiguousarray(hp).tobytes())
            self._content_key = h.hexdigest()[:16]
        return self._content_key

    # ---- array-source protocol ----
    @property
    def shape(self) -> Tuple[int, int]:
        return (self.M, self.n)

    @property
    def dtype(self):
        return np.dtype(np.int8)

    @property
    def nbytes_packed(self) -> int:
        return int(self.packed.shape[0]) * int(self.packed.shape[1])

    def __len__(self) -> int:
        return self.M

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        """Full host decode to (M, n) int8 (-1 missing) — lets
        np.asarray(rg) feed host-side consumers (anova/KW class tests,
        oracle comparisons). O(M*n) host RAM: for the big-genome paths
        use the packed/tile APIs instead."""
        out = self[0:self.M]
        return out if dtype is None else out.astype(dtype)

    def __getitem__(self, key) -> np.ndarray:
        """Rows as HOST int8 (missing = -1). Slices and integer-array
        indexing only (what the rescore/tile utilities use)."""
        from mixmogam_tpu import native

        if isinstance(key, slice):
            s, e, step = key.indices(self.M)
            if step != 1:
                raise IndexError("ResidentGenome supports step-1 slices")
            rows = np.asarray(self.packed[s:e])
        else:
            idx = np.asarray(key)
            if idx.ndim != 1:
                raise IndexError("ResidentGenome supports 1-D row indexing")
            rows = np.asarray(jnp.take(self.packed, jnp.asarray(idx),
                                       axis=0))
        return native.unpack_2bit(rows, self.n)

    def slice_rows(self, s: int, e: int) -> "ResidentGenome":
        """Row range [s, e) as its own tile-padded container — a device
        copy of the packed slice only (~n/4 bytes per SNP row). Used by
        the LOCO per-chromosome scans/kinships: every resident entry
        point then works on the sub-genome with zero host traffic.
        Zero pad rows are degenerate in the scan (masked) and cancel in
        every kinship accumulation (real-row counts are explicit)."""
        if not (0 <= s < e <= self.M):
            raise ValueError(f"invalid row range [{s}, {e}) for "
                             f"M={self.M}")
        m = e - s
        m_pad = -(-m // self.tile) * self.tile
        sub = self.packed[s:e]
        if m_pad > m:
            sub = jnp.pad(sub, ((0, m_pad - m), (0, 0)))
        return ResidentGenome(sub, m, self.n, self.ploidy, self.tile,
                              self.has_missing)

    # ---- construction ----
    @classmethod
    def from_source(cls, G, tile: int = 16_384, chunk: int = 65_536,
                    ploidy: Optional[int] = None,
                    cache_path: Optional[str] = None,
                    trust_cache: bool = False,
                    upload: bool = True) -> "ResidentGenome":
        """Pack an int8 host source (ndarray / memmap / h5py /
        GenotypeData) chunk-by-chunk (C++ packer when available,
        ~930 MB/s) and upload the packed rows in ONE transfer.
        Rows are zero-padded to a tile multiple (dosage-0 pad rows are
        degenerate in the scan -> masked, and contribute zero to every
        kinship accumulation given m_eff counts real rows only).

        cache_path: persist/reuse the host-side packed rows (an .npy +
        .json sidecar). A repeat construction then reads 2 bits/genotype
        from disk instead of 8 — at the 1M x 10k scale that skips a
        10.7 GB memmap pass + re-pack (minutes on a cold page cache).
        The cache is keyed on CONTENT (a streaming sha256 of the source
        rows, folded into the pack pass at write time): a regenerated
        file with the same shape repacks instead of silently reusing the
        wrong genome (VERDICT r3 weak #5). Validating costs one full
        read of the source; trust_cache=True skips the content check
        (shape/tile/ploidy still enforced) for callers that own both
        files — e.g. a benchmark over a multi-GB memmap. G=None loads
        the cache as-is (explicit opt-in, nothing to hash against).

        upload=False keeps the packed rows HOST-side (self.packed is
        the numpy array): for mesh flows that shard per-chip from
        host_packed, where an eager whole-genome upload to the default
        device would waste ~35 s of link and pin GBs of HBM on one
        chip (review r5 #2). Single-device scans over such a container
        still work (jit uploads on first use), just without the
        one-upload guarantee."""
        import hashlib
        import json
        import os

        from mixmogam_tpu import native
        from mixmogam_tpu.models.source import resolve_source

        mat = None if G is None else resolve_source(G)
        if mat is not None and np.dtype(mat.dtype) != np.int8:
            raise TypeError(
                "ResidentGenome stores int8 dosages 0..2 (+ -1 missing); "
                f"got dtype {mat.dtype} — use the streamed path for "
                "float sources")
        src_hash = None
        meta_path = cache_path + ".json" if cache_path else None
        if cache_path and os.path.exists(cache_path) \
                and os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            # a cache is only trusted when it matches the request: same
            # tile, same source shape + CONTENT (when a source is
            # given), same explicit ploidy — otherwise silently
            # returning stale rows would run the study on the wrong
            # genome
            ok = (meta["tile"] == tile
                  and (mat is None
                       or tuple(mat.shape) == (meta["M"], meta["n"]))
                  and (ploidy is None or ploidy == meta["ploidy"]))
            if ok and mat is not None and not trust_cache:
                h = hashlib.sha256()
                for s in range(0, mat.shape[0], chunk):
                    h.update(np.ascontiguousarray(
                        np.asarray(mat[s:s + chunk], dtype=np.int8)
                    ).tobytes())
                src_hash = h.hexdigest()[:16]
                ok = meta.get("src_hash") == src_hash
            if ok:
                hp = np.asarray(np.load(cache_path, mmap_mode="r"))
                if upload:
                    packed = jnp.asarray(hp)
                    packed.block_until_ready()
                else:
                    packed = hp
                return cls(packed, meta["M"], meta["n"], meta["ploidy"],
                           tile, meta["has_missing"], host_packed=hp)
            if G is None:
                raise ValueError(
                    f"packed cache at {cache_path} does not match the "
                    f"request (meta={meta}, tile={tile}, "
                    f"ploidy={ploidy}) and no source was given to "
                    "repack from")
        if mat is None:
            # cache files absent (or the .json sidecar missing) with no
            # source: fail with the reason, not an AttributeError at
            # mat.shape below (review finding)
            raise ValueError(
                f"packed cache at {cache_path!r} is missing or has no "
                ".json sidecar, and no source was given to repack from")

        if ploidy is None:
            ploidy = getattr(G, "ploidy", None)
        M, n = mat.shape
        M_pad = -(-M // tile) * tile
        rb = (n + 3) // 4
        host_packed = np.zeros((M_pad, rb), dtype=np.uint8)
        has_missing = False
        vmax = 0
        # content hash folded into the pack pass (no second source
        # read); reuse the one computed during cache validation
        h = hashlib.sha256() if src_hash is None else None
        for s in range(0, M, chunk):
            e = min(s + chunk, M)
            c = np.ascontiguousarray(np.asarray(mat[s:e], dtype=np.int8))
            if h is not None:
                h.update(c.tobytes())
            has_missing |= bool((c < 0).any())
            vmax = max(vmax, int(c.max(initial=0)))
            host_packed[s:e] = native.pack_2bit(c)
        if src_hash is None:
            src_hash = h.hexdigest()[:16]
        if ploidy is None:
            ploidy = 2 if vmax > 1 else 1
        if cache_path:
            np.save(cache_path, host_packed)
            if not cache_path.endswith(".npy"):
                os.replace(cache_path + ".npy", cache_path)
            with open(meta_path, "w") as f:
                json.dump({"M": M, "n": n, "ploidy": int(ploidy),
                           "tile": tile, "has_missing": has_missing,
                           "src_hash": src_hash}, f)
        if upload:
            packed = jnp.asarray(host_packed)
            packed.block_until_ready()
        else:
            packed = host_packed
        return cls(packed, M, n, ploidy, tile, has_missing,
                   host_packed=host_packed)


# ---------------------------------------------------------------------------
# whole-genome scan from packed HBM: ONE dispatch, lax.map over tiles
# ---------------------------------------------------------------------------

@functools.partial(jax.jit,
                   static_argnames=("n", "tile", "impute", "pre_rotated"))
def emmax_scan_packed(packed: jnp.ndarray, rot, n: int, tile: int,
                      impute: bool = False, pre_rotated: bool = False
                      ) -> Dict[str, jnp.ndarray]:
    """EMMAX stats over a packed (M_pad, rb) genome resident in HBM.
    Each tile is unpacked (VPU shifts) directly in front of the rotation
    matmul; no host traffic. Pad rows are constant -> masked.
    pre_rotated=True treats unpacked dosages as already rotated (the
    identity-K / fixed-effects-only case: phi = 1s, no rotation)."""
    from mixmogam_tpu.models.streaming import _impute_tile

    T = packed.shape[0] // tile
    tiles = packed.reshape(T, tile, packed.shape[1])

    def kern(pt):
        Gt = unpack_2bit_device(pt, n)
        if impute or pre_rotated:
            Gt = _impute_tile(Gt, rot.sd.dtype)
        return emmax_scan_stats(Gt, rot, pre_rotated=pre_rotated)

    out = jax.lax.map(kern, tiles)
    return {k: v.reshape(T * tile) for k, v in out.items()}


def emmax_resident(rg: ResidentGenome, y, K=None, X0=None, eig_k=None,
                   ngrids: int = 100, llim: float = -10.0,
                   ulim: float = 10.0, esp: float = 1e-6,
                   with_betas: bool = True, dtype=None,
                   precision: Optional[str] = None,
                   rotate_in_bf16=False,
                   rescore_top: int = 0) -> Dict[str, np.ndarray]:
    """EMMAX over a ResidentGenome — models.emmax semantics (same return
    dict), with the scan sourced from packed HBM. Called by
    models.emmax's routing; usable directly for repeated scans over one
    upload. Missing genotypes impute on device per tile (int8 tiers
    refuse, as everywhere)."""
    import contextlib

    from mixmogam_tpu.models.emmax import _as_design
    from mixmogam_tpu.models.streaming import _exact_rescore
    from mixmogam_tpu.ops.reml import esp_to_refine_iters, fit_null_model
    from mixmogam_tpu.ops.scan import (build_rotated_null,
                                       normalize_rotate_tier,
                                       resolve_precision)

    y = np.asarray(y, dtype=np.float64).ravel()
    n = y.shape[0]
    if n != rg.n:
        raise ValueError(f"y has {n} samples but the resident genome "
                         f"holds {rg.n}")
    if dtype is None:
        dtype = jnp.zeros(0).dtype
    if str(precision) == "fast" and not rescore_top:
        rescore_top = 1024
    if X0 is None:
        X0 = np.ones((n, 1))
    X0 = _as_design(X0, n)
    matmul_precision, tier_name = None, None
    if precision is not None:
        if rotate_in_bf16:
            raise ValueError("pass either precision= or the legacy "
                             "rotate_in_bf16 kwarg, not both")
        # int8 tiers need fully-observed dosages; has_missing was
        # established during packing (no extra pass over the source)
        from mixmogam_tpu.ops.scan import probe_for_source

        rotate_in_bf16, matmul_precision, tier_name = resolve_precision(
            precision, G=probe_for_source(rg))
    rd = normalize_rotate_tier(rotate_in_bf16)
    if (isinstance(rd, str) and rd.startswith("int8") and rg.has_missing):
        raise ValueError(
            "int8 digit-plane tiers need fully-observed dosages; this "
            "resident genome has missing genotypes (device-imputed to "
            "fractions). Use precision='exact'/'bf16' instead.")
    # 'fast' also takes the f32 host eigh (ssyevd, measured 1.45x) when the
    # decomposition has not been supplied — reported p-values remain
    # exact-grade via the rescore pass
    null = fit_null_model(y.astype(dtype), X0.astype(dtype), K=K,
                          eig_k=eig_k, ngrids=ngrids, llim=llim, ulim=ulim,
                          refine_iters=esp_to_refine_iters(
                              esp, ngrids, llim, ulim),
                          eigh_dtype=(np.float32
                                      if str(precision) == "fast"
                                      else None))
    rot = build_rotated_null(null, rotate_dtype=rd)
    ctx = (jax.default_matmul_precision(matmul_precision)
           if matmul_precision else contextlib.nullcontext())
    # tier-dependent scan granularity (XLA dispatch granularity, not a
    # kernel block; the sweep on the GPU is still open): the quantized
    # tiers scan 8,192 rows per step, the exact fp32 tier the
    # container's 16,384 — the packed row padding stays at rg.tile,
    # any divisor re-views it
    scan_tile = (rg.tile if rd is None and not matmul_precision
                 else subdivide_tile(rg.tile, 8192))
    with ctx:
        d = emmax_scan_packed(rg.packed, rot, rg.n, scan_tile,
                              impute=rg.has_missing)
    M = rg.M
    from mixmogam_tpu.models.streaming import finalize_scan

    return finalize_scan(
        rg, null, dtype,
        np.array(d["f_stats"], dtype=np.float64)[:M],
        np.array(d["mask"])[:M],
        betas=(np.array(d["betas"], dtype=np.float64)[:M]
               if with_betas else None),
        var_perc=(np.array(d["var_perc"], dtype=np.float64)[:M]
                  if with_betas else None),
        with_betas=with_betas, rescore_top=rescore_top, rd=rd,
        matmul_precision=matmul_precision, tier_name=tier_name,
        dof=int(rot.dof))


# ---------------------------------------------------------------------------
# kinship from packed HBM (reuses the streamed update kernels; the only
# difference is where tiles come from — a device dynamic-slice + unpack
# instead of a host transfer)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("tile", "n"))
def _tile_from_packed(packed: jnp.ndarray, s, tile: int, n: int
                      ) -> jnp.ndarray:
    pt = jax.lax.dynamic_slice_in_dim(packed, s, tile, axis=0)
    return unpack_2bit_device(pt, n)


@functools.partial(jax.jit, static_argnames=("tile", "n"))
def _tile_from_packed_cols(packed: jnp.ndarray, s, tile: int, n: int,
                           cols: jnp.ndarray) -> jnp.ndarray:
    """Unpack a tile and gather a SAMPLE subset on device (multi-trait
    missingness-pattern groups scan a column subset of the container —
    VERDICT r3 #7: no host decode). Returns raw int8 (missing = -1);
    impute after the gather so subset means match the host path."""
    pt = jax.lax.dynamic_slice_in_dim(packed, s, tile, axis=0)
    return jnp.take(unpack_2bit_device(pt, n), cols, axis=1)


@functools.partial(jax.jit, static_argnames=("n", "tile", "M", "ploidy"))
def _ibs_resident_fused(packed: jnp.ndarray, n: int, tile: int, M: int,
                        ploidy: int) -> jnp.ndarray:
    """Fully-observed int8 IBS accumulation as ONE dispatch: fori_loop
    over tiles inside jit (no per-tile host round trip; the whole
    1M-SNP gram is one program).

    The loop body is grams ONLY (every term of the IBS identity is
    additive over SNP tiles, and dosage-0 pad rows contribute zero to
    each of them), so the n x n rank-1/epilogue algebra runs ONCE after
    the loop instead of per tile — the per-tile work is pure int8 GEMM
    (precision: ops.kinship._INT8_PREC)."""
    from mixmogam_tpu.ops.kinship import _INT8_PREC

    T = packed.shape[0] // tile
    dims = (((0,), (0,)), ((), ()))

    if ploidy == 1:
        def body(i, carry):
            CtC, s = carry
            pt = jax.lax.dynamic_slice_in_dim(packed, i * tile, tile,
                                              axis=0)
            Gt = unpack_2bit_device(pt, n)
            CtC = CtC + jax.lax.dot_general(
                Gt, Gt, dims, preferred_element_type=jnp.int32,
                precision=_INT8_PREC)
            s = s + jnp.sum(Gt.astype(jnp.int32), axis=0,
                            dtype=jnp.int32)
            return CtC, s

        CtC, s = jax.lax.fori_loop(
            0, T, body, (jnp.zeros((n, n), jnp.int32),
                         jnp.zeros((n,), jnp.int32)))
        # sharing counts: sum over SNPs of [a==b] for a,b in {0,1}
        return 2 * CtC - s[:, None] - s[None, :] + jnp.int32(M)

    def body(i, carry):
        CtC, corr, a2 = carry
        pt = jax.lax.dynamic_slice_in_dim(packed, i * tile, tile, axis=0)
        Gt = unpack_2bit_device(pt, n)
        CtC = CtC + jax.lax.dot_general(
            Gt, Gt, dims, preferred_element_type=jnp.int32,
            precision=_INT8_PREC)
        W0 = (Gt == 0).astype(jnp.int8)
        W2 = (Gt == 2).astype(jnp.int8)
        corr = corr + jax.lax.dot_general(
            W0, W2, dims, preferred_element_type=jnp.int32,
            precision=_INT8_PREC)
        a2 = a2 + jnp.sum((Gt * Gt).astype(jnp.int32), axis=0,
                          dtype=jnp.int32)
        return CtC, corr, a2

    CtC, corr, a2 = jax.lax.fori_loop(
        0, T, body, (jnp.zeros((n, n), jnp.int32),
                     jnp.zeros((n, n), jnp.int32),
                     jnp.zeros((n,), jnp.int32)))
    # TWICE the per-pair sharing: 2*M - sum|a-b|, with
    # |a-b| = (a-b)^2 - 2([a=0][b=2] + [a=2][b=0]) for a,b in {0,1,2}
    absd = a2[:, None] + a2[None, :] - 2 * CtC - 2 * (corr + corr.T)
    return 2 * jnp.int32(M) - absd


@functools.partial(jax.jit, static_argnames=("n", "tile", "ploidy"))
def _ibs_resident_fused_range(packed: jnp.ndarray, s, e, n: int,
                              tile: int, ploidy: int) -> jnp.ndarray:
    """Fully-observed int8 IBS sharing counts for the row RANGE [s, e)
    of a packed genome, as ONE dispatch with TRACED bounds — so LOCO's
    22 per-chromosome grams share a single compile (per-chromosome
    shapes would otherwise each recompile the fused kernel). Rows
    outside the
    range are zeroed before the accumulations; zero rows contribute
    nothing to any term (the pad-row identity), and the final constant
    uses the range's true row count."""
    from mixmogam_tpu.ops.kinship import _INT8_PREC

    dims = (((0,), (0,)), ((), ()))
    t0 = s // tile
    t1 = (e - 1) // tile + 1
    Mr = (e - s).astype(jnp.int32)

    def masked_tile(i):
        base = i * tile
        pt = jax.lax.dynamic_slice_in_dim(packed, base, tile, axis=0)
        Gt = unpack_2bit_device(pt, n)
        rows = base + jnp.arange(tile, dtype=s.dtype)
        rm = ((rows >= s) & (rows < e)).astype(jnp.int8)[:, None]
        return Gt * rm

    if ploidy == 1:
        def body(i, carry):
            CtC, sm = carry
            Gt = masked_tile(i)
            CtC = CtC + jax.lax.dot_general(
                Gt, Gt, dims, preferred_element_type=jnp.int32,
                precision=_INT8_PREC)
            sm = sm + jnp.sum(Gt.astype(jnp.int32), axis=0,
                              dtype=jnp.int32)
            return CtC, sm

        CtC, sm = jax.lax.fori_loop(
            t0, t1, body, (jnp.zeros((n, n), jnp.int32),
                           jnp.zeros((n,), jnp.int32)))
        return 2 * CtC - sm[:, None] - sm[None, :] + Mr

    def body(i, carry):
        CtC, corr, a2 = carry
        Gt = masked_tile(i)
        CtC = CtC + jax.lax.dot_general(
            Gt, Gt, dims, preferred_element_type=jnp.int32,
            precision=_INT8_PREC)
        # masked rows are all-zero: W0 is 1 there but pairs with W2 = 0
        # on the same row, so every cross term still vanishes
        W0 = (Gt == 0).astype(jnp.int8)
        W2 = (Gt == 2).astype(jnp.int8)
        corr = corr + jax.lax.dot_general(
            W0, W2, dims, preferred_element_type=jnp.int32,
            precision=_INT8_PREC)
        a2 = a2 + jnp.sum((Gt * Gt).astype(jnp.int32), axis=0,
                          dtype=jnp.int32)
        return CtC, corr, a2

    CtC, corr, a2 = jax.lax.fori_loop(
        t0, t1, body, (jnp.zeros((n, n), jnp.int32),
                       jnp.zeros((n, n), jnp.int32),
                       jnp.zeros((n,), jnp.int32)))
    absd = a2[:, None] + a2[None, :] - 2 * CtC - 2 * (corr + corr.T)
    return 2 * Mr - absd


def kinship_resident_range(rg: ResidentGenome, s: int, e: int,
                           method: str = "ibs",
                           ploidy: Optional[int] = None,
                           return_den: bool = False):
    """Kinship over the SNP row range [s, e) of a resident genome
    (LOCO's per-chromosome grams). Fully-observed IBS rides the
    range-masked fused kernel — one compile for every chromosome;
    everything else takes a tile-padded slice (per-shape compiles)."""
    if not (0 <= s < e <= rg.M):
        raise ValueError(f"invalid row range [{s}, {e}) for M={rg.M}")
    ploidy = rg.ploidy if ploidy is None else ploidy
    if method == "ibs" and not rg.has_missing:
        S = np.asarray(_ibs_resident_fused_range(
            rg.packed, jnp.asarray(s, jnp.int32),
            jnp.asarray(e, jnp.int32), rg.n, rg.tile,
            ploidy)).astype(np.float64)
        m = e - s
        Kh = S / m if ploidy == 1 else S / (2.0 * m)
        return (Kh, float(m)) if return_den else Kh
    return kinship_resident(rg.slice_rows(s, e), method=method,
                            ploidy=ploidy, return_den=return_den)


def kinship_resident(rg: ResidentGenome, method: str = "ibs",
                     ploidy: Optional[int] = None,
                     dtype=jnp.float32, return_den: bool = False):
    """Kinship from a ResidentGenome: tiles are sliced+unpacked on device
    and fed to the SAME accumulation kernels as the streamed path
    (ops.kinship) — zero host traffic, device gram at the int8 GEMM
    rate.
    Zero pad rows cancel in every update given m_eff counts real rows.

    return_den=True also returns the normalization denominator
    (VanRaden: ploidy * sum p(1-p); IBS: the SNP count) — what LOCO's
    gram-subtraction identity needs (models/loco.py)."""
    from mixmogam_tpu.models.streaming import _impute_tile
    from mixmogam_tpu.ops.kinship import (_ibs_binary_update,
                                          _ibs_diploid_update,
                                          _vanraden_update)

    ploidy = rg.ploidy if ploidy is None else ploidy
    M, n, tile = rg.M, rg.n, rg.tile
    T = rg.packed.shape[0] // tile
    meffs = [min(M - i * tile, tile) for i in range(T)]

    if method in ("vanraden", "ibd"):
        K = jnp.zeros((n, n), dtype=dtype)
        denom = 0.0

        @functools.partial(jax.jit, static_argnames=("m_eff",))
        def vr_tile(Gt, m_eff: int):
            C = _impute_tile(Gt, dtype) if rg.has_missing \
                else Gt.astype(dtype)
            rm = (jnp.arange(tile) < m_eff).astype(dtype)[:, None]
            C = C * rm
            p = jnp.sum(C, axis=1) / (ploidy * n)
            dn = ploidy * jnp.sum(p * (1.0 - p) * rm[:, 0])
            W = (C - (ploidy * p)[:, None]) * rm
            return W, dn

        for i in range(T):
            Gt = _tile_from_packed(rg.packed, jnp.asarray(i * tile,
                                                          jnp.int32),
                                   tile, n)
            W, dn = vr_tile(Gt, meffs[i])
            K = _vanraden_update(K, W)
            denom += float(dn)
        Kh = np.asarray(K).astype(np.float64) / denom
        return (Kh, denom) if return_den else Kh
    if method != "ibs":
        raise ValueError(f"unknown kinship method {method!r}")

    if not rg.has_missing:
        S = np.asarray(_ibs_resident_fused(
            rg.packed, n, tile, M, ploidy)).astype(np.float64)
        Kh = S / M if ploidy == 1 else S / (2.0 * M)
        return (Kh, float(M)) if return_den else Kh

    # missing genotypes: device-imputed float accumulation (same rule
    # as the streamed float path)
    K = jnp.zeros((n, n), dtype=dtype)

    @functools.partial(jax.jit, static_argnames=("m_eff",))
    def prep(Gt, m_eff: int):
        C = _impute_tile(Gt, dtype)
        rm = (jnp.arange(tile) < m_eff).astype(dtype)[:, None]
        C = C * rm
        if ploidy == 1:
            return (C,)
        W0 = jnp.clip(1.0 - jnp.abs(C - 0.0), 0.0, None) * rm
        W2 = jnp.clip(1.0 - jnp.abs(C - 2.0), 0.0, None) * rm
        return C, W0, W2

    for i in range(T):
        Gt = _tile_from_packed(rg.packed, jnp.asarray(i * tile, jnp.int32),
                               tile, n)
        parts = prep(Gt, meffs[i])
        if ploidy == 1:
            K = _ibs_binary_update(K, parts[0], float(meffs[i]))
        else:
            K = _ibs_diploid_update(K, *parts, float(meffs[i]))
    Kh = np.asarray(K).astype(np.float64) / M
    return (Kh, float(M)) if return_den else Kh


def rotate_resident_to_device(rg: ResidentGenome, U=None, dtype=None
                              ) -> jnp.ndarray:
    """G_rot = impute(G) @ U built tile-by-tile from packed HBM (the
    'rotate once, scan many' asset for stepwise/EMMA/permutation) —
    like models.streaming.rotate_streamed_to_device but with zero host
    traffic. U=None skips the matmul and materializes the imputed float
    dosages themselves (the identity-K case)."""
    if dtype is None:
        dtype = jnp.zeros(0).dtype
    from mixmogam_tpu.models.streaming import _impute_tile

    M, n, tile = rg.M, rg.n, rg.tile
    Ud = None if U is None else jnp.asarray(U, dtype=dtype)
    T = rg.packed.shape[0] // tile

    @functools.partial(jax.jit, donate_argnums=(0,),
                       static_argnames=("impute", "m_keep"))
    def upd(out, packed, Ud, i, impute: bool, m_keep: int):
        pt = jax.lax.dynamic_slice_in_dim(packed, i * tile, tile, axis=0)
        Gt = unpack_2bit_device(pt, n)
        td = _impute_tile(Gt, out.dtype) if impute else Gt.astype(out.dtype)
        rot = td if Ud is None else jnp.dot(td, Ud,
                                            preferred_element_type=out.dtype)
        # out is exactly (M, n): the last tile writes only its real rows
        # (a full-tile update would clamp the start and smear pad rows
        # over earlier SNPs; slicing out[:M] afterwards would copy the
        # multi-GB rotation)
        return jax.lax.dynamic_update_slice(
            out, rot[:m_keep], (i * tile, jnp.zeros((), i.dtype)))

    out = jnp.zeros((M, n), dtype=dtype)
    for i in range(T):
        m_keep = min(M - i * tile, tile)
        out = upd(out, rg.packed, Ud, jnp.asarray(i, jnp.int32),
                  rg.has_missing, m_keep)
    return out
