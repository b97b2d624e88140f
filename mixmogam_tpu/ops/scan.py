"""The EMMAX scan core — fully vectorized rotated-GLS F-tests
(SURVEY.md A.3; reference: linear_models.emmax_f_test's per-SNP Python
loop of lstsq calls, here ONE fused tile computation with no marker loop).

Device design
-------------
Everything happens in the eigenbasis of K. With eigh(K) = (phi, U) and the
null REML delta:

  W  = U * (1/sqrt(phi+delta))      (n, n)  'rotate + whiten' operator
  Xs = G_tile @ W                   (m, n)  whitened SNPs — ONE GEMM
  c  = Xs @ Q0                      (m, q)  projections on null design
  xy = Xs @ y_res                   (m,)
  xx = row_sum(Xs^2) - row_sum(c^2)
  F  = (xy^2/xx) * dof / (rss0 - xy^2/xx)

Algebraically identical to the reference's per-SNP lstsq (A.3 step 4: the
residualized-regressor identity), but the per-tile cost is one (m,n)x(n,n)
matmul + elementwise — a library GEMM for the rotation and an epilogue
that XLA fuses. Degenerate (monomorphic/collinear) SNPs are
handled by mask-and-zero discipline instead of the reference's
filter-then-loop (SURVEY.md §7).

If genotype tiles are PRE-rotated (G_rot = G @ U stored once), pass
pre_rotated=True: the scan drops to elementwise + (m,q) matmuls — pure
memory-bandwidth bound, which is what makes stepwise/multi-trait/EMMA scans
(many scans over one rotation) cheap.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict

import jax
import jax.numpy as jnp

from mixmogam_tpu.ops.kinship import _INT8_PREC
from mixmogam_tpu.ops.reml import NullModel


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class RotatedNull:
    """Scan-phase constants (replicated across chips in sharded runs)."""

    W: jnp.ndarray        # (n, n) U * 1/sqrt(phi+delta) — rotate+whiten
    sd: jnp.ndarray       # (n,) 1/sqrt(phi+delta) (for pre-rotated tiles)
    Q0: jnp.ndarray       # (n, q) orthonormal basis of whitened null design
                          #   (zero-padded columns allowed: they contribute
                          #    nothing, letting stepwise keep ONE scan
                          #    compile across steps of growing q)
    y_res: jnp.ndarray    # (n,) whitened phenotype residual
    rss0: jnp.ndarray     # scalar null RSS
    dof: jnp.ndarray      # n - q - 1 as a DATA leaf (dynamic across steps)
    w_scale: jnp.ndarray = None  # (n,) per-column power-of-two scale for
                          #   the int8 digit-plane tiers ('int8xK'); None
                          #   for all float tiers


#: split/digit tier names build_rotated_null understands (besides None
#: and jnp.bfloat16)
_ROTATE_TIERS = frozenset({"bf16x2", "bf16x3", "bf16x2c", "bf16x3c",
                           "int8x2", "int8x3", "int8x4"})


def normalize_rotate_tier(rotate_in_bf16):
    """Normalize the user-facing tier spelling of `rotate_in_bf16` to the
    `rotate_dtype` argument of build_rotated_null.

    False/None -> None (exact fp32), True/'bf16' -> jnp.bfloat16,
    'x2'/'x3' -> 'bf16x2'/'bf16x3', and the explicit names ('bf16x2c',
    'int8x3', ...) pass through. Near-miss spellings (e.g. 'int8',
    'int8x5') raise here rather than silently quantizing W or failing
    deep inside tracing. Shared by models.emmax, models.streaming and
    parallel.distributed so every entry point accepts the same tiers."""
    if not rotate_in_bf16:
        return None
    if rotate_in_bf16 is True:
        return jnp.bfloat16
    s = str(rotate_in_bf16)
    if s in ("bf16", "bfloat16"):
        return jnp.bfloat16
    if not s.startswith(("bf16", "int8")):
        s = "bf16" + s
    if s not in _ROTATE_TIERS:
        raise ValueError(
            f"unknown rotation tier {rotate_in_bf16!r}; choose from "
            f"False (exact fp32), True/'bf16', {sorted(_ROTATE_TIERS)}")
    return s


def is_integer_dosage(G) -> bool:
    """True when every dosage is an exact small integer (int8-safe), i.e.
    the int8 digit-plane tiers are EXACT for this genotype matrix. False
    for mean-imputed fractional dosages (quantizing those would silently
    alter the data — the int8 tiers refuse them)."""
    import numpy as np

    G = np.asarray(G)
    if np.issubdtype(G.dtype, np.integer):
        # negative entries are the MISSING sentinel: imputation turns
        # them into fractional dosages, so the int8 tiers are not exact
        return bool(G.min(initial=0) >= 0 and G.max(initial=0) <= 127)
    if not np.issubdtype(G.dtype, np.floating):
        return False
    if G.size and (np.isnan(G).any() or np.abs(G).max() > 127):
        return False
    return bool(np.array_equal(G, np.round(G)))


#: unified user-facing precision tier names (emmax(precision=...), CLI
#: --precision): name -> (rotate_in_bf16 value, matmul_precision value)
PRECISION_TIERS = {
    "exact": (False, None),
    "high": (False, "high"),
    "bf16": (True, None),
    "bf16x2": ("bf16x2", None), "bf16x3": ("bf16x3", None),
    "bf16x2c": ("bf16x2c", None), "bf16x3c": ("bf16x3c", None),
    "int8x2": ("int8x2", None), "int8x3": ("int8x3", None),
    "int8x4": ("int8x4", None),
}


def probe_for_source(rg=None, Gf=None):
    """The 1x1 dosage probe resolve_precision's 'auto'/'fast' routing
    inspects: a resident container answers from its has_missing flag
    (no decode), an in-core matrix is probed directly (review r5 —
    previously copy-pasted at six call sites)."""
    import numpy as np

    if rg is not None:
        return (np.full((1, 1), np.nan) if rg.has_missing
                else np.zeros((1, 1), dtype=np.int8))
    return Gf


#: what 'auto' and 'fast' resolve to on each platform, as (tier for
#: integer dosages, tier for fractional ones); a platform not listed runs
#: the exact tier. An entry is there only where the tier measured faster
#: than exact on that platform with its drift inside TIER_P_DRIFT, on
#: dosages of its kind (PERF.md, Findings). The GPU's drifts were read on
#: binary genomes only, so fractional dosages run exact there. The int8
#: tiers need integer dosages: their digit planes round genotypes to int8.
PRECISION_ROUTES = {
    "gpu": {"auto": ("int8x3", "exact"), "fast": ("int8x2", "exact")},
}
_EXACT_ROUTE = {"auto": ("exact", "exact"), "fast": ("exact", "exact")}


def resolve_precision(precision: str, G=None, backend=None):
    """Resolve a unified `precision` name -> (rotate_in_bf16,
    matmul_precision, resolved_name).

    'auto' routes to the fastest tier whose accuracy is within the fp32
    device envelope and 'fast' to the fastest tier overall (callers pair
    it with the exact rescore), both read from PRECISION_ROUTES for the
    backend (default: jax.default_backend()). G (dosages or a
    probe_for_source probe) decides between the integer and the
    fractional route; None takes the fractional one."""
    p = str(precision)
    if p in ("auto", "fast"):
        if backend is None:
            backend = jax.default_backend()
        int_tier, frac_tier = PRECISION_ROUTES.get(backend, _EXACT_ROUTE)[p]
        p = (int_tier if int_tier == frac_tier
             or (G is not None and is_integer_dosage(G)) else frac_tier)
    if p not in PRECISION_TIERS:
        raise ValueError(
            f"unknown precision tier {precision!r}; choose from "
            f"{['auto', 'fast'] + sorted(PRECISION_TIERS)}")
    rb, mp = PRECISION_TIERS[p]
    return rb, mp, p


#: ABSOLUTE p-value drift bound per tier (|p_tier - p_exact|): twice the
#: largest max drift measured over three 65,536 x 10,240 binary genomes
#: (chip_smoke.py phase B, seeds 0-2) on an H100 80GB HBM3 at 700 W,
#: rounded up to one significant digit (readings per seed: PERF.md).
#: 'high' is TF32 there. select_rescore_idx widens the Bonferroni cut by
#: a safety multiple of this, making the rescore pass THRESHOLD-COMPLETE.
TIER_P_DRIFT = {
    "exact": 0.0,
    "high": 2e-3,                           # largest reading 9.24e-4
    "bf16": 2e-2,                           # 7.82e-3
    "bf16x2": 3e-5, "bf16x2c": 3e-5,        # 1.12e-5
    "bf16x3": 9e-6, "bf16x3c": 9e-6,        # 4.07e-6
    "int8x2": 1e-3,                         # 4.78e-4
    "int8x3": 1e-5,                         # 4.58e-6
    "int8x4": 9e-6,                         # 4.30e-6
}


def tier_drift_name(rd, matmul_precision) -> str:
    """Map a normalize_rotate_tier result + matmul_precision to the
    TIER_P_DRIFT key of the ACTIVE scan tier."""
    if isinstance(rd, str):
        return rd
    if rd is not None:          # jnp.bfloat16
        return "bf16"
    return matmul_precision or "exact"


def rescore_p_cut(M: int, tier, alpha: float = 0.05,
                  safety: float = 8.0) -> float:
    """Fast-tier p-value cut below which EVERY SNP must be exactly
    re-scored for the rescore pass to be threshold-complete: a SNP whose
    EXACT p sits just under the Bonferroni threshold alpha/M can surface
    from the fast tier with p up to threshold + drift, so the cut is
    alpha/M + safety*drift (drift is ADDITIVE on p, not relative — at
    M = 1e6 the threshold itself is 5e-8, far below every tier's
    drift). Unknown tier names take the worst measured drift."""
    drift = TIER_P_DRIFT.get(str(tier), max(TIER_P_DRIFT.values()))
    return alpha / max(M, 1) + safety * drift


def select_rescore_idx(ps, rescore_top: int, tier,
                       alpha: float = 0.05, safety: float = 8.0):
    """The rescore CONTRACT (VERDICT r4 #2): with precision='fast' (or
    any tier + rescore_top), every returned p-value below the Bonferroni
    threshold alpha/M is exact-tier — not just the top-k table. Selection
    = {all SNPs with fast-tier p <= rescore_p_cut} ∪ {top rescore_top by
    p} (the floor), UNCAPPED: a dense-signal genome with tens of
    thousands of sub-threshold hits rescans them all (the exact rescore
    is tiled, ~300k tests/s/chip — even 100k rows is sub-second), where
    the former fixed 8*top-k cap silently left hits 8193+ at tier
    drift. Expected null-genome set size is M * safety * drift
    (~4k at M=1e6 for int8x2) plus the floor."""
    import numpy as np

    ps = np.asarray(ps)
    M = ps.shape[0]
    k = min(int(rescore_top), M)
    cand = np.argsort(ps, kind="stable")[:k]
    near = np.flatnonzero(ps <= rescore_p_cut(M, tier, alpha, safety))
    return np.union1d(cand, near)


def quantize_rotation(W, rotate_dtype, sd_dtype=None):
    """Encode an (n, n) rotation operator in the precision tier named by
    `rotate_dtype` -> (W_repr, w_scale | None). The representation is
    decoded by apply_rotation; tier semantics as documented on
    build_rotated_null. Shared by the EMMAX scan (W = U*sd) and the GxE
    product rotations (env-scaled copies of U)."""
    if sd_dtype is None:
        sd_dtype = W.dtype
    if rotate_dtype in ("int8x2", "int8x3", "int8x4"):
        k = int(rotate_dtype[5])
        bits = 8 * k - 2  # top balanced digit stays within int8
        colmax = jnp.max(jnp.abs(W), axis=0)
        _, e = jnp.frexp(colmax)          # colmax <= 2^e exactly
        w_scale = jnp.exp2((e - bits).astype(sd_dtype))
        Wi = jnp.round(W / w_scale[None, :]).astype(jnp.int32)
        planes = []
        r = Wi
        for _ in range(k):                # balanced base-256 digits
            d = ((r + 128) % 256) - 128
            planes.append(d.astype(jnp.int8))
            r = (r - d) // 256
        return jnp.stack(planes), w_scale  # (k, n, n) int8, low digit 1st
    if rotate_dtype in ("bf16x2", "bf16x3", "bf16x2c", "bf16x3c"):
        concat = rotate_dtype.endswith("c")
        k = int(rotate_dtype[5])
        resid = W.astype(jnp.float32)
        parts = []
        for _ in range(k):
            p = resid.astype(jnp.bfloat16)
            parts.append(p)
            resid = resid - p.astype(jnp.float32)
        # stacked (k, n, n): k separate dots. concat (n, k*n): ONE wide
        # dot (XLA keeps all passes in one fused matmul kernel) + a
        # 3-way column-block sum; detected downstream by
        # W.shape[1] == k * W.shape[0].
        return (jnp.concatenate(parts, axis=1) if concat
                else jnp.stack(parts)), None
    if rotate_dtype is not None:
        return W.astype(rotate_dtype), None
    return W, None


def apply_rotation(G_tile, W, w_scale, dt, n_out=None):
    """Xs = G_tile @ W where W is a quantize_rotation representation;
    dt is the accumulate/output dtype (the epilogue precision).

    n_out (optional): the eigenbasis width. Pass it whenever W's
    CONTRACTION rows may be padded (TP sample-padding): the concat-tier
    heuristic below reads k from W.shape[1] % W.shape[0], which a
    row-padded (n_pad, k*n) concat W defeats — same pitfall
    apply_rotation_psum disambiguates with its explicit n_out."""
    prec = (jax.lax.Precision.DEFAULT
            if W.dtype == jnp.bfloat16 else None)
    # bf16 products are exact in float32, and the bf16 tiers accumulate
    # there (a GPU has no bf16 x bf16 -> float64 GEMM)
    acc = jnp.float32 if W.dtype == jnp.bfloat16 else dt
    if W.dtype == jnp.int8:
        # int8 digit-plane tier ('int8xK'): K exact int8->int32 integer
        # GEMMs, recombined base-256 in fp32
        Gb = (G_tile if G_tile.dtype == jnp.int8
              else jnp.round(G_tile).astype(jnp.int8))
        Xs = None
        for i in range(W.shape[0]):
            Ai = jnp.dot(Gb, W[i], preferred_element_type=jnp.int32,
                         precision=_INT8_PREC)
            term = Ai.astype(dt) * (256.0 ** i)
            Xs = term if Xs is None else Xs + term
        return Xs * w_scale[None, :].astype(dt)
    if W.ndim == 3:
        # split-W tier ('bf16xK'): sum of K single-pass bf16 matmuls
        Gb = G_tile.astype(W.dtype)
        Xs = jnp.dot(Gb, W[0], preferred_element_type=acc,
                     precision=prec).astype(dt)
        for i in range(1, W.shape[0]):
            Xs = Xs + jnp.dot(Gb, W[i], preferred_element_type=acc,
                              precision=prec).astype(dt)
        return Xs
    base = W.shape[0] if n_out is None else n_out
    if W.shape[1] != base and W.shape[1] % base == 0:
        # concat split-W tier ('bf16xKc'): one wide matmul, then sum
        # the K column blocks
        k = W.shape[1] // base
        m = G_tile.shape[0]
        Xw = jnp.dot(G_tile.astype(W.dtype), W,
                     preferred_element_type=acc, precision=prec).astype(dt)
        return jnp.sum(Xw.reshape(m, k, base), axis=1)
    return jnp.dot(G_tile.astype(W.dtype), W,
                   preferred_element_type=acc, precision=prec).astype(dt)


def build_rotated_null(null: NullModel, rotate_dtype=None) -> RotatedNull:
    """rotate_dtype selects the precision tier for the rotation matmul
    (measured speed and p-drift of each: ops.scan.PRECISION_ROUTES and
    TIER_P_DRIFT):

    - None: the null model's precision (package-pinned true fp32).
    - jnp.bfloat16: 1-pass bf16.
    - 'bf16x3' / 'bf16x2': W split into 3 (resp. 2) stacked bf16 terms
      (W = hi + lo (+ lo2), fp32 accumulation). Integer genotype dosages
      are EXACT in bf16, so only W's representation matters: 3 terms
      recover the full 24-bit fp32 mantissa at THREE single-pass bf16
      matmuls. 2 terms give 16 mantissa bits. With mean-imputed NON-integer
      dosages the genotype cast itself rounds to bf16; use the default
      fp32 tier there if 1e-6-grade parity is required.
    - 'int8x2' / 'int8x3' / 'int8x4': W quantized to a per-column
      power-of-two fixed point and decomposed into K signed int8 digit
      planes (base 256, balanced digits). Integer dosages are exact in
      int8, each digit matmul accumulates EXACTLY in int32 (no rounding
      at all until the final f32 recombine), and integer GEMMs run at
      twice the bf16 tensor-core rate. W resolution: 8K-2 bits below the
      per-column max (14/22/30), i.e. 'int8x3' is fp32-grade. Requires
      integer dosages (values rounded to int8 in-kernel)."""
    from mixmogam_tpu.ops.eigen import orthonormal_basis

    phi, U, delta = null.phi, null.U, null.delta
    # memoize the DEVICE copy of (phi, U) on the model: fit_null_model
    # often returns HOST numpy factors (cached eighs, LOCO pipelines),
    # and re-uploading the (n, n) U (420 MB at n=10,240) per build is
    # wasted — repeated builds (fast tier + its exact rescore,
    # per-chromosome LOCO) pay it once instead
    dev = getattr(null, "_dev_factors", None)
    if dev is None or dev[0] is not phi:
        dev = (phi, jnp.asarray(phi), jnp.asarray(U))
        try:
            null._dev_factors = dev
        except AttributeError:
            pass  # frozen/odd containers: behave as before
    phi, U = dev[1], dev[2]
    sd = 1.0 / jnp.sqrt(phi + delta)
    W, w_scale = quantize_rotation(U * sd[None, :], rotate_dtype,
                                   sd_dtype=sd.dtype)
    y_star = (null.y @ U) * sd
    X0_star = (null.X0.T @ U).T * sd[:, None]
    Q0 = orthonormal_basis(X0_star)
    y_res = y_star - Q0 @ (Q0.T @ y_star)
    rss0 = y_res @ y_res
    n, q = X0_star.shape
    # dof rides in sd's (full) precision — W may be bf16 where integers
    # above 256 are not representable
    return RotatedNull(W=W, sd=sd, Q0=Q0, y_res=y_res, rss0=rss0,
                       dof=jnp.asarray(n - q - 1, dtype=sd.dtype),
                       w_scale=w_scale)


def apply_rotation_psum(G_tile, W, w_scale, dt, axis_name: str,
                        n_out: int):
    """Tensor-parallel apply_rotation: G_tile holds a SAMPLE-column
    block and W the matching CONTRACTION-row block; partial products
    reduce over `axis_name` (the 'sample' mesh axis). int8 digit planes
    psum their int32 accumulators BEFORE the float conversion — integer
    addition is associative, so the TP result is BIT-IDENTICAL to the
    single-device dot (float tiers psum after local accumulation and
    match to partial-sum rounding only).

    n_out (the GLOBAL eigenbasis width) is explicit: apply_rotation's
    concat-tier heuristic (W.shape[1] % W.shape[0] == 0) misreads a
    row-sharded square W whose local row count divides n."""
    prec = (jax.lax.Precision.DEFAULT
            if W.dtype == jnp.bfloat16 else None)
    # bf16 products are exact in float32, and the bf16 tiers accumulate
    # there (a GPU has no bf16 x bf16 -> float64 GEMM)
    acc = jnp.float32 if W.dtype == jnp.bfloat16 else dt
    if W.dtype == jnp.int8:
        Gb = (G_tile if G_tile.dtype == jnp.int8
              else jnp.round(G_tile).astype(jnp.int8))
        Xs = None
        for i in range(W.shape[0]):
            Ai = jnp.dot(Gb, W[i], preferred_element_type=jnp.int32,
                         precision=_INT8_PREC)
            Ai = jax.lax.psum(Ai, axis_name)    # exact int32 reduce
            term = Ai.astype(dt) * (256.0 ** i)
            Xs = term if Xs is None else Xs + term
        return Xs * w_scale[None, :].astype(dt)
    if W.ndim == 3:                             # stacked bf16 tiers
        Gb = G_tile.astype(W.dtype)
        Xs = jnp.dot(Gb, W[0], preferred_element_type=acc,
                     precision=prec).astype(dt)
        for i in range(1, W.shape[0]):
            Xs = Xs + jnp.dot(Gb, W[i], preferred_element_type=acc,
                              precision=prec).astype(dt)
    elif W.shape[1] != n_out:                   # concat tier (nl, k*n)
        k = W.shape[1] // n_out
        m = G_tile.shape[0]
        Xw = jnp.dot(G_tile.astype(W.dtype), W,
                     preferred_element_type=acc, precision=prec).astype(dt)
        Xs = jnp.sum(Xw.reshape(m, k, n_out), axis=1)
    else:
        Xs = jnp.dot(G_tile.astype(W.dtype), W,
                     preferred_element_type=acc, precision=prec).astype(dt)
    return jax.lax.psum(Xs, axis_name)


def scan_epilogue(Xs: jnp.ndarray, rot: RotatedNull
                  ) -> Dict[str, jnp.ndarray]:
    """F statistics/betas from whitened SNP rows Xs (m, n) — the
    elementwise epilogue shared by the single-device scan and the sample-sharded
    (TP) shard_map kernel, which builds Xs via apply_rotation_psum."""
    dt = rot.sd.dtype
    c = Xs @ rot.Q0                                    # (m, q)
    xy = Xs @ rot.y_res                                # (m,)
    ss = jnp.sum(Xs * Xs, axis=1)
    xx = ss - jnp.sum(c * c, axis=1)
    eps = 100.0 * jnp.finfo(dt).eps
    mask = xx > eps * jnp.maximum(ss, jnp.finfo(dt).tiny)
    xx_safe = jnp.where(mask, xx, 1.0)
    expl = xy * xy / xx_safe                           # rss0 - rss1
    expl = jnp.where(mask, jnp.minimum(expl, rot.rss0), 0.0)
    rss1 = rot.rss0 - expl
    rss1_safe = jnp.maximum(rss1, jnp.finfo(dt).tiny)
    f = expl * jnp.asarray(rot.dof, dt) / rss1_safe
    beta = jnp.where(mask, xy / xx_safe, 0.0)
    var_perc = jnp.where(mask, expl / rot.rss0, 0.0)
    return {"f_stats": jnp.where(mask, f, 0.0), "betas": beta,
            "var_perc": var_perc, "mask": mask}


@functools.partial(jax.jit, static_argnames=("pre_rotated",))
def emmax_scan_stats(G_tile: jnp.ndarray, rot: RotatedNull,
                     pre_rotated: bool = False) -> Dict[str, jnp.ndarray]:
    """Per-SNP F statistics for one tile of SNP rows.

    G_tile: (m, n) float dosages (mean-imputed), or rotated dosages
    (rows of G @ U) when pre_rotated=True.
    Returns f_stats, betas, var_perc, mask (False = degenerate SNP).
    """
    dt = rot.sd.dtype  # epilogue/compute precision
    if pre_rotated:
        Xs = G_tile.astype(dt) * rot.sd[None, :]
    else:
        # rot.W's dtype/shape selects the precision tier for the rotation
        # matmul (see quantize_rotation/apply_rotation); epilogue stays
        # in fp32+. n_out disambiguates the concat tier when W's rows
        # are TP-sample-padded.
        Xs = apply_rotation(G_tile, rot.W, rot.w_scale, dt,
                            n_out=rot.sd.shape[0])
    return scan_epilogue(Xs, rot)


@functools.partial(jax.jit, static_argnames=("tile", "pre_rotated"))
def emmax_scan_all(G: jnp.ndarray, rot: RotatedNull, tile: int = 8192,
                   pre_rotated: bool = False) -> Dict[str, jnp.ndarray]:
    """Whole-matrix scan: pads the SNP axis to a tile multiple and
    lax.map's the tile kernel (bounded working set, single compile)."""
    M, n = G.shape
    T = -(-M // tile)
    pad = T * tile - M
    Gp = jnp.pad(G, ((0, pad), (0, 0)))
    tiles = Gp.reshape(T, tile, n)
    out = jax.lax.map(
        lambda t: emmax_scan_stats(t, rot, pre_rotated=pre_rotated), tiles)
    return {k: v.reshape(T * tile)[:M] for k, v in out.items()}
