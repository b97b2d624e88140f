"""Gene-environment (GxE) interaction scan (capability extension).

The reference stops at marginal and SNP-SNP tests (SURVEY.md §0; mount
was empty); testing SNP x environment interaction under the same mixed
model is the natural next workflow and reuses the package's whitened-
basis algebra end-to-end.

Model per SNP x, with environment e (per-sample covariate, forced into
the null):  y = X0 b + e c + x b_x + (x*e) b_xe + u + eps.

Reported per SNP (all in the EMMAX convention — delta fit ONCE per
environment on the null [X0, e]):
  marginal_ps  x tested on [X0, e]                  (1 dof)
  inter_ps     x*e tested on [X0, e, x]             (1 dof — the GxE test)
  joint_ps     {x, x*e} tested on [X0, e] jointly   (2 dof)

Vectorization: rotate G and G*e once (two matmuls), then every per-SNP
statistic is elementwise Gram-Schmidt in the whitened basis — the exact
same pairwise identity as models/twosnp._pairwise_interaction, with the
partner direction being the SNP itself and the product being x*e.
Degenerate columns (monomorphic x, or x*e collinear with [null, x] —
e.g. a constant environment) are masked to p = 1 inside the kernel.

Round 4 (VERDICT r3 #3):
- Precision tiers: the identity (G ∘ e) @ W == G @ (e[:, None] ∘ W)
  folds the environment into the WEIGHT side, so both rotations ride the
  same int8 digit-plane / bf16 split machinery as the plain scan
  (ops.scan.quantize_rotation/apply_rotation); genotypes stay int8 in
  the GEMM. rescore_top re-tests the leading interaction hits at the
  exact tier, the same contract as emmax(precision='fast').
- Multi-environment batch: env may be (n, E); the genotype rotation
  R = G @ U is computed ONCE per tile and shared by every environment
  (B_e = R * sd_e — the whitening diagonal commutes to the output
  columns), while each environment pays only its own product rotation:
  E + 1 matmuls per tile instead of 2E. Per-env nulls (delta_e, Q0_e,
  rss0_e) are fitted independently — exact, not an approximation.
  Each environment column must be complete (no NaN); drop or impute
  samples before the call (run_gwas's env_pid path drops).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from mixmogam_tpu.models.emmax import _as_design, _as_dosage
from mixmogam_tpu.ops.eigen import eigen_k, orthonormal_basis
from mixmogam_tpu.ops.reml import fit_null_model
from mixmogam_tpu.ops.scan import apply_rotation, quantize_rotation
from mixmogam_tpu.ops.stats import f_sf_host


def _gxe_stats_whitened(B, P, Q0, y_res, rss0, dof):
    """(marginal_f, inter_f, joint_f, masks) from WHITENED SNP columns
    B and product columns P (tile-shaped (m, n)).

    Q0/y_res/rss0: the [X0, e] null's whitened pieces (pytree ARGUMENTS
    — closing over them would bake device arrays into the executable).
    dof convention: dof = n - q - 1 is the marginal test's denominator
    dof; the pair model has dof - 1.
    """
    dt = B.dtype
    eps = 100.0 * jnp.finfo(dt).eps
    tiny = jnp.finfo(dt).tiny

    def orth(X):
        return X - (X @ Q0) @ Q0.T

    Br = orth(B)
    Pr = orth(P)
    bb = jnp.sum(Br * Br, axis=1)
    mask_b = bb > eps * jnp.maximum(jnp.sum(B * B, axis=1), tiny)
    bb_safe = jnp.where(mask_b, bb, 1.0)
    by = Br @ y_res
    expl_b = by * by / bb_safe                    # variance explained by x
    # marginal F: x on [X0, e]
    rss_b = jnp.maximum(rss0 - expl_b, tiny)
    f_marg = expl_b / (rss_b / dof)
    # residualize the product against the SNP direction
    pb = jnp.sum(Pr * Br, axis=1) / bb_safe
    Pr2 = Pr - pb[:, None] * Br
    pp = jnp.sum(Pr2 * Pr2, axis=1)
    mask_p = mask_b & (pp > eps * jnp.maximum(jnp.sum(P * P, axis=1),
                                              tiny))
    pp_safe = jnp.where(mask_p, pp, 1.0)
    py = Pr2 @ y_res
    expl_p = py * py / pp_safe                    # explained by x*e | x
    dof_pair = dof - 1.0
    rss_pair = jnp.maximum(rss_b - expl_p, tiny)
    f_inter = expl_p / (rss_pair / dof_pair)
    # joint 2-dof test of {x, x*e} on [X0, e]
    f_joint = ((rss0 - rss_pair) / 2.0) / (rss_pair / dof_pair)
    return (jnp.where(mask_b, f_marg, 0.0),
            jnp.where(mask_p, f_inter, 0.0),
            jnp.where(mask_p, f_joint, 0.0), mask_b, mask_p)


@jax.jit
def _gxe_envs_incore(Gd, RU, ru_scale, RUes, rue_scales, sds, Q0s,
                     y_ress, rss0s, dof):
    """In-core multi-env GxE: one shared genotype rotation, per-env
    product rotation + stats. Gd: (M, n) dosages (int8 or imputed
    float). Returns 5-tuples stacked (E, M)."""
    dt = sds.dtype
    R = apply_rotation(Gd, RU, ru_scale, dt)
    outs = []
    for e in range(sds.shape[0]):
        B = R * sds[e][None, :]
        P = apply_rotation(
            Gd, RUes[e],
            None if rue_scales is None else rue_scales[e], dt
        ) * sds[e][None, :]
        outs.append(_gxe_stats_whitened(B, P, Q0s[e], y_ress[e],
                                        rss0s[e], dof))
    return tuple(jnp.stack([o[i] for o in outs]) for i in range(5))


@functools.partial(jax.jit, static_argnames=("n", "tile", "impute"))
def _gxe_scan_packed(packed, RU, ru_scale, RUes, rue_scales, sds, Q0s,
                     y_ress, rss0s, dof, n: int, tile: int,
                     impute: bool = False):
    """GxE stats over a 2-bit packed genome resident in HBM: per tile,
    unpack -> ONE shared (tiered) genotype rotation + one product
    rotation per environment, then the elementwise pairwise identity —
    zero host traffic. E + 1 matmuls per tile."""
    from mixmogam_tpu.models.streaming import _impute_tile
    from mixmogam_tpu.ops.pack2 import unpack_2bit_device

    T = packed.shape[0] // tile
    tiles = packed.reshape(T, tile, packed.shape[1])
    dt = sds.dtype

    def kern(pt):
        Gt = unpack_2bit_device(pt, n)
        if impute:
            Gt = _impute_tile(Gt, dt)
        return _gxe_envs_incore(Gt, RU, ru_scale, RUes, rue_scales,
                                sds, Q0s, y_ress, rss0s, dof)

    out = jax.lax.map(kern, tiles)      # each (T, E, tile)
    E = sds.shape[0]
    return tuple(jnp.moveaxis(v, 1, 0).reshape(E, T * tile) for v in out)


def _sub_tile(tile: int, n_env: int) -> int:
    """Finer packed-row granularity when several environments multiply
    the per-tile float intermediates (models.resident.subdivide_tile)."""
    from mixmogam_tpu.models.resident import subdivide_tile

    return subdivide_tile(tile, max(2048, 16_384 // max(n_env, 1)))


def emmax_gxe(G, y, env, K=None, X0: Optional[np.ndarray] = None,
              eig_k=None, ngrids: int = 100, llim: float = -10.0,
              ulim: float = 10.0, dtype=None,
              precision: Optional[str] = None,
              rescore_top: int = 0, mesh=None) -> Dict[str, np.ndarray]:
    """GxE interaction scan (see module docstring).

    mesh: a ('snp', 'sample') device mesh SNP-shards the scan (VERDICT
    r4 #4) — the per-env nulls replicate, genotypes shard row-wise, and
    GSPMD partitions the (row-parallel) whitened-core kernel with one
    gather of the stat fields. A ResidentGenome source shards its
    PACKED rows per chip via shard_map (('snp', 1) meshes). Parity-
    tested against the single-device scan.

    env: (n,) per-sample environment (continuous or 0/1), or (n, E) for
    E environments batched over one shared genotype rotation; always
    appended to the null fixed effects (per env). K or eig_k as in
    emmax. precision: None/'exact' | 'high' | 'bf16' | 'bf16xK' |
    'int8xK' | 'auto' | 'fast' — the same tier names as emmax, applied
    to BOTH rotation matmuls (int8 tiers need fully-observed integer
    dosages). rescore_top: re-test that many leading interaction hits
    (per environment) at the exact tier and patch the reported values —
    precision='fast' defaults it to 1024.

    Returns {'marginal_ps', 'inter_ps', 'joint_ps', 'f_inter', masks,
    'delta', 'pseudo_heritability', ...}; with (n, E) input the per-SNP
    arrays gain a leading env axis (E, M) and 'deltas'/
    'pseudo_heritabilities' are (E,). p-values finalize in float64 on
    host (ops/stats.f_sf_host).
    """
    from mixmogam_tpu.models.resident import ResidentGenome
    from mixmogam_tpu.ops.scan import (is_integer_dosage,
                                       normalize_rotate_tier,
                                       resolve_precision)

    y = np.asarray(y, dtype=np.float64).ravel()
    n = y.shape[0]
    env = np.asarray(env, dtype=np.float64)
    single = env.ndim == 1
    if env.ndim == 1:
        env = env[:, None]
    if env.ndim != 2 or env.shape[0] != n:
        raise ValueError(f"env must be (n,) or (n, E) aligned to y's "
                         f"n={n} samples; got shape {env.shape}")
    E = env.shape[1]
    if not np.isfinite(env).all():
        raise ValueError("env contains non-finite values; GxE needs "
                         "complete environment columns (drop or impute "
                         "samples first — run_gwas's env_pid path drops)")
    if dtype is None:
        dtype = jnp.zeros(0).dtype
    rg = G if isinstance(G, ResidentGenome) else None
    if rg is not None and rg.n != n:
        raise ValueError(f"y has {n} samples but the resident genome "
                         f"holds {rg.n}")
    Gf = None if rg is not None else _as_dosage(G, dtype)
    if X0 is None:
        X0 = np.ones((n, 1))
    X0 = _as_design(X0, n)
    for e in range(E):
        X0e = np.column_stack([X0, env[:, e]])
        if np.linalg.matrix_rank(X0e) < X0e.shape[1]:
            raise ValueError(
                f"environment column {e} is linearly dependent on the "
                "null fixed effects (constant env duplicates the "
                "intercept?) — the null design [X0, env] must have "
                "full column rank")
    # ---- precision tier resolution (same contract as emmax) ----
    matmul_precision, tier_name = None, "exact"
    rd = None
    if precision is not None:
        from mixmogam_tpu.ops.scan import probe_for_source

        rb, matmul_precision, tier_name = resolve_precision(
            precision, G=probe_for_source(rg, Gf))
        rd = normalize_rotate_tier(rb)
    if isinstance(rd, str) and rd.startswith("int8"):
        if rg is not None and rg.has_missing:
            raise ValueError(
                "int8 digit-plane tiers need fully-observed dosages; "
                "this resident genome has missing genotypes (device-"
                "imputed to fractions). Use precision='exact'/'bf16'.")
        if rg is None and not is_integer_dosage(Gf):
            raise ValueError(
                "int8 digit-plane tiers need exact integer dosages; "
                "these genotypes are fractional (imputed). Use "
                "precision='exact'/'bf16'.")
    if str(precision) == "fast" and not rescore_top:
        rescore_top = 1024

    if eig_k is None:
        if K is None:
            raise ValueError("need K or eig_k")
        phi, U = eigen_k(K, host=True)
    else:
        phi, U = eig_k
    phi_d = jnp.asarray(phi, dtype=dtype)
    U_d = jnp.asarray(U, dtype=dtype)
    y_d = jnp.asarray(y, dtype=dtype)
    y_rot = U_d.T @ y_d

    # ---- per-env nulls: delta_e + whitened pieces ----
    nulls = []
    sds, Q0s, y_ress, rss0s = [], [], [], []
    for e in range(E):
        X0e = np.column_stack([X0, env[:, e]])
        null = fit_null_model(y.astype(np.dtype(dtype).name), X0e,
                              eig_k=(phi, U), ngrids=ngrids, llim=llim,
                              ulim=ulim)
        nulls.append(null)
        sd = 1.0 / jnp.sqrt(phi_d + jnp.asarray(null.delta, dtype=dtype))
        X0e_rot = U_d.T @ jnp.asarray(X0e, dtype=dtype)
        ys = y_rot * sd
        X0s = X0e_rot * sd[:, None]
        Q0 = orthonormal_basis(X0s)
        y_res = ys - Q0 @ (Q0.T @ ys)
        sds.append(sd)
        Q0s.append(Q0)
        y_ress.append(y_res)
        rss0s.append(y_res @ y_res)
    sds = jnp.stack(sds)
    Q0s = jnp.stack(Q0s)
    y_ress = jnp.stack(y_ress)
    rss0s = jnp.stack(rss0s)
    q = X0.shape[1] + 1
    dof = float(n - q - 1)
    dof_d = jnp.asarray(dof, dtype=dtype)

    # ---- tiered rotation operators: U shared, env_e ∘ U per env ----
    RU, ru_scale = quantize_rotation(U_d, rd, sd_dtype=sds.dtype)
    rues, rue_scales = [], []
    for e in range(E):
        Ue = jnp.asarray(env[:, e], dtype=dtype)[:, None] * U_d
        We, ws = quantize_rotation(Ue, rd, sd_dtype=sds.dtype)
        rues.append(We)
        rue_scales.append(ws)
    RUes = jnp.stack(rues)
    rue_scales = (None if rue_scales[0] is None
                  else jnp.stack(rue_scales))

    ctx = (jax.default_matmul_precision(matmul_precision)
           if matmul_precision else contextlib.nullcontext())
    with ctx:
        if rg is not None and mesh is not None:
            # SNP-sharded packed container (round 5): each chip scans
            # its packed shard with the replicated per-env nulls via
            # shard_map — same structure as distributed_emmax_resident
            from jax.sharding import PartitionSpec as P

            from mixmogam_tpu.parallel.distributed import shard_packed_rows
            from mixmogam_tpu.parallel.mesh import put_global, replicated

            if mesh.shape["sample"] != 1:
                raise ValueError(
                    "mesh-distributed resident GxE shards 'snp' only; "
                    "use a ('snp', 1) mesh")
            tile = _sub_tile(rg.tile, E)
            packed = shard_packed_rows(rg, mesh, tile)
            rep = replicated(mesh)

            def place(v):
                return None if v is None else put_global(v, rep)

            args = tuple(place(v) for v in
                         (RU, ru_scale, RUes, rue_scales, sds, Q0s,
                          y_ress, rss0s, dof_d))
            spec = tuple(None if v is None else P() for v in args)
            fn = jax.shard_map(
                lambda p, *a: _gxe_scan_packed(
                    p, *a, n=rg.n, tile=tile, impute=rg.has_missing),
                mesh=mesh, in_specs=(P("snp", None),) + spec,
                out_specs=(P(None, "snp"),) * 5)
            from mixmogam_tpu.parallel.mesh import gather_if_multiprocess

            out5 = gather_if_multiprocess(jax.jit(fn)(packed, *args),
                                          mesh)
            out5 = tuple(np.array(v, np.float64)[:, :rg.M]
                         for v in out5)
        elif rg is not None:
            out5 = _gxe_scan_packed(
                rg.packed, RU, ru_scale, RUes, rue_scales, sds, Q0s,
                y_ress, rss0s, dof_d, rg.n, _sub_tile(rg.tile, E),
                impute=rg.has_missing)
            out5 = tuple(np.array(v, np.float64)[:, :rg.M]
                         for v in out5)
        elif mesh is not None:
            # SNP-sharded scan: zero pad rows are degenerate -> masked;
            # the kernel is row-parallel so GSPMD partitions it from
            # the input shardings alone, one gather on readback
            from mixmogam_tpu.parallel.mesh import (pad_to_multiple,
                                                    put_global,
                                                    replicated,
                                                    snp_sharding)

            Gp, M0 = pad_to_multiple(np.asarray(Gf),
                                     mesh.shape["snp"], axis=0)
            rep = replicated(mesh)

            def place(v):
                return None if v is None else put_global(v, rep)

            from mixmogam_tpu.parallel.mesh import gather_if_multiprocess

            out5 = gather_if_multiprocess(_gxe_envs_incore(
                put_global(Gp, snp_sharding(mesh)), place(RU),
                place(ru_scale), place(RUes), place(rue_scales),
                place(sds), place(Q0s), place(y_ress), place(rss0s),
                place(dof_d)), mesh)
            out5 = tuple(np.array(v, np.float64)[:, :M0] for v in out5)
        else:
            out5 = _gxe_envs_incore(jnp.asarray(Gf), RU, ru_scale, RUes,
                                    rue_scales, sds, Q0s, y_ress, rss0s,
                                    dof_d)
            out5 = tuple(np.array(v, np.float64) for v in out5)
    f_marg, f_inter, f_joint, mask_b, mask_p = out5
    mask_b = mask_b.astype(bool)
    mask_p = mask_p.astype(bool)
    M = f_inter.shape[1]

    def _finalize(fm, fi, fj, mb, mp):
        return (np.where(mb, f_sf_host(fm, 1.0, dof), 1.0),
                np.where(mp, f_sf_host(fi, 1.0, dof - 1.0), 1.0),
                np.where(mp, f_sf_host(fj, 2.0, dof - 1.0), 1.0))

    marg_ps = np.empty((E, M))
    inter_ps = np.empty((E, M))
    joint_ps = np.empty((E, M))
    for e in range(E):
        marg_ps[e], inter_ps[e], joint_ps[e] = _finalize(
            f_marg[e], f_inter[e], f_joint[e], mask_b[e], mask_p[e])

    # ---- exact rescore of the leading interaction hits per env ----
    rescored = [np.zeros(0, dtype=np.int64)] * E
    tier_active = rd is not None or matmul_precision
    if rescore_top and tier_active:
        from mixmogam_tpu.ops.scan import (select_rescore_idx,
                                           tier_drift_name)

        source = rg if rg is not None else np.asarray(Gf)
        drift_tier = tier_drift_name(rd, matmul_precision)
        for e in range(E):
            # threshold-complete contract (VERDICT r4 #2) on the
            # INTERACTION p-field; uncapped, tiled dispatches below
            idx = select_rescore_idx(inter_ps[e], rescore_top,
                                     drift_tier)
            for s0 in range(0, len(idx), 8192):
                sub = idx[s0:s0 + 8192]
                rows = np.asarray(source[sub], dtype=np.float64)
                if (rows < 0).any():
                    obs = rows >= 0
                    mu = np.where(obs.any(axis=1),
                                  (rows * obs).sum(axis=1)
                                  / np.maximum(obs.sum(axis=1), 1), 0.0)
                    rows = np.where(obs, rows, mu[:, None])
                Gd_sub = jnp.asarray(rows, dtype=dtype)
                R = Gd_sub @ U_d
                B = R * sds[e][None, :]
                P = ((Gd_sub
                      * jnp.asarray(env[:, e], dtype=dtype)[None, :])
                     @ U_d) * sds[e][None, :]
                fm, fi, fj, mb, mp = (np.asarray(v, np.float64) for v in
                                      _gxe_stats_whitened(
                                          B, P, Q0s[e], y_ress[e],
                                          rss0s[e], dof_d))
                mb, mp = mb.astype(bool), mp.astype(bool)
                f_marg[e][sub], f_inter[e][sub], f_joint[e][sub] = \
                    fm, fi, fj
                mask_b[e][sub], mask_p[e][sub] = mb, mp
                m_ps, i_ps, j_ps = _finalize(fm, fi, fj, mb, mp)
                marg_ps[e][sub], inter_ps[e][sub], joint_ps[e][sub] = \
                    m_ps, i_ps, j_ps
            rescored[e] = idx

    deltas = np.array([float(nl.delta) for nl in nulls])
    h2s = np.array([float(nl.pseudo_heritability) for nl in nulls])
    out = {
        "marginal_ps": marg_ps, "inter_ps": inter_ps,
        "joint_ps": joint_ps, "f_inter": f_inter,
        "mask": mask_b, "mask_inter": mask_p,
        "deltas": deltas, "pseudo_heritabilities": h2s,
        "precision_tier": tier_name,
        "rescored_idx": rescored,
    }
    if single:
        for k_ in ("marginal_ps", "inter_ps", "joint_ps", "f_inter",
                   "mask", "mask_inter"):
            out[k_] = out[k_][0]
        out["rescored_idx"] = rescored[0]
        out["delta"] = float(deltas[0])
        out["pseudo_heritability"] = float(h2s[0])
    return out
