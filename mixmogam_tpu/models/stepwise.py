"""Stepwise MLMM — forward/backward multi-locus mixed model
(SURVEY.md A.5, §3.2; reference: linear_models.emmax_step_wise;
Segura et al. 2012).

Host-orchestrated loop over device scans (the step count is tiny and data-
dependent — exactly the control flow that should NOT live inside jit):

  per forward step:
    re-REML with current cofactors   [ops.xreml.explicit_reml — reuses
                                      eigh(K); no per-step eigendecomp,
                                      unlike the reference's eig_R re-eigh]
    full EMMAX scan                  [ops.scan on PRE-ROTATED genotypes —
                                      elementwise only, the rotation matmul
                                      is paid once for all steps]
    add argmin-p SNP as cofactor; record h2, ML criteria (BIC/eBIC/mBIC),
    cofactor re-test p-values, mbonf.
  backward: drop the least significant cofactor per step.
  selection: optimum per criterion over the whole path.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
import scipy.special

from mixmogam_tpu.models.emmax import _as_design, _as_dosage
from mixmogam_tpu.ops.eigen import eigen_k, orthonormal_basis
from mixmogam_tpu.ops.scan import RotatedNull, emmax_scan_all, emmax_scan_stats
from mixmogam_tpu.ops.stats import f_sf_host
from mixmogam_tpu.ops.xreml import explicit_reml


def _log_binom(m: int, k: int) -> float:
    return float(scipy.special.gammaln(m + 1) - scipy.special.gammaln(k + 1)
                 - scipy.special.gammaln(m - k + 1))


def _rot_null_from_delta(phi, delta, y_rot, X0_rot, dtype, pad_to: int = 0,
                         U=None):
    """RotatedNull built directly in the eigenbasis.

    pad_to: zero-pad Q0's column count so scans at every stepwise step
    share ONE compiled shape (zero columns contribute nothing to the
    projection; dof stays the TRUE n-q-1 as a dynamic scalar).
    U: pass eigh(K)'s eigenvectors to also build the rotate+whiten W for
    NON-pre-rotated (streamed) scans; otherwise W is left empty."""
    sd = 1.0 / jnp.sqrt(phi + delta)
    y_star = y_rot * sd
    X0_star = X0_rot * sd[:, None]
    Q0 = orthonormal_basis(X0_star)
    y_res = y_star - Q0 @ (Q0.T @ y_star)
    rss0 = y_res @ y_res
    n, q = X0_star.shape
    if pad_to > q:
        Q0 = jnp.pad(Q0, ((0, 0), (0, pad_to - q)))
    W = (U * sd[None, :]) if U is not None else jnp.zeros((0, 0),
                                                          dtype=dtype)
    return RotatedNull(W=W, sd=sd, Q0=Q0, y_res=y_res, rss0=rss0,
                       dof=jnp.asarray(n - q - 1, dtype=dtype))


def emmax_step_wise(G, y, K=None, max_steps: int = 10,
                    X0: Optional[np.ndarray] = None, alpha: float = 0.05,
                    ngrids: int = 100, llim: float = -10.0,
                    ulim: float = 10.0, esp: float = 1e-6,
                    dtype=None, tile: int = 8192, eig_k=None,
                    save_scans: bool = False, early_stop: bool = False,
                    rot_budget_bytes: Optional[int] = None,
                    mesh=None) -> Dict:
    """Returns {'steps': [...], 'selected': {criterion: {...}},
    'bonf_threshold': float} — same schema as the oracle
    (oracle.mlmm_step_wise), parity-tested.

    early_stop=True stops the forward phase once the scan's min p-value
    exceeds the Bonferroni threshold (the reference's stop rule);
    default False always runs max_steps and lets the selection criteria
    pick the best step (the oracle-parity behavior).

    Memory strategy: when the rotated genotype matrix fits in
    rot_budget_bytes of device memory (default: half the device's
    memory limit, 8 GiB where it reports none) it is stored once
    (per-step scans are then pure elementwise); otherwise scans STREAM
    int8 tiles from host, imputing on device and paying the rotation
    matmul per step (BASELINE config #5: 1M SNPs x 10k samples).

    mesh: a ('snp', 'sample') device mesh (parallel.mesh.make_mesh)
    distributes the stepwise campaign (VERDICT r4 #4): the rotated
    genotypes are SNP-sharded once, every per-step scan is a sharded
    whole-matrix dispatch (zero cross-chip communication; one gather of
    the per-shard stats per step), and the host-side selection loop is
    unchanged — same steps/criteria as the single-device path, parity-
    tested. Requires the stored-rotation budget (rot_budget_bytes x
    mesh width of aggregate HBM)."""
    from mixmogam_tpu.ops.reml import esp_to_refine_iters

    refine_iters = esp_to_refine_iters(esp, ngrids, llim, ulim)
    y = np.asarray(y, dtype=np.float64).ravel()
    n = y.shape[0]
    if dtype is None:
        dtype = jnp.zeros(0).dtype
    from mixmogam_tpu.models.resident import ResidentGenome

    rg = G if isinstance(G, ResidentGenome) else None
    if rg is not None and rg.n != n:
        # the packed scan decodes n columns per row — a mismatched
        # container would silently scan a truncated sample subset
        # before failing later with an unrelated shape error (review)
        raise ValueError(f"y has {n} samples but the resident genome "
                         f"holds {rg.n}")
    M = (rg.M if rg is not None
         else np.asarray(G.matrix if hasattr(G, "matrix") else G).shape[0])
    itemsize = np.dtype(np.dtype(dtype).name).itemsize
    if rot_budget_bytes is None:
        from mixmogam_tpu.models.source import device_budget

        rot_budget_bytes = device_budget(1 / 2, 8 << 30)
    use_stored = M * n * itemsize <= rot_budget_bytes
    if mesh is not None:
        if rg is not None:
            raise ValueError(
                "mesh-distributed stepwise takes a host source (the "
                "resident container is single-device; decode or pass "
                "the raw matrix)")
        if not use_stored:
            raise ValueError(
                "mesh-distributed stepwise stores the rotated genotypes "
                "sharded across the mesh; raise rot_budget_bytes (the "
                "per-chip share is rot bytes / mesh width)")
    if X0 is None:
        X0 = np.ones((n, 1))
    X0 = _as_design(X0, n)
    # K is None (and no eig_k): fixed-effects-only stepwise (reference:
    # lm_step_wise). The eigenbasis is the identity — phi = 1s, NO
    # rotation matmuls, genotypes used as-is (pre-rotated semantics).
    # Every per-step F-test equals its OLS value exactly, and the ML
    # log-likelihood's delta terms cancel for a uniform spectrum, so the
    # BIC criteria are exact OLS criteria.
    identity_k = K is None and eig_k is None
    if identity_k:
        phi = jnp.ones(n, dtype=dtype)
        U = None
    else:
        if eig_k is None:
            phi, U = eigen_k(K, host=True)
        else:
            phi, U = eig_k
        phi = jnp.asarray(phi, dtype=dtype)
        U = jnp.asarray(U, dtype=dtype)
    y_rot = (jnp.asarray(y, dtype=dtype) if identity_k
             else U.T @ jnp.asarray(y, dtype=dtype))
    X0_rot = (jnp.asarray(X0, dtype=dtype) if identity_k
              else U.T @ jnp.asarray(X0, dtype=dtype))
    if mesh is not None:
        # SNP-shard the rotated genotypes across the mesh ONCE; pad rows
        # to the shard count (zero rotated rows are degenerate -> masked)
        from mixmogam_tpu.parallel.mesh import (pad_to_multiple,
                                                put_global, replicated,
                                                snp_sharding)

        Gf = _as_dosage(G, dtype)
        Gp, _ = pad_to_multiple(Gf, mesh.shape["snp"], axis=0)
        Gd = put_global(Gp, snp_sharding(mesh))
        if identity_k:
            G_rot = Gd
        else:
            Ud = put_global(np.asarray(U), replicated(mesh))
            G_rot = jax.jit(
                lambda g, u: jnp.dot(g, u, preferred_element_type=g.dtype),
                out_shardings=snp_sharding(mesh))(Gd, Ud)
        G_i8 = None
        # per-step sharded whole-matrix scan; outputs replicate (the
        # step's single gather). One compile across steps via pad_to.
        _mesh_scan = jax.jit(
            lambda g, r: emmax_scan_stats(g, r, pre_rotated=True),
            out_shardings=replicated(mesh))
    elif use_stored:
        # rotate genotypes ONCE; every scan afterwards is elementwise
        if rg is not None:
            from mixmogam_tpu.models.resident import (
                rotate_resident_to_device)

            G_rot = rotate_resident_to_device(
                rg, None if identity_k else U, dtype)
        elif identity_k:
            G_rot = jnp.asarray(_as_dosage(G, dtype))
        else:
            # tiled device-side build: peak HBM = G_rot + one tile (a
            # full float G alongside G_rot would be 2x and OOM at
            # config-#5 scale, 262k+ x 10k)
            from mixmogam_tpu.models.streaming import (
                rotate_streamed_to_device)

            G_src = G.matrix if hasattr(G, "matrix") else np.asarray(G)
            G_rot = rotate_streamed_to_device(G_src, U, dtype)
        G_i8 = None
    elif rg is not None:
        # over-budget resident genome: per-step scans run straight off
        # the packed HBM copy (rotation matmul per step, zero host
        # traffic) — BASELINE config #5 at the FULL 1M x 10k scale
        G_rot = None
        G_i8 = None
        G_f = None
    else:
        G_rot = None
        G_host = np.asarray(G.matrix if hasattr(G, "matrix") else G)
        if np.issubdtype(G_host.dtype, np.integer):
            G_i8 = np.ascontiguousarray(G_host.astype(np.int8))
            G_f = None
        else:
            # float source: int8 streaming is only lossless for integer
            # dosages (NaN missing -> the -1 sentinel). Fractional
            # (mean-imputed) dosages stream as float32 tiles instead of
            # being silently truncated by an int8 cast.
            miss = np.isnan(G_host)
            obs = np.where(miss, 0.0, G_host)
            if (np.abs(obs).max(initial=0) <= 127
                    and np.array_equal(obs, np.rint(obs))):
                G_i8 = np.where(miss, -1, obs).astype(np.int8)
                G_f = None
            else:
                G_i8 = None
                G_f = _as_dosage(G_host, np.float32)  # NaN mean-imputed

    def rot_col(c: int) -> jnp.ndarray:
        """Rotated column of SNP c (from storage or a single matvec)."""
        if G_rot is not None:
            return G_rot[c]
        if rg is not None:
            from mixmogam_tpu.models.streaming import _impute_tile

            col = _impute_tile(jnp.asarray(rg[np.array([c])]))[0]
            return (col.astype(dtype) if identity_k
                    else U.T @ col.astype(dtype))
        if G_i8 is not None:
            from mixmogam_tpu.models.streaming import _impute_tile

            col = _impute_tile(jnp.asarray(G_i8[c][None, :]))[0]
        else:
            col = jnp.asarray(G_f[c])
        return (col.astype(dtype) if identity_k
                else U.T @ col.astype(dtype))

    bonf = alpha / M
    q0 = X0.shape[1]
    pad_to = q0 + max_steps  # one scan compile across all steps

    steps: List[Dict] = []
    cof: List[int] = []

    def model_stats(cof_now: List[int]):
        X_rot = (X0_rot if not cof_now
                 else jnp.concatenate([X0_rot] + [rot_col(c)[:, None]
                                                  for c in cof_now], axis=1))
        r = explicit_reml(phi, y_rot, X_rot, ngrids=ngrids, llim=llim,
                          ulim=ulim, reml=True, refine_iters=refine_iters)
        m = explicit_reml(phi, y_rot, X_rot, ngrids=ngrids, llim=llim,
                          ulim=ulim, reml=False, refine_iters=refine_iters)
        k = len(cof_now)
        bic = -2.0 * float(m["ll"]) + k * np.log(n)
        ebic = bic + 2.0 * _log_binom(M, k)
        mbic = (-2.0 * float(m["ll"]) + k * np.log(n)
                + 2.0 * k * np.log(max(M / 2.2 - 1.0, 1.0)))
        # re-test each cofactor by dropping it (GLS F at this step's delta)
        cof_ps = np.ones(k)
        for i, c in enumerate(cof_now):
            others = [cc for cc in cof_now if cc != c]
            Xm = (X0_rot if not others
                  else jnp.concatenate([X0_rot] + [rot_col(o)[:, None]
                                                   for o in others], axis=1))
            rotm = _rot_null_from_delta(phi, r["delta"], y_rot, Xm, dtype,
                                        pad_to=pad_to)
            st = emmax_scan_stats(rot_col(c)[None, :], rotm,
                                  pre_rotated=True)
            fval = float(np.asarray(st["f_stats"])[0])
            cof_ps[i] = float(f_sf_host(np.array([fval]), 1.0,
                                        float(rotm.dof))[0]) \
                if bool(np.asarray(st["mask"])[0]) else 1.0
        return r, X_rot, {
            "cofactor_ps": cof_ps, "bic": bic, "ebic": ebic, "mbic": mbic,
            "ll_ml": float(m["ll"]),
            "mbonf_ok": bool(np.all(cof_ps < bonf)) if cof_now else True,
        }

    def record(cof_now: List[int], phase: str):
        r, X_rot, stats = model_stats(cof_now)
        step = {"phase": phase, "cofactors": list(cof_now),
                "delta": float(r["delta"]),
                "pseudo_heritability": float(r["pseudo_heritability"]),
                **stats}
        return step, r, X_rot

    def full_scan(r, X_rot):
        if mesh is not None:
            from mixmogam_tpu.parallel.mesh import put_global, replicated

            rot = _rot_null_from_delta(phi, r["delta"], y_rot, X_rot,
                                       dtype, pad_to=pad_to)
            rot_d = jax.tree.map(
                lambda v: put_global(v, replicated(mesh)), rot)
            d = _mesh_scan(G_rot, rot_d)
            return rot, {k: np.asarray(v)[:M] for k, v in d.items()}
        if G_rot is not None:
            rot = _rot_null_from_delta(phi, r["delta"], y_rot, X_rot,
                                       dtype, pad_to=pad_to)
            return rot, emmax_scan_all(G_rot, rot, tile=tile,
                                       pre_rotated=True)
        if rg is not None:
            # packed device source: per-step rotation GEMM,
            # zero host traffic (models.resident)
            from mixmogam_tpu.models.resident import emmax_scan_packed

            rot = _rot_null_from_delta(phi, r["delta"], y_rot, X_rot,
                                       dtype, pad_to=pad_to,
                                       U=None if identity_k else U)
            # stepwise scans rotate with the full fp32 W (exact tier),
            # at the container's 16,384-row granularity (as
            # emmax_resident's exact tier)
            d = emmax_scan_packed(rg.packed, rot, n, rg.tile,
                                  impute=rg.has_missing,
                                  pre_rotated=identity_k)
            return rot, {k: np.asarray(v)[:M] for k, v in d.items()}
        # streamed: int8 tiles, device impute, rotation matmul per tile
        from mixmogam_tpu.models.streaming import _impute_tile

        rot = _rot_null_from_delta(phi, r["delta"], y_rot, X_rot, dtype,
                                   pad_to=pad_to, U=U)
        outs = {"f_stats": np.empty(M), "mask": np.empty(M, dtype=bool),
                "betas": np.empty(M), "var_perc": np.empty(M)}
        pend = []

        def drain(t, o):
            s, e = t * tile, min((t + 1) * tile, M)
            o = jax.device_get(o)
            for kk in outs:
                outs[kk][s:e] = np.asarray(o[kk])[: e - s]

        for t in range(-(-M // tile)):
            s, e = t * tile, min((t + 1) * tile, M)
            chunk = (G_i8 if G_i8 is not None else G_f)[s:e]
            if e - s < tile:
                chunk = np.vstack(
                    [chunk, np.zeros((tile - (e - s), n), chunk.dtype)])
            td = (_impute_tile(jnp.asarray(chunk)) if G_i8 is not None
                  else jnp.asarray(chunk))
            o = emmax_scan_stats(td.astype(dtype), rot,
                                 pre_rotated=identity_k)
            pend.append((t, o))
            if len(pend) >= 4:
                drain(*pend.pop(0))
        for t, o in pend:
            drain(t, o)
        return rot, outs

    for _ in range(max_steps):
        step, r, X_rot = record(cof, "forward")
        rot, d = full_scan(r, X_rot)
        f_stats = np.asarray(d["f_stats"], dtype=np.float64)
        ps = np.where(np.asarray(d["mask"]),
                      f_sf_host(f_stats, 1.0, float(rot.dof)), 1.0)
        if cof:
            ps[np.asarray(cof, dtype=int)] = 1.1  # never re-select
        jmin = int(np.argmin(ps))
        step["min_p"] = float(ps[jmin])
        step["min_p_snp"] = jmin
        if save_scans:
            step["scan_ps"] = ps
        steps.append(step)
        if early_stop and step["min_p"] > bonf:
            # reference stop rule: no genome-wide-significant SNP left to
            # add. Default (False) runs all max_steps like the oracle —
            # model selection then picks the best step, which can differ
            # from stop-at-first-nonsignificant on non-monotone paths.
            stopped_early = True
            break
        cof = cof + [jmin]
    else:
        stopped_early = False

    if not stopped_early:
        # record the model WITH the last added cofactor (the early-stop
        # break leaves `cof` identical to the step just recorded — a
        # final record would duplicate it)
        step, _, _ = record(cof, "forward")
        step["min_p"] = np.nan
        step["min_p_snp"] = -1
        steps.append(step)

    while cof:
        last = steps[-1]
        worst = int(np.argmax(last["cofactor_ps"]))
        cof = [c for i, c in enumerate(cof) if i != worst]
        step, _, _ = record(cof, "backward")
        step["min_p"] = np.nan
        step["min_p_snp"] = -1
        steps.append(step)

    sel = {}
    for c in ("bic", "ebic", "mbic"):
        j = int(np.argmin([s[c] for s in steps]))
        sel[c] = {"step": j, "cofactors": steps[j]["cofactors"]}
    ok = [i for i, s in enumerate(steps) if s["mbonf_ok"]]
    jm = max(ok, key=lambda i: (len(steps[i]["cofactors"]), -i)) if ok else 0
    sel["mbonf"] = {"step": jm, "cofactors": steps[jm]["cofactors"]}
    return {"steps": steps, "selected": sel, "bonf_threshold": bonf}
