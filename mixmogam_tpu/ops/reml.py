"""Vectorized REML/ML variance-component optimizer (SURVEY.md A.2).

Reference equivalent: LinearMixedModel.get_expedited_REMLE /
get_REML / get_ML in linear_models.py — a 100-point grid on log(delta)
with per-bracket root refinement (defaults ngrids=100, llim=-10, ulim=10,
esp=1e-6).

Device design: the grid evaluation is one broadcast over
(grid_points, spectrum) — no Python loop; ALL sign-change brackets are
refined simultaneously by a fixed-iteration bisection (masked lanes idle),
so the whole optimizer is a single jitted, vmap-able function. vmap over
the leading batch axis of eta2 gives multi-trait REML (50 traits share the
spectrum, SURVEY.md §2.3 'EP analog') and batched per-SNP EMMA.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def esp_to_refine_iters(esp: float, ngrids: int = 100, llim: float = -10.0,
                        ulim: float = 10.0) -> int:
    """Bisection iterations needed to shrink one grid bracket below the
    reference's esp tolerance on log(delta) (clamped to [16, 64])."""
    import math

    width = (ulim - llim) / max(ngrids, 1)
    need = math.log2(max(width / max(esp, 1e-30), 2.0))
    return max(16, min(64, int(math.ceil(need))))


def _ll_terms(logdelta, eta2, xi, det_eigs, scale):
    """LL(logdelta) for the unified REML/ML likelihood:
    REML: det_eigs = xi (n-q values),  scale = n-q
    ML:   det_eigs = phi (n values),   scale = n
    (EMMA eqs; see oracle.lmm._ll_reml/_ll_ml)."""
    d = jnp.exp(logdelta)[..., None]
    s1 = jnp.sum(eta2 / (xi + d), axis=-1)
    s2 = jnp.sum(jnp.log(det_eigs + d), axis=-1)
    return 0.5 * (scale * (jnp.log(scale / (2.0 * jnp.pi)) - 1.0
                           - jnp.log(s1)) - s2)


def _dll_terms(logdelta, eta2, xi, det_eigs, scale):
    d = jnp.exp(logdelta)[..., None]
    denom = xi + d
    s1 = jnp.sum(eta2 / denom, axis=-1)
    s2 = jnp.sum(eta2 / denom**2, axis=-1)
    s3 = jnp.sum(1.0 / (det_eigs + d), axis=-1)
    return 0.5 * (scale * s2 / s1 - s3)


@functools.partial(jax.jit, static_argnames=("ngrids", "refine_iters", "ml"))
def reml_from_spectrum(eta2: jnp.ndarray, xi: jnp.ndarray,
                       phi: Optional[jnp.ndarray] = None,
                       ngrids: int = 100, llim: float = -10.0,
                       ulim: float = 10.0, refine_iters: int = 32,
                       ml: bool = False):
    """Optimize the (RE)ML likelihood in log(delta).

    eta2: (n-q,) squared projections V'y (squared rotated phenotype);
    xi:   (n-q,) projected eigenvalues (A.2);
    phi:  (n,) eigenvalues of K — required for ml=True.

    Returns dict of scalars: log_delta, delta, ll, sigma_g2, sigma_e2,
    pseudo_heritability. 32 bisection iters shrink each 0.2-wide grid
    bracket below 1e-7 — tighter than the reference's esp=1e-6 brentq.
    """
    eta2 = jnp.asarray(eta2)
    xi = jnp.asarray(xi)
    nq = xi.shape[-1]
    if ml:
        assert phi is not None
        det_eigs, scale = jnp.asarray(phi), phi.shape[-1]
    else:
        det_eigs, scale = xi, nq

    grid = jnp.linspace(llim, ulim, ngrids + 1, dtype=eta2.dtype)
    dll = _dll_terms(grid, eta2, xi, det_eigs, scale)

    # all +->- brackets refine in parallel (masked bisection)
    lo0, hi0 = grid[:-1], grid[1:]
    is_bracket = (dll[:-1] > 0) & (dll[1:] < 0)

    def body(_, lohis):
        lo, hi = lohis
        mid = (lo + hi) / 2.0
        dmid = _dll_terms(mid, eta2, xi, det_eigs, scale)
        lo = jnp.where(dmid > 0, mid, lo)
        hi = jnp.where(dmid > 0, hi, mid)
        return lo, hi

    lo, hi = jax.lax.fori_loop(0, refine_iters, body, (lo0, hi0))
    roots = (lo + hi) / 2.0

    cands = jnp.concatenate([roots, jnp.array([llim, ulim], dtype=roots.dtype)])
    valid = jnp.concatenate([is_bracket,
                             jnp.array([True, True])])
    lls = _ll_terms(cands, eta2, xi, det_eigs, scale)
    lls = jnp.where(valid, lls, -jnp.inf)
    j = jnp.argmax(lls)
    log_delta = cands[j]
    ll = lls[j]
    delta = jnp.exp(log_delta)
    sg2 = jnp.sum(eta2 / (xi + delta)) / scale
    return {
        "log_delta": log_delta, "delta": delta, "ll": ll,
        "sigma_g2": sg2, "sigma_e2": delta * sg2,
        "pseudo_heritability": 1.0 / (1.0 + delta),
    }


def _explicit_reml_host(phi, y_rot, X_rot, ngrids: int = 100,
                        llim: float = -10.0, ulim: float = 10.0,
                        refine_iters: int = 32, ml: bool = False) -> dict:
    """X-explicit (RE)ML in float64 on host — needs ONLY eigh(K).

    Same likelihood as reml_from_spectrum through the determinant/
    quadratic identities pinned in tests/test_oracle.py (see
    ops.xreml module docstring):
      sum_i ln(xi_i + d)       == ln|H| + ln|X'H^-1X| - ln|X'X|
      sum_i eta_i^2/(xi_i + d) == y'Py
    so the optimum is identical — WITHOUT the second O(n^3) host eigh of
    S(K+I)S (reference _get_eigen_R_), as slow as the first at n=10k.
    Every evaluation here is O(n q^2) numpy.

    Mirrors reml_from_spectrum's optimizer semantics exactly: dLL/dlogd
    on the grid, bisection in every +->- bracket, argmax of LL over
    refined roots + both endpoints. dLL uses the analytic derivative
    d(y'Py)/dd = -y'P^2y and d ln|X'H^-1X|/dd = -tr(A^-1 X'H^-2X).
    """
    ll_at, dll_at, moments, scale = _explicit_ll_host(phi, y_rot, X_rot,
                                                      ml=ml)
    grid = np.linspace(llim, ulim, ngrids + 1)
    dll = np.array([dll_at(g) for g in grid])
    cands = [float(llim), float(ulim)]
    for i in np.flatnonzero((dll[:-1] > 0) & (dll[1:] < 0)):
        lo, hi = float(grid[i]), float(grid[i + 1])
        for _ in range(refine_iters):
            mid = 0.5 * (lo + hi)
            if dll_at(mid) > 0:
                lo = mid
            else:
                hi = mid
        cands.append(0.5 * (lo + hi))
    lls = np.array([ll_at(c) for c in cands])
    j = int(np.argmax(lls))
    log_delta = cands[j]
    delta = float(np.exp(log_delta))
    ypy = moments(delta)[4]
    sg2 = ypy / scale
    return {"log_delta": log_delta, "delta": delta, "ll": float(lls[j]),
            "sigma_g2": sg2, "sigma_e2": delta * sg2,
            "pseudo_heritability": 1.0 / (1.0 + delta)}


def _explicit_ll_host(phi, y_rot, X_rot, ml: bool = False):
    """(ll_at, dll_at, moments, scale) closures over log-delta for the
    X-explicit host likelihood (see _explicit_reml_host)."""
    phi = np.asarray(phi, np.float64)
    y = np.asarray(y_rot, np.float64).ravel()
    X = np.asarray(X_rot, np.float64)
    if X.ndim == 1:
        X = X[:, None]
    n, q = X.shape
    scale = float(n if ml else n - q)
    logdet_XtX = np.linalg.slogdet(X.T @ X)[1]
    tiny = np.finfo(np.float64).tiny

    def moments(d):
        w = 1.0 / (phi + d)
        Xw = X * w[:, None]
        A = X.T @ Xw
        b = Xw.T @ y
        beta = np.linalg.solve(A, b)
        ypy = max(float(w @ (y * y) - b @ beta), tiny)
        return w, Xw, A, beta, ypy

    def ll_at(logd):
        d = float(np.exp(logd))
        _, _, A, _, ypy = moments(d)
        logdet = float(np.sum(np.log(phi + d)))
        if not ml:
            logdet += np.linalg.slogdet(A)[1] - logdet_XtX
        return 0.5 * (scale * (np.log(scale / (2.0 * np.pi)) - 1.0
                               - np.log(ypy)) - logdet)

    def dll_at(logd):
        d = float(np.exp(logd))
        w, Xw, A, beta, ypy = moments(d)
        Py = w * (y - X @ beta)                      # P y (H diagonal here)
        tr = float(np.sum(w))
        if not ml:
            tr -= float(np.trace(np.linalg.solve(A, Xw.T @ Xw)))
        return 0.5 * d * (scale * float(Py @ Py) / ypy - tr)

    return ll_at, dll_at, moments, scale


@dataclasses.dataclass
class NullModel:
    """Fitted null model: everything the scan phase needs, replicated to all
    chips in distributed runs (SURVEY.md §2.3 'broadcast of the
    eigendecomposed null model')."""

    phi: jnp.ndarray            # (n,) eigenvalues of K, descending
    U: jnp.ndarray              # (n, n) eigenvectors of K
    delta: jnp.ndarray          # scalar REML variance ratio
    log_delta: jnp.ndarray
    ll: jnp.ndarray
    sigma_g2: jnp.ndarray
    sigma_e2: jnp.ndarray
    pseudo_heritability: jnp.ndarray
    y: jnp.ndarray              # (n,) phenotype
    X0: jnp.ndarray             # (n, q) null fixed effects


def fit_null_model(y, X0, K=None, eig_k: Optional[Tuple] = None,
                   ngrids: int = 100, llim: float = -10.0, ulim: float = 10.0,
                   refine_iters: int = 32, host_eigh: bool = True,
                   ml: bool = False, method: str = "auto",
                   eigh_dtype=None) -> NullModel:
    """Null-model REML (reference flow: _get_eigen_L_ -> _get_eigen_R_ ->
    get_expedited_REMLE).

    method:
      'explicit' (= 'auto', the default): X-explicit likelihood from
        eigh(K) ALONE, optimized in float64 on host — identical optimum
        (identities pinned by tests), skips the reference's second
        O(n^3) eigh of S(K+I)S entirely and never reconstructs K from
        eig_k.
      'spectrum': the reference-shaped projected-spectrum path
        (eigh(S(K+I)S) then grid+bisection on the device), kept for
        parity testing and for callers that want the device optimizer.

    eigh_dtype: factorization dtype for the one-time host eigh of K
    when eig_k is not supplied (None = float64; np.float32 = ssyevd,
    the precision='fast' routing).
    """
    import numpy as np

    from mixmogam_tpu.ops.eigen import eigen_k, projected_spectrum

    y = jnp.asarray(y).ravel()
    X0 = jnp.atleast_2d(jnp.asarray(X0))
    if eig_k is None:
        if K is None:
            raise ValueError("need K or eig_k")
        phi, U = eigen_k(K, host=host_eigh, factor_dtype=eigh_dtype)
    else:
        phi, U = eig_k
    if method in ("auto", "explicit"):
        U64 = np.asarray(U, np.float64)
        r64 = _explicit_reml_host(
            np.asarray(phi, np.float64),
            U64.T @ np.asarray(y, np.float64),
            U64.T @ np.asarray(X0, np.float64),
            ngrids=ngrids, llim=llim, ulim=ulim,
            refine_iters=refine_iters, ml=ml)
        r = {k: jnp.asarray(v, dtype=y.dtype) for k, v in r64.items()}
    elif method == "spectrum":
        if K is None:
            K = (U * phi[None, :]) @ U.T
        xi, V = projected_spectrum(K, X0, host=host_eigh)
        eta2 = (V.T @ y) ** 2
        r = reml_from_spectrum(eta2, xi, phi=phi if ml else None,
                               ngrids=ngrids, llim=llim, ulim=ulim,
                               refine_iters=refine_iters, ml=ml)
    else:
        raise ValueError(f"unknown method {method!r} "
                         "(expected 'auto', 'explicit' or 'spectrum')")
    null = NullModel(phi=phi, U=U, y=y, X0=X0, **r)
    # record the objective so h2_profile_ci can profile the SAME
    # likelihood (an ML fit profiled with the REML curve would invert
    # the LRT around the wrong optimum — review finding)
    null._ml = ml
    return null


def h2_profile_ci(null: NullModel, level: float = 0.95,
                  ngrids: int = 400, llim: float = -10.0,
                  ulim: float = 10.0, refine_iters: int = 40
                  ) -> Tuple[float, float]:
    """Profile-likelihood confidence interval for pseudo-heritability.

    The reference reports a point estimate only; this inverts the REML
    likelihood-ratio test on delta: the CI is
    {delta : 2*(LL(delta_hat) - LL(delta)) <= chi2_1(level)}, mapped
    through the monotone h2 = 1/(1+delta). Evaluated with the same
    X-explicit float64 host likelihood as the fit (every evaluation is
    O(n q^2); the eigenbasis is reused from the NullModel — no eigh).
    An endpoint that reaches the search limit is clamped there (h2 at
    e^llim ~ 1, e^ulim ~ 0 — a boundary CI, typical for h2 near 0/1).

    Returns (h2_lo, h2_hi).
    """
    from scipy.stats import chi2

    U = np.asarray(null.U, np.float64)
    # profile the SAME objective the null was fitted with (a NullModel
    # from fit_null_model(ml=True) records _ml; profiling the REML
    # curve around an ML optimum would invert the LRT off-center)
    ll_at, _, _, _ = _explicit_ll_host(
        np.asarray(null.phi, np.float64),
        U.T @ np.asarray(null.y, np.float64),
        U.T @ np.asarray(null.X0, np.float64),
        ml=bool(getattr(null, "_ml", False)))
    cut = float(ll_at(float(null.log_delta))) \
        - 0.5 * float(chi2.ppf(level, 1))
    ld_hat = float(null.log_delta)

    def edge(lo, hi, rising: bool):
        """Bisect the ll==cut crossing in [lo, hi] (ll(hi side near
        ld_hat) >= cut > ll(far side))."""
        for _ in range(refine_iters):
            mid = 0.5 * (lo + hi)
            inside = ll_at(mid) >= cut
            if inside == rising:
                hi = mid
            else:
                lo = mid
        return 0.5 * (lo + hi)

    # scan outward on a grid to bracket the two crossings; brackets are
    # taken ADJACENT to the outermost outside point so a disconnected
    # inside region (multimodal LL) cannot invert them
    grid = np.linspace(llim, ulim, ngrids + 1)
    lls = np.array([ll_at(g) for g in grid])
    inside = lls >= cut
    below = grid < ld_hat
    lo_out = grid[below & ~inside]
    if lo_out.size:
        lo = float(lo_out.max())
        in_above_lo = grid[(grid > lo) & inside]
        hi = float(in_above_lo.min()) if in_above_lo.size else ld_hat
        ld_lo = edge(lo, hi, rising=True)
    else:
        ld_lo = llim
    above = grid > ld_hat
    hi_out = grid[above & ~inside]
    if hi_out.size:
        hi = float(hi_out.min())
        in_below_hi = grid[(grid < hi) & inside]
        lo = float(in_below_hi.max()) if in_below_hi.size else ld_hat
        ld_hi = edge(lo, hi, rising=False)
    else:
        ld_hi = ulim
    # h2 = 1/(1+delta) is DEcreasing in delta: high delta -> low h2
    return (1.0 / (1.0 + float(np.exp(ld_hi))),
            1.0 / (1.0 + float(np.exp(ld_lo))))
