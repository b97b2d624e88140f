"""X-explicit REML in the kinship eigenbasis — the device EMMA engine
(SURVEY.md A.4).

The reference's EMMA (linear_models.emma) re-eigendecomposes S_x(K+I)S_x
for EVERY SNP — O(M n^3), the 'killer' loop of §3.3. Device redesign:
rotate once into eigh(K)'s basis, where H = K + delta*I is DIAGONAL, and
evaluate the same REML likelihood through explicit design-matrix algebra:

  LL_R(d) = 1/2 [ (n-p)(ln((n-p)/2pi) - 1 - ln yPy)
                  - ( ln|H| + ln|X'H^-1 X| - ln|X'X| ) ]

using the exact identities (pinned by tests/test_oracle.py):
  sum_i ln(xi_i + d)        == ln|H| + ln|X'H^-1X| - ln|X'X|
  sum_i eta_i^2/(xi_i + d)  == yPy = y'H^-1y - b'A^-1 b,
with A = X'H^-1X and b = X'H^-1y reduced to WEIGHTED MOMENTS of the
rotated data (w = 1/(phi+d)): every per-SNP, per-delta quantity is a
matmul over the SNP tile plus an O(p^2) epilogue — no eigh, no LAPACK,
fully vmap/tile-able. p = q+1 stays tiny, so the p x p solves are an
unrolled Cholesky (pure elementwise ops, no custom calls).

The same machinery with M=1 gives the per-step re-REML of stepwise MLMM
(X = [intercept | cofactor SNPs]) in milliseconds.
"""

from __future__ import annotations

import functools
from typing import Dict

import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# small-matrix linear algebra (unrolled, batched, no LAPACK custom calls)
# ---------------------------------------------------------------------------

def chol_small(A: jnp.ndarray) -> jnp.ndarray:
    """Cholesky of (..., p, p) SPD matrices with p small & static, unrolled
    into elementwise ops (batches under vmap, where a LAPACK-style custom
    call per matrix would not)."""
    p = A.shape[-1]
    L = [[None] * p for _ in range(p)]
    for i in range(p):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                # dtype-aware clamp (1e-300 underflows to 0 in float32)
                L[i][j] = jnp.sqrt(jnp.maximum(s, jnp.finfo(A.dtype).tiny))
            else:
                L[i][j] = s / L[j][j]
    rows = [jnp.stack([L[i][j] if j <= i else jnp.zeros_like(A[..., 0, 0])
                       for j in range(p)], axis=-1) for i in range(p)]
    return jnp.stack(rows, axis=-2)


def chol_solve_small(L: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve A x = b given L = chol(A), batched, unrolled."""
    p = L.shape[-1]
    y = [None] * p
    for i in range(p):
        s = b[..., i]
        for k in range(i):
            s = s - L[..., i, k] * y[k]
        y[i] = s / L[..., i, i]
    x = [None] * p
    for i in reversed(range(p)):
        s = y[i]
        for k in range(i + 1, p):
            s = s - L[..., k, i] * x[k]
        x[i] = s / L[..., i, i]
    return jnp.stack(x, axis=-1)


def inv_small(A: jnp.ndarray) -> jnp.ndarray:
    """Inverse of small SPD (..., p, p) matrices via the unrolled Cholesky
    (no LAPACK)."""
    p = A.shape[-1]
    L = chol_small(A)
    eye = jnp.eye(p, dtype=A.dtype)
    cols = [chol_solve_small(
        L, jnp.broadcast_to(eye[i], A.shape[:-2] + (p,))) for i in range(p)]
    return jnp.stack(cols, axis=-1)


def chol_logdet_small(L: jnp.ndarray) -> jnp.ndarray:
    p = L.shape[-1]
    out = jnp.zeros_like(L[..., 0, 0])
    for i in range(p):
        out = out + jnp.log(L[..., i, i])
    return 2.0 * out


# ---------------------------------------------------------------------------
# explicit-design likelihood from weighted moments
# ---------------------------------------------------------------------------

def _ll_from_moments(A, b, c, logdet_H, logdet_XtX, n: int, p: int,
                     reml: bool):
    """(RE)ML log-likelihood given A = X'H^-1X (..., p, p),
    b = X'H^-1y (..., p), c = y'H^-1y (...), and log-determinants."""
    L = chol_small(A)
    beta = chol_solve_small(L, b)
    ypy = c - jnp.sum(b * beta, axis=-1)
    # dtype-aware floor: 1e-300 underflows to 0.0 in float32, which would
    # let a cancellation-driven ypy <= 0 produce LL = +inf and win the
    # candidate argmax (same hazard chol_small guards against).
    ypy = jnp.maximum(ypy, jnp.finfo(ypy.dtype).tiny)
    if reml:
        scale = n - p
        logdet = logdet_H + chol_logdet_small(L) - logdet_XtX
    else:
        scale = n
        logdet = logdet_H
    ll = 0.5 * (scale * (jnp.log(scale / (2.0 * jnp.pi)) - 1.0
                         - jnp.log(ypy)) - logdet)
    return ll, ypy, beta


@functools.partial(jax.jit, static_argnames=("reml",))
def ll_explicit(logdelta, phi, y_rot, X_rot, reml: bool = True):
    """LL for ONE design X_rot (n, p) at scalar/batched logdelta.
    y_rot = U'y, X_rot = U'X (kinship eigenbasis). Batched over logdelta's
    leading dims."""
    logdelta = jnp.asarray(logdelta)
    d = jnp.exp(logdelta)[..., None]
    w = 1.0 / (phi + d)                                    # (..., n)
    n, p = X_rot.shape
    A = jnp.einsum("...n,np,nq->...pq", w, X_rot, X_rot)
    b = jnp.einsum("...n,np,n->...p", w, X_rot, y_rot)
    c = jnp.sum(w * y_rot**2, axis=-1)
    logdet_H = jnp.sum(jnp.log(phi + d), axis=-1)
    XtX = X_rot.T @ X_rot
    logdet_XtX = chol_logdet_small(chol_small(XtX))
    ll, _, _ = _ll_from_moments(A, b, c, logdet_H, logdet_XtX, n, p, reml)
    return ll


@functools.partial(jax.jit, static_argnames=("ngrids", "refine_iters", "reml"))
def explicit_reml(phi, y_rot, X_rot, ngrids: int = 100, llim: float = -10.0,
                  ulim: float = 10.0, refine_iters: int = 32,
                  reml: bool = True) -> Dict[str, jnp.ndarray]:
    """Single-design REML/ML via grid + bisection on d(LL)/d(logdelta)
    (autodiff). Exactly equals the projected-spectrum optimizer (ops.reml)
    by the determinant/quadratic identities; used for the per-step re-REML
    of stepwise MLMM where X changes every step but eigh(K) is reused."""
    grid = jnp.linspace(llim, ulim, ngrids + 1, dtype=y_rot.dtype)
    ll_fn = lambda g: ll_explicit(g, phi, y_rot, X_rot, reml=reml)
    dll_fn = jax.vmap(jax.grad(
        lambda g: ll_explicit(g, phi, y_rot, X_rot, reml=reml)))
    dll = dll_fn(grid)
    is_bracket = (dll[:-1] > 0) & (dll[1:] < 0)

    def body(_, lohis):
        lo, hi = lohis
        mid = (lo + hi) / 2.0
        dmid = dll_fn(mid)
        return (jnp.where(dmid > 0, mid, lo), jnp.where(dmid > 0, hi, mid))

    lo, hi = jax.lax.fori_loop(0, refine_iters, body, (grid[:-1], grid[1:]))
    roots = (lo + hi) / 2.0
    cands = jnp.concatenate([roots, jnp.array([llim, ulim], dtype=roots.dtype)])
    valid = jnp.concatenate([is_bracket, jnp.array([True, True])])
    lls = jnp.where(valid, ll_fn(cands), -jnp.inf)
    j = jnp.argmax(lls)
    log_delta = cands[j]
    delta = jnp.exp(log_delta)
    n, p = X_rot.shape
    w = 1.0 / (phi + delta)
    A = jnp.einsum("n,np,nq->pq", w, X_rot, X_rot)
    b = jnp.einsum("n,np,n->p", w, X_rot, y_rot)
    L = chol_small(A)
    beta = chol_solve_small(L, b)
    ypy = jnp.sum(w * y_rot**2) - jnp.sum(b * beta)
    scale = (n - p) if reml else n
    sg2 = ypy / scale
    return {"log_delta": log_delta, "delta": delta, "ll": lls[j],
            "sigma_g2": sg2, "sigma_e2": delta * sg2,
            "pseudo_heritability": 1.0 / (1.0 + delta), "beta": beta}


# ---------------------------------------------------------------------------
# batched per-SNP EMMA: grid scan with SHARED matmuls, then per-SNP
# bisection refinement in the argmax bracket
# ---------------------------------------------------------------------------

def _snp_moments(Gt, X0_rot, y_rot, w):
    """Weighted moments for designs [X0 | g_j], one SNP per row of Gt.

    Gt: (m, n) rotated SNPs; w: (..., n) weights (grid of deltas or
    per-SNP (m, n)). Returns per-SNP blocks to assemble A (p x p), b, c.
    All contractions are matmul-shaped."""
    # shared null blocks
    W0 = X0_rot * w[..., :, None] if w.ndim == 1 else None
    if w.ndim == 1:
        A00 = X0_rot.T @ W0                          # (q, q)
        b0 = W0.T @ y_rot                            # (q,)
        c = jnp.sum(w * y_rot**2)
        a01 = Gt @ W0                                # (m, q)
        a11 = (Gt * Gt) @ w                          # (m,)
        b1 = Gt @ (w * y_rot)                        # (m,)
        return A00, b0, c, a01, a11, b1
    # per-SNP weights: w is (m, n)
    WG = w * Gt
    q = X0_rot.shape[1]
    Xprod = (X0_rot[:, :, None] * X0_rot[:, None, :]).reshape(
        X0_rot.shape[0], q * q)
    A00 = (w @ Xprod).reshape(-1, q, q)              # (m, q, q)
    b0 = (w * y_rot[None, :]) @ X0_rot               # (m, q)
    c = w @ (y_rot**2)                               # (m,)
    a01 = jnp.einsum("mn,nq->mq", WG, X0_rot)        # (m, q)
    a11 = jnp.sum(WG * Gt, axis=1)                   # (m,)
    b1 = WG @ y_rot                                  # (m,)
    return A00, b0, c, a01, a11, b1


def _assemble(A00, b0, c, a01, a11, b1):
    """Blocks -> A (m, p, p), b (m, p), c (m,) with p = q + 1."""
    m = a11.shape[0]
    if A00.ndim == 2:
        q = A00.shape[0]
        A00b = jnp.broadcast_to(A00, (m, q, q))
        b0b = jnp.broadcast_to(b0, (m, q))
        cb = jnp.broadcast_to(c, (m,))
    else:
        q = A00.shape[-1]
        A00b, b0b, cb = A00, b0, c
    top = jnp.concatenate([A00b, a01[:, :, None]], axis=2)
    bot = jnp.concatenate([a01[:, None, :], a11[:, None, None]], axis=2)
    A = jnp.concatenate([top, bot], axis=1)
    b = jnp.concatenate([b0b, b1[:, None]], axis=1)
    return A, b, cb


def _ll_snps_at(logdelta, Gt, X0_rot, y_rot, phi, logdet_XtX, reml: bool):
    """Per-SNP LL at per-SNP logdelta (m,). Used by the bisection refine."""
    d = jnp.exp(logdelta)[:, None]
    w = 1.0 / (phi[None, :] + d)                    # (m, n)
    A00, b0, c, a01, a11, b1 = _snp_moments(Gt, X0_rot, y_rot, w)
    A, b, cc = _assemble(A00, b0, c, a01, a11, b1)
    n = phi.shape[0]
    p = X0_rot.shape[1] + 1
    logdet_H = jnp.sum(jnp.log(phi[None, :] + d), axis=1)
    ll, ypy, beta = _ll_from_moments(A, b, cc, logdet_H, logdet_XtX, n, p,
                                     reml)
    return ll, ypy, beta


@functools.partial(jax.jit,
                   static_argnames=("ngrids", "refine_iters", "reml"))
def emma_delta_scan(Gt, X0_rot, y_rot, phi, logdet_XtX_all,
                    ngrids: int = 100, llim: float = -10.0,
                    ulim: float = 10.0, refine_iters: int = 32,
                    reml: bool = True) -> Dict[str, jnp.ndarray]:
    """Per-SNP REML delta for designs [X0 | g_j] over a tile of SNPs.

    Grid phase: shared weight vectors across SNPs -> the moments are a few
    (m, n) matmuls per grid point. Refinement: bisection inside the grid
    interval bracketing each SNP's LL argmax (matches the reference's
    refine-roots-then-argmax for unimodal likelihoods, which REML in one
    variance ratio essentially always is; the grid argmax guards the rest).

    logdet_XtX_all: (m,) precomputed ln|[X0 g_j]'[X0 g_j]| per SNP.
    Returns log_delta, delta, ll, ypy (= GLS RSS of the FULL model at the
    per-SNP delta) and beta (p,) per SNP.
    """
    m, n = Gt.shape
    grid = jnp.linspace(llim, ulim, ngrids + 1, dtype=y_rot.dtype)
    p = X0_rot.shape[1] + 1

    def grid_eval(logd):
        d = jnp.exp(logd)
        w = 1.0 / (phi + d)                          # (n,)
        A00, b0, c, a01, a11, b1 = _snp_moments(Gt, X0_rot, y_rot, w)
        A, b, cc = _assemble(A00, b0, c, a01, a11, b1)
        logdet_H = jnp.sum(jnp.log(phi + d))
        ll, _, _ = _ll_from_moments(A, b, cc, logdet_H, logdet_XtX_all,
                                    n, p, reml)
        return ll                                    # (m,)

    lls_grid = jax.lax.map(grid_eval, grid)          # (ngrids+1, m)
    k1 = jnp.argmax(lls_grid, axis=0)                # (m,) global grid argmax
    # second candidate: best grid point NOT adjoining the argmax bracket —
    # covers multimodal surfaces the way the reference's refine-every-
    # sign-change-root-then-argmax does, at 2x refine cost instead of
    # ngrids x (the grid already localizes every local max to +-1 cell)
    idx = jnp.arange(ngrids + 1)
    masked = jnp.where(jnp.abs(idx[:, None] - k1[None, :]) > 1,
                       lls_grid, -jnp.inf)
    k2 = jnp.argmax(masked, axis=0)                  # (m,)

    def dll_at(logd_vec):
        f = lambda g: jnp.sum(
            _ll_snps_at(g, Gt, X0_rot, y_rot, phi, logdet_XtX_all, reml)[0])
        return jax.grad(f)(logd_vec)                 # (m,) per-SNP dLL

    def refine(k):
        # bracket = [grid[k-1], grid[k+1]] clipped: the interior max lies
        # in one of the two intervals adjoining the local grid argmax
        lo = grid[jnp.maximum(k - 1, 0)]
        hi = grid[jnp.minimum(k + 1, ngrids)]

        def body(_, lohis):
            lo, hi = lohis
            mid = (lo + hi) / 2.0
            dmid = dll_at(mid)
            return (jnp.where(dmid > 0, mid, lo),
                    jnp.where(dmid > 0, hi, mid))

        lo, hi = jax.lax.fori_loop(0, refine_iters, body, (lo, hi))
        return (lo + hi) / 2.0

    # candidates per SNP: the raw grid argmax FIRST (guards boundary
    # solutions and NaN refinements), then the refined argmax bracket and
    # the refined runner-up bracket. A NaN candidate never wins
    # (NaN > x is False), and starting from the grid argmax restores the
    # pre-rewrite guarantee that a NaN refined likelihood falls back to
    # the finite grid solution.
    cands = [grid[k1], refine(k1), refine(k2)]
    log_delta = cands[0]
    ll, ypy, beta = _ll_snps_at(log_delta, Gt, X0_rot, y_rot, phi,
                                logdet_XtX_all, reml)
    for c in cands[1:]:
        ll_c, ypy_c, beta_c = _ll_snps_at(c, Gt, X0_rot, y_rot, phi,
                                          logdet_XtX_all, reml)
        take = (ll_c > ll) | (jnp.isnan(ll) & ~jnp.isnan(ll_c))
        log_delta = jnp.where(take, c, log_delta)
        ypy = jnp.where(take, ypy_c, ypy)
        beta = jnp.where(take[:, None], beta_c, beta)
        ll = jnp.where(take, ll_c, ll)
    return {"log_delta": log_delta, "delta": jnp.exp(log_delta), "ll": ll,
            "ypy": ypy, "beta": beta}
