"""Symmetric eigendecompositions for the mixed-model core.

Reference equivalents: LinearMixedModel._get_eigen_L_ (eigh of K) and
_get_eigen_R_ (eigh of S(K+I)S) in linear_models.py (SURVEY.md §2.1).

eigh is the one O(n^3) step and runs ONCE per (K, X) pair, so it is not
on the throughput path, but at n=10k it is the largest single wall of a
study. The default is host=True: float64 LAPACK on the host, results
device_put. On an H100 the device path (cuSOLVER, in the device dtype:
float32 in production) is far faster, but its float32 eigenvectors move
the REML h2 and the exact tier's p-values outside the float32 envelope
that the host path holds (PERF.md, Findings). Everything downstream
(REML grid, scan) is matmul/elementwise and stays on device.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _host_eigh(a, factor_dtype=np.float64) -> Tuple[np.ndarray, np.ndarray]:
    # numpy.linalg.eigh routes to LAPACK dsyevd (divide & conquer);
    # factor_dtype=np.float32 runs ssyevd instead, with half the
    # workspace (the fast-tier option: the device consumes U in f32)
    w, v = np.linalg.eigh(np.asarray(a, dtype=factor_dtype))
    return w, v


def eigen_k(K, host: bool = True, factor_dtype=None
            ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """eigh(K) -> (phi, U), eigenvalues DESCENDING (EMMA convention).

    factor_dtype: host factorization dtype (None = float64 = exact
    default; np.float32 = ssyevd fast tier)."""
    if host:
        # canonicalize the dtype WITHOUT a device round-trip (a
        # jnp.asarray(K).dtype probe would upload the full (n, n) K)
        dt = (jax.dtypes.canonicalize_dtype(K.dtype)
              if hasattr(K, "dtype") else None)
        w, v = _host_eigh(K, np.float64 if factor_dtype is None
                          else factor_dtype)
        phi = jnp.asarray(w[::-1].copy(), dtype=dt)
        U = jnp.asarray(v[:, ::-1].copy(), dtype=dt)
        return phi, U
    w, v = jnp.linalg.eigh(jnp.asarray(K))
    return w[::-1], v[:, ::-1]


def projected_spectrum(K, X, host: bool = True
                       ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Spectrum of S(K+I)S with S = I - X(X'X)^-1 X' (A.2 step 2).

    Returns (xi, V): the n-q nonzero eigenvalues minus the +1 shift
    (descending) and their eigenvectors (n, n-q). The +I shift keeps the
    matrix positive definite on range(S) so the nonzero/null split is clean.
    """
    if host:
        # dtype WITHOUT a device round-trip (as in eigen_k)
        dt = (jax.dtypes.canonicalize_dtype(K.dtype)
              if hasattr(K, "dtype") else None)
        Kh = np.asarray(K, dtype=np.float64)
        Xh = np.atleast_2d(np.asarray(X, dtype=np.float64))
        n, q = Xh.shape
        S_X = np.linalg.solve(Xh.T @ Xh, Xh.T)
        KI = Kh + np.eye(n)
        SKI = KI - Xh @ (S_X @ KI)
        M = SKI - (SKI @ Xh) @ S_X
        M = (M + M.T) / 2.0
        w, v = _host_eigh(M)
        xi = jnp.asarray(w[::-1][: n - q] - 1.0, dtype=dt)
        V = jnp.asarray(v[:, ::-1][:, : n - q].copy(), dtype=dt)
        return xi, V
    K = jnp.asarray(K)
    X = jnp.atleast_2d(jnp.asarray(X)).astype(K.dtype)
    n, q = X.shape
    XtX = X.T @ X
    S_X = jnp.linalg.solve(XtX, X.T)
    KI = K + jnp.eye(n, dtype=K.dtype)
    SKI = KI - X @ (S_X @ KI)
    M = SKI - (SKI @ X) @ S_X
    M = (M + M.T) / 2
    w, v = jnp.linalg.eigh(M)
    xi = w[::-1][: n - q] - 1.0
    V = v[:, ::-1][:, : n - q]
    return xi, V


def orthonormal_basis(X: jnp.ndarray) -> jnp.ndarray:
    """Orthonormal basis of span(X) for tall-skinny X (n, q): Gram matrix
    on device, q x q Cholesky on host (q is tiny), back-substitution as a
    matmul. Used once per scan."""
    X = jnp.atleast_2d(jnp.asarray(X))
    C = np.asarray(X.T @ X, dtype=np.float64)
    L = np.linalg.cholesky(C)
    Linv_T = jnp.asarray(np.linalg.inv(L).T, dtype=X.dtype)
    return X @ Linv_T
