"""Device kinship construction (SURVEY.md A.1, L3).

Reference equivalent: kinship.py calc_ibs_kinship / calc_ibd_kinship —
a chunked Python loop of BLAS dgemms (SURVEY.md §3.4). Device design:
the same streaming-chunk contract (it is also the multi-host psum boundary,
§2.3), but each chunk's contribution is ONE device GEMM plus rank-1
corrections:

  IBS binary:  C'C + (1-C)'(1-C) = 2 C'C - s (x) 1 - 1 (x) s + m J
               (s = per-sample chunk sums) — half the naive matmul flops.
  VanRaden:    W = C - ploidy * p;  K += W'W;  denom += ploidy*sum p(1-p).

Chunks are padded to a static shape (zero rows + the true row count as a
scalar arg) so there is exactly one compile. Mean imputation of missing
genotypes happens per chunk on host before transfer (the normative rule,
shared with the oracle)."""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

#: precision of every int8 x int8 -> int32 dot (kinship grams, the int8
#: scan tiers). On the GPU, XLA hands an s8 dot at HIGHEST to cuBLAS's
#: integer GEMM. At DEFAULT it may emit its own Triton GEMM instead,
#: which on jax 0.9.0 miscomputed the diploid update below (|dK| 0.11
#: against the oracle at n=200; PERF.md, Findings). Integer accumulation
#: is exact in both.
_INT8_PREC = jax.lax.Precision.HIGHEST


@functools.partial(jax.jit, donate_argnums=(0,))
def _ibs_int8_update(S_acc, C, m_eff):
    """Integer-exact IBS sharing-count accumulation as an int8 GEMM:
    S += 2 C'C - s(x)1 - 1(x)s + m J with int8 inputs, int32 accumulate.
    Zero floating-point error; ~4x less HBM traffic than fp32 tiles.
    Output dtype == S_acc dtype (jnp.sum would promote to int64 under
    x64, which breaks fori_loop carries — models.resident fuses this
    update into one)."""
    d = jax.lax.dot_general(C, C, (((0,), (0,)), ((), ())),
                            preferred_element_type=jnp.int32,
                            precision=_INT8_PREC)
    s = jnp.sum(C.astype(jnp.int32), axis=0, dtype=jnp.int32)
    m = jnp.asarray(m_eff, jnp.int32)
    return S_acc + (2 * d - s[:, None] - s[None, :] + m).astype(S_acc.dtype)


def _streamed_int8_chunks(mat: np.ndarray, chunk: int, pad_value: int):
    """Generator of (device int8 chunk, m_eff) with the host-side prep
    (memmap read, padding) running ONE chunk ahead in a worker thread
    (models.source.prefetch_iter), so host prep overlaps the previous
    chunk's transfer and gram."""
    from mixmogam_tpu.models.source import prefetch_iter

    M, n = mat.shape

    def prep(s):
        e = min(s + chunk, M)
        C = np.ascontiguousarray(mat[s:e])
        if e - s < chunk:
            C = np.vstack([C, np.full((chunk - (e - s), n), pad_value,
                                      np.int8)])
        return C, e - s

    for _s, (host_arr, m_eff) in prefetch_iter(range(0, M, chunk), prep):
        yield jnp.asarray(host_arr), m_eff


def _ibs_int8_streamed(mat: np.ndarray, chunk: int) -> np.ndarray:
    """Streaming int8 IBS for fully-observed binary genotypes. Tiles ship
    as raw int8; host prep is prefetch-threaded."""
    M, n = mat.shape
    S = jnp.zeros((n, n), dtype=jnp.int32)
    for Cd, m_eff in _streamed_int8_chunks(mat, chunk, 0):
        S = _ibs_int8_update(S, Cd, m_eff)
    return np.asarray(S).astype(np.float64) / M


@functools.partial(jax.jit, donate_argnums=(0,))
def _ibs_diploid_int8_update(S2_acc, C, m_eff):
    """Diploid IBS, integer-exact: accumulates 2*m - sum|a-b| (TWICE the
    per-pair sharing) in int32. |a-b| = (a-b)^2 - 2([a=0][b=2]+[a=2][b=0])
    for a,b in {0,1,2}; every term is an int8 GEMM."""
    CtC = jax.lax.dot_general(C, C, (((0,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32,
                              precision=_INT8_PREC)
    a2 = jnp.sum((C * C).astype(jnp.int32), axis=0, dtype=jnp.int32)
    d2 = a2[:, None] + a2[None, :] - 2 * CtC
    W0 = (C == 0).astype(jnp.int8)
    W2 = (C == 2).astype(jnp.int8)
    corr = jax.lax.dot_general(W0, W2, (((0,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32,
                               precision=_INT8_PREC)
    absd = d2 - 2 * (corr + corr.T)
    m = jnp.asarray(m_eff, jnp.int32)
    # dtype-stable output (see _ibs_int8_update)
    return S2_acc + (2 * m - absd).astype(S2_acc.dtype)


def _ibs_diploid_int8_streamed(mat: np.ndarray, chunk: int) -> np.ndarray:
    """Streaming integer-exact diploid IBS (fully observed 0/1/2). Tiles
    ship as raw int8, prefetch-threaded. Pad rows use -1: in no indicator
    class (W0/W2 are 0), and the (a-b)^2 pad contribution cancels — a2=1, CtC
    pad pair = +1, d2 = 1+1-2 = 0 — so only the 2*m_eff term (which
    counts real rows) sees the pad."""
    M, n = mat.shape
    S2 = jnp.zeros((n, n), dtype=jnp.int32)
    for Cd, m_eff in _streamed_int8_chunks(mat, chunk, -1):
        S2 = _ibs_diploid_int8_update(S2, Cd, m_eff)
    return np.asarray(S2).astype(np.float64) / (2.0 * M)


@functools.partial(jax.jit, donate_argnums=(0,))
def _ibs_binary_update(K_acc, C, m_eff):
    """K_acc += 2 C'C - s(x)1 - 1(x)s + m_eff * J  (zero pad rows drop out
    of C'C and s; m_eff counts only real rows)."""
    CtC = jnp.dot(C.T, C, preferred_element_type=K_acc.dtype)
    s = jnp.sum(C, axis=0).astype(K_acc.dtype)
    return K_acc + 2.0 * CtC - s[:, None] - s[None, :] + m_eff


@functools.partial(jax.jit, donate_argnums=(0,))
def _vanraden_update(K_acc, W):
    """K_acc += W'W (pad rows are all-zero)."""
    return K_acc + jnp.dot(W.T, W, preferred_element_type=K_acc.dtype)


@functools.partial(jax.jit, donate_argnums=(0,))
def _ibs_diploid_update(K_acc, C, W0, W2, m_eff):
    """Diploid IBS sharing via |a-b| = (a-b)^2 - 2([a=0][b=2]+[a=2][b=0]):
    accumulates sum over chunk of (2 - |a-b|)/2 (see oracle.kinship)."""
    dt = K_acc.dtype
    CtC = jnp.dot(C.T, C, preferred_element_type=dt)
    a2 = jnp.sum(C * C, axis=0).astype(dt)
    d2 = a2[:, None] + a2[None, :] - 2.0 * CtC
    corr = jnp.dot(W0.T, W2, preferred_element_type=dt)
    absd = d2 - 2.0 * (corr + corr.T)
    return K_acc + (2.0 * m_eff - absd) / 2.0


def _impute_chunk(chunk: np.ndarray, dtype) -> np.ndarray:
    """(m, n) chunk -> float, per-SNP mean imputed (signed integer: < 0 =
    missing; float: NaN = missing — the normative rule shared with the
    oracle)."""
    if np.issubdtype(chunk.dtype, np.integer):
        miss = chunk < 0
        C = chunk.astype(np.float64)
        if miss.any():
            C[miss] = np.nan
    else:
        C = chunk.astype(np.float64)
        miss = np.isnan(C)
    if miss.any():
        mu = np.nanmean(C, axis=1)
        mu = np.where(np.isnan(mu), 0.0, mu)
        idx = np.where(miss)
        C[idx] = mu[idx[0]]
    return C.astype(dtype)


def kinship(data, method: str = "ibs", ploidy: Optional[int] = None,
            chunk: int = 2048, dtype=jnp.float32,
            use_device: bool = True) -> np.ndarray:
    """Build a kinship matrix from a GenotypeData or an (M, n) dosage array.

    method: 'ibs' (allele sharing) or 'vanraden' (a.k.a. 'ibd' in the
    reference's naming). Returns an (n, n) float64 numpy array (the small
    result lives host-side; downstream eigh is host by default too).
    """
    from mixmogam_tpu.data.genotype import GenotypeData
    from mixmogam_tpu.models.resident import ResidentGenome

    if isinstance(data, ResidentGenome):
        from mixmogam_tpu.models.resident import kinship_resident

        if not use_device:
            raise ValueError("a ResidentGenome lives in device HBM; "
                             "use_device=False needs a host source")
        return kinship_resident(data, method=method, ploidy=ploidy,
                                dtype=dtype)
    if isinstance(data, GenotypeData):
        mat = data.matrix
        ploidy = data.ploidy if ploidy is None else ploidy
    else:
        mat = np.asarray(data)
        if ploidy is None:
            ploidy = 2 if mat.max(initial=0) > 1 else 1
    M, n = mat.shape
    if method in ("vanraden", "ibd"):
        return _vanraden(mat, ploidy, chunk, dtype, use_device)
    if method != "ibs":
        raise ValueError(f"unknown kinship method {method!r}")
    if not use_device:
        from mixmogam_tpu import oracle

        Z = mat.astype(np.float64)
        if np.issubdtype(mat.dtype, np.integer):
            Z[mat < 0] = np.nan
        return oracle.ibs_kinship(Z, ploidy=ploidy)

    # int8 GEMM paths: fully-observed integer coding -> integer-exact
    # sharing counts (see _ibs_int8_update).
    # missing-check runs CHUNKED: one (M, n) bool temp is 10.7 GB at the
    # flagship scale, as large as the source itself (review finding)
    def _any_negative(m_):
        return any((np.asarray(m_[s:s + chunk]) < 0).any()
                   for s in range(0, m_.shape[0], chunk))

    if mat.dtype == np.int8 and not _any_negative(mat):
        if ploidy == 1:
            return _ibs_int8_streamed(mat, chunk)
        if ploidy == 2:
            return _ibs_diploid_int8_streamed(mat, chunk)

    K = jnp.zeros((n, n), dtype=dtype)
    for s in range(0, M, chunk):
        e = min(s + chunk, M)
        C = _impute_chunk(np.asarray(mat[s:e]), np.dtype(dtype).name)
        m = e - s
        if m < chunk:
            C = np.vstack([C, np.zeros((chunk - m, n), dtype=C.dtype)])
        Cd = jnp.asarray(C)
        if ploidy == 1:
            K = _ibs_binary_update(K, Cd, float(m))
        else:
            W0 = jnp.clip(1.0 - jnp.abs(Cd - 0.0), 0.0, None)
            W2 = jnp.clip(1.0 - jnp.abs(Cd - 2.0), 0.0, None)
            # zero pad rows look like genotype 0 -> W0 pad rows are 1;
            # mask them off
            if m < chunk:
                rowmask = jnp.asarray(
                    (np.arange(chunk) < m).astype(C.dtype))[:, None]
                W0 = W0 * rowmask
                W2 = W2 * rowmask
            K = _ibs_diploid_update(K, Cd, W0, W2, float(m))
    return np.asarray(K, dtype=np.float64) / M


def _vanraden(mat: np.ndarray, ploidy: int, chunk: int, dtype,
              use_device: bool) -> np.ndarray:
    from mixmogam_tpu import oracle

    M, n = mat.shape
    if not use_device:
        Z = mat.astype(np.float64)
        if np.issubdtype(mat.dtype, np.integer):
            Z[mat < 0] = np.nan
        return oracle.vanraden_kinship(Z, ploidy=ploidy)
    K = jnp.zeros((n, n), dtype=dtype)
    denom = 0.0
    for s in range(0, M, chunk):
        e = min(s + chunk, M)
        C = _impute_chunk(np.asarray(mat[s:e]), np.dtype(dtype).name)
        p = C.mean(axis=1) / ploidy
        denom += float(ploidy * np.sum(p * (1.0 - p)))
        W = C - (ploidy * p)[:, None]
        m = e - s
        if m < chunk:
            W = np.vstack([W, np.zeros((chunk - m, n), dtype=W.dtype)])
        K = _vanraden_update(K, jnp.asarray(W))
    return np.asarray(K, dtype=np.float64) / denom
