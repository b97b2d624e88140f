"""Oracle kinship construction (SURVEY.md Appendix A.1).

Reference shape: kinship.py calc_ibs_kinship / calc_ibd_kinship accumulate
over SNP chunks with BLAS dgemm (SURVEY.md §3.4); scale_k normalizes the
mean diagonal to 1; prepare_k subsets/reorders to phenotyped samples.

Genotype convention throughout the framework:
  Z: (M, n) int/float dosage matrix, rows = SNPs, cols = samples.
  Binary coding (inbred lines, the reference's bundled Arabidopsis data):
  values in {0, 1}. Diploid coding: {0, 1, 2}. Missing = NaN (imputed by
  per-SNP mean BEFORE kinship/scan — the documented rule shared by oracle
  and device kernels, SURVEY.md A.1).
"""

from __future__ import annotations

import numpy as np


def _chunks(m: int, chunk: int):
    for s in range(0, m, chunk):
        yield s, min(s + chunk, m)


def mean_impute(Z: np.ndarray) -> np.ndarray:
    """Per-SNP mean imputation of NaNs (the normative missing-data rule)."""
    Z = np.asarray(Z, dtype=np.float64)
    if not np.isnan(Z).any():
        return Z
    means = np.nanmean(Z, axis=1)
    idx = np.where(np.isnan(Z))
    Z = Z.copy()
    Z[idx] = means[idx[0]]
    return Z


def ibs_kinship(Z: np.ndarray, ploidy: int = 1, chunk: int = 1024) -> np.ndarray:
    """Identity-by-state allele-sharing kinship.

    Binary coding (ploidy=1): K = (Z^T Z + (1-Z)^T (1-Z)) / M — the fraction
    of shared alleles between each sample pair (A.1).
    Diploid coding (ploidy=2): K_ij = mean_m (1 - |Z_mi - Z_mj| / 2),
    expanded into gram matrices over one-hot channels so the accumulation is
    matmul-shaped like the reference's chunked dgemm loop.
    """
    Z = mean_impute(Z)
    m, n = Z.shape
    K = np.zeros((n, n), dtype=np.float64)
    if ploidy == 1:
        for s, e in _chunks(m, chunk):
            Zc = Z[s:e]
            K += Zc.T @ Zc + (1.0 - Zc).T @ (1.0 - Zc)
        return K / m
    elif ploidy == 2:
        # |a-b| = (a-b)^2 - 2*[a=0][b=2] - 2*[a=2][b=0]  for a,b in {0,1,2}
        # (exact for integer dosages; imputed fractional dosages use the
        #  quadratic surrogate (a-b)^2/2 clipped — we instead round-free
        #  compute with the exact formula on the imputed values, where the
        #  indicator terms use soft one-hot weights max(0, 1-|a-g|)).
        for s, e in _chunks(m, chunk):
            Zc = Z[s:e]
            # matmul-shaped expansion: (a-b)^2 = a^2 + b^2 - 2ab
            ones = np.ones((e - s, 1))
            a2 = (Zc**2).T @ ones  # (n,1) per-chunk sums of squares
            ab = Zc.T @ Zc
            d2 = a2 + a2.T - 2.0 * ab
            w0 = np.clip(1.0 - np.abs(Zc - 0.0), 0.0, None)
            w2 = np.clip(1.0 - np.abs(Zc - 2.0), 0.0, None)
            corr = w0.T @ w2
            absd = d2 - 2.0 * (corr + corr.T)
            K += (2.0 * (e - s) - absd) / 2.0
        return K / m
    else:
        raise ValueError(f"unsupported ploidy {ploidy}")


def vanraden_kinship(Z: np.ndarray, ploidy: int = 2, chunk: int = 1024) -> np.ndarray:
    """VanRaden / 'IBD' kinship: W = Z - ploidy*p (centered by per-SNP allele
    frequency); K = W^T W / (ploidy * sum_j p_j (1 - p_j)) (A.1)."""
    Z = mean_impute(Z)
    m, n = Z.shape
    p = Z.mean(axis=1) / ploidy  # allele frequency per SNP
    denom = ploidy * np.sum(p * (1.0 - p))
    K = np.zeros((n, n), dtype=np.float64)
    for s, e in _chunks(m, chunk):
        W = Z[s:e] - (ploidy * p[s:e])[:, None]
        K += W.T @ W
    return K / denom


def scale_k(K: np.ndarray) -> np.ndarray:
    """Normalize so that mean(diag(K)) == 1 (reference: kinship.scale_k).

    mixmogam's scale_k recenters via the quadratic form with the centering
    projector; the normative behavior we pin is the diagonal normalization:
    K / mean(diag(K)).
    """
    c = np.mean(np.diag(K))
    return K / c


def prepare_k(K: np.ndarray, k_accessions, accessions) -> np.ndarray:
    """Subset/reorder K's rows+cols from k_accessions order to accessions
    order (reference: kinship.prepare_k)."""
    index = {a: i for i, a in enumerate(k_accessions)}
    idx = np.array([index[a] for a in accessions], dtype=np.int64)
    return K[np.ix_(idx, idx)]
