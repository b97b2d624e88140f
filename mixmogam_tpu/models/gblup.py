"""gBLUP genomic prediction (capability extension).

The reference (mixmogam) stops at association: it fits the null mixed
model y = X0*beta + u + e, u ~ N(0, sg2*K), only to whiten the scan
(SURVEY.md Appendix A.2/A.3; the reference mount was empty). The same
fitted model IS the gBLUP predictor of breeding values — the standard
genomic-prediction workhorse (VanRaden 2008; Henderson's mixed-model
equations) — so this module exposes it: fit once on phenotyped samples,
predict genetic values for any samples covered by the kinship.

All algebra rides the eigenbasis the package already computes:

  H = K + delta*I  (up to sg2);  H^-1 = U diag(1/(phi+delta)) U'
  beta_hat = GLS estimate of the fixed effects (X0' H^-1 X0)^-1 X0' H^-1 y
  u_hat    = K H^-1 (y - X0 beta_hat)           (BLUP, train samples)
  u_new    = K_cross H^-1 (y - X0 beta_hat)     (any samples; K_cross is
                                                 their kinship rows vs train)

Prediction is O(n^2) once — like the eigh, it runs in float64 on host
(the one-time decompositions policy, ops/eigen.py); the O(M n)
kinship that feeds it uses the device int8 GEMM path as usual.

PEV / reliability: prediction error variance of u_hat_i is
sg2 * (K - K H^-1 K + K H^-1 X0 (X0'H^-1 X0)^-1 X0' H^-1 K)_ii
(from the MME inverse); reliability r^2_i = 1 - PEV_i / (sg2 * K_ii).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class GblupModel:
    """Fitted gBLUP model (all float64 host arrays)."""

    beta: np.ndarray              # (q,) GLS fixed-effect estimates
    u_hat: np.ndarray             # (n,) BLUP breeding values, train order
    delta: float                  # REML variance ratio sigma_e2/sigma_g2
    sigma_g2: float
    sigma_e2: float
    pseudo_heritability: float
    fitted: np.ndarray            # (n,) X0 @ beta + u_hat
    # internals for out-of-sample prediction
    _hinv_r: np.ndarray           # (n,) H^-1 (y - X0 beta_hat)
    _X0: np.ndarray               # (n, q)
    _phi: np.ndarray              # (n,) eigenvalues of K_train
    _U: np.ndarray                # (n, n) eigenvectors of K_train

    def predict(self, K_cross: np.ndarray,
                X_new: Optional[np.ndarray] = None) -> np.ndarray:
        """Predicted genetic (or phenotypic) values for new samples.

        K_cross: (n_new, n_train) kinship rows of the new samples against
        the TRAIN samples, from the same kinship construction as the
        training K (e.g. slice a joint kinship built over all samples).
        X_new: optional (n_new, q) fixed effects — when given, returns
        X_new @ beta + u_new (phenotype scale); otherwise u_new alone.
        """
        K_cross = np.asarray(K_cross, dtype=np.float64)
        u_new = K_cross @ self._hinv_r
        if X_new is not None:
            u_new = np.asarray(X_new, dtype=np.float64) @ self.beta + u_new
        return u_new

    def reliability(self) -> np.ndarray:
        """Per-train-sample reliability r^2_i = 1 - PEV_i/(sg2*K_ii)."""
        phi, U, d = self._phi, self._U, self.delta
        K = (U * phi) @ U.T
        Hinv = (U / (phi + d)) @ U.T
        KHi = K @ Hinv
        X0 = self._X0
        HiX = Hinv @ X0
        XtHiX_inv = np.linalg.inv(X0.T @ HiX)
        cov_adj = KHi @ X0 @ XtHiX_inv @ (KHi @ X0).T
        pev = self.sigma_g2 * (np.diag(K) - np.sum(KHi * K, axis=1)
                               + np.diag(cov_adj))
        with np.errstate(divide="ignore", invalid="ignore"):
            rel = 1.0 - pev / (self.sigma_g2 * np.diag(K))
        return np.clip(rel, 0.0, 1.0)


def gblup(y, K=None, X0=None, eig_k: Optional[Tuple] = None,
          ngrids: int = 100, llim: float = -10.0, ulim: float = 10.0
          ) -> GblupModel:
    """Fit gBLUP on phenotyped samples.

    y: (n,) phenotype; K: (n, n) kinship (scale_k'd) — or pass a
    precomputed eig_k=(phi, U). X0: (n, q) fixed effects (default
    intercept). REML for delta reuses ops/reml.fit_null_model (X-explicit
    float64 host path — no second eigh).

    No mesh= here (justified N/A): gBLUP has no SNP scan to shard —
    its cost is the one-time eigh(K) plus O(n^2) eigenbasis solves,
    all single-chip; only the upstream KINSHIP build scales with M and
    that already shards (parallel.distributed.distributed_kinship /
    the resident fused gram)."""
    from mixmogam_tpu.ops.reml import fit_null_model

    y = np.asarray(y, dtype=np.float64)
    if not np.isfinite(y).all():
        raise ValueError(
            "gblup needs fully-observed phenotypes (got non-finite "
            "values); drop unphenotyped samples from the TRAIN set and "
            "predict them through predict()/gblup_predict instead")
    n = y.shape[0]
    if X0 is None:
        X0 = np.ones((n, 1), dtype=np.float64)
    X0 = np.asarray(X0, dtype=np.float64)
    null = fit_null_model(y, X0, K=K, eig_k=eig_k, ngrids=ngrids,
                          llim=llim, ulim=ulim)
    phi = np.asarray(null.phi, dtype=np.float64)
    U = np.asarray(null.U, dtype=np.float64)
    delta = float(null.delta)
    # GLS in the eigenbasis: rotate, whiten by 1/sqrt(phi+delta)
    w = 1.0 / np.sqrt(phi + delta)
    Xr = (U.T @ X0) * w[:, None]
    yr = (U.T @ y) * w
    beta, *_ = np.linalg.lstsq(Xr, yr, rcond=None)
    r = y - X0 @ beta
    hinv_r = (U / (phi + delta)) @ (U.T @ r)
    u_hat = (U * phi) @ (U.T @ hinv_r)   # K H^-1 r without materializing K
    return GblupModel(
        beta=beta, u_hat=u_hat, delta=delta,
        sigma_g2=float(null.sigma_g2), sigma_e2=float(null.sigma_e2),
        pseudo_heritability=float(null.pseudo_heritability),
        fitted=X0 @ beta + u_hat, _hinv_r=hinv_r, _X0=X0,
        _phi=phi, _U=U)


def gblup_predict(gd_or_G, y, train_idx: Sequence[int],
                  test_idx: Sequence[int], X: Optional[np.ndarray] = None,
                  kinship_method: str = "ibs", K_all=None
                  ) -> Tuple[np.ndarray, GblupModel]:
    """Convenience split-fit-predict over one genotype source.

    Builds the joint kinship over ALL samples (device int8 GEMM path via
    GenotypeData.kinship / ops.kinship when gd_or_G is a GenotypeData or
    an int8 matrix; or pass K_all), fits on K[train, train] with
    y[train_idx], predicts the test samples through K[test, train].
    Returns (y_hat_test, model) — y_hat on phenotype scale when X is
    given (sliced per split), genetic values + intercept otherwise."""
    train_idx = np.asarray(train_idx, dtype=np.int64)
    test_idx = np.asarray(test_idx, dtype=np.int64)
    if K_all is None:
        K_all = _joint_kinship(gd_or_G, kinship_method)
    K_all = np.asarray(K_all, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if X is not None:
        X = np.asarray(X, dtype=np.float64)
        X0_train, X_test = X[train_idx], X[test_idx]
    else:
        X0_train = None
        X_test = np.ones((len(test_idx), 1), dtype=np.float64)
    model = gblup(y[train_idx], K=K_all[np.ix_(train_idx, train_idx)],
                  X0=X0_train)
    y_hat = model.predict(K_all[np.ix_(test_idx, train_idx)], X_new=X_test)
    return y_hat, model


def gblup_cv(gd_or_G, y, n_folds: int = 5, seed: int = 0,
             X: Optional[np.ndarray] = None, kinship_method: str = "ibs",
             K_all=None) -> dict:
    """K-fold cross-validated predictive accuracy of gBLUP.

    Returns {'r': mean Pearson correlation of (y_hat, y) over folds,
    'r_folds': per-fold, 'mse': mean squared error, 'y_hat': (n,)
    out-of-fold predictions in sample order}."""
    y = np.asarray(y, dtype=np.float64)
    n = y.shape[0]
    if n_folds < 2:
        raise ValueError(
            f"gblup_cv needs n_folds >= 2 (got {n_folds}); a 1-fold "
            "split leaves an empty training set — use gblup() for a "
            "no-CV fit (CLI: --folds 0)")
    if n_folds > n:
        raise ValueError(f"n_folds={n_folds} exceeds the {n} phenotyped "
                         "samples (some folds would be empty)")
    if K_all is None:
        K_all = _joint_kinship(gd_or_G, kinship_method)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    folds = np.array_split(perm, n_folds)
    y_hat = np.full(n, np.nan)
    rs = []
    for fold in folds:
        train = np.setdiff1d(perm, fold)
        pred, _ = gblup_predict(None, y, train, fold, X=X, K_all=K_all)
        y_hat[fold] = pred
        if len(fold) > 1 and np.std(y[fold]) > 0 and np.std(pred) > 0:
            rs.append(float(np.corrcoef(pred, y[fold])[0, 1]))
    return {"r": float(np.mean(rs)) if rs else float("nan"),
            "r_folds": rs,
            "mse": float(np.mean((y_hat - y) ** 2)),
            "y_hat": y_hat}


def _joint_kinship(gd_or_G, kinship_method: str) -> np.ndarray:
    """scale_k'd kinship over ALL samples of a GenotypeData / dosage
    matrix / ResidentGenome (device int8 GEMM path, ops/kinship.py)."""
    from mixmogam_tpu.oracle.kinship import scale_k
    from mixmogam_tpu.ops.kinship import kinship as build_kinship

    if kinship_method not in ("ibs", "ibd", "vanraden"):
        # silently coercing a typo ('vanRaden', 'grm') to IBS would run
        # the wrong kinship and return plausible-but-wrong predictions
        raise ValueError(f"unknown kinship method {kinship_method!r}; "
                         "expected 'ibs', 'ibd' or 'vanraden'")
    method = "vanraden" if kinship_method in ("ibd", "vanraden") else "ibs"
    return scale_k(np.asarray(build_kinship(gd_or_G, method=method)))
