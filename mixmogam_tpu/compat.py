"""Reference-compatible class facade (the `linear_models.py` class API).

Users of the reference drive GWAS through two stateful classes
(`LinearModel` / `LinearMixedModel` in `linear_models.py`, SURVEY.md
§2.1): construct with the phenotype, `add_factor()` cofactor columns,
`add_random_effect(K)`, then call `get_expedited_REMLE()` /
`emmax_f_test(snps)` / etc.  This module provides those classes with the
reference's method names so such code ports unchanged — each method is a
thin stateful shell that delegates to the functional device core
(`ops.reml`, `ops.scan`, `models.*`); no compute happens here.

State kept host-side per instance: phenotype y, fixed-effect columns X,
kinship K and its cached eigendecomposition (so repeated scans /
stepwise-style usage never re-pay the one-time eigh).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


class LinearModel:
    """Fixed-effects-only model (reference: linear_models.LinearModel).

    >>> lm = LinearModel(y)
    >>> lm.add_factor(covariate)
    >>> res = lm.fast_f_test(snps)          # per-SNP OLS F-tests
    """

    def __init__(self, Y):
        self.Y = np.asarray(Y, dtype=np.float64).ravel()
        n = self.Y.shape[0]
        self.X = np.ones((n, 1), dtype=np.float64)  # intercept

    @property
    def n(self) -> int:
        return self.Y.shape[0]

    @property
    def p(self) -> int:
        return self.X.shape[1]

    def add_factor(self, x, lin_depend_thres: float = 1e-4) -> bool:
        """Append a fixed-effect column (reference: add_factor). Returns
        False (and does not add) if the column is linearly dependent on
        the current design, mirroring the reference's check."""
        x = np.asarray(x, dtype=np.float64).ravel()
        if x.shape[0] != self.n:
            raise ValueError(f"factor length {x.shape[0]} != n={self.n}")
        Q, _ = np.linalg.qr(self.X)
        r = x - Q @ (Q.T @ x)
        denom = float(x @ x) or 1.0
        if float(r @ r) / denom < lin_depend_thres:
            return False
        self.X = np.column_stack([self.X, x])
        return True

    def least_square_estimate(self) -> Dict[str, np.ndarray]:
        """OLS of Y on the current design (reference:
        least_square_estimate). Returns betas, residuals, rss, rank."""
        beta, rss, rank, _ = np.linalg.lstsq(self.X, self.Y, rcond=None)
        resid = self.Y - self.X @ beta
        rss_val = float(resid @ resid) if rss.size == 0 else float(rss[0])
        return {"betas": beta, "residuals": resid, "rss": rss_val,
                "rank": int(rank)}

    def get_estimates(self) -> Dict[str, np.ndarray]:
        return self.least_square_estimate()

    def fast_f_test(self, snps, with_betas: bool = True, **kw) -> Dict:
        """Per-SNP OLS F-tests against the current design (vectorized
        device scan; reference: LinearModel.fast_f_test)."""
        from mixmogam_tpu.models.linear import linear_model

        return linear_model(snps, self.Y, X0=self.X,
                            with_betas=with_betas, **kw)

    def anova_f_test(self, snps, **kw) -> Dict:
        """Per-SNP genotype-class ANOVA (reference: anova_f_test).

        The categorical ANOVA tests genotype-class means against the
        grand mean only; covariate-adjusted class tests are a different
        model, so cofactors added via add_factor are NOT silently
        dropped — they raise."""
        from mixmogam_tpu.models.linear import anova

        if self.X.shape[1] > 1:
            raise NotImplementedError(
                "anova_f_test does not support cofactors; use "
                "fast_f_test (additive coding) or "
                "LinearMixedModel.emmax_anova_f_test with X0")
        return anova(snps, self.Y, **kw)

    def test_explained_variance(self, snps, **kw) -> Dict:
        d = self.fast_f_test(snps, with_betas=True, **kw)
        return {"var_perc": d["var_perc"], "ps": d["ps"]}


class LinearMixedModel(LinearModel):
    """Mixed model y = Xb + u + e, u ~ N(0, sg2 K)
    (reference: linear_models.LinearMixedModel).

    >>> lmm = LinearMixedModel(y)
    >>> lmm.add_random_effect(K)
    >>> reml = lmm.get_expedited_REMLE()     # variance components
    >>> res = lmm.emmax_f_test(snps)         # the EMMAX scan
    """

    def __init__(self, Y):
        super().__init__(Y)
        self.K: Optional[np.ndarray] = None
        self._eig_k = None          # cached (phi, U) of K
        self._reml = None           # cached REML fit for the current X

    # ---- random effect / eigen caches ----
    def add_random_effect(self, cov_matrix) -> None:
        """Set the (single) genetic random effect's covariance
        (reference: add_random_effect; one K supported, as in EMMA)."""
        K = np.asarray(cov_matrix, dtype=np.float64)
        if K.shape != (self.n, self.n):
            raise ValueError(f"K must be ({self.n}, {self.n}); got {K.shape}")
        self.K = K
        self._eig_k = None
        self._reml = None

    def add_factor(self, x, lin_depend_thres: float = 1e-4) -> bool:
        added = super().add_factor(x, lin_depend_thres)
        if added:
            self._reml = None      # X changed -> REML stale
        return added

    def _get_eigen_L_(self, K=None):
        """eigh(K), cached (reference: _get_eigen_L_). Returns
        {'values': phi, 'vectors': U^T} in the reference's layout.

        Passing the SAME K again (the reference's call pattern re-passes
        it before every scan) keeps the cached eigh — resetting it would
        re-pay the O(n^3) host decomposition per call (review finding)."""
        from mixmogam_tpu.ops.eigen import eigen_k

        if K is not None and not (
                self.K is not None
                and (K is self.K
                     or (np.shape(K) == np.shape(self.K)
                         and np.array_equal(K, self.K)))):
            self.add_random_effect(K)
        if self.K is None:
            raise ValueError("call add_random_effect(K) first")
        if self._eig_k is None:
            phi, U = eigen_k(self.K, host=True)
            self._eig_k = (np.asarray(phi), np.asarray(U))
        phi, U = self._eig_k
        return {"values": phi, "vectors": U.T}

    def _get_eigen_R_(self, X=None):
        """Eigendecomposition of the projected S(K+I)S spectrum for design
        X (reference: _get_eigen_R_). Returns {'values': xi,
        'vectors': V^T}."""
        from mixmogam_tpu.ops.eigen import projected_spectrum

        if self.K is None:
            raise ValueError("call add_random_effect(K) first")
        X = self.X if X is None else np.asarray(X, dtype=np.float64)
        xi, V = projected_spectrum(self.K, X, host=True)
        return {"values": np.asarray(xi), "vectors": np.asarray(V).T}

    # ---- variance components ----
    def _fit(self, ngrids: int, llim: float, ulim: float, esp: float,
             ml: bool):
        from mixmogam_tpu.ops.reml import esp_to_refine_iters, fit_null_model

        self._get_eigen_L_()
        phi, U = self._eig_k
        return fit_null_model(
            self.Y, self.X, K=self.K, eig_k=(phi, U), ngrids=ngrids,
            llim=llim, ulim=ulim,
            refine_iters=esp_to_refine_iters(esp, ngrids, llim, ulim),
            ml=ml)

    @staticmethod
    def _remle_dict(null) -> Dict[str, float]:
        d = {
            "max_ll": float(null.ll),
            "delta": float(null.delta),
            "log_delta": float(null.log_delta),
            "pseudo_heritability": float(null.pseudo_heritability),
            "vg": float(null.sigma_g2),
            "ve": float(null.sigma_e2),
        }
        # our canonical spellings as aliases
        d["sigma_g2"] = d["vg"]
        d["sigma_e2"] = d["ve"]
        return d

    def get_expedited_REMLE(self, ngrids: int = 100, llim: float = -10.0,
                            ulim: float = 10.0, esp: float = 1e-6,
                            **_ignored) -> Dict[str, float]:
        """REML variance components via grid + refinement on log(delta)
        (reference: get_expedited_REMLE, same defaults)."""
        null = self._fit(ngrids, llim, ulim, esp, ml=False)
        self._reml = null
        return self._remle_dict(null)

    def get_REML(self, ngrids: int = 100, llim: float = -10.0,
                 ulim: float = 10.0, esp: float = 1e-6) -> Dict[str, float]:
        return self.get_expedited_REMLE(ngrids, llim, ulim, esp)

    def get_ML(self, ngrids: int = 100, llim: float = -10.0,
               ulim: float = 10.0, esp: float = 1e-6) -> Dict[str, float]:
        """ML (all-eigenvalue likelihood; used by the stepwise BIC
        criteria — reference: get_ML)."""
        return self._remle_dict(self._fit(ngrids, llim, ulim, esp, ml=True))

    def get_estimates(self, ngrids: int = 100, llim: float = -10.0,
                      ulim: float = 10.0, esp: float = 1e-6
                      ) -> Dict[str, np.ndarray]:
        """GLS estimates of the fixed effects at the REML delta
        (reference: get_estimates): betas, their standard errors, rss,
        plus the variance components."""
        if self._reml is None:
            self.get_expedited_REMLE(ngrids, llim, ulim, esp)
        null = self._reml
        phi = np.asarray(null.phi)
        U = np.asarray(null.U)
        sd = 1.0 / np.sqrt(phi + float(null.delta))
        Xs = (self.X.T @ U).T * sd[:, None]
        ys = (self.Y @ U) * sd
        beta, _, rank, _ = np.linalg.lstsq(Xs, ys, rcond=None)
        resid = ys - Xs @ beta
        rss = float(resid @ resid)
        dof = max(self.n - int(rank), 1)
        sigma2 = rss / dof
        XtX_inv = np.linalg.pinv(Xs.T @ Xs)
        se = np.sqrt(np.maximum(np.diag(XtX_inv) * sigma2, 0.0))
        out = self._remle_dict(null)
        out.update({"betas": beta, "beta_ses": se, "rss": rss,
                    "dof": dof})
        return out

    # ---- scans (all delegate to the vectorized device models) ----
    def _model_kwargs(self) -> Dict:
        self._get_eigen_L_()
        return {"eig_k": self._eig_k, "X0": self.X}

    def emmax_f_test(self, snps, with_betas: bool = True,
                     ngrids: int = 100, llim: float = -10.0,
                     ulim: float = 10.0, esp: float = 1e-6, **kw) -> Dict:
        """The EMMAX scan against the current design + cofactors
        (reference: emmax_f_test; fully vectorized here, SURVEY.md A.3)."""
        from mixmogam_tpu.models.emmax import emmax

        return emmax(snps, self.Y, with_betas=with_betas, ngrids=ngrids,
                     llim=llim, ulim=ulim, esp=esp,
                     **self._model_kwargs(), **kw)

    def emmax_anova_f_test(self, snps, **kw) -> Dict:
        """Categorical genotype-class EMMAX test (reference:
        emmax_anova)."""
        from mixmogam_tpu.models.emmax import emmax_anova

        return emmax_anova(snps, self.Y, **self._model_kwargs(), **kw)

    # reference method name (linear_models.LinearMixedModel.emmax_anova)
    emmax_anova = emmax_anova_f_test

    def emmax_two_snps(self, snps,
                       focal_idx: Optional[Sequence[int]] = None,
                       **kw) -> Dict:
        """Pairwise conditional + interaction scan (reference:
        emmax_two_snps)."""
        from mixmogam_tpu.models.twosnp import emmax_two_snps

        return emmax_two_snps(snps, self.Y, focal_idx=focal_idx,
                              **self._model_kwargs(), **kw)

    def emmax_perm_test(self, snps, num_perm: int = 100, seed: int = 0,
                        **kw) -> Dict:
        """Permutation max-F null distribution (reference:
        emmax_perm_test)."""
        from mixmogam_tpu.models.permutation import emmax_perm_test

        return emmax_perm_test(snps, self.Y, num_perm=num_perm, seed=seed,
                               **self._model_kwargs(), **kw)


def lm_step_wise(G, y, max_steps: int = 10, X0=None, **kw) -> Dict:
    """Stepwise model selection with fixed effects only (reference:
    linear_models.lm_step_wise).

    Implemented as the MLMM loop's identity-eigenbasis path (K=None):
    with a uniform spectrum the whitening is a scalar multiple of I, so
    every per-step F-test equals its OLS F-test exactly, and the ML
    log-likelihood is algebraically independent of delta (the delta
    terms cancel), so BIC/eBIC/mBIC equal their OLS values exactly.
    No n x n identity is materialized and no rotation matmuls run —
    one code path, zero approximation, zero wasted flops."""
    from mixmogam_tpu.models.stepwise import emmax_step_wise

    y = np.asarray(y, dtype=np.float64).ravel()
    out = emmax_step_wise(G, y, K=None, max_steps=max_steps, X0=X0, **kw)
    for s in out["steps"]:  # h2 is meaningless for K=I; report 0
        s["pseudo_heritability"] = 0.0
    return out


# the reference's genome container class, re-exported under its name
# (snpsdata.SNPsDataSet — data/genotype.py holds the alias)
from mixmogam_tpu.data.genotype import SNPsDataSet  # noqa: E402

__all__ = ["LinearModel", "LinearMixedModel", "lm_step_wise",
           "SNPsDataSet"]
