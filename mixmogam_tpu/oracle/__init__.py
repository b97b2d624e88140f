"""Pure numpy/scipy oracle — ground truth for all parity tests.

This package is a float64 CPU re-implementation of the published algorithms
the reference (bvilhjal/mixmogam) directly implements (SURVEY.md Appendix A):

- A.1 kinship: IBS allele sharing; VanRaden centered covariance
  (reference: kinship.py calc_ibs_kinship / calc_ibd_kinship / scale_k /
  prepare_k — file:line citations impossible, mount empty; see SURVEY.md).
- A.2 REML for delta = sigma_e^2/sigma_g^2 (EMMA, Kang et al. 2008):
  projected spectrum of S(K+I)S, grid + root refinement on log(delta)
  (reference: linear_models.py get_expedited_REMLE).
- A.3 EMMAX scan (Kang et al. 2010): one null REML fit, per-SNP
  rotated-GLS F-tests (reference: linear_models.py emmax_f_test).
- A.4 EMMA exact scan: per-SNP REML re-fit (reference: linear_models.py
  emma).
- A.5 stepwise MLMM (Segura et al. 2012) (reference: linear_models.py
  emmax_step_wise).
- A.6 OLS / ANOVA / Kruskal-Wallis / permutation
  (reference: linear_models.py linear_model / anova / kruskal_wallis).

The device path must match this oracle's p-values to <=1e-6 in float64
(BASELINE.json).
The oracle is deliberately written in the reference's algorithmic shape
(chunked kinship, explicit grid REML, per-SNP lstsq scan) — NOT vectorized
the device way — so it is an independent check, not a mirror of the device code.
"""

from mixmogam_tpu.oracle.kinship import (
    ibs_kinship,
    vanraden_kinship,
    scale_k,
    prepare_k,
)
from mixmogam_tpu.oracle.lmm import (
    eigen_K,
    eigen_R,
    reml,
    ml,
    emmax_scan,
    emma_scan,
    gls_f_test,
)
from mixmogam_tpu.oracle.glm import (
    ols_scan,
    anova_scan,
    kruskal_wallis_scan,
)
from mixmogam_tpu.oracle.stepwise import mlmm_step_wise

__all__ = [
    "ibs_kinship", "vanraden_kinship", "scale_k", "prepare_k",
    "eigen_K", "eigen_R", "reml", "ml", "emmax_scan", "emma_scan",
    "gls_f_test", "ols_scan", "anova_scan", "kruskal_wallis_scan",
    "mlmm_step_wise",
]
