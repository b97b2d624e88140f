"""mixmogam_tpu — a mixed-model GWAS engine for accelerators.

A from-scratch JAX/XLA framework with the capability surface of
``bvilhjal/mixmogam`` (linear mixed-model GWAS: kinship construction, REML
variance components, EMMAX / EMMA / stepwise-MLMM scans, results layer,
multiple-testing correction, plotting), re-designed for the device:

- genotypes live as packed int8 tiles in device memory, sharded SNP-wise
  over a ``jax.sharding.Mesh``;
- kinship is an integer-exact int8 gram accumulated with ``psum`` across
  SNP shards;
- the mixed-model core rotates data ONCE into the kinship eigenbasis, after
  which every per-SNP GLS F-test is elementwise + a tiny matmul — no Python
  loop over markers, HBM-bandwidth bound;
- p-values are finalized in float64 on host for tail accuracy.

Reference capability map: see SURVEY.md (the reference mount was empty; all
parity targets are pinned by the scipy oracle in ``mixmogam_tpu.oracle``,
which implements the published EMMA/EMMAX/MLMM algorithms the reference is a
direct implementation of — Kang et al. 2008, Kang et al. 2010, Segura et al.
2012).
"""

__version__ = "0.2.0"

from mixmogam_tpu import config as config  # noqa: F401

__all__ = ["config", "__version__"]


def __getattr__(name):
    # Lazy facade: keep `import mixmogam_tpu` cheap (no jax import) so the
    # oracle and data layers can be used standalone.
    if name in {
        "emmax", "emma", "emmax_step_wise", "emmax_anova",
        "emmax_multi_trait", "emmax_perm_test", "emmax_two_snps",
        "linear_model", "anova", "kruskal_wallis", "calc_ibs_kinship",
        "calc_ibd_kinship", "parse_snp_data", "parse_phenotype_file",
        "run_gwas", "run_gwas_multi", "save_kinship_to_file", "load_kinship_from_file",
    }:
        from mixmogam_tpu import api

        return getattr(api, name)
    if name in {"ResidentGenome", "emmax_resident", "emmax_loco",
                "loco_kinships", "gblup", "gblup_cv", "gblup_predict",
                "emmax_gxe"}:
        from mixmogam_tpu import models

        return getattr(models, name)
    if name in {"read_plink", "resident_from_plink", "write_plink",
                "read_vcf", "write_vcf", "SNPsDataSet"}:
        from mixmogam_tpu import data

        return getattr(data, name)
    if name in {"LinearModel", "LinearMixedModel", "lm_step_wise"}:
        from mixmogam_tpu import compat

        return getattr(compat, name)
    raise AttributeError(f"module 'mixmogam_tpu' has no attribute {name!r}")
