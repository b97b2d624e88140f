"""Data layer: genotype/phenotype containers, parsers, simulation.

Device-first redesign of the reference's L1/L2 (snpsdata.py, phenotypeData.py,
dataParsers.py, hdf5_data.py — SURVEY.md §2.1): genotypes live as a single
packed int8 (M, n) matrix + metadata arrays (not per-chromosome Python
lists), so device tiles slice straight out of it.
"""

from mixmogam_tpu.data.genotype import GenotypeData, SNPsDataSet
from mixmogam_tpu.data.phenotype import PhenotypeData
from mixmogam_tpu.data.simulate import simulate_genotypes, simulate_phenotype
from mixmogam_tpu.data.plink import (read_plink, resident_from_plink,
                                     write_plink)
from mixmogam_tpu.data.vcf import read_vcf, write_vcf

__all__ = [
    "GenotypeData", "SNPsDataSet", "PhenotypeData", "simulate_genotypes",
    "simulate_phenotype", "read_plink", "resident_from_plink",
    "write_plink", "read_vcf", "write_vcf",
]
