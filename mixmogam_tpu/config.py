"""Central configuration dataclasses.

The reference (mixmogam) has no config system — everything is function kwargs
with hardcoded defaults (SURVEY.md §5: ``ngrids=100, llim=-10, ulim=10,
esp=1e-6``, ``min_mac=15``, SNP chunk sizes). We mirror those numeric
defaults here so parity is preserved, and add the device-side knobs
(tile sizes, mesh axes, dtypes) the reference never needed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RemlConfig:
    """REML optimizer settings (reference defaults: linear_models.py
    get_expedited_REMLE(ngrids=100, llim=-10, ulim=10, esp=1e-6))."""

    ngrids: int = 100
    llim: float = -10.0   # lower bound on log(delta), natural log
    ulim: float = 10.0    # upper bound on log(delta)
    esp: float = 1e-6     # root refinement tolerance on log(delta)
                          # (maps to bisection iterations; ops.reml.esp_to_refine_iters)


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    """SNP filtering (reference: SNPsDataSet.filter_mac_snps / filter_maf_snps)."""

    min_mac: int = 0
    min_maf: float = 0.0


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """Device tiling for the streamed SNP axis."""

    kinship_snp_block: int = 2048   # SNPs per kinship accumulation block
    scan_snp_tile: int = 8192       # SNPs per EMMAX-scan tile


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical mesh for multi-chip / multi-host runs (SURVEY.md §2.3):
    'snp' axis = data parallel over markers; 'sample' axis = tensor-parallel
    fallback for very large n (unused until n outgrows per-chip HBM)."""

    snp_axis: str = "snp"
    sample_axis: str = "sample"
    mesh_shape: Optional[Tuple[int, int]] = None  # None => (n_devices, 1)


@dataclasses.dataclass(frozen=True)
class PrecisionConfig:
    """Numerics policy.

    - compute_dtype: on-device linear algebra ('float32' in production;
      tests run on CPU with x64 enabled and use 'float64').
    - rotate_in_bf16: opt-in fast path for the genotype-rotation matmul
      (bf16 inputs, fp32 accumulation; p-drift bound in
      ops.scan.TIER_P_DRIFT); off by default to hold 1e-6 p-parity.
    - host_float64_pvalues: finalize p-values from F statistics in float64
      on host (scipy) so tails (p ~ 1e-30) survive fp32.
    """

    compute_dtype: str = "float32"
    rotate_in_bf16: bool = False
    host_float64_pvalues: bool = True


@dataclasses.dataclass(frozen=True)
class GwasConfig:
    reml: RemlConfig = dataclasses.field(default_factory=RemlConfig)
    filters: FilterConfig = dataclasses.field(default_factory=FilterConfig)
    tiles: TileConfig = dataclasses.field(default_factory=TileConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    precision: PrecisionConfig = dataclasses.field(default_factory=PrecisionConfig)


DEFAULT = GwasConfig()
