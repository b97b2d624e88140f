"""Result container (reference: gwaResults.py Result class, SURVEY.md §2.1):
scores/p-values + chr/pos/maf/mac arrays with -log10 transform, filtering,
top-k extraction, ranked file output, and candidate-gene region queries."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Gene:
    """Candidate gene (reference: gwaResults.Gene)."""

    chromosome: int
    start: int
    stop: int
    name: str = ""


def load_gene_list(path: str, delimiter: str = ",") -> List["Gene"]:
    """Candidate-gene list CSV: 'chromosome,start,stop[,name]' with an
    optional header (reference: gwaResults candidate-gene loading)."""
    genes: List[Gene] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(delimiter)
            try:
                chrom = int(parts[0])
            except ValueError:
                continue  # header
            genes.append(Gene(chrom, int(parts[1]), int(parts[2]),
                              parts[3].strip() if len(parts) > 3 else ""))
    return genes


class Result:
    """GWAS scan result, sortable/filterable, with the reference's
    neg_log_trans / filter_attr / get_top_snps / write_to_file surface."""

    def __init__(self, scores, chromosomes, positions,
                 mafs: Optional[np.ndarray] = None,
                 macs: Optional[np.ndarray] = None,
                 additional: Optional[Dict[str, np.ndarray]] = None,
                 score_type: str = "pvals"):
        self.scores = np.asarray(scores, dtype=np.float64)
        self.chromosomes = np.asarray(chromosomes)
        self.positions = np.asarray(positions)
        self.mafs = None if mafs is None else np.asarray(mafs)
        self.macs = None if macs is None else np.asarray(macs)
        self.additional = {k: np.asarray(v)
                           for k, v in (additional or {}).items()}
        self.score_type = score_type  # 'pvals' or 'neg_log_pvals' or 'scores'

    def __len__(self) -> int:
        return len(self.scores)

    def _all_arrays(self):
        out = {"scores": self.scores, "chromosomes": self.chromosomes,
               "positions": self.positions}
        if self.mafs is not None:
            out["mafs"] = self.mafs
        if self.macs is not None:
            out["macs"] = self.macs
        out.update(self.additional)
        return out

    def _subset(self, idx) -> "Result":
        arrs = {k: v[idx] for k, v in self._all_arrays().items()}
        add = {k: arrs[k] for k in self.additional}
        return Result(arrs["scores"], arrs["chromosomes"], arrs["positions"],
                      mafs=arrs.get("mafs"), macs=arrs.get("macs"),
                      additional=add, score_type=self.score_type)

    # ---- transforms (reference: neg_log_trans) ----
    def neg_log_trans(self) -> "Result":
        if self.score_type != "pvals":
            raise ValueError("neg_log_trans needs p-value scores")
        out = self._subset(slice(None))
        out.scores = -np.log10(np.maximum(out.scores, 1e-323))
        out.score_type = "neg_log_pvals"
        return out

    # ---- filters (reference: filter_attr) ----
    def filter_attr(self, attr: str, min_val=None, max_val=None) -> "Result":
        v = self._all_arrays()[attr]
        mask = np.ones(len(v), dtype=bool)
        if min_val is not None:
            mask &= v >= min_val
        if max_val is not None:
            mask &= v <= max_val
        return self._subset(mask)

    def filter_percentile(self, percentile: float) -> "Result":
        """Keep the best `percentile` fraction (reference:
        filter_percentile)."""
        k = max(1, int(len(self) * percentile))
        return self.get_top_snps(k)

    # ---- ranking (reference: get_top_snps / min_score) ----
    def _order(self) -> np.ndarray:
        if self.score_type == "pvals":
            return np.argsort(self.scores, kind="stable")
        return np.argsort(-self.scores, kind="stable")

    def get_top_snps(self, n: int = 10) -> "Result":
        return self._subset(self._order()[:n])

    def arg_min_attr(self) -> int:
        """Index of the most significant SNP."""
        return int(self._order()[0])

    def min_score(self) -> float:
        """Best score (smallest p / largest -log10 p)."""
        return float(self.scores[self._order()[0]])

    # ---- region / gene queries (reference: get_region_result,
    #      candidate-gene proximity) ----
    def get_region_result(self, chromosome: int, start: int, stop: int
                          ) -> "Result":
        mask = ((self.chromosomes == chromosome)
                & (self.positions >= start) & (self.positions <= stop))
        return self._subset(mask)

    def get_genes_within(self, genes: Sequence[Gene], radius: int = 0
                         ) -> List[Gene]:
        """Genes whose (extended) span contains at least one scanned SNP."""
        hits = []
        for g in genes:
            mask = ((self.chromosomes == g.chromosome)
                    & (self.positions >= g.start - radius)
                    & (self.positions <= g.stop + radius))
            if mask.any():
                hits.append(g)
        return hits

    def min_distances_to_genes(self, genes: Sequence[Gene]) -> np.ndarray:
        """Per-gene distance from the nearest scanned SNP (0 if inside)."""
        out = np.full(len(genes), np.inf)
        for i, g in enumerate(genes):
            mask = self.chromosomes == g.chromosome
            if not mask.any():
                continue
            pos = self.positions[mask]
            d = np.where((pos >= g.start) & (pos <= g.stop), 0,
                         np.minimum(np.abs(pos - g.start),
                                    np.abs(pos - g.stop)))
            out[i] = d.min()
        return out

    def clump(self, G, p_threshold: float = 1e-4,
              r2_threshold: float = 0.5, window_bp: int = 250_000):
        """Greedy LD clumping of this result's hits (results.ld.clump_hits;
        requires score_type 'pvals'). G = any row-indexable genotype
        source aligned to this result's SNP order (ResidentGenome ok)."""
        from mixmogam_tpu.results.ld import clump_hits

        if self.score_type != "pvals":
            raise ValueError("clump() needs raw p-values "
                             f"(score_type={self.score_type!r})")
        return clump_hits(self.scores, G, self.chromosomes,
                          self.positions, p_threshold=p_threshold,
                          r2_threshold=r2_threshold, window_bp=window_bp)

    # ---- output (reference: write_to_file) ----
    def write_to_file(self, path: str, only_pickled: bool = False) -> None:
        """Ranked CSV; only_pickled=True writes a pickle of the ranked
        column arrays instead (reference: Result.write_to_file's
        only_pickled mode — previously accepted-and-ignored, review
        finding). Load back with Result.from_pickle."""
        if only_pickled:
            import pickle

            arrs = self._all_arrays()
            order = self._order()
            payload = {k: np.asarray(v)[order] for k, v in arrs.items()}
            payload["score_type"] = self.score_type
            with open(path, "wb") as f:
                pickle.dump(payload, f)
            return
        cols = ["chromosomes", "positions", "scores"]
        arrs = self._all_arrays()
        extra = [k for k in ("mafs", "macs") if k in arrs]
        extra += sorted(self.additional)
        header = cols + extra
        order = self._order()
        # vectorized formatting: per-cell str() in a Python loop costs
        # minutes at the 1M-SNP scale (~7M str calls).
        # astype(str) sizes the unicode itemsize to the longest element —
        # a fixed U32 would silently truncate long strings (e.g. marker
        # names) in `additional` columns.
        str_cols = [np.asarray(arrs[k])[order].astype(str).tolist()
                    for k in header]
        with open(path, "w") as f:
            f.write(",".join(header) + "\n")
            f.write("\n".join(",".join(t) for t in zip(*str_cols)))
            if str_cols and str_cols[0]:
                f.write("\n")

    @staticmethod
    def from_pickle(path: str) -> "Result":
        """Load a write_to_file(only_pickled=True) artifact."""
        import pickle

        with open(path, "rb") as f:
            payload = pickle.load(f)
        score_type = payload.pop("score_type", "pvals")
        known = ("scores", "chromosomes", "positions", "mafs", "macs")
        add = {k: v for k, v in payload.items() if k not in known}
        return Result(payload["scores"], payload["chromosomes"],
                      payload["positions"], mafs=payload.get("mafs"),
                      macs=payload.get("macs"), additional=add,
                      score_type=score_type)

    @staticmethod
    def from_scan(scan: Dict[str, np.ndarray], chromosomes, positions,
                  mafs=None, macs=None) -> "Result":
        add = {}
        for k in ("betas", "var_perc", "f_stats"):
            if k in scan:
                add[k] = scan[k]
        return Result(scan["ps"], chromosomes, positions, mafs=mafs,
                      macs=macs, additional=add, score_type="pvals")
