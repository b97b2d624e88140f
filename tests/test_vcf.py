"""VCF input/output (data/vcf.py) — round-3 capability extension (the
reference reads only CSV/HDF5 per SURVEY.md §2.1; modern cohorts ship
VCF). Pins: GT decoding (phased/unphased/haploid/partial), missing and
multi-allelic rules, chromosome-name coding, gzip support, parser
dispatch, and the write_vcf round-trip."""

import gzip

import numpy as np
import pytest

from mixmogam_tpu.data.genotype import GenotypeData
from mixmogam_tpu.data.parsers import parse_snp_data
from mixmogam_tpu.data.vcf import read_vcf, write_vcf

HEADER = ("##fileformat=VCFv4.2\n"
          "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
          "s0\ts1\ts2\n")


def _write(tmp_path, body, name="toy.vcf"):
    p = str(tmp_path / name)
    opener = gzip.open if name.endswith(".gz") else open
    with opener(p, "wt") as f:
        f.write(HEADER + body)
    return p


class TestReadVcf:
    def test_diploid_gt_decoding(self, tmp_path):
        body = ("1\t100\t.\tA\tG\t.\t.\t.\tGT\t0/0\t0/1\t1/1\n"
                "1\t200\t.\tC\tT\t.\t.\t.\tGT\t0|1\t1|1\t0|0\n"
                "2\t50\t.\tG\tA\t.\t.\t.\tGT\t./.\t0/0\t./1\n")
        gd = read_vcf(_write(tmp_path, body))
        assert gd.accessions == ["s0", "s1", "s2"]
        assert gd.ploidy == 2
        np.testing.assert_array_equal(
            gd.matrix, [[0, 1, 2], [1, 2, 0], [-1, 0, 1]])
        np.testing.assert_array_equal(gd.chromosomes, [1, 1, 2])
        np.testing.assert_array_equal(gd.positions, [100, 200, 50])
        np.testing.assert_array_equal(gd.alleles[0], ["A", "G"])

    def test_haploid(self, tmp_path):
        body = ("1\t10\t.\tA\tG\t.\t.\t.\tGT\t0\t1\t.\n")
        gd = read_vcf(_write(tmp_path, body))
        assert gd.ploidy == 1
        np.testing.assert_array_equal(gd.matrix, [[0, 1, -1]])

    def test_multiallelic_second_alt_is_missing(self, tmp_path):
        body = ("1\t10\t.\tA\tG,T\t.\t.\t.\tGT\t0/1\t1/2\t2/2\n")
        gd = read_vcf(_write(tmp_path, body))
        # counts first ALT only; calls touching allele 2 -> missing
        np.testing.assert_array_equal(gd.matrix, [[1, -1, -1]])
        np.testing.assert_array_equal(gd.alleles[0], ["A", "G"])

    def test_format_with_extra_fields(self, tmp_path):
        body = ("1\t10\t.\tA\tG\t.\tPASS\t.\tDP:GT:GQ\t"
                "9:0/1:40\t7:1/1:10\t3:./.:.\n")
        gd = read_vcf(_write(tmp_path, body))
        np.testing.assert_array_equal(gd.matrix, [[1, 2, -1]])

    def test_record_without_gt_skipped(self, tmp_path):
        body = ("1\t10\t.\tA\tG\t.\t.\t.\tDP\t9\t7\t3\n"
                "1\t20\t.\tC\tT\t.\t.\t.\tGT\t0/0\t0/1\t1/1\n")
        gd = read_vcf(_write(tmp_path, body))
        assert gd.num_snps == 1
        np.testing.assert_array_equal(gd.positions, [20])

    def test_chrom_names_and_map(self, tmp_path):
        body = ("chr1\t10\t.\tA\tG\t.\t.\t.\tGT\t0/0\t0/1\t1/1\n"
                "chr5\t10\t.\tA\tG\t.\t.\t.\tGT\t0/0\t0/1\t1/1\n"
                "X\t10\t.\tA\tG\t.\t.\t.\tGT\t0/0\t0/1\t1/1\n"
                "MT\t10\t.\tA\tG\t.\t.\t.\tGT\t0/0\t0/1\t1/1\n")
        gd, cmap = read_vcf(_write(tmp_path, body), return_chrom_map=True)
        assert cmap == {"chr1": 1, "chr5": 5, "X": 6, "MT": 7}
        np.testing.assert_array_equal(gd.chromosomes, [1, 5, 6, 7])

    def test_gzip(self, tmp_path):
        body = "1\t10\t.\tA\tG\t.\t.\t.\tGT\t0/0\t0/1\t1/1\n"
        gd = read_vcf(_write(tmp_path, body, name="toy.vcf.gz"))
        np.testing.assert_array_equal(gd.matrix, [[0, 1, 2]])

    def test_parser_dispatch(self, tmp_path):
        body = "1\t10\t.\tA\tG\t.\t.\t.\tGT\t0/0\t0/1\t1/1\n"
        path = _write(tmp_path, body)
        gd = parse_snp_data(path)
        np.testing.assert_array_equal(gd.matrix, [[0, 1, 2]])
        gd2 = parse_snp_data(_write(tmp_path, body, name="toy2.vcf.gz"))
        np.testing.assert_array_equal(gd2.matrix, [[0, 1, 2]])

    def test_no_samples_raises(self, tmp_path):
        p = str(tmp_path / "bad.vcf")
        with open(p, "w") as f:
            f.write("##fileformat=VCFv4.2\n"
                    "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
            f.write("1\t10\t.\tA\tG\t.\t.\t.\n")
        with pytest.raises(ValueError, match="FORMAT"):
            read_vcf(p)


class TestWriteVcf:
    def _gd(self, ploidy=2, seed=0, m=40, n=11):
        rng = np.random.default_rng(seed)
        G = rng.integers(0, ploidy + 1, (m, n)).astype(np.int8)
        G[rng.random((m, n)) < 0.1] = -1
        return GenotypeData(
            matrix=G,
            chromosomes=rng.integers(1, 4, m).astype(np.int32),
            positions=np.sort(rng.choice(10_000, m, replace=False)),
            accessions=[f"s{i}" for i in range(n)], ploidy=ploidy)

    @pytest.mark.parametrize("ploidy", [1, 2])
    @pytest.mark.parametrize("suffix", ["vcf", "vcf.gz"])
    def test_roundtrip(self, tmp_path, ploidy, suffix):
        gd = self._gd(ploidy=ploidy)
        p = str(tmp_path / f"rt.{suffix}")
        write_vcf(gd, p)
        back = read_vcf(p)
        np.testing.assert_array_equal(back.matrix, gd.matrix)
        np.testing.assert_array_equal(back.chromosomes, gd.chromosomes)
        np.testing.assert_array_equal(back.positions, gd.positions)
        assert back.accessions == gd.accessions
        assert back.ploidy == ploidy

    def test_roundtrip_alleles_and_chrom_names(self, tmp_path):
        gd = self._gd()
        gd = GenotypeData(gd.matrix, gd.chromosomes, gd.positions,
                          gd.accessions, ploidy=2,
                          alleles=np.asarray([["A", "T"]] * gd.num_snps))
        p = str(tmp_path / "named.vcf")
        write_vcf(gd, p, chrom_names={1: "chr1", 2: "chr2", 3: "chrX"})
        back, cmap = read_vcf(p, return_chrom_map=True)
        np.testing.assert_array_equal(back.matrix, gd.matrix)
        np.testing.assert_array_equal(back.alleles, gd.alleles)
        assert cmap["chr1"] == 1 and cmap["chr2"] == 2
        # chrX maps above the numeric range in first-appearance order
        assert set(np.unique(back.chromosomes)) <= {1, 2, 3}


class TestVcfEndToEnd:
    def test_vcf_through_run_gwas(self, tmp_path):
        from mixmogam_tpu.api import run_gwas
        from mixmogam_tpu.data.simulate import (simulate_genotypes,
                                                simulate_phenotype)

        G, chroms, poss = simulate_genotypes(24, 120, seed=3)
        y, _ = simulate_phenotype(G, h2=0.6, n_causal=4, seed=3)
        gd = GenotypeData(G, chroms, poss,
                          [f"s{i}" for i in range(24)], ploidy=1)
        vp = str(tmp_path / "sim.vcf")
        write_vcf(gd, vp)
        pheno = str(tmp_path / "pheno.csv")
        with open(pheno, "w") as f:
            f.write("ecotype_id,phen\n")
            for i, v in enumerate(y):
                f.write(f"s{i},{v}\n")
        out = run_gwas(vp, pheno, pid=1, method="emmax", min_mac=1,
                       out_prefix=str(tmp_path / "out"), plots=False)
        pvals = np.asarray(out["result"].scores)
        assert np.isfinite(pvals).all()
        assert pvals.min() < 0.05  # plumbing test; n=24 is underpowered


class TestNativeVcfParser:
    """native/fast_vcf.cpp vs the pure-Python reader: identical output
    on the same content (the gzip copy forces the Python path)."""

    def _messy_vcf_body(self, seed=0, m=300, n=25):
        rng = np.random.default_rng(seed)
        lines = []
        chrom_pool = ["1", "2", "chr7", "X", "MT", "chr1"]
        gt_pool = ["0/0", "0/1", "1/1", "0|1", "1|0", "./.", ".", "./1",
                   "0", "1", "1/2", "2/2", "0/x"]
        for j in range(m):
            chrom = chrom_pool[int(rng.integers(len(chrom_pool)))]
            fmt, mk = (("GT", lambda g: g) if j % 3 == 0 else
                       (("DP:GT:GQ",
                         lambda g: f"{rng.integers(99)}:{g}:{rng.integers(60)}")
                        if j % 3 == 1 else ("GT:PL", lambda g: f"{g}:10,0")))
            if j % 41 == 17:   # record without GT -> skipped by both
                fmt, mk = "DP", lambda g: str(rng.integers(99))
            alt = "G,T" if j % 13 == 5 else "G"
            calls = "\t".join(mk(gt_pool[int(rng.integers(len(gt_pool)))])
                              for _ in range(n))
            lines.append(f"{chrom}\t{100 + j}\tid{j}\tA\t{alt}\t.\tPASS"
                         f"\t.\t{fmt}\t{calls}\n")
        header = ("##fileformat=VCFv4.2\n"
                  "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                  + "\t".join(f"s{i}" for i in range(n)) + "\n")
        return header + "".join(lines)

    def test_native_available_and_used(self, tmp_path):
        from mixmogam_tpu import native
        from mixmogam_tpu.data.vcf import _read_vcf_native

        assert native.available()
        p = str(tmp_path / "t.vcf")
        with open(p, "w") as f:
            f.write(self._messy_vcf_body())
        assert _read_vcf_native(p) is not None

    def test_parity_with_python_reader(self, tmp_path):
        body = self._messy_vcf_body(seed=3)
        p = str(tmp_path / "t.vcf")
        pgz = str(tmp_path / "t.vcf.gz")
        with open(p, "w") as f:
            f.write(body)
        with gzip.open(pgz, "wt") as f:
            f.write(body)                       # same content
        a, amap = read_vcf(p, return_chrom_map=True)    # native
        b, bmap = read_vcf(pgz, return_chrom_map=True)  # pure Python
        np.testing.assert_array_equal(a.matrix, b.matrix)
        np.testing.assert_array_equal(a.chromosomes, b.chromosomes)
        np.testing.assert_array_equal(a.positions, b.positions)
        np.testing.assert_array_equal(a.alleles, b.alleles)
        assert a.accessions == b.accessions
        assert a.ploidy == b.ploidy
        assert amap == bmap

    def test_long_chrom_name_falls_back(self, tmp_path):
        """>15-char chromosome names exceed the native buffer -> the
        Python path must produce the result."""
        body = (HEADER + "scaffold_000000123456\t10\t.\tA\tG\t.\t.\t.\t"
                "GT\t0/0\t0/1\t1/1\n")
        p = _write(tmp_path, body, name="long.vcf")
        gd, cmap = read_vcf(p, return_chrom_map=True)
        assert "scaffold_000000123456" in cmap
        np.testing.assert_array_equal(gd.matrix, [[0, 1, 2]])


class TestWriteVcfValidation:
    def test_dosage_exceeding_ploidy_raises(self, tmp_path):
        import dataclasses

        gd = TestWriteVcf()._gd(ploidy=2)
        bad = dataclasses.replace(gd, ploidy=1)  # dosage 2 under ploidy 1
        with pytest.raises(ValueError, match="exceed ploidy"):
            write_vcf(bad, str(tmp_path / "bad.vcf"))


class TestRound4VcfFeatures:
    """Round 4 (VERDICT r3 #8 + ADVICE): streaming native parser
    (.gz/bgzip in C++), DS dosage reads, and the memory-bounded
    packed-container parse."""

    def _big_vcf(self, tmp_path, M=300, n=3, seed=0, name="big.vcf",
                 missing=0.05):
        rng = np.random.default_rng(seed)
        mat = rng.integers(0, 3, size=(M, n)).astype(np.int8)
        mat[rng.random((M, n)) < missing] = -1
        codes = {0: "0/0", 1: "0/1", 2: "1/1", -1: "./."}
        lines = []
        for j in range(M):
            calls = "\t".join(codes[int(g)] for g in mat[j])
            lines.append(f"{1 + j // 200}\t{100 + j}\t.\tA\tG\t.\t.\t.\t"
                         f"GT\t{calls}\n")
        return _write(tmp_path, "".join(lines), name=name), mat

    def test_gz_native_python_parity(self, tmp_path):
        """.vcf.gz now parses natively (zlib stream); identical output
        to the Python reader on the same bytes."""
        from mixmogam_tpu import native
        from mixmogam_tpu.data import vcf as vcf_mod

        p, mat = self._big_vcf(tmp_path, name="big.vcf.gz")
        gd = read_vcf(p)
        np.testing.assert_array_equal(gd.matrix, mat)
        if native.available():
            # force the python path and compare
            import unittest.mock as mock

            with mock.patch.object(vcf_mod, "_read_vcf_native",
                                   lambda _p: None):
                gd_py = read_vcf(p)
            np.testing.assert_array_equal(gd.matrix, gd_py.matrix)
            np.testing.assert_array_equal(gd.positions, gd_py.positions)
            np.testing.assert_array_equal(gd.chromosomes,
                                          gd_py.chromosomes)
            assert gd.ploidy == gd_py.ploidy

    def test_native_chunked_stream_matches_single_chunk(self, tmp_path):
        from mixmogam_tpu import native

        if not native.available():
            pytest.skip("no native lib")
        p, mat = self._big_vcf(tmp_path, M=257)
        chunks = list(native.iter_vcf(p, 3, chunk_rows=64))
        assert sum(c[0].shape[0] for c in chunks) == 257
        np.testing.assert_array_equal(np.vstack([c[0] for c in chunks]),
                                      mat)

    def test_read_vcf_packed_parity(self, tmp_path):
        from mixmogam_tpu.data.vcf import read_vcf_packed

        p, mat = self._big_vcf(tmp_path, M=300)
        gd = read_vcf(p)
        rg, meta = read_vcf_packed(p, tile=64, chunk_rows=50)
        assert rg.M == 300 and rg.n == 3 and rg.has_missing
        np.testing.assert_array_equal(rg[0:300], mat)
        np.testing.assert_array_equal(meta["chromosomes"],
                                      gd.chromosomes)
        np.testing.assert_array_equal(meta["positions"], gd.positions)
        assert meta["accessions"] == gd.accessions
        np.testing.assert_array_equal(np.asarray(meta["alleles"]),
                                      np.asarray(gd.alleles))

    def test_read_vcf_packed_gz_and_python_fallback(self, tmp_path):
        import unittest.mock as mock

        from mixmogam_tpu import native
        from mixmogam_tpu.data.vcf import read_vcf_packed

        p, mat = self._big_vcf(tmp_path, M=120, name="z.vcf.gz")
        rg, meta = read_vcf_packed(p, tile=64, chunk_rows=32)
        np.testing.assert_array_equal(rg[0:120], mat)
        with mock.patch.object(native, "available", lambda: False):
            rg2, meta2 = read_vcf_packed(p, tile=64, chunk_rows=32)
        np.testing.assert_array_equal(rg2[0:120], mat)
        np.testing.assert_array_equal(meta2["chromosomes"],
                                      meta["chromosomes"])

    def test_read_vcf_packed_polyploid_refuses(self, tmp_path):
        from mixmogam_tpu.data.vcf import read_vcf_packed

        body = "1\t10\t.\tA\tG\t.\t.\t.\tGT\t0/1/1/1\t0/0/0/0\t1/1/1/1\n"
        p = _write(tmp_path, body)
        with pytest.raises(ValueError, match="polyploid"):
            read_vcf_packed(p)

    def test_read_vcf_packed_scan_end_to_end(self, tmp_path):
        """The packed container off a VCF drives the EMMAX scan
        directly (the cohort-scale workflow)."""
        from mixmogam_tpu.data.vcf import read_vcf_packed
        from mixmogam_tpu.models.emmax import emmax
        from mixmogam_tpu.oracle.kinship import scale_k, ibs_kinship

        rng = np.random.default_rng(7)
        n, M = 32, 200
        mat = rng.integers(0, 3, size=(M, n)).astype(np.int8)
        codes = {0: "0/0", 1: "0/1", 2: "1/1"}
        lines = []
        header = ("##fileformat=VCFv4.2\n"
                  "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\t"
                  "FORMAT\t" + "\t".join(f"s{i}" for i in range(n))
                  + "\n")
        for j in range(M):
            calls = "\t".join(codes[int(g)] for g in mat[j])
            lines.append(f"1\t{j + 1}\t.\tA\tG\t.\t.\t.\tGT\t{calls}\n")
        p = str(tmp_path / "cohort.vcf")
        with open(p, "w") as f:
            f.write(header + "".join(lines))
        rg, meta = read_vcf_packed(p, tile=64)
        y = mat[11].astype(float) + rng.normal(size=n) * 0.3
        K = scale_k(ibs_kinship(mat.astype(np.float64)))
        res = emmax(rg, y, K=K)
        ref = emmax(mat, y, K=K)
        np.testing.assert_allclose(res["ps"], ref["ps"], atol=1e-9)

    def test_ds_field_read(self, tmp_path):
        from mixmogam_tpu.data.genotype import DosageData

        body = ("1\t100\t.\tA\tG\t.\t.\t.\tGT:DS\t0/0:0.05\t0/1:1.1\t"
                "1/1:1.98\n"
                "1\t200\t.\tC\tT\t.\t.\t.\tDS\t0.5\t.\t1.25\n"
                "2\t50\t.\tG\tA\t.\t.\t.\tGT\t0/0\t0/1\t1/1\n"  # no DS
                "2\t60\t.\tG\tA,C\t.\t.\t.\tDS\t0.7,0.1\t0.2,0\t0\n")
        gd = read_vcf(_write(tmp_path, body), field="DS")
        assert isinstance(gd, DosageData)
        assert gd.matrix.dtype == np.float32
        assert gd.num_snps == 3  # the GT-only record is skipped
        np.testing.assert_allclose(gd.matrix[0], [0.05, 1.1, 1.98],
                                   rtol=1e-6)
        assert np.isnan(gd.matrix[1, 1])
        np.testing.assert_allclose(gd.matrix[2], [0.7, 0.2, 0.0],
                                   rtol=1e-6)  # first ALT of the list
        assert gd.ploidy == 2

    def test_ds_scan_routes_to_float_path(self, tmp_path):
        """DS dosages drive emmax via the float path; int8 tiers
        refuse the fractional dosages."""
        from mixmogam_tpu.models.emmax import emmax
        from mixmogam_tpu.ops.scan import resolve_precision

        rng = np.random.default_rng(3)
        n, M = 24, 60
        D = np.round(rng.uniform(0, 2, size=(M, n)), 2)
        header = ("##fileformat=VCFv4.2\n"
                  "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\t"
                  "FORMAT\t" + "\t".join(f"s{i}" for i in range(n))
                  + "\n")
        lines = [f"1\t{j + 1}\t.\tA\tG\t.\t.\t.\tDS\t"
                 + "\t".join(f"{v:.2f}" for v in D[j]) + "\n"
                 for j in range(M)]
        p = str(tmp_path / "ds.vcf")
        with open(p, "w") as f:
            f.write(header + "".join(lines))
        gd = read_vcf(p, field="DS")
        np.testing.assert_allclose(gd.matrix, D, rtol=1e-5)
        y = D[5] + rng.normal(size=n) * 0.5
        from mixmogam_tpu.oracle.kinship import scale_k
        K = scale_k(np.eye(n) + 0.05)
        out = emmax(gd, y, K=K)
        assert np.isfinite(out["ps"]).all()
        # 'auto' takes the fractional route (never int8) for dosages
        from mixmogam_tpu.ops.scan import PRECISION_ROUTES

        _, _, name = resolve_precision("auto", G=gd.matrix,
                                       backend="gpu")
        assert name == PRECISION_ROUTES["gpu"]["auto"][1]

    def test_dosage_data_surface(self, tmp_path):
        from mixmogam_tpu.data.genotype import DosageData
        from mixmogam_tpu.data.phenotype import PhenotypeData

        rng = np.random.default_rng(5)
        D = rng.uniform(0, 2, size=(20, 6)).astype(np.float32)
        D[0, 0] = np.nan
        gd = DosageData(D, np.repeat(1, 20), np.arange(20) * 10,
                        [f"a{i}" for i in range(6)], ploidy=2)
        assert gd.num_snps == 20 and gd.num_samples == 6
        sub = gd.select_samples([0, 2, 4])
        assert isinstance(sub, DosageData)
        assert sub.matrix.dtype == np.float32
        f = gd.filter_mac_snps(1)
        assert isinstance(f, DosageData)
        pd = PhenotypeData()
        pd.add_phenotype(1, "t", gd.accessions[:5],
                         rng.normal(size=5))
        gd2, y, ids = gd.coordinate_with_phenotype(pd, 1)
        assert isinstance(gd2, DosageData) and len(ids) == 5
        Z = gd.dosage_f64()
        assert np.isfinite(Z).all()
        with pytest.raises(NotImplementedError):
            gd.write_csv(str(tmp_path / "x.csv"))
        h5 = str(tmp_path / "d.h5")
        gd.write_hdf5(h5)
        back = DosageData.read_hdf5(h5)
        np.testing.assert_allclose(np.nan_to_num(back.matrix),
                                   np.nan_to_num(gd.matrix))

    def test_run_gwas_vcf_ds(self, tmp_path):
        """run_gwas(data_format='vcf_ds'): DS dosages drive the full
        facade pipeline (coordinate, MAC-expectation filter, kinship
        cache on the float container, float scan path)."""
        from mixmogam_tpu.api import run_gwas
        from mixmogam_tpu.data.phenotype import PhenotypeData

        rng = np.random.default_rng(9)
        n, M = 40, 120
        D = np.round(rng.uniform(0, 2, size=(M, n)), 2)
        samples = [f"s{i}" for i in range(n)]
        vp = str(tmp_path / "d.vcf")
        with open(vp, "w") as f:
            f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\t"
                    "QUAL\tFILTER\tINFO\tFORMAT\t"
                    + "\t".join(samples) + "\n")
            for j in range(M):
                f.write(f"1\t{j + 1}\t.\tA\tG\t.\t.\t.\tDS\t"
                        + "\t".join(f"{v:.2f}" for v in D[j]) + "\n")
        y = D[17] + rng.normal(size=n) * 0.4
        pp = str(tmp_path / "p.csv")
        pd = PhenotypeData()
        pd.add_phenotype(1, "t", samples, y)
        pd.write_to_file(pp)
        out = run_gwas(vp, pp, pid=1, data_format="vcf_ds", min_mac=1,
                       plots=False)
        assert np.isfinite(out["scan"]["ps"]).all()
        j_min = int(np.argmin(out["scan"]["ps"]))
        assert int(out["genotype"].positions[j_min]) == 18

    def test_native_arena_growth_retry(self, tmp_path):
        """REF/ALT strings larger than the default 64 B/row arena
        budget trigger the -3 grow-and-retry path; carried lines must
        not be lost or duplicated."""
        from mixmogam_tpu import native

        if not native.available():
            pytest.skip("no native lib")
        rng = np.random.default_rng(2)
        M = 40
        refs = ["".join(rng.choice(list("ACGT"), size=300)) for _ in
                range(M)]
        lines = [f"1\t{j + 1}\t.\t{refs[j]}\tG\t.\t.\t.\tGT\t0/1\t1/1\t"
                 f"0/0\n" for j in range(M)]
        p = _write(tmp_path, "".join(lines), name="longref.vcf")
        chunks = list(native.iter_vcf(p, 3, chunk_rows=8))
        assert sum(c[0].shape[0] for c in chunks) == M
        alleles = np.concatenate([c[4].reshape(-1, 2) for c in chunks])
        assert list(alleles[:, 0]) == refs
        gd = read_vcf(p)
        np.testing.assert_array_equal(
            np.vstack([c[0] for c in chunks]), gd.matrix)

    def test_gz_truncation_sweep(self, tmp_path):
        """Several truncation points of a .vcf.gz: the reader must
        either raise or (for a truncation that happens to end at a
        clean gzip stream boundary) return the full parse — never a
        silently truncated genome."""
        import gzip

        rows = "".join(f"1\t{j + 1}\t.\tA\tG\t.\t.\t.\tGT\t0/1\t1/1\n"
                       for j in range(400))
        full = ("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL"
                "\tFILTER\tINFO\tFORMAT\ts0\ts1\n" + rows)
        src = str(tmp_path / "full.vcf.gz")
        with gzip.open(src, "wt") as f:
            f.write(full)
        blob = open(src, "rb").read()
        for frac in (0.3, 0.6, 0.9):
            p = str(tmp_path / f"t{int(frac * 10)}.vcf.gz")
            with open(p, "wb") as f:
                f.write(blob[: int(len(blob) * frac)])
            try:
                gd = read_vcf(p)
            except Exception:
                continue  # raising is the expected outcome
            assert gd.num_snps == 400  # only full parses may succeed
