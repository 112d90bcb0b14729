"""Head-to-head parity vs the ACTUAL reference implementation.

The BASELINE.md north star is bit-identical strain reports vs CPU
StrainScan.  These tests build a DB with this pipeline, export it to
the reference layout (build/convert.py), run
/root/reference/StrainScan.py on it (via tools/run_reference.py: real
bundled jellyfish binary + treelib shim + two API-rename patches), and
require the reports to be **byte-identical** — except for fields that
go through sklearn's ElasticNetCV/ElasticNet coordinate descent, where
our JAX solver agrees to ~1e-12 relative (last-ulp summation-order
differences) and the comparison is numeric.

Covered samples (VERDICT round-1 item 1):
  single multi-strain cluster, cross-cluster mixture, intra-cluster
  mixture (real Enet fit), all-singleton, low-depth ladder (-l 1),
  gz+PE input, -b probability report, memory-efficient DB.

Reference call chain exercised: StrainScan.py:113-271,
library/identify.py:402-504 (identify_low_mem.py for the mem DB),
library/Vote_Strain_L2_Lasso_new_sp.py:247-438,
library/identify_strains_L2_Enet_Pscan_new_sp.py:177-478,
library/identify_low_depth.py:113-151.
"""

import gzip
import os

import numpy as np
import pytest

from strainscan_tpu.build.convert import export_reference_db
from strainscan_tpu.build.pipeline import build_database
from strainscan_tpu.config import BuildConfig, IdentifyConfig
from strainscan_tpu.identify.pipeline import run_identify

from ref_harness import jellyfish_ok, parse_report, run_reference

pytestmark = pytest.mark.skipif(
    not jellyfish_ok(), reason="bundled jellyfish binary not runnable")

RNG = np.random.default_rng(21)
BASES = np.array(list("ACGT"))
GLEN = 100_000


def _rand_genome(n):
    return "".join(RNG.choice(BASES, size=n))


def _mutate(seq, n_snps):
    s = np.array(list(seq))
    for p in RNG.choice(len(s), size=n_snps, replace=False):
        s[p] = RNG.choice([b for b in BASES if b != s[p]])
    return "".join(s)


def _revcomp(s):
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    return "".join(comp[c] for c in reversed(s))


def _sim_reads(seq, depth, read_len=100):
    reads = []
    for _ in range(int(len(seq) * depth / read_len)):
        p = int(RNG.integers(0, len(seq) - read_len))
        r = seq[p : p + read_len]
        if RNG.random() < 0.5:
            r = _revcomp(r)
        reads.append(r)
    return reads


def _write_fq(path, reads, gz=False):
    op = gzip.open if gz else open
    with op(path, "wt") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """Genomes, native DB (+mem variant), and reference-layout exports."""
    d = tmp_path_factory.mktemp("parity")
    gdir = d / "genomes"
    gdir.mkdir()
    base_a = _rand_genome(GLEN)
    base_d = _rand_genome(GLEN)
    strains = {
        "A1": base_a,
        "A2": _mutate(base_a, 60),
        "B1": _rand_genome(GLEN),
        "D1": base_d,
        "D2": _mutate(base_d, 70),
    }
    for name, seq in strains.items():
        with open(gdir / f"{name}.fa", "w") as f:
            f.write(f">{name}\n{seq}\n")
    db = str(d / "DB")
    build_database(str(gdir), db, BuildConfig())
    refdb = str(d / "REFDB")
    export_reference_db(db, refdb)
    mdb = str(d / "MDB")
    build_database(str(gdir), mdb, BuildConfig(memory_efficient=True))
    mrefdb = str(d / "MREFDB")
    export_reference_db(mdb, mrefdb)
    return str(d), strains, db, refdb, mdb, mrefdb


# fields whose values pass through sklearn coordinate descent — compared
# numerically (rtol) instead of as bytes
ENET_FIELDS = {
    "Relative_Abundance", "Relative_Abundance_Inside_Cluster",
    "Predicted_Depth (Enet)", "Predicted_Depth (Ab*cls_depth)",
}


def _assert_reports_match(ours_path, ref_path, enet_rtol=1e-9):
    assert os.path.exists(ours_path), f"missing {ours_path}"
    assert os.path.exists(ref_path), f"missing {ref_path}"
    a, b = open(ours_path).read(), open(ref_path).read()
    if a == b:
        return True  # byte-identical
    rows_a, rows_b = parse_report(ours_path), parse_report(ref_path)
    assert len(rows_a) == len(rows_b), f"row count {ours_path}\n{a}\nvs\n{b}"
    for ra, rb in zip(rows_a, rows_b):
        assert set(ra) == set(rb)
        for field, va in ra.items():
            vb = rb[field]
            if va == vb:
                continue
            assert field in ENET_FIELDS, \
                f"non-Enet field {field!r} differs: {va!r} vs {vb!r}"
            assert np.isclose(float(va), float(vb), rtol=enet_rtol), \
                f"{field}: {va} vs {vb}"
    return False


def _run_pair(d, name, fq, db, refdb, cfg=None, ref_args=(), fq2="",
              rgenome=""):
    ours = os.path.join(d, f"ours_{name}")
    run_identify(fq, fq2, db, ours, cfg or IdentifyConfig(),
                 rgenome=rgenome)
    ref_out = os.path.join(d, f"ref_{name}")
    args = ["-i", fq, "-d", refdb, "-o", ref_out] + list(ref_args)
    if fq2:
        args += ["-j", fq2]
    r = run_reference("StrainScan.py", args, os.path.join(d, f"wk_{name}"))
    assert r.returncode == 0, f"reference failed:\n{r.stderr[-3000:]}"
    return ours, ref_out


def test_single_multistrain_cluster(dbs):
    d, strains, db, refdb, _, _ = dbs
    fq = os.path.join(d, "single.fq")
    _write_fq(fq, _sim_reads(strains["A1"], 10))
    ours, ref = _run_pair(d, "single", fq, db, refdb)
    exact = _assert_reports_match(os.path.join(ours, "final_report.txt"),
                                  os.path.join(ref, "final_report.txt"))
    assert exact, "single-cluster report not byte-identical"


def test_cross_cluster_mixture(dbs):
    d, strains, db, refdb, _, _ = dbs
    fq = os.path.join(d, "crossmix.fq")
    _write_fq(fq, _sim_reads(strains["A1"], 5) + _sim_reads(strains["B1"], 5))
    ours, ref = _run_pair(d, "crossmix", fq, db, refdb)
    exact = _assert_reports_match(os.path.join(ours, "final_report.txt"),
                                  os.path.join(ref, "final_report.txt"))
    assert exact, "cross-cluster report not byte-identical"


def test_intra_cluster_mixture_enet(dbs):
    d, strains, db, refdb, _, _ = dbs
    fq = os.path.join(d, "intramix.fq")
    _write_fq(fq, _sim_reads(strains["A1"], 5) + _sim_reads(strains["A2"], 5))
    ours, ref = _run_pair(d, "intramix", fq, db, refdb)
    # both strains must be reported; Enet coefficients match to ~1e-9
    _assert_reports_match(os.path.join(ours, "final_report.txt"),
                          os.path.join(ref, "final_report.txt"))
    names = {r["Strain_Name"]
             for r in parse_report(os.path.join(ref, "final_report.txt"))}
    assert names == {"A1", "A2"}


def test_all_singleton(dbs):
    d, strains, db, refdb, _, _ = dbs
    fq = os.path.join(d, "singleton.fq")
    _write_fq(fq, _sim_reads(strains["B1"], 10))
    ours, ref = _run_pair(d, "singleton", fq, db, refdb)
    exact = _assert_reports_match(os.path.join(ours, "final_report.txt"),
                                  os.path.join(ref, "final_report.txt"))
    assert exact, "singleton report not byte-identical"


def test_low_depth_ladder(dbs):
    d, strains, db, refdb, _, _ = dbs
    fq = os.path.join(d, "lowdep.fq")
    _write_fq(fq, _sim_reads(strains["A1"], 0.5))
    ours, ref = _run_pair(d, "lowdep", fq, db, refdb,
                          cfg=IdentifyConfig(low_dep=1), ref_args=["-l", "1"])
    _assert_reports_match(os.path.join(ours, "final_report.txt"),
                          os.path.join(ref, "final_report.txt"))


def test_super_low_depth_ladder(dbs):
    """-l 2 cutoff triple [0.005, 0.01, 1] (StrainScan.py:211-217).

    0.6x, not lower: below ~0.3x the REFERENCE crashes (IndexError —
    get_avg_depth percentile over an empty array when no k-mer reaches
    count 2, identify_strains...sp.py:110-120); our _avg_depth guards
    that case, so there is nothing to byte-compare against down there."""
    d, strains, db, refdb, _, _ = dbs
    fq = os.path.join(d, "ldep2.fq")
    _write_fq(fq, _sim_reads(strains["A1"], 0.6))
    ours, ref = _run_pair(d, "ldep2", fq, db, refdb,
                          cfg=IdentifyConfig(low_dep=2), ref_args=["-l", "2"])
    _assert_reports_match(os.path.join(ours, "final_report.txt"),
                          os.path.join(ref, "final_report.txt"))


def test_retry_ladder(dbs):
    """A ~0.4x sample fails the primary [0.1, 0.4, 1] cutoffs, and the
    retry [0.05, 0.05, 1] (which also sets l2=1) must fire identically
    (StrainScan.py:194-204)."""
    d, strains, db, refdb, _, _ = dbs
    fq = os.path.join(d, "retry.fq")
    _write_fq(fq, _sim_reads(strains["B1"], 0.45))
    ours, ref = _run_pair(d, "retry", fq, db, refdb)
    _assert_reports_match(os.path.join(ours, "final_report.txt"),
                          os.path.join(ref, "final_report.txt"))


def test_pe_gzip_input(dbs):
    d, strains, db, refdb, _, _ = dbs
    reads = _sim_reads(strains["A1"], 6)
    h = len(reads) // 2
    fq1 = os.path.join(d, "pe_1.fq.gz")
    fq2 = os.path.join(d, "pe_2.fq.gz")
    _write_fq(fq1, reads[:h], gz=True)
    _write_fq(fq2, reads[h:], gz=True)
    ours, ref = _run_pair(d, "pe", fq1, db, refdb, fq2=fq2)
    _assert_reports_match(os.path.join(ours, "final_report.txt"),
                          os.path.join(ref, "final_report.txt"))


def test_strain_prob_report(dbs):
    d, strains, db, refdb, _, _ = dbs
    fq = os.path.join(d, "prob.fq")
    _write_fq(fq, _sim_reads(strains["A2"], 0.5))
    ours, ref = _run_pair(d, "prob", fq, db, refdb,
                          cfg=IdentifyConfig(low_dep=1, strain_prob=True),
                          ref_args=["-l", "1", "-b", "1"])
    exact = _assert_reports_match(os.path.join(ours, "strain_prob.txt"),
                                  os.path.join(ref, "strain_prob.txt"))
    assert exact, "strain_prob.txt not byte-identical"
    _assert_reports_match(os.path.join(ours, "final_report.txt"),
                          os.path.join(ref, "final_report.txt"))


def test_outlier_depth_sample(dbs):
    """A 60x repeated segment on top of 5x genome coverage drives counts
    through the reference's outlier culls (del_outlier 100x-median,
    identify.py:106-112, and the 1000x-median L2 ceiling,
    Vote_Strain_L2_Lasso_new_sp.py:404-414) — previously unexercised
    (round-1 weak #6)."""
    d, strains, db, refdb, _, _ = dbs
    fq = os.path.join(d, "outlier.fq")
    seg = strains["A1"][:3000]
    _write_fq(fq, _sim_reads(strains["A1"], 5) + _sim_reads(seg, 60))
    ours, ref = _run_pair(d, "outlier", fq, db, refdb)
    _assert_reports_match(os.path.join(ours, "final_report.txt"),
                          os.path.join(ref, "final_report.txt"))


@pytest.fixture(scope="module")
def shared_dbs(tmp_path_factory):
    """Two 2-strain clusters that SHARE a segment held by one strain of
    each: the shared k-mers are strain-unique within each cluster, so
    they land in both L2 matrices AND in each other's overlap-matrix
    column — driving the py_u cross-cluster masking
    (identify_strains...sp.py:191-205), dead on disjoint fixtures."""
    d = tmp_path_factory.mktemp("parity_shared")
    gdir = d / "genomes"
    gdir.mkdir()
    # S rides in ONE strain per cluster; the S-carrier chains into its
    # cluster through the superset relation (d(A1, A2) = |S|/(|base|+|S|)
    # ~ 0.04 < 0.05 single-linkage cutoff), while the clusters stay
    # ~0.98 apart
    S = _rand_genome(4_000)
    base_a = _rand_genome(100_000)
    base_b = _rand_genome(100_000)
    strains = {
        "A1": base_a + S,
        "A2": base_a,
        "A3": _mutate(base_a, 60),
        "B1": base_b + S,
        "B2": base_b,
        "B3": _mutate(base_b, 60),
    }
    for name, seq in strains.items():
        with open(gdir / f"{name}.fa", "w") as f:
            f.write(f">{name}\n{seq}\n")
    db = str(d / "DB")
    build_database(str(gdir), db, BuildConfig())
    refdb = str(d / "REFDB")
    export_reference_db(db, refdb)
    return str(d), strains, db, refdb


def test_cross_cluster_overlap_masking(shared_dbs):
    """Mixture of A1 + B1 (the two S-carrying strains): both clusters
    detect, and detect_strains must mask S's counts via the overlap
    matrix (py_u) when scanning each cluster.  Byte-compared against the
    reference on the exported DB."""
    d, strains, db, refdb = shared_dbs
    import json

    man = json.load(open(os.path.join(db, "manifest.json")))
    assert man["n_clusters"] == 2, "fixture must form exactly 2 clusters"
    fq = os.path.join(d, "sharedmix.fq")
    _write_fq(fq, _sim_reads(strains["A1"], 8) + _sim_reads(strains["B1"], 8))
    ours, ref = _run_pair(d, "sharedmix", fq, db, refdb)
    _assert_reports_match(os.path.join(ours, "final_report.txt"),
                          os.path.join(ref, "final_report.txt"))
    names = {r["Strain_Name"]
             for r in parse_report(os.path.join(ref, "final_report.txt"))}
    assert names == {"A1", "B1"}
    # the masking path must actually be active: S's k-mers appear in both
    # clusters' overlap matrices
    from strainscan_tpu.build.db import load_l2_db, load_manifest

    cids = load_manifest(db)["cluster_ids"]
    active = 0
    for cid in cids:
        cl = load_l2_db(db, int(cid))
        if cl is not None and cl.overlap[:, :].sum() > cl.matrix.shape[0]:
            active += 1
    assert active >= 1, "overlap matrices carry no cross-cluster k-mers"


def test_single_cluster_db(tmp_path):
    """Degenerate DB: 2 similar strains -> ONE cluster -> single-node
    tree.  The reference reader ignores the one-line tree_structure.txt
    and unpickles tree.pkl (identify.py:19-21), which export now writes
    via the treelib shim."""
    gdir = tmp_path / "genomes"
    gdir.mkdir()
    base = _rand_genome(GLEN)
    strains = {"S1": base, "S2": _mutate(base, 60)}
    for name, seq in strains.items():
        with open(gdir / f"{name}.fa", "w") as f:
            f.write(f">{name}\n{seq}\n")
    db = str(tmp_path / "DB")
    build_database(str(gdir), db, BuildConfig())
    import json

    man = json.load(open(os.path.join(db, "manifest.json")))
    assert man["n_clusters"] == 1
    refdb = str(tmp_path / "REFDB")
    export_reference_db(db, refdb)
    assert os.path.exists(os.path.join(refdb, "Tree_database", "tree.pkl"))
    fq = os.path.join(str(tmp_path), "s1.fq")
    _write_fq(fq, _sim_reads(strains["S1"], 8))
    ours, ref = _run_pair(str(tmp_path), "single_cls", fq, db, refdb)
    _assert_reports_match(os.path.join(ours, "final_report.txt"),
                          os.path.join(ref, "final_report.txt"))


@pytest.fixture(scope="module")
def emode_dbs(tmp_path_factory):
    """2-strain cluster where A2 = A1 + a 12 kb extra region — the use
    case -e 1 exists for (strains with extra genes/SVs,
    StrainScan.py:126).  The extra region is ~4% of the genome so the
    strains still fall in one cluster (d ~ 0.04 < 0.05)."""
    d = tmp_path_factory.mktemp("parity_emode")
    gdir = d / "genomes"
    gdir.mkdir()
    base = _rand_genome(500_000)
    extra = _rand_genome(14_000)
    # 150 SNPs keep both strains' unique-k-mer columns non-empty (a pure
    # superset pair would give A1 an all-zero column) while
    # d ~ (2*150*31 + 14000)/514k ~ 0.045 < 0.05 keeps one cluster
    strains = {"A1": base, "A2": _mutate(base, 150) + extra}
    for name, seq in strains.items():
        with open(gdir / f"{name}.fa", "w") as f:
            f.write(f">{name}\n{seq}\n")
    db = str(d / "DB")
    build_database(str(gdir), db, BuildConfig())
    refdb = str(d / "REFDB")
    export_reference_db(db, refdb)
    return str(d), strains, extra, db, refdb


def test_extra_region_mode_parity(emode_dbs):
    """-e 1 path head-to-head (round-2 VERDICT missing #3): A1 at full
    depth plus 60%% of A2's extra region.  Under default gates A2 is
    culled (coverage ~0.6 < 0.7 and remain-coverage cutoff); with -e 1
    the reference zeroes default_cov, sets remainc_cutoff=0 / check_c=5000
    (identify_strains...sp.py:247-261,350-355) and tags the strain
    '(With_ExtraRegion_covered)' (Vote...:430-436).  Exercises
    prescan.py:231,270-271 and vote.py:67-69."""
    d, strains, extra, db, refdb = emode_dbs
    fq = os.path.join(d, "emode.fq")
    # A1 at 15x keeps it the Pre-Scan dominant; half the extra region at
    # 6x gives A2 ~50% coverage (< 0.7 normal gate) with >5000 k-mers at
    # count >= 2 (the emode check_c)
    _write_fq(fq, _sim_reads(strains["A1"], 15) +
              _sim_reads(extra[: int(len(extra) * 0.5)], 6))
    ours, ref = _run_pair(d, "emode", fq, db, refdb,
                          cfg=IdentifyConfig(extra_region=True),
                          ref_args=["-e", "1"])
    _assert_reports_match(os.path.join(ours, "final_report.txt"),
                          os.path.join(ref, "final_report.txt"))
    # the emode acceptance must actually fire: A2 reported, suffixed
    names = {r["Strain_Name"]
             for r in parse_report(os.path.join(ref, "final_report.txt"))}
    assert "A2 (With_ExtraRegion_covered)" in names, names
    assert any(n.startswith("A1") for n in names)
    # per-cluster StrainVote.report carries the suffix identically
    import glob

    sv_ours = sorted(glob.glob(os.path.join(ours, "C*", "StrainVote.report")))
    assert sv_ours, "no StrainVote.report written"
    for p in sv_ours:
        rel = os.path.relpath(p, ours)
        _assert_reports_match(p, os.path.join(ref, rel))


def test_extra_region_off_suppresses(emode_dbs):
    """Same sample WITHOUT -e: both sides must agree again AND drop the
    partially-covered strain (proves the emode branches change the
    outcome rather than being dead)."""
    d, strains, extra, db, refdb = emode_dbs
    fq = os.path.join(d, "emode.fq")  # written by the test above
    if not os.path.exists(fq):
        _write_fq(fq, _sim_reads(strains["A1"], 15) +
                  _sim_reads(extra[: int(len(extra) * 0.5)], 6))
    ours, ref = _run_pair(d, "emode_off", fq, db, refdb)
    _assert_reports_match(os.path.join(ours, "final_report.txt"),
                          os.path.join(ref, "final_report.txt"))
    names = {r["Strain_Name"]
             for r in parse_report(os.path.join(ref, "final_report.txt"))}
    assert not any("ExtraRegion" in n for n in names)


def test_memory_efficient_db(dbs):
    d, strains, _, _, mdb, mrefdb = dbs
    fq = os.path.join(d, "memmix.fq")
    _write_fq(fq, _sim_reads(strains["A1"], 5) + _sim_reads(strains["B1"], 5))
    ours, ref = _run_pair(d, "mem", fq, mdb, mrefdb)
    _assert_reports_match(os.path.join(ours, "final_report.txt"),
                          os.path.join(ref, "final_report.txt"))


@pytest.fixture(scope="module")
def plasmid_dbs(tmp_path_factory):
    """Two same-cluster strains whose genome files each carry a distinct
    short (<100 kb) plasmid contig — the -p 1 use case
    (StrainScan.py:47-96,225-266).  Plasmids are disjoint so the
    rebuilt DB_plasmid forms two SINGLETON clusters: the reference's
    re-build then needs no sibeliaz (skipped for single-strain
    clusters, Build_kmer_sets...sp.py:612) and no random down-sampling
    (node sets < maxk), keeping its plasmid DB deterministic and
    head-to-head comparable with ours."""
    d = tmp_path_factory.mktemp("parity_plasmid")
    gdir = d / "genomes"
    gdir.mkdir()
    chrom = _rand_genome(400_000)
    pA1 = _rand_genome(6_000)
    pA2 = _rand_genome(8_000)
    # d(A1, A2) ~ (2*60*31 + 6000 + 8000) / ~416k = 0.043 < 0.05:
    # same cluster despite the distinct plasmids
    with open(gdir / "A1.fa", "w") as f:
        f.write(f">A1_chr\n{chrom}\n>pA1\n{pA1}\n")
    with open(gdir / "A2.fa", "w") as f:
        f.write(f">A2_chr\n{_mutate(chrom, 60)}\n>pA2\n{pA2}\n")
    with open(gdir / "B1.fa", "w") as f:
        f.write(f">B1\n{_rand_genome(300_000)}\n")
    db = str(d / "DB")
    build_database(str(gdir), db, BuildConfig(exact_distance=True))
    import json

    man = json.load(open(os.path.join(db, "manifest.json")))
    assert man["n_clusters"] == 2, "A1+A2 must share a cluster"
    refdb = str(d / "REFDB")
    export_reference_db(db, refdb)
    # plasmid-only genome dir for -p 2
    pdir = d / "plasmids"
    pdir.mkdir()
    with open(pdir / "pA1.fa", "w") as f:
        f.write(f">pA1\n{pA1}\n")
    with open(pdir / "pA2.fa", "w") as f:
        f.write(f">pA2\n{pA2}\n")
    reads = (_sim_reads(chrom, 5) + _sim_reads(pA1, 6)
             + _sim_reads(pA2, 6))
    fq = str(d / "plasmid.fq")
    _write_fq(fq, reads)
    return str(d), str(gdir), str(pdir), db, refdb, fq


def test_plasmid_mode_p1(plasmid_dbs):
    """-p 1 head-to-head (round-4 VERDICT item 4): short-contig
    extraction from -r genomes, re-build of DB_plasmid with -n 500, and
    re-identify — final report AND possible_plasmids.txt byte-compared
    against the reference driving its own StrainScan_build.py."""
    d, gdir, pdir, db, refdb, fq = plasmid_dbs
    ours, ref = _run_pair(d, "p1", fq, db, refdb,
                          cfg=IdentifyConfig(plasmid_mode=1),
                          ref_args=["-p", "1", "-r", gdir],
                          rgenome=gdir)
    _assert_reports_match(os.path.join(ours, "final_report.txt"),
                          os.path.join(ref, "final_report.txt"))
    a = open(os.path.join(ours, "possible_plasmids.txt")).read()
    b = open(os.path.join(ref, "possible_plasmids.txt")).read()
    assert a == b, f"possible_plasmids.txt differs:\n{a}\nvs\n{b}"
    names = {r["Strain_Name"]
             for r in parse_report(os.path.join(ref, "final_report.txt"))}
    assert names == {"A1", "A2"}, names


def test_plasmid_mode_p2(plasmid_dbs):
    """-p 2: the user-supplied -r dir IS the plasmid reference set — no
    extraction, straight re-build + re-identify (StrainScan.py:229-230)."""
    d, gdir, pdir, db, refdb, fq = plasmid_dbs
    ours, ref = _run_pair(d, "p2", fq, db, refdb,
                          cfg=IdentifyConfig(plasmid_mode=2),
                          ref_args=["-p", "2", "-r", pdir],
                          rgenome=pdir)
    _assert_reports_match(os.path.join(ours, "final_report.txt"),
                          os.path.join(ref, "final_report.txt"))
    names = {r["Strain_Name"]
             for r in parse_report(os.path.join(ref, "final_report.txt"))}
    assert names == {"pA1", "pA2"}, names


def test_direct_build_parity_singleton_db(tmp_path):
    """The reference's OWN StrainScan_build.py (via the dashing/Rscript
    shims) and our builder, run on the SAME genomes, must produce DBs
    that identify identically.  Limited to singleton clusters — the
    reference's multi-strain L2 build needs sibeliaz, which does not
    exist in this image (its plasmid path exercises the same machinery
    in test_plasmid_mode_p1).  Genomes stay under maxk/2 = 15 kb so no
    node set is randomly down-sampled — the reference's random.sample
    makes bigger builds nondeterministic by design (SURVEY §7 hard
    part 3)."""
    gdir = tmp_path / "genomes"
    gdir.mkdir()
    strains = {}
    for name in ("X1", "X2", "X3"):
        strains[name] = _rand_genome(14_500)
        with open(gdir / f"{name}.fa", "w") as f:
            f.write(f">{name}\n{strains[name]}\n")
    ours_db = str(tmp_path / "DB")
    build_database(str(gdir), ours_db, BuildConfig())

    ref_db = str(tmp_path / "REF_BUILT")
    r = run_reference("StrainScan_build.py",
                      ["-i", str(gdir), "-o", ref_db],
                      str(tmp_path / "wk_build"))
    assert r.returncode == 0, f"reference build failed:\n{r.stderr[-3000:]}"

    fq = str(tmp_path / "mix.fq")
    _write_fq(fq, _sim_reads(strains["X1"], 8) + _sim_reads(strains["X2"], 4))

    ours_out = str(tmp_path / "ours_out")
    run_identify(fq, "", ours_db, ours_out, IdentifyConfig())
    ref_out = str(tmp_path / "ref_out")
    r = run_reference("StrainScan.py",
                      ["-i", fq, "-d", ref_db, "-o", ref_out],
                      str(tmp_path / "wk_id"))
    assert r.returncode == 0, f"reference identify failed:\n{r.stderr[-3000:]}"
    exact = _assert_reports_match(os.path.join(ours_out, "final_report.txt"),
                                  os.path.join(ref_out, "final_report.txt"))
    assert exact, "direct-build reports not byte-identical"
    names = {r_["Strain_Name"]
             for r_ in parse_report(os.path.join(ref_out,
                                                 "final_report.txt"))}
    assert names == {"X1", "X2"}, names
