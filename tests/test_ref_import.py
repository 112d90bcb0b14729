"""Import a DB whose Tree_database was built by the ACTUAL reference
builder (round-2 VERDICT missing #4).

``convert.import_reference_db`` was previously proven only against this
repo's own exports.  Here the REFERENCE's ``library/Build_tree.build_tree``
(driven directly — it needs neither dashing nor sibeliaz) produces the
tree artifacts, including ``random.sample``-down-sampled node k-mer sets
and ``overlapping_info[_supple]`` files (Build_tree.py:494-698), which we
then import and require identify parity on.

Layout of the head-to-head:
  our build  -> export            gives Kmer_Sets_L2 + Cluster_Result
  reference  Build_tree.build_tree(dist_rebuild, hclsMap_95_recls, ...)
             -> Tree_database     (the artifacts the repo did NOT write)
  hybrid REFDB = reference Tree_database + exported L2/cluster files
  ours       import_reference_db(hybrid) -> identify
  reference  StrainScan.py -d hybrid     -> identify
  both final_report.txt must agree.

Reference chain exercised: Build_tree.py:239-698 (hierarchy, extract,
set propagation, down-sampling :590-591,:617-627, reconstruction +
overlapping_info :600-661, file writers :494-698), then identify.py's
reader over those files.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from strainscan_tpu.build.convert import export_reference_db, \
    import_reference_db
from strainscan_tpu.build.distance import distance_matrix
from strainscan_tpu.build.pipeline import build_database
from strainscan_tpu.config import BuildConfig, IdentifyConfig
from strainscan_tpu.identify.pipeline import run_identify

from ref_harness import REPO, ensure_ref_copy, jellyfish_ok, parse_report, \
    run_reference

pytestmark = pytest.mark.skipif(
    not jellyfish_ok(), reason="bundled jellyfish binary not runnable")

RNG = np.random.default_rng(43)
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


def _write_fq(path, reads):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")


_DRIVER = """\
import os
import random
import sys

random.seed(0)
from Build_tree import build_tree

dist_file, cls_file, tree_dir, k = sys.argv[1:5]
os.makedirs(tree_dir, exist_ok=True)
# params = [alpha_ratio, mink, maxk, maxn] (StrainScan_build.py:85 defaults)
build_tree([dist_file, cls_file, tree_dir, int(k), [0.8, 1000, 30000, 3000]])
"""


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("refimport"))
    gdir = os.path.join(d, "genomes")
    os.makedirs(gdir)
    base_a = _rand_genome(GLEN)
    base_d = _rand_genome(GLEN)
    strains = {
        "A1": base_a,
        "A2": _mutate(base_a, 60),
        "B1": _rand_genome(GLEN),
        "D1": base_d,
        "D2": _mutate(base_d, 70),
    }
    paths = {}
    for name, seq in strains.items():
        paths[name] = os.path.join(gdir, f"{name}.fa")
        with open(paths[name], "w") as f:
            f.write(f">{name}\n{seq}\n")

    # our build supplies the L2 matrices + cluster maps
    db = os.path.join(d, "DB")
    build_database(gdir, db, BuildConfig())
    refdb = os.path.join(d, "REFDB_export")
    export_reference_db(db, refdb)

    # similarity matrix in the reference's *_rebuild.txt format
    # (Cluster.py:32-53: header of paths, rows of 1-dist)
    names, dist = distance_matrix([paths[n] for n in sorted(strains)],
                                  exact=True)
    dist_file = os.path.join(d, "distance_matrix_rebuild.txt")
    with open(dist_file, "w") as f:
        for n in names:
            f.write("\t" + paths[n])
        f.write("\n")
        for i, n in enumerate(names):
            f.write(paths[n])
            for j in range(len(names)):
                f.write(f"\t{1.0 - dist[i, j]}")
            f.write("\n")

    # drive the REFERENCE builder on our cluster map
    cls_file = os.path.join(refdb, "Cluster_Result", "hclsMap_95_recls.txt")
    hybrid = os.path.join(d, "REFDB_hybrid")
    tree_dir = os.path.join(hybrid, "Tree_database")
    os.makedirs(hybrid)
    driver = os.path.join(d, "drive_build_tree.py")
    with open(driver, "w") as f:
        f.write(_DRIVER)
    r = run_reference(driver, [dist_file, cls_file, tree_dir, "31"],
                      os.path.join(d, "wk_build"), timeout=1800)
    assert r.returncode == 0, f"reference build_tree failed:\n{r.stderr[-4000:]}"
    assert os.path.exists(os.path.join(tree_dir, "kmer.fa"))
    # build_tree writes its own hclsMap into Tree_database
    # (StrainScan_build.py:136-137 copies it out); keep Cluster_Result and
    # the L2 sets from the export
    if not os.path.exists(os.path.join(tree_dir, "hclsMap_95_recls.txt")):
        shutil.copy(cls_file, tree_dir)
    for sub in ("Kmer_Sets_L2", "Cluster_Result"):
        shutil.copytree(os.path.join(refdb, sub), os.path.join(hybrid, sub))

    # import the reference-built artifacts into the native layout
    imported_db = os.path.join(d, "DB_imported")
    import_reference_db(hybrid, imported_db)
    return d, strains, imported_db, hybrid, tree_dir


# fields through coordinate descent: numeric compare (see
# tests/test_reference_parity.py)
ENET_FIELDS = {
    "Relative_Abundance", "Relative_Abundance_Inside_Cluster",
    "Predicted_Depth (Enet)", "Predicted_Depth (Ab*cls_depth)",
}


def _assert_match(ours_path, ref_path, rtol=1e-9):
    a, b = open(ours_path).read(), open(ref_path).read()
    if a == b:
        return True
    ra, rb = parse_report(ours_path), parse_report(ref_path)
    assert len(ra) == len(rb), f"row count:\n{a}\nvs\n{b}"
    for x, y in zip(ra, rb):
        for fld, va in x.items():
            vb = y[fld]
            if va == vb:
                continue
            assert fld in ENET_FIELDS, f"{fld}: {va!r} vs {vb!r}"
            assert np.isclose(float(va), float(vb), rtol=rtol)
    return False


def test_downsampling_happened(imported):
    """The nondeterministic random.sample path (Build_tree.py:590-591)
    must actually be active: 100 kb leaves have ~200k candidate k-mers,
    so every leaf set is capped at maxk=30000."""
    _, _, _, _, tree_dir = imported
    lens = {}
    with open(os.path.join(tree_dir, "node_length.txt")) as f:
        for line in f:
            nid, ln = line.split()
            lens[int(nid)] = int(ln)
    assert max(lens.values()) == 30000, lens


def test_identify_parity_on_imported_tree(imported):
    """Single-strain and cross-cluster samples against the imported DB;
    the cross mixture descends reconstructed nodes whose overlapping_info
    the reference builder wrote."""
    d, strains, imported_db, hybrid, _ = imported
    for sample, mix in (
        ("one", [("A1", 10.0)]),
        ("mix", [("A1", 6.0), ("B1", 6.0), ("D2", 5.0)]),
    ):
        fq = os.path.join(d, f"s_{sample}.fq")
        reads = []
        for s, dep in mix:
            reads += _sim_reads(strains[s], dep)
        _write_fq(fq, reads)
        ours = os.path.join(d, f"ours_{sample}")
        run_identify(fq, "", imported_db, ours, IdentifyConfig())
        ref_out = os.path.join(d, f"ref_{sample}")
        r = run_reference("StrainScan.py",
                          ["-i", fq, "-d", hybrid, "-o", ref_out],
                          os.path.join(d, f"wk_{sample}"))
        assert r.returncode == 0, r.stderr[-4000:]
        _assert_match(os.path.join(ours, "final_report.txt"),
                      os.path.join(ref_out, "final_report.txt"))
        names = {row["Strain_Name"]
                 for row in parse_report(
                     os.path.join(ref_out, "final_report.txt"))}
        assert {s for s, _ in mix} <= names, names
