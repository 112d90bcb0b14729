"""Scale stress: synthetic many-strain DB build + identification timing.

Approximates the reference's published DB scales (README.md:109-118, e.g.
E. coli 1433 strains / 823 clusters) with synthetic genomes: N_FAMILIES
unrelated base genomes, each with a few near-identical variants, so the
cluster structure (multi-strain clusters + singletons) matches real DBs.

    python benchmarks/scale.py --families 20 --variants 3 --glen 200000

Prints per-phase wall times and a one-line JSON summary.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def synth(gdir: str, families: int, variants: int, glen: int, rng):
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    bases = np.array(list("ACGT"))
    names = []
    first_family = None
    for f in range(families):
        base = "".join(rng.choice(bases, size=glen))
        if first_family is None:
            first_family = []
        for v in range(variants if f % 2 == 0 else 1):
            s = np.array(list(base))
            # 30 SNPs per variant step: far enough apart for the msn=40
            # L2 separability gate (30 x ~62 affected k-mers > 40*31),
            # close enough (d ~ 0.02-0.04 < 0.05) that variants form one
            # multi-strain cluster like real strain families
            n_snps = 30 * (v + 1)
            if v:
                for p in rng.choice(glen, size=n_snps, replace=False):
                    s[p] = rng.choice([b for b in bases if b != s[p]])
            name = f"F{f:03d}V{v}"
            seq = "".join(s)
            with open(os.path.join(gdir, name + ".fa"), "w") as fh:
                fh.write(f">{name}\n{seq}\n")
            names.append(name)
            if f == 0:
                first_family.append((name, seq))
    return names, first_family


def sim_reads(seq: str, depth: float, read_len: int, rng, out, start_id=0):
    comp = str.maketrans("ACGT", "TGCA")
    n = int(len(seq) * depth / read_len)
    for i in range(n):
        s = int(rng.integers(0, len(seq) - read_len))
        r = seq[s:s + read_len]
        if rng.random() < 0.5:
            r = r.translate(comp)[::-1]
        out.write(f"@r{start_id + i}\n{r}\n+\n{'I' * read_len}\n")
    return n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--families", type=int, default=20)
    ap.add_argument("--variants", type=int, default=3)
    ap.add_argument("--glen", type=int, default=200_000)
    ap.add_argument("--depth", type=float, default=8.0)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--keep", action="store_true")
    args = ap.parse_args()

    logging.basicConfig(format="%(asctime)s - %(message)s",
                        level=logging.INFO)
    rng = np.random.default_rng(5)
    tmp = tempfile.mkdtemp(prefix="sst_scale_")
    gdir = os.path.join(tmp, "genomes")
    os.makedirs(gdir)
    names, fam0 = synth(gdir, args.families, args.variants, args.glen, rng)
    print(f"{len(names)} synthetic strains of {args.glen} bp", flush=True)

    from strainscan_tpu.build.pipeline import build_database
    from strainscan_tpu.config import BuildConfig, IdentifyConfig
    from strainscan_tpu.identify.pipeline import run_identify

    db = os.path.join(tmp, "DB")
    t0 = time.time()
    build_database(gdir, db, BuildConfig(threads=args.threads))
    t_build = time.time() - t0
    print(f"build: {t_build:.1f}s", flush=True)

    fq = os.path.join(tmp, "sample.fq")
    with open(fq, "w") as out:
        n = sim_reads(fam0[0][1], args.depth, 100, rng, out)
        n += sim_reads(fam0[-1][1], args.depth / 2, 100, rng, out, n)
    print(f"sample: {n} reads", flush=True)

    t0 = time.time()
    res = run_identify(fq, "", db, os.path.join(tmp, "out"),
                       IdentifyConfig())
    t_id = time.time() - t0
    print(f"identify: {t_id:.1f}s", flush=True)
    report = open(os.path.join(tmp, "out", "final_report.txt")).read()
    print(report)
    ok = fam0[0][0] in report
    print(json.dumps({
        "strains": len(names), "glen": args.glen,
        "build_s": round(t_build, 1), "identify_s": round(t_id, 1),
        "reads": n, "target_found": ok,
    }))
    if not args.keep:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
