"""Build (once) a persistent E. coli-scale fixture for round-3 parity and
throughput work.

BASELINE.json's north star names the E. coli 1433-strain / 823-cluster DB
(/root/reference/README.md:114); this fixture reproduces that scale with
synthetic genomes: 823 families x (1 or 3 variants) = 1647 strains, which
clusters into ~1235 clusters with ~412 multi-strain ones (matches
benchmarks/SCALE_r02.json run 2).

Artifacts land under <repo>/.scale/ (gitignored):
  genomes/            1647 FASTA files
  DB/                 native-layout database
  REFDB/              the same DB exported to the reference layout
  samples/*.fq        single-strain / cross-cluster / intra-cluster reads
  meta.json           strain names, sample truth, build phase breakdown

Usage:  python benchmarks/scale_fixture.py [--families 823]
Re-runs skip everything already on disk (delete .scale/ to force).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from benchmarks.scale import sim_reads, synth  # noqa: E402

SCALE_DIR = os.path.join(REPO, ".scale")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--families", type=int, default=823)
    ap.add_argument("--variants", type=int, default=3)
    ap.add_argument("--glen", type=int, default=100_000)
    ap.add_argument("--threads", type=int, default=2)
    args = ap.parse_args()

    logging.basicConfig(format="%(asctime)s - %(message)s",
                        level=logging.INFO)
    rng = np.random.default_rng(5)
    os.makedirs(SCALE_DIR, exist_ok=True)
    gdir = os.path.join(SCALE_DIR, "genomes")
    meta_path = os.path.join(SCALE_DIR, "meta.json")
    meta = json.load(open(meta_path)) if os.path.exists(meta_path) else {}

    # ---------------------------------------------------------- genomes
    if not os.path.isdir(gdir) or not meta.get("strains"):
        os.makedirs(gdir, exist_ok=True)
        t0 = time.time()
        names, fam0 = synth(gdir, args.families, args.variants, args.glen,
                            rng)
        meta["strains"] = names
        meta["glen"] = args.glen
        meta["families"] = args.families
        print(f"genomes: {len(names)} strains in {time.time()-t0:.0f}s",
              flush=True)
    else:
        names = meta["strains"]
        fam0 = None
        print(f"genomes: reusing {len(names)} strains", flush=True)

    # --------------------------------------------------------------- DB
    db = os.path.join(SCALE_DIR, "DB")
    if not os.path.exists(os.path.join(db, "manifest.json")):
        from strainscan_tpu.build.pipeline import build_database
        from strainscan_tpu.config import BuildConfig
        from strainscan_tpu.utils.profiling import PHASE_TIMES

        t0 = time.time()
        build_database(gdir, db, BuildConfig(threads=args.threads))
        meta["build_s"] = round(time.time() - t0, 1)
        meta["build_phases"] = {k_: round(v, 1)
                                for k_, v in sorted(PHASE_TIMES.items())}
        print(f"build: {meta['build_s']}s", flush=True)
        print(json.dumps(meta["build_phases"], indent=1), flush=True)
    else:
        print("DB: reusing", flush=True)
    man = json.load(open(os.path.join(db, "manifest.json")))
    meta["n_clusters"] = man["n_clusters"]

    # ------------------------------------------------------------ REFDB
    refdb = os.path.join(SCALE_DIR, "REFDB")
    if not os.path.exists(os.path.join(refdb, "Tree_database", "kmer.fa")):
        from strainscan_tpu.build.convert import export_reference_db

        t0 = time.time()
        export_reference_db(db, refdb)
        meta["export_s"] = round(time.time() - t0, 1)
        print(f"export: {meta['export_s']}s", flush=True)
    else:
        print("REFDB: reusing", flush=True)

    # ---------------------------------------------------------- samples
    sdir = os.path.join(SCALE_DIR, "samples")
    os.makedirs(sdir, exist_ok=True)
    if "samples" not in meta:
        def genome_seq(name):
            p = os.path.join(gdir, name + ".fa")
            return "".join(l.strip() for l in open(p) if not
                           l.startswith(">"))

        # F000V0/F000V1 are variants in one multi-strain cluster;
        # F001V0 is a singleton family -> different cluster.
        samples = {}
        rng2 = np.random.default_rng(17)
        specs = {
            "single": [("F000V0", 10.0)],
            "crossmix": [("F000V0", 8.0), ("F001V0", 6.0)],
            "intramix": [("F000V0", 6.0), ("F000V1", 6.0)],
        }
        for sname, parts in specs.items():
            fq = os.path.join(sdir, sname + ".fq")
            n = 0
            with open(fq, "w") as out:
                for strain, depth in parts:
                    n += sim_reads(genome_seq(strain), depth, 100, rng2,
                                   out, n)
            samples[sname] = {"truth": [s for s, _ in parts], "reads": n}
            print(f"sample {sname}: {n} reads", flush=True)
        meta["samples"] = samples

    with open(meta_path, "w") as f:
        json.dump(meta, f, indent=1)
    print("fixture ready", flush=True)


if __name__ == "__main__":
    main()
