"""Sharded-vs-single count pipeline on the SAME device (1-device mesh).

Measures the overhead of the multi-device path (shard_map + mesh h2d +
slot-space partials) relative to the single-device CountPipeline on one
identical read stream, asserting bit-exact counts.  The ratio is the
per-device efficiency a multi-device run keeps (collectives excepted).

Usage:  python benchmarks/sharded_bench.py [--reads 300000]
                 [--genome-len 1000000]
(--genome-len 14300000 gives the 28.6M-key E. coli BASELINE scale.)
Prints one JSON line.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GENOME_LEN = 1_000_000      # overridden by --genome-len
READ_LEN = 150
K = 31
BATCH = 65536


def log(msg):
    print(f"[sharded_bench] {msg}", file=sys.stderr, flush=True)


def synthesize(tmp, n_reads):
    rng = np.random.default_rng(0)
    from strainscan_tpu.kmer import pack

    genome_codes = rng.integers(0, 4, size=GENOME_LEN).astype(np.uint8)
    km, _ = pack.pack_kmers(genome_codes, K)
    db = np.unique(np.concatenate([km, pack.revcomp_packed(km, K)]))
    fq = os.path.join(tmp, "bench.fq")
    starts = rng.integers(0, GENOME_LEN - READ_LEN, size=n_reads)
    idx = starts[:, None] + np.arange(READ_LEN)[None, :]
    reads = genome_codes[idx]
    flips = rng.random(n_reads) < 0.5
    reads[flips] = (3 - reads[flips])[:, ::-1]
    ascii_map = np.frombuffer(b"ACGT", dtype=np.uint8)
    lines = ascii_map[reads]
    qual = "I" * READ_LEN
    with open(fq, "wb") as f:
        seqs = lines.tobytes()
        for i in range(n_reads):
            f.write(b"@r%d\n" % i)
            f.write(seqs[i * READ_LEN:(i + 1) * READ_LEN])
            f.write(b"\n+\n%s\n" % qual.encode())
    return db, fq


def drive(pipe, fq):
    """Stream fq through pipe with the production prepare/dispatch split."""
    from strainscan_tpu.io import fastx
    from strainscan_tpu.utils.prefetch import prefetch_iter

    n_box = [0]
    ship = getattr(pipe, "ship", None)

    def produce():
        for batch in fastx.read_batches(fq, batch=BATCH,
                                        maxlen=READ_LEN + 6, k=K):
            n_box[0] += batch.shape[0]
            payloads = pipe.prepare_batch(batch)
            yield ship(payloads) if ship is not None else payloads

    t0 = time.time()
    for payloads in prefetch_iter(produce()):
        pipe.add_prepared(payloads)
    counts = pipe.finish()
    dt = time.time() - t0
    return n_box[0] / dt, np.asarray(counts, np.int64)


def main():
    global GENOME_LEN
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=300_000)
    ap.add_argument("--genome-len", type=int, default=GENOME_LEN)
    args = ap.parse_args()
    GENOME_LEN = args.genome_len
    from strainscan_tpu.index.hashtable import KmerTable
    from strainscan_tpu.ops.count import CountPipeline
    from strainscan_tpu.parallel.sharded import (ShardedCountPipeline,
                                                 make_mesh)

    tmp = tempfile.mkdtemp(prefix="sst_shbench_")
    log("synthesizing data")
    db, fq = synthesize(tmp, args.reads)
    table = KmerTable.build(db, k=K)
    single = CountPipeline(table)
    log("single: warm-up pass")
    rps, _ = drive(single, fq)  # compile + table upload outside timing
    single.reset()
    log(f"single warm pass {rps:.0f} r/s")

    mesh = make_mesh(1, index_shards=1)
    sharded = ShardedCountPipeline(db, k=K, mesh=mesh)
    log("sharded: warm-up pass")
    drive(sharded, fq)
    sharded.reset()

    # INTERLEAVED median-of-3: alternating the two pipelines keeps drift
    # in host or link rate from landing on one side only
    single_reps, sharded_reps = [], []
    single_counts = sharded_counts = None
    for rep in range(3):
        r, single_counts = drive(single, fq)
        single.reset()
        single_reps.append(r)
        log(f"rep {rep}: single {r:.0f} r/s")
        r, sharded_counts = drive(sharded, fq)
        sharded.reset()
        sharded_reps.append(r)
        log(f"rep {rep}: sharded {r:.0f} r/s")

    single_rps = float(np.median(single_reps))
    sharded_rps = float(np.median(sharded_reps))
    exact = bool(np.array_equal(single_counts, sharded_counts))
    print(json.dumps({
        "n_keys": int(db.size),
        "single_rps": round(single_rps, 1),
        "sharded_1dev_rps": round(sharded_rps, 1),
        "ratio": round(sharded_rps / single_rps, 3),
        "single_reps": [round(r, 1) for r in single_reps],
        "sharded_reps": [round(r, 1) for r in sharded_reps],
        "bit_exact": exact,
        "reads": args.reads,
    }))
    if not exact:
        sys.exit(1)


if __name__ == "__main__":
    main()
