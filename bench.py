"""Benchmark: restricted k-mer counting throughput (reads/s) vs the
reference's jellyfish pipeline, at TWO table scales.

Measures the identification hot path end-to-end (FASTQ parse -> 2-bit
pack -> hash-table match -> per-k-mer counts) on the default JAX device,
against the reference pipeline (jellyfish count --if kmer.fa + dump -c +
Python dict parse, library/identify.py:73-103) run with the bundled
binary on the same inputs.

Tiers (BASELINE.json's metric is "reads/s/chip k-mer matching on E. coli
DB" — the E. coli DB's unified k-mer table is ~28.6M entries):

    toy    ~2M-key table   (round-1/2 comparable trend point)
    ecoli  ~28.6M-key table (the BASELINE scale; HEADLINE metric)

Noise discipline:

* ours = median of 5 reps over THREE passes of the read file (3.6M
  reads/rep), so the stream-end count fetch — the only d2h in the run —
  amortizes over more reads;
* jellyfish = median of 3 (reads/s is volume-free);
* bit-identity holds exactly: a triple stream counts 3x each key, so
  ours/3 must equal the jellyfish dump;
* the JSON carries, per tier, the device-sustained windows/s and
  reads/s and the finish/d2h seconds per rep.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}
where value/vs_baseline are the ecoli tier e2e and "detail" carries both
tiers' raw numbers and the per-stage breakdown.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

READ_LEN = 150
K = 31
BATCH = 65536
REPS = 5          # ours (fast reps, amortized volume)
REPS_JF = 3       # jellyfish baseline (slow, volume-independent metric)
PASSES = 3        # ours streams the read file this many times per rep
JELLYFISH = "/root/reference/library/jellyfish-linux"

# (name, genome_len, n_reads): table keys ~= 2 * genome_len (both strands)
TIERS = [
    ("toy", 1_000_000, 1_200_000),
    ("ecoli", 14_300_000, 1_200_000),
]


def log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def synthesize(tmp, tag, genome_len, n_reads):
    rng = np.random.default_rng(0)
    from strainscan_tpu.kmer import pack

    genome_codes = rng.integers(0, 4, size=genome_len).astype(np.uint8)
    km, _ = pack.pack_kmers(genome_codes, K)
    db = np.unique(np.concatenate([km, pack.revcomp_packed(km, K)]))
    fq = os.path.join(tmp, f"bench_{tag}.fq")
    # vectorized read synthesis: gather windows, revcomp half, map to ASCII
    starts = rng.integers(0, genome_len - READ_LEN, size=n_reads)
    idx = starts[:, None] + np.arange(READ_LEN)[None, :]
    reads = genome_codes[idx]                              # [N, L] codes
    flips = rng.random(n_reads) < 0.5
    reads[flips] = (3 - reads[flips])[:, ::-1]             # revcomp
    ascii_map = np.frombuffer(b"ACGT", dtype=np.uint8)
    # fixed-width FASTQ records, fully vectorized (names need not be
    # unique for counting): @r\n<seq>\n+\n<qual>\n
    head = np.frombuffer(b"@r\n", dtype=np.uint8)
    mid = np.frombuffer(b"\n+\n", dtype=np.uint8)
    row = head.size + READ_LEN + mid.size + READ_LEN + 1
    out = np.empty((n_reads, row), dtype=np.uint8)
    out[:, :head.size] = head
    out[:, head.size:head.size + READ_LEN] = ascii_map[reads]
    out[:, head.size + READ_LEN:head.size + READ_LEN + mid.size] = mid
    out[:, head.size + READ_LEN + mid.size:-1] = ord("I")
    out[:, -1] = ord("\n")
    out.tofile(fq)
    return db, fq


def bench_ours(db, fq, n_reads):
    from strainscan_tpu.index.hashtable import KmerTable
    from strainscan_tpu.io import fastx
    from strainscan_tpu.ops.count import CountPipeline
    from strainscan_tpu.utils.prefetch import prefetch_iter

    t0 = time.time()
    table = KmerTable.build(db, k=K)
    pipe = CountPipeline(table)
    log(f"table built in {time.time()-t0:.1f}s: {table.n_keys} keys, "
        f"fp geometry {pipe.fpt.n_buckets}x{pipe.fpt.bucket}"
        if pipe.fpt else "exact table")
    # warm-up: upload the table once and compile the one batch shape
    first = next(iter(fastx.read_batches(fq, batch=BATCH,
                                         maxlen=READ_LEN + 6, k=K)))
    pipe.add_batch(first)
    log("compiled; warming finish")
    pipe.finish()
    paths = [fq] * PASSES
    n_streamed = n_reads * PASSES
    times, finish_times = [], []
    counts3 = None
    for rep in range(REPS):
        pipe.reset()
        t0 = time.time()

        def produce():
            for batch in fastx.read_batches(paths, batch=BATCH,
                                            maxlen=READ_LEN + 6, k=K):
                yield pipe.prepare_batch(batch)

        for payloads in prefetch_iter(produce()):
            pipe.add_prepared(payloads)
        t_fin = time.time()
        counts3 = pipe.finish()
        finish_times.append(time.time() - t_fin)
        times.append(time.time() - t0)
        log(f"ours rep {rep}: {times[-1]:.2f}s "
            f"({n_streamed/times[-1]:.0f} reads/s; "
            f"finish/d2h {finish_times[-1]:.2f}s)")
    assert counts3.sum() > 0
    # a PASSES-fold stream counts every key exactly PASSES times
    assert (counts3 % PASSES == 0).all(), "triple stream must count 3x"
    counts = counts3 // PASSES
    dt = float(np.median(times))
    bd = breakdown(pipe, table, fq, first, n_reads)
    bd["finish_s"] = [round(t, 2) for t in finish_times]
    return n_streamed / dt, counts, times, bd


def breakdown(pipe, table, fq, first_batch, n_reads):
    """Per-stage wall times + device windows/s."""
    import jax
    import jax.numpy as jnp
    from strainscan_tpu.io import fastx
    from strainscan_tpu.kmer import pack

    t0 = time.time()
    nb = 0
    for b in fastx.read_batches(fq, batch=BATCH, maxlen=READ_LEN + 6, k=K):
        nb += b.shape[0]
    t_parse = time.time() - t0
    fb = np.asarray(first_batch)
    pack.bitpack_codes(fb)  # warm (first call pays alloc/page faults)
    fused = pack.bitpack_codes_vlen(fb)
    t0 = time.time()
    for _ in range(4):
        if fused is not None:
            words, vlen = pack.bitpack_codes_vlen(fb)
        else:
            words, _ = pack.bitpack_codes(fb)
            vlen = pack.valid_prefix_lens(fb)
    t_pack = (time.time() - t0) / 4 * (nb / max(fb.shape[0], 1))
    # device-only: replay the resident first batch with a carry dep
    wd = jnp.asarray(words)
    vl = jnp.asarray(vlen)
    jax.block_until_ready((wd, vl))
    from strainscan_tpu.ops.count import count_batch_fp_packed_vlen

    kw = dict(length=first_batch.shape[1], k=table.k,
              n_buckets=pipe.fpt.n_buckets, bucket=pipe.fpt.bucket,
              seed=pipe.fpt.seed, canonical=False)
    c = jnp.zeros((pipe.fpt.n_slots + 1,), jnp.int32)
    c = count_batch_fp_packed_vlen(c, wd, vl, pipe.dev_table, **kw)
    jax.block_until_ready(c)
    iters = 8
    t0 = time.time()
    for _ in range(iters):
        c = count_batch_fp_packed_vlen(c, wd, vl, pipe.dev_table, **kw)
    jax.block_until_ready(c)
    t_dev = (time.time() - t0) / iters * (nb / first_batch.shape[0])
    nw = n_reads * (READ_LEN + 6 - K + 1)
    log(f"breakdown: parse {t_parse:.2f}s ({nb/t_parse/1e3:.0f}k reads/s) | "
        f"pack ~{t_pack:.2f}s | device {t_dev:.2f}s "
        f"({nw/t_dev/1e6:.0f}M windows/s)")
    return {
        "parse_s": round(t_parse, 3),
        "pack_s": round(t_pack, 3),
        "device_s": round(t_dev, 3),
        "device_Mwin_s": round(nw / t_dev / 1e6, 1),
        # reads/s the device stage sustains alone
        "device_reads_s": round(n_reads / t_dev, 1),
    }


def bench_jellyfish(db, fq, tmp, n_reads):
    from strainscan_tpu.kmer import pack

    jf = os.path.join(tmp, "jf")
    if not os.path.exists(jf):
        shutil.copy(JELLYFISH, jf)
        os.chmod(jf, 0o755)
    kfa = os.path.join(tmp, "kmer.fa")
    pack.write_kmer_fa(kfa, db, K)
    times = []
    counts = None
    for rep in range(REPS_JF):
        t0 = time.time()
        out_jf = os.path.join(tmp, "out.jf")
        out_fa = os.path.join(tmp, "out.fa")
        subprocess.run([jf, "count", "-m", str(K), "-s", "100M", "-t", "8",
                        "--if", kfa, "-o", out_jf, fq], check=True)
        with open(out_fa, "w") as f:
            subprocess.run([jf, "dump", "-c", out_jf], check=True, stdout=f)
        # reference parse: kmer string -> index dict, then dump parse
        # (identify.py:90-102)
        kmer_index = {}
        with open(kfa) as f:
            lines = f.readlines()
        for i in range(len(lines) // 2):
            kmer_index[lines[i * 2 + 1].rstrip().upper()] = i
        match_results = {}
        with open(out_fa) as f:
            for line in f:
                s, c = line.rstrip().split(" ")
                match_results[kmer_index[s]] = int(c)
        times.append(time.time() - t0)
        log(f"jellyfish rep {rep}: {times[-1]:.2f}s "
            f"({n_reads/times[-1]:.0f} reads/s)")
        if rep == 0:
            counts = np.zeros(db.size, dtype=np.int64)
            for i, c in match_results.items():
                counts[i] = c
        del kmer_index, match_results, lines
    dt = float(np.median(times))
    return n_reads / dt, counts, times


def run_tier(tmp, tag, genome_len, n_reads):
    log(f"=== tier {tag}: synthesizing (genome {genome_len/1e6:.1f}Mb, "
        f"{n_reads/1e6:.1f}M reads)")
    db, fq = synthesize(tmp, tag, genome_len, n_reads)
    log(f"tier {tag}: {db.size} table keys; running the device pipeline")
    ours_rps, ours_counts, ours_times, bd = bench_ours(db, fq, n_reads)
    detail = {
        "n_keys": int(db.size),
        "n_reads": n_reads,
        "ours_reads_s": round(ours_rps, 1),
        "ours_times_s": [round(t, 2) for t in ours_times],
        "breakdown": bd,
    }
    if os.path.exists(JELLYFISH):
        base_rps, base_counts, base_times = bench_jellyfish(
            db, fq, tmp, n_reads)
        if not np.array_equal(ours_counts, base_counts):
            diff = int((ours_counts != base_counts).sum())
            print(f"WARNING: counts differ from jellyfish at {diff} "
                  f"positions", file=sys.stderr)
            detail["count_mismatches"] = diff
        detail["jellyfish_reads_s"] = round(base_rps, 1)
        detail["jellyfish_times_s"] = [round(t, 2) for t in base_times]
        detail["vs_baseline"] = round(ours_rps / base_rps, 2)
    else:
        detail["vs_baseline"] = float("nan")
    os.remove(fq)
    return detail


def main():
    tmp = tempfile.mkdtemp(prefix="sst_bench_")
    try:
        from strainscan_tpu.cli import _enable_compile_cache

        _enable_compile_cache()
        detail = {}
        for tag, genome_len, n_reads in TIERS:
            detail[tag] = run_tier(tmp, tag, genome_len, n_reads)
        head = detail["ecoli"]
        print(json.dumps({
            "metric": "kmer_match_reads_per_s_ecoli_scale",
            "value": head["ours_reads_s"],
            "unit": "reads/s",
            "vs_baseline": head["vs_baseline"],
            # companion metric: what the device sustains with the host
            # out of the loop (see breakdown per tier)
            "device_sustained_reads_s": head["breakdown"]["device_reads_s"],
            "detail": detail,
        }))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
