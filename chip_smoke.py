"""Smoke test of the identify path on an NVIDIA GPU.

    python chip_smoke.py              # one card: count, L2 and identify phases
    python chip_smoke.py --cards 4    # four cards: the sharded paths only

Phases, each checked against a plain host reference:

* count — a seeded 14.3 Mb genome with both strands in the table (~28.6M
  keys, the E. coli DB's full table width).  A deep sample (~200k 150 bp
  reads, both orientations, some N bases, some reads shorter than k; its
  nnz exceeds the sparse cap, so finish takes the dense route) and a
  sparse one (~12k reads, sparse route) stream through
  ``identify.count.count_sample`` (fingerprint probe) and through
  ``CountPipeline(probe_mode="exact")`` with the default batch geometry.
  Counts must equal :func:`host_counts` exactly, and probe prep as
  compiled for the card (the Triton kernel of ops/probe_prep.py) must
  equal the plain jnp chain at 65536x256, forward and canonical.
* L2 kernels — the Pre-Scan int8 column sums and the Enet fold-Gram scan
  at 2^18 rows against int64 NumPy (exact), and the float32 Gram branch
  against float64 NumPy.
* identify — ``cli build`` over seeded synthetic strain families
  (benchmarks/scale.py), then ``cli identify`` on an intra-cluster and a
  cross-cluster mixture and ``cli batch-identify`` on three samples.
  Every ``final_report.txt`` must name the simulated strains and equal
  the same CLI run in a child process pinned to the CPU
  (``JAX_PLATFORMS=cpu``; it never opens the card): bytes, except the
  Enet-derived fields, which match at rtol 1e-9.

``--cards 4`` runs only what exists across cards: the deep sample through
``ShardedCountPipeline`` on the default 2x2 mesh, and the mesh-routed L2
kernels on a matrix above ``shard_min_l2_rows``.

Any failure raises (non-zero exit).  Without a GPU the script exits
non-zero before any phase.  The last line of standard output is one JSON
object: ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke")          # gitignored, removed at exit

K = 31
READ_LEN = 150
GENOME_LEN = 14_300_000
N_DEEP = 200_000
N_SPARSE = 12_000
L2_ROWS = 1 << 18
FAMILIES = 260         # of the E. coli DB's 823 clusters: builds in ~3 min
FAMILY_GLEN = 200_000

# fields that pass through the Enet coordinate descent (as in
# tests/test_reference_parity.py): compared numerically, not as bytes
ENET_FIELDS = {
    "Relative_Abundance", "Relative_Abundance_Inside_Cluster",
    "Predicted_Depth (Enet)", "Predicted_Depth (Ab*cls_depth)",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return r.stdout.strip() or r.stderr.strip()


# ------------------------------------------------------------------ data
def table_keys(genome: np.ndarray) -> np.ndarray:
    """Sorted unique packed k-mers of both strands (the default DB)."""
    from strainscan_tpu.kmer import pack

    km, _ = pack.pack_kmers(genome, K)
    return np.unique(np.concatenate([km, pack.revcomp_packed(km, K)]))


def synth_reads(rng, genome: np.ndarray, n: int, n_frac: float = 0.0,
                short_frac: float = 0.0, short_len: int = 20):
    """(codes uint8 [n, READ_LEN], lens int [n]): reads of either strand;
    ``n_frac`` of them get one N base, ``short_frac`` are cut below k.
    Code 4 marks N bases and the padding after a short read."""
    starts = rng.integers(0, genome.size - READ_LEN, size=n)
    codes = genome[starts[:, None] + np.arange(READ_LEN)[None, :]]
    flip = rng.random(n) < 0.5
    codes[flip] = (3 - codes[flip])[:, ::-1]
    with_n = np.nonzero(rng.random(n) < n_frac)[0]
    codes[with_n, rng.integers(0, READ_LEN, size=with_n.size)] = 4
    lens = np.full(n, READ_LEN)
    short = rng.random(n) < short_frac
    lens[short] = short_len
    codes[short, short_len:] = 4
    return codes, lens


def write_fastq(path: str, codes: np.ndarray, lens: np.ndarray) -> None:
    ascii_ = np.frombuffer(b"ACGTN", dtype=np.uint8)[codes].tobytes()
    qual = b"I" * READ_LEN
    w = codes.shape[1]
    with open(path, "wb") as f:
        for i, n in enumerate(lens.tolist()):
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, ascii_[i * w:i * w + n],
                                            qual[:n]))


def host_counts(keys: np.ndarray, codes: np.ndarray, k: int = K,
                chunk: int = 1 << 15) -> np.ndarray:
    """Host oracle: for every read's forward windows free of N (code >= 4),
    count the sorted ``keys`` it equals (searchsorted + bincount)."""
    out = np.zeros(keys.size, dtype=np.int64)
    m = codes.shape[1] - k + 1
    for i in range(0, codes.shape[0], chunk):
        c = codes[i:i + chunk]
        win = np.zeros((c.shape[0], m), dtype=np.uint64)
        for j in range(k):
            win <<= np.uint64(2)
            win |= (c[:, j:j + m] & 3).astype(np.uint64)
        bad = np.cumsum(np.pad(c >= 4, ((0, 0), (1, 0))), axis=1)
        w = win[(bad[:, k:] - bad[:, :-k]) == 0]
        idx = np.searchsorted(keys, w)
        idx[idx == keys.size] = 0
        hit = idx[keys[idx] == w]
        out += np.bincount(hit, minlength=keys.size)
    return out


def _check_counts(tag: str, got: np.ndarray, want: np.ndarray) -> None:
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = int(np.count_nonzero(got != want)) \
            if got.shape == want.shape else -1
        raise AssertionError(f"{tag}: counts differ from the host oracle "
                             f"at {bad} of {want.size} keys")


def _gpu_ops(hlo: str) -> str:
    """The fusions and custom calls of a compiled program's HLO text."""
    ops = set(re.findall(r"%([a-z_]+?)(?:\.\d+)? = [^=]*? fusion\(", hlo))
    ops |= set(re.findall(r'custom_call_target="([^"]+)"', hlo))
    return ",".join(sorted(ops)) or "none"


# ----------------------------------------------------------------- count
def count_phase(genome_len: int = GENOME_LEN, n_deep: int = N_DEEP,
                n_sparse: int = N_SPARSE, seed: int = 0) -> None:
    import jax
    import jax.numpy as jnp

    from strainscan_tpu.config import IdentifyConfig
    from strainscan_tpu.identify.count import count_sample
    from strainscan_tpu.index.hashtable import KmerTable
    from strainscan_tpu.io import fastx
    from strainscan_tpu.ops import count as ocount
    from strainscan_tpu.ops import probe_prep as pp

    cfg = IdentifyConfig()
    rng = np.random.default_rng(seed)
    t0 = time.time()
    genome = rng.integers(0, 4, size=genome_len).astype(np.uint8)
    keys = table_keys(genome)
    table = KmerTable.build(keys, k=K)
    log(f"count: {genome_len} bp genome, {keys.size} table keys, "
        f"built in {time.time() - t0:.1f}s")

    def run_exact(path):
        pipe = ocount.CountPipeline(table, probe_mode="exact")
        for b in fastx.read_batches(path, batch=cfg.read_batch,
                                    maxlen=cfg.max_read_len, k=K):
            pipe.add_batch(b)
        return pipe.finish()

    runs = {"fp": lambda p: count_sample(table, p, cfg, keys=keys),
            "exact": run_exact}
    for name, n, n_frac, short_frac in (("deep", n_deep, 0.02, 0.01),
                                        ("sparse", n_sparse, 0.0, 0.0)):
        codes, lens = synth_reads(rng, genome, n, n_frac, short_frac)
        path = os.path.join(WORK, f"{name}.fq")
        write_fastq(path, codes, lens)
        want = host_counts(keys, codes)
        nnz = int(np.count_nonzero(want))
        for mode, run in runs.items():
            t0 = time.time()
            got = run(path)
            t_cold = time.time() - t0
            _check_counts(f"count {name}/{mode}", got, want)
            t0 = time.time()
            got = run(path)
            t_warm = time.time() - t0
            _check_counts(f"count {name}/{mode} (warm)", got, want)
            log(f"count {name}/{mode}: {n} reads, nnz {nnz}, "
                f"{int(want.sum())} hits equal the host oracle; "
                f"first run {t_cold:.2f}s, warm {t_warm:.2f}s = "
                f"{n / t_warm:.0f} reads/s")
        # the route CountPipeline.finish takes for these counts
        cap = ocount._sparse_cap(table._fp_cache.n_slots)
        vb = 1 if want.max() < (1 << 8) else 2 if want.max() < (1 << 16) \
            else 4
        route = ("sparse" if nnz <= cap
                 and nnz * (4 + vb) < (table.n_keys * vb) // 2 else "dense")
        log(f"count {name}: finish route {route} (sparse cap {cap})")
        if route != ("dense" if name == "deep" else "sparse"):
            raise AssertionError(f"{name} sample took the {route} route")

    # probe prep as compiled for this platform (the Triton kernel on
    # CUDA) against the plain jnp chain, at the production batch width
    fpt = table._fp_cache
    codes = np.full((cfg.read_batch, cfg.max_read_len), 4, np.uint8)
    codes[:, :READ_LEN] = synth_reads(rng, genome, cfg.read_batch, 0.02,
                                      0.01)[0]
    codes = jnp.asarray(codes)
    for canonical in (False, True):
        kw = dict(k=K, n_buckets=fpt.n_buckets, seed=fpt.seed,
                  canonical=canonical)
        got = jax.device_get(jax.jit(
            lambda c: pp.probe_prep(c, **kw))(codes))
        want = jax.device_get(jax.jit(
            lambda c: pp.probe_prep_jnp(c, **kw))(codes))
        ok = want[0] >= 0
        if not (np.array_equal(got[0], want[0])
                and np.array_equal(got[1][ok], want[1][ok])):
            raise AssertionError(f"probe prep (canonical={canonical}) "
                                 "differs from the plain jnp chain")
        log(f"probe prep {codes.shape[0]}x{codes.shape[1]} "
            f"canonical={canonical}: equals the plain jnp chain on "
            f"{int(ok.sum())} valid windows")

    # the compiled count step at the production batch geometry
    sds = jax.ShapeDtypeStruct
    b, length = cfg.read_batch, cfg.max_read_len
    args = (sds((fpt.n_slots + 1,), np.int32),
            sds((b, -(-length // 16)), np.uint32), sds((b,), np.uint16),
            sds((fpt.n_buckets, fpt.bucket), np.uint32))
    t0 = time.time()
    comp = ocount.count_batch_fp_packed_vlen.lower(
        *args, length=length, k=K, n_buckets=fpt.n_buckets,
        bucket=fpt.bucket, seed=fpt.seed, canonical=False).compile()
    t_compile = time.time() - t0
    ma = comp.memory_analysis()
    mem = "unavailable" if ma is None else (
        f"argument {ma.argument_size_in_bytes} B, output "
        f"{ma.output_size_in_bytes} B, alias {ma.alias_size_in_bytes} B, "
        f"temp {ma.temp_size_in_bytes} B")
    log(f"count step {b}x{length} vs {fpt.n_buckets}x{fpt.bucket} fp table: "
        f"compile {t_compile:.2f}s; memory_analysis: {mem}")


# -------------------------------------------------------------------- L2
def l2_phase(n_rows: int = L2_ROWS, s: int = 16, seed: int = 1,
             min_shard_rows=None) -> None:
    """Pre-Scan column sums and Enet fold Grams against NumPy."""
    import jax.numpy as jnp

    from strainscan_tpu.identify import prescan
    from strainscan_tpu.ops import enet

    rng = np.random.default_rng(seed)
    X = (rng.random((n_rows, s)) < 0.3).astype(np.int8)
    y = rng.integers(0, 40, size=n_rows).astype(np.float64)
    X64 = X.astype(np.int64)
    big = y > 1
    used = X[:, 0] > 0
    kern = prescan._L2Kernels(X, min_shard_rows=min_shard_rows)
    if (min_shard_rows is not None) != (kern.mesh is not None):
        raise AssertionError("L2 mesh route engaged unexpectedly" if
                             kern.mesh is not None else
                             "L2 mesh route not engaged")
    route = "mesh %s" % dict(kern.mesh.shape) if kern.mesh else "one device"
    got = kern.colsum(kern.to_mask(big))
    if not np.array_equal(got, X64.T @ big):
        raise AssertionError("Pre-Scan colsum differs from NumPy")
    got = kern.colsum_unused(kern.to_mask(used), kern.to_mask(big))
    if not np.array_equal(got, X64.T @ (~used & big)):
        raise AssertionError("Pre-Scan colsum_unused differs from NumPy")
    got = np.asarray(kern.or_column(kern.to_mask(used), 3))[:n_rows]
    if not np.array_equal(got, used | (X[:, 3] > 0)):
        raise AssertionError("Pre-Scan or_column differs from NumPy")
    test = enet.shuffle_split_masks(n_rows, 20, 0.5, 0)
    train = np.vstack([~test, np.ones((1, n_rows), dtype=bool)])
    grams, _ = enet._fold_grams(X.astype(np.float64), y, train,
                                min_shard_rows=min_shard_rows)
    for f in range(train.shape[0]):
        xf = X64[train[f]]
        if not np.array_equal(grams[f].astype(np.int64), xf.T @ xf):
            raise AssertionError(f"fold Gram {f} differs from int64 NumPy")
    log(f"L2 kernels ({route}): colsum, colsum_unused, or_column and "
        f"{train.shape[0]} int8 fold Grams over {n_rows}x{s} equal NumPy")
    if min_shard_rows is not None:
        return
    # float32 branch: full float32 products, tolerance from float32
    # accumulation over 2^18 rows
    Xr = rng.random((n_rows, s))
    gr, _ = enet._fold_grams(Xr, y, train[:4])
    ref = np.stack([(Xr[t].T @ Xr[t]) for t in train[:4]])
    rel = float(np.abs(gr - ref).max() / np.abs(ref).max())
    log(f"L2 float32 fold Grams: max relative error {rel:.3e} vs float64 "
        f"(limit 1e-5)")
    if rel > 1e-5:
        raise AssertionError("float32 fold Grams outside 1e-5 of float64")
    colsum = prescan._jit_kernels()[0]
    hlo = colsum.lower(jnp.asarray(X), jnp.asarray(big)).compile().as_text()
    xb = jnp.zeros((2, 1 << 17, s), jnp.int8)
    tb = jnp.zeros((2, train.shape[0], 1 << 17), jnp.int8)
    ghlo = enet._gram_scan().lower(xb, tb).compile().as_text()
    log(f"L2 compiled ops: colsum [{_gpu_ops(hlo)}], "
        f"fold-Gram scan [{_gpu_ops(ghlo)}]")


# -------------------------------------------------------------- identify
def _load_scale():
    spec = importlib.util.spec_from_file_location(
        "strainscan_scale", os.path.join(ROOT, "benchmarks", "scale.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rows(path: str):
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    header = lines[0].split("\t")
    return [dict(zip(header, ln.split("\t"))) for ln in lines[1:]]


def compare_reports(a_path: str, b_path: str, rtol: float = 1e-9) -> bool:
    """True if byte-identical; raises unless every differing field is an
    Enet field within ``rtol``."""
    a, b = open(a_path).read(), open(b_path).read()
    if a == b:
        return True
    ra, rb = _rows(a_path), _rows(b_path)
    if len(ra) != len(rb):
        raise AssertionError(f"{a_path}: {len(ra)} rows vs {len(rb)}")
    for x, y in zip(ra, rb):
        if set(x) != set(y):
            raise AssertionError(f"{a_path}: columns differ")
        for fld, va in x.items():
            vb = y[fld]
            if va == vb:
                continue
            if fld not in ENET_FIELDS or not np.isclose(
                    float(va), float(vb), rtol=rtol, atol=0.0):
                raise AssertionError(
                    f"{a_path}: {fld} {va!r} vs CPU {vb!r}")
    return False


def _cpu_cli(args) -> None:
    """The same CLI call in a child pinned to the CPU backend."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "strainscan_tpu.cli", *args],
                       cwd=ROOT, env=env, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"CPU run of {args[0]} failed ({r.returncode}):\n"
                           f"{r.stderr[-3000:]}")


def identify_phase(families: int = FAMILIES, glen: int = FAMILY_GLEN,
                   seed: int = 5, threads: int = 8) -> None:
    from strainscan_tpu import cli
    from strainscan_tpu.io.fastx import read_fasta

    scale = _load_scale()
    rng = np.random.default_rng(seed)
    gdir = os.path.join(WORK, "genomes")
    os.makedirs(gdir, exist_ok=True)
    names, _ = scale.synth(gdir, families, 3, glen, rng)
    db = os.path.join(WORK, "DB")
    t0 = time.time()
    if cli.main(["build", "-i", gdir, "-o", db, "-t", str(threads)]) != 0:
        raise RuntimeError("cli build failed")
    log(f"identify: built a {len(names)}-strain DB of {families} families "
        f"(a cut from the E. coli DB's 823 clusters) in "
        f"{time.time() - t0:.1f}s")

    def seq(name):
        return next(read_fasta(os.path.join(gdir, name + ".fa")))[1]

    samples = {   # name -> [(strain, depth)]; odd families are singletons
        "intra": [("F000V0", 8.0), ("F000V2", 8.0)],
        "cross": [("F001V0", 6.0), ("F003V0", 6.0)],
        "single": [("F002V1", 6.0)],
    }
    fqs = {}
    for s, mix in samples.items():
        fqs[s] = os.path.join(WORK, f"{s}.fq")
        with open(fqs[s], "w") as out:
            n = 0
            for strain, depth in mix:
                n += scale.sim_reads(seq(strain), depth, 100, rng, out, n)

    def check(tag, gpu_dir, cpu_dir, expect):
        rep = os.path.join(gpu_dir, "final_report.txt")
        found = {r["Strain_Name"].split()[0] for r in _rows(rep)}
        if not set(expect) <= found:
            raise AssertionError(f"{tag}: report names {sorted(found)}, "
                                 f"expected {sorted(expect)}")
        same = compare_reports(rep, os.path.join(cpu_dir, "final_report.txt"))
        log(f"identify {tag}: names {sorted(found)}; equals the CPU run "
            f"({'bytes' if same else 'Enet fields at rtol 1e-9'})")

    for s in ("intra", "cross"):
        gpu, cpu = (os.path.join(WORK, f"{s}_{d}") for d in ("gpu", "cpu"))
        t0 = time.time()
        if cli.main(["identify", "-i", fqs[s], "-d", db, "-o", gpu]) != 0:
            raise RuntimeError(f"cli identify {s} failed")
        t_gpu = time.time() - t0
        _cpu_cli(["identify", "-i", fqs[s], "-d", db, "-o", cpu])
        log(f"identify {s}: {t_gpu:.2f}s on the card (first sample "
            f"includes compiles)")
        check(s, gpu, cpu, [n for n, _ in samples[s]])
    gpu, cpu = (os.path.join(WORK, f"batch_{d}") for d in ("gpu", "cpu"))
    batch = [fqs[s] for s in samples]
    t0 = time.time()
    if cli.main(["batch-identify", "-i", *batch, "-d", db, "-o", gpu]) != 0:
        raise RuntimeError("cli batch-identify failed")
    log(f"batch-identify: {len(batch)} samples in {time.time() - t0:.2f}s "
        f"on the card")
    _cpu_cli(["batch-identify", "-i", *batch, "-d", db, "-o", cpu])
    for s in samples:
        check(f"batch/{s}", os.path.join(gpu, s), os.path.join(cpu, s),
              [n for n, _ in samples[s]])


# ------------------------------------------------------------- four cards
def four_card_phase(genome_len: int = GENOME_LEN, n_deep: int = N_DEEP,
                    l2_rows: int = L2_ROWS, seed: int = 0) -> None:
    import jax

    from strainscan_tpu.config import IdentifyConfig
    from strainscan_tpu.identify import count as icount
    from strainscan_tpu.index.hashtable import KmerTable

    cfg = IdentifyConfig()
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=genome_len).astype(np.uint8)
    keys = table_keys(genome)
    if keys.size < cfg.shard_min_kmers:
        raise AssertionError("table below shard_min_kmers")
    codes, lens = synth_reads(rng, genome, n_deep, 0.02, 0.01)
    path = os.path.join(WORK, "deep.fq")
    write_fastq(path, codes, lens)
    want = host_counts(keys, codes)
    table = KmerTable.build(keys, k=K)
    for rep in ("first", "warm"):
        t0 = time.time()
        got = icount.count_sample(table, path, cfg, keys=keys)
        dt = time.time() - t0
        pipe = icount._SHARDED_CACHE[0][2] if icount._SHARDED_CACHE else None
        if pipe is None:
            raise AssertionError("sharded count pipeline not engaged")
        _check_counts(f"sharded count ({rep})", got, want)
        log(f"sharded count ({rep}): mesh {dict(pipe.mesh.shape)} over "
            f"{jax.device_count()} devices, {keys.size} keys, {n_deep} "
            f"reads, {int(want.sum())} hits equal the host oracle; "
            f"{dt:.2f}s")
    l2_phase(n_rows=max(l2_rows, cfg.shard_min_l2_rows),
             min_shard_rows=cfg.shard_min_l2_rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)
    if args.cards == 1:
        os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    log(f"card: {card_line()}")
    import jax

    devs = jax.devices()
    log(f"jax {jax.__version__}; devices {devs}")
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX found {devs[0].platform} devices only",
              file=sys.stderr)
        return 2
    if len(devs) < args.cards:
        print(f"--cards {args.cards} needs {args.cards} GPUs, found "
              f"{len(devs)}", file=sys.stderr)
        return 2
    from strainscan_tpu import native

    log(f"native host library: "
        f"{'built' if native.get_lib() is not None else 'unavailable'}")
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    t0 = time.time()
    try:
        if args.cards == 4:
            four_card_phase()
        else:
            count_phase()
            l2_phase()
            identify_phase()
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    log(f"all phases passed in {time.time() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
