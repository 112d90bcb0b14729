"""CPU-mesh scaling curve for the sharded count pipeline
(round-3 VERDICT missing #1: "an 8-virtual-device CPU-mesh scaling curve
[is] runnable today and absent").

Runs ShardedCountPipeline over meshes of 1/2/4/8 virtual CPU devices
(data axis scaling; index=2 where the device count allows) on one fixed
read stream and reports reads/s per mesh, asserting bit-exact counts vs
the single-device CountPipeline every time.  CPU wall-times are NOT device
predictions — the point is the shape (does adding data-parallel workers
scale the stream?) and the correctness of every mesh geometry.

A final 8-device run at the FULL 28.6M-key scale closes round-3 weak #5
(multi-device correctness had only toy fixtures): shard geometry at
2^19-bucket shards, value_map padding, psum payloads of 33.5M slots —
all asserted bit-exact against the single-device pipeline.

Usage: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
       python benchmarks/mesh_scaling.py
Writes benchmarks/MESH_SCALING_r05.json.
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402,F401

from strainscan_tpu.index.hashtable import KmerTable  # noqa: E402
from strainscan_tpu.kmer import pack  # noqa: E402
from strainscan_tpu.ops.count import CountPipeline  # noqa: E402
from strainscan_tpu.parallel.sharded import (ShardedCountPipeline,  # noqa: E402
                                             make_mesh)

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "MESH_SCALING_r05.json")
K = 31
READ_LEN = 150


def log(m):
    print(f"[mesh_scaling] {m}", file=sys.stderr, flush=True)


def synth(genome_len, n_reads, seed=0):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, size=genome_len).astype(np.uint8)
    km, _ = pack.pack_kmers(g, K)
    db = np.unique(np.concatenate([km, pack.revcomp_packed(km, K)]))
    starts = rng.integers(0, genome_len - READ_LEN, size=n_reads)
    codes = g[starts[:, None] + np.arange(READ_LEN)[None, :]]
    flips = rng.random(n_reads) < 0.5
    codes[flips] = (3 - codes[flips])[:, ::-1]
    return db, codes


def drive(pipe, codes, batch=16384):
    t0 = time.time()
    for i in range(0, codes.shape[0], batch):
        pipe.add_batch(codes[i:i + batch])
    counts = pipe.finish()
    return codes.shape[0] / (time.time() - t0), np.asarray(counts, np.int64)


def main():
    assert jax.device_count() >= 8, "need the 8-virtual-device CPU mesh"
    res = {"backend": "cpu-virtual", "devices": jax.device_count(),
           "curve": [], "note": ("CPU wall times, 2 physical cores under "
                                 "8 virtual devices — shape and "
                                 "correctness evidence, not device rates")}

    log("tier A: 2M-key curve")
    db, codes = synth(1_000_000, 100_000)
    table = KmerTable.build(db, k=K)
    single = CountPipeline(table)
    s_rps, want = drive(single, codes)
    single.reset()
    s_rps, want = drive(single, codes)  # warm
    res["tierA"] = {"n_keys": int(db.size), "reads": codes.shape[0],
                    "single_rps": round(s_rps, 1)}
    for n_dev in (1, 2, 4, 8):
        mesh = make_mesh(n_dev)
        pipe = ShardedCountPipeline(db, k=K, mesh=mesh)
        drive(pipe, codes)              # warm/compile
        pipe.reset()
        rps, got = drive(pipe, codes)
        ok = bool(np.array_equal(got, want))
        res["curve"].append({
            "devices": n_dev, "mesh": f"{mesh.shape['data']}x"
            f"{mesh.shape['index']}", "reads_s": round(rps, 1),
            "vs_single": round(rps / s_rps, 2), "bit_exact": ok})
        log(f"  {n_dev} dev ({mesh.shape['data']}x{mesh.shape['index']}): "
            f"{rps:.0f} r/s ({rps/s_rps:.2f}x single, exact={ok})")
        assert ok

    log("tier B: 28.6M-key 8-device bit-exactness (weak #5)")
    db, codes = synth(14_300_000, 60_000, seed=1)
    table = KmerTable.build(db, k=K)
    single = CountPipeline(table)
    t0 = time.time()
    _, want = drive(single, codes)
    log(f"  single pass {time.time()-t0:.0f}s")
    mesh = make_mesh(8)
    pipe = ShardedCountPipeline(db, k=K, mesh=mesh)
    t0 = time.time()
    _, got = drive(pipe, codes)
    ok = bool(np.array_equal(got, want))
    res["tierB_28p6M"] = {
        "n_keys": int(db.size), "reads": codes.shape[0],
        "mesh": f"{mesh.shape['data']}x{mesh.shape['index']}",
        "sharded_pass_s": round(time.time() - t0, 1), "bit_exact": ok,
        "n_hit_keys": int((want > 0).sum())}
    log(f"  8-dev exact={ok} ({time.time()-t0:.0f}s)")
    assert ok

    with open(OUT, "w") as f:
        json.dump(res, f, indent=1)
    log(f"wrote {OUT}")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
