"""Follow-up to probe_bench.py: bucket-width sweep for the fused probe.

probe_bench.py showed XLA's row gather is ~2x faster per row at 256B
rows than at the current 64B rows (88M vs 44M rows/s on a 512MB table),
while scatter is flat ~94M upd/s.  Here: the actual
gather+compare+scatter kernel at E. coli-scale table geometry with
bucket in {16, 32, 64, 128} (row widths 64B..512B) and load factors
{0.25, 0.5}, to pick the production FpTable geometry.

Writes benchmarks/PROBE_STUDY2.json.
"""

from __future__ import annotations

import functools
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax
import jax.numpy as jnp

Q = 8 * 1024 * 1024
ITERS = 6
N_KEYS = 28_600_000        # E. coli-scale key count


@functools.partial(jax.jit, static_argnames=("bucket",),
                   donate_argnames=("counts",))
def _fused(counts, tab, idx, fp, bucket):
    rows = tab.at[idx].get(mode="promise_in_bounds")
    hit = rows == fp[:, None]
    lane = jnp.argmax(hit, axis=1).astype(jnp.int32)
    found = jnp.any(hit, axis=1)
    slot = jnp.where(found, idx * bucket + lane, counts.shape[0] - 1)
    return counts.at[slot].add(jnp.int32(1), mode="promise_in_bounds")


def bench(bucket, load, rng):
    n_buckets = 1
    while n_buckets * bucket * load < N_KEYS:
        n_buckets *= 2
    tab = jnp.asarray(
        rng.integers(0, 2**31, size=(n_buckets, bucket)).astype(np.int32))
    idx = jnp.asarray(rng.integers(0, n_buckets, size=Q).astype(np.int32))
    fp = jnp.asarray(rng.integers(0, 2**31, size=Q).astype(np.int32))
    counts = jnp.zeros((n_buckets * bucket + 1,), jnp.int32)
    counts = _fused(counts, tab, idx, fp, bucket)
    jax.block_until_ready(counts)
    t0 = time.time()
    for _ in range(ITERS):
        counts = _fused(counts, tab, idx, fp, bucket)
    jax.block_until_ready(counts)
    dt = (time.time() - t0) / ITERS
    mb = n_buckets * bucket * 4 // (1024 * 1024)
    return Q / dt / 1e6, mb


def main():
    rng = np.random.default_rng(0)
    res = {"device": str(jax.devices()[0]), "n_keys": N_KEYS}
    out = {}
    for bucket in (16, 32, 64, 128):
        for load in (0.25, 0.5):
            r, mb = bench(bucket, load, rng)
            key = f"b{bucket}_load{load}"
            out[key] = {"Mwin_s": round(r, 1), "table_MB": mb}
            print(f"fused {key}: {r:.1f}M win/s ({mb} MB table)",
                  file=sys.stderr, flush=True)
    res["fused"] = out
    with open(os.path.join(REPO, "benchmarks", "PROBE_STUDY2.json"),
              "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
