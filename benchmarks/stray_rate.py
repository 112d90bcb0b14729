"""Measured FpTable stray-hit rate on a >=10^8-window stream.

Round-4 VERDICT item 5(b): the fingerprint probe's default hot path can
credit a miss to a real key when the miss's 32-bit fingerprint collides
inside its probed bucket.  Analytic rate per absent window:

    P(stray) = E[occupied slots in home bucket] * 2^-32
             = (n_keys / n_buckets) * 2^-32

at the E. coli geometry (28.6M keys, 2^20 buckets x 64, load 0.5):
27.3 * 2.33e-10 = 6.35e-9/window -> ~0.64 expected strays per 10^8
absent windows.  Real samples are far below this bound: windows that ARE
in the table cannot stray, so only the miss fraction of a stream is
exposed.

This script probes ABSENT (rejection-sampled) keys in device batches
against the real table and counts hits that land on occupied slots.
Usage: python benchmarks/stray_rate.py [--windows 200000000]
Writes JSON to stdout; saved as benchmarks/STRAY_RATE_r05.json.
"""

import argparse
import json
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", type=int, default=200_000_000)
    ap.add_argument("--n-keys", type=int, default=28_600_000)
    ap.add_argument("--batch", type=int, default=8_000_000)
    args = ap.parse_args()
    import jax
    import jax.numpy as jnp

    from strainscan_tpu.index.hashtable import FpTable, lookup_fp_device

    rng = np.random.default_rng(0)
    keys = np.unique(rng.integers(0, 1 << 62, size=args.n_keys,
                                  dtype=np.uint64))
    print(f"[stray] building fp table over {keys.size} keys",
          file=sys.stderr, flush=True)
    t = FpTable.build(keys, k=31)
    fp_dev = jnp.asarray(t.fp.reshape(t.n_buckets, t.bucket))
    val_dev = jnp.asarray(t.val)

    @jax.jit
    def stray_count(fp_dev, val_dev, hi, lo):
        # tables as ARGUMENTS: a closed-over device array would embed
        # as a 256 MB HLO constant
        slots = lookup_fp_device(fp_dev, t.n_buckets, t.bucket, t.seed,
                                 hi, lo)
        hit = slots >= 0
        occ = val_dev.at[jnp.where(hit, slots, 0)].get(
            mode="promise_in_bounds") >= 0
        return jnp.sum(jnp.logical_and(hit, occ).astype(jnp.int64))

    total = 0
    strays = 0
    t0 = time.time()
    while total < args.windows:
        n = min(args.batch, args.windows - total)
        q = rng.integers(0, 1 << 62, size=n, dtype=np.uint64)
        # rejection-sample: drop queries that ARE table keys (windows in
        # the table cannot stray by definition)
        present = np.isin(q, keys, assume_unique=False)
        q = q[~present]
        hi = (q >> np.uint64(32)).astype(np.uint32)
        lo = (q & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        strays += int(stray_count(fp_dev, val_dev, jnp.asarray(hi),
                                  jnp.asarray(lo)))
        total += q.size
        print(f"[stray] {total/1e6:.0f}M windows, {strays} strays",
              file=sys.stderr, flush=True)
    dt = time.time() - t0
    expected = total * (t.n_keys / t.n_buckets) * 2.0 ** -32
    out = {
        "n_keys": int(t.n_keys),
        "n_buckets": int(t.n_buckets),
        "bucket": int(t.bucket),
        "windows": int(total),
        "strays_measured": int(strays),
        "strays_expected": round(expected, 3),
        "rate_per_window_bound": (t.n_keys / t.n_buckets) * 2.0 ** -32,
        "windows_per_s": round(total / dt, 1),
        "note": ("absent-window probes only; in-table windows cannot "
                 "stray, so a real sample's exposure is its miss "
                 "fraction times this rate"),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
