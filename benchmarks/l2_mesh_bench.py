"""Timed entry for the mesh-routed L2 moments at the .scale fixture
(round-4 VERDICT item 2 acceptance).

Loads the LARGEST L2 cluster matrix from the .scale DB (E. coli-scale
fixture) and times the Pre-Scan column sums and Enet fold Grams through
(a) the single-device kernels and (b) the mesh-sharded route
(parallel/sharded.sharded_colsum_unused_fn / sharded_fold_grams_fn) on
the 8-virtual-device CPU mesh, asserting bit-identical results.  A CPU
mesh measures ROUTE overhead, not speedup — the virtual devices share
one socket; on several GPUs the same code divides the k-mer axis over
them.

Usage: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
       JAX_PLATFORMS=cpu python benchmarks/l2_mesh_bench.py
"""

import glob
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def main():
    import scipy.sparse  # noqa: F401

    from strainscan_tpu.build.db import load_l2_db, load_manifest
    from strainscan_tpu.identify import prescan

    db = os.path.join(REPO, ".scale", "DB")
    best, best_rows = None, -1
    for d in glob.glob(os.path.join(db, "l2", "C*")):
        cid = int(os.path.basename(d)[1:])
        cl = load_l2_db(db, cid)
        if cl is not None and cl.matrix.shape[0] > best_rows:
            best, best_rows = cl, cl.matrix.shape[0]
    assert best is not None, "run benchmarks/scale_fixture.py first"
    X = np.asarray(best.matrix.todense(), dtype=np.int8)
    n, s = X.shape
    rng = np.random.default_rng(0)
    y = rng.integers(0, 20, size=n).astype(np.float64)
    big = y > 1
    rounds = 15

    def drive(kern):
        used = kern.to_mask(X[:, 0] > 0)
        bigm = kern.to_mask(big)
        t0 = time.time()
        out = []
        for r in range(rounds):
            checks = kern.colsum_unused(used, bigm)
            used = kern.or_column(used, int(np.argmax(checks)) % s)
            out.append(checks)
        dt = time.time() - t0
        return np.stack(out), dt

    single = prescan._L2Kernels(X)               # single-device
    drive(single)                                # warm compile
    res_s, t_s = drive(single)
    mesh = prescan._L2Kernels(X, min_shard_rows=1)
    assert mesh.mesh is not None, "mesh route did not engage"
    drive(mesh)
    res_m, t_m = drive(mesh)
    assert np.array_equal(res_s, res_m), "mesh colsum not bit-identical"

    from strainscan_tpu.ops import enet

    tm = enet.shuffle_split_masks(n, 20, 0.5, 0)
    g_s, mom_s = enet._fold_grams(X.astype(np.float64), y, ~tm)
    t0 = time.time()
    g_s, mom_s = enet._fold_grams(X.astype(np.float64), y, ~tm)
    t_gs = time.time() - t0
    g_m, mom_m = enet._fold_grams(X.astype(np.float64), y, ~tm,
                                  min_shard_rows=1)
    t0 = time.time()
    g_m, mom_m = enet._fold_grams(X.astype(np.float64), y, ~tm,
                                  min_shard_rows=1)
    t_gm = time.time() - t0
    assert np.array_equal(g_s, g_m), "mesh fold Grams not bit-identical"

    out = {
        "fixture": ".scale largest L2 cluster",
        "rows": int(n), "strains": int(s),
        "prescan_15_rounds_s": {"single": round(t_s, 3),
                                "mesh8cpu": round(t_m, 3)},
        "fold_grams_s": {"single": round(t_gs, 3),
                         "mesh8cpu": round(t_gm, 3)},
        "bit_identical": True,
        "note": ("8 virtual CPU devices share one socket: this times the "
                 "mesh ROUTE (dispatch + psum) for correctness-shaped "
                 "overhead, not speedup; on several GPUs the k-mer axis "
                 "divides over them"),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
