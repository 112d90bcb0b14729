"""Probe prep — window extraction + bucket/fingerprint hashing — and the
fingerprint lookup against host oracles built from the NumPy packer.

Both implementations are held to the oracles: the plain jnp chain (what
every platform but CUDA compiles) and the Pallas-Triton kernel (the CUDA
path), the latter in the Pallas interpreter."""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from strainscan_tpu.index.hashtable import (FpTable, fp2_np,  # noqa: E402
                                            lookup_fp_rows, mix_seeded_np)
from strainscan_tpu.kmer import pack  # noqa: E402
from strainscan_tpu.ops import probe_prep as pp  # noqa: E402

IMPLS = {
    "jnp": pp.probe_prep_jnp,
    "triton_interpret": functools.partial(pp.probe_prep_triton,
                                          interpret=True),
}


def _random_codes(rng, b, length, n_frac=0.05):
    codes = rng.integers(0, 4, size=(b, length)).astype(np.uint8)
    mask = rng.random((b, length)) < n_frac
    codes[mask] = 4
    return codes


def _probe_prep(impl, codes, k, n_buckets, seed, canonical=False):
    """(bucket or -1, fingerprint) per window from one implementation."""
    b, fp = IMPLS[impl](jnp.asarray(codes), k=k, n_buckets=n_buckets,
                        seed=seed, canonical=canonical)
    return np.asarray(b), np.asarray(fp)


def _host_windows(codes, k, canonical=False):
    """uint64 keys [B, M] and validity from the host packer, row by row."""
    keys, valid = zip(*(pack.pack_kmers(row, k) for row in codes))
    keys, valid = np.stack(keys), np.stack(valid)
    if canonical:
        keys = pack.canonical_packed(keys.reshape(-1), k).reshape(keys.shape)
    return keys, valid


def _host_hash(keys, seed, n_buckets):
    hi, lo = pack.split_u64(keys)
    b = (mix_seeded_np(hi, lo, seed).astype(np.int64)
         & (n_buckets - 1)).astype(np.int32)
    return b, fp2_np(hi, lo)


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("k", [31, 21, 15])
def test_probe_prep_matches_extract_and_hash(k, impl):
    rng = np.random.default_rng(0)
    b, length = 16, 64
    codes = _random_codes(rng, b, length)
    n_buckets, seed = 1 << 12, 3

    bucket, fp = _probe_prep(impl, codes, k, n_buckets, seed)
    keys, valid = _host_windows(codes, k)
    exp_bucket, exp_fp = _host_hash(keys, seed, n_buckets)

    assert bucket.shape == (b, length - k + 1)
    np.testing.assert_array_equal(bucket[valid], exp_bucket[valid])
    np.testing.assert_array_equal(fp[valid], exp_fp[valid])
    assert (bucket[~valid] == -1).all()


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("k", [31, 16])
def test_probe_prep_canonical_matches_device_canonicalize(k, impl):
    rng = np.random.default_rng(2)
    b, length = 16, 64
    codes = _random_codes(rng, b, length)
    n_buckets, seed = 1 << 10, 0

    bucket, fp = _probe_prep(impl, codes, k, n_buckets, seed,
                             canonical=True)
    keys, valid = _host_windows(codes, k, canonical=True)
    exp_bucket, exp_fp = _host_hash(keys, seed, n_buckets)

    np.testing.assert_array_equal(bucket[valid], exp_bucket[valid])
    np.testing.assert_array_equal(fp[valid], exp_fp[valid])
    assert (bucket[~valid] == -1).all()


@pytest.mark.parametrize("impl", list(IMPLS))
def test_probe_prep_plus_lookup_matches_host_oracle(impl):
    k = 31
    rng = np.random.default_rng(1)
    genome = rng.integers(0, 4, size=4000).astype(np.uint8)
    km, _ = pack.pack_kmers(genome, k)
    db = np.unique(km)
    table = FpTable.build(db, k=k)

    codes = np.full((8, 80), 4, np.uint8)
    for i in range(8):
        st = int(rng.integers(0, genome.size - 72))
        codes[i, :72] = genome[st:st + 72]
    codes[3, 40] = 4                       # an N inside a read
    codes[5, 10:30] = rng.integers(0, 4, size=20)   # windows absent from db

    b, fp = _probe_prep(impl, codes, k, table.n_buckets, table.seed)
    slots = np.asarray(lookup_fp_rows(table.device_arrays(), jnp.asarray(b),
                                      jnp.asarray(fp), table.bucket))

    # sorted-key oracle: the id of each valid window's key, -1 if absent
    keys, hvalid = _host_windows(codes, k)
    idx = np.minimum(np.searchsorted(db, keys), db.size - 1)
    exp_ids = np.where(hvalid & (db[idx] == keys), idx, -1)
    got_ids = np.where(slots >= 0, table.val[np.maximum(slots, 0)], -1)
    np.testing.assert_array_equal(got_ids, exp_ids)
    # and the table's own host lookup agrees slot for slot
    exp = table.lookup_host(keys.reshape(-1)).reshape(keys.shape)
    exp[~hvalid] = -1
    np.testing.assert_array_equal(slots, exp)


def test_probe_prep_triton_pads_rows_to_the_program_tile():
    codes = _random_codes(np.random.default_rng(4), 13, 80)  # 13 % 8 != 0
    got = _probe_prep("triton_interpret", codes, 31, 1 << 8, 5)
    want = _probe_prep("jnp", codes, 31, 1 << 8, 5)
    assert got[0].shape == got[1].shape == (13, 50)
    np.testing.assert_array_equal(got[0], want[0])
    ok = want[0] >= 0
    np.testing.assert_array_equal(got[1][ok], want[1][ok])


def test_probe_prep_rejects_reads_shorter_than_k():
    with pytest.raises(ValueError):
        pp.probe_prep_triton(jnp.zeros((8, 20), jnp.uint32), k=31,
                             n_buckets=16, seed=0)


@pytest.mark.parametrize("platform,kernel", [("cuda", True),
                                             ("cpu", False)])
def test_probe_prep_selects_kernel_by_platform(platform, kernel):
    f = jax.jit(functools.partial(pp.probe_prep, k=31, n_buckets=1 << 10,
                                  seed=1))
    codes = jax.ShapeDtypeStruct((64, 256), jnp.uint32)
    text = f.trace(codes).lower(lowering_platforms=(platform,)).as_text()
    assert ("triton" in text.lower()) == kernel


def test_probe_prep_triton_under_shard_map():
    """The kernel's outputs carry the input's mesh variance, so the
    sharded count pipeline's shard_map traces it with vma checking on
    (lowered for CUDA here: the Pallas interpreter does not track vma)."""
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "index"))
    spec = P(("data", "index"), None)
    fn = jax.jit(jax.shard_map(
        functools.partial(pp.probe_prep, k=31, n_buckets=1 << 8, seed=2),
        mesh=mesh, in_specs=spec, out_specs=(spec, spec)))
    codes = jax.ShapeDtypeStruct((64, 256), jnp.uint32)
    text = fn.trace(codes).lower(lowering_platforms=("cuda",)).as_text()
    assert "triton" in text.lower()
