"""Fused restricted k-mer counting: reads -> per-DB-k-mer hit counts.

This is the jellyfish-equivalent hot path (reference
library/identify.py:73-103 and library/Vote_Strain_L2_Lasso_new_sp.py:354-372
shell out to ``jellyfish count --if <kmers> <fastq>`` + ``dump``): a batch of
2-bit-encoded reads is k-merized on device, every window probes the DB hash
table, and hits scatter-add into a count vector aligned with the DB k-mer id
space.

The default (non-memory-efficient) DB stores *both* orientations of every
k-mer as separate entries — exactly like the reference's kmer.fa
(Build_tree.py:101-109 inserts forward and revcomp separately) — so queries
probe only the forward orientation of each read window and the statistics
match jellyfish's non-canonical counting bit-for-bit.  Memory-efficient DBs
store canonical (min(fwd, rc)) k-mers and queries canonicalize first.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from strainscan_tpu.index.hashtable import FpTable, KmerTable, lookup_device
from strainscan_tpu.kmer import device as kdev
from strainscan_tpu.ops.probe_prep import fp_probe


def _count_core(counts, codes, table, k, n_buckets, max_probe,
                n_kmers, canonical):
    hi, lo, valid = kdev.extract_kmers(codes, k)
    if canonical:
        hi, lo = kdev.canonical(hi, lo, k)
    ids = lookup_device(table, n_buckets, max_probe, hi, lo)
    ids = jnp.where(valid, ids, -1).reshape(-1)
    # scatter-add; misses land in a trash slot that is sliced away
    safe = jnp.where(ids >= 0, ids, n_kmers)
    ones = jnp.ones_like(safe, dtype=counts.dtype)
    padded = jnp.concatenate([counts, jnp.zeros((1,), counts.dtype)])
    padded = padded.at[safe].add(ones, mode="drop")
    return padded[:n_kmers]


def _count_core_fp(counts, codes, fp_table, k, n_buckets, bucket, seed,
                   canonical):
    """Fingerprint hot path: ONE narrow row gather per window, counts in
    slot space (counts has n_buckets*bucket+1 entries; last = trash).
    Probe prep runs as ops/probe_prep.py selects for the platform."""
    slots = fp_probe(codes, fp_table, k=k, n_buckets=n_buckets,
                     bucket=bucket, seed=seed,
                     canonical=canonical).reshape(-1)
    trash = n_buckets * bucket
    safe = jnp.where(slots >= 0, slots, trash)
    ones = jnp.ones_like(safe, dtype=counts.dtype)
    return counts.at[safe].add(ones, mode="promise_in_bounds")


@functools.partial(
    jax.jit,
    static_argnames=("k", "n_buckets", "max_probe", "n_kmers", "canonical"),
    donate_argnames=("counts",),
)
def count_batch(
    counts: jax.Array,
    codes: jax.Array,
    table: jax.Array,
    *,
    k: int,
    n_buckets: int,
    max_probe: int,
    n_kmers: int,
    canonical: bool,
) -> jax.Array:
    """Accumulate one read batch into ``counts`` (donated, int32 [n_kmers])."""
    return _count_core(counts, codes, table, k, n_buckets,
                       max_probe, n_kmers, canonical)


@functools.partial(
    jax.jit,
    static_argnames=("k", "n_buckets", "bucket", "seed", "canonical"),
    donate_argnames=("counts",),
)
def count_batch_fp(
    counts: jax.Array,
    codes: jax.Array,
    fp_table: jax.Array,
    *,
    k: int,
    n_buckets: int,
    bucket: int,
    seed: int,
    canonical: bool,
) -> jax.Array:
    """Accumulate one batch into slot-space ``counts`` (donated,
    int32 [n_buckets*bucket + 1])."""
    return _count_core_fp(counts, codes, fp_table, k, n_buckets, bucket,
                          seed, canonical)


@functools.partial(
    jax.jit,
    static_argnames=("length", "k", "n_buckets", "bucket", "seed",
                     "canonical"),
    donate_argnames=("counts",),
)
def count_batch_fp_packed(
    counts: jax.Array,
    words: jax.Array,
    vbytes: jax.Array,
    fp_table: jax.Array,
    *,
    length: int,
    k: int,
    n_buckets: int,
    bucket: int,
    seed: int,
    canonical: bool,
) -> jax.Array:
    codes = kdev.unpack_codes(words, vbytes, length)
    return _count_core_fp(counts, codes, fp_table, k, n_buckets, bucket,
                          seed, canonical)


@functools.partial(
    jax.jit,
    static_argnames=("length", "k", "n_buckets", "bucket", "seed",
                     "canonical"),
    donate_argnames=("counts",),
)
def count_batch_fp_packed_vlen(
    counts: jax.Array,
    words: jax.Array,
    vlen: jax.Array,
    fp_table: jax.Array,
    *,
    length: int,
    k: int,
    n_buckets: int,
    bucket: int,
    seed: int,
    canonical: bool,
) -> jax.Array:
    """Prefix-run validity variant: ships 2 bytes/row of validity instead
    of ceil(L/8) (pack.valid_prefix_lens), ~27% fewer h2d bytes for
    150 bp reads."""
    codes = kdev.unpack_codes_vlen(words, vlen, length)
    return _count_core_fp(counts, codes, fp_table, k, n_buckets, bucket,
                          seed, canonical)


@functools.partial(
    jax.jit,
    static_argnames=("length", "k", "n_buckets", "max_probe", "n_kmers",
                     "canonical"),
    donate_argnames=("counts",),
)
def count_batch_packed(
    counts: jax.Array,
    words: jax.Array,
    vbytes: jax.Array,
    table: jax.Array,
    *,
    length: int,
    k: int,
    n_buckets: int,
    max_probe: int,
    n_kmers: int,
    canonical: bool,
) -> jax.Array:
    """Packed-transfer variant: reads arrive as 2-bit words + validity
    bits (pack.bitpack_codes) and are unpacked on device."""
    codes = kdev.unpack_codes(words, vbytes, length)
    return _count_core(counts, codes, table, k, n_buckets,
                       max_probe, n_kmers, canonical)


@jax.jit
def _remap_device(slot_counts: jax.Array, slot_of_id: jax.Array) -> jax.Array:
    """Slot-space counts -> id-space counts via one device gather."""
    return slot_counts.at[slot_of_id].get(mode="promise_in_bounds")


@jax.jit
def _count_stats(counts: jax.Array) -> jax.Array:
    """[max, nonzero] of a count vector — 8 bytes d2h to pick the
    cheapest fetch encoding for the full vector."""
    return jnp.stack([jnp.max(counts),
                      jnp.count_nonzero(counts).astype(jnp.int32)])


@functools.partial(jax.jit, static_argnames=("size",))
def _sparse_fetch(counts: jax.Array, size: int):
    """(indices int32 [size], values int32 [size]) of the nonzero counts,
    zero-padded.  ``size`` is FIXED per table geometry (see
    :func:`_sparse_cap`) so this program — a sized nonzero over tens of
    millions of entries — compiles exactly once per table, not once per
    sample-dependent nnz bucket."""
    (idx,) = jnp.nonzero(counts, size=size, fill_value=0)
    n = jnp.count_nonzero(counts)
    vals = jnp.where(jnp.arange(size) < n,
                     counts.at[idx].get(mode="promise_in_bounds"), 0)
    return idx.astype(jnp.int32), vals


def _sparse_cap(n_keys: int) -> int:
    """Static sparse-fetch capacity for a table: n_keys/8 rounded up to a
    power of two; nnz above the cap falls back to the dense fetch.  The
    value (like ``_SLICE_GRAN``) is not yet measured on the H100."""
    return 1 << max(10, (max(n_keys // 8, 1) - 1).bit_length())


_SLICE_GRAN = 1 << 16  # d2h prefix rounding: few distinct slice shapes


def fetch_counts(dev_counts, n_keys: int) -> np.ndarray:
    """Device counts -> host int32 array with the cheapest d2h encoding.

    A 28.6M-key (E. coli-scale) id-space fetch is 114 MB as int32.
    Device-side stats (8 B) pick:

    * sparse (nonzero idx + values) when few keys were touched — the
      identify case: a 12k-read sample hits ~1.5M of 28.6M keys;
    * uint16 values when max count < 65536 (always true in practice;
      the reference's jellyfish pipeline parses full ints, so fall back
      to int32 above that for bit-exactness);
    * dense int32 otherwise.

    Bit-exact with ``np.asarray(device_get(dev_counts))`` in all cases.
    """
    if n_keys == 0:  # degenerate empty table: jnp.max([]) would raise
        return np.zeros(0, dtype=np.int32)
    maxc, nnz = (int(x) for x in jax.device_get(_count_stats(dev_counts)))
    vdtype = (jnp.uint8 if maxc < (1 << 8)
              else jnp.uint16 if maxc < (1 << 16) else None)
    vbytes = 1 if maxc < (1 << 8) else 2 if maxc < (1 << 16) else 4
    dense_bytes = n_keys * vbytes
    sparse_bytes = nnz * (4 + vbytes)
    if sparse_bytes < dense_bytes // 2 and nnz > 0:
        size = _sparse_cap(n_keys)
        if nnz <= size and size < n_keys:
            idx, vals = _sparse_fetch(dev_counts, size)
            if vdtype is not None:
                vals = vals.astype(vdtype)
            # d2h only the used prefix (rounded so the trivial slice
            # programs stay few); the padded tail is zeros
            m = min(size, -(-nnz // _SLICE_GRAN) * _SLICE_GRAN)
            idx, vals = jax.device_get((idx[:m], vals[:m]))
            out = np.zeros(n_keys, dtype=np.int32)
            out[idx[:nnz]] = vals[:nnz].astype(np.int32)
            return out
    if vdtype is not None:
        return np.asarray(
            jax.device_get(dev_counts.astype(vdtype))).astype(np.int32)
    return np.asarray(jax.device_get(dev_counts))


class CountPipeline:
    """Streaming counter over read batches against one DB k-mer table.

    ``probe_mode="fp"`` (default) probes a single-gather fingerprint table
    derived from ``table`` (see :class:`FpTable`) and counts in slot
    space; ``"exact"`` keeps the full-key interleaved probe.
    ``packed_transfer`` (default on) ships reads as 2-bit words + validity
    bits — ~2.6x fewer host->device bytes.
    """

    def __init__(self, table: KmerTable, canonical: bool = False,
                 packed_transfer: bool = True, probe_mode: str = "fp"):
        self.table = table
        self.canonical = canonical
        self.packed_transfer = packed_transfer
        self.probe_mode = probe_mode
        if probe_mode == "fp":
            fpt = getattr(table, "_fp_cache", None)
            if fpt is None:
                fpt = FpTable.from_kmer_table(table)
                object.__setattr__(table, "_fp_cache", fpt)
            self.fpt = fpt
            self.dev_table = fpt.device_arrays()
            self.counts = jnp.zeros((fpt.n_slots + 1,), dtype=jnp.int32)
        else:
            self.fpt = None
            self.dev_table = table.device_arrays()
            self.counts = jnp.zeros((table.n_keys,), dtype=jnp.int32)
        self._shape: Optional[tuple] = None

    def prepare_batch(self, codes: np.ndarray):
        """Host-side half of add_batch: shape pinning, padding, packing.

        Returns a list of dispatch payloads for :meth:`add_prepared`.
        Safe to run in a producer thread (only the producer may call it —
        it owns the batch-shape state), so parse+pack overlap with device
        compute (utils/prefetch.py)."""
        out = []
        codes = np.asarray(codes)
        if self._shape is None:
            self._shape = codes.shape
        rows, cols = self._shape
        if codes.shape[1] != cols:
            raise ValueError(f"batch maxlen changed: {codes.shape[1]} != {cols}")
        if codes.shape[0] > rows:
            for i in range(0, codes.shape[0], rows):
                out.extend(self.prepare_batch(codes[i : i + rows]))
            return out
        if codes.shape[0] < rows:
            pad = np.full((rows - codes.shape[0], cols), 4, dtype=np.uint8)
            codes = np.concatenate([codes, pad], axis=0)
        if self.packed_transfer:
            from strainscan_tpu.kmer import pack

            if self.fpt is not None:
                fused = pack.bitpack_codes_vlen(codes)
                if fused is None:  # no native lib, or a mid-read N
                    vlen = pack.valid_prefix_lens(codes)
                    fused = (pack.bitpack_codes(
                        codes, need_vbytes=False)[0], vlen) \
                        if vlen is not None else None
                if fused is not None:
                    out.append(("vlen", fused[0], fused[1]))
                    return out
            words, vbytes = pack.bitpack_codes(codes)
            out.append(("vbytes", words, vbytes))
        else:
            out.append(("codes", codes, None))
        return out

    def add_prepared(self, payloads) -> None:
        """Dispatch payloads from :meth:`prepare_batch` (main thread)."""
        rows, cols = self._shape
        for form, a, b in payloads:
            if form == "vlen":
                self.counts = count_batch_fp_packed_vlen(
                    self.counts, jnp.asarray(a), jnp.asarray(b),
                    self.dev_table, length=cols, k=self.table.k,
                    n_buckets=self.fpt.n_buckets, bucket=self.fpt.bucket,
                    seed=self.fpt.seed, canonical=self.canonical)
            elif form == "vbytes" and self.fpt is not None:
                self.counts = count_batch_fp_packed(
                    self.counts, jnp.asarray(a), jnp.asarray(b),
                    self.dev_table, length=cols, k=self.table.k,
                    n_buckets=self.fpt.n_buckets, bucket=self.fpt.bucket,
                    seed=self.fpt.seed, canonical=self.canonical)
            elif form == "vbytes":
                self.counts = count_batch_packed(
                    self.counts, jnp.asarray(a), jnp.asarray(b),
                    self.dev_table, length=cols, k=self.table.k,
                    n_buckets=self.table.n_buckets,
                    max_probe=self.table.max_probe,
                    n_kmers=self.table.n_keys, canonical=self.canonical)
            elif self.fpt is not None:
                self.counts = count_batch_fp(
                    self.counts, jnp.asarray(a), self.dev_table,
                    k=self.table.k, n_buckets=self.fpt.n_buckets,
                    bucket=self.fpt.bucket, seed=self.fpt.seed,
                    canonical=self.canonical)
            else:
                self.counts = count_batch(
                    self.counts, jnp.asarray(a), self.dev_table,
                    k=self.table.k, n_buckets=self.table.n_buckets,
                    max_probe=self.table.max_probe,
                    n_kmers=self.table.n_keys, canonical=self.canonical)

    def add_batch(self, codes: np.ndarray) -> None:
        """codes: uint8 [B, L] encoded reads (0..3 bases, >=4 pad/N).

        Batches are padded (rows of invalid code 4 contribute nothing) to
        the first-seen shape so the whole stream compiles exactly once
        instead of once more for the partial final batch.
        """
        self.add_prepared(self.prepare_batch(codes))

    def reset(self) -> None:
        """Zero the accumulator without re-uploading the table."""
        import jax.numpy as jnp

        n = self.fpt.n_slots + 1 if self.fpt is not None else self.table.n_keys
        self.counts = jnp.zeros((n,), dtype=jnp.int32)

    def finish(self) -> np.ndarray:
        """int32 [n_keys] hit counts aligned with the table's id space.

        Sparse samples (the identify case: ~5% of keys touched) fetch in
        SLOT space and remap on the host through the fp table's resident
        ``val`` array — no ``slot_of_id`` upload at all (114 MB h2d at
        E. coli scale).  Dense samples fall back to the device-side
        slot->id remap (one gather over slot_of_id, cached on the
        FpTable) so only ``n_keys`` values cross the d2h link.
        Both routes produce identical vectors: empty-slot strays are
        dropped by the val>=0 mask exactly as the soi remap drops them.
        """
        if self.fpt is not None:
            n_keys = self.table.n_keys
            n_slots = self.fpt.n_slots
            occ = self.counts[:n_slots]   # drop the miss/trash slot
            maxc, nnz = (int(x) for x in jax.device_get(_count_stats(occ))) \
                if n_slots else (0, 0)
            vb = 1 if maxc < (1 << 8) else 2 if maxc < (1 << 16) else 4
            cap = _sparse_cap(n_slots)
            if (nnz > 0 and nnz <= cap
                    and nnz * (4 + vb) < (n_keys * vb) // 2):
                idx, vals = _sparse_fetch(occ, cap)
                if vb == 1:
                    vals = vals.astype(jnp.uint8)
                elif vb == 2:
                    vals = vals.astype(jnp.uint16)
                m = min(cap, -(-nnz // _SLICE_GRAN) * _SLICE_GRAN)
                idx, vals = jax.device_get((idx[:m], vals[:m]))
                ids = self.fpt.val[idx[:nnz]]
                keep = ids >= 0          # empty-slot strays drop here
                out = np.zeros(n_keys, dtype=np.int32)
                out[ids[keep]] = vals[:nnz][keep].astype(np.int32)
                return out
            # cached on the FpTable, not the pipeline: a fresh pipeline is
            # built per sample, and re-uploading slot_of_id is a 114 MB h2d
            # at E. coli scale
            soi = getattr(self.fpt, "_soi_dev", None)
            if soi is None:
                soi = jnp.asarray(self.fpt.slot_of_id())
                object.__setattr__(self.fpt, "_soi_dev", soi)
            id_counts = _remap_device(self.counts, soi)
            return fetch_counts(id_counts, self.table.n_keys)
        return fetch_counts(self.counts, self.table.n_keys)
