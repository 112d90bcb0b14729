"""Multi-device scale-out: sharded k-mer index + data-parallel read streams.

The reference is strictly single-node (SURVEY §2.3).  Here the hash table
is sharded across devices along an ``index`` mesh axis (the capacity
axis), read batches stream data-parallel along a ``data`` axis, and
per-k-mer hit counts are merged with ``psum`` over the device
interconnect.  Downstream L2 statistics (X^T y moments, Gram matrices for
the Elastic-Net) reduce over the sharded k-mer axis the same way, so only
O(strains) values ever cross devices.

Layout
------
* global k-mer array (sorted) is split into ``n_shards`` contiguous
  chunks; each chunk gets its own bucketed hash table, padded to the max
  shard table size so the stack is one rectangular array per field;
* ``codes`` [B, L] is sharded along ``data`` and replicated along
  ``index``; each (data, index) program probes its read block against its
  table shard;
* local counts [shard_capacity] are psum-reduced over ``data`` and stay
  sharded over ``index`` — exactly the layout the L2 matvecs want.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from strainscan_tpu.index.hashtable import (BUCKET, KmerTable,
                                            build_fp_shards, lookup_device)
from strainscan_tpu.kmer import device as kdev
from strainscan_tpu.ops.probe_prep import fp_probe


def make_mesh(n_devices: Optional[int] = None,
              index_shards: Optional[int] = None) -> Mesh:
    """Mesh over ('data', 'index').  index axis defaults to 2 when the
    device count allows, else 1 (pure data parallelism)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if index_shards is None:
        index_shards = 2 if n % 2 == 0 and n >= 2 else 1
    data_shards = n // index_shards
    arr = np.array(devs[: data_shards * index_shards]).reshape(
        data_shards, index_shards)
    return Mesh(arr, ("data", "index"))


@dataclasses.dataclass
class ShardedTable:
    """Rectangular stack of per-shard hash tables + shard id offsets."""

    table: np.ndarray    # [n_shards, n_buckets, BUCKET*3] interleaved
    n_buckets: int       # per shard (uniform)
    max_probe: int       # max across shards
    shard_sizes: np.ndarray  # [n_shards] number of keys per shard
    shard_cap: int       # padded per-shard key capacity (id space stride)
    n_keys: int
    k: int
    # sharded slot -> caller id space (-1 = padding).  Lets a sharded count
    # vector map back onto an arbitrary external k-mer id order (e.g. a
    # converted reference DB's kmer.fa order).
    value_map: Optional[np.ndarray] = None

    @classmethod
    def build(cls, keys: np.ndarray, k: int, n_shards: int,
              values: Optional[np.ndarray] = None) -> "ShardedTable":
        """``keys`` in any order; ``values`` (default ``arange``) are the
        caller's global ids for each key.  Internally keys are sorted and
        split into contiguous shards (good hash-balance per shard)."""
        n = keys.shape[0]
        if values is None:
            values = np.arange(n, dtype=np.int32)
        order = np.argsort(keys, kind="stable")
        keys_sorted = keys[order]
        vals_sorted = values[order].astype(np.int32)
        cap = -(-max(n, 1) // n_shards)
        tables = []
        sizes = []
        value_map = np.full(n_shards * cap, -1, dtype=np.int32)
        for s in range(n_shards):
            chunk = keys_sorted[s * cap : (s + 1) * cap]
            sizes.append(chunk.size)
            tables.append(KmerTable.build(chunk, k=k))
            value_map[s * cap : s * cap + chunk.size] = (
                vals_sorted[s * cap : (s + 1) * cap])
        n_buckets = max(t.n_buckets for t in tables)
        max_probe = max(t.max_probe for t in tables)
        # rebuild smaller shards at the common bucket count so the stack is
        # rectangular and the mix/probe math is uniform
        for i, t in enumerate(tables):
            if t.n_buckets != n_buckets:
                chunk = keys_sorted[i * cap : (i + 1) * cap]
                # force the bucket count by lowering the load factor
                lf = max(len(chunk), 1) / (n_buckets * BUCKET)
                tables[i] = KmerTable.build(chunk, k=k, load_factor=lf)
                max_probe = max(max_probe, tables[i].max_probe)
        table = np.stack([t.interleaved() for t in tables])
        return cls(table=table,
                   n_buckets=n_buckets, max_probe=max_probe,
                   shard_sizes=np.array(sizes), shard_cap=cap, n_keys=n,
                   k=k, value_map=value_map)


def sharded_count(mesh: Mesh, st: ShardedTable, codes: jax.Array,
                  canonical: bool = False) -> jax.Array:
    """Counts [n_shards * shard_cap] (global id = shard * cap + local id),
    sharded over the 'index' axis; psum over 'data' merges read blocks.

    jit once per codes shape; shard_map places the collectives.
    """
    k = st.k
    n_buckets = st.n_buckets
    max_probe = st.max_probe
    cap = st.shard_cap

    def local(codes_blk, table):
        # codes_blk: [B/d, L]; table: [1, n_buckets, BUCKET*3] (this shard)
        hi, lo, valid = kdev.extract_kmers(codes_blk, k)
        if canonical:
            hi, lo = kdev.canonical(hi, lo, k)
        ids = lookup_device(table[0], n_buckets, max_probe, hi, lo)
        ids = jnp.where(valid, ids, -1).reshape(-1)
        safe = jnp.where(ids >= 0, ids, cap)
        counts = jnp.zeros((cap + 1,), jnp.int32).at[safe].add(
            jnp.ones_like(safe, dtype=jnp.int32), mode="drop")[:cap]
        counts = jax.lax.psum(counts, "data")
        return counts[None, :]

    fn = jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("data", None), P("index", None, None)),
        out_specs=P("index", None),
    ))
    out = fn(codes, jnp.asarray(st.table))
    return out.reshape(-1)


@dataclasses.dataclass
class ShardedFpTable:
    """Rectangular stack of single-probe fingerprint shards (one common
    (n_buckets, bucket, seed) geometry — see
    ``hashtable.build_fp_shards``) plus the slot->id remap arrays.

    This is the sharded twin of the single-chip FpTable hot path
    (ops/count.py design, VERDICT round-1 item 3): ONE narrow row gather
    per window, counts accumulated in slot space, remapped device-side."""

    fp: np.ndarray        # uint32 [n_shards, n_buckets, bucket]
    soi: np.ndarray       # int32  [n_shards, shard_cap] slot of local id
    n_buckets: int
    bucket: int
    seed: int
    shard_cap: int        # padded per-shard key capacity (id space stride)
    n_keys: int
    k: int
    value_map: np.ndarray  # [n_shards*cap] -> caller ids (-1 = padding)

    @property
    def n_slots(self) -> int:
        return self.n_buckets * self.bucket

    @classmethod
    def build(cls, keys: np.ndarray, k: int, n_shards: int,
              values: Optional[np.ndarray] = None) -> "ShardedFpTable":
        n = keys.shape[0]
        if values is None:
            values = np.arange(n, dtype=np.int32)
        order = np.argsort(keys, kind="stable")
        keys_sorted = keys[order]
        vals_sorted = values[order].astype(np.int32)
        cap = -(-max(n, 1) // n_shards)
        chunks = [keys_sorted[s * cap:(s + 1) * cap] for s in range(n_shards)]
        tables = build_fp_shards(chunks, k=k)
        value_map = np.full(n_shards * cap, -1, dtype=np.int32)
        n_slots = tables[0].n_slots
        soi = np.full((n_shards, cap), n_slots, dtype=np.int32)  # pad->trash
        for s, t in enumerate(tables):
            m = chunks[s].size
            value_map[s * cap : s * cap + m] = vals_sorted[s * cap:(s + 1) * cap]
            if m:
                soi[s, :m] = t.slot_of_id()
        return cls(fp=np.stack([t.fp.reshape(t.n_buckets, t.bucket)
                                for t in tables]),
                   soi=soi, n_buckets=tables[0].n_buckets,
                   bucket=tables[0].bucket, seed=tables[0].seed,
                   shard_cap=cap, n_keys=n, k=k, value_map=value_map)


class ShardedCountPipeline:
    """Multi-device drop-in for ops.count.CountPipeline with the SAME
    single-device probe (ops/probe_prep.fp_probe, packed 2-bit transfer): the fingerprint table lives sharded over the mesh's
    ``index`` axis, read batches stream over ``data``, per-(data, index)
    partial totals stay device-resident in slot space, and ONE psum at
    ``finish()`` merges the data axis — no per-batch collectives.

    ``finish()`` returns counts in the CALLER's k-mer id space (the
    ``values`` passed to ``build``), so it is interchangeable with the
    single-device pipeline for any DB layout.
    """

    def __init__(self, keys: np.ndarray, k: int,
                 mesh: Optional[Mesh] = None,
                 values: Optional[np.ndarray] = None,
                 canonical: bool = False,
                 packed_transfer: bool = True):
        self.mesh = mesh if mesh is not None else make_mesh()
        n_index = self.mesh.shape["index"]
        self.st = ShardedFpTable.build(keys, k=k, n_shards=n_index,
                                       values=values)
        self.canonical = canonical
        self.packed_transfer = packed_transfer
        self._table_dev = None
        self._total = None
        self._fns = {}
        self._fin = None
        self._soi_dev = None
        self._shape = None
        self._zeros_fn = None

    def _fn(self, shape, form="codes"):
        key = (shape, form)
        if key not in self._fns:
            st, mesh = self.st, self.mesh
            k, n_buckets, bucket, seed = (st.k, st.n_buckets, st.bucket,
                                          st.seed)
            trash = st.n_slots
            canonical = self.canonical
            packed = self.packed_transfer
            length = self._len  # codes row length (shape is pre-packing)


            # read batches arrive split over BOTH mesh axes — every byte
            # crosses the host link exactly once — and each index program
            # reassembles its data-block with an all_gather over 'index'
            # on the device interconnect (replicating the block over
            # 'index' at h2d time would pay n_index x the host-link bytes)
            def gather_idx(x):
                return jax.lax.all_gather(x, "index", axis=0, tiled=True)

            def accumulate(codes_blk, fp_blk, total_blk):
                slots = fp_probe(codes_blk, fp_blk[0], k=k,
                                 n_buckets=n_buckets, bucket=bucket,
                                 seed=seed, canonical=canonical).reshape(-1)
                safe = jnp.where(slots >= 0, slots, trash)
                ones = jnp.ones_like(safe, dtype=total_blk.dtype)
                # flatten: the 1-D scatter lowers to the same program
                # as the single-chip path; at[0, 0, safe] does not
                t = total_blk.reshape(-1).at[safe].add(
                    ones, mode="promise_in_bounds")
                return t.reshape(total_blk.shape)

            if form == "vlen":
                def local(words, vlen, fp_blk, total_blk):
                    codes_blk = kdev.unpack_codes_vlen(
                        gather_idx(words), gather_idx(vlen), length)
                    return accumulate(codes_blk, fp_blk, total_blk)

                in_specs = (P(("data", "index"), None),
                            P(("data", "index"),),
                            P("index", None, None),
                            P("data", "index", None))
                donate = (3,)
            elif packed:
                def local(words, vbytes, fp_blk, total_blk):
                    codes_blk = kdev.unpack_codes(
                        gather_idx(words), gather_idx(vbytes), length)
                    return accumulate(codes_blk, fp_blk, total_blk)

                in_specs = (P(("data", "index"), None),
                            P(("data", "index"), None),
                            P("index", None, None),
                            P("data", "index", None))
                donate = (3,)
            else:
                def local(codes, fp_blk, total_blk):
                    return accumulate(gather_idx(codes), fp_blk, total_blk)

                in_specs = (P(("data", "index"), None),
                            P("index", None, None),
                            P("data", "index", None))
                donate = (2,)

            self._fns[key] = jax.jit(
                jax.shard_map(local, mesh=mesh, in_specs=in_specs,
                              out_specs=P("data", "index", None)),
                donate_argnums=donate,
            )
        return self._fns[key]

    def _ensure_device_state(self):
        if self._table_dev is None:
            self._table_dev = jax.device_put(
                self.st.fp,
                NamedSharding(self.mesh, P("index", None, None)))
        if self._total is None:
            d = self.mesh.shape["data"]
            n_index = self.mesh.shape["index"]
            # zeros are CREATED on device (compiled once): a device_put
            # of host zeros is a full accumulator-sized h2d — 268 MB at
            # E. coli scale — after every reset(), i.e. once per sample
            # on the identify path
            if self._zeros_fn is None:
                shape = (d, n_index, self.st.n_slots + 1)
                self._zeros_fn = jax.jit(
                    lambda: jnp.zeros(shape, jnp.int32),
                    out_shardings=NamedSharding(
                        self.mesh, P("data", "index", None)))
            self._total = self._zeros_fn()

    def prepare_batch(self, codes: np.ndarray):
        """Host-side half of add_batch: shape pinning, padding, packing.

        Mirrors ``CountPipeline.prepare_batch`` so ``count_sample``'s
        producer thread overlaps parse+pack with device dispatch (the
        same split that closed the round-1 single-chip gap).  Only the
        producer may call it — it owns the batch-shape state."""
        out = []
        d = self.mesh.shape["data"] * self.mesh.shape["index"]
        codes = np.asarray(codes)
        if self._shape is None:
            b = codes.shape[0]
            b += (-b) % d   # rows split over BOTH mesh axes at h2d time
            self._shape = (b, codes.shape[1])
            self._len = codes.shape[1]
        rows, cols = self._shape
        if codes.shape[1] != cols:
            raise ValueError(
                f"batch maxlen changed: {codes.shape[1]} != {cols}")
        if codes.shape[0] > rows:
            for i in range(0, codes.shape[0], rows):
                out.extend(self.prepare_batch(codes[i : i + rows]))
            return out
        if codes.shape[0] < rows:  # pin one shape -> compile exactly once
            pad = np.full((rows - codes.shape[0], cols), 4, dtype=codes.dtype)
            codes = np.concatenate([codes, pad], axis=0)
        if self.packed_transfer:
            from strainscan_tpu.kmer import pack

            fused = pack.bitpack_codes_vlen(codes)  # one native pass
            if fused is None:  # no native lib, or a mid-read N
                vlen = pack.valid_prefix_lens(codes)
                fused = (pack.bitpack_codes(codes, need_vbytes=False)[0],
                         vlen) if vlen is not None else None
            if fused is not None:
                out.append(("vlen", codes.shape, fused[0], fused[1]))
            else:
                words, vbytes = pack.bitpack_codes(codes)
                out.append(("vbytes", codes.shape, words, vbytes))
        else:
            out.append(("codes", codes.shape, codes, None))
        return out

    def ship(self, payloads):
        """h2d half of dispatch: device_put each payload's arrays into
        the mesh layout (rows split over data x index — see :meth:`_fn`).

        Safe to call from the producer thread, so the host->device
        transfer overlaps the main thread's (cheap, async) dispatches —
        the explicit per-batch device_put on the main thread was the
        0.3-0.4 s/batch serial overhead of the round-4 sharded path.

        Transfers go as plain per-device device_puts of contiguous row
        chunks, assembled with make_array_from_single_device_arrays.  All
        chunks of both arrays ship in ONE pytree call."""
        devs = list(self.mesh.devices.flat)   # data-major = P axis order
        n = len(devs)
        out = []
        for form, shape, a, b in payloads:
            arrs, tgts = [], []
            for x in (a, b):
                if x is None:
                    continue
                rows = x.shape[0] // n
                for i, d in enumerate(devs):
                    arrs.append(x[i * rows:(i + 1) * rows])
                    tgts.append(d)
            parts = jax.device_put(arrs, tgts)

            def assemble(x, shards):
                spec = P(("data", "index"), *([None] * (x.ndim - 1)))
                return jax.make_array_from_single_device_arrays(
                    x.shape, NamedSharding(self.mesh, spec), shards)

            ad = assemble(a, parts[:n])
            bd = assemble(b, parts[n:]) if b is not None else None
            out.append((form, shape, ad, bd))
        return out

    def add_prepared(self, payloads) -> None:
        """Dispatch payloads from :meth:`prepare_batch` or :meth:`ship`
        (main thread)."""
        self._ensure_device_state()
        for form, shape, a, b in payloads:
            if not isinstance(a, jax.Array):
                (form, shape, a, b), = self.ship([(form, shape, a, b)])
            if form == "vlen":
                self._total = self._fn(shape, "vlen")(
                    a, b, self._table_dev, self._total)
            elif form == "vbytes":
                self._total = self._fn(shape, "vbytes")(
                    a, b, self._table_dev, self._total)
            else:
                self._total = self._fn(shape)(
                    a, self._table_dev, self._total)

    def add_batch(self, codes: np.ndarray) -> None:
        self.add_prepared(self.prepare_batch(codes))

    def reset(self) -> None:
        self._total = None
        # re-pin the batch geometry: the jitted fns are keyed by shape,
        # so a cached pipeline first exercised on a tiny sample must not
        # keep splitting later full-size batches into tiny sub-dispatches
        self._shape = None

    def close(self) -> None:
        """Drop device buffers (fp table, totals, slot_of_id) and the
        compiled fns — called when a pipeline cache evicts this entry so
        hundreds of MB of device memory don't linger until GC."""
        self._table_dev = None
        self._total = None
        self._soi_dev = None
        self._fns = {}
        self._fin = None
        self._zeros_fn = None

    def _finish_fn(self):
        if self._fin is None:
            def fin(total_blk, soi_blk):
                # [1, 1, S+1] per program -> psum over data -> id gather
                # -> all_gather over index: the id-space result comes out
                # REPLICATED, so the caller reads it off one device with
                # zero cross-sharding copies
                t = jax.lax.psum(total_blk[0, 0], "data")
                ids = t.at[soi_blk[0]].get(mode="promise_in_bounds")
                return jax.lax.all_gather(ids, "index", axis=0, tiled=True)

            # check_vma off: the checker can't infer that a tiled
            # all_gather over 'index' makes the output index-invariant
            # (it is — every program computes the identical vector)
            self._fin = jax.jit(jax.shard_map(
                fin, mesh=self.mesh,
                in_specs=(P("data", "index", None), P("index", None)),
                out_specs=P(None), check_vma=False,
            ))
        return self._fin

    def finish(self) -> np.ndarray:
        """int32 [n_keys] counts in the caller's id space (same dtype as
        the single-device pipeline).  The data-axis psum and the slot->id
        remap both run on device; the d2h fetch shares
        ``ops.count.fetch_counts`` with the single-device pipeline
        (device-side stats pick sparse idx+vals / uint8 / uint16 / int32;
        counts >= 2^16 automatically fall back to dense int32, so the
        encoding is bit-exact at any depth)."""
        if self._total is None:
            return np.zeros(self.st.n_keys, dtype=np.int32)
        from strainscan_tpu.ops.count import fetch_counts

        # slot_of_id uploads ONCE per pipeline: it is 114 MB at E. coli
        # scale
        if self._soi_dev is None:
            self._soi_dev = jax.device_put(
                self.st.soi, NamedSharding(self.mesh, P("index", None)))
        per_id = self._finish_fn()(self._total, self._soi_dev)
        n_padded = per_id.shape[0]
        # the finish output is replicated, so shard 0's data IS the full
        # id-space vector on one device (zero-copy view); the compact
        # fetch's single-device jitted helpers run straight on it
        flat = fetch_counts(per_id.addressable_shards[0].data, n_padded)
        vm = self.st.value_map
        ident = getattr(self, "_vm_ident", None)
        if ident is None:
            # default arange values + evenly-divided shards make the map
            # the identity; skipping the remap avoids a 28.6M-element
            # fancy scatter (~1.1 s at E. coli scale) AND a fresh
            # n_keys-sized zeros + copy (~0.4 s of host memory traffic)
            # every finish
            ident = bool(vm.size == self.st.n_keys
                         and vm[0] == 0 and vm[-1] == vm.size - 1
                         and np.array_equal(
                             vm, np.arange(vm.size, dtype=vm.dtype)))
            self._vm_ident = ident
        if ident:
            return flat if flat.size == self.st.n_keys \
                else flat[:self.st.n_keys]
        out = np.zeros(self.st.n_keys, dtype=np.int32)
        valid = vm >= 0
        out[vm[valid]] = flat[valid]
        return out


_L2_MESH_CACHE: list = []


def l2_mesh(n_rows: int, min_rows: int) -> Optional[Mesh]:
    """Mesh for sharded L2 statistics, or None when sharding would not
    pay: single device, multi-host (the L2 solve is replicated per
    host), or a matrix below the size gate (collective latency would
    exceed the matvec).

    The mesh is cached for the life of the process (devices don't
    change) so the jitted shard_map factories below — lru_cached ON the
    mesh — compile once per shape, not once per sample."""
    if n_rows < min_rows:
        return None
    if jax.process_count() > 1 or jax.device_count() < 2:
        return None
    if not _L2_MESH_CACHE:
        _L2_MESH_CACHE.append(make_mesh())
    return _L2_MESH_CACHE[0]


def shard_rows(mesh: Mesh, a: np.ndarray) -> jax.Array:
    """Host array -> device array with axis 0 split over the WHOLE mesh
    (both axes, data-major).  Rows must be pre-padded to a multiple of
    the device count (see :func:`pad_rows`)."""
    spec = P(("data", "index"), *([None] * (a.ndim - 1)))
    return jax.device_put(a, NamedSharding(mesh, spec))


def pad_rows(mesh: Mesh, n: int) -> int:
    nd = int(mesh.devices.size)
    return n + (-n) % nd


@functools.lru_cache(maxsize=8)
def sharded_colsum_fn(mesh: Mesh):
    """jit: (X8 [n, s] int8 row-sharded, m [n] bool row-sharded) ->
    replicated int32 [s] = X^T m.

    The Pre-Scan inner statistic (reference get_candidate_arr /
    cal_cov_all, identify_strains...sp.py:121-134/:44-49) with the
    k-mer axis sharded over every device; one psum returns the O(s)
    result.  int8 x int8 -> int32 partial sums are exact, so the
    sharded result is bit-identical to the single-device matvec."""

    def local(Xb, mb):
        out = jnp.einsum("ns,n->s", Xb, mb.astype(jnp.int8),
                         preferred_element_type=jnp.int32)
        return jax.lax.psum(out, ("data", "index"))

    return jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(("data", "index"), None), P(("data", "index"),)),
        out_specs=P(None),
    ))


@functools.lru_cache(maxsize=8)
def sharded_colsum_unused_fn(mesh: Mesh):
    """Fused ``X^T (~used & big)`` variant of :func:`sharded_colsum_fn`
    — one dispatch per Pre-Scan round (get_candidate_arr, :121-134)."""

    def local(Xb, ub, bb):
        m = jnp.logical_and(jnp.logical_not(ub), bb)
        out = jnp.einsum("ns,n->s", Xb, m.astype(jnp.int8),
                         preferred_element_type=jnp.int32)
        return jax.lax.psum(out, ("data", "index"))

    return jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(("data", "index"), None), P(("data", "index"),),
                  P(("data", "index"),)),
        out_specs=P(None),
    ))


@functools.lru_cache(maxsize=8)
def sharded_or_col_fn(mesh: Mesh):
    """``used |= X[:, c]`` with both arrays row-sharded (the Pre-Scan
    'used' union stays device-resident across rounds)."""

    def local(ub, Xb, c):
        col = jax.lax.dynamic_index_in_dim(Xb, c, axis=1, keepdims=False)
        return ub | (col > 0)

    return jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(("data", "index"),), P(("data", "index"), None), P()),
        out_specs=P(("data", "index"),),
    ))


@functools.lru_cache(maxsize=8)
def sharded_fold_grams_fn(mesh: Mesh, block: int = 131072):
    """jit: (X8 [n, s] int8 row-sharded, T8 [F, n] int8 col-sharded) ->
    replicated int32 [F, s, s] per-fold Grams X^T diag(t_f) X.

    The Elastic-Net CV moment computation (reference ElasticNetCV fold
    fits, identify_strains...sp.py:433-444) with the k-mer axis sharded
    over the whole mesh; each device scans its row chunk in blocks (so
    the [F, block, s] intermediate stays small) and ONE psum merges the
    O(F s^2) partials."""

    def local(Xb, Tb):
        n_loc, s = Xb.shape
        F = Tb.shape[0]
        nb = -(-n_loc // block)
        npad = nb * block
        Xp = jnp.zeros((npad, s), jnp.int8).at[:n_loc].set(Xb)
        Tp = jnp.zeros((F, npad), jnp.int8).at[:, :n_loc].set(Tb)
        Xs = Xp.reshape(nb, block, s)
        Ts = Tp.reshape(F, nb, block).transpose(1, 0, 2)

        def step(g, inp):
            xb, trb = inp
            xw = trb[:, :, None] * xb[None]
            g = g + jnp.einsum("fbs,bt->fst", xw, xb,
                               preferred_element_type=jnp.int32)
            return g, None

        # the carry varies over the mesh like the row blocks it sums
        g0 = jax.lax.pcast(jnp.zeros((F, s, s), jnp.int32),
                           ("data", "index"), to="varying")
        g, _ = jax.lax.scan(step, g0, (Xs, Ts))
        return jax.lax.psum(g, ("data", "index"))

    return jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(("data", "index"), None), P(None, ("data", "index"))),
        out_specs=P(None, None, None),
    ))


def sharded_l2_stats(mesh: Mesh, X: jax.Array, y: jax.Array
                     ) -> Tuple[jax.Array, jax.Array]:
    """(X^T y, X^T X) with the k-mer axis sharded over the whole mesh.

    X: [n_kmers, s] float; y: [n_kmers] float, both sharded on axis 0.
    Returns replicated moments — the O(s) surface the host Enet consumes.
    The float32 products run at full float32 precision (no TF32).
    """
    hp = jax.lax.Precision.HIGHEST

    def local(Xb, yb):
        m = jnp.matmul(Xb.T, yb, precision=hp)
        g = jnp.matmul(Xb.T, Xb, precision=hp)
        m = jax.lax.psum(jax.lax.psum(m, "data"), "index")
        g = jax.lax.psum(jax.lax.psum(g, "data"), "index")
        return m, g

    fn = jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(("data", "index"), None), P(("data", "index"))),
        out_specs=(P(None), P(None, None)),
    ))
    return fn(X, y)
