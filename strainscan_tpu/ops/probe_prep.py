"""Probe prep: every read window's (bucket, fingerprint) for the count step.

The fingerprint count step (ops/count.py) is, per read batch,

  1. probe prep — window extraction (k shift-or passes over the 2-bit
     codes), optional canonicalization, the seeded bucket hash
     (``hashtable.mix_jnp``) and the fingerprint hash
     (``hashtable.fp2_jnp``); windows holding an invalid code (N or
     padding) get bucket -1;
  2. one fingerprint-row gather + lane compare
     (``hashtable.lookup_fp_rows``);
  3. one scatter-add into the slot-space counts.

Stage 1 has two implementations with bit-identical outputs, chosen by
the platform being lowered for (:func:`probe_prep`):

* CUDA: :func:`probe_prep_triton`, a Pallas kernel through Triton.  One
  program takes ``_ROWS`` reads and a power-of-two tile of window starts;
  each of the k shifted windows is a masked load, so nothing is carried
  between programs.  On an H100 80GB HBM3 (400 W power limit) it takes
  0.22 ms per 65536x256 batch where XLA's fusion of the plain chain takes
  1.7 ms, and the whole count step runs 8% faster with it (PERF.md).
* elsewhere: :func:`probe_prep_jnp`, the plain jnp chain
  (``kmer.device.extract_kmers`` + the hash functions), which is also the
  reference the kernel is tested against (in interpret mode on the CPU).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from strainscan_tpu.index.hashtable import fp2_jnp, lookup_fp_rows, mix_jnp
from strainscan_tpu.kmer import device as kdev

U32 = jnp.uint32
_ROWS = 8        # reads per Triton program
_NUM_WARPS = 4   # 8 reads x 256 window starts over 128 threads


def _hash(hi, lo, n_buckets: int, seed: int):
    b = (mix_jnp(hi, lo, seed) & U32(n_buckets - 1)).astype(jnp.int32)
    return b, fp2_jnp(hi, lo)


def probe_prep_jnp(codes, *, k: int, n_buckets: int, seed: int,
                   canonical: bool = False):
    """Plain jnp probe prep: (bucket or -1 int32 [B, M], fp uint32 [B, M])
    with ``M = L - k + 1``."""
    hi, lo, valid = kdev.extract_kmers(codes, k)
    if canonical:
        hi, lo = kdev.canonical(hi, lo, k)
    b, fp = _hash(hi, lo, n_buckets, seed)
    return jnp.where(valid, b, -1), fp


def _prep_kernel(codes_ref, bucket_ref, fp_ref, *, k, n_buckets, seed,
                 canonical, length, m, width):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    r = pl.program_id(0) * _ROWS + jnp.arange(_ROWS, dtype=jnp.int32)
    rr = jnp.broadcast_to(r[:, None], (_ROWS, width))
    cc = jnp.broadcast_to(jnp.arange(width, dtype=jnp.int32)[None, :],
                          (_ROWS, width))
    base = rr * length + cc
    k_hi = k - min(k, 16)          # 5'-most bases go to hi
    hi = jnp.zeros((_ROWS, width), U32)
    lo = jnp.zeros((_ROWS, width), U32)
    bad = jnp.zeros((_ROWS, width), U32)
    for j in range(k):
        w = plgpu.load(codes_ref.at[base + j], mask=cc + j < length,
                       other=4).astype(U32)
        if j < k_hi:
            hi = (hi << 2) | (w & U32(3))
        else:
            lo = (lo << 2) | (w & U32(3))
        bad = bad | (w >> 2)       # any code >= 4 sets a bit
    if canonical:
        hi, lo = kdev.canonical(hi, lo, k)
    b, fp = _hash(hi, lo, n_buckets, seed)
    out = rr * m + cc
    keep = cc < m
    plgpu.store(bucket_ref.at[out], jnp.where(bad == 0, b, -1), mask=keep)
    plgpu.store(fp_ref.at[out], fp, mask=keep)


def probe_prep_triton(codes, *, k: int, n_buckets: int, seed: int,
                      canonical: bool = False, interpret: bool = False):
    """Pallas-Triton probe prep, bit-identical to :func:`probe_prep_jnp`.

    ``codes``: [B, L] integer codes (0..3 bases, >= 4 invalid); any B —
    rows are padded to the program tile with invalid codes and sliced
    off.  ``interpret`` runs the Pallas interpreter (CPU tests)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    b, length = codes.shape
    m = length - k + 1
    if m <= 0:
        raise ValueError(f"reads of length {length} cannot hold {k}-mers")
    bp = -(-b // _ROWS) * _ROWS
    if bp * length >= 2**31:
        raise ValueError(f"batch of {bp}x{length} codes overflows int32 "
                         "offsets; use smaller batches")
    if bp != b:
        codes = jnp.pad(codes, ((0, bp - b), (0, 0)), constant_values=4)
    vma = jax.typeof(codes).vma    # varies like its input under shard_map
    kern = functools.partial(
        _prep_kernel, k=k, n_buckets=n_buckets, seed=seed,
        canonical=canonical, length=length, m=m,
        width=pl.next_power_of_2(length))
    bucket, fp = pl.pallas_call(
        kern,
        out_shape=(jax.ShapeDtypeStruct((bp * m,), jnp.int32, vma=vma),
                   jax.ShapeDtypeStruct((bp * m,), U32, vma=vma)),
        grid=(bp // _ROWS,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS),
        interpret=interpret,
        name="probe_prep",
    )(codes.reshape(-1))
    return bucket.reshape(bp, m)[:b], fp.reshape(bp, m)[:b]


def probe_prep(codes, *, k: int, n_buckets: int, seed: int,
               canonical: bool = False):
    """(bucket or -1 int32 [B, M], fp uint32 [B, M]): the Triton kernel
    when lowering for CUDA, the plain jnp chain on every other platform."""
    kw = dict(k=k, n_buckets=n_buckets, seed=seed, canonical=canonical)
    return jax.lax.platform_dependent(
        codes, cuda=functools.partial(probe_prep_triton, **kw),
        default=functools.partial(probe_prep_jnp, **kw))


def fp_probe(codes, fp_table, *, k: int, n_buckets: int, bucket: int,
             seed: int, canonical: bool = False):
    """Slot id of every window of ``codes`` [B, L] (-1 miss/invalid)."""
    b, fp = probe_prep(codes, k=k, n_buckets=n_buckets, seed=seed,
                       canonical=canonical)
    return lookup_fp_rows(fp_table, b, fp, bucket)
