"""Device-side k-mer extraction (JAX, 32-bit arithmetic).

Packed k-mers live as ``(hi, lo)`` uint32 pairs on device, so no
process-wide ``jax_enable_x64`` is needed: ``hi`` holds the top ``2k-32`` bits
(the 5'-most bases), ``lo`` the bottom 32 bits.  The layout matches
:mod:`strainscan_tpu.kmer.pack` exactly, so host-built hash tables and
device-extracted query k-mers agree bit-for-bit.

This replaces the jellyfish read-scan (reference library/identify.py:73-103)
on the device side: a batch of padded encoded reads ``[B, L]`` (codes 0..3,
4 = N/pad) becomes all valid k-mer windows ``[B, L-k+1]`` with a validity
mask, using ``k`` static shift-or passes (elementwise work, no gathers).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

U32 = jnp.uint32


def _u32(x):
    return jnp.asarray(x, dtype=U32)


@functools.partial(jax.jit, static_argnames=("k",))
def extract_kmers(codes: jax.Array, k: int):
    """All k-mer windows of encoded reads.

    Args:
      codes: uint8/uint32 array ``[B, L]`` with values 0..3 (bases) or >=4
        (invalid / padding).
      k: k-mer size (<= 31).

    Returns:
      ``(hi, lo, valid)`` each ``[B, L-k+1]``; ``hi``/``lo`` are uint32 and
      ``valid`` is bool (window contains no invalid code).
    """
    if k > 31:
        raise ValueError("k must be <= 31")
    codes = jnp.asarray(codes)
    b, length = codes.shape
    m = length - k + 1
    if m <= 0:
        raise ValueError(f"reads of length {length} cannot hold {k}-mers")
    k_lo = min(k, 16)   # bases packed into lo (3'-most)
    k_hi = k - k_lo     # bases packed into hi (5'-most)
    c32 = codes.astype(U32) & _u32(3)
    hi = jnp.zeros((b, m), dtype=U32)
    lo = jnp.zeros((b, m), dtype=U32)
    for j in range(k_hi):
        hi = (hi << 2) | jax.lax.dynamic_slice_in_dim(c32, j, m, axis=1)
    for j in range(k_lo):
        lo = (lo << 2) | jax.lax.dynamic_slice_in_dim(c32, k_hi + j, m, axis=1)
    invalid = (codes >= 4).astype(jnp.int32)
    csum = jnp.cumsum(invalid, axis=1)
    csum = jnp.pad(csum, ((0, 0), (1, 0)))
    valid = (csum[:, k:] - csum[:, :-k]) == 0
    return hi, lo, valid


@functools.partial(jax.jit, static_argnames=("length",))
def unpack_codes(words: jax.Array, vbytes: jax.Array, length: int):
    """Inverse of pack.bitpack_codes on device: uint32 words + validity
    bytes -> uint32 codes [B, length] (0..3, 4 = invalid).  Pure VPU
    shifts, no gathers."""
    b, w = words.shape
    parts = [((words >> (2 * j)) & _u32(3)) for j in range(16)]
    codes = jnp.stack(parts, axis=-1).reshape(b, w * 16)[:, :length]
    vparts = [((vbytes >> j) & jnp.uint8(1)) for j in range(8)]
    valid = jnp.stack(vparts, axis=-1).reshape(b, -1)[:, :length]
    return jnp.where(valid > 0, codes, _u32(4))


@functools.partial(jax.jit, static_argnames=("length",))
def unpack_codes_vlen(words: jax.Array, vlen: jax.Array, length: int):
    """unpack_codes for prefix-run validity: ``vlen`` uint16 [B] valid
    prefix lengths (pack.valid_prefix_lens) — 2 bytes/row shipped instead
    of ceil(L/8) validity bytes."""
    b, w = words.shape
    parts = [((words >> (2 * j)) & _u32(3)) for j in range(16)]
    codes = jnp.stack(parts, axis=-1).reshape(b, w * 16)[:, :length]
    valid = (jnp.arange(length, dtype=jnp.int32)[None, :]
             < vlen.astype(jnp.int32)[:, None])
    return jnp.where(valid, codes, _u32(4))


def _rev2(x):
    """Reverse the sixteen 2-bit groups of a uint32 lane."""
    m2 = _u32(0x33333333)
    m4 = _u32(0x0F0F0F0F)
    m8 = _u32(0x00FF00FF)
    x = ((x >> 2) & m2) | ((x & m2) << 2)
    x = ((x >> 4) & m4) | ((x & m4) << 4)
    x = ((x >> 8) & m8) | ((x & m8) << 8)
    x = (x >> 16) | (x << 16)
    return x


@functools.partial(jax.jit, static_argnames=("k",))
def revcomp(hi: jax.Array, lo: jax.Array, k: int):
    """Reverse complement of packed (hi, lo) k-mers on device."""
    s = 64 - 2 * k
    r_hi = _rev2(~lo)
    r_lo = _rev2(~hi)
    if s == 0:
        new_hi, new_lo = r_hi, r_lo
    elif s < 32:
        new_lo = (r_lo >> s) | (r_hi << (32 - s))
        new_hi = r_hi >> s
    elif s == 32:
        new_lo, new_hi = r_hi, jnp.zeros_like(r_hi)
    else:
        new_lo = r_hi >> (s - 32)
        new_hi = jnp.zeros_like(r_hi)
    mask_hi = _u32((1 << max(2 * k - 32, 0)) - 1) if 2 * k > 32 else _u32(0)
    mask_lo = _u32(0xFFFFFFFF) if 2 * k >= 32 else _u32((1 << (2 * k)) - 1)
    return new_hi & mask_hi, new_lo & mask_lo


@functools.partial(jax.jit, static_argnames=("k",))
def canonical(hi: jax.Array, lo: jax.Array, k: int):
    """min(fwd, rc) under 64-bit numeric order (memory-efficient DB rule)."""
    rhi, rlo = revcomp(hi, lo, k)
    fwd_less = (hi < rhi) | ((hi == rhi) & (lo <= rlo))
    return jnp.where(fwd_less, hi, rhi), jnp.where(fwd_less, lo, rlo)
