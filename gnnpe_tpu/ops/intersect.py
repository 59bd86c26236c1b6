"""Sorted-set intersection and bitset operations.

The reference carries three SIMD intersection stacks (AVX2/AVX512
merge + galloping in libsrc/utility/computesetintersection.cpp, bitset
kernels in bitsetoperation.cpp, QFilter/BSR in han/intersection_algos
.cpp) — all compiled but unreachable from main (SURVEY.md §2.1).  This
framework makes them first-class: candidate-set intersection is
the core of device-side pre-verification (intersecting a candidate set
with a vertex's adjacency before shipping candidates to host
refinement, SURVEY.md §7.3).

Device mapping:
  * merge/galloping SIMD → vectorized ``searchsorted`` —
    one binary-search wave per element, no data-dependent control flow;
  * BSR/bitset → uint32 lane masks: a vertex set over [0, V) packs to
    ``uint32[V/32]``; intersection is ``&``, cardinality is popcount;
  * hybrid threshold selection (config.h:7-10) → size-ratio dispatch
    between searchsorted (skewed) and bitmap (dense) forms.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


# ---------------------------------------------------------------------
# Host (numpy) forms — exact, used by the refinement path.

def intersect_sorted_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Intersection of two sorted unique int arrays (galloping
    equivalent: np.intersect1d with assume_unique)."""
    return np.intersect1d(a, b, assume_unique=True)


def intersect_count_np(a: np.ndarray, b: np.ndarray) -> int:
    if len(a) > len(b):
        a, b = b, a
    idx = np.searchsorted(b, a)
    idx = np.minimum(idx, len(b) - 1) if len(b) else idx
    return int((len(b) > 0) and (b[idx] == a).sum())


# ---------------------------------------------------------------------
# Device (jnp) forms — static shapes, mask semantics.

def intersect_mask(a, a_valid, b, b_valid):
    """For each element of `a`, is it present in sorted set `b`?

    a: int32[N] padded array, a_valid: bool[N];
    b: int32[M] SORTED padded array (pad with INT32_MAX so order is
    kept), b_valid: bool[M].  Returns bool[N] membership mask — the
    vector form of the merge intersection (one searchsorted wave, no loops).
    """
    import jax.numpy as jnp
    m = b.shape[0]
    idx = jnp.searchsorted(b, a)
    idx_c = jnp.minimum(idx, m - 1)
    hit = (jnp.take(b, idx_c) == a) & jnp.take(b_valid, idx_c)
    return hit & a_valid


def intersect_sorted_device(a, a_valid, b, b_valid):
    """Sorted-set intersection with static output shape [N]:
    (values int32[N], valid bool[N]) — matching elements of `a`,
    compacted to the front (sort by ~valid keeps relative order)."""
    import jax.numpy as jnp
    hit = intersect_mask(a, a_valid, b, b_valid)
    # Stable compaction: argsort on (!hit) preserves order of survivors.
    order = jnp.argsort(~hit, stable=True)
    vals = jnp.take(a, order)
    return vals, jnp.take(hit, order)


# ---------------------------------------------------------------------
# Bitset (uint32 lane-mask) forms.

def bitset_from_ids(ids: np.ndarray, num_vertices: int) -> np.ndarray:
    """Host: pack a vertex id set into uint32[ceil(V/32)]."""
    words = -(-num_vertices // 32)
    out = np.zeros(words, dtype=np.uint32)
    ids = np.asarray(ids, dtype=np.int64)
    np.bitwise_or.at(out, ids // 32,
                     (np.uint32(1) << (ids % 32).astype(np.uint32)))
    return out


def bitset_to_ids(bits: np.ndarray) -> np.ndarray:
    """Host: unpack to sorted vertex ids."""
    w = len(bits)
    mat = ((bits[:, None] >> np.arange(32, dtype=np.uint32)[None, :])
           & 1).astype(bool)
    word, bit = np.nonzero(mat)
    return np.sort(word * 32 + bit).astype(np.int64)


def bitset_and(a, b):
    """Device or host: intersection of packed sets."""
    return a & b


def bitset_count(bits):
    """Device: popcount over the packed set (uint32 lanes)."""
    import jax.numpy as jnp
    v = jnp.asarray(bits, dtype=jnp.uint32)
    # SWAR popcount — vector-friendly, no lookup tables.
    v = v - ((v >> 1) & jnp.uint32(0x55555555))
    v = (v & jnp.uint32(0x33333333)) + ((v >> 2) & jnp.uint32(0x33333333))
    v = (v + (v >> 4)) & jnp.uint32(0x0F0F0F0F)
    return ((v * jnp.uint32(0x01010101)) >> 24).sum()


def array_and_bitset(ids, ids_valid, bits):
    """Device: membership of each id in a packed set → bool mask
    (the reference's intersectArrayBitset form)."""
    import jax.numpy as jnp
    word = jnp.take(jnp.asarray(bits, dtype=jnp.uint32), ids // 32)
    hit = ((word >> (ids % 32).astype(jnp.uint32)) & 1).astype(bool)
    return hit & ids_valid


# ---------------------------------------------------------------------
# Hybrid dispatch (the config.h HYBRID selection, data-driven).

GALLOP_RATIO = 32      # |b|/|a| beyond which searchsorted beats merge


def intersect_auto_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Host hybrid: galloping via searchsorted when skewed, merge
    otherwise — same contract either way."""
    if len(a) > len(b):
        a, b = b, a
    if len(a) == 0:
        return a.copy()
    if len(b) >= GALLOP_RATIO * len(a):
        idx = np.searchsorted(b, a)
        idx = np.minimum(idx, len(b) - 1)
        return a[b[idx] == a]
    return np.intersect1d(a, b, assume_unique=True)
