"""SDDMM + scatter-free attention aggregation (the north star's named
kernel family, BASELINE.json; VERDICT r2 "missing #2").

SDDMM (sampled dense-dense matmul): per-arc scores
``s[e] = <x[src_e], y[dst_e]>`` — the score kernel of attention-style
GNNs (GAT / transformer-conv).  The SDDMM is expressed as gathers +
a row-wise dot, which XLA fuses — there is no scatter anywhere in the
forward path.

The full attention layer composes three scatter-free pieces over ONE
uniform ELL layout (ops/ell.build_ell, whose level-1 slots carry the
arc ids via ``slot_arc``):

  sddmm           per-arc scores                 (gather + dot)
  segment_softmax per-destination softmax        (slot folds, masked)
  weighted_apply  out[v] = Σ_e w_e · x[src_e]    (weighted gather-sum)

Reference parity note: the reference has no attention anywhere
(SURVEY.md §2.3 "No attention"); this module exists for the trainable
GNN family the north star asks for, not for reference parity.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from gnnpe_tpu.ops.ell import HierarchicalEll, build_ell


def arc_endpoints(offsets: np.ndarray) -> np.ndarray:
    """int32[E]: destination vertex of each CSR arc."""
    deg = np.diff(np.asarray(offsets, dtype=np.int64))
    return np.repeat(np.arange(len(deg), dtype=np.int32), deg)


def sddmm(neighbors, dst_of_arc, x, y, chunk: int = 1 << 20):
    """Per-arc scores s[e] = <x[neighbors[e]], y[dst_of_arc[e]]>.

    Chunked so peak memory is O(chunk·D); returns f32[E] in CSR arc
    order.  Pass device arrays for a fused single dispatch per chunk.
    """
    import jax.numpy as jnp
    e = len(neighbors)
    outs = []
    for lo in range(0, max(e, 1), chunk):
        s = jnp.take(x, neighbors[lo:lo + chunk], axis=0)
        d = jnp.take(y, dst_of_arc[lo:lo + chunk], axis=0)
        outs.append((s * d).sum(-1))
    return jnp.concatenate(outs) if len(outs) > 1 else outs[0]


def _slot_vals(layout: HierarchicalEll, arc_vals, fill):
    """Scatter-free slot layout: gather per-arc values into the
    level-1 slot grid through the precomputed slot→arc permutation."""
    import jax.numpy as jnp
    perm = jnp.asarray(layout.slot_arc)
    tbl1 = layout.levels[0].tbl
    vals = jnp.where(perm >= 0,
                     jnp.take(arc_vals, jnp.maximum(perm, 0)), fill)
    return vals.reshape(tbl1.shape)


def _fold(layout: HierarchicalEll, slot_grid, op, fill):
    """Fold level-1 slot values down to one value per vertex with
    ``op`` (masked pads = ``fill``)."""
    import jax.numpy as jnp
    h = op(slot_grid, axis=1)
    for lvl in layout.levels[1:]:
        tbl = jnp.asarray(lvl.tbl)
        g = jnp.take(h, jnp.maximum(tbl, 0).reshape(-1)).reshape(
            tbl.shape)
        h = op(jnp.where(tbl >= 0, g, fill), axis=1)
    return h


def segment_softmax(layout: HierarchicalEll, scores, dst_of_arc):
    """Softmax of per-arc scores over each destination's incoming
    arcs — entirely gathers and folds (no scatter): per-dst max and
    sum come from the ELL slot folds; the broadcast back to arcs is a
    take through dst_of_arc."""
    import jax.numpy as jnp
    dst = jnp.asarray(dst_of_arc)
    m = _fold(layout, _slot_vals(layout, scores, -jnp.inf), jnp.max,
              -jnp.inf)
    m = jnp.where(jnp.isfinite(m), m, 0.0)       # isolated vertices
    e = jnp.exp(scores - jnp.take(m, dst))
    z = _fold(layout, _slot_vals(layout, e, 0.0), jnp.sum, 0.0)
    return e / jnp.maximum(jnp.take(z, dst), 1e-30)


def weighted_apply(layout: HierarchicalEll, x, arc_weights):
    """out[v] = Σ_{e into v} w_e · x[src_e] — the weighted SpMM:
    level-1 gathers scale by the slot-aligned weights, the fold levels
    are plain sums."""
    import jax.numpy as jnp
    w = _slot_vals(layout, arc_weights, 0.0)
    lvl0 = layout.levels[0]
    tbl = jnp.asarray(lvl0.tbl)
    g = jnp.take(x, jnp.maximum(tbl, 0).reshape(-1), axis=0).reshape(
        *tbl.shape, x.shape[-1])
    h = (g * w[..., None]).sum(axis=1)
    for lvl in layout.levels[1:]:
        t = jnp.asarray(lvl.tbl)
        g = jnp.take(h, jnp.maximum(t, 0).reshape(-1), axis=0).reshape(
            *t.shape, h.shape[-1])
        h = jnp.where((t >= 0)[..., None], g, 0.0).sum(axis=1)
    return h


def attention_aggregate(layout: HierarchicalEll, neighbors, dst_of_arc,
                        x_key, x_query, x_value):
    """One GAT-style attention hop: SDDMM scores → per-dst softmax →
    weighted aggregation.  All three stages scatter-free."""
    s = sddmm(neighbors, dst_of_arc, x_key, x_query)
    w = segment_softmax(layout, s, dst_of_arc)
    return weighted_apply(layout, x_value, w)
