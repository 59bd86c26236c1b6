"""Sparse matrix–dense matrix products over CSR/COO adjacency.

This is the "GNN" of the reference: one neighbor-gather + scatter-add hop
(gen_vde, GNN-PE/include/custom.h:513-544).  Here it is expressed as
SpMM ``A @ X`` so the same kernel family serves:
  * parity mode — the fixed label-seeded features, f64 on host;
  * training mode — message-passing layers under jit/grad, f32/bf16 on
    device (see gnnpe_tpu.models.gnn), with the scatter-free binned-ELL
    layout in gnnpe_tpu.ops.ell as the alternative layout; which of the
    two is faster on the GPU is what chip_smoke.py's SpMM phase
    times.

Conventions: the adjacency is unweighted and symmetric; ``A @ X`` with
binary A is exactly the neighbor feature sum.
"""

from __future__ import annotations

import numpy as np


# ----------------------------------------------------------------------
# Host (numpy, float64) — bit-parity path
# ----------------------------------------------------------------------
def neighbor_sum_np(offsets: np.ndarray, neighbors: np.ndarray,
                    x: np.ndarray) -> np.ndarray:
    """nx[v] = Σ_{u∈N(v)} x[u] in float64 on host.

    Matches the reference accumulation order (custom.h:523-534): ascending
    neighbor order per row (rows are sorted), left-to-right summation —
    np.add.reduceat reduces in index order, so sums are bit-identical.
    """
    x = np.asarray(x, dtype=np.float64)
    gathered = x[neighbors]
    deg = np.diff(offsets).astype(np.int64)
    out = np.zeros((len(deg), x.shape[1]), dtype=np.float64)
    if len(neighbors) == 0:
        return out
    # Strictly left-to-right accumulation per row, vectorized across
    # rows: iterate the neighbor *position*, adding the j-th neighbor of
    # every row that has one.  (np.add.reduceat / np.sum use pairwise
    # summation, which drifts from the reference by ulps at degree ≥ ~10.)
    starts = offsets[:-1].astype(np.int64)
    max_deg = int(deg.max())
    active = np.nonzero(deg > 0)[0]
    for j in range(max_deg):
        if j > 0:
            active = active[deg[active] > j]
        out[active] += gathered[starts[active] + j]
    return out


# ----------------------------------------------------------------------
# Device (JAX) — jit/grad-able, mesh-shardable
# ----------------------------------------------------------------------
def neighbor_sum(src, dst, x, num_vertices: int):
    """COO scatter-add aggregation on device:
    out[v] = Σ_{(u→v)∈E} x[u], as ``segment_sum`` over destination ids.

    src/dst are int32[E] directed arcs (both directions present for an
    undirected graph).  Gradient flows through the gather, so this is the
    forward of a trainable message-passing layer.
    """
    import jax
    import jax.numpy as jnp
    gathered = jnp.take(x, src, axis=0)
    return jax.ops.segment_sum(gathered, dst, num_segments=num_vertices)


def segment_spmm(src, dst, values, x, num_vertices: int):
    """Weighted SpMM: out[v] = Σ_e values[e] * x[src[e]] for dst[e]==v."""
    import jax
    import jax.numpy as jnp
    gathered = jnp.take(x, src, axis=0) * values[:, None]
    return jax.ops.segment_sum(gathered, dst, num_segments=num_vertices)


def spmm_csr(offsets, neighbors, x):
    """CSR SpMM via COO segment-sum (see ops.ell.BinnedEll for the
    scatter-free layout)."""
    import jax.numpy as jnp
    num_vertices = offsets.shape[0] - 1
    deg = jnp.diff(offsets)
    src = jnp.repeat(jnp.arange(num_vertices, dtype=jnp.int32), deg,
                     total_repeat_length=neighbors.shape[0])
    return neighbor_sum(neighbors, src, x, num_vertices)
