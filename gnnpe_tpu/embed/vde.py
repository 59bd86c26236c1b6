"""Vertex dominance embeddings (VDE).

Reference: gen_vde (GNN-PE/include/custom.h:513-544) — a single fixed
message-passing hop: ``vde[v] = x[v] + Σ_{u∈N(v)} x[u]`` with x the
label-seeded features.  Dominance (SURVEY.md §0.1): if u↦v is part of a
monomorphism then vde(u) ≤ vde(v) element-wise, because x depends only on
the label and all entries are positive.

Two paths:
  * :func:`gen_vde` — host numpy float64, bit-identical to the reference.
  * :func:`gen_vde_device` — jit-able JAX version of the same hop (the
    degenerate case of the trainable GNN in gnnpe_tpu.models.gnn).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gnnpe_tpu.graph.csr import CSRGraph
from gnnpe_tpu.ops.mt19937 import label_feature_table
from gnnpe_tpu.ops.spmm import neighbor_sum_np


@dataclass
class VertexEmbeddings:
    """Struct-of-arrays replacement for the reference's vector<Vertex>
    (custom.h:121-130): labels/degrees plus x, nx, vde tables."""

    labels: np.ndarray    # int32[V]
    degrees: np.ndarray   # int32[V]
    x: np.ndarray         # f64[V, D] label-seeded features
    nx: np.ndarray        # f64[V, D] neighbor sums
    vde: np.ndarray       # f64[V, D] x + nx

    @property
    def num_vertices(self) -> int:
        return len(self.labels)

    @property
    def dim(self) -> int:
        return self.x.shape[1]


def gen_vde(graph: CSRGraph, vde_dim: int) -> VertexEmbeddings:
    """Host-exact VDE (parity with custom.h:513-544).

    x is a per-label table gathered to vertices (same-label vertices share
    x by construction); nx is one SpMM hop; vde = x + nx, all float64 with
    the reference's accumulation order.
    """
    table = label_feature_table(graph.labels_count, vde_dim)
    x = table[graph.labels]
    nx = neighbor_sum_np(graph.offsets, graph.neighbors, x)
    return VertexEmbeddings(labels=graph.labels, degrees=graph.degrees,
                            x=x, nx=nx, vde=x + nx)


def gen_vde_device(offsets, neighbors, labels, label_table):
    """Device VDE: gather per-label features and run one aggregation hop.
    jit-compiled in one unit (eager per-op dispatch compiles each op
    separately — pathologically slow on some hosts); dtype follows
    ``label_table`` (f32 for device speed)."""
    import jax
    import jax.numpy as jnp
    from gnnpe_tpu.ops.spmm import spmm_csr

    @jax.jit
    def _run(offsets, neighbors, labels, label_table):
        x = jnp.take(label_table, labels, axis=0)
        nx = spmm_csr(offsets, neighbors, x)
        return x, nx, x + nx

    return _run(offsets, neighbors, labels, label_table)
