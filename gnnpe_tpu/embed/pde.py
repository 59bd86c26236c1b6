"""Path dominance embeddings (PDE) and per-vertex path groups.

Reference:
  * gen_pde (GNN-PE/include/custom.h:546-572): pde = concat of vde over a
    path's vertices; pde_label = concat of raw x.  Here both are a single
    gather + reshape over the path id matrix — no per-path loops.
  * gen_query_pde (custom.h:574-599): adds per-path weight (Σ degrees) and
    search key (-Σ pde).  The greedy path-cover plan lives in
    gnnpe_tpu.match.plan.
  * PGE path groups (GNN-PGE/src/main.cpp:95-177): per start vertex, the
    [min,max] interval of all its paths' embeddings; vertices with no path
    get a degenerate vde box padded with zeros (main.cpp:105-122).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gnnpe_tpu.embed.vde import VertexEmbeddings


@dataclass
class PathEmbeddings:
    """Struct-of-arrays replacement for vector<Path> (custom.h:132-140)."""

    vids: np.ndarray       # int32[P, L]
    labels: np.ndarray     # int32[P, L]
    degrees: np.ndarray    # int32[P, L]
    pde: np.ndarray        # f64[P, L*D] concatenated vde
    pde_label: np.ndarray  # f64[P, L*D] concatenated x

    @property
    def num_paths(self) -> int:
        return self.vids.shape[0]

    @property
    def path_length(self) -> int:
        return self.vids.shape[1]


def gen_pde(vertices: VertexEmbeddings, paths: np.ndarray) -> PathEmbeddings:
    """Vectorized gen_pde (custom.h:546-572): one fancy-index gather."""
    paths = np.asarray(paths, dtype=np.int32)
    p, l = paths.shape
    d = vertices.dim
    return PathEmbeddings(
        vids=paths,
        labels=vertices.labels[paths],
        degrees=vertices.degrees[paths],
        pde=vertices.vde[paths].reshape(p, l * d),
        pde_label=vertices.x[paths].reshape(p, l * d),
    )


def gen_query_pde_table(vertices: VertexEmbeddings, paths: np.ndarray):
    """Query-path table with weight and key (custom.h:576-599):
    weight = Σ path-vertex degrees; key = -Σ pde entries.
    Returns (PathEmbeddings, weight int64[P], key f64[P])."""
    pe = gen_pde(vertices, paths)
    weight = pe.degrees.astype(np.int64).sum(axis=1)
    key = -pe.pde.sum(axis=1)
    return pe, weight, key


def path_groups(vertices: VertexEmbeddings, start: np.ndarray,
                paths: np.ndarray, pde_dim: int):
    """PGE per-vertex path groups (GNN-PGE/src/main.cpp:95-177).

    Args:
      vertices: embeddings for the graph.
      start: int32[P] owning (start) vertex of each path.
      paths: int32[P, L] path vertex ids (paths from the same start need
        not be contiguous; we sort internally).
      pde_dim: L*D, used for the zero-padded degenerate boxes.

    Returns (group, label_group): f64[V, 2, pde_dim] where [:,0] is the
    per-dimension minimum and [:,1] the maximum over the vertex's paths.
    Vertices with no path get their own vde (padded with zeros) as a
    degenerate box (main.cpp:105-122).
    """
    v = vertices.num_vertices
    d = vertices.dim
    group = np.zeros((v, 2, pde_dim), dtype=np.float64)
    label_group = np.zeros((v, 2, pde_dim), dtype=np.float64)

    # Degenerate boxes for pathless vertices: vde/x in the first D dims,
    # zeros beyond.
    group[:, 0, :d] = vertices.vde
    group[:, 1, :d] = vertices.vde
    label_group[:, 0, :d] = vertices.x
    label_group[:, 1, :d] = vertices.x

    if len(start):
        pe = gen_pde(vertices, paths)
        order = np.argsort(start, kind="stable")
        s = start[order]
        emb = pe.pde[order]
        lemb = pe.pde_label[order]
        uniq, first = np.unique(s, return_index=True)
        group[uniq, 0] = np.minimum.reduceat(emb, first, axis=0)
        group[uniq, 1] = np.maximum.reduceat(emb, first, axis=0)
        label_group[uniq, 0] = np.minimum.reduceat(lemb, first, axis=0)
        label_group[uniq, 1] = np.maximum.reduceat(lemb, first, axis=0)
    return group, label_group


def path_groups_device(vertices: VertexEmbeddings, graph, order,
                       num_vertices_per_path: int, pde_dim: int,
                       chunk_starts: int = 65536):
    """Bit-exact PGE path groups with the fold on DEVICE, streaming.

    Scale problem (VERDICT r1): the host fold sorts all P paths and
    reduceat-folds f64 rows — at the patents rung P ≈ 2.5e9, which
    neither fits memory nor a 2-core host.  Device min/max folds would
    lose exactness in f32 (PGE's leaf compares are strict f64)...
    except min/max are SELECTIONS, not sums: mapping each vde value to
    its per-dimension RANK (int32) preserves order exactly, so the
    fold can run as jax segment_min/max over int32 ranks — bit-exact —
    and the winning ranks map back to f64 values on host.  Memory is
    O(V·pde_dim) regardless of P: paths are enumerated and folded in
    start-vertex chunks and never materialized.

    Reference semantics: GNN-PGE/src/main.cpp:95-177 (per-vertex
    min/max over all paths from the vertex; pathless vertices get the
    degenerate vde box padded with zeros, main.cpp:105-122).
    """
    import jax
    import jax.numpy as jnp
    from gnnpe_tpu.paths.enumerate import enumerate_paths_from

    v = vertices.num_vertices
    d = vertices.dim
    l = num_vertices_per_path

    # Per-dimension dense ranks of the vde/x value tables (host, O(V)).
    def rank_tables(table):
        ranks = np.empty((v, d), dtype=np.int32)
        uniqs = []
        for j in range(d):
            u, inv = np.unique(table[:, j], return_inverse=True)
            ranks[:, j] = inv
            uniqs.append(u)
        return ranks, uniqs

    vde_rank, vde_uniq = rank_tables(vertices.vde)
    x_rank, x_uniq = rank_tables(vertices.x)
    # Rank tables flow in as jit ARGUMENTS: closured device arrays
    # would be baked into the program as constants ([2e7, d] at the
    # synth100m rung).
    vr = jnp.asarray(vde_rank)
    xr = jnp.asarray(x_rank)
    big = np.int32(2 ** 31 - 1)

    @jax.jit
    def fold_chunk(paths, vr, xr, mn_v, mx_v, mn_x, mx_x):
        # Pad rows carry start vertex v: they fold into the discard
        # segment (index v) and never touch real vertices.
        seg = paths[:, 0]
        pv = jnp.take(vr, paths.reshape(-1), axis=0).reshape(
            paths.shape[0], l * d)
        px = jnp.take(xr, paths.reshape(-1), axis=0).reshape(
            paths.shape[0], l * d)
        mn_v = jnp.minimum(mn_v, jax.ops.segment_min(
            pv, seg, num_segments=v + 1)[:v])
        mx_v = jnp.maximum(mx_v, jax.ops.segment_max(
            pv, seg, num_segments=v + 1)[:v])
        mn_x = jnp.minimum(mn_x, jax.ops.segment_min(
            px, seg, num_segments=v + 1)[:v])
        mx_x = jnp.maximum(mx_x, jax.ops.segment_max(
            px, seg, num_segments=v + 1)[:v])
        return mn_v, mx_v, mn_x, mx_x

    mn_v = jnp.full((v, l * d), big)
    mx_v = jnp.full((v, l * d), -1, dtype=jnp.int32)
    mn_x = jnp.full((v, l * d), big)
    mx_x = jnp.full((v, l * d), -1, dtype=jnp.int32)
    order = np.asarray(order)
    for lo in range(0, len(order), chunk_starts):
        rows = enumerate_paths_from(graph, order[lo:lo + chunk_starts], l)
        if rows.shape[0] == 0:
            continue
        # Power-of-two row buckets: a data-dependent chunk shape would
        # recompile fold_chunk per chunk (~280 compiles at the
        # youtube rung); bucketed, the whole stream compiles
        # ~log2(spread) times.
        p_pad = 1 << max(0, (rows.shape[0] - 1).bit_length())
        if p_pad > rows.shape[0]:
            rows = np.concatenate(
                [rows, np.full((p_pad - rows.shape[0], l), v,
                               rows.dtype)])
        mn_v, mx_v, mn_x, mx_x = fold_chunk(
            jnp.asarray(rows), vr, xr, mn_v, mx_v, mn_x, mx_x)

    mn_v, mx_v = np.asarray(mn_v), np.asarray(mx_v)
    mn_x, mx_x = np.asarray(mn_x), np.asarray(mx_x)
    has_path = mx_v[:, 0] >= 0

    group = np.zeros((v, 2, pde_dim), dtype=np.float64)
    label_group = np.zeros((v, 2, pde_dim), dtype=np.float64)
    group[:, 0, :d] = vertices.vde
    group[:, 1, :d] = vertices.vde
    label_group[:, 0, :d] = vertices.x
    label_group[:, 1, :d] = vertices.x

    def unrank(ranks_mat, uniqs, out):
        for j in range(l * d):
            out[has_path, j] = uniqs[j % d][ranks_mat[has_path, j]]

    unrank(mn_v, vde_uniq, group[:, 0, :])
    unrank(mx_v, vde_uniq, group[:, 1, :])
    unrank(mn_x, x_uniq, label_group[:, 0, :])
    unrank(mx_x, x_uniq, label_group[:, 1, :])
    return group, label_group


def path_group_keys(group: np.ndarray) -> np.ndarray:
    """Query-vertex search key: -Σ lower bounds of the path group
    (GNN-PGE/src/main.cpp:325-329)."""
    return -group[:, 0, :].sum(axis=1)
