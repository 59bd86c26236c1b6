"""Distributed online candidate search over a device mesh.

The reference parallelizes the online search with one OpenMP thread per
METIS partition, each filling a private candidate set, merged serially
afterwards (GNN-PE/src/main.cpp:155-172, GNN-PGE/src/main.cpp:342-346).
The SPMD form shards the *entry table* (paths for PE, vertices
for PGE) across the mesh's "graph" axis and runs the dominance filter
as one shard_map'd masked compare; the union is either

  * ``union="host"``  — the bool[Q, P] pair mask concatenates across
    shards (out_specs P(None, axis)) and the host extracts candidates;
  * ``union="device"` — each device scatters its hits into a
    bool[Qv, V] vertex bitmap and the bitmaps OR-combine with a psum
    — the collective form of the reference's serial set union.
    O(Qv·V) output regardless of path count; the right choice at scale
    (P ~ 10^8 makes the pair mask itself the bottleneck).

Both unions are BIT-EXACT w.r.t. the f64 host filter: the dominance
comparisons run as three-limb f32 lexicographic compares
(match.device_filter.split3/ge3), which decide exactly as f64 — so PE
parity counts (SURVEY.md §0.3: candidate-set dependent!) hold under
any sharding and either union, with no host re-verification pass.
"""

from __future__ import annotations

import functools
from typing import List, Optional

import numpy as np

from gnnpe_tpu.match.filter import eps_threshold as _eps_threshold

from gnnpe_tpu.match.device_filter import (extract_candidates,
                                           pe_mask_device_exact,
                                           pge_mask_device_exact,
                                           split3)


def pad_rows(arr: np.ndarray, n_shards: int, fill) -> np.ndarray:
    """Pad the leading dim to a multiple of n_shards.  Label fills must
    differ between data (-2) and query (-1) sides: equal fills would
    let a padded query row "match" a padded data row and scatter a
    spurious (0, 0) hit into the device-union bitmap."""
    p = len(arr)
    per = -(-max(p, 1) // n_shards)
    pad = per * n_shards - p
    if pad == 0:
        return arr
    return np.concatenate(
        [arr, np.full((pad,) + arr.shape[1:], fill, arr.dtype)])


def _pad_q(arr: np.ndarray, pad: int, fill) -> np.ndarray:
    if not pad:
        return arr
    return np.concatenate(
        [arr, np.full((pad,) + arr.shape[1:], fill, arr.dtype)])


def _put_limbs(x_f64: np.ndarray, n: int, shard):
    """split3 + pad + device_put each limb with the given sharding."""
    import jax
    import jax.numpy as jnp
    return tuple(
        jax.device_put(jnp.asarray(pad_rows(limb, n, np.float32(0.0))),
                       shard)
        for limb in split3(x_f64))


class ShardedPESearch:
    """PE candidate search with the path table sharded over one mesh
    axis.  Device arrays are placed once at construction; each online
    query is a single jit'd shard_map dispatch with bit-exact f64
    dominance decisions (limb compare)."""

    def __init__(self, mesh, data_pde, axis: str = "graph",
                 base_epsilon: float = 1e-6):
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        self.mesh = mesh
        self.axis = axis
        self.num_paths = data_pde.num_paths
        self.base_epsilon = base_epsilon
        n = mesh.shape[axis]
        shard = NamedSharding(mesh, P(axis))
        self.d_labels = jax.device_put(
            jnp.asarray(pad_rows(data_pde.labels, n, -2)), shard)
        self.d_degrees = jax.device_put(
            jnp.asarray(pad_rows(data_pde.degrees, n, 0)), shard)
        self.d_pde3 = _put_limbs(data_pde.pde, n, shard)
        self.d_vids = jax.device_put(
            jnp.asarray(pad_rows(data_pde.vids, n, 0)), shard)
        self._host = data_pde
        self._mask_fn = None
        self._bitmap_fn = {}

    # -- union="host": exact pair mask ---------------------------------
    def _build_mask_fn(self):
        import jax
        from jax.sharding import PartitionSpec as P

        @functools.partial(
            jax.shard_map, mesh=self.mesh,
            in_specs=(P(self.axis), P(self.axis),
                      (P(self.axis),) * 3,
                      P(), P(), (P(),) * 3),
            out_specs=P(None, self.axis))
        def run(dl, dd, dp3, ql, qd, qt3):
            return pe_mask_device_exact(dl, dd, dp3, ql, qd, qt3)

        return jax.jit(run)

    def _query_arrays(self, query_pde, rows: np.ndarray):
        """Bucket the query-row count to the next power of two so the
        jit compiles once per bucket; build threshold limb triples."""
        import jax.numpy as jnp
        q = len(rows)
        qb = 1 << max(0, (q - 1).bit_length())
        pad = qb - q
        ql = jnp.asarray(_pad_q(query_pde.labels[rows], pad, -1))
        qd = jnp.asarray(_pad_q(query_pde.degrees[rows], pad, 0))
        thresh = _eps_threshold(query_pde.pde[rows],
                                self.base_epsilon)
        qt3 = tuple(jnp.asarray(_pad_q(limb, pad, np.float32(0.0)))
                    for limb in split3(thresh))
        return ql, qd, qt3, pad, q

    def search(self, query_pde, plan_rows: np.ndarray,
               num_query_vertices: int, union: str = "host"
               ) -> List[np.ndarray]:
        rows = np.asarray(plan_rows)
        ql, qd, qt3, pad, q = self._query_arrays(query_pde, rows)
        if union == "device":
            q_vids = _pad_q(query_pde.vids[rows], pad, 0)
            return self._search_device_union(
                ql, qd, qt3, q_vids, num_query_vertices, real_q=q)
        if self._mask_fn is None:
            self._mask_fn = self._build_mask_fn()
        mask = np.asarray(self._mask_fn(
            self.d_labels, self.d_degrees, self.d_pde3, ql, qd, qt3))
        mask = mask[:q, :self.num_paths]
        return extract_candidates(mask, self._host.vids,
                                  query_pde.vids[rows],
                                  num_query_vertices)

    # -- union="device": per-shard vertex bitmap + psum-OR -------------
    def _build_bitmap_fn(self, num_vertices: int, l: int, nq: int):
        import jax
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P
        axis = self.axis

        @functools.partial(
            jax.shard_map, mesh=self.mesh,
            in_specs=(P(axis), P(axis), (P(axis),) * 3, P(axis),
                      P(), P(), (P(),) * 3, P()),
            out_specs=P())
        def run(dl, dd, dp3, dv, ql, qd, qt3, qv):
            # mask[qi, p] over the local path shard — exact decisions
            m = pe_mask_device_exact(dl, dd, dp3, ql, qd, qt3)
            # fold hits straight onto (query-vertex, data-vertex):
            # out[qv[qi, k], dv[p, k]] |= m[qi, p]
            out = jnp.zeros((nq, num_vertices), dtype=jnp.int32)
            for k in range(l):       # l is tiny (path_length+1, ~3)
                out = out.at[qv[:, k][:, None], dv[None, :, k]].max(
                    m.astype(jnp.int32))
            return jax.lax.psum(out, axis)  # psum-as-OR: values ∈ {0,1}·n

        return jax.jit(run)

    def _search_device_union(self, ql, qd, qt3, q_vids,
                             num_query_vertices: int,
                             real_q: Optional[int] = None
                             ) -> List[np.ndarray]:
        # Padded query rows (label -1) match nothing, so they scatter
        # nothing; real_q is only for documentation.
        import jax.numpy as jnp
        l = q_vids.shape[1]
        key = (l, num_query_vertices)
        if key not in self._bitmap_fn:
            nv = int(self._host.vids.max(initial=0)) + 1
            self._bitmap_fn[key] = self._build_bitmap_fn(
                nv, l, num_query_vertices)
        out = np.asarray(self._bitmap_fn[key](
            self.d_labels, self.d_degrees, self.d_pde3, self.d_vids,
            ql, qd, qt3, jnp.asarray(q_vids)))
        return [np.nonzero(out[i])[0].astype(np.int64)
                for i in range(num_query_vertices)]


class ShardedPGESearch:
    """PGE candidate search with the vertex table sharded over one mesh
    axis.  The filter output *is* the per-query-vertex candidate mask
    (one entry per data vertex), so the shard outputs concatenate
    directly — no scatter needed.  Decisions are bit-exact f64 via
    limb compares against ``q_group_lo - base_epsilon`` (slack applied
    on host, in f64, before limb-splitting — see
    match/filter.py:pge_candidates for why the reference's strict
    compare, GNN-PGE custom.h:330-372, falsely prunes)."""

    def __init__(self, mesh, labels, degrees, group, label_group,
                 axis: str = "graph", base_epsilon: float = 1e-6):
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        self.mesh = mesh
        self.axis = axis
        self.base_epsilon = base_epsilon
        self.num_vertices = len(labels)
        n = mesh.shape[axis]
        shard = NamedSharding(mesh, P(axis))
        self.d_labels = jax.device_put(
            jnp.asarray(pad_rows(labels, n, -2)), shard)
        self.d_degrees = jax.device_put(
            jnp.asarray(pad_rows(degrees, n, 0)), shard)
        self.d_ghi3 = _put_limbs(group[:, 1, :], n, shard)
        self.d_llo3 = _put_limbs(label_group[:, 0, :], n, shard)
        self.d_lhi3 = _put_limbs(label_group[:, 1, :], n, shard)
        self._mask_fn = None

    def _build_mask_fn(self):
        import jax
        from jax.sharding import PartitionSpec as P

        @functools.partial(
            jax.shard_map, mesh=self.mesh,
            in_specs=(P(self.axis), P(self.axis)) +
                     ((P(self.axis),) * 3,) * 3 +
                     (P(), P()) + ((P(),) * 3,) * 3,
            out_specs=P(None, self.axis))
        def run(dl, dd, dghi3, dllo3, dlhi3, ql, qd, qglo3, qllo3, qlhi3):
            return pge_mask_device_exact(dl, dd, dghi3, dllo3, dlhi3,
                                         ql, qd, qglo3, qllo3, qlhi3)

        return jax.jit(run)

    def search(self, q_labels, q_degrees, q_group, q_label_group,
               q_vertex_ids) -> List[np.ndarray]:
        import jax.numpy as jnp
        if self._mask_fn is None:
            self._mask_fn = self._build_mask_fn()
        # Power-of-two query bucketing (one compile per bucket).
        q = len(q_labels)
        qb = 1 << max(0, (q - 1).bit_length())
        pad = qb - q
        ql = jnp.asarray(_pad_q(q_labels, pad, -1))
        qd = jnp.asarray(_pad_q(q_degrees, pad, 0))

        def limbs(x):
            return tuple(jnp.asarray(_pad_q(a, pad, np.float32(0.0)))
                         for a in split3(x))
        mask = np.asarray(self._mask_fn(
            self.d_labels, self.d_degrees,
            self.d_ghi3, self.d_llo3, self.d_lhi3,
            ql, qd, limbs(_eps_threshold(q_group[:, 0, :],
                          self.base_epsilon)),
            limbs(q_label_group[:, 0, :]),
            limbs(q_label_group[:, 1, :])))
        mask = mask[:q, :self.num_vertices]
        return [np.nonzero(mask[j])[0].astype(np.int64)
                for j, _ in enumerate(q_vertex_ids)]
