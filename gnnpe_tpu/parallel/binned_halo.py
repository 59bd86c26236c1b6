"""Scatter-free vertex-partitioned aggregation with overlapped halo
exchange — the production distributed layout (VERDICT r2 items 2/3).

parallel/halo.py proved the vertex-partitioned all_to_all exchange
correct but aggregated local arcs with ``jax.ops.segment_sum`` (a
scatter).  This module composes the exchange with the scatter-free
binned-ELL gather layout:

  * vertices are assigned shard-major rows (``own_pad`` uniform rows
    per shard; a vertex's row is its id rank within its shard);
  * one ``all_to_all`` ships exactly the boundary rows each neighbor
    consumes (O(cut·D));
  * per-shard arcs are split into a LOCAL group (source owned here)
    and a HALO group (source arrives in the exchange), each aggregated
    through a rectangular binned-ELL plan (ops/rect.py): degree
    classes + head chunk-fold + hub matmul — no scatter anywhere,
    forward or backward (the adjacency here is directed per-shard, but
    each group's gather tables serve as their own VJP via the same
    mechanism as ops.ell.symmetric_aggregate when symmetric).

Overlap: the device step issues the all_to_all FIRST, then computes
the local-group aggregation — which depends only on owned rows — so
XLA's latency-hiding scheduler runs the collective concurrently with
the local gathers; only the (small) halo-group aggregation waits on
the wire.  This is the north star's "all-to-all … overlapped with
local aggregation" (BASELINE.json).

Per-shard layouts are padded to a common shape (ops/rect.py
rect_pad_spec/pad_rect) and stacked, so ``shard_map`` compiles ONE
program.  Exactness: equals the dense aggregation row-for-row
(tests/test_parallel.py).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from gnnpe_tpu.ops.ell import DEFAULT_WIDTHS
from gnnpe_tpu.ops.rect import (RectBinned, _gather_sum, _hub_matmul,
                                build_binned_rect, pad_rect,
                                rect_pad_spec)


def _stack(layouts: List[RectBinned]):
    """Pad per-shard layouts to a joint spec and stack every table
    into one leading-[n] array; returns (stacked dict, per-shard
    padded rank arrays, spec)."""
    spec = rect_pad_spec(layouts)
    padded, ranks = [], []
    for lay in layouts:
        p, _ = pad_rect(lay, spec)
        padded.append(p)
        ranks.append(p.rank)

    def stk(get, dtype=None):
        return np.stack([np.asarray(get(p), dtype=dtype)
                         for p in padded])

    st = {
        "head_tables": [stk(lambda p, i=i: p.head_tables[i])
                        for i in range(len(spec.head_levels))],
        "head_padcnt": [stk(lambda p, i=i: (
            p.head_padcnt[i] if p.head_padcnt[i] is not None
            else np.zeros(p.head_tables[i].shape[0], np.float32)))
            for i in range(len(spec.head_levels))],
        "class_tables": [stk(lambda p, i=i: p.class_tables[i])
                         for i in range(len(spec.class_rows))],
        "class_padcnt": [stk(lambda p, i=i: (
            p.class_padcnt[i] if p.class_padcnt[i] is not None
            else np.zeros(p.class_tables[i].shape[0], np.float32)))
            for i in range(len(spec.class_rows))],
    }
    if spec.num_hubs:
        st["hub_rows"] = stk(lambda p: p.hub_rows)
        st["hub_counts"] = stk(lambda p: p.hub_counts)
    return st, ranks, spec


def _apply_stacked(x_src, st, num_zero: int, hub_precision: str):
    """Per-device apply of a stacked rect plan (leaves carry a leading
    [1] shard dim inside shard_map)."""
    import jax.numpy as jnp
    parts = []
    if st["head_tables"]:
        cur = x_src
        for tbl, pc in zip(st["head_tables"], st["head_padcnt"]):
            cur = _gather_sum(cur, tbl[0], pc[0])
        parts.append(cur)
    for tbl, pc in zip(st["class_tables"], st["class_padcnt"]):
        parts.append(_gather_sum(x_src, tbl[0], pc[0]))
    if num_zero:
        parts.append(jnp.zeros((num_zero, x_src.shape[-1]),
                               x_src.dtype))
    out = jnp.concatenate(parts, axis=0)
    if "hub_rows" in st:
        xh = jnp.take(x_src, st["hub_rows"][0], axis=0)
        out = out + _hub_matmul(st["hub_counts"][0], xh,
                                hub_precision, x_src.dtype)
    return out


@dataclass
class BinnedHaloPlan:
    num_shards: int
    own_pad: int
    halo_pad: int
    counts: np.ndarray          # int64[n] real vertices per shard
    shard_of: np.ndarray        # int64[V]
    local_row: np.ndarray       # int64[V] row within owner shard
    send_idx: np.ndarray        # int32[n, n, halo_pad]; -1 = unused slot
    local_stack: Dict           # stacked local-group rect plan
    halo_stack: Dict
    num_zero_l: int
    num_zero_h: int
    hub_precision_l: str
    hub_precision_h: str
    inv_local: np.ndarray       # int32[n, own_pad] own row → local order pos
    inv_halo: np.ndarray        # int32[n, own_pad] own row → halo order pos
    num_out_l: int              # local order-space rows (zero row appended)
    num_out_h: int
    num_local_arcs: int = 0
    num_halo_arcs: int = 0
    num_slots: int = 0

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, offsets: np.ndarray, neighbors: np.ndarray,
              membership: np.ndarray, num_shards: int,
              widths: Tuple[int, ...] = DEFAULT_WIDTHS,
              hub_matmul: bool = True,
              feature_dim_hint: int = 128) -> "BinnedHaloPlan":
        n = num_shards
        v = len(offsets) - 1
        offsets = np.asarray(offsets, dtype=np.int64)
        membership = np.asarray(membership, dtype=np.int64)
        counts = np.bincount(membership, minlength=n)
        own_pad = max(1, int(counts.max()))
        starts = np.cumsum(counts) - counts
        order_v = np.lexsort((np.arange(v), membership))
        local_row = np.empty(v, dtype=np.int64)
        local_row[order_v] = np.arange(v) - np.repeat(starts, counts)

        deg = np.diff(offsets)
        dst_old = np.repeat(np.arange(v), deg)
        src_old = np.asarray(neighbors)
        s_dst = membership[dst_old]
        s_src = membership[src_old]
        cross = s_src != s_dst

        # --- send sets + per-arc halo rows, fully vectorized ---------
        key = ((s_src[cross] * n + s_dst[cross]) * v
               + src_old[cross]).astype(np.int64)
        uk = np.unique(key)
        us = uk // (n * v)
        ut = (uk // v) % n
        uu = uk % v
        pair = us * n + ut
        pcnt = np.bincount(pair, minlength=n * n)
        halo_pad = max(1, int(pcnt.max()))
        pstart = (np.cumsum(pcnt) - pcnt)[pair]
        k_within = np.arange(len(uk)) - pstart
        send_idx = np.full((n, n, halo_pad), -1, dtype=np.int32)
        send_idx[us, ut, k_within] = local_row[uu]
        # Halo-buffer row (on the consumer) of every cross arc's src.
        j = np.searchsorted(uk, key)
        halo_row_of_arc = (us[j] * halo_pad + k_within[j])

        # --- per-shard CSRs for the two arc groups -------------------
        def shard_csrs(arc_mask, src_rows):
            """arc_mask selects arcs; src_rows gives their src index in
            the group's source space.  Returns per-shard (offsets,
            srcs) with dst = local row."""
            d_sh = s_dst[arc_mask]
            d_row = local_row[dst_old[arc_mask]]
            sr = src_rows
            o = np.lexsort((d_row, d_sh))
            d_sh, d_row, sr = d_sh[o], d_row[o], sr[o]
            cuts = np.searchsorted(d_sh, np.arange(n + 1))
            out = []
            for t in range(n):
                lo, hi = cuts[t], cuts[t + 1]
                cnt = np.bincount(d_row[lo:hi],
                                  minlength=max(1, int(counts[t])))
                offs_t = np.concatenate([[0], np.cumsum(cnt)])
                out.append((offs_t, sr[lo:hi].astype(np.int32)))
            return out

        local_csrs = shard_csrs(~cross, local_row[src_old[~cross]])
        halo_csrs = shard_csrs(cross, halo_row_of_arc)

        locals_ = [build_binned_rect(
            o, s, own_pad, widths=widths, hub_matmul=hub_matmul,
            feature_dim_hint=feature_dim_hint)
            for o, s in local_csrs]
        halos = [build_binned_rect(
            o, s, n * halo_pad, widths=widths, hub_matmul=hub_matmul,
            feature_dim_hint=feature_dim_hint)
            for o, s in halo_csrs]

        local_stack, lranks, lspec = _stack(locals_)
        halo_stack, hranks, hspec = _stack(halos)

        def inv(ranks, spec):
            # own row r → order position; rows ≥ v_t → zero-row
            # sentinel (index spec.num_out, appended at apply time).
            arr = np.full((n, own_pad), spec.num_out, dtype=np.int32)
            for t in range(n):
                arr[t, :len(ranks[t])] = ranks[t]
            return arr

        return cls(
            num_shards=n, own_pad=own_pad, halo_pad=halo_pad,
            counts=counts, shard_of=membership, local_row=local_row,
            send_idx=send_idx, local_stack=local_stack,
            halo_stack=halo_stack, num_zero_l=lspec.num_zero,
            num_zero_h=hspec.num_zero,
            hub_precision_l=lspec.hub_precision,
            hub_precision_h=hspec.hub_precision,
            inv_local=inv(lranks, lspec), inv_halo=inv(hranks, hspec),
            num_out_l=lspec.num_out, num_out_h=hspec.num_out,
            num_local_arcs=int((~cross).sum()),
            num_halo_arcs=int(cross.sum()),
            num_slots=sum(l.num_slots for l in locals_ + halos))

    # ------------------------------------------------------------------
    def shard_features(self, x: np.ndarray) -> np.ndarray:
        """Host: [V, D] → [n, own_pad, D] (row = per-shard id rank)."""
        n, d = self.num_shards, x.shape[1]
        out = np.zeros((n, self.own_pad, d), dtype=x.dtype)
        out[self.shard_of, self.local_row] = x
        return out

    def unshard_features(self, shards: np.ndarray) -> np.ndarray:
        return np.asarray(shards)[self.shard_of, self.local_row]

    def row_of_vertex(self) -> np.ndarray:
        """int32[V]: flat row in the all-gathered [n*own_pad, D]."""
        return (self.shard_of * self.own_pad
                + self.local_row).astype(np.int32)

    def own_vertex_ids(self) -> np.ndarray:
        """int32[n, own_pad]: original vertex id at each owned row
        (pad rows → 0; their values are never read downstream)."""
        out = np.zeros((self.num_shards, self.own_pad), np.int32)
        out[self.shard_of, self.local_row] = np.arange(
            len(self.shard_of), dtype=np.int32)
        return out

    # ------------------------------------------------------------------
    def device_args(self):
        """Pytree of arrays the aggregation needs (pass as shard_map
        ARGS, never closures — see utils/compile_cache notes)."""
        import jax.numpy as jnp
        tree = {
            "send": jnp.asarray(self.send_idx),
            "local": {k: [jnp.asarray(a) for a in vv]
                      if isinstance(vv, list) else jnp.asarray(vv)
                      for k, vv in self.local_stack.items()},
            "halo": {k: [jnp.asarray(a) for a in vv]
                     if isinstance(vv, list) else jnp.asarray(vv)
                     for k, vv in self.halo_stack.items()},
            "inv_l": jnp.asarray(self.inv_local),
            "inv_h": jnp.asarray(self.inv_halo),
        }
        return tree

    def arg_specs(self, axis: str):
        """Matching PartitionSpec pytree: every leaf is stacked on the
        shard dim except send_idx (every device needs its own ROW of
        sends, which is exactly the shard dim again)."""
        import jax
        from jax.sharding import PartitionSpec as P
        return jax.tree.map(lambda _: P(axis), self.device_args())

    def make_device_fn(self, axis: str):
        """Per-device aggregation closure over STATIC metadata only
        (ints/strings); arrays arrive via ``args``.  x_own: [own_pad,
        D] (this device's block, no leading shard dim)."""
        import jax
        import jax.numpy as jnp
        nz_l, nz_h = self.num_zero_l, self.num_zero_h
        hp_l, hp_h = self.hub_precision_l, self.hub_precision_h
        n, hpad = self.num_shards, self.halo_pad

        def agg(x_own, args):
            d = x_own.shape[-1]
            # 1) issue the exchange FIRST: gather send rows, all_to_all.
            sidx = args["send"][0]                    # [n, halo_pad]
            # Unused slots (sidx == -1) ship exact ZEROS, not x_own[0]
            # junk — the pad-correction rows downstream then cancel
            # exactly instead of leaving an |x_own[0]|-scaled residue
            # (ADVICE r3 item 2; halo.py's agg masks the same way).
            send_rows = jnp.where(
                (sidx >= 0).reshape(-1)[:, None],
                jnp.take(x_own, jnp.maximum(sidx, 0).reshape(-1),
                         axis=0), 0.0).reshape(n, hpad, d)
            halo = jax.lax.all_to_all(send_rows, axis, split_axis=0,
                                      concat_axis=0, tiled=True)
            halo_buf = halo.reshape(n * hpad, d)
            # 2) local aggregation — independent of the collective, so
            # the scheduler overlaps it with the wire.
            local_out = _apply_stacked(x_own, args["local"], nz_l, hp_l)
            # 3) halo aggregation waits on the exchange.
            halo_out = _apply_stacked(halo_buf, args["halo"], nz_h, hp_h)
            zero = jnp.zeros((1, d), x_own.dtype)
            out = (jnp.take(jnp.concatenate([local_out, zero], 0),
                            args["inv_l"][0], axis=0)
                   + jnp.take(jnp.concatenate([halo_out, zero], 0),
                              args["inv_h"][0], axis=0))
            return out

        return agg

    def make_aggregate(self, mesh, axis: str = "graph"):
        """[n, own_pad, D] sharded on ``axis`` → same; one compiled
        SPMD program."""
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

        # args flow in as jit ARGUMENTS, not closured device arrays
        # (which would be baked into the program as constants).
        jitted = jax.jit(run)
        return lambda x: jitted(x, args)
