"""Rectangular binned-ELL gather-sum: out[dst] = Σ_{arcs} x[src].

The production single-chip layout (ops/ell.py BinnedEll) assumes a
square aggregation (input rows == output rows) and fuses its vertex
permutation across layers.  The sharded halo path needs the
RECTANGULAR generalization: each device aggregates arcs whose sources
live in an *extended* buffer (own rows + halo rows received from peers)
into its own output rows — input space ≠ output space.  This module
builds that layout with the same scatter-free recipe (degree classes,
head chunk-fold, mask-free pads, optional hub matmul) plus two
things the SPMD composition needs:

  * an explicit zero-degree tail (most rows of a halo-arc group have
    no arcs; they cost nothing instead of padding the smallest class);
  * :func:`pad_rect` / :func:`rect_pad_spec` — pad a group of
    per-shard layouts to a common shape so they stack into one
    ``[n_shards, ...]`` array per table and run under ``shard_map``
    with a single compiled program.

Output rows live in the layout's own class order; ``order``/``rank``
map caller dst ids to order-space positions.  Pad rows produced by
:func:`pad_rect` compute ≈0 (full pad-count correction; float
re-association leaves ~1e-5 relative residue) and are NEVER READ —
every consumer (gather tables, halo sends, hub columns, the final
vertex gather) references natural rows only — so the padded order
space can safely BE the per-device row space.

Reference contract being scaled: the aggregation is gen_vde's
neighbor sum (GNN-PE/include/custom.h:513-544) in its distributed,
trainable form (SURVEY.md §2.3).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np

from gnnpe_tpu.ops.ell import DEFAULT_WIDTHS, _HUB_PRECISIONS, \
    _hub_matmul, _padcnt, _select_hubs

_FOLD_W = 8     # head chunk-fold width (matches BinnedEll)


def _gather_sum(buf, tbl, padcnt):
    """Σ_k buf[tbl[:, k]] minus the pad-slot correction (pads → row 0)."""
    import jax.numpy as jnp
    tblj = jnp.asarray(tbl)
    g = jnp.take(buf, tblj.reshape(-1), axis=0).reshape(
        *tblj.shape, buf.shape[-1]).sum(1)
    if padcnt is not None:
        g = g - jnp.asarray(padcnt)[:, None] * buf[0]
    return g


@dataclass
class RectBinned:
    """Host-built plan; ``apply(x_src)`` returns ``[num_out, D]`` in
    order space (``out[p]`` is caller dst ``order[p]``)."""
    num_out: int                 # total order-space rows (incl. pads)
    num_dst: int                 # caller dst rows (== len(order))
    order: np.ndarray            # int64[num_dst] order position → dst id
    rank: np.ndarray             # int64[num_dst] dst id → order position
    num_head: int                # head rows (order positions [0, num_head))
    head_tables: List[np.ndarray]    # level 0: src ids; folds: prev rows
    head_padcnt: List[Optional[np.ndarray]]
    class_tables: List[np.ndarray]   # src ids, rows contiguous in order
    class_padcnt: List[Optional[np.ndarray]]
    num_zero: int                # trailing all-zero rows
    num_slots: int
    num_arcs: int
    num_hub_arcs: int = 0
    hub_rows: Optional[np.ndarray] = None    # int32[H] src ids
    hub_counts: Optional[np.ndarray] = None  # int8/16[num_out, H]
    hub_precision: str = "hi_lo"

    def apply(self, x_src):
        import jax.numpy as jnp
        parts = []
        if self.head_tables:
            cur = x_src
            for tbl, pc in zip(self.head_tables, self.head_padcnt):
                cur = _gather_sum(cur, tbl, pc)
            parts.append(cur)
        for tbl, pc in zip(self.class_tables, self.class_padcnt):
            parts.append(_gather_sum(x_src, tbl, pc))
        if self.num_zero:
            parts.append(jnp.zeros((self.num_zero, x_src.shape[-1]),
                                   x_src.dtype))
        out = (jnp.concatenate(parts, axis=0) if parts
               else jnp.zeros((self.num_out, x_src.shape[-1]),
                              x_src.dtype))
        if self.hub_rows is not None and len(self.hub_rows):
            xh = jnp.take(x_src, jnp.asarray(self.hub_rows), axis=0)
            out = out + _hub_matmul(jnp.asarray(self.hub_counts), xh,
                                    self.hub_precision, x_src.dtype)
        return out

    def unrank(self, out_order, dst_sentinel_ok: bool = False):
        """Gather order-space output back to caller dst order."""
        import jax.numpy as jnp
        return jnp.take(out_order, jnp.asarray(self.rank), axis=0)


def build_binned_rect(dst_offsets: np.ndarray, src_ids: np.ndarray,
                      num_src_rows: int,
                      widths: Tuple[int, ...] = DEFAULT_WIDTHS,
                      hub_matmul: bool = True,
                      feature_dim_hint: int = 128,
                      max_hubs: int = 2048,
                      hub_precision: str = "hi_lo",
                      hub_mem_budget: int = 256 << 20) -> RectBinned:
    """Build the rectangular layout from a dst-major CSR arc list
    (host, O(arcs)).  ``dst_offsets``: int[num_dst+1]; ``src_ids``:
    indices into the caller's source buffer ``[0, num_src_rows)``."""
    if tuple(sorted(set(widths))) != tuple(widths):
        raise ValueError(f"widths must be strictly increasing: {widths}")
    if hub_precision not in _HUB_PRECISIONS:
        raise ValueError(f"hub_precision {hub_precision!r}")
    offsets = np.asarray(dst_offsets, dtype=np.int64)
    src_ids = np.asarray(src_ids)
    num_dst = len(offsets) - 1
    num_arcs = len(src_ids)
    deg = np.diff(offsets)

    hub_rows = hub_counts = None
    num_hub_arcs = 0
    hubs = np.zeros(0, np.int64)
    if hub_matmul and num_dst and num_arcs:
        hubs = _select_hubs(num_src_rows, src_ids, feature_dim_hint,
                            max_hubs, hub_mem_budget)
        # B columns cost scales with num_dst rows, not src rows.
        hubs = hubs[:max(0, hub_mem_budget // max(1, num_dst))] \
            if len(hubs) else hubs
    if len(hubs):
        nh = len(hubs)
        hub_id = np.full(num_src_rows, -1, dtype=np.int64)
        hub_id[hubs] = np.arange(nh)
        arc_dst = np.repeat(np.arange(num_dst), deg)
        j = hub_id[src_ids]
        is_hub = j >= 0
        num_hub_arcs = int(is_hub.sum())
        key = arc_dst[is_hub] * nh + j[is_hub]
        uk, cnt = np.unique(key, return_counts=True)
        cmax = int(cnt.max(initial=0))
        assert cmax <= 32767, f"hub multiplicity {cmax} overflows int16"
        if cmax > 256 and hub_precision != "f32":
            hub_precision = "f32"
        B = np.zeros((num_dst, nh),
                     dtype=np.int8 if cmax <= 127 else np.int16)
        B[uk // nh, uk % nh] = cnt
        hub_counts = B
        hub_rows = hubs.astype(np.int32)
        keep = ~is_hub
        src_ids = src_ids[keep]
        deg = np.bincount(arc_dst[keep], minlength=num_dst)
        offsets = np.concatenate([[0], np.cumsum(deg)])

    wmax = widths[-1]
    order = np.argsort(-deg, kind="stable")
    rank = np.empty(num_dst, dtype=np.int64)
    rank[order] = np.arange(num_dst)
    deg_s = deg[order]
    if hub_counts is not None:
        hub_counts = hub_counts[order]      # B rows live in order space
    num_head = int((deg_s > wmax).sum())
    num_zero = int((deg_s == 0).sum())
    slots = 0

    head_tables: List[np.ndarray] = []
    head_padcnt: List[Optional[np.ndarray]] = []
    if num_head:
        h_deg = deg_s[:num_head]
        chunks_per = -(-h_deg // wmax)
        n_chunks = int(chunks_per.sum())
        tbl0 = np.full((n_chunks, wmax), -1, dtype=np.int32)
        c_start = np.cumsum(chunks_per) - chunks_per
        arc_v = np.repeat(np.arange(num_head), h_deg)
        starts = offsets[order[:num_head]]
        arc_pos = (np.arange(int(h_deg.sum()))
                   - np.repeat(np.cumsum(h_deg) - h_deg, h_deg))
        flat = src_ids[np.repeat(starts, h_deg) + arc_pos]
        tbl0[c_start[arc_v] + arc_pos // wmax, arc_pos % wmax] = flat
        pad0 = tbl0 < 0
        head_tables.append(np.where(pad0, 0, tbl0))
        head_padcnt.append(_padcnt(tbl0, pad0))
        slots += tbl0.size
        counts, start = chunks_per, c_start
        while True:
            kmax = int(counts.max())
            if kmax <= _FOLD_W:
                tbl = np.full((num_head, kmax), -1, dtype=np.int32)
                iv = np.repeat(np.arange(num_head), counts)
                pos = (np.arange(int(counts.sum()))
                       - np.repeat(start, counts))
                tbl[iv, pos] = np.arange(int(counts.sum()))
                pad = tbl < 0
                head_tables.append(np.where(pad, 0, tbl))
                head_padcnt.append(_padcnt(tbl, pad))
                slots += tbl.size
                break
            sub = -(-counts // _FOLD_W)
            s_start = np.cumsum(sub) - sub
            tbl = np.full((int(sub.sum()), _FOLD_W), -1, dtype=np.int32)
            iv = np.repeat(np.arange(num_head), counts)
            pos = np.arange(int(counts.sum())) - np.repeat(start, counts)
            tbl[s_start[iv] + pos // _FOLD_W,
                pos % _FOLD_W] = np.arange(int(counts.sum()))
            pad = tbl < 0
            head_tables.append(np.where(pad, 0, tbl))
            head_padcnt.append(_padcnt(tbl, pad))
            slots += tbl.size
            counts, start = sub, s_start

    class_tables: List[np.ndarray] = []
    class_padcnt: List[Optional[np.ndarray]] = []
    lo = num_head
    lowers = [0] + list(widths[:-1])
    for w, w_lo in zip(widths[::-1], lowers[::-1]):
        hi = lo + int(((deg_s[lo:] <= w) & (deg_s[lo:] > w_lo)).sum())
        n = hi - lo
        tbl = np.full((n, w), -1, dtype=np.int32)
        if n:
            d = deg_s[lo:hi]
            iv = np.repeat(np.arange(n), d)
            pos = np.arange(int(d.sum())) - np.repeat(np.cumsum(d) - d, d)
            starts = offsets[order[lo:hi]]
            tbl[iv, pos] = src_ids[np.repeat(starts, d) + pos]
        pad = tbl < 0
        class_tables.append(np.where(pad, 0, tbl))
        class_padcnt.append(_padcnt(tbl, pad))
        slots += tbl.size
        lo = hi
    assert lo + num_zero == num_dst, (lo, num_zero, num_dst)

    return RectBinned(num_out=num_dst, num_dst=num_dst, order=order,
                      rank=rank, num_head=num_head,
                      head_tables=head_tables, head_padcnt=head_padcnt,
                      class_tables=class_tables,
                      class_padcnt=class_padcnt, num_zero=num_zero,
                      num_slots=int(slots), num_arcs=num_arcs,
                      num_hub_arcs=num_hub_arcs, hub_rows=hub_rows,
                      hub_counts=hub_counts,
                      hub_precision=hub_precision)


# ---------------------------------------------------------------------
# SPMD padding: align a group of per-shard layouts to one shape.

@dataclass(frozen=True)
class RectPadSpec:
    head_levels: Tuple[Tuple[int, int], ...]   # (rows, width) per level
    num_head: int
    class_rows: Tuple[int, ...]
    num_zero: int
    num_hubs: int
    hub_dtype: object
    hub_precision: str

    @property
    def num_out(self) -> int:
        return self.num_head + sum(self.class_rows) + self.num_zero


def rect_pad_spec(layouts: Sequence[RectBinned]) -> RectPadSpec:
    """Joint padding spec: level counts aligned (identity levels appended
    to shallower heads), then per-level/per-class row maxima."""
    max_levels = max((len(l.head_tables) for l in layouts), default=0)
    num_head = max(l.num_head for l in layouts)
    heads = []
    for i in range(max_levels):
        rows = 0
        width = 1
        for l in layouts:
            lv = l.head_tables
            # Aligned view: shallower heads get identity levels at the
            # END, so level i of a depth-k head maps to i if i < k-1,
            # the last real level if i == k-1... identity after.
            if i < len(lv):
                rows = max(rows, lv[i].shape[0])
                width = max(width, lv[i].shape[1])
            else:
                rows = max(rows, l.num_head)
        heads.append((max(rows, num_head if i == max_levels - 1 else rows),
                      width))
    class_rows = tuple(
        max(l.class_tables[c].shape[0] for l in layouts)
        for c in range(len(layouts[0].class_tables)))
    num_zero = max(l.num_zero for l in layouts)
    num_hubs = max((0 if l.hub_rows is None else len(l.hub_rows))
                   for l in layouts)
    hub_dtype = np.int8
    precision = "hi_lo"
    for l in layouts:
        if l.hub_counts is not None and l.hub_counts.dtype == np.int16:
            hub_dtype = np.int16
        if l.hub_precision == "f32":
            precision = "f32"
    return RectPadSpec(head_levels=tuple(heads), num_head=num_head,
                       class_rows=class_rows, num_zero=num_zero,
                       num_hubs=num_hubs, hub_dtype=hub_dtype,
                       hub_precision=precision)


def pad_rect(layout: RectBinned, spec: RectPadSpec
             ) -> Tuple[RectBinned, np.ndarray]:
    """Pad ``layout`` to ``spec``; returns (padded, pos_map) where
    ``pos_map[p]`` is the padded position of natural order position p.
    Pad rows evaluate to exactly zero."""
    def pad_tbl(tbl, pc, rows, width):
        r, w = tbl.shape
        out = np.zeros((rows, width), tbl.dtype)
        out[:r, :w] = tbl
        cnt = np.zeros(rows, np.float32)
        if pc is not None:
            cnt[:r] = pc
        cnt[:r] += width - w          # widened slots are pads
        cnt[r:] = width               # full-pad rows
        return out, (cnt if cnt.any() else None)

    heads, head_pc = [], []
    if spec.head_levels:
        lv = list(zip(layout.head_tables, layout.head_padcnt))
        if not lv:      # no head in this shard: all-pad level 0
            lv = [(np.zeros((0, spec.head_levels[0][1]), np.int32),
                   None)]
        # Append identity levels to align depth.
        while len(lv) < len(spec.head_levels):
            h = lv[-1][0].shape[0] if len(lv) > 1 else layout.num_head
            h = max(h, layout.num_head)
            ident = np.arange(h, dtype=np.int32)[:, None]
            lv.append((ident, None))
        for (tbl, pc), (rows, width) in zip(lv, spec.head_levels):
            t, c = pad_tbl(tbl, pc, rows, width)
            heads.append(t)
            head_pc.append(c)

    classes, class_pc = [], []
    for (tbl, pc), rows in zip(
            zip(layout.class_tables, layout.class_padcnt),
            spec.class_rows):
        t, c = pad_tbl(tbl, pc, rows, tbl.shape[1])
        classes.append(t)
        class_pc.append(c)

    # Natural→padded position map.
    pos_map = np.empty(layout.num_dst, dtype=np.int64)
    off_nat = 0
    off_pad = 0
    segs_nat = [layout.num_head] + [t.shape[0]
                                    for t in layout.class_tables] \
        + [layout.num_zero]
    segs_pad = [spec.num_head] + list(spec.class_rows) + [spec.num_zero]
    for n_nat, n_pad in zip(segs_nat, segs_pad):
        pos_map[off_nat:off_nat + n_nat] = off_pad + np.arange(n_nat)
        off_nat += n_nat
        off_pad += n_pad
    assert off_nat == layout.num_dst

    hub_rows = hub_counts = None
    if spec.num_hubs:
        hub_rows = np.zeros(spec.num_hubs, np.int32)
        hub_counts = np.zeros((spec.num_out, spec.num_hubs),
                              spec.hub_dtype)
        if layout.hub_rows is not None and len(layout.hub_rows):
            h = len(layout.hub_rows)
            hub_rows[:h] = layout.hub_rows
            hub_counts[pos_map, :h] = layout.hub_counts

    new_rank = pos_map[layout.rank]            # dst id → padded pos
    new_order = np.full(spec.num_out, -1, dtype=np.int64)
    new_order[new_rank] = np.arange(layout.num_dst)
    return replace(
        layout, num_out=spec.num_out, num_head=spec.num_head,
        order=new_order, rank=new_rank,
        head_tables=heads, head_padcnt=head_pc, class_tables=classes,
        class_padcnt=class_pc, num_zero=spec.num_zero,
        hub_rows=hub_rows, hub_counts=hub_counts,
        hub_precision=spec.hub_precision), pos_map
