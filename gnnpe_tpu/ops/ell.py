"""Hierarchical ELLPACK aggregation: scatter-free neighbor sums.

This layout removes the scatter from the neighbor sum: neighbors are packed into fixed-width tables and the
aggregation becomes dense gathers + axis sums.

Level structure (power-law safe): each vertex's adjacency is split
into ceil(deg/K) *chunks* of ≤K neighbors.  Level 1 computes one
partial sum per chunk (gather [C, K] rows → sum axis 1).  Level 2 sums
each vertex's ≤ceil(max_deg/K) chunk rows through a second ELL table —
recursively if a tail vertex still exceeds the width.  All shapes are
static; everything jits and shards.

The layout is built once per graph (host) and reused across layers /
training steps — the analogue of the reference building its R-tree
once per partition (custom.h:235-257).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


@dataclass
class EllLayout:
    """One gather-sum level: out[i] = Σ_k in[tbl[i,k]] * (tbl[i,k]>=0).
    Index -1 marks padding (mapped to row 0 and masked)."""
    tbl: np.ndarray        # int32[N, K]

    @property
    def num_rows(self) -> int:
        return self.tbl.shape[0]


@dataclass
class HierarchicalEll:
    levels: List[EllLayout]
    num_vertices: int
    num_slots: int          # total gather slots (padding overhead metric)
    slot_arc: np.ndarray = None   # int32[level-1 slots]: CSR arc index
    #                               per slot, -1 pad (ops/sddmm.py)

    def apply(self, x, *, dtype=None):
        """Aggregate neighbor features: returns [V, D]."""
        import jax.numpy as jnp
        h = x if dtype is None else x.astype(dtype)
        for lvl in self.levels:
            tbl = jnp.asarray(lvl.tbl)
            idx = jnp.maximum(tbl, 0)
            mask = (tbl >= 0)
            g = jnp.take(h, idx.reshape(-1), axis=0).reshape(
                *tbl.shape, h.shape[-1])
            h = jnp.where(mask[..., None], g, 0.0).sum(axis=1)
        return h


def build_ell(offsets: np.ndarray, neighbors: np.ndarray,
              width: int = 8, level2_width: int = 8) -> HierarchicalEll:
    """Build the hierarchical layout from CSR (host, O(E))."""
    num_v = len(offsets) - 1
    deg = np.diff(offsets).astype(np.int64)

    # ---- level 1: chunks of ≤width neighbors -------------------------
    chunks_per_v = np.maximum(-(-deg // width), 1)
    c_of_v_end = np.cumsum(chunks_per_v)
    c_of_v_start = c_of_v_end - chunks_per_v
    num_chunks = int(c_of_v_end[-1])

    tbl1 = np.full((num_chunks, width), -1, dtype=np.int32)
    # Chunk row r of vertex v covers neighbors [offsets[v]+ (r-start)*W ...]
    # Vectorized fill: for each slot position j, the arcs at position
    # j within their chunk.
    arc_v = np.repeat(np.arange(num_v), deg)
    arc_pos = np.arange(len(neighbors)) - np.repeat(offsets[:-1], deg)
    chunk_row = c_of_v_start[arc_v] + arc_pos // width
    slot = arc_pos % width
    tbl1[chunk_row, slot] = neighbors
    slot_arc = np.full(tbl1.size, -1, dtype=np.int32)
    slot_arc[chunk_row * width + slot] = np.arange(len(neighbors))

    levels = [EllLayout(tbl1)]
    slots = tbl1.size

    # ---- level 2+: fold chunk rows per vertex ------------------------
    cur_counts = chunks_per_v
    cur_start = c_of_v_start
    while True:
        kmax = int(cur_counts.max()) if num_v else 1
        if kmax <= level2_width:
            tbl = np.full((num_v, level2_width), -1, dtype=np.int32)
            item_v = np.repeat(np.arange(num_v), cur_counts)
            pos = (np.arange(int(cur_counts.sum()))
                   - np.repeat(cur_start, cur_counts))
            tbl[item_v, pos] = np.arange(int(cur_counts.sum()))
            levels.append(EllLayout(tbl))
            slots += tbl.size
            break
        # Another chunking level over the chunk rows.
        n_items = int(cur_counts.sum())
        sub = np.maximum(-(-cur_counts // level2_width), 1)
        sub_end = np.cumsum(sub)
        sub_start = sub_end - sub
        n_sub = int(sub_end[-1])
        tbl = np.full((n_sub, level2_width), -1, dtype=np.int32)
        item_v = np.repeat(np.arange(num_v), cur_counts)
        pos = np.arange(n_items) - np.repeat(cur_start, cur_counts)
        row = sub_start[item_v] + pos // level2_width
        tbl[row, pos % level2_width] = np.arange(n_items)
        levels.append(EllLayout(tbl))
        slots += tbl.size
        cur_counts = sub
        cur_start = sub_start

    return HierarchicalEll(levels=levels, num_vertices=num_v,
                           num_slots=int(slots), slot_arc=slot_arc)


def ell_neighbor_sum(layout: HierarchicalEll, x):
    return layout.apply(x)


# ---------------------------------------------------------------------
# Degree-binned relabeled ELL ("sliced ELL"): the production layout.
#
# It was chosen where XLA's scatter (segment_sum) ran an order of
# magnitude slower than its row gather; the uniform-width ELL above
# also pays its padding ratio (2.4x on power-law graphs) directly in
# throughput.  Whether either still holds on the GPU is what
# chip_smoke.py's SpMM phase times (ROADMAP Design 5).  This layout
# removes both costs:
#   * vertices are RELABELED in degree-descending order, so
#     same-width classes are contiguous output ranges — every class
#     result concatenates in place, no scatter and no inverse permute
#     inside the layer loop;
#   * each class packs vertices whose (residual) degree fits its
#     width; padding is bounded by the class-step ratio plus the
#     min-width floor (degree-d rows pad to the smallest class >= d,
#     so low-degree graphs pay more: 1.37x on the power-law bench,
#     1.5x on Test/ — still far below uniform width-8's 2.4-4.4x);
#   * degrees above the widest class are chunked and folded through a
#     small recursive second level (only the power-law head pays it).

# Width classes: finer classes cut padding but pay per-op dispatch.
# (4,8,16,32,64) was the best of earlier sweeps at D=128 on the
# power-law bench; it is unmeasured on the GPU.  With the hub path on,
# the hub extraction empties the ≥64 tail anyway, so the choice only
# matters for hub_matmul=False graphs.
DEFAULT_WIDTHS = (4, 8, 16, 32, 64)

_HUB_PRECISIONS = ("hi_lo", "bf16", "f32")


def _split_hi_lo(x):
    """f32 → (hi, lo) bf16 pair with hi + lo = x to ~2^-16 relative.

    hi is x with its low 16 bits cleared, made by bit masking, so it
    is exact in bf16 and lo = x - hi is exact in f32.  A bf16 round
    trip (x.astype(bf16).astype(f32)) would not do: XLA may drop that
    round trip as excess precision (the GPU default), leaving lo = 0
    and the sum at bf16 accuracy."""
    import jax
    import jax.numpy as jnp
    bits = jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.uint32)
    hi = jax.lax.bitcast_convert_type(bits & jnp.uint32(0xFFFF0000),
                                      jnp.float32)
    return hi.astype(jnp.bfloat16), (x - hi).astype(jnp.bfloat16)


def _hub_matmul(B, xh, precision, out_dtype):
    """Σ_j B[:, j] * xh[j] on the matrix units (see BinnedEll hub-path
    notes).  B holds integer multiplicities; counts ≤ 256 are exact in
    bf16."""
    import jax
    import jax.numpy as jnp
    dims = (((1,), (0,)), ((), ()))
    if precision == "f32":
        return jax.lax.dot_general(
            B.astype(jnp.float32), xh.astype(jnp.float32), dims,
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32).astype(out_dtype)
    Bb = B.astype(jnp.bfloat16)
    if precision == "hi_lo" and xh.dtype != jnp.bfloat16:
        hi, lo = _split_hi_lo(xh)
        out = (jax.lax.dot_general(Bb, hi, dims,
                                   preferred_element_type=jnp.float32)
               + jax.lax.dot_general(Bb, lo, dims,
                                     preferred_element_type=jnp.float32))
    else:
        out = jax.lax.dot_general(Bb, xh.astype(jnp.bfloat16), dims,
                                  preferred_element_type=jnp.float32)
    return out.astype(out_dtype)


@dataclass
class BinnedEll:
    """Permutation-fused binned layout (+ optional matmul hub path).

    apply_perm(h_perm) aggregates in the permuted vertex space:
    h_perm[i] = x[perm[i]]; returns out_perm with out_perm[i] =
    Σ_{u ∈ N(perm[i])} x[u].  apply(x) adds the boundary permutes.

    Mask-free padding: pad slots in every gather table point at row 0,
    and the spurious contribution is removed with a rank-1 correction
    ``out[i] -= padcnt[i] * buf[0]``.  This replaces the per-slot
    where-mask (a [n, w, D] select) with a [n, D] fused multiply-sub.

    Hub path: a row gather pays per row, so on power-law graphs the
    few hundred highest-occurrence *sources* — which account for ~25%
    of all arcs — are pulled out of the gather tables entirely and
    their contribution computed by the matrix units as
    ``B @ x[hubs]`` where
    ``B[i, j]`` counts hub j in N(perm[i]) (int8/int16, converted to
    bf16 in-register).  Removing hubs also shrinks residual degrees,
    cutting ELL padding.

    Hub-path numerics (precision per mode, measured on signed inputs):
      * ``hi_lo`` (default): bf16 hi/lo split, two matmuls with f32
        accumulation.  The two-term split leaves a ~2^-16 (~1.5e-5)
        per-addend residual; under cancellation of signed features the
        worst case grows to ~1e-3 relative — fine for training and for
        candidate *filtering* (any superset is corrected by refinement)
        but NOT a bit-exactness guarantee.  Exact-parity consumers
        (VDE/PDE stage) do not use this layout at all.
      * ``f32``: f32 matmul with precision=HIGHEST (auto-selected when
        any multiplicity exceeds 256, where bf16 counts would round).
      * ``bf16``: single bf16 matmul, cheapest, for bf16 activations.
    """
    perm: np.ndarray            # int64[V]: new row i holds vertex perm[i]
    rank: np.ndarray            # int64[V]: inverse (rank[v] = row of v)
    class_tables: List[np.ndarray]  # int32[n_c, w_c], rows contiguous
    class_padcnt: List[np.ndarray]  # f32[n_c] or None (no padding)
    head_tables: List[np.ndarray]   # chunk fold levels for the head
    head_padcnt: List[np.ndarray]   # f32[rows] or None, per fold level
    num_head: int               # head vertices (first rows of output)
    num_vertices: int
    num_slots: int              # gather slots over RESIDUAL (non-hub) arcs
    num_hub_arcs: int = 0       # arcs routed through the matmul hub path
    hub_rows: np.ndarray = None     # int32[H]: permuted rows of hubs
    hub_counts: np.ndarray = None   # int8/int16[V, H] multiplicity B
    hub_precision: str = "hi_lo"    # see class docstring

    def _hub_part(self, h_perm):
        import jax.numpy as jnp
        xh = jnp.take(h_perm, jnp.asarray(self.hub_rows), axis=0)
        return _hub_matmul(jnp.asarray(self.hub_counts), xh,
                           self.hub_precision, h_perm.dtype)

    @staticmethod
    def _gather_sum(buf, tbl, padcnt):
        """Σ_k buf[tbl[:, k]] minus the pad-slot correction."""
        import jax.numpy as jnp
        tblj = jnp.asarray(tbl)
        g = jnp.take(buf, tblj.reshape(-1), axis=0).reshape(
            *tblj.shape, buf.shape[-1]).sum(1)
        if padcnt is not None:
            g = g - jnp.asarray(padcnt)[:, None] * buf[0]
        return g

    def apply_perm(self, h_perm):
        import jax.numpy as jnp
        parts = []
        if self.num_head:
            cur = h_perm
            for tbl, pc in zip(self.head_tables, self.head_padcnt):
                cur = self._gather_sum(cur, tbl, pc)
            parts.append(cur)
        for tbl, pc in zip(self.class_tables, self.class_padcnt):
            parts.append(self._gather_sum(h_perm, tbl, pc))
        out = jnp.concatenate(parts, axis=0) if parts else \
            jnp.zeros_like(h_perm)
        if self.hub_rows is not None and len(self.hub_rows):
            out = out + self._hub_part(h_perm)
        return out

    def permute(self, x):
        import jax.numpy as jnp
        return jnp.take(x, jnp.asarray(self.perm), axis=0)

    def unpermute(self, h_perm):
        import jax.numpy as jnp
        return jnp.take(h_perm, jnp.asarray(self.rank), axis=0)

    def apply(self, x, *, dtype=None):
        h = x if dtype is None else x.astype(dtype)
        return self.unpermute(self.apply_perm(self.permute(h)))


def _select_hubs(num_v: int, neighbors: np.ndarray, feature_dim: int,
                 max_hubs: int, hub_mem_budget: int):
    """Pick hub sources worth routing through the matrix units.

    Include vertex i (by occurrence count in ``neighbors``) while the
    gather time its arcs would cost (per-row cost from the device's
    published peaks, utils/device_probe) exceeds the marginal cost of
    one more B column: V int8 bytes of memory traffic plus two bf16
    [V,1]x[1,D] matmul slivers.  The hub count is additionally capped
    so the dense B matrix fits ``hub_mem_budget`` bytes (int8 on
    device)."""
    from gnnpe_tpu.utils.device_probe import device_constants
    bw, flops, gather_row_s = device_constants(feature_dim)
    occ = np.bincount(neighbors, minlength=num_v).astype(np.int64)
    col_cost_s = num_v / bw + 4.0 * num_v * feature_dim / flops
    thresh = max(4.0, col_cost_s / gather_row_s)
    order = np.argsort(-occ, kind="stable")
    n = int((occ[order] > thresh).sum())
    n = min(n, max_hubs, num_v, max(0, hub_mem_budget // max(1, num_v)))
    return order[:n]


def _padcnt(tbl_filled: np.ndarray, pad_mask: np.ndarray):
    """f32 pad-slot count per row, or None when the table is full."""
    cnt = pad_mask.sum(1)
    return cnt.astype(np.float32) if cnt.any() else None


def build_binned_ell(offsets: np.ndarray, neighbors: np.ndarray,
                     widths: Tuple[int, ...] = DEFAULT_WIDTHS,
                     hub_matmul: bool = True,
                     feature_dim_hint: int = 128,
                     max_hubs: int = 2048,
                     hub_precision: str = "hi_lo",
                     hub_mem_budget: int = 256 << 20) -> BinnedEll:
    """Build the degree-binned relabeled layout (host, O(E log V)).

    With ``hub_matmul`` the top-occurrence sources are lifted out of
    the gather tables into a dense count matrix contracted by a matmul
    (see BinnedEll docstring); the ELL tables are then built over the
    residual adjacency.  ``feature_dim_hint`` only tunes the hub-count
    economics; any D works at apply time.  ``hub_mem_budget`` caps the
    dense B matrix (bytes, int8) so power-law graphs at V≈1e6+ cannot
    OOM the build.  When any hub multiplicity exceeds 256, a caller-
    supplied bf16 ``hub_precision`` is auto-upgraded to "f32" (bf16
    integer rounding starts at 257); pass hub_matmul=False to opt out.
    """
    if tuple(sorted(set(widths))) != tuple(widths):
        raise ValueError(f"widths must be strictly increasing: {widths}")
    if hub_precision not in _HUB_PRECISIONS:
        raise ValueError(f"hub_precision {hub_precision!r} not in "
                         f"{_HUB_PRECISIONS}")
    num_v = len(offsets) - 1
    offsets = np.asarray(offsets, dtype=np.int64)
    neighbors = np.asarray(neighbors)

    hub_rows = hub_counts = None
    num_hub_arcs = 0
    if hub_matmul and num_v and len(neighbors):
        hubs = _select_hubs(num_v, neighbors, feature_dim_hint,
                            max_hubs, hub_mem_budget)
        if len(hubs):
            nh = len(hubs)
            hub_id = np.full(num_v, -1, dtype=np.int64)
            hub_id[hubs] = np.arange(nh)
            arc_dst = np.repeat(np.arange(num_v),
                                np.diff(offsets).astype(np.int64))
            j = hub_id[neighbors]
            is_hub = j >= 0
            num_hub_arcs = int(is_hub.sum())
            # Sparse count build: O(hub_arcs) transient memory, then a
            # single dense int8/int16 [V, H] fill (the matrix the matmul
            # needs anyway, capped by hub_mem_budget in _select_hubs).
            key = arc_dst[is_hub] * nh + j[is_hub]
            uk, cnt = np.unique(key, return_counts=True)
            cmax = int(cnt.max(initial=0))
            assert cmax <= 32767, \
                f"hub multiplicity {cmax} overflows int16"
            # bf16 holds integers exactly only up to 256; past that the
            # conversion in apply would silently round multiplicities.
            if cmax > 256 and hub_precision != "f32":
                hub_precision = "f32"
            B = np.zeros((num_v, nh),
                         dtype=np.int8 if cmax <= 127 else np.int16)
            B[uk // nh, uk % nh] = cnt
            hub_counts = B
            # Residual adjacency: drop hub occurrences.
            keep = ~is_hub
            neighbors = neighbors[keep]
            rdeg = np.bincount(arc_dst[keep],
                               minlength=num_v).astype(np.int64)
            offsets = np.concatenate([[0], np.cumsum(rdeg)])
            hub_vertices = hubs

    deg = np.diff(offsets).astype(np.int64)
    wmax = widths[-1]
    # Degree-descending stable order; rank = inverse permutation.
    perm = np.argsort(-deg, kind="stable")
    rank = np.empty(num_v, dtype=np.int64)
    rank[perm] = np.arange(num_v)
    deg_s = deg[perm]
    num_head = int((deg_s > wmax).sum())
    slots = 0

    # ---- head: chunk into width-wmax rows, fold recursively ---------
    head_tables: List[np.ndarray] = []
    head_padcnt: List[np.ndarray] = []
    if num_head:
        h_deg = deg_s[:num_head]
        chunks_per = -(-h_deg // wmax)
        n_chunks = int(chunks_per.sum())
        tbl0 = np.full((n_chunks, wmax), -1, dtype=np.int32)
        c_start = np.cumsum(chunks_per) - chunks_per
        arc_v = np.repeat(np.arange(num_head), h_deg)
        starts = offsets[perm[:num_head]]
        arc_pos = (np.arange(int(h_deg.sum()))
                   - np.repeat(np.cumsum(h_deg) - h_deg, h_deg))
        flat_nbr = neighbors[np.repeat(starts, h_deg) + arc_pos]
        tbl0[c_start[arc_v] + arc_pos // wmax,
             arc_pos % wmax] = rank[flat_nbr]
        pad0 = tbl0 < 0
        head_tables.append(np.where(pad0, 0, tbl0))
        head_padcnt.append(_padcnt(tbl0, pad0))
        slots += tbl0.size
        # Fold chunk rows per head vertex (recursively if very deep).
        counts, start = chunks_per, c_start
        fold_w = 8
        while True:
            kmax = int(counts.max())
            if kmax <= fold_w:
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
            sub = -(-counts // fold_w)
            s_start = np.cumsum(sub) - sub
            tbl = np.full((int(sub.sum()), fold_w), -1, dtype=np.int32)
            iv = np.repeat(np.arange(num_head), counts)
            pos = np.arange(int(counts.sum())) - np.repeat(start, counts)
            tbl[s_start[iv] + pos // fold_w,
                pos % fold_w] = np.arange(int(counts.sum()))
            pad = tbl < 0
            head_tables.append(np.where(pad, 0, tbl))
            head_padcnt.append(_padcnt(tbl, pad))
            slots += tbl.size
            counts, start = sub, s_start

    # ---- width classes over the rest (contiguous ranges) ------------
    class_tables: List[np.ndarray] = []
    class_padcnt: List[np.ndarray] = []
    lo = num_head
    bounds = list(widths[::-1])
    lowers = [0] + list(widths[:-1])
    for w, w_lo in zip(bounds, lowers[::-1]):
        # vertices with w_lo < deg <= w (deg_s descending ⇒ contiguous)
        hi = lo + int(((deg_s[lo:] <= w) & (deg_s[lo:] > w_lo)).sum())
        if w == widths[0]:      # smallest class also takes deg < w_lo+1
            hi = lo + int((deg_s[lo:] <= w).sum())
        n = hi - lo
        if n == 0:
            lo = hi
            continue
        tbl = np.full((n, w), -1, dtype=np.int32)
        d = deg_s[lo:hi]
        iv = np.repeat(np.arange(n), d)
        pos = np.arange(int(d.sum())) - np.repeat(np.cumsum(d) - d, d)
        starts = offsets[perm[lo:hi]]
        flat_nbr = neighbors[np.repeat(starts, d) + pos]
        tbl[iv, pos] = rank[flat_nbr]
        pad = tbl < 0
        class_tables.append(np.where(pad, 0, tbl))
        class_padcnt.append(_padcnt(tbl, pad))
        slots += tbl.size
        lo = hi
    assert lo == num_v, (lo, num_v)

    if hub_counts is not None:
        hub_counts = hub_counts[perm]           # rows in permuted space
        hub_rows = rank[hub_vertices].astype(np.int32)
    return BinnedEll(perm=perm, rank=rank, class_tables=class_tables,
                     class_padcnt=class_padcnt, head_tables=head_tables,
                     head_padcnt=head_padcnt, num_head=num_head,
                     num_vertices=num_v, num_slots=int(slots),
                     num_hub_arcs=num_hub_arcs,
                     hub_rows=hub_rows, hub_counts=hub_counts,
                     hub_precision=hub_precision)


def symmetric_aggregate(layout: BinnedEll):
    """Scatter-free aggregation with a scatter-free GRADIENT.

    jnp.take's autodiff transpose is a scatter-add — the op the whole
    layout exists to avoid (XLA serializes it ~10x slower than the
    gather).  For a symmetric adjacency A = Aᵀ the cotangent pullback
    of h ↦ A_perm h is A_perm itself, so the backward pass can reuse
    the same gather tables.  Returns agg(h_perm) for use inside the
    permuted vertex space (models inject it as their ``aggregate``).
    """
    import jax

    @jax.custom_vjp
    def agg(h_perm):
        return layout.apply_perm(h_perm)

    def fwd(h_perm):
        return layout.apply_perm(h_perm), None

    def bwd(_, g):
        return (layout.apply_perm(g),)

    agg.defvjp(fwd, bwd)
    return agg
