"""Device-side candidate filtering (jit / shard_map).

The flat dominance filter is a dense masked compare — vector work
(SURVEY.md §7.1.3).  The comparisons are **bit-exact f64** on device
via a three-limb f32 split (below), which needs no f64 arithmetic; the
f32-with-inflated-epsilon superset path is kept for the
training/approximate modes.  The GPU has f64 compares, so whether the
limbs still earn their bytes there is open (ROADMAP Design 2).

Exact f64 comparison on an f32 machine (``split3`` / ``ge3``):
an f64 value x (52 mantissa bits) splits into three f32 limbs
  hi  = f32(x)              (24 bits;  x - hi is exact in f64 — the
                             difference spans ≤ 28 bits)
  mid = f32(x - hi)         (next 24 bits; residual spans ≤ 3 bits)
  lo  = f32(x - hi - mid)   (exact: 3 ≤ 24 bits)
so hi + mid + lo == x exactly for normal magnitudes, and because each
rounding step is monotone, limb-LEXICOGRAPHIC comparison equals f64
value comparison:  a > b  ⟺  (hi_a, mid_a, lo_a) >_lex (hi_b, ...).
Dominance thresholds (q - ε) are computed in f64 on host and split the
same way, so the device decision is bit-identical to the reference's
f64 compare (custom.h:410-434) — no superset, no re-verification.

Sharded search: data paths split across the mesh's "graph" axis, each
device computes its mask shard, results concatenate — the SPMD analogue
of the reference's per-partition OpenMP search + serial union
(GNN-PE/src/main.cpp:155-172).
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np


def f32_safe_epsilon(max_abs: float, base_epsilon: float = 1e-6) -> float:
    """Slack that preserves all f64-accepted pairs under f32 rounding:
    base + 2 ulps at the embedding magnitude.  (Superset mode only —
    the exact paths use split3/ge3 instead.)"""
    ulp = np.spacing(np.float32(max(max_abs, 1.0)), dtype=np.float32)
    return float(base_epsilon + 2.0 * float(ulp))


def split3(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact three-limb f32 decomposition of f64 ``x`` (host).
    hi + mid + lo == x bit-exactly for |x| in the normal f32 range;
    see module docstring for the proof sketch."""
    x = np.asarray(x, dtype=np.float64)
    hi = x.astype(np.float32)
    r1 = x - hi.astype(np.float64)
    mid = r1.astype(np.float32)
    lo = (r1 - mid.astype(np.float64)).astype(np.float32)
    return hi, mid, lo


def ge3(a_hi, a_mid, a_lo, b_hi, b_mid, b_lo):
    """Elementwise exact-f64 ``a >= b`` from three-limb f32 operands
    (device, f32 compares only)."""
    hi_gt = a_hi > b_hi
    hi_eq = a_hi == b_hi
    mid_gt = a_mid > b_mid
    mid_eq = a_mid == b_mid
    return hi_gt | (hi_eq & (mid_gt | (mid_eq & (a_lo >= b_lo))))


def pe_mask_device(d_labels, d_degrees, d_pde,
                   q_labels, q_degrees, q_pde, epsilon: float):
    """bool[Q, P] position-wise PE match mask on device (jit-able).
    Inputs: d_* int32/f32[P, L]/[P, LD]; q_* [Q, L]/[Q, LD]."""
    import jax.numpy as jnp
    label_ok = (q_labels[:, None, :] == d_labels[None]).all(-1)
    degree_ok = (q_degrees[:, None, :] <= d_degrees[None]).all(-1)
    pde_ok = (q_pde[:, None, :] <= d_pde[None] + epsilon).all(-1)
    return label_ok & degree_ok & pde_ok


def pe_mask_device_exact(d_labels, d_degrees, d_pde3,
                         q_labels, q_degrees, q_thresh3):
    """bool[Q, P] PE match mask with BIT-EXACT f64 dominance decisions
    on an f32 device.  ``d_pde3`` / ``q_thresh3`` are (hi, mid, lo)
    limb triples; the threshold limbs encode q_pde - ε split on host,
    so the test here is ``d_pde >= q_pde - ε`` exactly as the
    reference's f64 compare (custom.h:410-434)."""
    label_ok = (q_labels[:, None, :] == d_labels[None]).all(-1)
    degree_ok = (q_degrees[:, None, :] <= d_degrees[None]).all(-1)
    dh, dm, dl = d_pde3
    qh, qm, ql = q_thresh3
    pde_ok = ge3(dh[None], dm[None], dl[None],
                 qh[:, None, :], qm[:, None, :], ql[:, None, :]).all(-1)
    return label_ok & degree_ok & pde_ok


@functools.lru_cache(maxsize=8)
def _jit_pe_mask():
    import jax
    return jax.jit(pe_mask_device, static_argnames=("epsilon",))


@functools.lru_cache(maxsize=8)
def _jit_pe_mask_exact():
    import jax
    return jax.jit(pe_mask_device_exact)


def pe_candidates_device(data_pde, q_pde, plan_rows: np.ndarray,
                         num_query_vertices: int,
                         base_epsilon: float = 1e-6) -> List[np.ndarray]:
    """Device candidate generation: device mask (bit-exact f64 decisions
    via limb splitting), host extraction.  Candidate sets are identical
    to the f64 host filter (match.filter.pe_candidates)."""
    import jax.numpy as jnp
    plan_rows = np.asarray(plan_rows)
    d3 = tuple(jnp.asarray(a) for a in split3(data_pde.pde))
    q3 = tuple(jnp.asarray(a) for a in split3(
        q_pde.pde[plan_rows] - base_epsilon))
    mask = _jit_pe_mask_exact()(
        jnp.asarray(data_pde.labels), jnp.asarray(data_pde.degrees),
        d3,
        jnp.asarray(q_pde.labels[plan_rows]),
        jnp.asarray(q_pde.degrees[plan_rows]),
        q3)
    return extract_candidates(np.asarray(mask), data_pde.vids,
                              q_pde.vids[plan_rows], num_query_vertices)


def extract_candidates(mask: np.ndarray, data_vids: np.ndarray,
                       plan_vids: np.ndarray,
                       num_query_vertices: int) -> List[np.ndarray]:
    """Host: mask bool[Q, P] → sorted unique candidates per query vertex
    (custom.h:429-433 semantics)."""
    per_vertex: List[List[np.ndarray]] = [
        [] for _ in range(num_query_vertices)]
    l = plan_vids.shape[1]
    for qi in range(mask.shape[0]):
        hit = np.nonzero(mask[qi])[0]
        if not len(hit):
            continue
        dv = data_vids[hit]
        for k in range(l):
            per_vertex[int(plan_vids[qi, k])].append(dv[:, k])
    return [np.unique(np.concatenate(s).astype(np.int64))
            if s else np.zeros(0, dtype=np.int64) for s in per_vertex]


def pe_mask_sharded(mesh, d_labels, d_degrees, d_pde,
                    q_labels, q_degrees, q_pde, epsilon: float,
                    axis: str = "graph"):
    """shard_map'd mask: data paths sharded on ``axis`` along their
    leading dim, query replicated; output mask bool[Q, P] sharded along
    its second (path) dim — the SPMD form of the reference's
    per-partition parallel search (main.cpp:160-164).  Pad P to a
    multiple of the axis size before calling."""
    import jax
    from jax.sharding import PartitionSpec as P

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(), P(), P()),
        out_specs=P(None, axis))
    def run(dl, dd, dp, ql, qd, qp):
        return pe_mask_device(dl, dd, dp, ql, qd, qp, epsilon)

    return run(d_labels, d_degrees, d_pde, q_labels, q_degrees, q_pde)


def pge_mask_device(d_labels, d_degrees, d_group_lo, d_group_hi,
                    d_lgroup_lo, d_lgroup_hi,
                    q_labels, q_degrees, q_group_lo,
                    q_lgroup_lo, q_lgroup_hi):
    """bool[Q, V] PGE vertex filter chain on device (GNN-PGE
    custom.h:330-372; leaf path-group test is strict, no epsilon)."""
    ok = ((q_degrees[:, None] <= d_degrees[None]) &
          (q_labels[:, None] == d_labels[None]))
    overlap = ((d_lgroup_hi[None] >= q_lgroup_lo[:, None, :]) &
               (d_lgroup_lo[None] <= q_lgroup_hi[:, None, :])).all(-1)
    dom = (d_group_hi[None] >= q_group_lo[:, None, :]).all(-1)
    return ok & overlap & dom


def pge_mask_device_exact(d_labels, d_degrees,
                          d_ghi3, d_llo3, d_lhi3,
                          q_labels, q_degrees,
                          q_glo3, q_llo3, q_lhi3):
    """bool[Q, V] PGE filter with BIT-EXACT f64 decisions via limb
    triples (GNN-PGE custom.h:330-372 runs strict f64 compares, no
    epsilon).  Tests: d_lgroup_hi >= q_lgroup_lo,
    q_lgroup_hi >= d_lgroup_lo, d_group_hi >= q_group_lo."""
    ok = ((q_degrees[:, None] <= d_degrees[None]) &
          (q_labels[:, None] == d_labels[None]))

    def _b_d(t):  # broadcast data limbs over Q
        return tuple(a[None] for a in t)

    def _b_q(t):  # broadcast query limbs over V
        return tuple(a[:, None, :] for a in t)

    overlap = (ge3(*_b_d(d_lhi3), *_b_q(q_llo3)) &
               ge3(*_b_q(q_lhi3), *_b_d(d_llo3))).all(-1)
    dom = ge3(*_b_d(d_ghi3), *_b_q(q_glo3)).all(-1)
    return ok & overlap & dom
