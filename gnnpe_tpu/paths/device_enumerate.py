"""Device-side path enumeration: frontier expansion under jit.

The host enumerator (paths/enumerate.py) materializes each frontier in
numpy.  At ladder scale (patents/synth100m, BASELINE.md) the frontier
is hundreds of millions of rows and the expansion is exactly the kind
of regular gather/compare work an accelerator does well — so this module runs the
hop on device with XLA-static shapes (SURVEY.md §7.3 "capped-buffer +
overflow-spill"):

  * a hop takes rows int32[CAP, k] + valid bool[CAP] and emits
    int32[CAP, k+1] — `jnp.repeat(..., total_repeat_length=CAP)`
    keeps the shape static; `overflow` (true frontier size > CAP) is
    returned as a scalar so the host can split the start batch and
    retry — no silent truncation;
  * rows stay in emission order (rows expanded in order, neighbors
    ascending), so output order matches the host enumerator and the
    reference's DFS completion order bit-for-bit;
  * invalid rows (simple-path violations, padding) are compacted with
    a stable sort on the validity mask — gather, not scatter.

The host driver chunks start vertices by a degree-product bound so
overflow is rare, then falls back to halving chunks when it happens.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

from gnnpe_tpu.graph.csr import CSRGraph


@functools.partial(
    __import__("jax").jit,
    static_argnames=("cap",))
def _expand_hop(offsets, neighbors, rows, valid, cap: int):
    """One device hop.  rows int32[CAP, k] → (rows int32[CAP, k+1],
    valid bool[CAP], used int32 scalar, overflow bool scalar)."""
    import jax.numpy as jnp

    last = rows[:, -1]
    deg = jnp.where(valid, offsets[last + 1] - offsets[last], 0)
    row_start = jnp.cumsum(deg) - deg
    total = row_start[-1] + deg[-1]
    # Parent row of each output slot (monotone; slots ≥ total clamp).
    rep = jnp.searchsorted(row_start + deg,
                           jnp.arange(cap, dtype=deg.dtype), side="right")
    rep = jnp.minimum(rep, rows.shape[0] - 1)
    slot_valid = jnp.arange(cap) < total
    local = jnp.arange(cap) - row_start[rep]
    src_pos = offsets[last[rep]] + jnp.clip(local, 0, None)
    nbr = neighbors[jnp.minimum(src_pos, neighbors.shape[0] - 1)]
    out = jnp.concatenate(
        [rows[rep], nbr[:, None].astype(rows.dtype)], axis=1)
    simple = (out[:, :-1] != out[:, -1:]).all(axis=1)
    ok = slot_valid & simple & jnp.take(valid, rep)
    # Stable compaction: survivors to the front, order preserved.
    order = jnp.argsort(~ok, stable=True)
    return (jnp.take(out, order, axis=0), jnp.take(ok, order),
            ok.sum(), total > cap)


def enumerate_paths_device(graph: CSRGraph, starts: np.ndarray,
                           num_vertices_per_path: int,
                           cap: int = 1 << 20) -> np.ndarray:
    """All directed simple paths from ``starts`` (emission order), via
    device hops.  Chunks starts adaptively; overflow splits the chunk.
    Returns int32[P, L] on host."""
    import jax.numpy as jnp

    offs = jnp.asarray(graph.offsets.astype(np.int64))
    nbrs = jnp.asarray(graph.neighbors.astype(np.int32))
    l = num_vertices_per_path
    starts = np.asarray(starts, dtype=np.int32)

    # Upper-bound frontier growth per start: prod of top degrees.
    deg = np.diff(graph.offsets).astype(np.float64)
    max_deg = max(float(deg.max(initial=1.0)), 1.0)
    est_rows = np.maximum(deg[starts], 1.0) * max_deg ** max(l - 2, 0)

    out_parts = []
    i = 0
    chunk = len(starts)
    while i < len(starts):
        chunk = min(chunk, len(starts) - i)
        # Shrink chunk until the (loose) estimate fits the cap.
        while chunk > 1 and est_rows[i:i + chunk].sum() > cap:
            chunk //= 2
        batch = starts[i:i + chunk]
        got = _run_chunk(offs, nbrs, batch, l, cap)
        if got is None:              # true overflow: split further
            if chunk == 1:
                raise ValueError(
                    f"cap={cap} too small for start {starts[i]}")
            chunk //= 2
            continue
        out_parts.append(got)
        i += len(batch)
        chunk *= 2                   # gentle re-growth
    return (np.concatenate(out_parts, axis=0) if out_parts
            else np.zeros((0, l), dtype=np.int32))


def _run_chunk(offs, nbrs, batch: np.ndarray, l: int, cap: int):
    """Expand one start chunk to length l; None on overflow."""
    import jax.numpy as jnp
    n = len(batch)
    rows = jnp.zeros((cap, 1), dtype=jnp.int32)
    rows = rows.at[:n, 0].set(jnp.asarray(batch))
    valid = jnp.arange(cap) < n
    used = n
    for _ in range(l - 1):
        rows, valid, used, overflow = _expand_hop(
            offs, nbrs, rows, valid, cap=cap)
        if bool(overflow):
            return None
        used = int(used)
    return np.asarray(rows[:used])
