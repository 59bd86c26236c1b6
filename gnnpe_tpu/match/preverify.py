"""Device-side candidate pre-verification (semi-join pruning).

The reference ships every candidate set straight to the backtracking
refinement (custom.h:890-932).  At scale the host transfer and the
backtracking fan-out both pay for candidates that cannot possibly
extend to a full match.  This pass prunes them ON DEVICE before the
transfer (SURVEY.md §7.3 "device-side pre-verification").

Semantics (arc consistency over the candidate relation): candidate v
for query vertex q survives iff for EVERY query edge (q, q') some
candidate of q' is adjacent to v in the data graph.  Every vertex of a
true monomorphism survives, so the pruned sets still contain every
real match.

Answer-count contract — mode-dependent:
  * EXACT semantics (PGE, or any candidate sets that are supersets of
    the true match images): the count is UNCHANGED.  Refinement
    constrains only the start vertex's candidate set and verifies all
    edges itself (custom.h:757-797), so any superset-of-matches
    candidate sets yield the exact count.
  * PE PARITY semantics: the reference's candidate sets are NOT
    match-supersets (orientation dedup drops real matches,
    SURVEY.md §0.3), and its answer depends on which vertex the GQL
    order picks as start (min |candidates|) and on that set's content.
    Pruning changes both, so the count can move — toward the true
    count, since pruning only removes match-impossible vertices.
    Do not enable preverify when bit-parity with shipped GNN-PE
    output is required.

Array form: stack the candidate indicator vectors into C ∈ {0,1}^[V, Q];
one neighbor aggregation (the same SpMM as the embedding stage) gives
reach = A @ C, and the update is
    C[v, q] &= ∀ q' ∈ N(q): reach[v, q'] > 0
— one SpMM + one masked reduce per iteration, run to fixpoint (or a
fixed iteration budget; pruning is monotone so any prefix is sound).
"""

from __future__ import annotations

import functools
from typing import List, Optional

import numpy as np

from gnnpe_tpu.graph.csr import CSRGraph


@functools.lru_cache(maxsize=8)
def _jit_step(num_vertices: int):
    """One pruning round as a shape-cached jit (re-tracing per call
    would pay the compile round-trip every query)."""
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnames=())
    def step(cj, srcj, dstj, needj):
        gathered = jnp.take(cj, srcj, axis=0)
        reach = jax.ops.segment_sum(
            gathered, dstj, num_segments=num_vertices) > 0.0
        ok = (reach[:, None, :] | ~needj[None]).all(-1)
        return cj * ok.astype(cj.dtype)

    return step


def semijoin_prune(data_graph: CSRGraph, query_graph: CSRGraph,
                   candidates: List[np.ndarray], iters: int = 2,
                   ell=None) -> List[np.ndarray]:
    """Prune candidate sets by arc consistency (device SpMM form).

    iters: pruning rounds; each is sound, fixpoint needs ≤ V rounds
    but 2-3 capture almost all of the benefit.
    ell: optional prebuilt HierarchicalEll layout for the data graph
    (reused across queries); falls back to segment_sum.
    """
    import jax
    import jax.numpy as jnp

    v = data_graph.num_vertices
    nq = query_graph.num_vertices
    c = np.zeros((v, nq), dtype=np.float32)
    for q, cand in enumerate(candidates):
        c[np.asarray(cand, dtype=np.int64), q] = 1.0

    # Query adjacency mask: need[q, q'] — which reach columns must be
    # positive for a q-candidate to survive.
    need = np.zeros((nq, nq), dtype=bool)
    for q in range(nq):
        need[q, query_graph.vertex_neighbors(q)] = True
    needj = jnp.asarray(need)

    if ell is not None:
        needj_l = jnp.asarray(need)

        @jax.jit
        def step_ell(cj):
            reach = ell.apply(cj) > 0.0
            ok = (reach[:, None, :] | ~needj_l[None]).all(-1)
            return cj * ok.astype(cj.dtype)

        run = step_ell
    else:
        src, dst = data_graph.coo()
        srcj, dstj = jnp.asarray(src), jnp.asarray(dst)
        cached = _jit_step(v)
        run = lambda cj: cached(cj, srcj, dstj, needj)

    cj = jnp.asarray(c)
    for _ in range(iters):
        nxt = run(cj)
        if bool((nxt == cj).all()):
            cj = nxt
            break
        cj = nxt

    out = np.asarray(cj) > 0.0
    return [np.nonzero(out[:, q])[0].astype(np.int64)
            for q in range(nq)]
