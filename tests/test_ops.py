"""Aggregation-op tests: ELL layouts and the device filter — all
against the host ground truth."""

import jax.numpy as jnp
import numpy as np
import pytest

from gnnpe_tpu.graph.csr import CSRGraph
from gnnpe_tpu.ops.ell import build_ell
from gnnpe_tpu.ops.spmm import neighbor_sum_np


def _ref_agg(g, x):
    out = np.zeros_like(x)
    for v in range(g.num_vertices):
        nb = g.vertex_neighbors(v)
        if len(nb):
            out[v] = x[nb].sum(0)
    return out


@pytest.fixture(scope="module")
def rand_graph():
    rng = np.random.RandomState(0)
    edges = ([[0, i] for i in range(1, 200)] +
             rng.randint(1, 300, (800, 2)).tolist())
    edges = np.array([e for e in edges if e[0] != e[1]])
    return CSRGraph.from_edges(300, edges, np.zeros(300, dtype=np.int64))


def test_ell_matches_reference(rand_graph):
    rng = np.random.RandomState(1)
    x = rng.rand(300, 64).astype(np.float32)
    want = _ref_agg(rand_graph, x)
    for w, w2 in [(8, 8), (4, 4), (16, 2)]:
        lay = build_ell(rand_graph.offsets, rand_graph.neighbors,
                        width=w, level2_width=w2)
        got = np.asarray(lay.apply(jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_ell_overhead_reasonable(data_graph):
    lay = build_ell(data_graph.offsets, data_graph.neighbors, width=8)
    arcs = len(data_graph.neighbors)
    assert lay.num_slots < 4 * arcs, lay.num_slots / arcs


def test_ell_isolated_vertices():
    g = CSRGraph.from_edges(5, np.array([[0, 1]]),
                            np.zeros(5, dtype=np.int64))
    lay = build_ell(g.offsets, g.neighbors, width=8)
    out = np.asarray(lay.apply(jnp.ones((5, 4), jnp.float32)))
    assert (out[2:] == 0).all() and out[0, 0] == 1.0


def test_device_filter_exact_and_count(data_graph, query_graph):
    """The limb-compare device filter must produce candidate sets
    EQUAL to the exact f64 host filter, and the identical 45,426
    refined count (bit-exact f64 decisions via split3/ge3)."""
    from gnnpe_tpu.config import PEConfig
    from gnnpe_tpu.engine import PEEngine
    from gnnpe_tpu.match.device_filter import pe_candidates_device
    from gnnpe_tpu.match.refine import refinement
    from gnnpe_tpu.embed.vde import gen_vde
    from gnnpe_tpu.embed.pde import gen_query_pde_table
    from gnnpe_tpu.paths.enumerate import enumerate_paths
    from gnnpe_tpu.match.plan import greedy_path_cover

    eng = PEEngine(PEConfig.from_cli(), data_graph).offline() \
        .build_index(packed=False)
    qv = gen_vde(query_graph, 2)
    qp, _ = enumerate_paths(query_graph, np.arange(8), 3, dedup=True)
    q_pde, weight, _ = gen_query_pde_table(qv, qp)
    plan = greedy_path_cover(qp, weight, 8)

    from gnnpe_tpu.match.filter import pe_candidates
    exact = pe_candidates(eng.data_pde, q_pde, plan, 8)
    fast = pe_candidates_device(eng.data_pde, q_pde, plan, 8)
    for e, f in zip(exact, fast):
        assert np.array_equal(np.asarray(e), np.asarray(f))
    n_exact = refinement(data_graph, query_graph, exact)
    n_fast = refinement(data_graph, query_graph, fast)
    assert n_exact == 45426
    assert n_fast == n_exact


def test_split3_ge3_bit_exact():
    """Limb-lexicographic compare == f64 compare on adversarial pairs:
    values differing in the last mantissa bit, equal values, negatives,
    and the actual VDE value distribution."""
    import jax.numpy as jnp
    from gnnpe_tpu.match.device_filter import ge3, split3
    rng = np.random.RandomState(0)
    a = rng.rand(4096) * rng.choice([1.0, -1.0, 1e-6, 1e6], 4096)
    bump = np.where(rng.rand(4096) < 0.5, np.spacing(a), 0.0)
    b = np.where(rng.rand(4096) < 0.3, a, a + bump)
    b[::7] = rng.rand(len(b[::7]))       # unrelated values too
    ah, am, al = (jnp.asarray(v) for v in split3(a))
    bh, bm, bl = (jnp.asarray(v) for v in split3(b))
    got = np.asarray(ge3(ah, am, al, bh, bm, bl))
    np.testing.assert_array_equal(got, a >= b)
    # Round-trip exactness of the decomposition itself.
    h, m, l = split3(a)
    np.testing.assert_array_equal(
        h.astype(np.float64) + m.astype(np.float64)
        + l.astype(np.float64), a)


def test_sharded_filter_matches(data_graph, query_graph):
    """shard_map'd PE mask == single-device mask."""
    import jax
    from gnnpe_tpu.parallel.mesh import make_mesh
    from gnnpe_tpu.match.device_filter import (pe_mask_device,
                                               pe_mask_sharded)
    from gnnpe_tpu.config import PEConfig
    from gnnpe_tpu.engine import PEEngine
    from gnnpe_tpu.embed.vde import gen_vde
    from gnnpe_tpu.embed.pde import gen_query_pde_table
    from gnnpe_tpu.paths.enumerate import enumerate_paths
    from gnnpe_tpu.match.plan import greedy_path_cover

    eng = PEEngine(PEConfig.from_cli(), data_graph).offline() \
        .build_index(packed=False)
    qv = gen_vde(query_graph, 2)
    qp, _ = enumerate_paths(query_graph, np.arange(8), 3, dedup=True)
    q_pde, weight, _ = gen_query_pde_table(qv, qp)
    plan = np.asarray(greedy_path_cover(qp, weight, 8))

    n = 4
    mesh = make_mesh(n, axes=("graph",), shape=(n,))
    p = eng.data_pde.num_paths
    pad = -(-p // n) * n - p

    def padded(a, fill):
        return jnp.asarray(np.concatenate(
            [a, np.full((pad,) + a.shape[1:], fill, a.dtype)]))

    dl = padded(eng.data_pde.labels, -1)
    dd = padded(eng.data_pde.degrees, 0)
    dp = padded(eng.data_pde.pde.astype(np.float32), 0.0)
    ql = jnp.asarray(q_pde.labels[plan])
    qd = jnp.asarray(q_pde.degrees[plan])
    qp_ = jnp.asarray(q_pde.pde[plan].astype(np.float32))
    single = pe_mask_device(dl, dd, dp, ql, qd, qp_, 1e-5)
    sharded = pe_mask_sharded(mesh, dl, dd, dp, ql, qd, qp_, 1e-5)
    assert np.array_equal(np.asarray(single), np.asarray(sharded))


def test_binned_ell_matches_reference(rand_graph):
    """Degree-binned relabeled layout == host SpMM, at low padding."""
    import jax.numpy as jnp
    from gnnpe_tpu.ops.ell import build_binned_ell
    from gnnpe_tpu.ops.spmm import neighbor_sum_np
    x = np.random.RandomState(0).rand(
        rand_graph.num_vertices, 16).astype(np.float32)
    want = neighbor_sum_np(rand_graph.offsets, rand_graph.neighbors,
                           x.astype(np.float64))
    lay = build_binned_ell(rand_graph.offsets, rand_graph.neighbors)
    got = np.asarray(lay.apply(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # Round-trip permute identity + perm-space equivalence.
    hp = lay.permute(jnp.asarray(x))
    np.testing.assert_allclose(
        np.asarray(lay.unpermute(lay.apply_perm(hp))), got)


def test_binned_ell_padding_and_head(data_graph):
    """Padding stays under the width-step bound on Test/ (max degree
    168 forces the head chunk+fold path).  hub_matmul pinned off so
    num_slots covers ALL arcs and the bound is dataset-stable."""
    from gnnpe_tpu.ops.ell import build_binned_ell
    lay = build_binned_ell(data_graph.offsets, data_graph.neighbors,
                           hub_matmul=False)
    assert lay.num_head >= 1          # deg 168 > widest class
    assert lay.num_hub_arcs == 0
    e = data_graph.offsets[-1]
    # Bound: width-class step + the min-width floor (deg<4 rows pad
    # to 4; Test/ has many degree-1..3 vertices).
    assert lay.num_slots <= 1.7 * e, (lay.num_slots, e)
    import jax.numpy as jnp
    from gnnpe_tpu.ops.spmm import neighbor_sum_np
    x = np.random.RandomState(1).rand(
        data_graph.num_vertices, 4).astype(np.float32)
    want = neighbor_sum_np(data_graph.offsets, data_graph.neighbors,
                           x.astype(np.float64))
    got = np.asarray(lay.apply(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_binned_ell_hub_signed_accuracy(rand_graph):
    """Hub hi/lo path on SIGNED features: the two-term bf16 split
    leaves ~1.5e-5 per-addend residual, growing under cancellation —
    document the real envelope (hub vs hub-free agree to ~1e-3 rel on
    signed inputs, not the old '~1e-7' claim)."""
    import jax.numpy as jnp
    from gnnpe_tpu.ops.ell import build_binned_ell
    x = (np.random.RandomState(3).rand(rand_graph.num_vertices, 16)
         .astype(np.float32) * 2.0 - 1.0)
    hub = build_binned_ell(rand_graph.offsets, rand_graph.neighbors,
                           hub_matmul=True, max_hubs=64)
    ref = build_binned_ell(rand_graph.offsets, rand_graph.neighbors,
                           hub_matmul=False)
    got = np.asarray(hub.apply(jnp.asarray(x)))
    want = np.asarray(ref.apply(jnp.asarray(x)))
    scale = np.maximum(np.abs(want), 1.0)
    assert np.max(np.abs(got - want) / scale) < 2e-3

    # f32 hub precision must be tighter (precision=HIGHEST matmul).
    hub32 = build_binned_ell(rand_graph.offsets, rand_graph.neighbors,
                             hub_matmul=True, max_hubs=64,
                             hub_precision="f32")
    got32 = np.asarray(hub32.apply(jnp.asarray(x)))
    assert np.max(np.abs(got32 - want) / scale) < 2e-5

    import pytest
    with pytest.raises(ValueError):
        build_binned_ell(rand_graph.offsets, rand_graph.neighbors,
                         hub_precision="f64")
    with pytest.raises(ValueError):
        build_binned_ell(rand_graph.offsets, rand_graph.neighbors,
                         widths=(4, 4, 8))


def test_symmetric_aggregate_gradient(rand_graph):
    """custom-vjp binned aggregation: value == A@x and grad == A@g
    (symmetric adjacency), with no scatter in either direction."""
    import jax
    import jax.numpy as jnp
    from gnnpe_tpu.ops.ell import build_binned_ell, symmetric_aggregate
    from gnnpe_tpu.ops.spmm import neighbor_sum_np
    lay = build_binned_ell(rand_graph.offsets, rand_graph.neighbors)
    agg = symmetric_aggregate(lay)
    x = np.random.RandomState(0).rand(
        rand_graph.num_vertices, 8).astype(np.float32)
    xp = lay.permute(jnp.asarray(x))
    out = np.asarray(lay.unpermute(agg(xp)))
    want = neighbor_sum_np(rand_graph.offsets, rand_graph.neighbors,
                           x.astype(np.float64))
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)

    # d/dx sum(A@x * c) = Aᵀ c = A c for symmetric A.
    c = np.random.RandomState(1).rand(*x.shape).astype(np.float32)
    cpj = lay.permute(jnp.asarray(c))
    g = jax.grad(lambda hp: (agg(hp) * cpj).sum())(xp)
    want_g = neighbor_sum_np(rand_graph.offsets, rand_graph.neighbors,
                             c.astype(np.float64))
    np.testing.assert_allclose(np.asarray(lay.unpermute(g)), want_g,
                               rtol=1e-4, atol=1e-4)


def test_rect_binned_hub_forced():
    """Rectangular binned layout with the matmul hub path ENGAGED (a
    skewed source distribution forces hub selection) must equal the
    dense aggregation — regression for the round-3 hub-rows-not-in-
    order-space bug."""
    import jax.numpy as jnp
    from gnnpe_tpu.ops.rect import build_binned_rect
    rng = np.random.RandomState(3)
    nd, ns, na = 200, 64, 5000
    dst = np.sort(rng.randint(0, nd, na))
    src = rng.zipf(1.3, na) % ns          # heavy repeat of few sources
    src = src.astype(np.int32)
    offs = np.concatenate([[0], np.cumsum(np.bincount(dst,
                                                      minlength=nd))])
    x = rng.rand(ns, 8).astype(np.float32)
    lay = build_binned_rect(offs, src, ns, hub_matmul=True,
                            hub_precision="f32")
    assert lay.hub_rows is not None and len(lay.hub_rows) > 0
    assert lay.num_hub_arcs > 0
    out = np.asarray(lay.apply(jnp.asarray(x)))[lay.rank]
    want = np.zeros((nd, 8))
    np.add.at(want, dst, x[src])
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)


def test_sddmm_attention_matches_dense():
    """SDDMM scores, segment softmax, and weighted aggregation equal
    the dense per-vertex reference (all scatter-free on device)."""
    import jax.numpy as jnp
    from gnnpe_tpu.ops.ell import build_ell
    from gnnpe_tpu.ops.sddmm import (arc_endpoints, attention_aggregate,
                                     sddmm, segment_softmax,
                                     weighted_apply)
    rng = np.random.RandomState(0)
    v, e = 120, 900
    dst = np.sort(rng.randint(0, v, e))
    src = rng.randint(0, v, e).astype(np.int32)
    offs = np.concatenate([[0], np.cumsum(np.bincount(dst,
                                                      minlength=v))])
    layout = build_ell(offs, src, width=4, level2_width=4)
    d = 8
    xk = rng.rand(v, d).astype(np.float32)
    xq = rng.rand(v, d).astype(np.float32)
    xv = rng.rand(v, d).astype(np.float32)
    dst_arc = arc_endpoints(offs)

    s = np.asarray(sddmm(jnp.asarray(src), jnp.asarray(dst_arc),
                         jnp.asarray(xk), jnp.asarray(xq)))
    want_s = (xk[src] * xq[dst_arc]).sum(-1)
    np.testing.assert_allclose(s, want_s, rtol=1e-5, atol=1e-6)

    w = np.asarray(segment_softmax(layout, jnp.asarray(s),
                                   jnp.asarray(dst_arc)))
    # dense softmax reference per destination
    want_w = np.zeros_like(want_s)
    for u in range(v):
        lo, hi = offs[u], offs[u + 1]
        if hi > lo:
            ex = np.exp(want_s[lo:hi] - want_s[lo:hi].max())
            want_w[lo:hi] = ex / ex.sum()
    np.testing.assert_allclose(w, want_w, rtol=1e-4, atol=1e-6)

    out = np.asarray(weighted_apply(layout, jnp.asarray(xv),
                                    jnp.asarray(w)))
    want = np.zeros((v, d))
    np.add.at(want, dst_arc, want_w[:, None] * xv[src])
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-5)

    full = np.asarray(attention_aggregate(
        layout, jnp.asarray(src), jnp.asarray(dst_arc),
        jnp.asarray(xk), jnp.asarray(xq), jnp.asarray(xv)))
    np.testing.assert_allclose(full, want, rtol=1e-4, atol=1e-5)
