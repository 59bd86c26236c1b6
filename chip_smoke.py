"""Smoke run of the serving path on one GPU (or four, with --four-cards).

Drives the system the way a user does, at the dblp rung of the dataset
ladder (io/datasets.py): the seeded synthetic stand-in for SunLab's DBLP
(V=317,080, E=1,049,866, 15 labels, max degree 343), the PE index at
l=2 built by the pipelined offline stage, and the PGE index at l=2.

Phases, in order (each prints its wall time on its own line):
  0  device       refuse anything but a GPU; print kind, count, memory
                  limit and the card's name and power limit
  1  pe_build     offline_build_pipelined -> DevicePackedPESearch, warm()
  2  pe_serve     8 random-walk 8-vertex tree queries per query (both
                  unions) and stacked; candidates of query 0 and of the
                  query with the most chunks equal the f64 host oracle
  3  pge          PGEEngine offline(device=True) + packed search, same
                  queries and the same oracle check
  4  streamed     yeast rung, PE l=2 streamed tier with a chunk cache of
                  about two chunks (forced eviction), both unions, cache
                  on and off, all equal to the resident index and oracle
  5  spmm         embedding-stage aggregation: segment_sum and binned
                  ELL (with and without the bf16 hi/lo hub path) against
                  the f64 host sum

With --four-cards only phases 0-3 run, with the PE and PGE indexes split
by block over a four-device mesh.

Nothing here catches its own failure: any mismatch or exception ends the
run with a non-zero exit code and no result line.  The last line of
standard output is one JSON object naming the device.

Run:  python chip_smoke.py [--four-cards] [--seed N]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

from gnnpe_tpu.config import PEConfig, PGEConfig
from gnnpe_tpu.embed.pde import gen_pde, gen_query_pde_table, path_groups
from gnnpe_tpu.engine import PEEngine, PGEEngine
from gnnpe_tpu.graph.partition import degree_sorted_nodes
from gnnpe_tpu.index.device_packed import DevicePackedPESearch
from gnnpe_tpu.io.datasets import load_dataset, sample_query
from gnnpe_tpu.match.filter import (pe_candidates, pe_candidates_chunked,
                                    pge_candidates)
from gnnpe_tpu.match.plan import greedy_path_cover
from gnnpe_tpu.ops.spmm import neighbor_sum_np
from gnnpe_tpu.paths.enumerate import enumerate_paths
from gnnpe_tpu.paths.pipeline import offline_build_pipelined

NUM_QUERIES = 8
QUERY_SIZE = 8
MAX_ANSWERS = 100_000        # the ladder's refinement cap (ref -n)


@contextlib.contextmanager
def phase(name: str):
    print(f"[smoke] phase {name} ...", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"[smoke] phase {name}: {time.perf_counter() - t0:.3f} s",
          flush=True)


def _same(got, want, what: str) -> None:
    assert len(got) == len(want), (what, len(got), len(want))
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a), np.asarray(b)
        assert np.array_equal(a, b), \
            f"{what}: query vertex {i} has {len(a)} candidates, " \
            f"oracle {len(b)}"


def _spot_queries(chunks) -> list:
    """Query 0 and the query with the most chunks among the others."""
    if len(chunks) < 2:
        return [0]
    return [0, 1 + int(np.argmax(chunks[1:]))]


def _peak_bytes(mesh):
    stats = mesh.devices.flat[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def device_phase(count: int) -> dict:
    """Phase 0: the devices this run uses.  Exits when JAX has no GPU."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU found (JAX platform is "
                         f"{devs[0].platform!r}); nothing was run")
    if len(devs) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs, JAX sees "
                         f"{len(devs)}")
    from gnnpe_tpu.utils.compile_cache import enable_persistent_cache
    from gnnpe_tpu.utils.device_probe import peak_rates
    cache_dir = enable_persistent_cache()
    stats = devs[0].memory_stats() or {}
    bw, flops = peak_rates(devs[0].device_kind)
    print(f"[smoke] device_kind={devs[0].device_kind} "
          f"devices={len(devs)} using={count} "
          f"bytes_limit={stats.get('bytes_limit')} "
          f"published_peaks=({bw:g} B/s, {flops:g} bf16 flop/s) "
          f"compile_cache={cache_dir}", flush=True)
    print(f"[smoke] nvidia-smi: {nvidia_smi()}", flush=True)
    return dict(platform=devs[0].platform, kind=devs[0].device_kind,
                count=count)


def sample_queries(g, n: int = NUM_QUERIES, size: int = QUERY_SIZE):
    return [sample_query(g, size, tree=True, seed=i) for i in range(n)]


def pe_query_table(eng: PEEngine, qg):
    """(query path table, plan rows) exactly as PEEngine.online builds
    them, for the oracle side of a spot check."""
    qv = eng.embedder(qg)
    qp, _ = enumerate_paths(qg, np.arange(qg.num_vertices),
                            eng.config.path_length, dedup=True)
    q_pde, w, _ = gen_query_pde_table(qv, qp)
    return q_pde, greedy_path_cover(qp, w, qg.num_vertices)


def pe_build(g, mesh, block_size: int = 512) -> PEEngine:
    """Phase 1: the ladder's PE build route, then warm()."""
    eng = PEEngine(PEConfig.from_cli(l=2, e=2, p=5, n=MAX_ANSWERS), g)
    eng.vertices = eng.embedder(g)
    eng.paths, eng.sharded, timings = offline_build_pipelined(
        g, degree_sorted_nodes(g), eng.config.path_length, eng.vertices,
        mesh, block_size=block_size)
    warm_s = eng.sharded.warm()
    print(f"[smoke] pe paths={len(eng.paths)} "
          f"blocks={eng.sharded.num_blocks} "
          f"mode={'streamed' if eng.sharded.streamed else 'resident'} "
          f"pipeline={json.dumps(timings)} "
          f"build_phase_ms={json.dumps(eng.sharded.build_phase_ms)} "
          f"warm_s={warm_s:.3f} peak_bytes_in_use={_peak_bytes(mesh)}",
          flush=True)
    return eng


def _lat_summary(lat_ms) -> str:
    return (f"p50={np.median(lat_ms):.1f}ms "
            f"p90={np.percentile(lat_ms, 90):.1f}ms "
            f"max={np.max(lat_ms):.1f}ms")


def _serve(eng, qs, oracle, what: str) -> dict:
    """Per-query search with the host union (timed) and the device
    union, then all queries stacked through online_many: answers and
    candidates agree everywhere, and the spot queries' candidates
    equal ``oracle(query)``, the f64 host filter."""
    lat, chunks, host = [], [], []
    for q in qs:
        t0 = time.perf_counter()
        host.append(eng.online(q, engine="native", union="host"))
        lat.append((time.perf_counter() - t0) * 1e3)
        chunks.append(eng.sharded.last_stats["chunks"]
                      if eng.sharded.last_stats else 0)
    answers = [r.answer_count for r in host]
    for i, q in enumerate(qs):
        rd = eng.online(q, engine="native", union="device")
        _same(rd.candidates, host[i].candidates,
              f"{what} query {i}: device union vs host union")
        assert rd.answer_count == answers[i], (what, i)
    t0 = time.perf_counter()
    stacked = eng.online_many(qs, engine="native", union="device")
    stacked_s = time.perf_counter() - t0
    assert [r.answer_count for r in stacked] == answers, \
        (what, [r.answer_count for r in stacked], answers)
    spot = _spot_queries(chunks)
    t0 = time.perf_counter()
    for qi in spot:
        want = oracle(qs[qi])
        _same(host[qi].candidates, want, f"{what} query {qi} vs oracle")
        _same(stacked[qi].candidates, want,
              f"{what} stacked query {qi} vs oracle")
    print(f"[smoke] {what} serve: {_lat_summary(lat)} chunks={chunks} "
          f"answers={answers} stacked_s={stacked_s:.3f} "
          f"spot_checked={spot} "
          f"oracle_s={time.perf_counter() - t0:.3f} "
          f"peak_bytes_in_use={_peak_bytes(eng.sharded.mesh)}",
          flush=True)
    return dict(answers=answers, lat_ms=lat, chunks=chunks)


def pe_serve(eng: PEEngine, qs) -> dict:
    """Phase 2: the PE index serves ``qs`` (see _serve)."""
    def oracle(qg):
        q_pde, plan = pe_query_table(eng, qg)
        return pe_candidates_chunked(eng.vertices, eng.paths, q_pde, plan,
                                     qg.num_vertices,
                                     epsilon=eng.config.epsilon)
    return _serve(eng, qs, oracle, "pe")


def pge_phase(g, mesh, qs) -> dict:
    """Phase 3: the PGE index built and served on the mesh (see
    _serve)."""
    eng = PGEEngine(PGEConfig.from_cli(l=2, e=2, p=5, n=MAX_ANSWERS), g)
    t0 = time.perf_counter()
    eng.offline(device=True, packed=True)
    offline_s = time.perf_counter() - t0
    eng.attach_mesh(mesh, packed=True)
    warm_s = eng.sharded.warm()
    print(f"[smoke] pge offline_s={offline_s:.3f} warm_s={warm_s:.3f}",
          flush=True)

    def oracle(qg):
        qv = eng.embedder(qg)
        qp, _ = enumerate_paths(qg, np.arange(qg.num_vertices),
                                eng.config.path_length, dedup=False)
        q_group, q_lgroup = path_groups(qv, qp[:, 0], qp,
                                        eng.config.pde_dim)
        return pge_candidates(
            eng.vertices.labels, eng.vertices.degrees, eng.group,
            eng.label_group, qv.labels, qv.degrees, q_group, q_lgroup,
            q_vertex_ids=list(range(qg.num_vertices)),
            epsilon=eng.config.epsilon)
    out = _serve(eng, qs, oracle, "pge")
    eng.sharded.close()
    return out


@contextlib.contextmanager
def _env(**kv):
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update({k: str(v) for k, v in kv.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def streamed_phase(g, mesh, qs, block_size: int = 4) -> dict:
    """Phase 4: the streamed tier with a cache of about two chunks.

    Per query, then all queries stacked through online_many: the
    stacked search survives more blocks than the cache holds, so LRU
    eviction overwrites slots that earlier chunks of the same search
    read.  That checks the dispatch-order argument of DeviceChunkCache
    on the device: every union and cache setting must equal the
    resident index and the flat f64 oracle."""
    eng = PEEngine(PEConfig.from_cli(l=2, e=2, p=5, n=MAX_ANSWERS), g)
    eng.offline()
    eng.vertices = eng.embedder(g)
    data_pde = gen_pde(eng.vertices, eng.paths)
    want = []
    for q in qs:
        q_pde, plan = pe_query_table(eng, q)
        want.append(pe_candidates(data_pde, q_pde, plan, q.num_vertices,
                                  epsilon=eng.config.epsilon))
    resident = DevicePackedPESearch.build_from_paths(
        mesh, eng.paths, eng.vertices, block_size=block_size)
    streamed = DevicePackedPESearch.build_from_paths(
        mesh, eng.paths, eng.vertices, block_size=block_size,
        resident=False)
    n = mesh.shape["graph"]
    k = streamed.k_chunk
    assert streamed.streamed and streamed.nb_local > 2 * k, \
        (streamed.nb_local, k)

    def check(index, what):
        for i, q in enumerate(qs):
            q_pde, plan = pe_query_table(eng, q)
            for union in ("host", "device"):
                _same(index.search(q_pde, plan, q.num_vertices,
                                   union=union), want[i],
                      f"query {i}: {what} {union} union")
        eng.sharded = index
        for union in ("host", "device"):
            got = eng.online_many(qs, engine="native", union=union)
            for i, r in enumerate(got):
                _same(r.candidates, want[i],
                      f"stacked query {i}: {what} {union} union")

    check(resident, "resident")
    cache_bytes = 2 * k * n * block_size * eng.paths.shape[1] * 4
    with _env(GNNPE_CACHE_BYTES=cache_bytes):
        check(streamed, "cached streamed")
        cache = streamed._cache
        assert cache and cache.capacity == 2 * k, cache
        hits, misses = cache.hits, cache.misses
    assert misses > n * cache.capacity, \
        f"no eviction: {misses} misses for {n * cache.capacity} slots"
    streamed._cache = None
    with _env(GNNPE_STREAM_CACHE=0):
        check(streamed, "uncached streamed")
        assert streamed._cache is False
    print(f"[smoke] streamed paths={len(eng.paths)} "
          f"blocks={streamed.num_blocks} k_chunk={k} "
          f"cache_slots={n * cache.capacity} hits={hits} "
          f"misses={misses}", flush=True)
    streamed.close()
    resident.close()
    return dict(hits=hits, misses=misses)


def _median_ms(fn, x, reps: int) -> float:
    fn(x).block_until_ready()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(x).block_until_ready()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def spmm_phase(num_vertices: int = 100_000, num_edges: int = 800_000,
               dim: int = 128, reps: int = 20) -> dict:
    """Phase 5: the embedding stage's neighbor sum in each XLA layout
    against the f64 host sum.  f32 layouts agree to rtol 1e-5 (sums in
    another order); the bf16 hi/lo hub path to rtol 1e-4 (its split
    leaves ~2^-16 per addend, and the inputs are non-negative, so no
    cancellation).  Pad-slot corrections may leave a few ulps on
    isolated rows, hence atol equal to rtol on inputs in [0, 1)."""
    import jax
    import jax.numpy as jnp
    from bench import synth_graph
    from gnnpe_tpu.ops.ell import build_binned_ell
    from gnnpe_tpu.ops.spmm import neighbor_sum

    src, dst = synth_graph(num_vertices, num_edges)
    counts = np.bincount(dst, minlength=num_vertices)
    offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    x = np.random.RandomState(1).rand(num_vertices, dim) \
        .astype(np.float32)
    want = neighbor_sum_np(offs, src, x.astype(np.float64))
    xj = jnp.asarray(x)
    srcj, dstj = jnp.asarray(src), jnp.asarray(dst)
    seg = jax.jit(lambda h: neighbor_sum(srcj, dstj, h, num_vertices))
    plain = build_binned_ell(offs, src, hub_matmul=False)
    hub = build_binned_ell(offs, src, feature_dim_hint=dim)
    assert hub.hub_rows is not None and hub.hub_precision == "hi_lo", \
        "the hub path did not engage"
    layouts = [("segment_sum", seg, seg, 1e-5),
               ("binned_ell", jax.jit(plain.apply),
                jax.jit(plain.apply_perm), 1e-5),
               (f"binned_ell_hub{len(hub.hub_rows)}",
                jax.jit(hub.apply), jax.jit(hub.apply_perm), 1e-4)]
    out = {}
    for name, apply, layer, rtol in layouts:
        got = np.asarray(apply(xj), dtype=np.float64)
        err = float(np.max(np.abs(got - want) / np.maximum(
            np.abs(want), 1.0)))
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol,
                                   err_msg=name)
        ms = _median_ms(layer, xj, reps)
        out[name] = dict(max_rel_err=err, ms_per_layer=ms)
        print(f"[smoke] spmm {name}: max_rel_err={err:.3e} "
              f"(rtol {rtol:g}) median_ms_per_layer={ms:.4f}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the PE/PGE search split over a "
                         "four-GPU mesh")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the synthetic data graphs")
    args = ap.parse_args(argv)
    count = 4 if args.four_cards else 1

    with phase("0 device"):
        device = device_phase(count)
    from gnnpe_tpu.parallel.mesh import make_mesh
    mesh = make_mesh(count, axes=("graph",), shape=(count,))

    g = load_dataset("dblp", seed=args.seed)
    print(f"[smoke] dblp V={g.num_vertices} E={g.num_edges} "
          f"labels={g.labels_count} "
          f"max_degree={int(np.diff(g.offsets).max())}", flush=True)
    qs = sample_queries(g)
    with phase("1 pe_build"):
        pe = pe_build(g, mesh)
    with phase("2 pe_serve"):
        pe_serve(pe, qs)
    pe.sharded.close()
    del pe
    with phase("3 pge"):
        pge_phase(g, mesh, qs)
    if not args.four_cards:
        y = load_dataset("yeast", seed=args.seed)
        with phase("4 streamed"):
            streamed_phase(y, mesh, sample_queries(y, n=16))
        with phase("5 spmm"):
            spmm_phase()
    print(f"[smoke] nvidia-smi: {nvidia_smi()}", flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
