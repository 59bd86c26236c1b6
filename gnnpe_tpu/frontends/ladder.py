"""Dataset-ladder benchmark (BASELINE.md ladder; VERDICT r1 item 2).

Runs the full pipeline — offline enumeration, index build, online
candidate search + refinement over sampled queries — on each rung and
emits one JSON row per rung/variant.  The reference's end-to-end
contract being scaled is GNN-PE/src/main.cpp:122-182.

Scale policy (documented, not hidden):
  * PE indexes ONE ENTRY PER PATH.  Round 4 removed the HBM wall: the
    index auto-selects STREAMED mode (sorted table host-RAM-resident,
    phase-2 chunks uploaded per dispatch) when the leaf table exceeds
    the HBM budget, so l=2 now runs wherever the HOST can enumerate
    and sort the path set — the cap below (default 2e9 entries) is
    enumeration/RAM feasibility, not device memory.  youtube's ~1.2e9
    3-vertex entries run PE l=2 streamed; synth100m (~many-e9) stays
    l=1.  PGE runs l=2 everywhere via the O(V)-memory streamed device
    group fold.
  * Queries: ``--queries`` random-walk trees (labels inherited from
    the data graph, matches guaranteed to exist) — the standard
    SubgraphMatching methodology; p50 over all queries reported.
  * Spot verification: on every rung the packed-search candidates of
    one query are checked bit-equal against the flat exact filter.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from gnnpe_tpu.utils.compile_cache import enable_persistent_cache


def run_rung(name: str, queries: int = 50, query_size: int = 8,
             seed: int = 0, block_size: int = 512,
             pe_max_paths: int = 2_000_000_000,
             max_answers: int = 100_000,
             pipelined: bool = True,
             prefill_seconds: float = 300.0,
             force_streamed: bool = False,
             serve: bool = True,
             ab_sequential: bool = False,
             pe_only: bool = False,
             pge_only: bool = False,
             pe_load: str = "",
             build_note: str = "",
             out_path: str = "") -> list:
    import jax
    enable_persistent_cache()
    from gnnpe_tpu.config import PEConfig, PGEConfig
    from gnnpe_tpu.engine import PEEngine, PGEEngine
    from gnnpe_tpu.graph.partition import degree_sorted_nodes
    from gnnpe_tpu.index.device_packed import DevicePackedPESearch
    from gnnpe_tpu.io.datasets import LADDER, load_dataset, sample_query
    from gnnpe_tpu.parallel.mesh import make_mesh

    rows = []

    def emit(row):
        # Rows land on disk AS PRODUCED: a crash in a later variant
        # must not lose an hour-scale rung's completed results.
        rows.append(row)
        if out_path:
            with open(out_path, "a") as f:
                f.write(json.dumps(row) + "\n")

    t0 = time.time()
    g = load_dataset(name, seed=seed)
    gen_s = time.time() - t0
    deg = np.diff(g.offsets).astype(np.int64)
    est_paths3 = int((deg * (deg - 1)).sum())
    print(f"[ladder:{name}] V={g.num_vertices} E={g.num_edges} "
          f"maxdeg={deg.max()} gen={gen_s:.1f}s "
          f"est 3v-paths={est_paths3}", file=sys.stderr)
    mesh = make_mesh(len(jax.devices()), axes=("graph",),
                     shape=(len(jax.devices()),))
    qs = [sample_query(g, query_size, tree=True, seed=seed + i)
          for i in range(queries)]

    # ---------------- PE ------------------------------------------------
    if pge_only:
        return _run_pge(name, g, qs, mesh, max_answers, serve, emit,
                        rows)
    pe_l = 2 if est_paths3 // 2 <= pe_max_paths else 1
    cfg = PEConfig.from_cli(l=pe_l, e=2, p=5, n=max_answers)
    eng = PEEngine(cfg, g)
    eng.vertices = eng.embedder(g)
    pipe_timings = None
    forced = False if force_streamed else None
    if pe_load:
        # Serve a persisted index (DevicePackedPESearch.save format)
        # instead of rebuilding — the reference's index.dat reload
        # (custom.h:218-234).  enumerate/build times then describe the
        # LOAD, not a fresh build; build_note records provenance.
        t0 = time.time()
        eng.sharded = DevicePackedPESearch.load(
            mesh, pe_load, eng.vertices)
        build_s = time.time() - t0
        enum_s = 0.0
        eng.paths = eng.sharded._host_vids[
            :eng.sharded.num_entries]
    elif pipelined:
        from gnnpe_tpu.paths.pipeline import offline_build_pipelined
        t0 = time.time()
        eng.paths, eng.sharded, pipe_timings = offline_build_pipelined(
            g, degree_sorted_nodes(g), cfg.path_length, eng.vertices,
            mesh, block_size=block_size, resident=forced)
        build_s = time.time() - t0
        enum_s = pipe_timings["enum_keys_s"]
    else:
        from gnnpe_tpu.index.device_packed import auto_resident
        t0 = time.time()
        eng.offline()
        enum_s = time.time() - t0
        t0 = time.time()
        eng.sharded = DevicePackedPESearch.build_from_paths(
            mesh, eng.paths, eng.vertices, block_size=block_size,
            resident=(False if force_streamed else auto_resident(
                len(eng.paths), cfg.path_length, block_size,
                g.num_vertices, mesh.shape["graph"])))
        build_s = time.time() - t0
    num_paths = len(eng.paths)
    # Optional A/B of record (VERDICT r4 item 3): rebuild the SAME
    # index sequentially — monolithic enumerate, then monolithic
    # build (the r4 path) — and record the overlap+bucketing speedup
    # in the row itself instead of a hand-merged side measurement.
    ab = None
    if ab_sequential and pipelined:
        from gnnpe_tpu.index.device_packed import (
            DevicePackedPESearch as _DPS, auto_resident)
        from gnnpe_tpu.paths.enumerate import (
            enumerate_paths as _enum)
        t0 = time.time()
        paths2, _ = _enum(g, degree_sorted_nodes(g),
                          cfg.path_length, dedup=True)
        seq_sh = _DPS.build_from_paths(
            mesh, paths2, eng.vertices, block_size=block_size,
            resident=(False if force_streamed else auto_resident(
                len(paths2), cfg.path_length, block_size,
                g.num_vertices, mesh.shape["graph"])))
        seq_s = time.time() - t0
        del seq_sh, paths2
        ab = round(seq_s / max(build_s, 1e-9), 2)
        print(f"[ladder:{name}] PE build A/B: sequential {seq_s:.1f}s"
              f" / pipelined {build_s:.1f}s = {ab}x", file=sys.stderr)
    from gnnpe_tpu.embed.pde import gen_pde
    if num_paths <= 20_000_000:
        # Full f64 PathEmbeddings only where it fits (the flat spot
        # oracle); billion-path rungs use the chunked oracle instead.
        eng.data_pde = gen_pde(eng.vertices, eng.paths)
    warm_s = eng.sharded.warm()
    # Streamed mode: prefetch popularity-ordered leaf blocks into the
    # HBM cache DURING the offline phase (VERDICT r4 item 1) — first
    # queries then mostly hit instead of paying cold uploads.
    prefill_s = prefill_blocks = None
    if eng.sharded.streamed:
        t0 = time.time()
        prefill_blocks = eng.sharded.prefill_cache(
            max_seconds=prefill_seconds)
        prefill_s = round(time.time() - t0, 2)
    index_bytes = int(eng.sharded._host_vids.nbytes
                      + sum(np.asarray(a).nbytes
                            for a in eng.sharded.b_ub3)
                      + sum(np.asarray(a).nbytes
                            for a in eng.sharded.b_llo3)
                      + sum(np.asarray(a).nbytes
                            for a in eng.sharded.b_lhi3)
                      + np.asarray(eng.sharded.b_deg).nbytes)
    lat = []
    answers = []
    stages = {"query_plan": [], "search": [], "refine": []}
    chunk_counts, survived, hit_rates = [], [], []
    for q in qs:
        t0 = time.time()
        r = eng.online(q, union="host")
        lat.append((time.time() - t0) * 1e3)
        answers.append(r.answer_count)
        for k in stages:
            stages[k].append(r.timings_ms.get(k, 0.0))
        st = eng.sharded.last_stats
        if st is not None:
            chunk_counts.append(st["chunks"])
            survived.append(st["survived"])
            if "cache_hits" in st:
                tot = st["cache_hits"] + st["cache_misses"]
                hit_rates.append(st["cache_hits"] / tot if tot else 1.0)

    # Spot verification against an INDEPENDENT host f64 implementation
    # of the flat exact filter: in one shot up to 20e6 paths, streamed
    # over path chunks beyond (pe_candidates_chunked — full flat
    # semantics, bounded memory, shares no code with the device
    # search).  TWO queries are checked (VERDICT r4 item 5): query 0
    # and the heaviest (max-chunk-count) query, which stresses chunk
    # handoff, cache fill/evict, and mask reassembly hardest.
    from gnnpe_tpu.match.filter import (pe_candidates,
                                        pe_candidates_chunked)
    from gnnpe_tpu.embed.pde import gen_query_pde_table
    from gnnpe_tpu.match.plan import greedy_path_cover
    from gnnpe_tpu.paths.enumerate import enumerate_paths

    def pe_spot(qi: int) -> bool:
        qg = qs[qi]
        qv = eng.embedder(qg)
        qp, _ = enumerate_paths(qg, np.arange(qg.num_vertices),
                                cfg.path_length, dedup=True)
        q_pde, w, _ = gen_query_pde_table(qv, qp)
        plan = greedy_path_cover(qp, w, qg.num_vertices)
        if num_paths <= 20_000_000:
            oracle = pe_candidates(eng.data_pde, q_pde, plan,
                                   qg.num_vertices,
                                   epsilon=cfg.epsilon)
        else:
            oracle = pe_candidates_chunked(
                eng.vertices, eng.paths, q_pde, plan,
                qg.num_vertices, epsilon=cfg.epsilon)
        packed = eng.sharded.search(q_pde, plan, qg.num_vertices)
        ok = all(np.array_equal(a, b)
                 for a, b in zip(oracle, packed))
        assert ok, f"packed search != host oracle on query {qi}"
        return ok

    # A failure here is RECORDED in the row (an hour-scale rung's
    # completed measurements must reach disk); main() then exits
    # non-zero.
    spot_err = None
    try:
        spot_ok = pe_spot(0)
        heavy_qi = (int(np.argmax(chunk_counts))
                    if chunk_counts else 0)
        spot_ok_p90 = pe_spot(heavy_qi) if heavy_qi != 0 else spot_ok
    except Exception as exc:               # noqa: BLE001
        spot_ok = spot_ok_p90 = False
        spot_err = repr(exc)[:300]
        print(f"[ladder:{name}] PE SPOT-CHECK FAILED: {spot_err}",
              file=sys.stderr)

    # Batched serving (VERDICT r4 item 6): all queries in ONE stacked
    # search through the device-bitmap union (one [nq, V/32] download
    # per stack), answers asserted equal to the per-query loop.
    serving = None
    if serve:
        def serve_once():
            t0 = time.time()
            rs = eng.online_many(qs, union="device")
            cold_s = time.time() - t0
            got = [r.answer_count for r in rs]
            assert got == answers, "online_many answers != per-query"
            # Second pass = steady-state serving (the stacked bitmap
            # program compiles once per process; a serving deployment
            # pays that once, not per batch).
            t0 = time.time()
            rs = eng.online_many(qs, union="device")
            serving_s = time.time() - t0
            assert [r.answer_count for r in rs] == answers
            return dict(
                queries=len(qs), cold_s=round(cold_s, 2),
                serving_s=round(serving_s, 2),
                qps=round(len(qs) / serving_s, 2),
                amortized_ms=round(serving_s * 1e3 / len(qs), 1),
                speedup_vs_sequential=round(
                    float(np.sum(lat)) / (serving_s * 1e3), 2))

        try:
            serving = serve_once()
        except Exception as exc:           # noqa: BLE001
            # Memory-pressure recovery: the stacked dispatch competes
            # with a full leaf cache pool for HBM; evict + shrink the
            # cache and retry once before recording a failure.
            if ("RESOURCE_EXHAUSTED" in repr(exc)
                    and eng.sharded.streamed):
                nb = eng.sharded.degrade_cache(0.5)
                print(f"[ladder:{name}] PE serving OOM -> cache "
                      f"degraded to {nb/1e9:.1f} GB, retrying",
                      file=sys.stderr)
                try:
                    serving = serve_once()
                    serving["degraded_cache_bytes"] = int(nb)
                except Exception as exc2:  # noqa: BLE001
                    serving = dict(error=repr(exc2)[:300],
                                   degraded_cache_bytes=int(nb))
            else:
                serving = dict(error=repr(exc)[:300])
            if "error" in (serving or {}):
                print(f"[ladder:{name}] PE SERVING FAILED: {serving}",
                      file=sys.stderr)
    emit(dict(
        rung=name, variant="pe", l=pe_l, v=g.num_vertices,
        e=g.num_edges, paths=num_paths,
        mode="streamed" if eng.sharded.streamed else "resident",
        loaded_from=pe_load or None, build_note=build_note or None,
        enumerate_s=round(enum_s, 2), index_build_s=round(build_s, 2),
        build_phase_ms=eng.sharded.build_phase_ms,
        pipeline=pipe_timings,
        pipeline_vs_sequential=ab,
        warm_s=round(warm_s, 2),
        prefill_s=prefill_s, prefill_blocks=prefill_blocks,
        index_bytes=index_bytes, queries=len(lat),
        max_answers=max_answers,
        online_p50_ms=round(float(np.median(lat)), 1),
        online_p90_ms=round(float(np.percentile(lat, 90)), 1),
        stage_p50_ms={k: round(float(np.median(v)), 1)
                      for k, v in stages.items()},
        stage_p90_ms={k: round(float(np.percentile(v, 90)), 1)
                      for k, v in stages.items()},
        chunks_p50=(round(float(np.median(chunk_counts)), 1)
                    if chunk_counts else None),
        chunks_p90=(round(float(np.percentile(chunk_counts, 90)), 1)
                    if chunk_counts else None),
        blocks_survived_p50=(round(float(np.median(survived)), 1)
                             if survived else None),
        cache_hit_rate_p50=(round(float(np.median(hit_rates)), 3)
                            if hit_rates else None),
        cache_hit_rate_min=(round(float(np.min(hit_rates)), 3)
                            if hit_rates else None),
        num_blocks=int(eng.sharded.num_blocks),
        mean_answers=round(float(np.mean(answers)), 1),
        serving=serving,
        spot_verified=bool(spot_ok),
        spot_verified_p90=bool(spot_ok_p90),
        spot_error=spot_err))
    print(f"[ladder:{name}] PE l={pe_l}: paths={num_paths} "
          f"enum={enum_s:.1f}s build={build_s:.1f}s "
          f"idx={index_bytes/1e6:.0f}MB p50={np.median(lat):.0f}ms "
          f"p90={np.percentile(lat, 90):.0f}ms",
          file=sys.stderr)
    # Free PE device state (HBM cache pool, tables) BEFORE the PGE
    # offline fold — both resident at youtube scale is an OOM.
    eng.sharded.close()
    del eng
    if pe_only:
        return rows
    return _run_pge(name, g, qs, mesh, max_answers, serve, emit,
                    rows)


def _run_pge(name, g, qs, mesh, max_answers, serve, emit, rows):
    """The PGE half of a rung — separable so --pge-only can recover a
    PGE row in a fresh process when the PE half of a previous run
    crashed after emitting its row (e.g. the r5 youtube serving OOM
    took down the in-process PGE pass)."""
    from gnnpe_tpu.config import PGEConfig
    from gnnpe_tpu.engine import PGEEngine
    from gnnpe_tpu.paths.enumerate import enumerate_paths

    cfg2 = PGEConfig.from_cli(l=2, e=2, p=5, n=max_answers)
    eng2 = PGEEngine(cfg2, g)
    t0 = time.time()
    eng2.offline(device=True, packed=True)
    pge_off_s = time.time() - t0
    eng2.attach_mesh(mesh, packed=True)
    warm2_s = eng2.sharded.warm()
    lat2 = []
    answers2 = []
    skipped = 0
    stages2 = {"query_plan": [], "search": [], "refine": []}
    chunk_counts2, survived2 = [], []
    qs_ok = []
    for q in qs:
        t0 = time.time()
        try:
            r = eng2.online(q)
        except ValueError:      # query vertex with no path: skip (ref
            skipped += 1        # reads uninitialized memory here)
            continue
        lat2.append((time.time() - t0) * 1e3)
        answers2.append(r.answer_count)
        qs_ok.append(q)
        for k in stages2:
            stages2[k].append(r.timings_ms.get(k, 0.0))
        st = eng2.sharded.last_stats
        if st is not None:
            chunk_counts2.append(st["chunks"])
            survived2.append(st["survived"])

    # Spot verification (VERDICT r3 item 3 / r4 item 5): query 0 AND
    # the heaviest (max-chunk) query, checked bit-equal against the
    # flat exact PGE filter — one shot where its [V, D] broadcasts
    # fit (≤5M vertices), streamed over vertex chunks beyond
    # (pge_candidates_chunked — implementation-independent of every
    # packed index, unlike the r4 host packed-walk fallback).
    from gnnpe_tpu.embed.pde import path_groups
    from gnnpe_tpu.match.filter import (pge_candidates,
                                        pge_candidates_chunked)

    def pge_spot(qg) -> bool:
        qv2 = eng2.embedder(qg)
        qp2, _ = enumerate_paths(qg, np.arange(qg.num_vertices),
                                 cfg2.path_length, dedup=False)
        qg2, qlg2 = path_groups(qv2, qp2[:, 0], qp2, cfg2.pde_dim)
        ids2 = list(range(qg.num_vertices))
        fn = (pge_candidates if g.num_vertices <= 5_000_000
              else pge_candidates_chunked)
        oracle2 = fn(eng2.vertices.labels, eng2.vertices.degrees,
                     eng2.group, eng2.label_group,
                     qv2.labels, qv2.degrees, qg2, qlg2,
                     q_vertex_ids=ids2, epsilon=cfg2.epsilon)
        packed2 = eng2.sharded.search(qv2.labels, qv2.degrees,
                                      qg2, qlg2, ids2)
        ok = all(np.array_equal(a, b)
                 for a, b in zip(oracle2, packed2))
        assert ok, "PGE packed search != host oracle on spot query"
        return ok

    spot_ok2 = spot_ok2_p90 = None
    spot_err2 = None
    if qs_ok:
        try:
            spot_ok2 = pge_spot(qs_ok[0])
            heavy2 = (int(np.argmax(chunk_counts2))
                      if chunk_counts2 else 0)
            spot_ok2_p90 = (pge_spot(qs_ok[heavy2]) if heavy2 != 0
                            else spot_ok2)
        except Exception as exc:           # noqa: BLE001
            spot_ok2 = spot_ok2_p90 = False
            spot_err2 = repr(exc)[:300]
            print(f"[ladder:{name}] PGE SPOT-CHECK FAILED: "
                  f"{spot_err2}", file=sys.stderr)

    # Batched serving (VERDICT r4 item 6): the per-query dispatch
    # floor (33 pipelined chunks per patents query) collapses into ONE
    # chunk loop shared by every stacked query.
    serving2 = None
    if serve and qs_ok:
        try:
            t0 = time.time()
            rs2 = eng2.online_many(qs_ok, union="device")
            cold2_s = time.time() - t0
            got2 = [r.answer_count for r in rs2]
            assert got2 == answers2, "PGE online_many != per-query"
            t0 = time.time()
            rs2 = eng2.online_many(qs_ok, union="device")
            serving2_s = time.time() - t0
            assert [r.answer_count for r in rs2] == answers2
            serving2 = dict(
                queries=len(qs_ok), cold_s=round(cold2_s, 2),
                serving_s=round(serving2_s, 2),
                qps=round(len(qs_ok) / serving2_s, 2),
                amortized_ms=round(serving2_s * 1e3 / len(qs_ok), 1),
                speedup_vs_sequential=round(
                    float(np.sum(lat2)) / (serving2_s * 1e3), 2))
        except Exception as exc:           # noqa: BLE001
            serving2 = dict(error=repr(exc)[:300])
            print(f"[ladder:{name}] PGE SERVING FAILED: {serving2}",
                  file=sys.stderr)

    # Honest index accounting (VERDICT r4 item 8): count what the
    # device search actually holds — per-entry limb arrays, block
    # summaries, and the order map — not just the host group tables.
    sh2 = eng2.sharded
    index_bytes2 = int(
        sh2.d_labels.nbytes + sh2.d_degrees.nbytes
        + sum(a.nbytes for t in (sh2.d_ghi3, sh2.d_llo3, sh2.d_lhi3,
                                 sh2.b_gub3, sh2.b_llo3, sh2.b_lhi3)
              for a in t)
        + sh2.b_deg.nbytes + sh2.d_order.nbytes + sh2._order.nbytes)
    emit(dict(
        rung=name, variant="pge", l=2, v=g.num_vertices, e=g.num_edges,
        offline_s=round(pge_off_s, 2), warm_s=round(warm2_s, 2),
        index_bytes=index_bytes2,
        host_group_bytes=int(eng2.group.nbytes
                             + eng2.label_group.nbytes),
        queries=len(lat2), skipped=skipped, max_answers=max_answers,
        online_p50_ms=round(float(np.median(lat2)), 1),
        online_p90_ms=round(float(np.percentile(lat2, 90)), 1),
        stage_p50_ms={k: round(float(np.median(v)), 1)
                      for k, v in stages2.items()},
        stage_p90_ms={k: round(float(np.percentile(v, 90)), 1)
                      for k, v in stages2.items()},
        chunks_p50=(round(float(np.median(chunk_counts2)), 1)
                    if chunk_counts2 else None),
        chunks_p90=(round(float(np.percentile(chunk_counts2, 90)), 1)
                    if chunk_counts2 else None),
        blocks_survived_p50=(round(float(np.median(survived2)), 1)
                             if survived2 else None),
        mean_answers=round(float(np.mean(answers2)), 1),
        serving=serving2,
        spot_verified=bool(spot_ok2),
        spot_verified_p90=bool(spot_ok2_p90),
        spot_error=spot_err2))
    print(f"[ladder:{name}] PGE l=2: offline={pge_off_s:.1f}s "
          f"p50={np.median(lat2):.0f}ms skipped={skipped}",
          file=sys.stderr)
    eng2.sharded.close()
    del eng2
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="dblp",
                    help="ladder rung name or comma list")
    ap.add_argument("--queries", type=int, default=50)
    ap.add_argument("--query-size", type=int, default=8)
    ap.add_argument("--out", default="ladder_rows.jsonl")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-answers", type=int, default=100_000,
                    help="refinement emission cap (ref -n flag); the "
                         "dblp rung has queries with ~2.5e9 matches")
    ap.add_argument("--sequential", action="store_true",
                    help="disable the pipelined offline stage")
    ap.add_argument("--force-streamed", action="store_true",
                    help="force streamed (HBM-wall) PE index mode "
                         "even when the table would fit HBM")
    ap.add_argument("--prefill-seconds", type=float, default=300.0,
                    help="cache-prefill budget for streamed rungs")
    ap.add_argument("--no-serve", action="store_true",
                    help="skip the batched-serving measurement")
    ap.add_argument("--ab-sequential", action="store_true",
                    help="also rebuild the PE index sequentially "
                         "(monolithic r4 path) and record the "
                         "pipeline_vs_sequential speedup in the row")
    ap.add_argument("--pe-only", action="store_true",
                    help="skip the PGE pass (used for PE-focused "
                         "re-runs, e.g. the forced-streamed A/B)")
    ap.add_argument("--pge-only", action="store_true",
                    help="skip the PE pass (recover a PGE row in a "
                         "fresh process)")
    ap.add_argument("--pe-load", default="",
                    help="serve a persisted PE index "
                         "(DevicePackedPESearch.save .npz) instead "
                         "of rebuilding")
    ap.add_argument("--build-note", default="",
                    help="provenance note recorded in the PE row")
    ap.add_argument("--pe-max-paths", type=float,
                    default=2_000_000_000,
                    help="PE l=2 feasibility cap in entries; the "
                         "disk-tier bucketed build lifts the old "
                         "host-RAM wall (youtube_skew l=2 ≈ 4.2e9)")
    args = ap.parse_args(argv)
    all_rows = []
    for name in args.dataset.split(","):
        all_rows.extend(run_rung(name.strip(), queries=args.queries,
                                 query_size=args.query_size,
                                 seed=args.seed,
                                 max_answers=args.max_answers,
                                 pipelined=not args.sequential,
                                 prefill_seconds=args.prefill_seconds,
                                 force_streamed=args.force_streamed,
                                 serve=not args.no_serve,
                                 ab_sequential=args.ab_sequential,
                                 pe_only=args.pe_only,
                                 pge_only=args.pge_only,
                                 pe_load=args.pe_load,
                                 build_note=args.build_note,
                                 pe_max_paths=int(args.pe_max_paths),
                                 out_path=args.out))
    print(json.dumps(all_rows))
    failed = [f"{r['rung']}/{r['variant']}" for r in all_rows
              if r.get("spot_error") or r.get("spot_verified") is False
              or r.get("spot_verified_p90") is False
              or "error" in (r.get("serving") or {})]
    if failed:
        print(f"[ladder] FAILED (rows written): {', '.join(failed)}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
