"""Pipelined offline stage: overlap enumeration, embedding, and
index-block construction.

SURVEY.md §2.3 "pipeline offline stages (enumerate → embed → index) as
overlapping device streams": JAX dispatch is asynchronous, so the host
can enumerate chunk k+1 while the device embeds chunk k — no explicit
stream management needed, just chunked dispatch with the dependency
chain left un-synchronized until the end.  Gains are real whenever
enumeration (host) and embedding (device) are comparable costs — the
patents/synth ladder rungs.

The output equals the unpipelined stage exactly: chunks partition the
start-vertex order, and both enumeration order and the PDE gather are
chunk-local.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from gnnpe_tpu.graph.csr import CSRGraph
from gnnpe_tpu.paths.enumerate import enumerate_paths_from


def offline_pipelined(graph: CSRGraph, order: np.ndarray,
                      num_vertices_per_path: int, label_table,
                      chunk_starts: int = 4096
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Enumerate paths and compute their f32 PDE embeddings with
    host/device overlap.  Returns (paths int32[P, L], pde f32[P, L*D]).

    label_table: f32[num_labels, D] per-label features (the fixed
    mt19937 table or trained embeddings); vertex features are
    x[v] = table[label[v]] and vde = x + Σ_nbr x, computed once on
    device, then PDE rows are gathered per chunk as paths arrive.
    """
    import jax
    import jax.numpy as jnp
    from gnnpe_tpu.ops.spmm import neighbor_sum

    src, dst = graph.coo()
    labels = jnp.asarray(graph.labels)
    table = jnp.asarray(label_table, dtype=jnp.float32)

    @jax.jit
    def vde_fn(table):
        x = jnp.take(table, labels, axis=0)
        nx = neighbor_sum(jnp.asarray(src), jnp.asarray(dst), x,
                          graph.num_vertices)
        return x + nx

    vde = vde_fn(table)                      # async dispatch

    @jax.jit
    def embed_chunk(vde, rows):
        p, l = rows.shape
        return jnp.take(vde, rows.reshape(-1), axis=0).reshape(p, -1)

    path_chunks: List[np.ndarray] = []
    pde_futures = []
    for lo in range(0, len(order), chunk_starts):
        chunk = enumerate_paths_from(
            graph, order[lo:lo + chunk_starts], num_vertices_per_path)
        if chunk.shape[0] == 0:
            continue
        path_chunks.append(chunk)
        # Dispatch device embedding WITHOUT blocking: the next chunk's
        # host enumeration overlaps this chunk's device gather.
        pde_futures.append(embed_chunk(vde, jnp.asarray(chunk)))
    if not path_chunks:
        d = label_table.shape[1]
        return (np.zeros((0, num_vertices_per_path), np.int32),
                np.zeros((0, num_vertices_per_path * d), np.float32))
    paths = np.concatenate(path_chunks, axis=0)
    pde = np.concatenate([np.asarray(f) for f in pde_futures], axis=0)
    return paths, pde


def offline_build_pipelined(graph: CSRGraph, order: np.ndarray,
                            num_vertices_per_path: int, vertices,
                            mesh, block_size: int = 512,
                            chunk_starts: int = 16384,
                            workers: int = 8,
                            resident=None):
    """Pipelined PE offline stage THROUGH index build (VERDICT r2 item
    6): thread-parallel chunked enumeration overlapped with per-chunk
    sort-key computation, then one global dedup + stable argsort +
    device fold.

    The sort-based index makes the merge trivial: chunk keys are
    independent (composite_sort_key), so the only global steps are the
    reverse-orientation dedup, ONE np.argsort over the concatenated
    keys, and the single-dispatch device fold — everything else runs
    concurrently on the worker pool (numpy releases the GIL in the
    vectorized expansion/gather ops).

    Output is IDENTICAL to the sequential
    ``enumerate_paths(dedup=True)`` + ``build_from_paths`` pipeline:
    chunks partition the start order, dedup keeps the first-seen
    orientation which is chunk-order invariant, and the final sort is
    over the same keys.

    Returns (paths int32[P, L], DevicePackedPESearch, timings dict).
    """
    import threading
    import time
    from concurrent.futures import ThreadPoolExecutor

    from gnnpe_tpu.index.device_packed import (ChunkUploader,
                                               DevicePackedPESearch,
                                               composite_sort_key,
                                               key_tables,
                                               pe_pad_shapes)
    from gnnpe_tpu.paths.enumerate import (dedup_orientations_streaming,
                                           start_ranks)

    t_all = time.perf_counter()
    rank = start_ranks(order, graph.num_vertices)
    # Key tables hoisted OUT of the chunk loop: composite_sort_key's
    # outward-rounded vde copy is an O(V·D) nextafter pass — recomputed
    # per chunk it was ~all of synth100m's 903 s "enumeration" time
    # (1220 chunks × O(20M)); hoisted, keys cost O(paths) only.
    ktabs = key_tables(vertices)

    # Exact dedup'd path count, known BEFORE enumeration for 2- and
    # 3-vertex paths (one orientation per undirected edge; Σdeg(deg-1)
    # directed 3-paths, halved by the rank dedup).  Knowing p up front
    # lets the device buffer and the fold program's compile happen
    # DURING enumeration — and lets the unsorted vid rows stream to
    # the device as each chunk's dedup completes, instead of one
    # serial upload after the sort.
    deg_all = np.diff(graph.offsets).astype(np.int64)
    if num_vertices_per_path == 2:
        known_p = int(graph.num_edges)
    elif num_vertices_per_path == 3:
        known_p = int((deg_all * (deg_all - 1)).sum()) // 2
    else:
        known_p = None
    # Capacity model (VERDICT r3 item 1): the device-resident leaf
    # table costs l·p_pad·4 bytes of HBM; past the budget the build
    # switches to STREAMED mode — sorted table host-RAM-resident,
    # summaries folded on host, phase 2 uploads surviving chunks per
    # dispatch.  The reference has the same property via its
    # disk-paged R-tree (blk_file.cpp), just ~10^3× slower media.
    from gnnpe_tpu.index.device_packed import auto_resident
    n_sh = mesh.shape["graph"]
    if resident is None:
        resident = (True if known_p is None else auto_resident(
            known_p, num_vertices_per_path, block_size,
            graph.num_vertices, n_sh))
    uploader = None
    prewarm = None
    if resident and known_p is not None and known_p > 0:
        from gnnpe_tpu.index.device_packed import device_memory_bytes
        p_pad, _, _, _ = pe_pad_shapes(known_p, block_size,
                                       graph.num_vertices, n_sh)
        # The streamed-build overlap transiently holds ~3 table-sized
        # device buffers (uploader buf + prewarm input + fold output);
        # near the auto_resident boundary (table = 0.35·HBM) that is
        # ~1.05·HBM plus XLA scratch (ADVICE r4 item 2).  Only overlap
        # when the transient fits; otherwise build resident via the
        # plain whole-table upload (one table + fold output ≈ 2×).
        hbm = device_memory_bytes()
        table_bytes = num_vertices_per_path * p_pad * 4
        if 3 * table_bytes <= 0.8 * hbm * n_sh:
            uploader = ChunkUploader(mesh, num_vertices_per_path,
                                     p_pad,
                                     sentinel=graph.num_vertices)
            prewarm = threading.Thread(
                target=DevicePackedPESearch.prewarm_fold,
                args=(mesh, num_vertices_per_path, vertices.dim,
                      known_p, graph.num_vertices, block_size),
                daemon=True)
            prewarm.start()

    if num_vertices_per_path == 2:
        # l=1 fast path: 2-vertex paths ARE the arc list, already in
        # enumeration order (starts in rank order, CSR neighbors
        # ascending) — no chunk loop, no expansion.
        t0 = time.perf_counter()
        deg = np.diff(graph.offsets).astype(np.int64)
        src = np.repeat(np.asarray(order, np.int64), deg[order])
        starts_ = graph.offsets[order].astype(np.int64)
        row_start = np.concatenate([[0], np.cumsum(deg[order])])[:-1]
        rep = np.repeat(np.arange(len(order), dtype=np.int64),
                        deg[order])
        local = np.arange(len(src), dtype=np.int64) - row_start[rep]
        dst = graph.neighbors[starts_[rep] + local].astype(np.int64)
        keep = rank[src] < rank[dst]
        paths = np.stack([src[keep], dst[keep]], axis=1) \
            .astype(np.int32)
        if uploader is not None:
            uploader.feed(paths)     # async; overlaps key computation
        keys = composite_sort_key(paths, vertices, tables=ktabs)
        t_enum_keys = time.perf_counter() - t_all
        t_dedup = 0.0
    else:
        # Streamed builds route through the bucketed out-of-core sort
        # (index/bucket_build.py — VERDICT r4 items 2/3): chunk rows
        # range-partition by key inside the worker threads, buckets
        # sort/write/fold in parallel after enumeration, and the
        # sorted table lands in a np.memmap (the disk tier) when it
        # exceeds the host-RAM budget.  NOTE: the returned ``paths``
        # are then in INDEX (sorted) order, not enumeration order —
        # the same multiset; candidate semantics are order-free.
        spill = None
        bucketed = (not resident) and known_p is not None \
            and known_p > 0
        t_sample = 0.0
        if bucketed:
            import os
            from gnnpe_tpu.index.bucket_build import (
                BucketSpill, host_ram_bytes, sample_key_boundaries)
            t0 = time.perf_counter()
            n_buckets = int(max(8, min(1024,
                                       known_p // 32_000_000 + 1)))
            bounds = sample_key_boundaries(
                graph, order, num_vertices_per_path, vertices,
                n_buckets)
            est_bytes = known_p * (num_vertices_per_path * 4 + 8)
            base = os.environ.get(
                "GNNPE_SPILL_DIR",
                os.path.join(os.getcwd(), ".cache", "gnnpe_spill"))
            spill_dir = None
            if est_bytes > 0.4 * host_ram_bytes():
                spill_dir = os.path.join(base, f"spill_{os.getpid()}")
            spill = BucketSpill(bounds, num_vertices_per_path,
                                spill_dir)
            t_sample = time.perf_counter() - t0

        # Cost-balanced chunking: starts are degree-SORTED, so fixed
        # start-count chunks put nearly all paths in the last few
        # chunks (a 4096-degree start yields ~16.7M 3-vertex paths);
        # with 8 in-flight workers that is an OOM.  Split by estimated
        # per-start path cost (deg·(deg-1) for 3-vertex paths) so each
        # chunk holds ≤ ~32M paths regardless of where it falls.
        if num_vertices_per_path == 3:
            # EXACT directed 3-path count per start v:
            # Σ_{w∈N(v)} (deg(w)-1).  (deg_v·(deg_v-1) is the per-
            # MIDDLE count — it misses that a 28k-degree hub puts its
            # ~8e8 paths on its *neighbors'* start chunks, which is
            # precisely the youtube_skew failure mode.)
            contrib = np.maximum(
                deg_all[graph.neighbors.astype(np.int64)] - 1, 0)
            cum_e = np.concatenate([[0], np.cumsum(contrib)])
            per_start = (cum_e[graph.offsets[1:]]
                         - cum_e[graph.offsets[:-1]])
            cost = per_start[order].astype(np.int64)
        else:
            cost = np.maximum(
                deg_all[order].astype(np.float64)
                ** (num_vertices_per_path - 1), 1.0).astype(np.int64)
        cum = np.cumsum(cost)
        chunk_paths = 32_000_000
        ncut = max(1, int(cum[-1] // chunk_paths))
        cuts = np.searchsorted(
            cum, np.arange(1, ncut + 1) * chunk_paths)
        starts_cuts = np.arange(chunk_starts, len(order), chunk_starts)
        bounds = np.unique(np.concatenate(
            [cuts, starts_cuts, [len(order)]]))
        bounds = bounds[(bounds > 0) & (bounds <= len(order))]
        chunks = [order[lo:hi] for lo, hi in
                  zip(np.concatenate([[0], bounds[:-1]]), bounds)
                  if hi > lo]

        def work(c):
            # Dedup is ROW-LOCAL (rank[first] < rank[last]), so it
            # applies per chunk — survivors only get keys, and the
            # whole enumerate→dedup→key→partition chain runs inside
            # the overlap.
            rows = enumerate_paths_from(graph, c, num_vertices_per_path)
            rows = rows[dedup_orientations_streaming(rows, rank)]
            keys = composite_sort_key(rows, vertices, tables=ktabs)
            if spill is not None:
                return spill.partition(rows, keys)
            return rows, keys

        results = []
        with ThreadPoolExecutor(max_workers=workers) as pool:
            # Consume lazily IN ORDER: each finished chunk's rows feed
            # the device uploader / the bucket spill immediately
            # (transfers and spill writes ride alongside enumeration
            # still running on the worker pool).
            for res in pool.map(work, chunks):
                if spill is not None:
                    spill.append(res)
                    continue
                if uploader is not None:
                    uploader.feed(res[0])
                results.append(res)
        t_enum_keys = time.perf_counter() - t_all

        if spill is not None:
            import os
            from gnnpe_tpu.index.bucket_build import (
                build_streamed_bucketed, host_ram_bytes)
            from gnnpe_tpu.index.device_packed import \
                pe_pad_shapes as _pps
            t0 = time.perf_counter()
            p_pad, _, _, nbl = _pps(spill.total, block_size,
                                    graph.num_vertices, n_sh,
                                    pow2=False)
            ent_rows = n_sh * nbl * block_size
            table_bytes = ent_rows * num_vertices_per_path * 4
            table_path = None
            if table_bytes > 0.3 * host_ram_bytes() \
                    or os.environ.get("GNNPE_FORCE_MEMMAP"):
                base = os.environ.get(
                    "GNNPE_SPILL_DIR",
                    os.path.join(os.getcwd(), ".cache",
                                 "gnnpe_spill"))
                os.makedirs(base, exist_ok=True)
                table_path = os.path.join(
                    base, f"leaf_table_{os.getpid()}.bin")
            idx = build_streamed_bucketed(
                mesh, spill, vertices, num_vertices_per_path,
                block_size=block_size, table_path=table_path)
            t_build = time.perf_counter() - t0
            timings = {"enum_keys_s": round(t_enum_keys, 2),
                       "sample_s": round(t_sample, 2),
                       "dedup_s": 0.0,
                       "build_s": round(t_build, 2),
                       "total_s": round(
                           time.perf_counter() - t_all, 2),
                       "n_buckets": spill.nb,
                       "spilled_to_disk": spill.dir is not None,
                       "table_memmap": table_path is not None,
                       "mode": "streamed"}
            return idx._host_vids[:spill.total], idx, timings

        t0 = time.perf_counter()
        paths = np.concatenate([r[0] for r in results], axis=0)
        keys = np.concatenate([r[1] for r in results])
        del results
        t_dedup = time.perf_counter() - t0

    t0 = time.perf_counter()
    preuploaded = None
    if uploader is not None:
        if prewarm is not None:
            prewarm.join()
        buf, fed = uploader.finish()
        # A wrong closed-form count means the device buffer was sized
        # for the wrong p_pad — fall back to the whole-table upload
        # rather than build a bad index.  (``fed`` always equals
        # len(paths) by construction, so the real guard is known_p;
        # ADVICE r4 item 3.)
        if known_p == len(paths) and fed == known_p:
            preuploaded = (buf, fed)
    idx = DevicePackedPESearch.build_from_paths(
        mesh, paths, vertices, block_size=block_size,
        precomputed_key=keys, preuploaded=preuploaded,
        resident=resident)
    t_build = time.perf_counter() - t0
    timings = {"enum_keys_s": round(t_enum_keys, 2),
               "dedup_s": round(t_dedup, 2),
               "build_s": round(t_build, 2),
               "total_s": round(time.perf_counter() - t_all, 2),
               "mode": "resident" if resident else "streamed"}
    return paths, idx, timings
