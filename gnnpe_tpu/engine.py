"""End-to-end PE / PGE engines: the stage pipeline of the reference CLI
drivers (GNN-PE/src/main.cpp, GNN-PGE/src/main.cpp), array-first.

Stage contract (checkpoint/resume mirrors the reference's staged
artifacts, SURVEY.md §5):
  prepare  → membership                    (ref: gnnpe.py → membership.txt)
  offline  → paths / per-vertex groups     (ref: all_paths.txt,
                                            partition_paths.txt,
                                            data_vertices.bin)
  online   → candidates → refinement → N   (ref: "Answer Number: N")

Partitions shard work only; the candidate union is invariant to
membership (SURVEY.md §3.3).  The online path filters per partition and
unions — same contract as the reference's OpenMP loop + serial union
(main.cpp:155-172) — or in one fused pass when unsharded.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from gnnpe_tpu.config import PEConfig, PGEConfig
from gnnpe_tpu.embed.pde import (gen_pde, gen_query_pde_table, path_groups,
                                 path_group_keys)
from gnnpe_tpu.embed.vde import gen_vde
from gnnpe_tpu.graph.csr import CSRGraph
from gnnpe_tpu.graph.partition import degree_sorted_nodes, partition_graph
from gnnpe_tpu.match.filter import pe_candidates, pge_candidates
from gnnpe_tpu.match.plan import greedy_path_cover
from gnnpe_tpu.match.refine import refinement
from gnnpe_tpu.paths.enumerate import enumerate_paths
from gnnpe_tpu.utils.timers import StageTimer


@dataclass
class MatchResult:
    answer_count: int
    candidates: List[np.ndarray]
    timings_ms: dict
    embeddings: Optional[np.ndarray] = None


class PEEngine:
    """GNN-PE variant: per-path index entries, position-wise filtering."""

    def __init__(self, config: PEConfig, data_graph: CSRGraph,
                 membership: Optional[np.ndarray] = None,
                 embedder=None):
        """embedder: callable(graph) -> VertexEmbeddings; defaults to
        the reference's fixed label-seeded VDE.  A trained non-negative
        PathGNN (models/embedder.py) drops in here — its monotone
        layers preserve the dominance invariant, so exactness holds."""
        self.config = config
        self.graph = data_graph
        self.embedder = embedder or (
            lambda g: gen_vde(g, config.vde_dim))
        self.membership = (membership if membership is not None
                           else partition_graph(data_graph,
                                                config.partition_num,
                                                strategy="auto"))
        self.paths = None
        self.partition_rows = None
        self.data_pde = None
        self.vertices = None
        self.index = None
        self.sharded = None

    def offline(self, device: bool = False):
        """Enumerate + dedup paths and shard them (ref main.cpp:75-120).
        device=True runs the expansion hops on the accelerator
        (paths/device_enumerate.py) — same paths, same order."""
        order = degree_sorted_nodes(self.graph)
        if device:
            from gnnpe_tpu.paths.device_enumerate import \
                enumerate_paths_device
            from gnnpe_tpu.paths.enumerate import (
                dedup_orientations_streaming, start_ranks)
            rows = enumerate_paths_device(self.graph, order,
                                          self.config.path_length)
            rank = start_ranks(order, self.graph.num_vertices)
            self.paths = rows[dedup_orientations_streaming(rows, rank)]
            owner = self.membership[self.paths[:, 0]]
            nparts = int(self.membership.max()) + 1
            self.partition_rows = [
                np.nonzero(owner == pid)[0].astype(np.int64)
                for pid in range(nparts)]
        else:
            self.paths, self.partition_rows = enumerate_paths(
                self.graph, order, self.config.path_length, dedup=True,
                membership=self.membership)
        return self

    def build_index(self, packed: bool = True, block_size: int = 512):
        """Embed all paths (ref gen_vde+gen_pde, main.cpp:124-126) and
        build the packed dominance index (the R*-tree replacement; the
        flat filter remains the semantic ground truth and the fallback)."""
        self.vertices = self.embedder(self.graph)
        self.data_pde = gen_pde(self.vertices, self.paths)
        if packed:
            from gnnpe_tpu.index.packed import PackedDominanceIndex
            self.index = PackedDominanceIndex.build(
                self.data_pde, block_size=block_size)
        else:
            self.index = None
        return self

    def attach_mesh(self, mesh, axis: str = "graph",
                    packed: bool = False):
        """Shard the path table over ``mesh``'s ``axis`` for distributed
        online search (the SPMD form of the reference's per-partition
        OpenMP search + serial union, main.cpp:155-172).

        packed=True shards the packed dominance index instead of the
        flat table: block summaries prune on device before the leaf
        pass (index/device_packed.py) — same candidates, less
        device-memory traffic at scale.  Requires build_index(packed=True) first."""
        assert self.data_pde is not None, "call offline() + build_index()"
        if packed:
            from gnnpe_tpu.index.device_packed import DevicePackedPESearch
            assert self.index is not None, "build_index(packed=True) first"
            self.sharded = DevicePackedPESearch(
                mesh, self.index, axis=axis,
                base_epsilon=self.config.epsilon)
        else:
            from gnnpe_tpu.parallel.query import ShardedPESearch
            self.sharded = ShardedPESearch(
                mesh, self.data_pde, axis=axis,
                base_epsilon=self.config.epsilon)
        return self

    def online(self, query_graph: CSRGraph, engine: str = "auto",
               return_embeddings: bool = False,
               union: str = "host", preverify: int = 0) -> MatchResult:
        assert (self.data_pde is not None or self.index is not None
                or self.sharded is not None), \
            "call offline() + build_index() (or load a persisted index)"
        t = StageTimer()
        with t.stage("query_plan"):
            q_vertices = self.embedder(query_graph)
            q_paths, _ = enumerate_paths(
                query_graph, np.arange(query_graph.num_vertices),
                self.config.path_length, dedup=True)
            q_pde, weight, key = gen_query_pde_table(q_vertices, q_paths)
            plan = greedy_path_cover(q_paths, weight,
                                     query_graph.num_vertices)
        with t.stage("search"):
            if self.sharded is not None:
                cands = self.sharded.search(q_pde, plan,
                                            query_graph.num_vertices,
                                            union=union)
            elif self.index is not None:
                cands = self.index.search(q_pde, plan,
                                          query_graph.num_vertices,
                                          epsilon=self.config.epsilon)
            else:
                cands = pe_candidates(self.data_pde, q_pde, plan,
                                      query_graph.num_vertices,
                                      epsilon=self.config.epsilon)
        if preverify:
            with t.stage("preverify"):
                from gnnpe_tpu.match.preverify import semijoin_prune
                cands = semijoin_prune(self.graph, query_graph, cands,
                                       iters=preverify)
        with t.stage("refine"):
            res = refinement(self.graph, query_graph, cands,
                             self.config.max_answers, engine=engine,
                             return_embeddings=return_embeddings)
        count, emb = res if return_embeddings else (res, None)
        return MatchResult(answer_count=int(count), candidates=cands,
                           timings_ms=t.times_ms, embeddings=emb)

    def online_many(self, query_graphs, engine: str = "auto",
                    preverify: int = 0,
                    union: str = "host") -> List[MatchResult]:
        """Batched serving: all queries' plan rows stack into ONE
        filter dispatch (query-vertex ids offset into a disjoint global
        space), then candidates split per query for refinement.  The
        reference has no multi-query story at all — its driver is one
        process per query (GNN-PE/src/main.cpp:122-182).

        union='device' routes the stacked search through the packed
        device-bitmap union (one [nq, V/32] download per stack) — the
        serving-scale path: the per-chunk leaf-mask download of the
        host union scales with the stacked query-bucket width."""
        from gnnpe_tpu.embed.pde import PathEmbeddings
        assert (self.data_pde is not None or self.index is not None
                or self.sharded is not None), \
            "call offline() + build_index() (or load a persisted index)"
        tables, bases = [], []
        base = 0
        for qg in query_graphs:
            qv = self.embedder(qg)
            q_paths, _ = enumerate_paths(
                qg, np.arange(qg.num_vertices),
                self.config.path_length, dedup=True)
            q_pde, weight, _ = gen_query_pde_table(qv, q_paths)
            plan = np.asarray(greedy_path_cover(q_paths, weight,
                                                qg.num_vertices))
            shifted = PathEmbeddings(
                vids=q_pde.vids[plan] + base, labels=q_pde.labels[plan],
                degrees=q_pde.degrees[plan], pde=q_pde.pde[plan],
                pde_label=q_pde.pde_label[plan])
            tables.append(shifted)
            bases.append(base)
            base += qg.num_vertices
        big = PathEmbeddings(
            vids=np.concatenate([t.vids for t in tables]),
            labels=np.concatenate([t.labels for t in tables]),
            degrees=np.concatenate([t.degrees for t in tables]),
            pde=np.concatenate([t.pde for t in tables]),
            pde_label=np.concatenate([t.pde_label for t in tables]))
        plan_all = np.arange(big.num_paths)
        if self.sharded is not None:
            cands_all = self.sharded.search(big, plan_all, base,
                                            union=union)
        elif self.index is not None:
            cands_all = self.index.search(big, plan_all, base,
                                          epsilon=self.config.epsilon)
        else:
            # Flat fallback: chunk plan rows so peak host memory stays
            # ~256 MB.  pe_pair_mask materializes [Q, P, L·D]-class
            # broadcast intermediates, so the budget divides by the
            # pde width, not just P (ADVICE r2).
            cands_all = [np.zeros(0, dtype=np.int64)
                         for _ in range(base)]
            step = max(1, int(256e6 // max(
                self.data_pde.num_paths
                * self.data_pde.pde.shape[1], 1)))
            for lo in range(0, big.num_paths, step):
                part = pe_candidates(
                    self.data_pde, big,
                    plan_all[lo:lo + step], base,
                    epsilon=self.config.epsilon)
                cands_all = [
                    np.union1d(a, b) for a, b in zip(cands_all, part)]
        per_query = [cands_all[b:b + qg.num_vertices]
                     for qg, b in zip(query_graphs, bases)]
        return _refine_batch(self.graph, query_graphs, per_query,
                             self.config.max_answers, engine, preverify)


def _refine_batch(graph, query_graphs, per_query_cands, max_answers,
                  engine, preverify) -> List[MatchResult]:
    """Shared tail of online_many: optional pruning, then refinement —
    threaded across queries when the native engine is in play (the
    ctypes call releases the GIL, so this is the reference's OpenMP
    parallel region in serving form, GNN-PE/src/main.cpp:160-164)."""
    if preverify:
        from gnnpe_tpu.match.preverify import semijoin_prune
        per_query_cands = [
            semijoin_prune(graph, qg, c, iters=preverify)
            for qg, c in zip(query_graphs, per_query_cands)]

    def one(qg, cands):
        t = StageTimer()
        with t.stage("refine"):
            count = refinement(graph, qg, cands, max_answers,
                               engine=engine)
        return MatchResult(answer_count=int(count), candidates=cands,
                           timings_ms=t.times_ms)

    if engine != "python" and len(query_graphs) > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=min(8, len(query_graphs))) \
                as pool:
            return list(pool.map(one, query_graphs, per_query_cands))
    return [one(qg, c) for qg, c in zip(query_graphs, per_query_cands)]


class PGEEngine:
    """GNN-PGE variant: per-vertex path-group boxes (exact on Test/)."""

    def __init__(self, config: PGEConfig, data_graph: CSRGraph,
                 membership: Optional[np.ndarray] = None,
                 embedder=None):
        self.config = config
        self.graph = data_graph
        self.embedder = embedder or (
            lambda g: gen_vde(g, config.vde_dim))
        self.membership = (membership if membership is not None
                           else partition_graph(data_graph,
                                                config.partition_num,
                                                strategy="auto"))
        self.vertices = None
        self.group = None
        self.label_group = None
        self.sharded = None

    def offline(self, packed: bool = True, device: bool = False,
                chunk_starts: int = 4096):
        """VDE + per-vertex path groups (ref GNN-PGE/src/main.cpp:91-177)
        + packed vertex index.  device=True streams the enumeration in
        start chunks and folds groups on the accelerator via the exact
        rank-space min/max (O(V) memory at any path count — the
        patents-rung scale path)."""
        self.vertices = self.embedder(self.graph)
        order = degree_sorted_nodes(self.graph)
        if device:
            from gnnpe_tpu.embed.pde import path_groups_device
            self.group, self.label_group = path_groups_device(
                self.vertices, self.graph, order,
                self.config.path_length, self.config.pde_dim,
                chunk_starts=chunk_starts)
        else:
            paths, _ = enumerate_paths(
                self.graph, order, self.config.path_length, dedup=False)
            self.group, self.label_group = path_groups(
                self.vertices, paths[:, 0], paths, self.config.pde_dim)
        if packed:
            from gnnpe_tpu.index.packed import PGEPackedIndex
            self.index = PGEPackedIndex.build(
                self.vertices.labels, self.vertices.degrees,
                self.group, self.label_group)
        else:
            self.index = None
        return self

    def attach_mesh(self, mesh, axis: str = "graph",
                    packed: bool = False):
        """Shard the vertex table over ``mesh`` for distributed online
        search (GNN-PGE/src/main.cpp:342-346's OpenMP loop, SPMD form).
        packed=True shards the packed vertex index (block pruning on
        device; requires offline(packed=True))."""
        assert self.group is not None, "call offline() first"
        if packed:
            from gnnpe_tpu.index.device_packed import \
                DevicePackedPGESearch
            assert getattr(self, "index", None) is not None, \
                "offline(packed=True) first"
            self.sharded = DevicePackedPGESearch(
                mesh, self.index, axis=axis,
                base_epsilon=self.config.epsilon)
        else:
            from gnnpe_tpu.parallel.query import ShardedPGESearch
            self.sharded = ShardedPGESearch(
                mesh, self.vertices.labels, self.vertices.degrees,
                self.group, self.label_group, axis=axis,
                base_epsilon=self.config.epsilon)
        return self

    def online(self, query_graph: CSRGraph, engine: str = "auto",
               return_embeddings: bool = False,
               union: str = "host", preverify: int = 0) -> MatchResult:
        assert self.group is not None, "call offline() first"
        t = StageTimer()
        with t.stage("query_plan"):
            qv = self.embedder(query_graph)
            q_paths, _ = enumerate_paths(
                query_graph, np.arange(query_graph.num_vertices),
                self.config.path_length, dedup=False)
            if len(q_paths) == 0:
                raise ValueError(
                    "query has a vertex with no path; unsupported (the "
                    "reference reads uninitialized memory here, "
                    "GNN-PGE/src/main.cpp:284-330)")
            q_group, q_label_group = path_groups(
                qv, q_paths[:, 0], q_paths, self.config.pde_dim)
        with t.stage("search"):
            nq = query_graph.num_vertices
            if self.sharded is not None:
                from gnnpe_tpu.index.device_packed import \
                    DevicePackedPGESearch
                if isinstance(self.sharded, DevicePackedPGESearch):
                    cands = self.sharded.search(
                        qv.labels, qv.degrees, q_group, q_label_group,
                        list(range(nq)), union=union)
                else:
                    cands = self.sharded.search(qv.labels, qv.degrees,
                                                q_group, q_label_group,
                                                list(range(nq)))
            elif getattr(self, "index", None) is not None:
                cands = self.index.search(qv.labels, qv.degrees,
                                          q_group, q_label_group,
                                          list(range(nq)),
                                          epsilon=self.config.epsilon)
            else:
                cands = pge_candidates(
                    self.vertices.labels, self.vertices.degrees,
                    self.group, self.label_group,
                    qv.labels, qv.degrees, q_group, q_label_group,
                    q_vertex_ids=list(range(nq)),
                    epsilon=self.config.epsilon)
        if preverify:
            with t.stage("preverify"):
                from gnnpe_tpu.match.preverify import semijoin_prune
                cands = semijoin_prune(self.graph, query_graph, cands,
                                       iters=preverify)
        with t.stage("refine"):
            res = refinement(self.graph, query_graph, cands,
                             self.config.max_answers, engine=engine,
                             return_embeddings=return_embeddings)
        count, emb = res if return_embeddings else (res, None)
        return MatchResult(answer_count=int(count), candidates=cands,
                           timings_ms=t.times_ms, embeddings=emb)

    def online_many(self, query_graphs, engine: str = "auto",
                    preverify: int = 0,
                    union: str = "host") -> List[MatchResult]:
        """Batched PGE serving: all queries' vertex tables stack into
        one filter dispatch, candidates split per query (see
        PEEngine.online_many).  union='device' uses the packed
        vertex-bitmap union when the packed device index is attached."""
        assert self.group is not None, "call offline() first"
        qls, qds, qgs, qlgs, sizes = [], [], [], [], []
        for qg in query_graphs:
            qv = self.embedder(qg)
            q_paths, _ = enumerate_paths(
                qg, np.arange(qg.num_vertices),
                self.config.path_length, dedup=False)
            if len(q_paths) == 0:
                raise ValueError("query has a vertex with no path")
            q_group, q_label_group = path_groups(
                qv, q_paths[:, 0], q_paths, self.config.pde_dim)
            qls.append(qv.labels)
            qds.append(qv.degrees)
            qgs.append(q_group)
            qlgs.append(q_label_group)
            sizes.append(qg.num_vertices)
        ql = np.concatenate(qls)
        qd = np.concatenate(qds)
        qgrp = np.concatenate(qgs)
        qlg = np.concatenate(qlgs)
        ids = list(range(len(ql)))
        if self.sharded is not None:
            from gnnpe_tpu.index.device_packed import \
                DevicePackedPGESearch
            if isinstance(self.sharded, DevicePackedPGESearch):
                cands_all = self.sharded.search(ql, qd, qgrp, qlg,
                                                ids, union=union)
            else:
                cands_all = self.sharded.search(ql, qd, qgrp, qlg, ids)
        elif getattr(self, "index", None) is not None:
            cands_all = self.index.search(ql, qd, qgrp, qlg, ids,
                                          epsilon=self.config.epsilon)
        else:
            cands_all = pge_candidates(
                self.vertices.labels, self.vertices.degrees,
                self.group, self.label_group, ql, qd, qgrp, qlg,
                q_vertex_ids=ids, epsilon=self.config.epsilon)
        per_query, b = [], 0
        for n in sizes:
            per_query.append(cands_all[b:b + n])
            b += n
        return _refine_batch(self.graph, query_graphs, per_query,
                             self.config.max_answers, engine, preverify)
