"""CLI front end mirroring the reference drivers.

Replaces both C++ mains + the Python prep scripts with one entry point:

  python -m gnnpe_tpu.frontends.cli \
      --file <dataset-dir> --data data_graph.graph \
      --query query_graph.graph --variant pe --mode online \
      -l 2 -e 2 -p 5 [-n MAX] [--workdir DIR]

Flags and semantics follow GNN-PE/src/main.cpp:46-69 (including the
``-l`` +1 quirk handled by the per-variant configs) and
gnnpe.py:44-75 for the prepare stage.  ``--mode prepare`` replaces the
pymetis prep script; ``offline`` enumerates/embeds and checkpoints;
``online`` answers a query and prints the reference's answer line.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gnnpe-tpu",
        description="GNN-PE/GNN-PGE exact subgraph matching on a GPU "
                    "(JAX)")
    p.add_argument("-f", "--file", default="../Test/",
                   help="dataset path")
    p.add_argument("-d", "--data", default="data_graph.graph",
                   help="data graph (path or name under --file)")
    p.add_argument("-q", "--query", default="query_graph.graph",
                   help="query graph (path or name under --file)")
    p.add_argument("-m", "--mode", default="offline",
                   choices=["prepare", "offline", "online"])
    p.add_argument("-p", "--partition", type=int, default=5)
    p.add_argument("-l", "--length", type=int, default=2,
                   help="path length (PE: edges, +1 applied; PGE: vertices)")
    p.add_argument("-e", "--embedding", type=int, default=2)
    p.add_argument("-n", "--answers", default="MAX")
    p.add_argument("--variant", default="pe", choices=["pe", "pge"])
    p.add_argument("--engine", default="auto",
                   choices=["auto", "native", "python"])
    p.add_argument("--workdir", default=None,
                   help="artifact dir (default: <file>/gnnpe-tpu)")
    p.add_argument("--partitioner", default="bfs",
                   choices=["bfs", "round_robin", "block"])
    return p


def _resolve(base: str, path: str) -> str:
    return path if os.path.isabs(path) or os.path.exists(path) \
        else os.path.join(base, path)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from gnnpe_tpu.config import PEConfig, PGEConfig
    from gnnpe_tpu.engine import PEEngine, PGEEngine
    from gnnpe_tpu.graph.csr import CSRGraph
    from gnnpe_tpu.graph.partition import partition_graph, write_membership
    from gnnpe_tpu.io.artifacts import ArtifactStore
    from gnnpe_tpu.utils.compile_cache import enable_persistent_cache
    enable_persistent_cache()

    n = None if args.answers == "MAX" else int(args.answers)
    cfg_cls = PEConfig if args.variant == "pe" else PGEConfig
    config = cfg_cls.from_cli(l=args.length, e=args.embedding,
                              p=args.partition, n=n)

    data_path = _resolve(args.file, args.data)
    graph = CSRGraph.from_graph_file(data_path)
    print(f"|V|: {graph.num_vertices}, |E|: {graph.num_edges}, "
          f"|Σ|: {graph.labels_count}")

    workdir = args.workdir or os.path.join(args.file, "gnnpe-tpu")
    store = ArtifactStore(workdir)
    fp = store.fingerprint(config, data_path,
                           {"partitioner": args.partitioner})

    membership = None
    m = store.load("membership", fp)
    if m is not None:
        membership = m["membership"]

    if args.mode == "prepare" or membership is None:
        membership = partition_graph(graph, config.partition_num,
                                     strategy=args.partitioner)
        store.save("membership", fp, membership=membership)
        write_membership(os.path.join(workdir, "membership.txt"),
                         graph, membership)
        if args.mode == "prepare":
            print(f"membership written to {workdir}")
            return 0

    if args.variant == "pe":
        engine = PEEngine(config, graph, membership)
        cached = store.load("paths", fp)
        if cached is not None and args.mode == "online":
            engine.paths = cached["paths"]
        else:
            engine.offline()
            store.save("paths", fp, paths=engine.paths)
            store.write_all_paths(os.path.join(workdir, "all_paths.txt"),
                                  engine.paths)
        if args.mode == "offline":
            print(f"{engine.paths.shape[0]} paths enumerated")
            return 0
        from gnnpe_tpu.index.packed import (PackedDominanceIndex,
                                            load_index, save_index)
        idx = load_index(store, "index", fp, PackedDominanceIndex)
        if idx is not None and args.mode == "online":
            # True resume: the index alone serves the search; the
            # [P, L*D] PDE table is not rebuilt.
            engine.index = idx
        else:
            engine.build_index()
            save_index(store, "index", fp, engine.index)
    else:
        engine = PGEEngine(config, graph, membership)
        from gnnpe_tpu.index.packed import (PGEPackedIndex, load_index,
                                            save_index)
        cached = store.load("groups", fp)
        idx = load_index(store, "pge-index", fp, PGEPackedIndex)
        if cached is not None and args.mode == "online":
            from gnnpe_tpu.embed.vde import gen_vde
            engine.vertices = gen_vde(graph, config.vde_dim)
            engine.group = cached["group"]
            engine.label_group = cached["label_group"]
            if idx is not None:
                engine.index = idx
            else:
                engine.index = PGEPackedIndex.build(
                    engine.vertices.labels, engine.vertices.degrees,
                    engine.group, engine.label_group)
                save_index(store, "pge-index", fp, engine.index)
        else:
            engine.offline()
            store.save("groups", fp, group=engine.group,
                       label_group=engine.label_group)
            save_index(store, "pge-index", fp, engine.index)
        if args.mode == "offline":
            print("path groups built")
            return 0

    query = CSRGraph.from_graph_file(_resolve(args.file, args.query))
    t0 = time.perf_counter()
    res = engine.online(query, engine=args.engine)
    dt = (time.perf_counter() - t0) * 1e3
    label = "Answer Number" if args.variant == "pe" else "Answer Num"
    print(f"{label}: {res.answer_count} Query Time (ms): {dt:.4g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
