"""gnnpe_tpu — a JAX framework for GNN path-dominance-embedding exact
subgraph matching, served on an NVIDIA GPU.

Capabilities mirror the reference GNN-PE/GNN-PGE engines
(/root/reference, VLDB 2024; arXiv 2309.15641) but the architecture is
array-first: message passing runs as SpMM over CSR/COO device buffers,
path enumeration is frontier expansion, the dominance index is a packed
bounding-box hierarchy traversed with masked vector compares, and the
irregular backtracking refinement lives in a native C++ host extension.

Layer map (bottom → top):
  graph/      CSR graph core (ref: GNN-PE/libsrc/graph/graph.cpp)
  ops/        device ops: SpMM layouts, segment ops, set intersection
  embed/      VDE / PDE / path-group embedding stages (ref: custom.h:492-632)
  paths/      simple-path enumeration + orientation dedup (ref: custom.h:66-119)
  index/      packed dominance index (replaces the on-disk R*-tree)
  match/      query planning, candidate search, native refinement
  models/     trainable GNN model family sharing the SpMM kernels
  parallel/   mesh / sharding / halo-exchange distributed layer
  io/         dataset formats, staged artifact store (checkpoint/resume)
  utils/      timers, logging, profiling
"""

from gnnpe_tpu.config import Config, PEConfig, PGEConfig

__version__ = "0.1.0"

__all__ = ["Config", "PEConfig", "PGEConfig", "__version__"]
