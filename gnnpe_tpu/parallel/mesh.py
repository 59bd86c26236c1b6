"""Device mesh construction.

The distributed layer is a new first-class component — the reference is
single-process with OpenMP over partitions and no communication backend
at all (SURVEY.md §2.3).  Scaling here follows the JAX SPMD recipe:
pick a mesh, annotate shardings, let XLA insert the collectives.  On a
GPU host every card reaches every other over NVLink at the same rate,
so a mesh's shape follows the algorithm alone.

Axes:
  "graph" — edge shards of the data graph (aggregation partial sums
            combine via psum over this axis)
  "batch" — data parallelism over path minibatches / queries
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_devices: Optional[int] = None,
              axes: Tuple[str, ...] = ("graph", "batch"),
              shape: Optional[Sequence[int]] = None) -> Mesh:
    """Mesh over the first n available devices.

    With 2 axes and no explicit shape, factor n as (graph, batch) with
    the graph axis taking the larger factor (aggregation partial sums
    combine every layer; batch gradients all-reduce less often)."""
    devs = jax.devices()
    n = n_devices or len(devs)
    devs = devs[:n]
    if shape is None:
        if len(axes) == 1:
            shape = (n,)
        else:
            g = _largest_factor_leq_sqrt_complement(n)
            shape = (g, n // g)
    arr = np.array(devs).reshape(tuple(shape))
    return Mesh(arr, axes[: arr.ndim])


def _largest_factor_leq_sqrt_complement(n: int) -> int:
    """Largest divisor g of n with g >= n//g (graph axis gets more)."""
    best = n
    for g in range(1, int(n ** 0.5) + 1):
        if n % g == 0:
            best = n // g
    return best


def maybe_distributed_init():
    """Multi-host init hook: call before mesh construction on pods.
    No-op when JAX isn't running under a multi-host launcher."""
    import os
    if os.environ.get("JAX_COORDINATOR_ADDRESS"):
        jax.distributed.initialize()
