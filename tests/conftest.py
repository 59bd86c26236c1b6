"""Test configuration.

Forces the CPU backend with 8 virtual devices so multi-device sharding
logic is exercised without accelerators (the reference has no
distributed test story at all — SURVEY.md §4).  Must run before jax is
imported anywhere.  The GPU path is checked by ``chip_smoke.py``.
"""

import os

# Overwrite the env AND the config after import, so a GPU-enabled JAX
# still runs the tests on the CPU.
os.environ["JAX_PLATFORMS"] = "cpu"
# The CPU backend reports no memory limit; index budgets
# (index/device_packed.device_memory_bytes) size against 16 GB here.
os.environ["GNNPE_HBM_BYTES"] = "16e9"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

import pathlib

# Persistent XLA compilation cache shared across test runs.
_cache = pathlib.Path(__file__).parent.parent / ".cache" / "jax"
_cache.mkdir(parents=True, exist_ok=True)
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", str(_cache))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")

import numpy as np
import pytest

GOLDEN = pathlib.Path(__file__).parent / "golden"
TEST_DATA = pathlib.Path("/root/reference/Test")


@pytest.fixture(scope="session")
def data_graph():
    from gnnpe_tpu.graph.csr import CSRGraph
    return CSRGraph.from_graph_file(str(TEST_DATA / "data_graph.graph"))


@pytest.fixture(scope="session")
def query_graph():
    from gnnpe_tpu.graph.csr import CSRGraph
    return CSRGraph.from_graph_file(str(TEST_DATA / "query_graph.graph"))


@pytest.fixture(scope="session")
def golden_meta():
    import json
    with open(GOLDEN / "GOLDEN.json") as f:
        return json.load(f)


@pytest.fixture(scope="session")
def golden_paths():
    import gzip
    tok = gzip.open(GOLDEN / "all_paths_l2.txt.gz", "rt").read().split()
    n = int(tok[0])
    return np.array(tok[1:], dtype=np.int64).reshape(n, 3)


def load_candidates(name):
    """Parse a candidates dump fixture → list[set[int]] per query vertex."""
    import gzip
    out = []
    with gzip.open(GOLDEN / name, "rt") as f:
        for line in f:
            t = line.split()
            assert int(t[0]) == len(out)
            out.append(set(map(int, t[2:])))
    return out
