"""ctypes bindings for the native refinement engine.

Builds refine.cpp into a shared library on first use (cached next to
the source, keyed by source mtime), then exposes
:func:`explore_native`.  pybind11 isn't available in this image, so the
boundary is a plain C ABI over borrowed numpy buffers.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Tuple, Union

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "refine.cpp")
_LOCK = threading.Lock()
_LIB = None


def _build_dir() -> str:
    d = os.environ.get("GNNPE_TPU_BUILD_DIR",
                       os.path.join(_HERE, "_build"))
    os.makedirs(d, exist_ok=True)
    return d


def load() -> ctypes.CDLL:
    """Build (if stale) and load the extension library."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        so = os.path.join(_build_dir(), "libgnnpe_refine.so")
        if (not os.path.exists(so)
                or os.path.getmtime(so) < os.path.getmtime(_SRC)):
            cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared",
                   "-fPIC", _SRC, "-o", so + ".tmp"]
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(so + ".tmp", so)
        lib = ctypes.CDLL(so)
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.gnnpe_refine.restype = ctypes.c_uint64
        lib.gnnpe_refine.argtypes = [
            i32p, i32p, i32p, ctypes.c_int32,        # data CSR
            i32p, i32p, i32p, ctypes.c_int32,        # query CSR
            i32p, i32p,                              # order, pivot
            i32p, i32p,                              # bn
            i32p, i64p,                              # candidates
            ctypes.c_uint64,                         # max_answers
            ctypes.c_void_p, ctypes.c_int64,         # out_embeddings
            ctypes.POINTER(ctypes.c_int64),          # out_emitted
        ]
        _LIB = lib
        return lib


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def explore_native(data_graph, query_graph, candidates: List[np.ndarray],
                   order: np.ndarray, pivot: np.ndarray,
                   bn: List[np.ndarray], max_answers: int,
                   max_emit: int = 0
                   ) -> Union[int, Tuple[int, np.ndarray]]:
    """Run the C++ explorer.  With max_emit > 0, also returns up to that
    many embeddings (int32[n, |Vq|], query-vertex-id indexed)."""
    lib = load()
    nq = query_graph.num_vertices
    bn_off = np.zeros(nq + 1, dtype=np.int32)
    for i, b in enumerate(bn):
        bn_off[i + 1] = bn_off[i] + len(b)
    bn_flat = (np.concatenate([_i32(b) for b in bn])
               if bn_off[-1] else np.zeros(0, dtype=np.int32))
    cand_off = np.zeros(nq + 1, dtype=np.int64)
    for i, c in enumerate(candidates):
        cand_off[i + 1] = cand_off[i] + len(c)
    cand_flat = (np.concatenate([_i32(c) for c in candidates])
                 if cand_off[-1] else np.zeros(0, dtype=np.int32))

    out_emb = (np.zeros((max_emit, nq), dtype=np.int32)
               if max_emit > 0 else None)
    emitted = ctypes.c_int64(0)
    count = lib.gnnpe_refine(
        _i32(data_graph.offsets), _i32(data_graph.neighbors),
        _i32(data_graph.labels), data_graph.num_vertices,
        _i32(query_graph.offsets), _i32(query_graph.neighbors),
        _i32(query_graph.labels), nq,
        _i32(order), _i32(pivot), bn_flat, bn_off, cand_flat, cand_off,
        ctypes.c_uint64(max_answers),
        out_emb.ctypes.data_as(ctypes.c_void_p) if out_emb is not None
        else None,
        ctypes.c_int64(max_emit), ctypes.byref(emitted))
    if max_emit > 0:
        return int(count), out_emb[:emitted.value]
    return int(count)
