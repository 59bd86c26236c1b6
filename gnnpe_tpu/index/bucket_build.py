"""Bucketed out-of-core streamed index build.

Round 4's streamed (HBM-wall) build paid a ~16-22 min serial host tail
after enumeration: ONE global np.argsort over ~1.2e9 int64 keys, one
random-access permutation gather over the whole path table, then the
summary fold — nothing overlapped, and everything lived in host RAM,
so index size was bounded by RAM (VERDICT r4 items 2/3).  This module
replaces that tail with a range-partitioned bucket sort:

  * During enumeration, each finished chunk's (rows, keys) are
    partitioned into contiguous KEY-RANGE buckets (boundaries from a
    pre-pass key sample).  Partitioning runs inside the enumeration
    worker threads; appends are O(1).  In disk mode the partitions
    spill to per-bucket files, so host RAM never holds the table.
  * After enumeration, buckets sort INDEPENDENTLY (stable argsort per
    bucket — parallel across workers, cache-resident at ~32M rows),
    write their sorted segment straight into the final table (a
    np.memmap when the table exceeds the RAM budget — the disk tier
    the reference gets from its BlockFile pages, blk_file.cpp:22-62),
    record the per-block label-signature ranges, and fold the block
    summaries for their fully-contained blocks.  Blocks straddling a
    bucket boundary fold in a tiny final pass.

Equality with the monolithic build is exact: the range partition
respects key order, the per-bucket stable sort preserves arrival
order within equal keys, and chunks feed in enumeration order — so
the concatenated segments equal the global stable argsort row for
row (asserted by tests/test_paths.py::test_bucketed_streamed_build).

Reference contract being scaled: the disk-paged R*-tree leaf storage
(GNN-PE/libsrc/blockfile/blk_file.cpp:22-62) and its offline build
(custom.h:170-216), re-landed array-first: the sorted table IS the leaf
storage, phase 2 pages row ranges on demand (device_packed.py), and
the device-memory block cache (DeviceChunkCache) plays the page-cache
role.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Tuple

import numpy as np


def host_ram_bytes() -> float:
    """Physical host RAM (override via GNNPE_HOST_RAM_BYTES)."""
    v = os.environ.get("GNNPE_HOST_RAM_BYTES")
    if v is not None:
        return float(v)
    try:
        return float(os.sysconf("SC_PHYS_PAGES")
                     * os.sysconf("SC_PAGE_SIZE"))
    except (ValueError, OSError):
        return 64e9


def sample_key_boundaries(graph, order: np.ndarray, l: int, vertices,
                          n_buckets: int, sample_starts: int = 8192,
                          seed: int = 0) -> np.ndarray:
    """Bucket boundaries = quantiles of the composite sort key over a
    uniform random start sample.  Boundary quality shapes only bucket
    BALANCE, never correctness (the range partition is exact either
    way); a few-× imbalance just makes one sort job longer."""
    from gnnpe_tpu.index.device_packed import (composite_sort_key,
                                               key_tables)
    from gnnpe_tpu.paths.enumerate import (
        dedup_orientations_streaming, enumerate_paths_from,
        start_ranks)
    rng = np.random.RandomState(seed)
    take = min(sample_starts, len(order))
    starts = np.asarray(order)[rng.choice(len(order), size=take,
                                          replace=False)]
    rank = start_ranks(order, graph.num_vertices)
    ktabs = key_tables(vertices)
    keys: List[np.ndarray] = []
    for batch in np.array_split(starts, max(1, take // 256)):
        rows = enumerate_paths_from(graph, batch, l)
        rows = rows[dedup_orientations_streaming(rows, rank)]
        if len(rows):
            keys.append(composite_sort_key(rows, vertices,
                                           tables=ktabs))
    if not keys:
        return np.zeros(0, np.int64)
    k = np.concatenate(keys)
    k.sort()
    idx = len(k) * np.arange(1, n_buckets) // n_buckets
    return k[idx]


class BucketSpill:
    """Range-partitioned spill of (path rows int32[*, l], keys
    int64[*]).  ``partition`` runs in worker threads (argsort releases
    the GIL); ``append`` is the serialized cheap step.  Disk mode
    (spill_dir set) appends each bucket's bytes to per-bucket files
    and frees host memory; RAM mode keeps the partitioned chunk
    arrays."""

    def __init__(self, boundaries: np.ndarray, l: int,
                 spill_dir: Optional[str] = None):
        self.boundaries = np.asarray(boundaries, np.int64)
        self.nb = len(self.boundaries) + 1
        self.l = l
        self.dir = spill_dir
        self.counts = np.zeros(self.nb, np.int64)
        self.total = 0
        self._chunks: List[Tuple[np.ndarray, np.ndarray,
                                 np.ndarray]] = []
        self._files: dict = {}
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)

    def partition(self, rows: np.ndarray, keys: np.ndarray):
        """Worker-side: group a chunk's rows by bucket (stable).
        Returns (rows_grouped, keys_grouped, offsets int64[nb+1])."""
        bi = np.searchsorted(self.boundaries, keys, side="right")
        order = np.argsort(bi, kind="stable")
        offs = np.searchsorted(bi[order],
                               np.arange(self.nb + 1, dtype=np.int64))
        return rows[order], keys[order], offs

    def append(self, part) -> None:
        """Main-thread: record one partitioned chunk (in enumeration
        order — order across appends defines the stable tie-break)."""
        rows, keys, offs = part
        self.counts += offs[1:] - offs[:-1]
        self.total += len(rows)
        if self.dir is None:
            self._chunks.append((rows, keys, offs))
            return
        for b in range(self.nb):
            lo, hi = offs[b], offs[b + 1]
            if hi <= lo:
                continue
            fr, fk = self._handles(b)
            fr.write(np.ascontiguousarray(rows[lo:hi]).tobytes())
            fk.write(np.ascontiguousarray(keys[lo:hi]).tobytes())

    def _handles(self, b: int):
        if b not in self._files:
            fr = open(os.path.join(self.dir, f"rows_{b}.bin"), "wb")
            fk = open(os.path.join(self.dir, f"keys_{b}.bin"), "wb")
            self._files[b] = (fr, fk)
        return self._files[b]

    def bucket(self, b: int) -> Tuple[np.ndarray, np.ndarray]:
        """All rows/keys of bucket ``b`` in arrival order."""
        if self.dir is None:
            rs = [c[0][c[2][b]:c[2][b + 1]] for c in self._chunks]
            ks = [c[1][c[2][b]:c[2][b + 1]] for c in self._chunks]
            rs = [r for r in rs if len(r)]
            ks = [k for k in ks if len(k)]
            if not rs:
                return (np.zeros((0, self.l), np.int32),
                        np.zeros(0, np.int64))
            return np.concatenate(rs), np.concatenate(ks)
        if b not in self._files:
            return (np.zeros((0, self.l), np.int32),
                    np.zeros(0, np.int64))
        fr, fk = self._files[b]
        fr.close(), fk.close()
        rows = np.fromfile(os.path.join(self.dir, f"rows_{b}.bin"),
                           np.int32).reshape(-1, self.l)
        keys = np.fromfile(os.path.join(self.dir, f"keys_{b}.bin"),
                           np.int64)
        return rows, keys

    def free(self, b: int) -> None:
        """Disk mode: delete bucket b's spill files the moment its
        sorted segment is written (bounds peak disk usage)."""
        if self.dir is None or b not in self._files:
            return
        del self._files[b]
        for name in (f"rows_{b}.bin", f"keys_{b}.bin"):
            try:
                os.remove(os.path.join(self.dir, name))
            except OSError:
                pass

    def close(self) -> None:
        for fr, fk in self._files.values():
            if not fr.closed:
                fr.close()
            if not fk.closed:
                fk.close()


def _fold_blocks(hv_rows: np.ndarray, g0: int, g1: int, b: int,
                 vde_up, x_up, x_dn, degv,
                 blk_ub, blk_llo, blk_lhi, blk_deg) -> None:
    """Fold block summaries for blocks [g0, g1) given their rows
    (hv_rows = the contiguous [g0·b, g1·b) slice of the sorted
    table).  Layout identical to _host_fold_summaries."""
    if g1 <= g0:
        return
    l = hv_rows.shape[1]
    d = vde_up.shape[1]
    for j in range(l):
        col = hv_rows[:, j]
        blk_ub[g0:g1, j * d:(j + 1) * d] = \
            vde_up[col].reshape(-1, b, d).max(1)
        blk_lhi[g0:g1, j * d:(j + 1) * d] = \
            x_up[col].reshape(-1, b, d).max(1)
        blk_llo[g0:g1, j * d:(j + 1) * d] = \
            x_dn[col].reshape(-1, b, d).min(1)
        blk_deg[g0:g1, j] = degv[col].reshape(-1, b).max(1)


def build_streamed_bucketed(mesh, spill: BucketSpill, vertices,
                            l: int, block_size: int = 512,
                            axis: str = "graph",
                            table_path: Optional[str] = None,
                            base_epsilon: float = 1e-6,
                            workers: int = 2):
    """Consume a fed BucketSpill into a streamed DevicePackedPESearch.

    The sorted leaf table lands in ``table_path`` (np.memmap, the
    disk tier) when given, else in host RAM — bit-identical either
    way to DevicePackedPESearch.build_from_paths(resident=False).
    Bucket jobs (sort + segment write + sig ranges + contained-block
    fold) run on ``workers`` threads; straddle and pad blocks fold in
    a final pass."""
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gnnpe_tpu.index.device_packed import (
        DevicePackedPESearch, _chunk_k, _outward, pe_pad_shapes,
        sig_radix_of)
    from gnnpe_tpu.match.device_filter import split3
    from gnnpe_tpu.utils.compile_cache import enable_persistent_cache
    enable_persistent_cache()

    p = int(spill.total)
    b = block_size
    v = vertices.num_vertices
    d = vertices.dim
    n = mesh.shape[axis]
    self = DevicePackedPESearch.__new__(DevicePackedPESearch)
    self.table_mode = True
    self.streamed = True
    self.mesh = mesh
    self.axis = axis
    self.base_epsilon = base_epsilon
    self.block_size = b
    assert b & (b - 1) == 0
    self.num_entries = p
    p_pad, v_pad, nb, nbl = pe_pad_shapes(p, b, v, n, pow2=False)
    self.nb_local = nbl
    nb_pad = n * nbl
    self.num_blocks = nb
    ent_rows = nb_pad * b
    self.k_chunk = _chunk_k(nbl)

    t0 = time.perf_counter()
    vde_up = _outward(vertices.vde, True, v_pad - v)
    x_up = _outward(vertices.x, True, v_pad - v)
    x_dn = _outward(vertices.x, False, v_pad - v)
    labv = np.concatenate([vertices.labels.astype(np.int32),
                           np.full(v_pad - v, -2, np.int32)])
    degv = np.concatenate([vertices.degrees.astype(np.int32),
                           np.zeros(v_pad - v, np.int32)])
    limb_tables = tuple(
        jnp.asarray(np.concatenate(
            [a, np.zeros((v_pad - v, d), np.float32)]))
        for a in split3(vertices.vde))
    self._tables = (jnp.asarray(labv), jnp.asarray(degv)) \
        + limb_tables
    t_tables = time.perf_counter() - t0

    t0 = time.perf_counter()
    if table_path is not None:
        hv = np.memmap(table_path, dtype=np.int32, mode="w+",
                       shape=(ent_rows, l))
    else:
        hv = np.empty((ent_rows, l), np.int32)
    hv[p:] = v                       # sentinel pad tail
    self._host_vids = hv
    # Build-temp disk-tier file: OWNED by this index, deleted on
    # close() (save() copies into its own .vids.bin sidecar, so the
    # working file never outlives the search object).
    self._owned_table_path = table_path
    offs = np.concatenate([[0], np.cumsum(spill.counts)])
    assert offs[-1] == p, (offs[-1], p)
    hi_sent = np.int64(1) << 62
    blk_first = np.full(nb_pad, hi_sent, np.int64)
    blk_last = np.full(nb_pad, hi_sent, np.int64)
    blk_ub = np.empty((nb_pad, l * d), np.float32)
    blk_lhi = np.empty((nb_pad, l * d), np.float32)
    blk_llo = np.empty((nb_pad, l * d), np.float32)
    blk_deg = np.empty((nb_pad, l), np.int32)

    def job(bi: int):
        rows, keys = spill.bucket(bi)
        r0, r1 = int(offs[bi]), int(offs[bi + 1])
        assert len(rows) == r1 - r0
        if r1 == r0:
            spill.free(bi)
            return
        o = np.argsort(keys, kind="stable")
        sr = rows[o]
        sk = keys[o] >> 32
        del rows, keys, o
        hv[r0:r1] = sr
        spill.free(bi)
        # Per-block sig ranges for anchor rows inside [r0, r1):
        # first anchor of block g is row g·b, last is min((g+1)·b,
        # p) − 1 (the partial tail block's last REAL row).
        for g in range(-(-r0 // b), -(-r1 // b)):
            if g * b < r1:
                blk_first[g] = sk[g * b - r0]
        for g in range((r0 // b), -(-r1 // b)):
            last_row = min((g + 1) * b, p) - 1
            if r0 <= last_row < r1:
                blk_last[g] = sk[last_row - r0]
        # Fold blocks fully contained in [r0, r1).
        g0 = -(-r0 // b)
        g1 = r1 // b
        if g1 > g0:
            _fold_blocks(sr[g0 * b - r0:g1 * b - r0], g0, g1, b,
                         vde_up, x_up, x_dn, degv,
                         blk_ub, blk_llo, blk_lhi, blk_deg)

    with ThreadPoolExecutor(max_workers=workers) as pool:
        list(pool.map(job, range(spill.nb)))
    spill.close()
    t_sortw = time.perf_counter() - t0

    # Straddle blocks (a bucket boundary inside the block) + the
    # partial tail block + sentinel pad blocks: fold from the written
    # table.  O(n_buckets + nb_pad − nb_real) blocks — tiny.
    t0 = time.perf_counter()
    done = np.zeros(nb_pad, bool)
    for bi in range(spill.nb):
        r0, r1 = int(offs[bi]), int(offs[bi + 1])
        if r1 > r0:
            done[-(-r0 // b):r1 // b] = True
    todo = np.nonzero(~done)[0]
    # Contiguous runs of undone blocks fold together (pad tail is one
    # run; straddles are single blocks).
    if len(todo):
        run_starts = np.concatenate(
            [[0], np.nonzero(np.diff(todo) > 1)[0] + 1])
        run_ends = np.concatenate([run_starts[1:], [len(todo)]])
        for s, e in zip(run_starts, run_ends):
            g0, g1 = int(todo[s]), int(todo[e - 1]) + 1
            _fold_blocks(np.asarray(hv[g0 * b:g1 * b]), g0, g1, b,
                         vde_up, x_up, x_dn, degv,
                         blk_ub, blk_llo, blk_lhi, blk_deg)
    self._blk_sig_first = blk_first
    self._blk_sig_last = blk_last
    self._sig_radix = sig_radix_of(vertices)
    t_straddle = time.perf_counter() - t0

    t0 = time.perf_counter()
    shard = NamedSharding(mesh, P(axis))
    put = lambda a: jax.device_put(a, shard)
    # Shared zero buffer for the six zero-limb slots (read-only
    # phase-1 inputs; ~1.2 GB saved at the 8.2M-block skew rung).
    z0 = put(np.zeros_like(blk_ub))
    self.b_ub3 = (put(blk_ub), z0, z0)
    self.b_llo3 = (put(blk_llo), z0, z0)
    self.b_lhi3 = (put(blk_lhi), z0, z0)
    self.b_deg = put(blk_deg)
    self.b_deg.block_until_ready()
    self.d_vids = None
    self.d_labels = self.d_degrees = self.d_pde3 = None
    t_put = time.perf_counter() - t0
    self.build_phase_ms = {
        "tables": round(t_tables * 1e3, 1),
        "bucket_sort_write_fold": round(t_sortw * 1e3, 1),
        "straddle_fold": round(t_straddle * 1e3, 1),
        "summaries_put": round(t_put * 1e3, 1),
    }
    self.last_stats = None
    self._num_vertices = v
    self._cache = None
    self._phase1 = None
    self._phase2 = {}
    self._phase2_bitmap = {}
    return self
