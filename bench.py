"""SpMM aggregation benchmark of the embedding stage.  Prints ONE
JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

Headline metric: **aggregation edges/sec/device** for the
message-passing neighbor sum — the hot op of the embedding/training
stage, not of query serving — measured on a synthetic power-law graph
(V=100k, E=800k, D=128).  ``vs_baseline`` is the fraction of a
gather-bound roofline measured in the same run (see
bench_aggregation).

Memory-byte roofline (stderr, for reference): with f32 features of
width D,
  bytes/edge ≈ 4·D (gather x[src]) + 8 (src+dst ids)
             + amortized accumulator traffic ≈ 8·D·V/E
  roofline edges/s = peak bytes/s / bytes_per_edge
where the peak is the device's published memory bandwidth
(utils/device_probe.py; an unknown device is an error).
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def _chip_bandwidth_bytes():
    """Published memory bandwidth of the attached device — one source
    of truth shared with ops/ell hub pricing (utils/device_probe)."""
    from gnnpe_tpu.utils.device_probe import device_constants
    return device_constants()[0]


def synth_graph(num_vertices: int, num_edges: int, seed: int = 0):
    """Power-law-ish multigraph arcs (both directions), sorted by dst
    for scatter locality."""
    rng = np.random.RandomState(seed)
    # Preferential-attachment-flavored: degree ∝ zipf weights, sampled
    # by inverse-CDF (rng.choice with p= is pathologically slow here).
    w = 1.0 / np.arange(1, num_vertices + 1) ** 0.8
    cdf = np.cumsum(w / w.sum())
    src = np.searchsorted(cdf, rng.rand(num_edges)).astype(np.int32)
    src = np.minimum(src, num_vertices - 1)
    dst = rng.randint(0, num_vertices, size=num_edges).astype(np.int32)
    order = np.argsort(dst, kind="stable")
    return src[order], dst[order]


def _step_time(agg, x, iters=20, reps=7):
    """Per-iteration time of ``h = agg(h) * 0.1`` (one GNN layer:
    aggregate + fused elementwise).  The ``iters`` iterations run
    inside one jit with a data dependency chaining them; each rep is
    timed to ``block_until_ready`` and the median rep is reported."""
    import jax

    body = lambda i, h: agg(h) * 0.1
    run = jax.jit(lambda h: jax.lax.fori_loop(0, iters, body, h))
    run(x).block_until_ready()        # compile + warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run(x).block_until_ready()
        times.append((time.perf_counter() - t0) / iters)
    return max(float(np.median(times)), 1e-9)


def bench_aggregation(num_vertices=100_000, num_edges=800_000,
                      dim=128, implementation="binned"):
    """Measure aggregation edges/s and the fraction of a gather-bound
    roofline achieved (the ``vs_baseline`` of the JSON line).

    For the binned layout the roofline is measured in the same run, on
    the same device, as the time XLA's own gather needs for exactly
    this layout's slot list (one flat take, no binning overhead) plus
    the measured hub-matmul time — the fastest this aggregation could
    run without changing its access pattern.  Whether rows gathers or
    memory bytes bind on a given device is not assumed: the
    memory-byte fraction against the published bandwidth is printed
    on stderr beside it.
    """
    import jax
    import jax.numpy as jnp

    src, dst = synth_graph(num_vertices, num_edges)
    x = jnp.asarray(np.random.RandomState(1).rand(
        num_vertices, dim).astype(np.float32))
    counts = np.bincount(dst, minlength=num_vertices)
    offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)

    layout = None
    if implementation == "ell":
        from gnnpe_tpu.ops.ell import build_ell
        layout_u = build_ell(offs, src, width=8, level2_width=8)
        agg = layout_u.apply
    elif implementation == "binned_halo":
        # The sharded layout on a 1-shard mesh: what the distributed
        # path costs per device, next to the unsharded binned number.
        from gnnpe_tpu.parallel.binned_halo import BinnedHaloPlan
        from gnnpe_tpu.parallel.mesh import make_mesh
        mesh = make_mesh(1, axes=("graph",), shape=(1,))
        plan = BinnedHaloPlan.build(
            offs, src, np.zeros(num_vertices, np.int64), 1)
        agg3 = plan.make_aggregate(mesh)
        x = jnp.asarray(plan.shard_features(np.asarray(x)))
        agg = agg3
    elif implementation == "binned":
        # Degree-binned relabeled layout: the layer loop runs in the
        # permuted vertex space; boundary permutes amortize across
        # layers/iterations, so the loop body is apply_perm.
        from gnnpe_tpu.ops.ell import build_binned_ell
        layout = build_binned_ell(offs, src)
        x = layout.permute(x)
        agg = layout.apply_perm
    else:
        from gnnpe_tpu.ops.spmm import neighbor_sum
        srcj, dstj = jnp.asarray(src), jnp.asarray(dst)
        agg = lambda x: neighbor_sum(srcj, dstj, x, num_vertices)

    dt = _step_time(agg, x)
    edges_per_sec = num_edges / dt

    # ---- gather-bound roofline (same run, same device) --------------
    if layout is not None:
        # The full slot list of the layout: every class gather AND
        # every head fold LEVEL (apply_perm chains gathers through
        # all of head_tables, not just level 0 — pricing only the
        # first level overstated the roofline).  Level-k indices
        # address intermediate buffers; clamp into x's rows — the
        # probe times the access pattern, not the values.
        parts = [t.reshape(-1) for t in layout.class_tables]
        parts += [t.reshape(-1) for t in layout.head_tables]
        flat = np.minimum(np.concatenate(parts),
                          num_vertices - 1)
        gidx = jnp.asarray(flat.astype(np.int32))

        def probe(h):
            g = jnp.take(h, gidx, axis=0).sum(0, keepdims=True)
            return jnp.broadcast_to(g * 1e-9, h.shape) + h
        # The probes' own elementwise pass is timed alone and taken
        # off, so the roofline prices the gather and the matmul only.
        t_stream = _step_time(lambda h: h + 1.0, x)
        # Floor: a gather cannot beat the published bandwidth.
        t_floor = len(flat) * dim * 4 / _chip_bandwidth_bytes()
        t_gather = max(_step_time(probe, x) - t_stream, t_floor)
        hub_t = 0.0
        if layout.hub_rows is not None and len(layout.hub_rows):
            def hub_probe(h):
                p = layout._hub_part(h)
                return jnp.broadcast_to(p[:1] * 1e-9, h.shape) + h
            hub_t = max(_step_time(hub_probe, x) - t_stream, 0.0)
        # Two bounds: the ADDITIVE sum (gather then hub, no overlap)
        # and the OVERLAP bound max(gather, hub): gathers and matrix
        # products use different units, so a perfect implementation
        # overlaps them and the sum is no true ceiling.  vs_baseline
        # reports the strict overlap bound.
        roof_add = num_edges / (t_gather + hub_t)
        gather_roofline = num_edges / max(t_gather, hub_t)
        frac = edges_per_sec / gather_roofline
        print(f"[bench] gather probe {len(flat)} rows in "
              f"{t_gather*1e3:.3f} ms ({len(flat)/max(t_gather,1e-9)/1e6:.0f}"
              f" M rows/s), hub {hub_t*1e3:.3f} ms -> overlap roofline "
              f"{gather_roofline/1e6:.0f} M edges/s (additive "
              f"{roof_add/1e6:.0f}, frac {edges_per_sec/roof_add:.3f})",
              file=sys.stderr)
    else:
        gather_roofline = None
        frac = 0.0

    bytes_per_edge = (4 * dim + 8 +
                      8 * dim * num_vertices / num_edges)
    hbm_roofline = _chip_bandwidth_bytes() / bytes_per_edge
    print(f"[bench] memory-byte roofline fraction "
          f"{edges_per_sec/hbm_roofline:.3f}", file=sys.stderr)
    if gather_roofline is None:
        frac = edges_per_sec / hbm_roofline
    return edges_per_sec, frac, dt


def main(argv=None):
    import argparse
    from gnnpe_tpu.utils.compile_cache import enable_persistent_cache
    from gnnpe_tpu.utils.profiling import MetricsLog, trace
    enable_persistent_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--metrics", default="bench_metrics.jsonl",
                    help="JSON-lines metrics file ('' disables)")
    ap.add_argument("--trace", default="",
                    help="capture a jax.profiler trace of the "
                         "aggregation bench into this directory")
    ap.add_argument("--skip-halo", action="store_true",
                    help="skip the 1-shard binned_halo comparison")
    args = ap.parse_args(argv)
    log = MetricsLog(args.metrics or None)
    if args.trace:
        with trace(args.trace):
            edges_per_sec, frac, dt = bench_aggregation()
    else:
        edges_per_sec, frac, dt = bench_aggregation()
    log.log("aggregation", edges_per_sec=round(edges_per_sec),
            step_ms=round(dt * 1e3, 3), roofline_frac=round(frac, 4))
    if not args.skip_halo:
        halo_eps, _, halo_dt = bench_aggregation(
            implementation="binned_halo")
        print(f"[bench] binned_halo (1-shard sharded layout) "
              f"{halo_eps/1e6:.0f} M edges/s = "
              f"{halo_eps/edges_per_sec:.2f}x of unsharded binned",
              file=sys.stderr)
        log.log("binned_halo_1shard",
                edges_per_sec=round(halo_eps),
                vs_binned=round(halo_eps / edges_per_sec, 4))
    log.close()
    print(json.dumps({
        "metric": "aggregation_edges_per_sec_chip",
        "value": round(edges_per_sec),
        "unit": "edges/s",
        "vs_baseline": round(frac, 4),
    }))


if __name__ == "__main__":
    main()
