"""Distributed message passing and training over a device mesh.

Strategy (SURVEY.md §2.3):
  * the data graph's directed arcs are sharded across the "graph" mesh
    axis (edge partitioning — replaces the reference's METIS vertex
    partitioning for the compute path);
  * each device aggregates its arc shard into a full-width vertex
    buffer, then partial sums combine with ``psum`` — the
    collective form of scatter-add;
  * path minibatches shard over the "batch" axis (DP); gradients psum
    over both axes.

Everything is shard_map'd so XLA sees static per-device shapes.  The
halo-exchange variant (exchange only boundary vertices instead of a
full psum) is an optimization for vertex-partitioned layouts; the
edge-parallel psum form is the baseline and is exact.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gnnpe_tpu.models.gnn import PathGNN, PathGNNParams


def shard_edges(src: np.ndarray, dst: np.ndarray, n_shards: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad the arc list to a multiple of n_shards and reshape to
    [n_shards, E_pad].  Padding arcs point at vertex 0 with src -1; the
    aggregation masks them out."""
    e = len(src)
    per = -(-e // n_shards)
    pad = per * n_shards - e
    src_p = np.concatenate([src, np.full(pad, -1, dtype=src.dtype)])
    dst_p = np.concatenate([dst, np.zeros(pad, dtype=dst.dtype)])
    return (src_p.reshape(n_shards, per), dst_p.reshape(n_shards, per))


def _local_masked_aggregate(src_shard, dst_shard, x, num_vertices):
    """Segment-sum one arc shard; padded arcs (src<0) contribute zero."""
    valid = (src_shard >= 0)[:, None]
    gathered = jnp.where(valid, jnp.take(x, jnp.maximum(src_shard, 0),
                                         axis=0), 0.0)
    return jax.ops.segment_sum(gathered, dst_shard,
                               num_segments=num_vertices)


def distributed_neighbor_sum(mesh: Mesh, src_shards, dst_shards, x,
                             num_vertices: int, axis: str = "graph"):
    """Edge-parallel aggregation: out[v] = Σ_{(u→v)} x[u], with arc
    shards on the mesh's graph axis and x replicated.  The psum is the
    only collective."""

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis), P(axis), P()), out_specs=P())
    def agg(src_shard, dst_shard, x_rep):
        local = _local_masked_aggregate(src_shard[0], dst_shard[0],
                                        x_rep, num_vertices)
        return jax.lax.psum(local, axis)

    return agg(src_shards, dst_shards, x)


def make_distributed_train_step(model: PathGNN, mesh: Mesh,
                                optimizer, num_vertices: int,
                                graph_axis: str = "graph",
                                batch_axis: Optional[str] = "batch",
                                backend: Optional[str] = None,
                                plan=None):
    """Build a jit-compiled SPMD training step with a pluggable
    aggregation backend — one seam, three implementations, identical
    numerics (VERDICT r2 item 10):

      * ``"psum"`` — edge-parallel baseline: arcs sharded, x
        replicated, every hop psums a full [V, D] buffer.  Exact,
        O(V·D) collective volume per hop.
      * ``"halo"`` — vertex-partitioned (``parallel.halo.HaloPlan``):
        per-hop all_to_all of boundary rows only (O(cut·D)), local
        arcs via segment_sum.
      * ``"binned_halo"`` — the production path
        (``parallel.binned_halo.BinnedHaloPlan``): same exchange, but
        local/halo arcs aggregate through the scatter-free binned-ELL
        tables with hub matmuls, and the all_to_all is issued
        before the local gathers so it overlaps them.

    Halo backends take ``plan`` (pre-built for this graph+shard count)
    and keep vertex features SHARDED through every layer; one
    all_gather at the end serves the path readout.  Step signature for
    every backend:
        step(params, labels, src_shards, dst_shards, paths, pairs,
             opt_state) -> (params, opt_state, loss)
    (halo backends ignore src/dst shards — pass None).

    Sharding layout: params/opt_state/labels replicated; arc shards on
    the graph axis; paths/subpath_pairs on the batch axis (pair
    indices are SHARD-LOCAL rows of that device's path shard).
    """
    axes = [a for a in (graph_axis, batch_axis)
            if a and a in mesh.axis_names]

    if backend is None:
        # Default: the production scatter-free layout whenever a plan
        # is supplied; the exact psum baseline otherwise.
        backend = "psum" if plan is None else (
            "binned_halo" if hasattr(plan, "local_stack") else "halo")

    if backend != "psum":
        assert plan is not None, f"backend {backend!r} needs plan="
        assert plan.num_shards == mesh.shape[graph_axis]
        own_pad = plan.own_pad
        dev_fn = plan.make_device_fn(graph_axis)
        agg_args = plan.device_args()
        arg_specs = plan.arg_specs(graph_axis)
        own_vids = shard_along(mesh, jnp.asarray(plan.own_vertex_ids()),
                               graph_axis)
        rows_v = replicate(mesh, jnp.asarray(plan.row_of_vertex()))

        def loss_fn_h(params, labels, ovids, rvert, aargs, paths,
                      pairs):
            lab_own = jnp.take(labels, ovids[0])
            h_own = model.vertex_embeddings(
                params, lab_own, None, None, own_pad,
                aggregate=lambda h: dev_fn(h, aargs))
            h_all = jax.lax.all_gather(h_own, graph_axis, axis=0)
            h_full = jnp.take(h_all.reshape(-1, h_own.shape[-1]),
                              rvert, axis=0)
            pde = jnp.take(h_full, paths.reshape(-1), axis=0).reshape(
                paths.shape[0], -1)
            return _dominance_pair_loss(pde, pairs)

        in_specs = (P(), P(), P(graph_axis), P(), arg_specs,
                    P(batch_axis) if batch_axis else P(),
                    P(batch_axis) if batch_axis else P(), P())

        @functools.partial(jax.shard_map, mesh=mesh,
                           in_specs=in_specs, out_specs=(P(), P(), P()))
        def step_h(params, labels, ovids, rvert, aargs, paths, pairs,
                   opt_state):
            loss, grads = jax.value_and_grad(loss_fn_h)(
                params, labels, ovids, rvert, aargs, paths, pairs)
            for a in axes:
                grads = jax.lax.pmean(grads, a)
                loss = jax.lax.pmean(loss, a)
            updates, opt_state = optimizer.update(grads, opt_state,
                                                  params)
            params = jax.tree.map(lambda p, u: p + u, params, updates)
            return params, opt_state, loss

        jitted = jax.jit(step_h)

        def step(params, labels, src_shards, dst_shards, paths, pairs,
                 opt_state):
            return jitted(params, labels, own_vids, rows_v, agg_args,
                          paths, pairs, opt_state)

        return step

    def loss_fn(params, labels, src_shard, dst_shard, paths, pairs):
        agg = lambda h: jax.lax.psum(
            _local_masked_aggregate(src_shard, dst_shard, h,
                                    num_vertices), graph_axis)
        return _sharded_dominance_loss(model, params, labels, agg,
                                       num_vertices, paths, pairs)

    in_specs = (P(), P(), P(graph_axis), P(graph_axis),
                P(batch_axis) if batch_axis else P(),
                P(batch_axis) if batch_axis else P(), P())
    out_specs = (P(), P(), P())

    @functools.partial(jax.shard_map, mesh=mesh, in_specs=in_specs,
                       out_specs=out_specs)
    def step(params, labels, src_shards, dst_shards, paths, pairs,
             opt_state):
        loss, grads = jax.value_and_grad(loss_fn)(
            params, labels, src_shards[0], dst_shards[0], paths, pairs)
        for a in axes:
            grads = jax.lax.pmean(grads, a)
            loss = jax.lax.pmean(loss, a)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        return params, opt_state, loss

    return jax.jit(step)


def _dominance_pair_loss(pde, pairs):
    pi = jnp.take(pde, pairs[:, 0], axis=0)
    pj = jnp.take(pde, pairs[:, 1], axis=0)
    violation = jnp.maximum(pi - pj, 0.0)
    anti_collapse = jnp.maximum(1.0 - jnp.mean(pde, axis=0), 0.0)
    return jnp.mean(violation ** 2) + 0.01 * jnp.mean(anti_collapse ** 2)


def _sharded_dominance_loss(model, params, labels, aggregate,
                            num_vertices, paths, pairs):
    """dominance_loss with an injected (collective) aggregation."""
    pde = model.path_embeddings(params, labels, None, None, num_vertices,
                                paths, aggregate=aggregate)
    return _dominance_pair_loss(pde, pairs)


def replicate(mesh: Mesh, tree):
    """Place a pytree replicated on every mesh device."""
    sharding = NamedSharding(mesh, P())
    return jax.device_put(tree, sharding)


def shard_along(mesh: Mesh, arr, axis_name: str):
    """Place an array with its leading dim split over one mesh axis."""
    return jax.device_put(arr, NamedSharding(mesh, P(axis_name)))
