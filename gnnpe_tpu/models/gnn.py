"""Trainable GNN family for path-dominance embeddings.

The reference ships no training loop — its "GNN" is one fixed
aggregation hop (SURVEY.md §0.1; custom.h:513-544).  The north star
(BASELINE.json) asks for the capability as real message passing that
*can* be trained: neighbor gather + scatter-add as SpMM, path readout as
gathers, all jit/grad/shard-able.

Model: K layers of
    h^{k+1} = act( h^k @ W_self + (A h^k) @ W_nbr + b )
with non-negative weight parameterization (softplus) preserving the
monotone-dominance property the downstream index relies on: if
features of u are ≤ features of v element-wise and N(u) ⊆ N(v) (by the
monomorphism), non-negative W and monotone act keep vde(u) ≤ vde(v).
With identity weights, one layer, and no activation the model
reproduces the reference's fixed VDE exactly.

Path embedding = concat of the final per-vertex features along the path
(gen_pde, custom.h:546-572), expressed as a gather.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PathGNNParams:
    """One pytree leaf-set per layer: raw (pre-softplus) weights."""
    w_self: Any   # list of [D, D]
    w_nbr: Any    # list of [D, D]
    bias: Any     # list of [D]
    embed: Any    # [L_labels, D] label embedding table (raw, softplus'd)


@dataclasses.dataclass(frozen=True)
class PathGNN:
    """Config + pure functions; params live in PathGNNParams."""

    dim: int
    num_layers: int = 1
    labels_count: int = 0
    activation: str = "identity"   # "identity" | "relu" | "softplus"
    nonneg: bool = True            # constrain weights ≥ 0 (dominance)

    # ------------------------------------------------------------------
    def init(self, key, labels_count: Optional[int] = None,
             label_table: Optional[np.ndarray] = None) -> PathGNNParams:
        """Random init, or seed the embedding table with the reference's
        label-seeded features for parity-preserving finetuning."""
        lc = labels_count or self.labels_count
        keys = jax.random.split(key, 3 * self.num_layers + 1)
        d = self.dim

        def winit(k, near_identity):
            base = jnp.eye(d) if near_identity else jnp.zeros((d, d))
            noise = 0.01 * jax.random.normal(k, (d, d))
            return self._raw(base + jnp.abs(noise))

        w_self = [winit(keys[3 * i], True) for i in range(self.num_layers)]
        w_nbr = [winit(keys[3 * i + 1], True)
                 for i in range(self.num_layers)]
        bias = [jnp.zeros(d) for _ in range(self.num_layers)]
        if label_table is not None:
            embed = self._raw(jnp.asarray(label_table, dtype=jnp.float32))
        else:
            embed = self._raw(jax.nn.softmax(
                jax.random.normal(keys[-1], (lc, d)), axis=-1))
        return PathGNNParams(w_self=w_self, w_nbr=w_nbr, bias=bias,
                             embed=embed)

    def _raw(self, positive):
        """Inverse of the non-negativity map, so _pos(_raw(x)) ≈ x."""
        if not self.nonneg:
            return positive
        return jnp.log(jnp.expm1(jnp.maximum(positive, 1e-6)))

    def _pos(self, raw):
        return jax.nn.softplus(raw) if self.nonneg else raw

    def _act(self, h):
        if self.activation == "relu":
            return jax.nn.relu(h)
        if self.activation == "softplus":
            return jax.nn.softplus(h)
        return h

    # ------------------------------------------------------------------
    def vertex_embeddings(self, params: PathGNNParams, labels,
                          src, dst, num_vertices: int,
                          aggregate: Optional[Callable] = None):
        """Per-vertex features after message passing.

        src/dst: int32[E] directed arcs.  ``aggregate`` overrides the
        neighbor-sum (the distributed layer passes a halo-exchanging
        version; the binned layout passes its gather tables)."""
        from gnnpe_tpu.ops.spmm import neighbor_sum
        agg = aggregate or (
            lambda h: neighbor_sum(src, dst, h, num_vertices))
        h = jnp.take(self._pos(params.embed), labels, axis=0)
        for i in range(self.num_layers):
            ws = self._pos(params.w_self[i])
            wn = self._pos(params.w_nbr[i])
            b = self._pos(params.bias[i]) if self.nonneg else params.bias[i]
            # HIGHEST: f32 products, not TF32, so the same embeddings
            # come out on the CPU and on a GPU.
            hi = jax.lax.Precision.HIGHEST
            h = self._act(jnp.matmul(h, ws, precision=hi)
                          + jnp.matmul(agg(h), wn, precision=hi) + b)
        return h

    def path_embeddings(self, params: PathGNNParams, labels, src, dst,
                        num_vertices: int, paths,
                        aggregate: Optional[Callable] = None):
        """PDE readout: concat vertex features along each path row
        (gen_pde as a gather): f32[P, L*D]."""
        h = self.vertex_embeddings(params, labels, src, dst,
                                   num_vertices, aggregate)
        p, l = paths.shape
        return jnp.take(h, paths.reshape(-1), axis=0).reshape(p, l * self.dim)

    # ------------------------------------------------------------------
    def reference_params(self, label_table: np.ndarray) -> PathGNNParams:
        """Parameters that reproduce the fixed reference VDE exactly
        (identity weights, zero bias, label-seeded embeddings)."""
        d = self.dim
        eye = self._raw(jnp.eye(d) + 1e-9)
        return PathGNNParams(
            w_self=[eye] * self.num_layers,
            w_nbr=[eye] * self.num_layers,
            bias=[jnp.full(d, -30.0) if self.nonneg else jnp.zeros(d)
                  for _ in range(self.num_layers)],
            embed=self._raw(jnp.asarray(label_table, dtype=jnp.float32)))


def dominance_loss(model: PathGNN, params: PathGNNParams, labels, src,
                   dst, num_vertices: int, paths, subpath_pairs,
                   margin: float = 0.0, aggregate=None,
                   negative_pairs=None, neg_margin: float = 0.1):
    """Self-supervised dominance objective.

    subpath_pairs int32[B, 2]: rows (i, j) where path i's vertex set
    maps into path j under some monomorphism (training data generated by
    sampling paths and their embeddable sub-patterns).  The loss is a
    hinge on the element-wise dominance violation pde_i ≤ pde_j — the
    invariant the index prunes with — plus a small norm term to prevent
    collapse.

    negative_pairs int32[B2, 2] (optional): rows (i, j) that pass the
    label+degree leaf filter (custom.h:410-434) but provably admit no
    monomorphism i→j (e.g. the per-vertex NLF containment fails —
    train.sample_negative_pairs).  For these the model is rewarded for
    *violating* dominance in at least one dimension by ``neg_margin``,
    which is what makes the pde test prune more than label+degree do
    alone.  Exactness is unaffected for any weights: true-match pairs
    satisfy dominance structurally (non-negative monotone layers), so
    the discriminative term can only sharpen the filter on non-matches.
    """
    pde = model.path_embeddings(params, labels, src, dst, num_vertices,
                                paths, aggregate=aggregate)
    pi = jnp.take(pde, subpath_pairs[:, 0], axis=0)
    pj = jnp.take(pde, subpath_pairs[:, 1], axis=0)
    violation = jnp.maximum(pi - pj + margin, 0.0)
    anti_collapse = jnp.maximum(1.0 - jnp.mean(pde, axis=0), 0.0)
    loss = jnp.mean(violation ** 2) + 0.01 * jnp.mean(anti_collapse ** 2)
    if negative_pairs is not None:
        ni = jnp.take(pde, negative_pairs[:, 0], axis=0)
        nj = jnp.take(pde, negative_pairs[:, 1], axis=0)
        # Separation = the largest per-dimension dominance violation;
        # the flat filter prunes j for query-like i iff this exceeds
        # its epsilon.  Scale-normalize so the term cannot be gamed by
        # inflating all features (anti_collapse bounds deflation).
        sep = jnp.max(ni - nj, axis=1) / (
            jnp.mean(jnp.abs(nj), axis=1) + 1e-6)
        loss = loss + jnp.mean(jax.nn.softplus(neg_margin - sep))
    return loss
