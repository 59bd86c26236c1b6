"""Training orchestration for the PathGNN family.

The reference has no training loop at all (SURVEY.md §0.1) — this is
the new capability the north star asks for: train path embeddings with
the same SpMM/gather kernels the fixed pipeline uses, preserving the
dominance invariant via the non-negative parameterization.

Training data: sampled (sub-path, super-path) pairs with a label-
preserving vertex mapping — positive pairs for the dominance hinge.
Single-chip ``fit`` here; the multi-chip step lives in
gnnpe_tpu.parallel.dist.make_distributed_train_step.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from gnnpe_tpu.graph.csr import CSRGraph
from gnnpe_tpu.models.gnn import PathGNN, PathGNNParams, dominance_loss


def sample_dominance_pairs(graph: CSRGraph, paths: np.ndarray,
                           num_pairs: int, seed: int = 0) -> np.ndarray:
    """int32[B, 2] rows (i, j): path i should be dominated by path j.

    Positive construction: j shares i's label sequence position-wise,
    each of i's vertices has degree ≤ j's (the leaf-filter necessary
    conditions, custom.h:410-434), AND the per-vertex NLF containment
    holds.  The NLF requirement keeps this set disjoint from
    sample_negative_pairs — without it the dominance hinge and the
    discriminative term fight over the same pairs and training goes
    nowhere.  If the strict (NLF-containing) set is empty — tiny or
    adversarial graphs — falls back to degree-only positives."""
    rng = np.random.RandomState(seed)
    degrees = np.take(graph.degrees, paths)
    nlf = graph.nlf
    flat, offs, sizes = _label_signature_buckets(graph, paths)
    if flat is None:
        return np.zeros((0, 2), dtype=np.int32)

    def draw(require_nlf):
        pairs = []
        got = 0
        for _ in range(64):  # vectorized rejection rounds
            i, j = _draw_bucket_pairs(rng, flat, offs, sizes,
                                      max(num_pairs, 4096))
            fwd = (degrees[i] <= degrees[j]).all(axis=1)
            bwd = (degrees[j] <= degrees[i]).all(axis=1)
            if require_nlf:
                fwd &= (nlf[paths[i]] <= nlf[paths[j]]).all(axis=(1, 2))
                bwd &= (nlf[paths[j]] <= nlf[paths[i]]).all(axis=(1, 2))
            bwd &= ~fwd
            ii = np.concatenate([i[fwd], j[bwd]])
            jj = np.concatenate([j[fwd], i[bwd]])
            if len(ii):
                pairs.append(np.stack([ii, jj], axis=1))
                got += len(ii)
            if got >= num_pairs:
                break
        if not pairs:
            return np.zeros((0, 2), dtype=np.int32)
        return np.concatenate(pairs)[:num_pairs].astype(np.int32)

    strict = draw(require_nlf=True)
    return strict if len(strict) else draw(require_nlf=False)


def _label_signature_buckets(graph: CSRGraph, paths: np.ndarray):
    """Rows of ``paths`` grouped by per-position label signature
    (buckets of size ≥ 2), via one argsort — NOT a per-bucket scan,
    which is O(#buckets · P) and hangs at 415k paths.  Returns
    (flat_rows, bucket_offsets, bucket_sizes), or (None, None, None)
    if no bucket has ≥ 2 rows."""
    labels = np.take(graph.labels, paths)
    sig = np.ascontiguousarray(labels).view(
        np.dtype((np.void, labels.dtype.itemsize * labels.shape[1])))
    _, inverse = np.unique(sig.ravel(), return_inverse=True)
    order = np.argsort(inverse, kind="stable")
    sorted_inv = inverse[order]
    cuts = np.nonzero(np.diff(sorted_inv))[0] + 1
    buckets = [b for b in np.split(order, cuts) if len(b) >= 2]
    if not buckets:
        return None, None, None
    sizes = np.array([len(b) for b in buckets], dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    return np.concatenate(buckets), offs, sizes


def _draw_bucket_pairs(rng, flat, offs, sizes, n):
    """n (i, j) path-row pairs drawn within random buckets, i != j."""
    b = rng.randint(len(sizes), size=n)
    i = flat[offs[b] + (rng.rand(n) * sizes[b]).astype(np.int64)]
    j = flat[offs[b] + (rng.rand(n) * sizes[b]).astype(np.int64)]
    keep = i != j
    return i[keep], j[keep]


def sample_negative_pairs(graph: CSRGraph, paths: np.ndarray,
                          num_pairs: int, seed: int = 0) -> np.ndarray:
    """int32[B, 2] rows (i, j): provably NON-matching candidate pairs.

    Each pair passes the leaf filter's label+degree test position-wise
    (so only the pde dominance test can prune it), but the per-vertex
    NLF containment — for some position k and label ℓ, vertex i_k has
    MORE ℓ-labeled neighbors than j_k — proves no monomorphism maps
    path i into path j (neighbor labels must inject;
    ref BuildNLF graph.cpp:107-123 states the same necessary
    condition).  These are exactly the false candidates the fixed VDE
    fails to prune; the discriminative loss term teaches the model to
    separate them.  Feeding only provable negatives keeps the
    objective consistent with the structural dominance guarantee."""
    rng = np.random.RandomState(seed)
    degrees = np.take(graph.degrees, paths)
    nlf = graph.nlf  # int[V, L] neighbor-label counts
    flat, offs, sizes = _label_signature_buckets(graph, paths)
    if flat is None:
        return np.zeros((0, 2), dtype=np.int32)
    pairs = []
    got = 0
    for _ in range(64):  # vectorized rejection rounds
        i, j = _draw_bucket_pairs(rng, flat, offs, sizes,
                                  max(num_pairs, 4096))
        keep = (degrees[i] <= degrees[j]).all(axis=1)
        i, j = i[keep], j[keep]
        if not len(i):
            continue
        # NLF containment must FAIL at >=1 position to prove i !-> j.
        neg = (nlf[paths[i]] > nlf[paths[j]]).any(axis=(1, 2))
        if neg.any():
            pairs.append(np.stack([i[neg], j[neg]], axis=1))
            got += int(neg.sum())
        if got >= num_pairs:
            break
    if not pairs:
        return np.zeros((0, 2), dtype=np.int32)
    return np.concatenate(pairs)[:num_pairs].astype(np.int32)


@dataclass
class TrainState:
    params: PathGNNParams
    opt_state: object
    step: int = 0
    history: List[float] = field(default_factory=list)


def fit(model: PathGNN, graph: CSRGraph, paths: np.ndarray,
        num_steps: int = 100, batch_size: int = 1024,
        learning_rate: float = 1e-3, seed: int = 0,
        init_from_reference: bool = True,
        state: Optional[TrainState] = None,
        aggregation: str = "segment",
        negatives: bool = False,
        neg_margin: float = 0.1) -> TrainState:
    """Single-chip training loop (jit'd step, resumable via ``state``).

    aggregation: "segment" (COO segment-sum) or "binned" (the
    degree-binned relabeled gather layout with a scatter-free custom
    VJP).  Which of the two is faster on the GPU is unmeasured
    (ROADMAP Design 5).

    negatives=True adds the discriminative term over NLF-violating
    candidate pairs (sample_negative_pairs) — the configuration that
    actually shrinks candidate sets; see frontends/train_payoff.py
    for the measured effect.
    """
    import jax
    import jax.numpy as jnp
    import optax

    optimizer = optax.adam(learning_rate)
    if state is None:
        if init_from_reference:
            from gnnpe_tpu.ops.mt19937 import label_feature_table
            table = label_feature_table(graph.labels_count, model.dim)
            params = model.init(jax.random.key(seed),
                                labels_count=graph.labels_count,
                                label_table=table)
        else:
            params = model.init(jax.random.key(seed),
                                labels_count=graph.labels_count)
        state = TrainState(params=params,
                           opt_state=optimizer.init(params))

    src, dst = graph.coo()
    labels = jnp.asarray(graph.labels)
    srcj, dstj = jnp.asarray(src), jnp.asarray(dst)
    aggregate = None
    if aggregation == "binned":
        from gnnpe_tpu.ops.ell import build_binned_ell, symmetric_aggregate
        lay = build_binned_ell(graph.offsets, graph.neighbors)
        inner = symmetric_aggregate(lay)
        permj = jnp.asarray(lay.perm)
        rankj = jnp.asarray(lay.rank)
        # Permute in/out at the layer boundary (cheap [V, D] gathers;
        # the scatter-free custom VJP is what matters for speed).
        aggregate = lambda h: jnp.take(
            inner(jnp.take(h, permj, axis=0)), rankj, axis=0)
    pairs_all = sample_dominance_pairs(graph, paths,
                                       num_pairs=batch_size * 8,
                                       seed=seed)
    if not len(pairs_all):
        raise ValueError("no dominance pairs could be sampled")
    neg_all = (sample_negative_pairs(graph, paths,
                                     num_pairs=batch_size * 8,
                                     seed=seed + 7)
               if negatives else np.zeros((0, 2), dtype=np.int32))
    use_neg = len(neg_all) > 0
    paths_j = jnp.asarray(paths.astype(np.int32))

    def step_fn(params, opt_state, pairs, neg, flag):
        loss, grads = jax.value_and_grad(
            lambda p: dominance_loss(
                model, p, labels, srcj, dstj, graph.num_vertices,
                paths_j, pairs, aggregate=aggregate,
                negative_pairs=neg if use_neg else None,
                neg_margin=neg_margin))(params)
        updates, new_opt = optimizer.update(grads, opt_state, params)
        new_params = optax.apply_updates(params, updates)
        # flag=0 steps are padding (see below): params AND optimizer
        # state stay exactly untouched.
        sel = lambda a, b: jnp.where(flag, a, b)
        return (jax.tree.map(sel, new_params, params),
                jax.tree.map(sel, new_opt, opt_state), loss)

    # Steps run in lax.scan chunks of exactly ``chunk`` inside ONE
    # dispatch each: scanning cuts dispatches 50x with identical
    # math.  The final
    # partial chunk is PADDED to the same length with flag-masked
    # no-op steps so run_chunk compiles exactly once per shape
    # (ADVICE r2: a remainder chunk paid a second full jit compile).
    @jax.jit
    def run_chunk(params, opt_state, batches, negs, flags):
        def body(carry, b):
            p, o = carry
            pairs, neg, flag = b
            p, o, loss = step_fn(p, o, pairs, neg, flag)
            return (p, o), loss
        (params, opt_state), losses = jax.lax.scan(
            body, (params, opt_state), (batches, negs, flags))
        return params, opt_state, losses

    rng = np.random.RandomState(seed + 1)
    chunk = min(50, max(1, num_steps))
    done = 0
    while done < num_steps:
        k = min(chunk, num_steps - done)
        batches = pairs_all[rng.randint(len(pairs_all),
                                        size=(chunk, batch_size))]
        negs = (neg_all[rng.randint(len(neg_all),
                                    size=(chunk, batch_size))]
                if use_neg else np.zeros((chunk, 1, 2), dtype=np.int32))
        flags = np.arange(chunk) < k
        state.params, state.opt_state, losses = run_chunk(
            state.params, state.opt_state, jnp.asarray(batches),
            jnp.asarray(negs), jnp.asarray(flags))
        state.step += k
        state.history.extend(np.asarray(losses)[:k].tolist())
        done += k
    return state


def save_checkpoint(path: str, state: TrainState) -> None:
    """npz checkpoint of params + step (resumable; optimizer state is
    reconstructed on resume, matching common practice for Adam restarts
    at stage boundaries)."""
    import jax
    flat, treedef = jax.tree.flatten(state.params)
    np.savez(path, step=state.step,
             **{f"p{i}": np.asarray(l) for i, l in enumerate(flat)})


def load_checkpoint(path: str, model: PathGNN, labels_count: int
                    ) -> TrainState:
    import jax
    import optax
    z = np.load(path)
    template = model.init(jax.random.key(0), labels_count=labels_count)
    flat, treedef = jax.tree.flatten(template)
    leaves = [z[f"p{i}"] for i in range(len(flat))]
    params = jax.tree.unflatten(treedef, leaves)
    optimizer = optax.adam(1e-3)
    return TrainState(params=params, opt_state=optimizer.init(params),
                      step=int(z["step"]))
