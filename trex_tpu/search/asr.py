"""Gradient-based ancestral sequence reconstruction (fixed topology).

Counterparts of the reference's optimization harnesses
(``/root/reference/src/trex/evals/benchmark.py:75-202`` and the
landscape-aware variants ``:235-456, :586-663``), redesigned for an
accelerator:

- Whole training loop is one jitted ``lax.scan`` (optimizer state in carry);
  nothing crosses the host boundary per step.
- The NK "parental logits" marginalization is fully vectorized over sites —
  one chained-outer-product einsum over the K epistatic neighbors — instead
  of the reference's chunked per-site ``safe_map`` loop
  (``evals/benchmark.py:623-663``). An optional ``site_chunk`` re-chunks the
  site axis through ``lax.map`` only when q**K blows past memory-friendly
  sizes.
- Mixed precision keeps parameters f32 and casts the forward pass to the
  compute dtype (e.g. bfloat16), like the reference's flag.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import optax

from trex_tpu.models.nk import NKLandscape
from trex_tpu.ops.costs import soft_parsimony_cost, surrogate_cost
from trex_tpu.ops.relax import soft_sequences
from trex_tpu.search.optimizers import make_optimizer


def _masked_leaf_tensor(leaf_sequences, n_all, n_states, dtype):
    """(n_all, L, Q): one-hot leaves, zero ancestors."""
    n_leaves, length = leaf_sequences.shape
    base = jnp.zeros((n_all, length, n_states), dtype=dtype)
    return base.at[:n_leaves].set(
        jax.nn.one_hot(leaf_sequences, n_states, dtype=dtype)
    )


def _run_descent(loss_fn, params, optimizer, n_iterations, return_losses):
    """Shared on-device descent loop: scan with (params, opt_state) carry."""
    opt_state = optimizer.init(params)
    grad_fn = jax.value_and_grad(loss_fn)

    def step(carry, _):
        p, s = carry
        loss, grads = grad_fn(p)
        updates, s = optimizer.update(grads, s, p)
        p = optax.apply_updates(p, updates)
        return (p, s), loss if return_losses else None

    (params, _), losses = jax.lax.scan(
        step, (params, opt_state), None, length=n_iterations
    )
    return params, losses


@partial(
    jax.jit,
    static_argnames=(
        "n_all",
        "n_states",
        "use_soft_cost",
        "optimizer_name",
        "learning_rate",
        "n_iterations",
        "return_losses",
        "mixed_precision",
        "compute_dtype",
    ),
)
def reconstruct_ancestors(
    leaf_sequences: jax.Array,
    n_all: int,
    n_states: int,
    adjacency: jax.Array,
    key: jax.Array,
    *,
    use_soft_cost: bool = False,
    optimizer_name: str = "adam",
    learning_rate: float = 1e-3,
    n_iterations: int = 10000,
    return_losses: bool = False,
    mixed_precision: bool = False,
    compute_dtype=jnp.float32,
):
    """Learn ancestor sequences on a fixed topology by gradient descent.

    Args:
        leaf_sequences: (n_leaves, L) int observed states.
        adjacency: (n_all, n_all) fixed topology (dense, child->parent).
        use_soft_cost: substitution-weighted soft cost vs plain surrogate.

    Returns:
        (n_ancestors, L) int32 argmax ancestors; plus the (n_iterations,)
        loss curve when ``return_losses``.
    """
    n_leaves, length = leaf_sequences.shape
    n_ancestors = n_all - n_leaves
    param_dtype = jnp.float32 if mixed_precision else compute_dtype

    key, init_key = jax.random.split(key)
    ancestors = jax.random.normal(
        init_key, (n_ancestors, length, n_states), dtype=param_dtype
    )
    masked = _masked_leaf_tensor(leaf_sequences, n_all, n_states, compute_dtype)
    identity = jnp.eye(n_states, dtype=compute_dtype)
    adjacency = adjacency.astype(compute_dtype)

    def loss_fn(anc):
        seqs = soft_sequences(anc.astype(compute_dtype), masked, n_leaves)
        if use_soft_cost:
            return soft_parsimony_cost(seqs, adjacency, identity)
        return surrogate_cost(seqs, adjacency)

    optimizer = make_optimizer(optimizer_name, learning_rate)
    ancestors, losses = _run_descent(
        loss_fn, ancestors, optimizer, n_iterations, return_losses
    )
    result = jnp.argmax(ancestors, axis=-1).astype(jnp.int32)
    return (result, losses) if return_losses else result


def parental_logits(
    parent_soft_seqs: jax.Array,
    landscape: NKLandscape,
    *,
    site_chunk: int | None = None,
) -> jax.Array:
    """Expected-fitness logits for each site/state under soft parent beliefs.

    For site ``i`` in state ``s``, the logit is the landscape fitness
    marginalized over the parent's soft distribution for the K epistatic
    neighbor sites (``compute_parental_logits``,
    ``evals/benchmark.py:586-663``), here vectorized over all sites at once.

    Args:
        parent_soft_seqs: (P, L, Q) soft parent sequences.
        site_chunk: optional chunk size over the site axis for memory.

    Returns:
        (P, L, Q) logits.
    """
    n_parents, length, q = parent_soft_seqs.shape
    k = landscape.k
    if k == 0:
        return jnp.broadcast_to(
            landscape.tables[None, :, :], (n_parents, length, q)
        ).astype(parent_soft_seqs.dtype)

    k_eff = landscape.interactions.shape[-1]
    # tables: (L, Q, q^K) — own state split from the neighbor combination.
    tables = landscape.tables.reshape(length, q, -1)

    def logits_for_sites(site_ids):
        neigh = landscape.interactions[site_ids]  # (l, K)
        # (P, l, K, Q) soft neighbor distributions.
        probs = parent_soft_seqs[:, neigh, :]
        joint = probs[:, :, 0, :]  # (P, l, Q)
        for j in range(1, k_eff):
            joint = jnp.einsum("plc,pls->plcs", joint, probs[:, :, j, :])
            joint = joint.reshape(n_parents, site_ids.shape[0], -1)
        # (l, Q, q^K) x (P, l, q^K) -> (P, l, Q)
        return jnp.einsum(
            "lsi,pli->pls", tables[site_ids], joint,
            preferred_element_type=jnp.float32,
        ).astype(parent_soft_seqs.dtype)

    sites = jnp.arange(length, dtype=jnp.int32)
    if site_chunk is None or site_chunk >= length:
        return logits_for_sites(sites)
    # Pad to a chunk multiple (repeating site 0), then slice the tail off.
    n_chunks = -(-length // site_chunk)
    padded = jnp.pad(sites, (0, n_chunks * site_chunk - length))
    out = jax.lax.map(
        logits_for_sites, padded.reshape(n_chunks, site_chunk)
    )  # (chunks, P, chunk, Q)
    out = jnp.moveaxis(out, 0, 1).reshape(n_parents, n_chunks * site_chunk, q)
    return out[:, :length, :]


def landscape_aware_loss(
    ancestors: jax.Array,
    masked_sequences: jax.Array,
    n_leaves: int,
    landscape: NKLandscape,
    adjacency: jax.Array,
    lambda_val: float,
    *,
    temperature: float = 1.0,
    site_mask: jax.Array | None = None,
    site_chunk: int | None = None,
) -> jax.Array:
    """surrogate + lambda * parental-guidance cross-entropy.

    Matches ``_compute_loss_landscape_aware_stacked``
    (``evals/benchmark.py:235-306``): the fitness term is the masked
    cross-entropy between each child's soft states and the softmaxed
    expected-fitness logits of its parent, normalized by (#non-root nodes ×
    #valid sites). Skipped entirely (at trace time) when lambda == 0 or the
    landscape has no epistasis.
    """
    n_all, length = masked_sequences.shape[0], masked_sequences.shape[1]
    seqs = soft_sequences(ancestors, masked_sequences, n_leaves, temperature)
    cost = surrogate_cost(seqs, adjacency)
    if lambda_val == 0.0 or landscape.k == 0:
        return cost

    if site_mask is None:
        site_mask = jnp.ones(length, dtype=bool)
    parent_idx = jnp.argmax(adjacency, axis=-1)
    logits = parental_logits(seqs[parent_idx], landscape, site_chunk=site_chunk)
    log_probs = jax.nn.log_softmax(logits, axis=-1)
    per_site_ce = -jnp.sum(seqs * log_probs, axis=-1)  # (N, L)
    ce = jnp.sum(per_site_ce * site_mask[None, :])
    is_root = jnp.arange(n_all) == parent_idx
    fitness_cost = ce / (jnp.sum(~is_root) * jnp.sum(site_mask))
    return cost + lambda_val * fitness_cost


@partial(
    jax.jit,
    static_argnames=(
        "n_all",
        "n_states",
        "lambda_val",
        "optimizer_name",
        "learning_rate",
        "n_iterations",
        "return_losses",
        "mixed_precision",
        "compute_dtype",
        "site_chunk",
    ),
)
def reconstruct_ancestors_landscape_aware(
    leaf_sequences: jax.Array,
    n_all: int,
    n_states: int,
    landscape: NKLandscape,
    lambda_val: float,
    adjacency: jax.Array,
    key: jax.Array,
    *,
    optimizer_name: str = "adam",
    learning_rate: float = 1e-3,
    n_iterations: int = 10000,
    return_losses: bool = False,
    mixed_precision: bool = False,
    compute_dtype=jnp.float32,
    site_mask: jax.Array | None = None,
    site_chunk: int | None = None,
):
    """ASR with the landscape-aware objective (fixed topology)."""
    n_leaves, length = leaf_sequences.shape
    n_ancestors = n_all - n_leaves
    param_dtype = jnp.float32 if mixed_precision else compute_dtype

    key, init_key = jax.random.split(key)
    ancestors = jax.random.normal(
        init_key, (n_ancestors, length, n_states), dtype=param_dtype
    )
    masked = _masked_leaf_tensor(leaf_sequences, n_all, n_states, compute_dtype)
    adjacency = adjacency.astype(compute_dtype)

    def loss_fn(anc):
        return landscape_aware_loss(
            anc.astype(compute_dtype),
            masked,
            n_leaves,
            landscape,
            adjacency,
            lambda_val,
            site_mask=site_mask,
            site_chunk=site_chunk,
        )

    optimizer = make_optimizer(optimizer_name, learning_rate)
    ancestors, losses = _run_descent(
        loss_fn, ancestors, optimizer, n_iterations, return_losses
    )
    result = jnp.argmax(ancestors, axis=-1).astype(jnp.int32)
    return (result, losses) if return_losses else result
