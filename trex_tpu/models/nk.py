"""NK fitness landscapes and Metropolis-Hastings tree evolution.

Behavioral counterpart of ``/root/reference/src/trex/nk_model.py``: a random
epistatic landscape (per-site lookup tables over the site's own state and K
partner states) plus a simulator that evolves sequences down a tree with
coupled/random mutation proposals filtered by an MH acceptance step.

Design notes:

- The landscape is a typed pytree (``NKLandscape``) rather than a loose dict;
  fitness evaluation is the same gather + power-basis dot as the reference
  (``nk_model.py:97-110``) — already fully vectorized, no per-site loops.
- The tree walk needs no BFS toposort (``nk_model.py:157-192``): under the
  engine's node-ordering contract children have smaller indices than parents,
  so one ``fori_loop`` over nodes in descending index order is a valid
  root-down schedule. An adjacency-matrix wrapper keeps API parity.
- The MH chain is inherently sequential per edge; it stays a ``fori_loop``
  (this is data generation, not the hot path).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from trex_tpu.topology import Topology, topology_from_adjacency, topology_to_adjacency
from trex_tpu.types import PhyloData, default_dtype


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class NKLandscape:
    """Random NK epistatic fitness landscape.

    ``interactions[i]`` lists the K partner sites of site ``i``;
    ``tables[i]`` is the flattened q^(K+1) fitness lookup for
    (own state, partner states) combinations.
    """

    interactions: jax.Array  # (L, K) int32
    tables: jax.Array  # (L, q**(K+1)) float
    n_states: int = dataclasses.field(metadata=dict(static=True))
    k: int = dataclasses.field(metadata=dict(static=True))


def make_landscape(
    n_sites: int, k: int, key: jax.Array, n_states: int = 2
) -> NKLandscape:
    """Sample a random landscape (``create_nk_model_landscape``, ``nk_model.py:17-43``)."""
    inter_key, table_key = jax.random.split(key)
    interactions = jax.random.randint(inter_key, (n_sites, k), 0, n_sites)
    tables = jax.random.uniform(table_key, (n_sites, n_states ** (k + 1)))
    return NKLandscape(
        interactions=interactions.astype(jnp.int32),
        tables=tables,
        n_states=n_states,
        k=k,
    )


def sequence_fitness(
    sequence: jax.Array,
    landscape: NKLandscape,
    site_mask: jax.Array | None = None,
) -> jax.Array:
    """Mean per-site table fitness of an integer sequence.

    index_i = sum_j s_j * q^j over (own state, partner states); masked mean
    over valid sites (``get_fitness``, ``nk_model.py:46-110``).
    """
    n_sites = sequence.shape[-1]
    own = jnp.arange(n_sites, dtype=jnp.int32)[:, None]
    gather_idx = jnp.concatenate([own, landscape.interactions], axis=-1)  # (L, K+1)
    states = sequence[gather_idx].astype(jnp.int32)
    powers = landscape.n_states ** jnp.arange(gather_idx.shape[-1], dtype=jnp.int32)
    table_idx = jnp.sum(states * powers, axis=-1)
    values = landscape.tables[jnp.arange(n_sites), table_idx]
    if site_mask is None:
        return jnp.mean(values)
    mask = site_mask.astype(values.dtype)
    return jnp.sum(values * mask) / jnp.sum(mask)


batched_sequence_fitness = jax.vmap(sequence_fitness, in_axes=(0, None))


def _mh_edge_walk(
    parent_seq: jax.Array,
    key: jax.Array,
    landscape: NKLandscape,
    mutation_rate: float,
    coupled_prob: float,
    rate_noise_std: float,
    branch_length: int,
    n_states: int,
) -> jax.Array:
    """Evolve one child from its parent: ``branch_length`` MH-filtered steps.

    Matches the reference's edge model (``nk_model.py:202-254``): per-edge
    log-normal mutation-rate noise, coupled-vs-random proposals, accept with
    probability ``min(1, exp(dF))``.
    """
    seq_length = parent_seq.shape[-1]
    key, noise_key = jax.random.split(key)
    noise = jax.random.normal(noise_key) * rate_noise_std
    edge_rate = jnp.minimum(mutation_rate * jnp.exp(noise), 1.0)

    def step(_, carry):
        seq, k = carry
        k, choose_k, prop_k1, prop_k2, accept_k = jax.random.split(k, 5)

        # Random proposal: iid per-site resample at the edge rate.
        random_hit = jax.random.bernoulli(prop_k1, edge_rate, (seq_length,))
        fresh = jax.random.randint(prop_k2, (seq_length,), 0, n_states)

        # Coupled proposal: resample one site plus its epistatic partners.
        site = jax.random.randint(prop_k1, (), 0, seq_length)
        partner_sites = jnp.concatenate(
            [site[None], landscape.interactions[site]]
        )
        coupled_hit = jnp.zeros(seq_length, dtype=bool).at[partner_sites].set(True)

        use_coupled = jax.random.bernoulli(choose_k, coupled_prob)
        hit = jnp.where(use_coupled, coupled_hit, random_hit)
        proposal = jnp.where(hit, fresh, seq)

        delta = sequence_fitness(proposal, landscape) - sequence_fitness(seq, landscape)
        accept = jax.random.bernoulli(accept_k, jnp.minimum(1.0, jnp.exp(delta)))
        return jnp.where(accept, proposal, seq), k

    final_seq, _ = jax.lax.fori_loop(0, branch_length, step, (parent_seq, key))
    return final_seq


@partial(
    jax.jit,
    static_argnames=(
        "coupled_prob",
        "rate_noise_std",
        "branch_length",
        "mutation_rate",
    ),
)
def evolve_tree(
    landscape: NKLandscape,
    topology: Topology,
    root_sequence: jax.Array,
    mutation_rate: float,
    key: jax.Array,
    coupled_prob: float = 0.5,
    rate_noise_std: float = 0.0,
    branch_length: int = 1,
) -> jax.Array:
    """Evolve sequences down a tree, returning (n_all, L) int32 sequences.

    Walks nodes root-down (descending index order — valid because children
    have smaller indices than parents under the engine contract).
    """
    n_all = topology.n_all
    seq_length = root_sequence.shape[-1]
    n_states = landscape.n_states

    seqs0 = jnp.zeros((n_all, seq_length), dtype=jnp.int32)
    seqs0 = seqs0.at[n_all - 1].set(root_sequence.reshape(seq_length))
    node_keys = jax.random.split(key, n_all)

    def visit(i, seqs):
        node = n_all - 2 - i  # descending, root (already set) excluded
        child_seq = _mh_edge_walk(
            seqs[topology.parents[node]],
            node_keys[node],
            landscape,
            mutation_rate,
            coupled_prob,
            rate_noise_std,
            branch_length,
            n_states,
        )
        return seqs.at[node].set(child_seq)

    return jax.lax.fori_loop(0, n_all - 1, visit, seqs0)


def evolve_tree_on_adjacency(
    landscape: NKLandscape,
    adjacency: jax.Array,
    root_sequence: jax.Array,
    mutation_rate: float,
    key: jax.Array,
    coupled_prob: float = 0.5,
    rate_noise_std: float = 0.0,
    branch_length: int = 1,
) -> PhyloData:
    """Adjacency-API wrapper matching ``generate_tree_data`` (``nk_model.py:116-278``)."""
    n_all = adjacency.shape[-1]
    n_leaves = (n_all + 1) // 2
    topo = topology_from_adjacency(adjacency, n_leaves)
    all_seqs = evolve_tree(
        landscape,
        topo,
        root_sequence,
        mutation_rate,
        key,
        coupled_prob=coupled_prob,
        rate_noise_std=rate_noise_std,
        branch_length=branch_length,
    )
    dtype = default_dtype()
    return PhyloData(
        masked_sequences=jnp.zeros_like(all_seqs).astype(dtype),
        all_sequences=all_seqs.astype(dtype),
        adjacency=topology_to_adjacency(topo, dtype=dtype),
    )
