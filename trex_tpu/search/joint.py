"""Joint topology + sequence optimization and topology-only search.

The "differentiable evolution tree search" loops: anneal a Gumbel-softmax
topology and soft ancestor sequences against the surrogate parsimony cost +
binary-tree constraint (reference flow: ``tests/test_convergence.py:208-299``
driving ``tree.py:299-361``).

On device: the whole annealing schedule runs inside one jitted ``lax.scan``
(temperature is a scanned input), so a 5000-step search is a single XLA
program — the reference re-enters jit from Python each epoch.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import optax

from trex_tpu.ops.costs import surrogate_cost
from trex_tpu.ops.relax import (
    binary_tree_penalty,
    discretize_topology,
    soft_sequences,
    soft_topology,
)
from trex_tpu.search.optimizers import make_optimizer


@dataclasses.dataclass(frozen=True)
class JointConfig:
    """Hyperparameters of the joint search (defaults = reference test setup)."""

    n_iterations: int = 5000
    learning_rate: float = 0.01
    optimizer: str = "adam"
    clip_global_norm: float | None = None
    temp_start: float = 2.0
    temp_end: float = 0.1
    constraint_scale: float = 10.0
    learn_sequences: bool = True
    learn_topology: bool = True


def _anneal(cfg: JointConfig) -> jax.Array:
    """Linear temperature ramp, floored at ``temp_end`` (convergence-test
    schedule: ``max(0.1, 2.0 * (1 - epoch/n))``)."""
    steps = jnp.arange(cfg.n_iterations, dtype=jnp.float32)
    return jnp.maximum(
        cfg.temp_end, cfg.temp_start * (1.0 - steps / cfg.n_iterations)
    )


def init_params(
    key: jax.Array, n_leaves: int, seq_length: int, n_states: int
) -> dict[str, jax.Array]:
    """Gaussian-init topology logits (n_all-1, n_anc) + ancestor logits."""
    n_all = 2 * n_leaves - 1
    n_anc = n_leaves - 1
    tree_key, seq_key = jax.random.split(key)
    return {
        "tree_params": jax.random.normal(tree_key, (n_all - 1, n_anc)),
        "ancestors": jax.random.normal(seq_key, (n_anc, seq_length, n_states)),
    }


@partial(jax.jit, static_argnames=("cfg",))
def joint_optimize(
    key: jax.Array,
    params: dict[str, jax.Array],
    leaf_tensor: jax.Array,
    cfg: JointConfig = JointConfig(),
    fixed_adjacency: jax.Array | None = None,
    fixed_sequences: jax.Array | None = None,
):
    """Run the annealed joint search.

    Args:
        params: ``init_params`` pytree.
        leaf_tensor: (n_all, L, Q) one-hot leaves, zero ancestor rows.
        fixed_adjacency: when ``cfg.learn_topology`` is False, the topology to
            hold fixed (soft or one-hot row-stochastic).
        fixed_sequences: when ``cfg.learn_sequences`` is False, the (N, L, Q)
            sequence tensor to hold fixed.

    Returns:
        (params, losses): optimized parameters and the per-step loss curve.
    """
    n_all = leaf_tensor.shape[0]
    n_leaves = (n_all + 1) // 2
    optimizer = make_optimizer(
        cfg.optimizer, cfg.learning_rate, clip_global_norm=cfg.clip_global_norm
    )
    opt_state = optimizer.init(params)
    temps = _anneal(cfg)
    step_keys = jax.random.split(key, cfg.n_iterations)

    def loss_fn(p, temperature, step_key):
        if cfg.learn_sequences:
            seqs = soft_sequences(p["ancestors"], leaf_tensor, n_leaves, temperature)
        else:
            seqs = fixed_sequences
        if cfg.learn_topology:
            # Topology softmax runs at T=1 (reference: tree.py:338); the
            # anneal controls only the constraint weight + sequence softmax.
            tree = soft_topology(step_key, p["tree_params"])
            penalty = temperature * binary_tree_penalty(tree, cfg.constraint_scale)
        else:
            tree = fixed_adjacency
            penalty = 0.0
        return surrogate_cost(seqs, tree) + penalty

    # Freeze gradients of whatever is fixed (reference grad-mask pattern,
    # tests/test_convergence.py:124-129).
    mask = {
        "tree_params": 1.0 if cfg.learn_topology else 0.0,
        "ancestors": 1.0 if cfg.learn_sequences else 0.0,
    }

    def step(carry, inputs):
        p, s = carry
        temperature, step_key = inputs
        loss, grads = jax.value_and_grad(loss_fn)(p, temperature, step_key)
        grads = jax.tree_util.tree_map(lambda g, m: g * m, grads, mask)
        updates, s = optimizer.update(grads, s, p)
        p = optax.apply_updates(p, updates)
        return (p, s), loss

    (params, _), losses = jax.lax.scan(step, (params, opt_state), (temps, step_keys))
    return params, losses


def extract_solution(
    key: jax.Array,
    params: dict[str, jax.Array],
    leaf_tensor: jax.Array,
    eval_temperature: float = 0.01,
):
    """Discretized topology + sequences from trained parameters.

    Returns (soft_tree, hard_tree, soft_seqs): evaluation-temperature soft
    adjacency, its one-hot discretization, and the near-hard sequences.
    """
    n_all = leaf_tensor.shape[0]
    n_leaves = (n_all + 1) // 2
    soft_tree = soft_topology(key, params["tree_params"], eval_temperature)
    hard_tree = discretize_topology(soft_tree)
    soft_seqs = soft_sequences(
        params["ancestors"], leaf_tensor, n_leaves, eval_temperature
    )
    return soft_tree, hard_tree, soft_seqs


def evaluate_solution(
    key: jax.Array,
    params: dict[str, jax.Array],
    leaf_tensor: jax.Array,
    cost_matrix: jax.Array,
    eval_temperature: float = 0.01,
) -> jax.Array:
    """Discrete parsimony score of a trained joint solution.

    Discretizes at ``eval_temperature``, reorders nodes by the learned parent
    assignment, and scores with ``exact_cost`` — the reference's evaluation
    recipe (``tests/test_convergence.py:264-296``).
    """
    from trex_tpu.ops.costs import exact_cost

    soft_tree, hard_tree, soft_seqs = extract_solution(
        key, params, leaf_tensor, eval_temperature
    )
    q = leaf_tensor.shape[-1]
    hard_seqs = jax.nn.one_hot(jnp.argmax(soft_seqs, axis=-1), q)
    order = jnp.argmax(hard_tree, axis=1)
    reordered_tree = soft_tree[order][:, order]
    reordered_seqs = hard_seqs[order]
    return exact_cost(reordered_seqs, reordered_tree, cost_matrix)


def joint_search(
    key: jax.Array,
    leaf_tensor: jax.Array,
    cost_matrix: jax.Array,
    cfg: JointConfig = JointConfig(),
    n_restarts: int = 8,
    mesh=None,
):
    """Multi-restart joint search; restarts are a vmapped batch axis.

    Returns (params, losses, score) of the restart whose discretized solution
    has the lowest exact parsimony cost.

    ``mesh``: optional ``jax.sharding.Mesh`` with a 'tree' axis — restarts
    are pure data parallelism, so sharding the restart-key batch over it
    lets jit/GSPMD shard every descent (``n_restarts`` must divide by the
    tree axis size); results are identical to the unsharded vmap.
    """
    n_all = leaf_tensor.shape[0]
    n_leaves = (n_all + 1) // 2
    seq_length, q = leaf_tensor.shape[1], leaf_tensor.shape[2]

    def one_restart(restart_key):
        k_init, k_run, k_eval = jax.random.split(restart_key, 3)
        params = init_params(k_init, n_leaves, seq_length, q)
        params, losses = joint_optimize(k_run, params, leaf_tensor, cfg)
        score = evaluate_solution(k_eval, params, leaf_tensor, cost_matrix)
        return params, losses, score

    keys = jax.random.split(key, n_restarts)
    if mesh is not None:
        keys = _shard_restart_keys(mesh, keys, n_restarts)
    params_b, losses_b, scores = jax.jit(jax.vmap(one_restart))(keys)
    best = jnp.argmin(scores)
    params = jax.tree_util.tree_map(lambda x: x[best], params_b)
    return params, losses_b[best], scores[best]


def _shard_restart_keys(mesh, keys, n_restarts):
    """Shard a restart-key batch over the mesh's 'tree' axis (data parallel)."""
    from jax.sharding import NamedSharding, PartitionSpec

    from trex_tpu.parallel.mesh import TREE_AXIS

    n_tree = mesh.shape[TREE_AXIS]
    if n_restarts % n_tree != 0:
        raise ValueError(
            f"n_restarts = {n_restarts} must be divisible by the mesh tree "
            f"axis size ({n_tree})"
        )
    return jax.device_put(keys, NamedSharding(mesh, PartitionSpec(TREE_AXIS)))


def fit_topology(
    key: jax.Array,
    sequences_one_hot: jax.Array,
    n_iterations: int = 3000,
    learning_rate: float = 0.05,
    constraint_scale: float = 10.0,
    n_restarts: int = 8,
    mesh=None,
):
    """Learn only the topology for known (hard) sequences.

    The reference's "fixed sequences, learned topology" regime
    (``tests/test_convergence.py:150-204``): constraint penalty is NOT
    temperature-scaled here.

    Addition over the reference: ``n_restarts`` Gumbel descents run as one
    vmapped program (restarts are a batch axis, nearly free on device)
    and the restart with the best evaluated discrete cost wins — single-seed
    descent lands in local minima for most seeds.
    """
    from trex_tpu.ops.costs import exact_cost

    n_all = sequences_one_hot.shape[0]
    n_leaves = (n_all + 1) // 2
    n_anc = n_all - n_leaves
    optimizer = make_optimizer("adam", learning_rate, clip_global_norm=None)

    def one_restart(restart_key):
        tree_key, run_key, eval_key = jax.random.split(restart_key, 3)
        params = {"tree_params": jax.random.normal(tree_key, (n_all - 1, n_anc))}
        opt_state = optimizer.init(params)
        step_keys = jax.random.split(run_key, n_iterations)

        def loss_fn(p, step_key):
            tree = soft_topology(step_key, p["tree_params"], 1.0)
            return surrogate_cost(sequences_one_hot, tree) + binary_tree_penalty(
                tree, constraint_scale
            )

        def step(carry, step_key):
            p, s = carry
            loss, grads = jax.value_and_grad(loss_fn)(p, step_key)
            updates, s = optimizer.update(grads, s, p)
            p = optax.apply_updates(p, updates)
            return (p, s), loss

        (params, _), losses = jax.lax.scan(step, (params, opt_state), step_keys)
        tree = soft_topology(eval_key, params["tree_params"], 0.01)
        q = sequences_one_hot.shape[-1]
        hamming = jnp.ones((q, q)) - jnp.eye(q)
        score = exact_cost(sequences_one_hot, tree, hamming)
        return params, losses, score

    restart_keys = jax.random.split(key, n_restarts)
    if mesh is not None:
        restart_keys = _shard_restart_keys(mesh, restart_keys, n_restarts)
    params_b, losses_b, scores = jax.jit(jax.vmap(one_restart))(restart_keys)
    best = jnp.argmin(scores)
    params = jax.tree_util.tree_map(lambda x: x[best], params_b)
    return params, losses_b[best]
