"""Marginal ancestral state reconstruction under the likelihood model.

The parsimony side reconstructs ancestors by backtracking
(``ops.sankoff.sankoff_reconstruct``, ``ops.fitch.fitch_reconstruct``); this
module is the ML counterpart: per-node **marginal posterior** state
probabilities via the standard inside-outside (up-down) pruning passes.

For node v with parent p and sibling s:

    outside(v) = P_v^T @ ( outside(p) * (P_s @ inside(s)) )
    posterior(v) ∝ outside(v) * inside(v)

with ``outside(root) = prior``. Both passes are ``lax.scan``s over the
ancestor index order (upward forward, downward reverse — children always
have smaller indices than their parent, the engine's topological-numbering
invariant), laid out (nodes, states, sites) so sites are the vector axis.
Per-site normalization of the posterior cancels all underflow scalings, so
no log-scale bookkeeping is needed in the downward pass beyond per-node
renormalization.

The same outside pass yields analytic branch-length gradients
(d logL / d t_v = Σ_sites outside(v)ᵀ (dP/dt) inside(v) / site_lik); see
``branch_length_gradients``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from trex_tpu.ops.likelihood import highest_matmul_precision, gtr_generator, jc69_transition
from trex_tpu.topology import Topology


def _transitions(branch_lengths, n_states, rates, freqs):
    """(n_all, Q, Q) per-node transition matrices + (Q,) root prior + generator."""
    q = n_states
    if rates is not None or freqs is not None:
        if freqs is None:
            freqs = jnp.full((q,), 1.0 / q)
        if rates is None:
            rates = jnp.ones((q, q))
        gen = gtr_generator(rates, freqs)
        pmats = jax.vmap(lambda t: jax.scipy.linalg.expm(gen * t))(
            branch_lengths
        )
        prior = freqs
    else:
        # JC69 generator: off-diagonal 1/(Q-1), diagonal -1 (normalized).
        gen = (jnp.ones((q, q)) - q * jnp.eye(q)) / (q - 1.0)
        pmats = jax.vmap(lambda t: jc69_transition(t, q))(branch_lengths)
        prior = jnp.full((q,), 1.0 / q)
    return pmats, prior, gen


def _inside_partials(topology, pmats, leaf_sequences, n_states, masks):
    """Upward (inside) partials, per-node renormalized; (n_all, Q, L)."""
    n_leaves = topology.n_leaves
    n_all = topology.n_all
    length = leaf_sequences.shape[-1]
    q = n_states

    states = jnp.arange(q, dtype=jnp.int32)
    if masks:
        tip = (
            (leaf_sequences.astype(jnp.int32)[:, None, :] >> states[None, :, None]) & 1
        ).astype(jnp.float32)
    else:
        # Negative states are missing data: all-ones tip partial, matching
        # _per_site_log_likelihood (an all-ZERO tip would silently collapse
        # every posterior at that site to 0).
        leaves = leaf_sequences.astype(jnp.int32)[:, None, :]
        tip = (
            (leaves == states[None, :, None]) | (leaves < 0)
        ).astype(jnp.float32)
    inside0 = jnp.zeros((n_all, q, length))
    inside0 = inside0.at[:n_leaves].set(tip)

    def up(inside, inputs):
        anc_offset, child_pair = inputs
        child_inside = inside[child_pair]  # (2, Q, L)
        child_mats = pmats[child_pair]  # (2, Q, Q)
        messages = jnp.einsum(
            "cij,cjl->cil", child_mats, child_inside,
            preferred_element_type=jnp.float32,
        )
        combined = messages[0] * messages[1]
        # Renormalize per site; posteriors normalize per site anyway, so the
        # dropped constant never matters downstream.
        combined = combined / jnp.maximum(
            jnp.max(combined, axis=0, keepdims=True), 1e-30
        )
        inside = jax.lax.dynamic_update_slice(
            inside, combined[None], (n_leaves + anc_offset, 0, 0)
        )
        return inside, None

    offsets = jnp.arange(topology.n_ancestors, dtype=jnp.int32)
    inside, _ = jax.lax.scan(up, inside0, (offsets, topology.children))
    return inside


def _outside_partials(topology, pmats, inside, prior):
    """Downward pass. Returns (outside, upstream), each (n_all, Q, L).

    Conventions (per non-root node v with parent p, sibling s):

    - ``upstream(v)`` lives at the PARENT's states: everything outside
      subtree(v), EXCLUDING v's own branch —
      ``outside(p) * (P_s @ inside(s))``. ``site_lik ∝ upstream(v)ᵀ P_v
      inside(v)`` (the branch-gradient denominator).
    - ``outside(v) = P_vᵀ @ upstream(v)`` lives at v's own states;
      ``posterior(v) ∝ outside(v) * inside(v)``.

    Both are per-site renormalized; the shared scalar cancels in posteriors
    and in the gradient ratio. The root's outside is the prior and its
    upstream row is zero (no branch above).
    """
    n_leaves = topology.n_leaves
    n_all = topology.n_all
    q, length = inside.shape[-2:]

    outside0 = jnp.zeros((n_all, q, length))
    outside0 = outside0.at[-1].set(
        jnp.broadcast_to(prior[:, None], (q, length))
    )
    upstream0 = jnp.zeros((n_all, q, length))

    def down(carry, inputs):
        outside, upstream = carry
        anc_offset, child_pair = inputs
        parent_outside = outside[n_leaves + anc_offset]  # (Q, L)
        child_mats = pmats[child_pair]  # (2, Q, Q)
        # Sibling message of each child = P_sib @ inside(sib), swapped.
        sib_msgs = jnp.einsum(
            "cij,cjl->cil", child_mats, inside[child_pair],
            preferred_element_type=jnp.float32,
        )[::-1]
        up = parent_outside[None] * sib_msgs  # (2, Q, L) at parent states
        up = up / jnp.maximum(jnp.max(up, axis=1, keepdims=True), 1e-30)
        child_outside = jnp.einsum(
            "cji,cjl->cil", child_mats, up,
            preferred_element_type=jnp.float32,
        )
        outside = outside.at[child_pair[0]].set(child_outside[0])
        outside = outside.at[child_pair[1]].set(child_outside[1])
        upstream = upstream.at[child_pair[0]].set(up[0])
        upstream = upstream.at[child_pair[1]].set(up[1])
        return (outside, upstream), None

    offsets = jnp.arange(topology.n_ancestors, dtype=jnp.int32)
    (outside, upstream), _ = jax.lax.scan(
        down, (outside0, upstream0), (offsets, topology.children),
        reverse=True,
    )
    return outside, upstream


@partial(jax.jit, static_argnames=("n_states", "sequences_are_masks"))
@highest_matmul_precision
def marginal_ancestral_posteriors(
    topology: Topology,
    branch_lengths: jax.Array,
    leaf_sequences: jax.Array,
    n_states: int,
    rates: jax.Array | None = None,
    freqs: jax.Array | None = None,
    *,
    sequences_are_masks: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Per-node marginal posterior state probabilities + MAP states.

    Args:
        branch_lengths: (n_all,) length above each node (root ignored).
        rates/freqs: optional GTR model (JC69 + uniform prior when None).

    Returns:
        posteriors: (n_all, Q, L) — P(state at node | data, tree); leaf rows
            are the (normalized) tip distributions, so ambiguous leaves get
            data-informed posteriors too.
        map_states: (n_all, L) int32 argmax states.
    """
    pmats, prior, _ = _transitions(branch_lengths, n_states, rates, freqs)
    inside = _inside_partials(
        topology, pmats, leaf_sequences, n_states, sequences_are_masks
    )
    outside, _ = _outside_partials(topology, pmats, inside, prior)
    joint = inside * outside  # (n_all, Q, L), unnormalized
    posteriors = joint / jnp.maximum(
        jnp.sum(joint, axis=1, keepdims=True), 1e-30
    )
    map_states = jnp.argmax(posteriors, axis=1).astype(jnp.int32)
    return posteriors, map_states


@partial(jax.jit, static_argnames=("n_states", "sequences_are_masks"))
@highest_matmul_precision
def branch_length_gradients(
    topology: Topology,
    branch_lengths: jax.Array,
    leaf_sequences: jax.Array,
    n_states: int,
    rates: jax.Array | None = None,
    freqs: jax.Array | None = None,
    site_weights: jax.Array | None = None,
    *,
    sequences_are_masks: bool = False,
) -> jax.Array:
    """Analytic d logL / d branch_lengths, all branches in two passes.

    The inside-outside identity (cf. BEAGLE-style linear-time gradients;
    autodiff through the pruning scan computes the same thing with a stored
    transposed scan — this form is the explicit two-pass version), with
    ``upstream(v)`` the parent-side outside EXCLUDING v's own branch:

        d logL / d t_v = Σ_sites w_s ·
            upstream(v)ᵀ (Q P(t_v)) inside(v) / (upstream(v)ᵀ P(t_v) inside(v))

    Per-node rescalings of inside/upstream cancel in the ratio. Verified
    against ``jax.grad`` of ``tree_log_likelihood`` in
    ``tests/test_likelihood_asr.py``; at 64 taxa the two f32 paths agree to
    ~1% (different accumulation orders), exact at small sizes.

    XLA's transposed scan (``jax.grad`` of the pruning scan) is already the
    linear-time algorithm, so use this form when you ALSO need the
    posteriors (shared passes), not as a speedup.

    Returns (n_all,) gradients; the root entry is 0 (no branch above).
    """
    pmats, prior, gen = _transitions(branch_lengths, n_states, rates, freqs)
    inside = _inside_partials(
        topology, pmats, leaf_sequences, n_states, sequences_are_masks
    )
    _, upstream = _outside_partials(topology, pmats, inside, prior)

    # For every non-root node v: numerator uses d P/d t = Q @ P(t).
    dpmats = jnp.einsum(
        "ij,njk->nik", gen, pmats, preferred_element_type=jnp.float32
    )
    denom = jnp.einsum(
        "nil,nij,njl->nl", upstream, pmats, inside,
        preferred_element_type=jnp.float32,
    )
    numer = jnp.einsum(
        "nil,nij,njl->nl", upstream, dpmats, inside,
        preferred_element_type=jnp.float32,
    )
    ratio = numer / jnp.maximum(denom, 1e-30)  # (n_all, L)
    if site_weights is not None:
        ratio = ratio * site_weights.astype(ratio.dtype)[None, :]
    grads = jnp.sum(ratio, axis=-1)
    return grads.at[-1].set(0.0)


def _branch_curvatures(
    topology, branch_lengths, leaf_sequences, n_states,
    rates, freqs, site_weights, masks,
):
    """(gradient, hessian-diagonal) of logL w.r.t. every branch length.

    Per site u = upstreamᵀ P inside (∝ site likelihood):
        d logL/dt   = Σ w u'/u          with u'  = upstreamᵀ (G P) inside
        d² logL/dt² = Σ w (u''/u − (u'/u)²),  u'' = upstreamᵀ (G² P) inside
    """
    pmats, prior, gen = _transitions(branch_lengths, n_states, rates, freqs)
    inside = _inside_partials(topology, pmats, leaf_sequences, n_states, masks)
    _, upstream = _outside_partials(topology, pmats, inside, prior)

    dpmats = jnp.einsum("ij,njk->nik", gen, pmats)
    d2pmats = jnp.einsum("ij,njk->nik", gen, dpmats)

    def contract(mats):
        return jnp.einsum(
            "nil,nij,njl->nl", upstream, mats, inside,
            preferred_element_type=jnp.float32,
        )

    u = jnp.maximum(contract(pmats), 1e-30)
    r1 = contract(dpmats) / u  # (n_all, L)
    r2 = contract(d2pmats) / u
    if site_weights is None:
        w = 1.0
    else:
        w = site_weights.astype(r1.dtype)[None, :]
    grad = jnp.sum(w * r1, axis=-1)
    hess = jnp.sum(w * (r2 - r1 * r1), axis=-1)
    return grad.at[-1].set(0.0), hess.at[-1].set(-1.0)


@partial(
    jax.jit,
    static_argnames=("n_states", "sequences_are_masks", "n_sweeps"),
)
@highest_matmul_precision
def optimize_branch_lengths_newton(
    topology: Topology,
    leaf_sequences: jax.Array,
    n_states: int,
    rates: jax.Array | None = None,
    freqs: jax.Array | None = None,
    site_weights: jax.Array | None = None,
    *,
    sequences_are_masks: bool = False,
    init_length: float = 0.1,
    n_sweeps: int = 12,
    min_length: float = 1e-6,
    max_length: float = 10.0,
) -> tuple[jax.Array, jax.Array]:
    """ML branch lengths by damped Newton sweeps on analytic derivatives.

    Each sweep updates ALL branches simultaneously with the coordinate
    Newton step ``t - g/h`` (curvature-guarded: non-concave coordinates fall
    back to a bounded gradient step), then backtracks by halving toward the
    previous lengths (up to 4 times, jointly) if the total log-likelihood
    got worse. Converges in ~5-10 sweeps vs hundreds of Adam iterations
    (``optimize_branch_lengths``) — each sweep costs two pruning passes.

    Returns (branch_lengths (n_all,), nll curve (n_sweeps+1,)).
    """
    from trex_tpu.ops.likelihood import tree_log_likelihood

    n_all = topology.n_all

    def nll(lengths):
        return -tree_log_likelihood(
            topology, lengths, leaf_sequences, n_states,
            site_mask=site_weights, rates=rates, freqs=freqs,
            sequences_are_masks=sequences_are_masks,
        )

    def sweep(carry, _):
        lengths, current = carry
        grad, hess = _branch_curvatures(
            topology, lengths, leaf_sequences, n_states,
            rates, freqs, site_weights, sequences_are_masks,
        )
        newton = lengths - grad / jnp.minimum(hess, -1e-8)
        fallback = lengths + jnp.clip(0.1 * grad, -0.5, 0.5)
        proposed = jnp.where(hess < -1e-8, newton, fallback)
        proposed = jnp.clip(proposed, min_length, max_length)
        proposed = proposed.at[-1].set(lengths[-1])

        def backtrack(state, _):
            cand, best_cand, best_val = state
            value = nll(cand)
            improved = value < best_val
            best_cand = jnp.where(improved, cand, best_cand)
            best_val = jnp.minimum(value, best_val)
            # Halve toward the incumbent for the next evaluation.
            return (
                (cand + lengths) / 2.0, best_cand, best_val
            ), None

        (_, accepted, new_val), _ = jax.lax.scan(
            backtrack, (proposed, lengths, current), None, length=4
        )
        return (accepted, new_val), new_val

    lengths0 = jnp.full((n_all,), init_length)
    nll0 = nll(lengths0)
    (lengths, _), curve = jax.lax.scan(
        sweep, (lengths0, nll0), None, length=n_sweeps
    )
    return lengths, jnp.concatenate([nll0[None], curve])


@partial(jax.jit, static_argnames=("n_states", "sequences_are_masks"))
@highest_matmul_precision
def joint_ancestral_reconstruction(
    topology: Topology,
    branch_lengths: jax.Array,
    leaf_sequences: jax.Array,
    n_states: int,
    rates: jax.Array | None = None,
    freqs: jax.Array | None = None,
    *,
    sequences_are_masks: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """JOINT ML ancestral states (Pupko et al. 2000 max-product DP).

    ``marginal_ancestral_posteriors`` maximizes each node's posterior
    independently; this maximizes the probability of the ENTIRE ancestral
    assignment at once. Per site and node v with parent p:

        M_v(s_p) = max_{s_v} [ log P_v(s_p -> s_v) + T_v(s_v) ]
        T_v(s_v) = sum_{c in children(v)} M_c(s_v)   (leaves: 0/-inf tips)

    with the root maximizing ``log prior + T_root``; the argmax tables are
    replayed root-down. Exactly the Sankoff recursion with per-edge
    -log-transition costs — verified against exhaustive enumeration in
    ``tests/test_likelihood_asr.py``.

    Returns:
        states: (n_all, L) int32 jointly-optimal assignment (leaf rows are
            the observed states; ambiguous leaves get their ML resolution).
        joint_log_prob: (L,) per-site log-probability of that assignment.
    """
    n_leaves = topology.n_leaves
    n_all = topology.n_all
    length = leaf_sequences.shape[-1]
    q = n_states

    pmats, prior, _ = _transitions(branch_lengths, n_states, rates, freqs)
    logp = jnp.log(jnp.maximum(pmats, 1e-30))  # (n_all, Q_parent, Q_child)

    neg_inf = jnp.asarray(-1e30, jnp.float32)
    states_iota = jnp.arange(q, dtype=jnp.int32)
    if sequences_are_masks:
        allowed = (
            (leaf_sequences.astype(jnp.int32)[:, None, :]
             >> states_iota[None, :, None]) & 1
        ) == 1
    else:
        leaves = leaf_sequences.astype(jnp.int32)[:, None, :]
        allowed = (leaves == states_iota[None, :, None]) | (leaves < 0)
    tip_scores = jnp.where(allowed, 0.0, neg_inf)  # (n_leaves, Q, L)

    # Leaf messages to parents: M_leaf(s_p) over own allowed states.
    def leaf_message(leaf):
        cand = logp[leaf][:, :, None] + tip_scores[leaf][None, :, :]
        return jnp.max(cand, axis=1), jnp.argmax(cand, axis=1)

    leaf_m, leaf_a = jax.vmap(leaf_message)(
        jnp.arange(n_leaves, dtype=jnp.int32)
    )
    messages0 = jnp.zeros((n_all, q, length))
    messages0 = messages0.at[:n_leaves].set(leaf_m)
    argmax0 = jnp.zeros((n_all, q, length), jnp.int32)
    argmax0 = argmax0.at[:n_leaves].set(leaf_a.astype(jnp.int32))
    subtree0 = jnp.zeros((n_all, q, length))
    subtree0 = subtree0.at[:n_leaves].set(tip_scores)

    def up(carry, inputs):
        messages, argmax, subtree = carry
        anc_offset, child_pair = inputs
        node = n_leaves + anc_offset
        t_v = messages[child_pair[0]] + messages[child_pair[1]]  # (Q, L)
        cand = logp[node][:, :, None] + t_v[None, :, :]  # (Qp, Qv, L)
        messages = jax.lax.dynamic_update_slice(
            messages, jnp.max(cand, axis=1)[None], (node, 0, 0)
        )
        argmax = jax.lax.dynamic_update_slice(
            argmax,
            jnp.argmax(cand, axis=1).astype(jnp.int32)[None],
            (node, 0, 0),
        )
        subtree = jax.lax.dynamic_update_slice(
            subtree, t_v[None], (node, 0, 0)
        )
        return (messages, argmax, subtree), None

    offsets = jnp.arange(topology.n_ancestors, dtype=jnp.int32)
    (messages, argmax, subtree), _ = jax.lax.scan(
        up, (messages0, argmax0, subtree0), (offsets, topology.children)
    )

    root_score = jnp.log(prior)[:, None] + subtree[-1]  # (Q, L)
    joint_log_prob = jnp.max(root_score, axis=0)  # (L,)
    root_state = jnp.argmax(root_score, axis=0).astype(jnp.int32)

    states0 = jnp.zeros((n_all, length), jnp.int32)
    states0 = states0.at[-1].set(root_state)
    site_idx = jnp.arange(length)

    def down(states, inputs):
        anc_offset, child_pair = inputs
        node_state = states[n_leaves + anc_offset]  # (L,)
        for k in range(2):
            child = child_pair[k]
            child_state = argmax[child][node_state, site_idx]
            states = states.at[child].set(child_state)
        return states, None

    states, _ = jax.lax.scan(
        down, states0, (offsets, topology.children), reverse=True
    )
    return states, joint_log_prob
