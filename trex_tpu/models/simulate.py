"""General CTMC alignment simulator (seq-gen equivalent).

Samples an alignment down an arbitrary rooted tree under any reversible
substitution model the likelihood layer supports — JC69, GTR, empirical
amino-acid matrices — with optional discrete-Gamma site-rate heterogeneity
and an invariant-sites category, matching the mixing conventions of
``ops.likelihood`` exactly (p_inv · invariant + (1-p_inv) · mean-1 Gamma
categories; branch lengths in expected substitutions per site).

Two implementations behind one API:

- Host-side (numpy + scipy.expm), like the reference's generators
  (`/root/reference/src/trex/ground_truth.py:112-197`,
  `/root/reference/src/trex/nk_model.py:116-278`) — the default at small
  sizes so test fixtures stay byte-identical across rounds.
- Device-side: ONE ``lax.scan`` over ancestors (root first — the
  ``models/mutation_tree.py`` single-scan pattern: children have smaller
  indices than their parent, so every parent row is written before its
  children read it), with all (node, rate-category) transition matrices
  built in one vmapped ``expm`` up front and every site sampled in
  parallel per step. Auto-selected above ``_DEVICE_CELLS`` cells on an
  accelerator: the host walk costs ~2 scipy.expm calls per ancestor per
  category (~32k sequential calls at 8192 taxa x 1024 sites); the scan
  replaces them with one compiled program.
  Same model, same statistics (validated by the same closed-form tests),
  different RNG stream than the host path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.likelihood import discrete_gamma_rates, gtr_generator
from ..topology import Topology

__all__ = ["simulate_ctmc", "simulate_alignment"]


def _sample_markov(
    rng: np.random.Generator, probs: np.ndarray
) -> np.ndarray:
    """Sample one categorical draw per row of ``probs`` ((n, Q) rows sum 1)."""
    cum = np.cumsum(probs, axis=1)
    u = rng.random(probs.shape[0])[:, None]
    return (u > cum).sum(axis=1).astype(np.int64)


# Above this many n_all x n_sites cells the device scan path is
# auto-selected (host walk cost grows with ~2 scipy.expm calls per
# ancestor per category). Small fixtures stay on the host path so their
# bytes never change.
_DEVICE_CELLS = 1 << 22


def _simulate_ctmc_device(
    key: jax.Array,
    topology: Topology,
    blens: np.ndarray,
    gen: np.ndarray,
    freqs: np.ndarray,
    n_sites: int,
    site_rates: np.ndarray,
    rate_probs: np.ndarray,
) -> np.ndarray:
    """(n_all, n_sites) int32 states, all sampling in one jitted program."""
    q = gen.shape[0]
    n_all = topology.n_all
    n_leaves = topology.n_leaves
    n_anc = topology.n_ancestors
    n_cat = site_rates.size

    k_cat, k_root, k_anc = jax.random.split(key, 3)
    site_cat = jax.random.choice(
        k_cat, n_cat, (n_sites,), p=jnp.asarray(rate_probs, jnp.float32)
    )
    root_states = jax.random.choice(
        k_root, q, (n_sites,), p=jnp.asarray(freqs, jnp.float32)
    ).astype(jnp.int32)

    # All (node, category) transition CDFs in one vmapped expm. f64 would
    # match the host path's precision but f32 row-normalized CDFs are
    # statistically equivalent (and expm(0) = I exactly either way, so
    # invariant sites stay exactly invariant).
    ts = (
        jnp.asarray(blens, jnp.float32)[:, None]
        * jnp.asarray(site_rates, jnp.float32)[None, :]
    ).reshape(-1)
    mats = jax.vmap(
        lambda t: jax.scipy.linalg.expm(jnp.asarray(gen, jnp.float32) * t)
    )(ts)
    mats = jnp.clip(mats, 0.0, None)
    mats = mats / mats.sum(axis=-1, keepdims=True)
    cum = jnp.cumsum(mats, axis=-1).reshape(n_all, n_cat, q, q)

    states0 = jnp.zeros((n_all, n_sites), jnp.int32).at[-1].set(root_states)
    tiny = jnp.float32(np.finfo(np.float32).tiny)

    def sample_child(k, child, parent_seq):
        rows = cum[child, site_cat, parent_seq]  # (L, Q)
        u = jax.random.uniform(k, (n_sites, 1), minval=tiny)
        return jnp.minimum((u > rows).sum(axis=-1), q - 1).astype(jnp.int32)

    def fill_children(states, inputs):
        anc_offset, child_pair, anc_key = inputs
        parent_seq = states[n_leaves + anc_offset]
        k1, k2 = jax.random.split(anc_key)
        states = states.at[child_pair[0]].set(
            sample_child(k1, child_pair[0], parent_seq)
        )
        states = states.at[child_pair[1]].set(
            sample_child(k2, child_pair[1], parent_seq)
        )
        return states, None

    offsets = jnp.arange(n_anc, dtype=jnp.int32)
    states, _ = jax.lax.scan(
        fill_children,
        states0,
        (offsets, topology.children, jax.random.split(k_anc, n_anc)),
        reverse=True,
    )
    return states


def simulate_ctmc(
    key: jax.Array,
    topology: Topology,
    branch_lengths: np.ndarray,
    *,
    generator: np.ndarray,
    freqs: np.ndarray,
    n_sites: int,
    site_rates: np.ndarray | None = None,
    rate_probs: np.ndarray | None = None,
    p_invariant: float = 0.0,
    return_ancestors: bool = False,
    device: bool | None = None,
) -> np.ndarray | tuple[np.ndarray, np.ndarray]:
    """Simulate an alignment down ``topology`` under a CTMC.

    Args:
        generator: (Q, Q) rate matrix (rows sum to 0). Use
            ``ops.likelihood.gtr_generator`` for the normalized reversible
            family (one expected substitution per unit branch length).
        freqs: (Q,) root/stationary distribution.
        branch_lengths: (n_all,) length ABOVE each node (root entry ignored),
            the engine's newick convention.
        site_rates / rate_probs: optional discrete rate-mixture categories
            (each site draws one category; lengths scale by its rate).
            Defaults to a single rate-1 category.
        p_invariant: probability a site is invariant (rate 0), mixed in on
            top of the rate categories — the ``tree_log_likelihood_gamma_
            invariant`` convention.
        return_ancestors: also return the (n_ancestors, n_sites) true
            ancestral states (index order: node n_leaves + i at row i).
        device: force the device scan path (True), the host walk (False),
            or auto-select by size (None — device above ``_DEVICE_CELLS``
            total cells). The two paths draw from different RNG streams:
            same model and statistics, different bytes for the same key.

    Returns:
        (n_leaves, n_sites) int32 leaf states, plus the ancestor states when
        ``return_ancestors``.
    """
    import scipy.linalg  # host-side data gen only

    q = int(generator.shape[0])
    freqs = np.asarray(freqs, dtype=np.float64)
    freqs = freqs / freqs.sum()
    gen = np.asarray(generator, dtype=np.float64)
    blens = np.asarray(branch_lengths, dtype=np.float64)
    children = np.asarray(topology.children)

    if site_rates is None:
        site_rates = np.ones((1,), dtype=np.float64)
        rate_probs = np.ones((1,), dtype=np.float64)
    site_rates = np.asarray(site_rates, dtype=np.float64)
    if rate_probs is None:
        rate_probs = np.full(site_rates.shape, 1.0 / site_rates.size)
    rate_probs = np.asarray(rate_probs, dtype=np.float64)
    rate_probs = rate_probs / rate_probs.sum()
    if p_invariant > 0.0:
        site_rates = np.concatenate([site_rates, [0.0]])
        rate_probs = np.concatenate(
            [rate_probs * (1.0 - p_invariant), [p_invariant]]
        )

    if device is None:
        # Auto-select only on accelerators: the CPU backend runs the scan
        # SLOWER than the numpy walk (measured 2.3 s host vs 3.0 s warm
        # scan at 2048 x 512), and CPU-forced tests keep byte-stable
        # host-path fixtures at every size.
        device = (
            topology.n_all * n_sites >= _DEVICE_CELLS
            and jax.default_backend() != "cpu"
        )
    if device:
        states = _simulate_ctmc_device(
            key, topology, blens, gen, freqs, n_sites,
            site_rates, rate_probs,
        )
        # Slice on device BEFORE the host transfer: reading back the full
        # (n_all, L) table would double the transfer for no use.
        leaves = np.asarray(states[: topology.n_leaves], dtype=np.int32)
        if return_ancestors:
            return leaves, np.asarray(
                states[topology.n_leaves :], dtype=np.int32
            )
        return leaves

    seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    site_cat = rng.choice(site_rates.size, size=n_sites, p=rate_probs)

    n_all = topology.n_all
    states = np.zeros((n_all, n_sites), dtype=np.int64)
    states[-1] = rng.choice(q, size=n_sites, p=freqs)
    # Root-first ancestor walk: reverse index order keeps parents before
    # children under the engine's topological node ordering.
    for anc in range(topology.n_ancestors - 1, -1, -1):
        parent = topology.n_leaves + anc
        for child in children[anc]:
            child = int(child)
            for cat in range(site_rates.size):
                sel = site_cat == cat
                if not sel.any():
                    continue
                rate = site_rates[cat]
                if rate == 0.0 or blens[child] == 0.0:
                    states[child, sel] = states[parent, sel]
                    continue
                p = scipy.linalg.expm(gen * (blens[child] * rate))
                p = np.clip(p, 0.0, None)
                p = p / p.sum(axis=1, keepdims=True)
                states[child, sel] = _sample_markov(rng, p[states[parent, sel]])
    leaves = states[: topology.n_leaves].astype(np.int32)
    if return_ancestors:
        return leaves, states[topology.n_leaves :].astype(np.int32)
    return leaves


def simulate_alignment(
    key: jax.Array,
    topology: Topology,
    branch_lengths: np.ndarray,
    *,
    n_sites: int,
    n_states: int = 4,
    rates: np.ndarray | None = None,
    freqs: np.ndarray | None = None,
    gamma_shape: float | None = None,
    n_categories: int = 4,
    p_invariant: float = 0.0,
    return_ancestors: bool = False,
    device: bool | None = None,
) -> np.ndarray | tuple[np.ndarray, np.ndarray]:
    """Model-level wrapper over ``simulate_ctmc``.

    ``rates``/``freqs`` follow ``tree_log_likelihood``'s GTR convention
    ((Q, Q) symmetric exchangeabilities + (Q,) stationary frequencies; both
    None → JC69). ``gamma_shape`` switches on the Yang-1994 discrete-Gamma
    mixture used by ``tree_log_likelihood_gamma`` so fitted parameters are
    directly comparable to the simulation truth.
    """
    q = n_states
    if freqs is None:
        freqs = np.full((q,), 1.0 / q)
    if rates is None:
        rates = np.ones((q, q)) - np.eye(q)
    gen = np.asarray(
        gtr_generator(jnp.asarray(rates, jnp.float32), jnp.asarray(freqs, jnp.float32))
    )
    site_rates = rate_probs = None
    if gamma_shape is not None:
        site_rates = np.asarray(
            discrete_gamma_rates(jnp.float32(gamma_shape), n_categories)
        )
        rate_probs = np.full((n_categories,), 1.0 / n_categories)
    return simulate_ctmc(
        key,
        topology,
        branch_lengths,
        generator=gen,
        freqs=freqs,
        n_sites=n_sites,
        site_rates=site_rates,
        rate_probs=rate_probs,
        p_invariant=p_invariant,
        return_ancestors=return_ancestors,
        device=device,
    )


def simulate_coalescent(
    seed: int,
    n_leaves: int,
    ne: float,
    tip_ages: np.ndarray | None = None,
):
    """Sample a (serial) Kingman coalescent genealogy.

    Goes backward in time: lineages activate at their ``tip_ages``
    (all 0 when None); with k active lineages the next coalescence waits
    Exp(ne / C(k, 2)); pending tips that activate first pre-empt it. The
    generative complement of the coalescent prior in ``search.dating``
    (their agreement is tested), and the data generator for tip-dating /
    phylodynamics validation.

    Returns:
        (Topology (canonical numbering), ages (n_all,) float32 node ages).
    """
    from trex_tpu.io.fallback import _canonicalize
    from trex_tpu.topology import Topology

    rng = np.random.default_rng(seed)
    tips = (
        np.zeros(n_leaves) if tip_ages is None
        else np.asarray(tip_ages, dtype=np.float64)
    )
    order = np.argsort(tips)
    pending = list(order)  # leaves not yet sampled (ascending age)
    active: list[int] = []
    ages = {i: float(tips[i]) for i in range(n_leaves)}
    kids: dict[int, list[int]] = {}
    t = float(tips[order[0]])
    node = n_leaves
    while len(active) + len(pending) > 1 or len(pending) == 1:
        while pending and tips[pending[0]] <= t + 1e-12:
            active.append(int(pending.pop(0)))
        k = len(active)
        if k < 2:
            if not pending:
                break
            t = float(tips[pending[0]])
            continue
        wait = rng.exponential(ne / (k * (k - 1) / 2.0))
        if pending and t + wait > tips[pending[0]]:
            t = float(tips[pending[0]])
            continue
        t += wait
        i, j = rng.choice(k, 2, replace=False)
        a, b = active[i], active[j]
        active = [x for x in active if x not in (a, b)] + [node]
        kids[node] = [min(a, b), max(a, b)]
        ages[node] = t
        node += 1
        if len(active) == 1 and not pending:
            break
    ch, par, relabel = _canonicalize(n_leaves, kids, 2 * n_leaves - 2)
    ages_arr = np.zeros(2 * n_leaves - 1, np.float32)
    for old, new in relabel.items():
        ages_arr[new] = ages.get(old, 0.0)
    import jax.numpy as _jnp

    return (
        Topology(children=_jnp.asarray(ch), parents=_jnp.asarray(par)),
        ages_arr,
    )
