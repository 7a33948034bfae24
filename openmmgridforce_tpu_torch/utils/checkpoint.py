"""Checkpoint/resume for MD and sampler state.

A tree of tensors (nested NamedTuples, tuples, lists and dicts; MDState,
batched replica states) round-trips through one .npz file, a leaf per
entry. A ``torch.Generator`` leaf is saved as its ``get_state()`` and
restored in place into the generator of the tree it is loaded into, so
a sampler's states and the sampler keep sharing one generator.
"""

from __future__ import annotations

import json

import numpy as np
import torch


def _flatten(tree, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], out)
    elif isinstance(tree, (tuple, list)):
        for item in tree:
            _flatten(item, out)
    elif tree is not None:
        out.append(tree)
    return out


def _unflatten(like, leaves):
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(item, leaves) for item in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(item, leaves) for item in like)
    if like is None:
        return None
    return next(leaves)


def _to_numpy(leaf):
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path, tree) -> None:
    """Save a tree of tensors (and generators) to ``path`` (.npz)."""
    leaves = _flatten(tree, [])
    np.savez(path, **{f"leaf_{i}": _to_numpy(leaf)
                      for i, leaf in enumerate(leaves)})


def load_pytree(path, like):
    """Load what save_pytree wrote into the structure of ``like``, each
    tensor with the dtype and device of ``like``'s leaf; a generator leaf
    of ``like`` gets the saved state and is returned itself."""
    with np.load(path) as z:
        loaded = []
        for i, ref in enumerate(_flatten(like, [])):
            arr = z[f"leaf_{i}"]
            if isinstance(ref, torch.Generator):
                ref.set_state(torch.from_numpy(arr.copy()))
                loaded.append(ref)
            elif isinstance(ref, torch.Tensor):
                loaded.append(torch.as_tensor(arr, dtype=ref.dtype,
                                              device=ref.device))
            else:
                loaded.append(type(ref)(arr) if np.ndim(arr) == 0 else arr)
    return _unflatten(like, iter(loaded))


def save_sampler(path, sampler) -> None:
    """Checkpoint a sampling.Sampler: every rung's state with the
    generator's state (``{path}.states.npz``), the host rng's state and
    the MC counters (``{path}.meta.json``). Under a mesh every rank calls
    it (the states are gathered) and rank 0 writes."""
    states = sampler.global_states()
    if sampler.mesh is not None and sampler.mesh.rank != 0:
        return
    save_pytree(f"{path}.states.npz", states)
    meta = {
        "rng_state": sampler._rng.bit_generator.state,
        "n_exchange_accepted": sampler.n_exchange_accepted,
        "n_exchange_attempted": sampler.n_exchange_attempted,
        "n_gmc_accepted": sampler.n_gmc_accepted,
        "n_gmc_attempted": sampler.n_gmc_attempted,
    }
    with open(f"{path}.meta.json", "w") as fh:
        json.dump(meta, fh)


def load_sampler(path, sampler) -> None:
    """Restore a checkpoint into an already-constructed Sampler (under a
    mesh, on every rank: each keeps its rows)."""
    states = load_pytree(f"{path}.states.npz", sampler.global_states())
    rows = sampler._rows
    sampler.states = type(states)(states.positions[rows],
                                  states.velocities[rows], states.generator)
    with open(f"{path}.meta.json") as fh:
        meta = json.load(fh)
    sampler._rng.bit_generator.state = meta["rng_state"]
    sampler.n_exchange_accepted = meta["n_exchange_accepted"]
    sampler.n_exchange_attempted = meta["n_exchange_attempted"]
    sampler.n_gmc_accepted = meta["n_gmc_accepted"]
    sampler.n_gmc_attempted = meta["n_gmc_attempted"]
