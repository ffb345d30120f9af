"""Weight bridge: load the reference package's flax variables into the
port's modules.

``params`` and ``batch_stats`` are the flax trees as nested dicts of
**numpy** arrays (``jax.tree_util.tree_map(np.asarray, ...)`` on the
caller's side), so this module needs no JAX.  Module names in the port
follow the flax parameter paths, so the map is by name:

- ``.../kernel`` [in, out] (flax ``Dense``) -> ``....weight`` [out, in]
  of ``nn.Linear``: stored TRANSPOSED;
- ``.../bias`` -> ``....bias``;
- ``.../embedding`` (``nn.Embed``) -> ``....weight`` of ``nn.Embedding``;
- ``.../scale`` (``MaskedBatchNorm``) -> ``....weight``;
- ``batch_stats .../mean`` and ``.../var`` -> ``....running_mean`` and
  ``....running_var``;
- any other leaf (``dense_0_bias``, ``dense_1_bias``) keeps its name.

A flax leaf with no counterpart in the model, a model entry with no flax
leaf, and a shape mismatch all raise.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

_PARAM_LEAVES = {"kernel": "weight", "bias": "bias", "embedding": "weight",
                 "scale": "weight"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            yield from _leaves(val, path)
        else:
            yield path, np.asarray(val)


def flax_to_state_dict(params: Mapping,
                       batch_stats: Optional[Mapping] = None
                       ) -> Dict[str, np.ndarray]:
    """The port's ``state_dict`` names for a flax variable tree."""
    out: Dict[str, np.ndarray] = {}
    for path, arr in _leaves(params):
        leaf = path[-1]
        if leaf in _PARAM_LEAVES:
            name = ".".join(path[:-1] + (_PARAM_LEAVES[leaf],))
            if leaf == "kernel":
                arr = arr.T
        else:
            name = ".".join(path)
        out[name] = arr
    for path, arr in _leaves(batch_stats or {}):
        if path[-1] not in _STAT_LEAVES:
            raise KeyError(f"unknown batch_stats leaf {'/'.join(path)}")
        out[".".join(path[:-1] + (_STAT_LEAVES[path[-1]],))] = arr
    return out


def load_flax_variables(model: torch.nn.Module, params: Mapping,
                        batch_stats: Optional[Mapping] = None) -> None:
    """Copy the flax ``params``/``batch_stats`` into ``model`` in place."""
    mapped = flax_to_state_dict(params, batch_stats)
    state = model.state_dict()
    unmapped = sorted(set(mapped) - set(state))
    missing = sorted(set(state) - set(mapped))
    if unmapped or missing:
        raise KeyError(f"weight bridge: flax leaves with no module entry "
                       f"{unmapped}; module entries with no flax leaf "
                       f"{missing}")
    new_state = {}
    for name, arr in mapped.items():
        ref = state[name]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"weight bridge: {name} has shape "
                             f"{tuple(arr.shape)}, the module "
                             f"{tuple(ref.shape)}")
        new_state[name] = torch.tensor(arr, dtype=ref.dtype)
    model.load_state_dict(new_state)
