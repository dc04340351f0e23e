"""Carry weights between the JAX package's flax variables and the port.

The flax variables are nested dicts of numpy arrays (``jax.tree_util.
tree_map(np.asarray, variables["params"])`` gives one), and the port's
modules carry the flax names, so a path maps to a state_dict key:

- params: a Dense ``kernel`` [in, out] is the port's ``weight`` [out, in];
  a ``bias`` and a BatchNorm ``scale`` carry as they are
  (``params["conv0"]["lin_l"]["kernel"]`` is ``conv0.lin_l.weight``);
- batch_stats: a BatchNorm's running ``mean`` and ``var`` are the port's
  buffers of the same names (``batch_stats["conv0"]["bn"]["mean"]`` is
  ``conv0.bn.mean``).

Load both into a model with ``model.load_state_dict({**params_from_jax(p),
**batch_stats_from_jax(s)})``. Nothing of JAX is imported here.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_STATS = ("mean", "var")


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _nest(pairs) -> Dict:
    out: Dict = {}
    for path, a in pairs:
        *mod, leaf = path
        node = out
        for m in mod:
            node = node.setdefault(m, {})
        node[leaf] = a
    return out


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def params_from_jax(params_np: Mapping) -> Dict[str, torch.Tensor]:
    """Nested numpy flax params -> state_dict entries of the port's model."""
    out = {}
    for path, v in _flatten(params_np):
        a = np.asarray(v, np.float32)
        *mod, leaf = path
        if leaf == "kernel":
            out[".".join(mod + ["weight"])] = torch.from_numpy(
                np.ascontiguousarray(a.T))
        elif leaf in ("bias", "scale"):
            out[".".join(path)] = torch.from_numpy(a.copy())
        else:
            raise KeyError(f"no port counterpart for flax param "
                           f"{'/'.join(path)}")
    return out


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The port's state_dict -> nested numpy flax params (the running
    statistics go to ``batch_stats_to_jax``)."""
    pairs = []
    for key, t in state_dict.items():
        *mod, leaf = key.split(".")
        if leaf in _STATS:
            continue
        if leaf == "weight":
            pairs.append((mod + ["kernel"], np.ascontiguousarray(_f32(t).T)))
        elif leaf in ("bias", "scale"):
            pairs.append((mod + [leaf], _f32(t).copy()))
        else:
            raise KeyError(f"no flax counterpart for {key}")
    return _nest(pairs)


def batch_stats_from_jax(stats_np: Mapping) -> Dict[str, torch.Tensor]:
    """Nested numpy flax batch_stats -> the port's BatchNorm buffers."""
    out = {}
    for path, v in _flatten(stats_np):
        if path[-1] not in _STATS:
            raise KeyError(f"no port counterpart for flax batch stat "
                           f"{'/'.join(path)}")
        out[".".join(path)] = torch.from_numpy(np.asarray(v, np.float32)
                                               .copy())
    return out


def batch_stats_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The port's BatchNorm buffers -> nested numpy flax batch_stats."""
    return _nest((key.split("."), _f32(t).copy())
                 for key, t in state_dict.items()
                 if key.split(".")[-1] in _STATS)
