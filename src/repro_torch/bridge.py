"""Weight bridge between the JAX package's value tree and the port's.

The JAX side is the ``split_params`` value tree of ``repro.models.lm``
with its leaves as numpy arrays (convert with ``np.asarray``; this module
imports no JAX):

- ``groups`` is a list over pattern positions, each block tree carrying a
  leading ``n_groups`` axis (``jax.vmap`` of ``init_block``);
- ``tail`` (when ``n_layers`` is not a multiple of the pattern) is a list
  of unstacked block trees;
- ``mixer.filters.ffn`` is a list of ``{w, b}``;
- ``head.w`` is (D, V).

The port keeps the same leaves under the same names, with the layers as a
flat list ``blocks`` in execution order (``lm.layer_mixers``).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.tree import tree_map
from repro_torch.configs.base import ModelConfig, check_supported


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([t[i] for t in trees]) for i in range(len(first)))
    return np.stack(trees)


def _take(tree, g: int):
    return tree_map(lambda a: a[g], tree)


def from_jax_values(values: Dict[str, Any], cfg: ModelConfig, device="cuda") -> Dict[str, Any]:
    """JAX value tree (numpy leaves) -> the port's param tree on ``device``."""
    check_supported(cfg)
    dev = resolve_device(device)
    to = lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev)
    plen = len(cfg.pattern)
    n_groups = cfg.n_layers // plen
    blocks = [
        tree_map(to, _take(values["groups"][p], g))
        for g in range(n_groups) for p in range(plen)
    ]
    blocks += [tree_map(to, t) for t in values.get("tail", [])]
    out = {
        "embed": tree_map(to, values["embed"]),
        "final_norm": tree_map(to, values["final_norm"]),
        "blocks": blocks,
    }
    out["head"] = tree_map(to, values["head"])
    return out


def to_jax_values(params: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """The port's param tree -> the JAX value tree with numpy leaves."""
    to = lambda t: t.detach().cpu().numpy()
    plen = len(cfg.pattern)
    n_groups = cfg.n_layers // plen
    blocks = params["blocks"]
    out: Dict[str, Any] = {
        "embed": tree_map(to, params["embed"]),
        "final_norm": tree_map(to, params["final_norm"]),
        "groups": [
            _stack([tree_map(to, blocks[g * plen + p]) for g in range(n_groups)])
            for p in range(plen)
        ],
    }
    tail = blocks[n_groups * plen:]
    if tail:
        out["tail"] = [tree_map(to, b) for b in tail]
    out["head"] = tree_map(to, params["head"])
    return out
