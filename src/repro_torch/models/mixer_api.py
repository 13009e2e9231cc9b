"""Pluggable TokenMixer API (counterpart of ``repro/models/mixer_api.py``).

A :class:`TokenMixer` bundles what the block/LM/serve layers need from a
mixer — ``make_config``, ``init``, ``init_cache``, ``prefill``,
``decode_step`` and the cache-slot contract of continuous batching
(``cache_slot_axes`` and the slot slice / insert / reset / mask ops) — and
an :class:`ApplyContext` carries the per-call execution options.  The
port's registry holds the mixers ported so far: ``hyena``, ``attention``
and ``local_attention``.

The slot ops differ from JAX's pure functions in one way: insert and reset
write into the pooled cache in place (PyTorch has no buffer donation, and a
copy of the pool per admission would double its traffic), and return it.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, Optional, Tuple

import torch

# modules that register their mixers on import, loaded lazily
_BUILTIN_MODULES = ("repro_torch.models.hyena", "repro_torch.models.attention")


@dataclasses.dataclass(frozen=True)
class ApplyContext:
    """Per-call execution context: the decode position offset and the
    long-conv backend (validated at construction, ``None`` = registry
    default)."""

    pos_offset: int = 0
    conv_backend: Optional[str] = None

    def __post_init__(self):
        if self.conv_backend is not None:
            from repro_torch.core.conv_api import get_conv_backend

            get_conv_backend(self.conv_backend)  # raises with registered list

    def conv_backend_for(self, L: int) -> Optional[str]:
        """Long-conv backend for a length-``L`` pass (no length routing)."""
        return self.conv_backend


DEFAULT_CONTEXT = ApplyContext()


class TokenMixer:
    """Interface of a registered token mixer."""

    name: str = ""
    # whether prefill runs the long conv of ``ApplyContext.conv_backend``
    # (the LM checks that backend's length limit before any work)
    uses_conv_backend: bool = False

    def make_config(self, cfg) -> Any:
        """ModelConfig -> mixer config (opaque to callers)."""
        raise NotImplementedError

    def init(self, mc, gen, device) -> Dict[str, Any]:
        raise NotImplementedError

    def init_cache(self, mc, batch: int, max_len: int, dtype, device):
        """Empty decode cache, directly consumable by ``decode_step``."""
        raise NotImplementedError

    def prefill(self, params, mc, h, max_len: int, dtype,
                ctx: ApplyContext) -> Tuple[Any, Any]:
        """Full-sequence forward that also returns a populated cache."""
        raise NotImplementedError

    def decode_step(self, params, mc, h_t, cache, active=None) -> Tuple[Any, Any]:
        """One token: (B, D) -> (B, D), updated cache.

        ``active`` is None or a (B,) bool tensor.  Where it is False, a cache
        leaf that the step writes *in place* must keep its bytes (write the
        row's own values back); the leaves it replaces are restored by
        :func:`slot_mask_leaf` (``lm.mask_slots``)."""
        raise NotImplementedError

    # ------------------------------------------------------ cache-slot contract
    def cache_slot_axes(self, mc) -> Dict[str, int]:
        """Slot (batch) axis per cache key.  Missing keys default to axis
        0; ``-1`` marks a leaf shared across slots (never sliced/reset)."""
        return {}

    def cache_slice(self, mc, cache, slot: int):
        """One slot of a pooled cache as a batch-1 cache (views)."""
        axes = self.cache_slot_axes(mc)
        return {k: slot_slice_leaf(v, slot, axes.get(k, 0)) for k, v in cache.items()}

    def cache_insert(self, mc, cache, slot: int, one):
        """Copy a batch-1 cache (a fresh prefill's) into ``slot`` of the
        pooled cache, in place.  Shared leaves take the incoming value — it
        is identical for every request (same params, same max_len grid)."""
        axes = self.cache_slot_axes(mc)
        return {
            k: slot_insert_leaf(v, one[k], slot, axes.get(k, 0))
            for k, v in cache.items()
        }

    def cache_reset(self, mc, cache, slot: int):
        """Zero one slot in place, so an evicted request's state cannot
        leak into the slot's next occupant."""
        axes = self.cache_slot_axes(mc)
        return {k: slot_zero_leaf(v, slot, axes.get(k, 0)) for k, v in cache.items()}

    def cache_mask(self, mc, new, old, active):
        """Keep ``new`` on active slots and ``old`` elsewhere."""
        axes = self.cache_slot_axes(mc)
        return {
            k: slot_mask_leaf(v, old[k], active, axes.get(k, 0))
            for k, v in new.items()
        }


# ------------------------------------------------------ slot-contract leaf ops
#
# The single implementation of per-leaf slot slice / insert / zero / mask.
# ``axis < 0`` marks a leaf shared across slots: never sliced, inserted over
# wholesale, never reset or masked.

def slot_slice_leaf(leaf, slot: int, axis: int):
    if axis < 0:
        return leaf
    return leaf.narrow(axis, slot, 1)


def slot_insert_leaf(leaf, new, slot: int, axis: int):
    if axis < 0:
        return new.to(leaf.dtype)
    leaf.narrow(axis, slot, 1).copy_(new)
    return leaf


def slot_zero_leaf(leaf, slot: int, axis: int):
    if axis >= 0:
        leaf.narrow(axis, slot, 1).zero_()
    return leaf


def slot_mask_leaf(new, old, active, axis: int):
    """``new`` where ``active`` (bool (S,)) along the slot axis, ``old``
    elsewhere.  A leaf the step wrote in place is the same tensor in both
    trees and passes through: its writer kept the inactive rows."""
    if axis < 0 or new is old:
        return new
    shape = [1] * new.dim()
    shape[axis] = active.shape[0]
    return torch.where(active.reshape(shape), new, old)


_REGISTRY: Dict[str, TokenMixer] = {}
_builtins_loaded = False


def register_mixer(cls):
    """Class decorator: instantiate and register under ``cls.name``;
    a different class under a taken name raises."""
    inst = cls()
    if not inst.name:
        raise ValueError(f"{cls.__name__} must set a non-empty 'name'")
    prev = _REGISTRY.get(inst.name)
    if prev is not None and (
        type(prev).__module__ != cls.__module__
        or type(prev).__qualname__ != cls.__qualname__
    ):
        raise ValueError(
            f"mixer '{inst.name}' already registered by "
            f"{type(prev).__module__}.{type(prev).__qualname__}"
        )
    _REGISTRY[inst.name] = inst
    return cls


def _ensure_builtins() -> None:
    global _builtins_loaded
    if not _builtins_loaded:
        _builtins_loaded = True
        for mod in _BUILTIN_MODULES:
            importlib.import_module(mod)


def get_mixer(name: str) -> TokenMixer:
    _ensure_builtins()
    if name not in _REGISTRY:
        raise KeyError(
            f"mixer '{name}' is not ported; registered mixers: "
            f"{sorted(_REGISTRY)}"
        )
    return _REGISTRY[name]

