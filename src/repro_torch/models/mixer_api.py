"""Pluggable TokenMixer API (counterpart of ``repro/models/mixer_api.py``).

A :class:`TokenMixer` bundles what the block/LM/serve layers need from a
mixer — ``make_config``, ``init``, ``init_cache``, ``prefill`` and
``decode_step`` — and an :class:`ApplyContext` carries the per-call
execution options.  The port's registry holds the mixers ported so far:
``hyena``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, Optional, Tuple

# modules that register their mixers on import, loaded lazily
_BUILTIN_MODULES = ("repro_torch.models.hyena",)


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

    def decode_step(self, params, mc, h_t, cache) -> Tuple[Any, Any]:
        """One token: (B, D) -> (B, D), updated cache."""
        raise NotImplementedError


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

