"""Model configuration and the architecture registry (counterpart of
``repro/configs/base.py``).

``ModelConfig`` carries the same fields with the same defaults as the JAX
one, and ``reduced()`` shrinks it the same way, so one registry name means
one model in both packages (pinned field by field by the tests).

The registry holds the data of every arch.  Whether an arch can be *built*
is a separate question, answered by :func:`check_supported` against the
port's own mixer registry (``repro_torch.models.mixer_api``), which holds
only the mixers ported so far, and the layers ported so far.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[str, ...] = ("attention",)
    head_dim: int = 0  # 0 -> d_model // n_heads
    mlp: str = "swiglu"  # swiglu | gelu | squared_relu
    norm: str = "rmsnorm"
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    local_window: int = 0
    tie_embeddings: bool = False
    # --- MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- SSM (Mamba-2 SSD)
    ssm_state: int = 0
    ssd_head_dim: int = 64
    ssd_expand: int = 2
    # --- RG-LRU
    rnn_width: int = 0
    # --- Hyena
    hyena_order: int = 2
    hyena_filter_width: int = 64
    hyena_filter_depth: int = 4
    hyena_pos_dim: int = 65
    hyena_sine_freq: float = 14.0
    hyena_decay: tuple = (0.3, 1.5)  # (fast, slow) window decay-rate range
    hyena_max_support: int = 0  # >0: explicit short-FIR ablation
    # --- Hyena multi-hybrid variants
    hyena_se_len: int = 8
    hyena_mr_support: int = 128
    # --- modality frontend stub
    frontend: Optional[str] = None  # "vit_stub" | "encodec_stub"
    frontend_len: int = 0
    # --- citation bookkeeping
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    def reduced(self) -> "ModelConfig":
        """Small same-family config for CPU smoke tests (same rule as the
        JAX ``ModelConfig.reduced``)."""
        plen = len(self.pattern)
        n_layers = plen + (1 if self.n_layers % plen else 0) if plen > 1 else 2
        n_kv = min(self.n_kv_heads, 2) if self.n_kv_heads else 0
        return dataclasses.replace(
            self,
            name=f"{self.name}-smoke",
            n_layers=max(n_layers, plen),
            d_model=64,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=n_kv if n_kv else (2 if self.n_heads else 0),
            head_dim=16 if self.n_heads else 0,
            d_ff=0 if self.d_ff == 0 else 128,
            vocab_size=128,
            n_experts=4 if self.moe else 0,
            top_k=min(self.top_k, 2) if self.moe else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssd_head_dim=16 if self.ssm_state else 64,
            rnn_width=64 if self.rnn_width else 0,
            local_window=min(self.local_window, 32) if self.local_window else 0,
            hyena_filter_width=16,
            hyena_pos_dim=9,
            hyena_se_len=4,
            hyena_mr_support=16,
            frontend_len=8 if self.frontend else 0,
        )


_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    """Record an arch after the data checks of the JAX registry's
    multi-hybrid rules (an SE-MR stripe needs ordered, usable supports)."""
    if "hyena_se" in cfg.pattern and cfg.hyena_se_len < 2:
        raise ValueError(
            f"pattern {cfg.pattern} uses hyena_se but hyena_se_len="
            f"{cfg.hyena_se_len} < 2"
        )
    if "hyena_mr" in cfg.pattern and cfg.hyena_mr_support < 2:
        raise ValueError(
            f"pattern {cfg.pattern} uses hyena_mr but hyena_mr_support="
            f"{cfg.hyena_mr_support} < 2"
        )
    if (
        "hyena_se" in cfg.pattern
        and "hyena_mr" in cfg.pattern
        and cfg.hyena_mr_support <= cfg.hyena_se_len
    ):
        raise ValueError(
            f"multi-hybrid pattern {cfg.pattern} needs hyena_mr_support "
            f"({cfg.hyena_mr_support}) > hyena_se_len ({cfg.hyena_se_len})"
        )
    _REGISTRY[cfg.name] = cfg
    return cfg


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless the port can build ``cfg``: every mixer of the pattern
    registered in the port's mixer registry (``hyena``, ``attention``,
    ``local_attention``), an RMSNorm, a dense MLP of a known kind (or
    none), an untied head and no frontend.  Called wherever a model is
    built."""
    from repro_torch.models.layers import MLP_KINDS
    from repro_torch.models.mixer_api import get_mixer

    for m in cfg.pattern:
        get_mixer(m)
    unported = {
        "moe": cfg.moe,
        f"norm={cfg.norm}": cfg.norm != "rmsnorm",
        f"mlp={cfg.mlp}": cfg.d_ff > 0 and cfg.mlp not in MLP_KINDS,
        "tie_embeddings": cfg.tie_embeddings,
        f"frontend={cfg.frontend}": cfg.frontend is not None,
    }
    missing = [k for k, v in unported.items() if v]
    if missing:
        raise NotImplementedError(f"{cfg.name}: not ported yet: {missing}")


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> Dict[str, ModelConfig]:
    return dict(_REGISTRY)
