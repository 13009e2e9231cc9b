"""GQA/MHA attention mixer: RoPE, optional QKV bias, sliding window, the
causal attention of a prompt on the flash kernel, and the KV-cache decode
step (counterpart of ``repro/models/attention.py``).

The full-sequence passes (:func:`apply_attention`, the prefill) run
``kernels.ops.flash_attention``: the hand-written CUDA kernel on CUDA
tensors, its plain version on CPU tensors.  They hand it the (B, L, H, Dh)
projections transposed, without a copy, and it returns its output in the
layout the output projection reads.  JAX's ``chunked_attention`` chunk
sizes have no counterpart: the kernel picks its own tiles.  A decode step
is plain torch, as in JAX: one query row per request against the whole
cache, with a per-row cursor.  The context-parallel paths
(``cp_ring_attention``, ``cp_allgather_attention``) are not ported.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense, init_dense
from repro_torch.models.mixer_api import ApplyContext, TokenMixer, register_mixer

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    window: Optional[int] = None  # sliding-window (local) attention


def init_attention(cfg: AttentionConfig, gen: torch.Generator, device) -> Dict[str, Any]:
    """Same shapes and scales as the JAX ``init_attention``."""
    D, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "q": init_dense(D, H * Dh, gen, device, bias=cfg.qkv_bias),
        "k": init_dense(D, Hkv * Dh, gen, device, bias=cfg.qkv_bias),
        "v": init_dense(D, Hkv * Dh, gen, device, bias=cfg.qkv_bias),
        "o": init_dense(H * Dh, D, gen, device),
    }


def _attend(params, cfg: AttentionConfig, x: torch.Tensor, pos_offset: int):
    """Projections, RoPE at ``pos_offset + arange(L)`` and causal attention
    of the whole sequence; returns (y (B, L, D), k, v), k and v being the
    (B, L, Hkv, Dh) keys (after RoPE) and values that a cache keeps."""
    B, L, _ = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = dense(params["q"], x).view(B, L, H, Dh)
    k = dense(params["k"], x).view(B, L, Hkv, Dh)
    v = dense(params["v"], x).view(B, L, Hkv, Dh)
    pos = torch.arange(L, device=x.device) + pos_offset
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    o = ops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=True, window=cfg.window, q_offset=pos_offset,
    )  # (B, H, L, Dh)
    y = dense(params["o"], o.transpose(1, 2).reshape(B, L, H * Dh))
    return y, k, v


def apply_attention(params, cfg: AttentionConfig, x: torch.Tensor, *,
                    pos_offset: int = 0) -> torch.Tensor:
    """Full-sequence forward. x: (B, L, D).  Query i sits at position
    ``pos_offset + i`` and sees keys ``j <= pos_offset + i`` (JAX's
    ``chunked_attention(q_offset=pos_offset)``)."""
    return _attend(params, cfg, x, pos_offset)[0]


def attention_prefill(
    params, cfg: AttentionConfig, x: torch.Tensor, max_len: int,
    dtype=torch.bfloat16, *, pos_offset: int = 0,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Full-sequence forward that also fills the decode cache: token j at
    index j of a global cache, at index ``j % size`` of a window's ring
    buffer (which keeps the last ``size`` tokens)."""
    B, L, _ = x.shape
    y, k, v = _attend(params, cfg, x, pos_offset)
    cache = init_kv_cache(cfg, B, max_len, dtype, x.device)
    size = cache["k"].shape[1]
    if cfg.window is None:
        cache["k"][:, :L] = k
        cache["v"][:, :L] = v
    else:
        n = min(L, size)
        slots = torch.arange(L - n, L, device=x.device) % size
        cache["k"][:, slots] = k[:, L - n:].to(dtype)
        cache["v"][:, slots] = v[:, L - n:].to(dtype)
    cache["t"].fill_(L)
    return y, cache


def init_kv_cache(cfg: AttentionConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device="cpu") -> Dict[str, Any]:
    """K and V of (batch, size, Hkv, Dh), size = max_len, or the window for
    local attention; ``t`` is the per-row write cursor (continuous batching:
    every row is a request at its own position)."""
    size = max_len if cfg.window is None else min(cfg.window, max_len)
    shape = (batch, size, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "t": torch.zeros(batch, dtype=torch.int32, device=device),
    }


def attention_decode_step(
    params, cfg: AttentionConfig, x_t: torch.Tensor, cache: Dict[str, Any],
    active: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One token. x_t: (B, D).  Row b writes its key and value at slot
    ``t[b] % size`` and attends to the slots it has written (within the
    window for a ring buffer), in fp32.

    K and V are written **in place**; the returned cache holds the same
    tensors.  With ``active`` ((B,) bool), the rows where it is False write
    their slot's own bytes back; the caller restores ``t``
    (``lm.mask_slots``)."""
    B, _ = x_t.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    t = cache["t"]
    ck, cv = cache["k"], cache["v"]
    size = ck.shape[1]
    q = dense(params["q"], x_t).view(B, 1, H, Dh)
    k = dense(params["k"], x_t).view(B, 1, Hkv, Dh)
    v = dense(params["v"], x_t).view(B, 1, Hkv, Dh)
    pos = t[:, None]  # (B, 1): one position per row
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    rows = torch.arange(B, device=x_t.device)
    slot = (t % size).long()
    k_new, v_new = k[:, 0].to(ck.dtype), v[:, 0].to(cv.dtype)
    if active is not None:
        keep = active[:, None, None]
        k_new = torch.where(keep, k_new, ck[rows, slot])
        v_new = torch.where(keep, v_new, cv[rows, slot])
    ck[rows, slot] = k_new
    cv[rows, slot] = v_new
    idx = torch.arange(size, device=x_t.device)[None, :]
    valid = idx <= t[:, None]  # (B, size)
    if cfg.window is not None:
        ages = (t[:, None] - idx) % size  # 0 = newest
        valid = valid & (ages < cfg.window)
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, Dh).float() / math.sqrt(Dh)
    s = torch.einsum("bhgd,bshd->bhgs", qg, ck.float())
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, cv.float())
    y = dense(params["o"], o.reshape(B, H * Dh).to(x_t.dtype))
    return y, {"k": ck, "v": cv, "t": t + 1}


# ----------------------------------------------------------- registrations

@register_mixer
class AttentionMixer(TokenMixer):
    """Global causal GQA/MHA — the baseline the paper swaps out."""

    name = "attention"

    def make_config(self, cfg) -> AttentionConfig:
        return AttentionConfig(
            d_model=cfg.d_model,
            n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim,
            qkv_bias=cfg.qkv_bias,
            rope_theta=cfg.rope_theta,
            window=None,
        )

    def init(self, mc, gen, device):
        return init_attention(mc, gen, device)

    def init_cache(self, mc, batch, max_len, dtype, device):
        return init_kv_cache(mc, batch, max_len, dtype, device)

    def prefill(self, params, mc, h, max_len, dtype, ctx: ApplyContext):
        return attention_prefill(params, mc, h, max_len, dtype, pos_offset=ctx.pos_offset)

    def decode_step(self, params, mc, h_t, cache, active=None):
        return attention_decode_step(params, mc, h_t, cache, active)


@register_mixer
class LocalAttentionMixer(AttentionMixer):
    """Sliding-window attention: O(L·window), ring-buffer decode cache."""

    name = "local_attention"

    def make_config(self, cfg) -> AttentionConfig:
        return dataclasses.replace(super().make_config(cfg), window=cfg.local_window)
