"""Hyena as an LM token mixer (counterpart of ``repro/models/hyena.py``).

Prefill runs the long convs of the prompt on the ``conv_backend``
registration (``blockfft_overlap`` and ``toeplitz`` are CUDA kernels);
decode steps are cached dots and have no backend dimension.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as Fn

from repro_torch.core import filters as F
from repro_torch.core.conv_api import get_conv_backend
from repro_torch.core.fftconv import short_causal_conv
from repro_torch.core.operator import (
    HyenaConfig,
    hyena_decode_step,
    init_decode_cache,
    init_hyena,
    linear,
)
from repro_torch.models.mixer_api import ApplyContext, TokenMixer, register_mixer


def hyena_prefill(
    params, cfg: HyenaConfig, x: torch.Tensor, max_len: int,
    dtype=torch.bfloat16, *, conv_backend: Optional[str] = None,
) -> Tuple[torch.Tensor, dict]:
    """Full-sequence forward capturing the decode caches: the short-conv
    input history (newest first) and, per order, the conv *operand* at
    absolute positions (token ``p`` at index ``p``).

    The filters are evaluated on the **max_len** grid and sliced to the
    prompt, so their l1 normalisation runs over max_len — the taps then
    match the decode-time dot exactly.  ``v`` is the first of the N+1
    chunks and the gate of order n is ``xs[n]``."""
    backend = get_conv_backend(conv_backend)
    B, L, D = x.shape
    backend.validate_len(L)
    N = cfg.order
    z_pre = linear(params["in_proj"], x)
    z = short_causal_conv(z_pre, params["short_filter"])
    parts = torch.split(z, D, dim=-1)
    v, xs = parts[0], parts[1:]
    h_dec = F.evaluate_filters(params["filters"], cfg.filter, max_len)
    skip = F.filter_skip(params["filters"], cfg.filter)

    def hist(seq):  # (B, L, D) -> absolute positions, zero past L
        n = min(L, max_len)
        recent = seq[:, L - n:].to(dtype)
        return Fn.pad(recent, (0, 0, 0, max_len - n))

    Ks = cfg.short_filter_len - 1
    n_short = min(L, Ks)
    short_hist = Fn.pad(
        torch.flip(z_pre[:, L - n_short:], dims=(1,)).to(dtype),
        (0, 0, 0, Ks - n_short),
    )
    longs = []
    for n in range(N):
        longs.append(hist(v))
        v = backend(v, h_dec[n][:, :L], skip[n], gate=xs[n]).to(x.dtype)
    y = linear(params["out_proj"], v)
    cache = {
        "short": short_hist,
        "long": torch.stack(longs),
        "t": torch.full((B,), L, dtype=torch.int32, device=x.device),
        "h": h_dec,
        "skip": skip,
    }
    return y, cache


@register_mixer
class HyenaMixer(TokenMixer):
    """The paper's operator as a drop-in token mixer (Def. 3.1)."""

    name = "hyena"
    uses_conv_backend = True

    def make_config(self, cfg) -> HyenaConfig:
        return HyenaConfig(
            d_model=cfg.d_model,
            order=cfg.hyena_order,
            filter=F.FilterConfig(
                d_model=cfg.d_model,
                order=cfg.hyena_order,
                ffn_width=cfg.hyena_filter_width,
                ffn_depth=cfg.hyena_filter_depth,
                pos_dim=cfg.hyena_pos_dim,
                sine_freq=cfg.hyena_sine_freq,
                decay_fast=cfg.hyena_decay[0],
                decay_slow=cfg.hyena_decay[1],
                max_support=cfg.hyena_max_support,
            ),
        )

    def init(self, mc, gen, device):
        return init_hyena(mc, gen, device)

    def init_cache(self, mc, batch, max_len, dtype, device):
        return init_decode_cache(mc, batch, max_len, dtype, device)

    def prefill(self, params, mc, h, max_len, dtype, ctx: ApplyContext):
        if ctx.pos_offset:
            raise NotImplementedError(
                "hyena prefill does not support pos_offset != 0"
            )
        return hyena_prefill(
            params, mc, h, max_len, dtype,
            conv_backend=ctx.conv_backend_for(h.shape[1]),
        )

    def decode_step(self, params, mc, h_t, cache, active=None):
        return hyena_decode_step(params, mc, h_t, cache, active)

    def cache_slot_axes(self, mc) -> dict:
        # "long" stacks the per-order operand histories ahead of the batch
        # dim; the decode filter taps "h"/"skip" depend only on params and
        # the max_len grid, so the pool shares one copy across slots.  The
        # port keeps one cache per layer (no scan stacking), so these axes
        # are the leaves' own.
        return {"long": 1, "h": -1, "skip": -1}
