"""The order-N Hyena operator's decode path (counterpart of
``repro/core/operator.py``; paper Def. 3.1, Algorithms 1–3).

Per token, the projection ``D → (N+1)·D``, the width-3 short conv over a
rolling window, the split into ``v, x¹..xᴺ``, and N steps of
``v ← xⁿ ⊙ (hⁿ ∗ v + skipⁿ·v)`` evaluated against the cached operand
history, then the output projection.  The full-sequence pass with the long
convs is the mixer's prefill (``repro_torch.models.hyena``).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.common.tree import tree_leaves
from repro_torch.core import filters as F


@dataclasses.dataclass(frozen=True)
class HyenaConfig:
    d_model: int
    order: int = 2
    short_filter_len: int = 3
    filter: F.FilterConfig = None  # type: ignore[assignment]
    use_bias: bool = True

    def __post_init__(self):
        if self.filter is None:
            object.__setattr__(
                self, "filter", F.FilterConfig(d_model=self.d_model, order=self.order)
            )


def init_hyena(cfg: HyenaConfig, gen: torch.Generator, device) -> Dict[str, Any]:
    """Same shapes and scales as the JAX ``init_hyena``."""
    D, N = cfg.d_model, cfg.order
    inner = (N + 1) * D
    K = cfg.short_filter_len
    randn = lambda *shape: torch.randn(*shape, generator=gen, device=device)
    params: Dict[str, Any] = {
        "in_proj": {"w": randn(D, inner) / D ** 0.5},
        "out_proj": {"w": randn(D, D) / D ** 0.5},
        # short explicit depthwise filter over all (N+1)·D projected channels
        "short_filter": randn(inner, K) / K ** 0.5,
        "filters": F.init_hyena_filter(cfg.filter, gen, device),
    }
    if cfg.use_bias:
        params["in_proj"]["b"] = torch.zeros(inner, device=device)
        params["out_proj"]["b"] = torch.zeros(D, device=device)
    return params


def linear(p, x: torch.Tensor) -> torch.Tensor:
    """``x @ w (+ b)`` with the weights cast to x's dtype, as JAX does."""
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def init_decode_cache(cfg: HyenaConfig, batch: int, max_len: int,
                      dtype, device):
    """Caches for single-token decode.

    - ``short``: the last ``short_filter_len - 1`` projected inputs,
      newest first.
    - ``long``: the recurrence operand of every order at its **absolute
      position** (the value fed at step ``p`` lives at index ``p``);
      positions ``>= t`` are masked out of the decode contraction.
    - ``t``: per-row position counter.
    """
    D, N = cfg.d_model, cfg.order
    inner = (N + 1) * D
    return {
        "short": torch.zeros(batch, cfg.short_filter_len - 1, inner, dtype=dtype, device=device),
        "long": torch.zeros(N, batch, max_len, D, dtype=dtype, device=device),
        "t": torch.zeros(batch, dtype=torch.int32, device=device),
    }


# Memo for decode steps whose cache holds no taps (a cache from
# ``lm.init_caches`` rather than from a prefill): the taps of given
# (filter tensors, filter config, cache length) are evaluated on the first
# such step and reused, instead of re-running the filter FFN over the whole
# cache grid on every token.  Keyed by the tensors' ids; each entry holds a
# weakref per tensor whose callback evicts it when the tensor is freed, and
# a hit must find every tensor still alive, the same object (an id can be
# reused) and at the same version (an in-place update re-evaluates).
_FALLBACK_TAPS: Dict[tuple, tuple] = {}


def _fallback_decode_taps(params, cfg: HyenaConfig, Lc: int):
    leaves = tree_leaves(params["filters"])
    evaluate = lambda: (
        F.evaluate_filters(params["filters"], cfg.filter, Lc),
        F.filter_skip(params["filters"], cfg.filter),
    )
    if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
        return evaluate()  # taps that carry a graph would keep their params alive
    key = (cfg.filter, Lc, tuple(id(t) for t in leaves))
    hit = _FALLBACK_TAPS.get(key)
    if hit is not None and all(
        r() is t and t._version == v for (r, v), t in zip(hit[0], leaves)
    ):
        return hit[1]
    taps = evaluate()
    evict = lambda _, k=key: _FALLBACK_TAPS.pop(k, None)
    _FALLBACK_TAPS[key] = (tuple((weakref.ref(t, evict), t._version) for t in leaves), taps)
    return taps


def hyena_decode_step(
    params, cfg: HyenaConfig, u_t: torch.Tensor, cache: Dict[str, Any],
    active: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One token: u_t (B, D) -> y_t (B, D), updated cache.

    With per-row cursor ``t``,
    ``yⁿ_t = (hⁿ_0 + skipⁿ)·vⁿ_t + Σ_{p<t} hⁿ_{t-p}·vⁿ_p``: the history
    term of all orders contracts in one fp32 einsum over the cache, with
    the taps past each row's cursor masked to zero.

    The operand history ``cache["long"]`` is written **in place** at
    position ``t`` (one row per order and batch row); the returned cache
    holds the same tensor.  With ``active`` ((B,) bool), the rows where it
    is False write their own history values back, so their bytes do not
    change; the caller restores the other leaves (``lm.mask_slots``).
    Taps come from ``cache["h"]``/``cache["skip"]``
    (stored by prefill or :func:`precompute_decode_filters`); without them
    they are evaluated on the cache's grid once per filter tensors and
    memoized (:func:`_fallback_decode_taps`).
    """
    B, Dm = u_t.shape
    N = cfg.order
    long = cache["long"]
    Lc = long.shape[2]
    h = cache.get("h")
    skip = cache.get("skip")
    if h is None:
        h, skip = _fallback_decode_taps(params, cfg, Lc)
    # --- projection + short conv over the rolling window
    z = linear(params["in_proj"], u_t)
    w = params["short_filter"]  # (inner, K)
    hist = cache["short"]  # (B, K-1, inner) newest first
    zc = z.float() * w[:, 0].float()[None, :]
    for k in range(1, cfg.short_filter_len):
        zc = zc + hist[:, k - 1].float() * w[:, k].float()[None, :]
    new_short = torch.cat([z[:, None, :], hist[:, : cfg.short_filter_len - 2]], dim=1)
    zc = zc.to(u_t.dtype)
    parts = torch.split(zc, Dm, dim=-1)
    v, xs = parts[0], parts[1:]
    # --- recurrence: one history contraction for all orders
    t = cache["t"].long()  # (B,)
    lag = t[:, None] - torch.arange(Lc, device=u_t.device)[None, :]  # (B, Lc)
    taps = h.float()[:, :, lag.clamp(min=0)]  # (N, D, B, Lc): h[t - p]
    taps = taps * (lag > 0).to(taps.dtype)[None, None]  # only p < t
    hist_y = torch.einsum("nbpd,ndbp->nbd", long.float(), taps)
    h0 = (h[:, :, 0] + skip).float()  # (N, D) fused rank-1 taps
    vs = []
    for n in range(N):
        vs.append(v.to(long.dtype))
        conv_y = hist_y[n] + v.float() * h0[n][None, :]
        v = xs[n] * conv_y.to(u_t.dtype)
    y = linear(params["out_proj"], v)
    rows = torch.arange(B, device=u_t.device)
    new_rows = torch.stack(vs)  # (N, B, D)
    if active is not None:
        new_rows = torch.where(active[None, :, None], new_rows, long[:, rows, t])
    long[:, rows, t] = new_rows
    out_cache = dict(cache)
    out_cache.update({"short": new_short, "long": long, "t": cache["t"] + 1})
    return y, out_cache


def precompute_decode_filters(params, cfg: HyenaConfig, max_len: int, cache):
    """Evaluate filter taps once per sequence and stash them in the cache."""
    cache = dict(cache)
    cache["h"] = F.evaluate_filters(params["filters"], cfg.filter, max_len)
    cache["skip"] = F.filter_skip(params["filters"], cfg.filter)
    return cache
