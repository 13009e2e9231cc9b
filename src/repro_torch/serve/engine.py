"""Static-batch serving (counterpart of ``generate`` and the fields of
``ServeConfig`` it reads in ``repro/serve/engine.py``).

Every request of the batch shares one prompt length and one horizon.  The
prompt's prefill runs the long convs on ``ServeConfig.conv_backend``
(``blockfft_overlap`` is the CUDA two-level FFT conv kernel); each decode
step is cached dots.  The weights are cast once by the policy, every float
leaf included, as JAX does.  The continuous-batching ``ServeEngine`` and
paging are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.common.policy import Policy
from repro_torch.configs.base import ModelConfig, check_supported
from repro_torch.models import lm
from repro_torch.models.mixer_api import ApplyContext
from repro_torch.serve.sampling import sample


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int
    temperature: float = 0.0
    top_k: int = 0
    cache_dtype: torch.dtype = torch.bfloat16
    # hyena long-conv backend for the prefill (None = registry default)
    conv_backend: Optional[str] = None
    # None derives Policy(compute_dtype=cache_dtype)
    policy: Optional[Policy] = None

    def __post_init__(self):
        self.apply_context()  # unknown backend names fail here

    def apply_context(self) -> ApplyContext:
        return ApplyContext(conv_backend=self.conv_backend)

    def resolved_policy(self) -> Policy:
        return self.policy or Policy(compute_dtype=self.cache_dtype)


@torch.no_grad()
def generate(
    params,
    cfg: ModelConfig,
    prompts: torch.Tensor,  # (B, L_prompt) integer tokens
    *,
    scfg: ServeConfig,
    max_new_tokens: int,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Greedy / sampled continuation on the device of ``params``.
    Returns (B, max_new_tokens) int64: the token sampled from the prefill's
    last logits, then one per decode step."""
    check_supported(cfg)
    if prompts.device != params["embed"]["table"].device:
        raise ValueError(
            f"prompts on {prompts.device}, params on "
            f"{params['embed']['table'].device}"
        )
    ctx = scfg.apply_context()
    policy = scfg.resolved_policy()
    params = policy.cast_compute(params)
    compute = policy.compute_dtype
    logits, caches = lm.prefill(
        params, cfg, prompts, scfg.max_len, dtype=scfg.cache_dtype,
        compute_dtype=compute, ctx=ctx,
    )
    draw = lambda lg: sample(
        lg, temperature=scfg.temperature, top_k=scfg.top_k, generator=generator
    )
    if max_new_tokens <= 0:
        return prompts.new_zeros((prompts.shape[0], 0), dtype=torch.int64)
    token = draw(logits[:, -1])
    out = [token]
    for _ in range(max_new_tokens - 1):
        lg, caches = lm.decode_step(params, cfg, token, caches, compute_dtype=compute)
        token = draw(lg)
        out.append(token)
    return torch.stack(out, dim=1)
