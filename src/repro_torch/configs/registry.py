"""Arch registry data, the same entries as ``repro/configs/registry.py``:
the assigned architectures (exact public-literature configs) and the
paper's own Hyena LMs (Table A.4).  Only archs whose mixers are ported can
be built (``configs.base.check_supported``); the data of the rest is kept so
that the registries stay equal field by field.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, register

# --------------------------------------------------------------- dense LMs

QWEN25_14B = register(ModelConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=13824,
    vocab_size=152064, qkv_bias=True, mlp="swiglu", rope_theta=1000000.0,
    source="hf:Qwen/Qwen2.5-14B",
))

QWEN2_72B = register(ModelConfig(
    name="qwen2-72b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
    vocab_size=152064, qkv_bias=True, mlp="swiglu", rope_theta=1000000.0,
    source="arXiv:2407.10671",
))

NEMOTRON4_15B = register(ModelConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=24576,
    vocab_size=256000, mlp="squared_relu", rope_theta=10000.0,
    source="arXiv:2402.16819",
))

PHI4_MINI = register(ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, d_ff=8192,
    vocab_size=200064, mlp="swiglu", rope_theta=10000.0,
    source="arXiv:2412.08905",
))

# ---------------------------------------------------------------------- VLM

INTERNVL2_2B = register(ModelConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=8192,
    vocab_size=92553, mlp="swiglu", rope_theta=10000.0,
    frontend="vit_stub", frontend_len=256,  # InternViT patch embeds (stub)
    source="arXiv:2404.16821",
))

# ---------------------------------------------------------------------- MoE

DBRX_132B = register(ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=10752,
    vocab_size=100352, mlp="swiglu", rope_theta=500000.0,
    moe=True, n_experts=16, top_k=4,
    source="hf:databricks/dbrx-base",
))

GRANITE_MOE = register(ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512,
    vocab_size=49155, mlp="swiglu", rope_theta=10000.0,
    moe=True, n_experts=40, top_k=8,
    source="hf:ibm-granite/granite-3.0-3b-a800m-base",
))

# ---------------------------------------------------------------------- SSM

MAMBA2_130M = register(ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=50280, pattern=("ssd",), ssm_state=128, ssd_head_dim=64,
    ssd_expand=2, norm="rmsnorm", tie_embeddings=True,
    source="arXiv:2405.21060",
))

# ------------------------------------------------------------------- hybrid

RECURRENTGEMMA_2B = register(ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    head_dim=256, vocab_size=256000, mlp="geglu", rope_theta=10000.0,
    pattern=("rglru", "rglru", "local_attention"), local_window=2048,
    rnn_width=2560,
    source="arXiv:2402.19427",
))

# -------------------------------------------------------------------- audio

MUSICGEN_LARGE = register(ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=2048, mlp="gelu", norm="layernorm", rope_theta=10000.0,
    frontend="encodec_stub", frontend_len=500,  # 10 s EnCodec prompt frames
    source="arXiv:2306.05284",
))

# ----------------------------------------------- the paper's own Hyena LMs
# Table A.4: depth/width/FFN width/filter FFN width+depth/sine freq.

def _hyena_lm(name, depth, width, ffn, order=2, vocab=50257):
    return register(ModelConfig(
        name=name, family="dense",
        n_layers=depth, d_model=width, n_heads=0, n_kv_heads=0, d_ff=ffn,
        vocab_size=vocab, pattern=("hyena",), hyena_order=order,
        hyena_filter_width=64, hyena_filter_depth=4, hyena_pos_dim=65,
        hyena_sine_freq=14.0, mlp="gelu",
        source="arXiv:2302.10866 Table A.4",
    ))


# StripedHyena-2-style multi-hybrid: short-explicit / medium-regularized /
# long-implicit hyena stripes plus one attention layer per repeat — the
# "convolutional multi-hybrid" layer allocation (no single operator wins
# every range at equal compute).
HYENA_MH_SMALL = register(ModelConfig(
    name="hyena-mh-small", family="hybrid",
    n_layers=8, d_model=512, n_heads=8, n_kv_heads=8, d_ff=1024,
    vocab_size=50257,
    pattern=("hyena_se", "hyena_mr", "hyena_li", "attention"),
    hyena_order=2, hyena_se_len=8, hyena_mr_support=128,
    hyena_filter_width=64, hyena_filter_depth=4, hyena_pos_dim=65,
    hyena_sine_freq=14.0, mlp="gelu",
    source="arXiv:2503.01868",
))

HYENA_125M = _hyena_lm("hyena-125m", 12, 768, 3072, order=3)
HYENA_125M_SLIM = _hyena_lm("hyena-125m-slim", 18, 768, 1536, order=3)
HYENA_153M = _hyena_lm("hyena-153m", 18, 864, 1728, order=2)
HYENA_355M = _hyena_lm("hyena-355m", 36, 1024, 2048, order=2)
HYENA_1_3B = _hyena_lm("hyena-1.3b", 36, 2048, 4096, order=2)

ASSIGNED = [
    "qwen2.5-14b", "qwen2-72b", "nemotron-4-15b", "phi4-mini-3.8b",
    "internvl2-2b", "dbrx-132b", "granite-moe-3b-a800m", "mamba2-130m",
    "recurrentgemma-2b", "musicgen-large",
]
