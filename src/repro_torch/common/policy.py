"""Mixed-precision policy: fp32 master params, bf16 compute, fp32
reductions (counterpart of ``repro/common/policy.py``).

``cast_compute`` casts **every** floating leaf of a tree to the compute
dtype, as the JAX policy does: in bf16 serving that includes the filter
FFN, ``decay_log_rate``, ``window_bias``, ``skip`` and the norm gains, so
``1.0 + g`` rounds in bf16 before the fp32 multiply in ``apply_norm``.
The port matches JAX only because it casts the same leaves.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.common.tree import tree_map


@dataclasses.dataclass(frozen=True)
class Policy:
    """fp32 master params are cast to ``compute_dtype`` for compute."""

    compute_dtype: torch.dtype = torch.bfloat16

    def cast_compute(self, tree):
        def cast(x):
            if isinstance(x, torch.Tensor) and x.is_floating_point():
                return x.to(self.compute_dtype)
            return x

        return tree_map(cast, tree)


BF16 = Policy()
