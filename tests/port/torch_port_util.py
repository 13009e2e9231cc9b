"""Shared helpers of the ``test_torch_*`` parity tests: the same weights and
inputs, made from numpy seeds, go through the JAX package and the PyTorch
port, which exchange arrays as numpy.

They live in ``tests/port/`` rather than beside the JAX suite so that pytest
collects them first: xdist hands tests out in batches sized by how many are
still pending, and tests collected after the JAX suite's randomized serve
harnesses would enlarge the batches those heavy harnesses go out in.  Each
process keeps every XLA program it compiled mapped, and a worker that gets
several of them in one batch can reach the kernel's per-process map limit
(``vm.max_map_count``) and crash."""
import functools
import gc

import jax
import numpy as np
import pytest
import torch

from repro.common.param import split_params
from repro.configs import get_config as jax_get_config
from repro.models import lm as jax_lm
from repro_torch.bridge import from_jax_values
from repro_torch.configs import get_config as torch_get_config

# six xdist workers share the host: keep each one's torch pool small
TORCH_THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def free_jax_programs():
    """Drop the XLA programs a parity module compiled once it is done, so the
    worker goes on to the JAX suite with no more memory maps than it had."""
    yield
    jax.clear_caches()
    gc.collect()


@functools.lru_cache(maxsize=None)
def jax_and_torch_model(arch: str, seed: int = 0):
    """(jax cfg, jax values, torch cfg, torch params on CPU) of the reduced
    ``arch``, the torch weights bridged from the JAX ones.  Made once per
    process, with the JAX init jitted (~3 s; op by op it takes ~7 s); tests
    only read them."""
    jcfg = jax_get_config(arch).reduced()
    tcfg = torch_get_config(arch).reduced()
    init = jax.jit(jax_lm.init_lm, static_argnums=1)
    values, _ = split_params(init(jax.random.PRNGKey(seed), jcfg))
    np_values = jax.tree_util.tree_map(np.asarray, values)
    return jcfg, values, tcfg, from_jax_values(np_values, tcfg, device="cpu")


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 explicit mantissa bits), to nearest with ties
    away from zero: what the kernels' cvt.rna.tf32.f32 does."""
    if x.is_complex():
        return torch.complex(tf32(x.real), tf32(x.imag))
    b = x.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def t(a) -> torch.Tensor:
    """numpy / jax array -> CPU torch tensor (a copy)."""
    return torch.from_numpy(np.array(a, copy=True))
