"""The port's RMSNorm (``repro_torch.kernels.ops.rmsnorm``) against the JAX
package, on CPU tensors, where the wrapper runs the kernel's plain
version.

The JAX side is the Pallas kernel body in interpret mode, as
``tests/test_kernels.py`` runs it (a small ``block_rows`` that the number of
rows is not a multiple of), and the oracle ``ref.rmsnorm``.  Every input
holds a row of zeros, which must give zeros.

Tolerances, with their reasons:

- fp32: rtol = atol = 1e-5.  The mean of squares is a reduction that the
  two packages sum in another order.
- bf16: one bf16 ulp.  The fp32 results agree to ~1e-6 relative, so the
  downcast lands on the same bf16 value except where a result straddles a
  rounding boundary.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the JAX package is the reference
import jax.numpy as jnp  # noqa: E402
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
from repro_torch.kernels import ops
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain

from torch_port_util import free_jax_programs  # noqa: F401

jax_ref_jit = jax.jit(jax_ref.rmsnorm, static_argnames=("eps",))

FP32_TOL = dict(rtol=1e-5, atol=1e-5)
_DT = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}

# (shape, x dtype, g dtype, JAX block_rows, eps): rows not a multiple of
# block_rows; one JAX program each
CASES = [
    ((7, 16), "fp32", "bf16", 4, 1e-6),  # 2-D
    ((2, 3, 24), "bf16", "bf16", 4, 1e-6),  # 3-D
    ((1, 3, 2, 40), "bf16", "fp32", 4, 1e-5),  # 4-D
]


def _inputs(shape, x_dtype, g_dtype, seed):
    """numpy fp32 arrays (x, g), each rounded to its dtype so that both
    packages read the same values; the first row of x is zeros."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x.reshape(-1, shape[-1])[0] = 0.0
    g = (0.5 * rng.standard_normal(shape[-1])).astype(np.float32)
    rnd = lambda a, dt: np.asarray(jnp.asarray(a, _DT[dt][0]).astype(jnp.float32))
    return rnd(x, x_dtype), rnd(g, g_dtype)


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits), floored at the smallest normal."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("shape,x_dtype,g_dtype,block_rows,eps", CASES)
def test_plain_matches_pallas_and_ref(shape, x_dtype, g_dtype, block_rows, eps):
    x, g = _inputs(shape, x_dtype, g_dtype, seed=sum(shape))
    jx, jg = jnp.asarray(x, _DT[x_dtype][0]), jnp.asarray(g, _DT[g_dtype][0])
    got = ops.rmsnorm(torch.tensor(x).to(_DT[x_dtype][1]), torch.tensor(g).to(_DT[g_dtype][1]),
                      eps=eps)
    assert got.dtype == _DT[x_dtype][1] and tuple(got.shape) == shape
    got = got.float().numpy()
    assert not got.reshape(-1, shape[-1])[0].any()  # the zero row
    for want in (jax_rmsnorm(jx, jg, eps=eps, block_rows=block_rows, interpret=True),
                 jax_ref_jit(jx, jg, eps=eps)):
        assert want.dtype == jx.dtype
        want = np.asarray(want.astype(jnp.float32))
        if x_dtype == "fp32":
            np.testing.assert_allclose(got, want, **FP32_TOL)
        else:
            assert (np.abs(got - want) <= _bf16_ulp(want)).all()


def test_wrapper_dispatch_and_refusals():
    """On CPU tensors the public wrapper is the plain version, with 1 + g
    formed in fp32 (a bf16 g is not rounded again after the add, as the
    model's norm would); the kernel itself refuses CPU tensors, and both
    refuse a g of another width."""
    x, g = (torch.tensor(a) for a in _inputs((3, 4, 16), "fp32", "fp32", seed=2))
    assert torch.equal(ops.rmsnorm(x, g), rmsnorm_plain(x, g))
    gb = g.bfloat16()
    scaled = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6)
    assert torch.equal(ops.rmsnorm(x, gb), scaled * (1 + gb.float()))
    assert not torch.equal(ops.rmsnorm(x, gb), scaled * (1 + gb).float())
    with pytest.raises(ValueError, match="CUDA tensors"):
        rmsnorm(x, g)
    with pytest.raises(ValueError, match="g has shape"):
        ops.rmsnorm(x, g[:-1])
