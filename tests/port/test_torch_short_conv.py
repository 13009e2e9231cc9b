"""The port's short conv (``repro_torch.kernels.ops.short_conv_gate``)
against the JAX package, on CPU tensors, where the wrapper runs the
kernel's plain version.

The JAX side is the Pallas kernel body in interpret mode, as
``tests/test_kernels.py`` runs it (small ``block_l`` / ``block_d``, L and D
not multiples of them), and the oracle ``ref.short_conv_gate`` on every
case.

Tolerances, with their reasons:

- fp32: rtol = atol = 1e-6.  Both add the same fp32 products in the same
  order (k = 0 .. K − 1); XLA may contract a product and its add into one
  FMA, which moves the last bit.
- bf16: one bf16 ulp.  The fp32 sums agree to the last bits above, so the
  downcast lands on the same bf16 value except where a sum straddles a
  rounding boundary.  The gate multiplies in fp32 before the downcast, so
  it adds no rounding of its own.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the JAX package is the reference
import jax.numpy as jnp  # noqa: E402
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.short_conv import short_conv_gate as jax_short_conv
from repro_torch.kernels import ops
from repro_torch.kernels import short_conv as sc
from repro_torch.kernels.short_conv import short_conv_gate, short_conv_gate_plain

from torch_port_util import free_jax_programs  # noqa: F401

jax_ref_jit = jax.jit(jax_ref.short_conv_gate)

FP32_TOL = dict(rtol=1e-6, atol=1e-6)

# (B, L, D, K, dtype, gated, JAX block_l, JAX block_d): K − 1 <= block_l,
# L and D ragged against the blocks; one JAX program each
PALLAS_CASES = [
    (2, 64, 16, 3, "fp32", True, 16, 8),
    (2, 64, 16, 3, "bf16", False, 16, 8),
    (1, 50, 33, 4, "bf16", True, 16, 16),  # D = 33 padded to 48
    (2, 40, 8, 2, "fp32", False, 8, 8),
]
# (B, L, D, K, dtype, gated): the cases the Pallas body gets wrong
REF_CASES = [
    (1, 64, 8, 1, "fp32", True),  # K = 1
    (2, 30, 5, 1, "bf16", False),
    (2, 3, 8, 8, "fp32", False),  # L < K − 1
    (1, 2, 6, 4, "bf16", True),
    (1, 1, 4, 3, "fp32", True),  # L = 1
    (1, 5, 6, 9, "fp32", True),  # K = 9 (the kernel's general instance), L < K − 1
]


def _inputs(B, L, D, K, dtype, seed):
    """numpy fp32 arrays (u, w, gate); u and gate rounded to ``dtype`` so
    that both packages read the same values."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((B, L, D)).astype(np.float32)
    w = rng.standard_normal((D, K)).astype(np.float32)
    gate = rng.standard_normal((B, L, D)).astype(np.float32)
    if dtype == "bf16":
        u, gate = (np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)) for x in (u, gate))
    return u, w, gate


def _jax(fn, u, w, gate, dtype, **kw):
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    out = fn(jnp.asarray(u, jdt), jnp.asarray(w), None if gate is None else jnp.asarray(gate, jdt),
             **kw)
    assert out.dtype == jdt
    return np.asarray(out.astype(jnp.float32))


def _port(u, w, gate, dtype):
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    out = ops.short_conv_gate(torch.tensor(u).to(tdt), torch.tensor(w),
                              None if gate is None else torch.tensor(gate).to(tdt))
    assert out.dtype == tdt
    return out.float().numpy()


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits), floored at the smallest normal."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _assert_close(got, want, dtype):
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, **FP32_TOL)
    else:
        assert (np.abs(got - want) <= _bf16_ulp(want)).all()


@pytest.mark.parametrize("B,L,D,K,dtype,gated,bl,bd", PALLAS_CASES)
def test_plain_matches_pallas_and_ref(B, L, D, K, dtype, gated, bl, bd):
    u, w, gate = _inputs(B, L, D, K, dtype, seed=L * 31 + D + K)
    gate = gate if gated else None
    got = _port(u, w, gate, dtype)
    _assert_close(got, _jax(jax_short_conv, u, w, gate, dtype, block_l=bl, block_d=bd,
                            interpret=True), dtype)
    _assert_close(got, _jax(jax_ref_jit, u, w, gate, dtype), dtype)


@pytest.mark.parametrize("B,L,D,K,dtype,gated", REF_CASES)
def test_plain_matches_ref_where_pallas_is_wrong(B, L, D, K, dtype, gated):
    """K = 1 and L < K − 1, against the oracle only.  The Pallas body
    computes another function there: at K = 1 its halo slice ``-(K-1):``
    is the whole previous block, so tap 0 reads that block instead of u;
    with K − 1 > block_l the halo comes from one previous block only."""
    u, w, gate = _inputs(B, L, D, K, dtype, seed=L * 31 + D + K)
    gate = gate if gated else None
    _assert_close(_port(u, w, gate, dtype), _jax(jax_ref_jit, u, w, gate, dtype), dtype)


def test_gate_multiplies_before_the_downcast():
    """The bf16 gated output is the fp32 result rounded once: the oracle's
    order, not ``_fused_epilogue``'s downcast-then-gate, which rounds twice
    and lies within the one-ulp tolerance above."""
    u, w, gate = (torch.tensor(a) for a in _inputs(2, 64, 16, 3, "bf16", seed=4))
    got = ops.short_conv_gate(u.bfloat16(), w, gate.bfloat16())
    assert torch.equal(got, ops.short_conv_gate(u, w, gate).bfloat16())
    twice = ops.short_conv_gate(u.bfloat16(), w) * gate.bfloat16()
    assert not torch.equal(got, twice)


def test_wrapper_dispatch_and_refusals():
    """On CPU tensors the public wrapper is the plain version, w read as
    fp32 whatever its dtype; the kernel itself refuses CPU tensors, and both
    refuse malformed arguments."""
    u, w, gate = (torch.tensor(a) for a in _inputs(2, 20, 6, 3, "fp32", seed=3))
    assert torch.equal(ops.short_conv_gate(u, w, gate), short_conv_gate_plain(u, w, gate))
    wb = w.bfloat16()
    assert torch.equal(ops.short_conv_gate(u, wb), short_conv_gate_plain(u, wb.float()))
    with pytest.raises(ValueError, match="CUDA tensors"):
        short_conv_gate(u, w, gate)
    with pytest.raises(ValueError, match="w has shape"):
        ops.short_conv_gate(u, w[:-1])
    with pytest.raises(ValueError, match="gate has shape"):
        ops.short_conv_gate(u, w, gate[:, :-1])
    with pytest.raises(ValueError, match=r"\(B, L, D\)"):
        ops.short_conv_gate(u[0], w)


def _zeros(shape, dtype):
    return torch.zeros(shape, dtype=dtype)


_BF16, _F32 = torch.bfloat16, torch.float32
_PROJ = _zeros((2, 4, 2592), _BF16)  # hyena-153m's projection, (N+1)·D channels
_BUF = _zeros(4096, _BF16)


# (case, u, gate, K, instance): the kernel's instance for CPU tensors'
# pointers and strides (the CPU allocator starts a tensor on 64 bytes)
PLAN_CASES = [
    ("projection", _PROJ, _PROJ, 3, "vector"),
    ("split views of the projection", _PROJ[..., :864], _PROJ[..., 864:1728], 3, "vector"),
    ("views at channels 1728 and 0", _PROJ[..., 1728:], _PROJ[..., :864], 3, "vector"),
    ("ungated fp32, D = 2592 + 4", _zeros((2, 3, 2596), _F32), None, 3, "vector"),
    ("K = 8", _PROJ, None, 8, "vector"),
    ("B = 1, its stride never stepped", _BUF.as_strided((1, 4, 64), (1001, 64, 1)), None, 3,
     "vector"),
    ("L = 1, its stride never stepped", _BUF.as_strided((2, 1, 64), (64, 7, 1)), None, 3,
     "vector"),
    ("u one element off 16 bytes", _PROJ[..., 1:865], None, 3, "scalar"),
    ("gate one element off 16 bytes", _PROJ[..., :864], _PROJ[..., 865:1729], 3, "scalar"),
    ("row stride not a multiple of V", _zeros((2, 3, 868), _BF16)[..., :864], None, 3, "scalar"),
    ("batch stride not a multiple of V", _BUF.as_strided((2, 4, 64), (260, 64, 1)), None, 3,
     "scalar"),
    ("ragged D = 33", _zeros((2, 3, 33), _F32), None, 3, "scalar"),
    ("D = 2592 + 4 in bf16", _zeros((2, 3, 2596), _BF16), None, 3, "scalar"),
    ("K = 9", _PROJ, _PROJ, 9, "general"),
    ("K = 64 off 16 bytes", _PROJ[..., 1:865], None, 64, "general"),
]


@pytest.mark.parametrize("case,u,gate,K,instance", PLAN_CASES, ids=[c[0] for c in PLAN_CASES])
def test_short_conv_plan(case, u, gate, K, instance):
    assert sc.short_conv_plan(u, torch.zeros(u.shape[2], K), gate) == instance


# (B, L, n_vec, gated, (R, n_runs, threads))
GEOMETRY_CASES = [
    (4, 1024, 324, False, (16, 64, 82944)),  # hyena-153m's projection in bf16
    (4, 1024, 324, True, (8, 128, 165888)),
    (1, 1024, 108, False, (4, 256, 27648)),  # runs halved to fill the card
    (1, 1024, 108, True, (4, 256, 27648)),
    (3, 1, 324, True, (1, 1, 972)),  # L = 1
    (2, 1001, 324, False, (16, 63, 40824)),  # L not a multiple of R
    (2, 3, 324, True, (3, 1, 648)),  # L shorter than the shortest run
    (2, 10, 8, False, (4, 3, 48)),  # a small call: runs no shorter than AHEAD
]


@pytest.mark.parametrize("B,L,n_vec,gated,want", GEOMETRY_CASES)
def test_short_conv_vector_geometry(B, L, n_vec, gated, want):
    assert sc.vector_geometry(B, L, n_vec, gated=gated) == want


def test_short_conv_constants_and_refusals():
    """A run is no shorter than the ring of rows in flight, unless L is;
    the kernel wrapper refuses CPU tensors before it plans anything."""
    assert (sc.vector_width(_BF16), sc.vector_width(_F32)) == (8, 4)
    assert sc.AHEAD <= sc.RUN_ROWS_GATED <= sc.RUN_ROWS
    for L in (1, 3, 4, 100):
        for gated in (False, True):
            assert sc.vector_geometry(1, L, 1, gated=gated)[0] == min(sc.AHEAD, L)
    with pytest.raises(ValueError, match="CUDA tensors"):
        short_conv_gate(_PROJ, torch.zeros(2592, 0))
