"""The port's block-Toeplitz conv (``toeplitz`` backend) against the JAX
package, on CPU tensors, where ``repro_torch.kernels.ops.toeplitz_conv``
runs the kernel's plain version.

The shapes are those of the JAX kernel's own tests
(``tests/test_kernels.py``, ``tests/test_conv_backends_prop.py``): full and
banded support, L below the chunk and L not a multiple of it, and D that
the JAX kernel pads to its channel block.  The JAX side is the Pallas
kernel body in interpret mode and the dense oracle ``ref.toeplitz_conv``.

Tolerances, with their reasons:

- fp32: rtol = atol = 1e-5.  Both sum the same fp32 products in another
  order (measured ≤ 1e-6 on outputs of magnitude ~10).
- bf16: one bf16 ulp of the conv output.  The fp32 sums agree to ~1e-7
  relative, so the downcast lands on the same bf16 value except where a sum
  straddles a rounding boundary.  A gated output carries that ulp through
  the gate: |gate|·ulp(y) plus the product's own rounding, ulp(gate·y).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the JAX package is the reference
import jax.numpy as jnp  # noqa: E402
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.toeplitz_conv import toeplitz_conv as jax_toeplitz
from repro_torch.core.conv_api import get_conv_backend
from repro_torch.kernels import ops
from repro_torch.kernels import toeplitz_conv as TT
from repro_torch.kernels.toeplitz_conv import toeplitz_conv, toeplitz_conv_plain

from torch_port_util import TORCH_THREADS, free_jax_programs, tf32  # noqa: F401

jax_ref_jit = jax.jit(jax_ref.toeplitz_conv, static_argnames=("n_chunk_diags", "chunk"))

# (B, L, D, chunk, n_chunk_diags, JAX block_d)
CASES = [
    (2, 64, 8, 16, None, 8),
    (1, 128, 16, 32, None, 8),
    (2, 96, 8, 32, None, 8),
    (1, 128, 4, 16, 3, 4),  # banded
    (2, 100, 33, 32, None, 32),  # L not a multiple of C; D padded to 64
    (1, 96, 8, 32, None, 8),
    (2, 65, 5, 16, None, 4),  # L = 4C + 1; D padded to 8
    (1, 37, 8, 128, None, 8),  # L < C: one chunk of 37
    (2, 100, 33, 32, 2, 32),  # banded, ragged L and D
]
BF16_CASES = [CASES[0], CASES[3], CASES[4], CASES[7]]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(prev)


def _inputs(B, L, D, dtype, seed):
    """numpy fp32 arrays; u and gate rounded to ``dtype`` so that both
    packages read the same values."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((B, L, D)).astype(np.float32)
    h = (rng.standard_normal((D, L)) / L).astype(np.float32)
    skip = rng.standard_normal((D,)).astype(np.float32)
    gate = rng.standard_normal((B, L, D)).astype(np.float32)
    if dtype == "bf16":
        u, gate = (np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)) for x in (u, gate))
    return u, h, skip, gate


def _jax(fn, arrays, dtype, **kw):
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    u, h, skip, gate = arrays
    out = fn(jnp.asarray(u, jdt), jnp.asarray(h), None if skip is None else jnp.asarray(skip),
             None if gate is None else jnp.asarray(gate, jdt), **kw)
    return np.asarray(out.astype(jnp.float32))


def _port(arrays, dtype, **kw):
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    u, h, skip, gate = (None if a is None else torch.tensor(a) for a in arrays)
    out = ops.toeplitz_conv(u.to(tdt), h, skip, None if gate is None else gate.to(tdt), **kw)
    assert out.dtype == tdt
    return out.float().numpy()


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits), floored at the smallest normal."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("B,L,D,C,K,bd", CASES)
def test_plain_matches_jax_fp32(B, L, D, C, K, bd):
    u, h, skip, gate = _inputs(B, L, D, "fp32", seed=L * 31 + D)
    got = _port((u, h, skip, gate), "fp32", chunk=C, n_chunk_diags=K)
    want = _jax(jax_toeplitz, (u, h, skip, gate), "fp32", chunk=C, block_d=bd,
                n_chunk_diags=K, interpret=True)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # ungated and skipless against the dense oracle
    got = _port((u, h, None, None), "fp32", chunk=C, n_chunk_diags=K)
    want = _jax(jax_ref_jit, (u, h, None, None), "fp32", chunk=C, n_chunk_diags=K)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,L,D,C,K,bd", BF16_CASES)
def test_plain_matches_jax_bf16(B, L, D, C, K, bd):
    u, h, skip, gate = _inputs(B, L, D, "bf16", seed=L * 31 + D)
    y_want = _jax(jax_toeplitz, (u, h, skip, None), "bf16", chunk=C, block_d=bd,
                  n_chunk_diags=K, interpret=True)
    y_got = _port((u, h, skip, None), "bf16", chunk=C, n_chunk_diags=K)
    assert (np.abs(y_got - y_want) <= _bf16_ulp(y_want)).all()
    got = _port((u, h, skip, gate), "bf16", chunk=C, n_chunk_diags=K)
    want = _jax(jax_ref_jit, (u, h, skip, gate), "bf16", chunk=C, n_chunk_diags=K)
    bound = np.abs(gate) * _bf16_ulp(y_want) + _bf16_ulp(want)
    assert (np.abs(got - want) <= bound).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gated_equals_gate_times_ungated_bit_for_bit(dtype):
    """DESIGN.md §7: the gate multiplies the downcast conv output, so the
    fused call equals the two-pass schedule exactly."""
    u, h, skip, gate = (torch.from_numpy(a) for a in _inputs(2, 100, 33, "fp32", seed=5))
    u, gate = u.to(dtype), gate.to(dtype)
    for K in (None, 2):
        fused = toeplitz_conv_plain(u, h, skip, gate, chunk=32, n_chunk_diags=K)
        assert torch.equal(fused, gate * toeplitz_conv_plain(u, h, skip, chunk=32, n_chunk_diags=K))


def test_toeplitz_backend_equals_direct_fp32():
    u, h, skip, gate = (torch.from_numpy(a) for a in _inputs(2, 200, 16, "fp32", seed=7))
    got = get_conv_backend("toeplitz")(u, h, skip, gate=gate)
    want = get_conv_backend("direct")(u, h, skip, gate=gate)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_wrapper_dispatch_and_refusals():
    """On CPU tensors the public wrapper is the plain version; the kernel
    itself refuses them, and both refuse malformed arguments."""
    u, h, skip, gate = (torch.from_numpy(a) for a in _inputs(1, 40, 4, "fp32", seed=9))
    assert torch.equal(ops.toeplitz_conv(u, h, skip, gate, chunk=16),
                       toeplitz_conv_plain(u, h, skip, gate, chunk=16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        toeplitz_conv(u, h, skip, gate)
    with pytest.raises(ValueError, match="chunk must be"):
        ops.toeplitz_conv(u, h, chunk=0)
    with pytest.raises(ValueError, match="n_chunk_diags must be"):
        ops.toeplitz_conv(u, h, n_chunk_diags=0)
    with pytest.raises(ValueError, match="h has shape"):
        ops.toeplitz_conv(u, h[:, :-1])


def test_toeplitz_tolerance_states_the_tf32_bound():
    """TOLERANCE's values, and the rounding its derivation rests on: TF32
    by round-to-nearest (ties away) is off by at most 2^-11 of the value,
    and bf16 values pass through it unchanged."""
    assert TT.TOLERANCE == {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2.0 ** -6, 2.0 ** -10)}
    r = torch.from_numpy(np.random.default_rng(1).standard_normal(10_000).astype(np.float32))
    assert ((tf32(r) - r).abs() <= 2.0 ** -11 * r.abs()).all()
    assert torch.equal(tf32(r.bfloat16().float()), r.bfloat16().float())


@pytest.mark.parametrize("B,L,D,C,K", [(1, 1000, 64, 128, None), (1, 97, 16, 128, None),
                                       (2, 300, 33, 128, 2), (1, 1000, 64, 256, None)])
def test_tf32_rounding_model_holds_the_bf16_gate(B, L, D, C, K):
    """The bf16 kernel's TF32 taps, modelled on the CPU (the plain chunked
    sum with h rounded to TF32, u exact), stay inside the unchanged bf16
    gate against the plain version (TOLERANCE), with at least a fourfold
    margin on atol, gated with skip and bare."""
    u, h, skip, gate = (torch.tensor(a) for a in _inputs(B, L, D, "bf16", seed=L + D))
    u, gate = u.bfloat16(), gate.bfloat16()
    rtol, atol = TT.TOLERANCE[torch.bfloat16]
    for sk, g in ((skip, gate), (None, None)):
        got = toeplitz_conv_plain(u, tf32(h), sk, g, chunk=C, n_chunk_diags=K).float()
        want = toeplitz_conv_plain(u, h, sk, g, chunk=C, n_chunk_diags=K).float()
        excess = ((got - want).abs() - rtol * want.abs()).max().item()
        assert excess <= atol / 4, (sk is not None, excess)


def _fragment_product(h, U, r, C):
    """T_r @ U (U: CP x 8, one input chunk a column) as the tensor-core
    kernel computes it: per warp strip, the tap window of diagonal r as
    pairs (h[x - 1], h[x]) from tc_window_start, the A fragments read from
    it by tc_fragment_index, the B fragments as rows 2t, 2t + 1 of each
    k-tile, each m16n8k8 tile rebuilt from its 32 lanes' registers; on
    r = 0 the tiles the kernel skips are left out."""
    L = h.shape[0]
    CP, MW, KT, strips = TT.tc_dims(C)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    Y = np.zeros((CP, U.shape[1]))
    for strip in range(strips):
        mi0 = strip * MW
        x = TT.tc_window_start(r, C, mi0, KT) + np.arange(8 * (2 * (MW - 1) + KT - 1) + 22)
        tap = lambda x: np.where((x >= 0) & (x < L), h[np.clip(x, 0, L - 1)], 0.0)
        P = np.stack([tap(x - 1), tap(x)], axis=-1)
        for mm in range(MW):
            for ki in range(KT):
                s = 2 * mm - ki
                if r == 0 and 2 * mi0 + s < -1:
                    continue
                p0, p1 = TT.tc_fragment_index(s, lane, KT)
                A = np.zeros((16, 8))
                A[g, t], A[g + 8, t] = P[p0, 1], P[p1, 1]  # a0, a1
                A[g, t + 4], A[g + 8, t + 4] = P[p0, 0], P[p1, 0]  # a2, a3
                Bm = np.zeros((8, 8))
                Bm[t, g] = U[8 * ki + 2 * t, g]  # b0
                Bm[t + 4, g] = U[8 * ki + 2 * t + 1, g]  # b1
                rows = slice(16 * (mi0 + mm), 16 * (mi0 + mm) + 16)
                Y[rows] += A @ Bm
    return Y


@pytest.mark.parametrize("C", [128, 97, 256])
@pytest.mark.parametrize("r", [0, 1, 3])
def test_tensor_core_fragments_reproduce_the_toeplitz_product(C, r):
    """The kernel's index rule, emulated lane by lane in numpy, gives
    T_r @ U for the shifted u columns: output column i reads input chunk
    i - r (zero where i < r), and T_r[a, b] = h[rC + a - b] is zero at
    negative lags."""
    rng = np.random.default_rng(C + r)
    n = 8
    L = n * C - 5
    h = rng.standard_normal(L)
    u = np.zeros(n * C)
    u[:L] = rng.standard_normal(L)
    CP = TT.tc_dims(C)[0]
    U = np.zeros((CP, 8))
    for i in range(r, 8):
        U[:C, i] = u[(i - r) * C:(i - r + 1) * C]
    lag = r * C + np.arange(C)[:, None] - np.arange(C)[None, :]
    T = np.where((lag >= 0) & (lag < L), h[np.clip(lag, 0, L - 1)], 0.0)
    got = _fragment_product(h, U, r, C)
    np.testing.assert_allclose(got[:C], T @ U[:C], rtol=1e-12, atol=1e-12)


def test_tensor_core_launch_shapes_fit_the_card():
    """Every chunk size the tensor-core instance takes, at the engine's and
    small widths, plans a block within 227 KB of shared memory and its 512
    threads; at D = 864 seven channels a block (two warps each at C = 128)
    fill 124 of 132 SMs."""
    assert TT.tc_launch_shape(864, 128, 132) == (7, 448, TT.tc_smem_bytes(128, 7), 124)
    for C in range(1, TT.MAX_CHUNK + 1):
        CP, MW, KT, strips = TT.tc_dims(C)
        assert C <= CP <= max(16, 2 * C) and MW * strips * 16 == CP and KT * 8 == CP
        for D in (1, 5, 864, 865, 5000):
            G, threads, smem, grid = TT.tc_launch_shape(D, C, 132)
            assert 1 <= G and threads == 32 * G * strips <= 32 * TT.TC_MAX_WARPS
            assert smem == TT.tc_smem_bytes(C, G) <= TT.SMEM_PER_BLOCK
            assert grid * G >= D > (grid - 1) * G
