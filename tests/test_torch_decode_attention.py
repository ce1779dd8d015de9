"""K4's plain version == the reference's decode attention, to its tolerances.

``repro_torch.kernels.decode_attention.decode_attention`` on CPU tensors
runs its plain PyTorch version; the reference ``decode_attention`` runs its
Pallas kernel in interpret mode, as the JAX package's own tests run it
(``tests/test_kernels.py``).  Inputs are made with numpy from a seed and cast
to the working type in each framework.  Tolerances are the reference's:
2e-5 in float32, 2e-2 in bf16.  Where the reference's kernel and its jnp
oracle part (a length of 0: zeros against NaN), the port follows the
kernel and its own oracle copy follows the oracle.  The CUDA kernel itself
is held to the plain version on the card by ``chip_smoke.py``.
"""
import importlib

import numpy as np
import pytest

# The port's tests need torch.  CI's jax-only tier-1 job installs no torch,
# so there these files skip instead of failing at import.
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as ref_oracle  # noqa: E402
from repro_torch.kernels import ref as port_ref  # noqa: E402
from repro_torch.obs import telemetry_session  # noqa: E402

# both packages re-export a function named ``decode_attention`` over the
# submodule's name, so import the modules by their full names
ref_kernel = importlib.import_module("repro.kernels.decode_attention")
port = importlib.import_module("repro_torch.kernels.decode_attention")

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(seed, b, s, h, kvh, hd, dtype, lengths=None):
    rng = np.random.default_rng(seed)
    arrays = [(rng.standard_normal(shape) * 0.5).astype(np.float32)
              for shape in ((b, h, hd), (b, s, kvh, hd), (b, s, kvh, hd))]
    if lengths is None:
        lengths = rng.integers(1, s + 1, b)
    lengths = np.asarray(lengths, np.int32)
    jdt, tdt, tol = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays] + [jnp.asarray(lengths)],
            [torch.from_numpy(a).to(tdt) for a in arrays] + [torch.from_numpy(lengths)], tol)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# the shapes of tests/test_kernels.py::test_decode_attention
KERNEL_SHAPES = [
    (2, 512, 8, 2, 64, 128),
    (1, 1024, 4, 4, 128, 256),
    (3, 256, 8, 1, 64, 128),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kvh,hd,bk", KERNEL_SHAPES)
def test_ragged_matches_reference_kernel(dtype, b, s, h, kvh, hd, bk):
    jargs, targs, tol = _inputs(0, b, s, h, kvh, hd, dtype)
    want = ref_kernel.decode_attention(*jargs, block_k=bk, interpret=True)
    got = port.decode_attention(*targs, block_k=bk)
    assert got.dtype == targs[0].dtype and tuple(got.shape) == (b, h, hd)
    _close(got, want, tol)


S = 256


@pytest.mark.parametrize("lengths", [[S, S], [1, 1], [1, S], [0, 77], [S + 1, 3 * S],
                                     [-2, S]],
                         ids=["full", "single", "mixed", "zero", "above_S", "negative"])
def test_lengths_match_reference_kernel(lengths):
    jargs, targs, tol = _inputs(1, 2, S, 4, 2, 64, "float32", lengths)
    want = ref_kernel.decode_attention(*jargs, block_k=128, interpret=True)
    got = port.decode_attention(*targs, block_k=128)
    _close(got, want, tol)
    for row, n in enumerate(lengths):
        if n <= 0:              # the kernel's max(l, 1e-30) over an empty row: zeros
            assert torch.equal(got[row], torch.zeros_like(got[row]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_of_five_matches_reference_kernel(dtype):
    """hymba's query-head group: rep = 5, not a power of two."""
    jargs, targs, tol = _inputs(2, 2, 256, 10, 2, 64, dtype, [256, 131])
    want = ref_kernel.decode_attention(*jargs, block_k=64, interpret=True)
    _close(port.decode_attention(*targs, block_k=64), want, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kvh", [(3, 3), (6, 2), (5, 1)])
@pytest.mark.parametrize("seed", [3, 4])
def test_sweep_matches_reference_oracle(dtype, h, kvh, seed):
    jargs, targs, tol = _inputs(seed, 3, 48, h, kvh, 16, dtype)
    want = ref_oracle.decode_attention_ref(*jargs)
    _close(port.decode_attention(*targs, block_k=16), want, tol)


def test_scale_matches_reference_kernel():
    jargs, targs, tol = _inputs(5, 2, 128, 4, 2, 32, "float32")
    want = ref_kernel.decode_attention(*jargs, scale=0.2, block_k=64, interpret=True)
    _close(port.decode_attention(*targs, scale=0.2), want, tol)


def test_port_oracle_matches_reference_oracle_nan_at_length_zero():
    jargs, targs, tol = _inputs(6, 3, 64, 4, 2, 16, "float32", [0, 5, 64])
    want = np.asarray(ref_oracle.decode_attention_ref(*jargs))
    got = port_ref.decode_attention_ref(*targs).numpy()
    assert np.isnan(want[0]).all() and np.isnan(got[0]).all()
    np.testing.assert_allclose(got[1:], want[1:], rtol=tol, atol=tol)
    # ...while both kernels, and the port's plain version, give zeros there
    assert not np.asarray(ref_kernel.decode_attention(*jargs, block_k=64, interpret=True)).any(
        axis=(1, 2))[0]
    assert not port.decode_attention_plain(*targs)[0].any()


def test_indivisible_block_raises_on_both_sides():
    jargs, targs, _ = _inputs(7, 1, 256, 4, 2, 64, "float32")
    with pytest.raises(AssertionError):
        ref_kernel.decode_attention(*jargs, block_k=96, interpret=True)
    with pytest.raises(ValueError, match="multiple of block_k"):
        port.decode_attention(*targs, block_k=96)


def test_argument_checks():
    _, (q, k, v, lengths), _ = _inputs(8, 2, 32, 4, 2, 16, "float32")
    with pytest.raises(ValueError, match="query heads"):
        port.decode_attention(q[:, :3], k, v, lengths)
    with pytest.raises(ValueError, match="lengths must be"):
        port.decode_attention(q, k, v, lengths[:1])
    with pytest.raises(ValueError, match="do not fit"):
        port.decode_attention(q[:1], k, v, lengths)


def test_no_cpu_or_cuda_tensor_raises():
    """No fallback: a tensor on another device is refused, not computed."""
    q = torch.empty((1, 2, 64), device="meta")
    k = torch.empty((1, 8, 1, 64), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        port.decode_attention(q, k, k, torch.tensor([8]))


@pytest.mark.parametrize("b,kvh,s,sms", [(16, 4, 32768, 132), (1, 5, 524288, 132),
                                         (4, 4, 8192, 132), (1, 1, 64, 132),
                                         (1, 1, 100, 132), (64, 8, 2048, 132),
                                         (3, 2, 1000, 7)])
def test_splits_cover_the_cache_in_whole_tiles(b, kvh, s, sms):
    n_split, chunk = port.splits(b, kvh, s, sms)
    assert chunk % port.TILE == 0 and chunk >= port.TILE
    assert (n_split - 1) * chunk < s <= n_split * chunk
    n_tiles = -(-s // port.TILE)
    assert n_split <= n_tiles
    # as many blocks as asked for, unless the cache runs out of tiles first
    assert b * kvh * n_split >= min(port.BLOCKS_PER_SM * sms, b * kvh * n_tiles) // 2


def test_cpu_calls_launch_nothing():
    _, targs, _ = _inputs(9, 2, 32, 4, 2, 16, "float32")
    before = port.decode_launches
    with telemetry_session() as tel:
        port.decode_attention(*targs)
    assert port.decode_launches == before == 0
    assert not any(r["name"] == "kernels/decode_attention_launches"
                   for r in tel.metrics_records())
