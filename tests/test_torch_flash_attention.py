"""K3's plain version == the reference's flash attention, to its tolerances.

``repro_torch.kernels.flash_attention.flash_attention`` on CPU tensors runs
its plain PyTorch version; the reference ``flash_attention`` runs its Pallas
kernel in interpret mode, as the JAX package's own tests run it
(``tests/test_kernels.py``).  Inputs are made with numpy from a seed and cast
to the working type in each framework (float32 -> bf16 rounds alike in
both).  Tolerances are the reference's: 2e-5 in float32, 2e-2 in bf16 and
fp16.  Broad sweeps compare against the reference's jnp oracle, which is
cheaper than interpret mode; the CUDA kernel itself is held to the plain
version on the card by ``chip_smoke.py``.
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

# both packages re-export a function named ``flash_attention`` over the
# submodule's name, so import the modules by their full names
ref_kernel = importlib.import_module("repro.kernels.flash_attention")
port = importlib.import_module("repro_torch.kernels.flash_attention")

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2),
          "float16": (jnp.float16, torch.float16, 2e-2)}


def _inputs(seed, b, s, h, kvh, hd, dtype):
    rng = np.random.default_rng(seed)
    arrays = [(rng.standard_normal(shape) * 0.5).astype(np.float32)
              for shape in ((b, s, h, hd), (b, s, kvh, hd), (b, s, kvh, hd))]
    jdt, tdt, tol = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays], tol)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# the shapes of tests/test_kernels.py::test_flash_attention_causal
KERNEL_SHAPES = [
    (2, 256, 4, 4, 64, 128, 128),    # MHA
    (1, 256, 8, 2, 64, 128, 128),    # GQA 4x
    (2, 128, 4, 1, 128, 128, 128),   # MQA
    (1, 512, 2, 2, 64, 256, 128),    # rectangular blocks
    (1, 384, 2, 1, 64, 128, 128),    # non-power-of-two S
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kvh,hd,bq,bk", KERNEL_SHAPES)
def test_causal_matches_reference_kernel(dtype, b, s, h, kvh, hd, bq, bk):
    (jq, jk, jv), (tq, tk, tv), tol = _inputs(0, b, s, h, kvh, hd, dtype)
    want = ref_kernel.flash_attention(jq, jk, jv, causal=True, block_q=bq, block_k=bk,
                                      interpret=True)
    got = port.flash_attention(tq, tk, tv, causal=True, block_q=bq, block_k=bk)
    assert got.dtype == tq.dtype and tuple(got.shape) == (b, s, h, hd)
    _close(got, want, tol)


@pytest.mark.parametrize("causal,window", [(True, 32), (True, 128), (False, 0)],
                         ids=["window32", "window128", "noncausal"])
def test_masks_match_reference_kernel(causal, window):
    (jq, jk, jv), (tq, tk, tv), tol = _inputs(1, 1, 256, 4, 2, 64, "float32")
    want = ref_kernel.flash_attention(jq, jk, jv, causal=causal, window=window,
                                      block_q=128, block_k=128, interpret=True)
    got = port.flash_attention(tq, tk, tv, causal=causal, window=window,
                               block_q=128, block_k=128)
    _close(got, want, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_of_five_matches_reference_kernel(dtype):
    """hymba's query-head group: rep = 5, not a power of two, with a window."""
    (jq, jk, jv), (tq, tk, tv), tol = _inputs(2, 1, 128, 5, 1, 64, dtype)
    want = ref_kernel.flash_attention(jq, jk, jv, causal=True, window=48, block_q=64,
                                      block_k=64, interpret=True)
    got = port.flash_attention(tq, tk, tv, causal=True, window=48, block_q=64, block_k=64)
    _close(got, want, tol)


@pytest.mark.parametrize("bq,bk", [(96, 128), (128, 96)])
def test_indivisible_blocks_raise_on_both_sides(bq, bk):
    (jq, jk, jv), (tq, tk, tv), _ = _inputs(3, 1, 256, 2, 1, 64, "float32")
    with pytest.raises(AssertionError):
        ref_kernel.flash_attention(jq, jk, jv, block_q=bq, block_k=bk, interpret=True)
    with pytest.raises(ValueError, match="multiple of the blocks"):
        port.flash_attention(tq, tk, tv, block_q=bq, block_k=bk)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 1), (True, 7), (False, 0),
                                           (False, 5)])
@pytest.mark.parametrize("h,kvh", [(3, 3), (6, 2)])
def test_sweep_matches_reference_oracle(dtype, causal, window, h, kvh):
    (jq, jk, jv), (tq, tk, tv), tol = _inputs(4, 2, 40, h, kvh, 16, dtype)
    want = ref_oracle.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    got = port.flash_attention(tq, tk, tv, causal=causal, window=window, block_q=8,
                               block_k=20)
    _close(got, want, tol)


def test_scale_matches_reference_kernel():
    (jq, jk, jv), (tq, tk, tv), tol = _inputs(5, 1, 64, 2, 1, 32, "float32")
    want = ref_kernel.flash_attention(jq, jk, jv, scale=0.3, block_q=32, block_k=32,
                                      interpret=True)
    _close(port.flash_attention(tq, tk, tv, scale=0.3), want, tol)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16), (False, 0), (False, 9)])
def test_port_oracle_matches_reference_oracle(causal, window):
    (jq, jk, jv), (tq, tk, tv), tol = _inputs(6, 2, 48, 4, 2, 16, "float32")
    want = ref_oracle.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    got = port_ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    _close(got, want, tol)


@pytest.mark.parametrize("window", [0, 16])
def test_matches_model_attention(window):
    """K3's semantics == the reference model's einsum attention (same masks),
    as tests/test_kernels.py::test_flash_matches_model_attention holds the
    Pallas kernel."""
    from repro.models.attention import _causal_mask, _expand_kv, _sdpa

    b, s, h, kvh, hd = 1, 128, 4, 2, 64
    (jq, jk, jv), (tq, tk, tv), _ = _inputs(7, b, s, h, kvh, hd, "float32")
    mask = _causal_mask(s, s, window, 0)[None, None]
    want = _sdpa(jq, _expand_kv(jk, h), _expand_kv(jv, h), mask, jnp.float32)
    got = port.flash_attention(tq, tk, tv, causal=True, window=window, block_q=128,
                               block_k=128)
    _close(got, want, 2e-4)


def test_argument_checks():
    _, (tq, tk, tv), _ = _inputs(8, 1, 32, 4, 2, 16, "float32")
    with pytest.raises(ValueError, match="query heads"):
        port.flash_attention(tq[:, :, :3], tk, tv)
    with pytest.raises(ValueError, match="do not fit"):
        port.flash_attention(tq[:, :16], tk, tv)
    with pytest.raises(ValueError, match="need q"):
        port.flash_attention(tq[0], tk, tv)


def test_no_cpu_or_cuda_tensor_raises():
    """No fallback: a tensor on another device is refused, not computed."""
    q = torch.empty((1, 8, 2, 64), device="meta")
    k = torch.empty((1, 8, 1, 64), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        port.flash_attention(q, k, k)


def test_cpu_calls_launch_nothing():
    _, (tq, tk, tv), _ = _inputs(9, 1, 32, 4, 2, 16, "float32")
    before = port.flash_launches
    with telemetry_session() as tel:
        port.flash_attention(tq, tk, tv)
    assert port.flash_launches == before == 0
    assert not any(r["name"] == "kernels/flash_attention_launches"
                   for r in tel.metrics_records())
