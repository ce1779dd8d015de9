"""The slice as a whole: ``repro_torch.kernels.ops`` == ``repro.kernels.ops``.

The public attention wrappers of both packages, with their default blocks,
on the same inputs at the reduced widths of the models the repo supports
(``repro.configs``: yi-9b, hymba-1.5b with its sliding window, llama3.2-1b).
The reference's wrappers run its Pallas kernels in interpret mode on the
CPU; the port's run their plain versions on CPU tensors.  Tolerances are the
reference's: 2e-5 in float32, 2e-2 in bf16.
"""
import inspect

import numpy as np
import pytest

# The port's tests need torch.  CI's jax-only tier-1 job installs no torch,
# so there these files skip instead of failing at import.
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro_torch.kernels as port_kernels  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.kernels import ops as port_ops  # noqa: E402

MODELS = ["yi-9b", "hymba-1.5b", "llama3.2-1b"]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
B, S_PREFILL, S_CACHE = 2, 64, 128


def _pair(rng, shape, dtype):
    a = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", MODELS)
def test_flash_attention_at_reduced_width(model, dtype):
    cfg = get_config(model, reduced=True)
    rng = np.random.default_rng(0)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng, (B, S_PREFILL, heads, cfg.head_dim), dtype)
        for heads in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    want = ref_ops.flash_attention(jq, jk, jv, causal=True, window=cfg.window)
    got = port_ops.flash_attention(tq, tk, tv, causal=True, window=cfg.window)
    _close(got, want, DTYPES[dtype][2])


def test_flash_attention_noncausal_at_reduced_width():
    cfg = get_config("llama3.2-1b", reduced=True)
    rng = np.random.default_rng(1)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng, (B, S_PREFILL, heads, cfg.head_dim), "float32")
        for heads in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    want = ref_ops.flash_attention(jq, jk, jv, causal=False)
    _close(port_ops.flash_attention(tq, tk, tv, causal=False), want, 2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", MODELS)
def test_decode_attention_at_reduced_width(model, dtype):
    cfg = get_config(model, reduced=True)
    rng = np.random.default_rng(2)
    jq, tq = _pair(rng, (B + 1, cfg.n_heads, cfg.head_dim), dtype)
    (jk, tk), (jv, tv) = (_pair(rng, (B + 1, S_CACHE, cfg.n_kv_heads, cfg.head_dim), dtype)
                          for _ in range(2))
    lengths = np.array([S_CACHE, 0, 37], np.int32)       # full, empty, ragged
    want = ref_ops.decode_attention(jq, jk, jv, jnp.asarray(lengths))
    got = port_ops.decode_attention(tq, tk, tv, torch.from_numpy(lengths))
    _close(got, want, DTYPES[dtype][2])
    assert not got[1].any()


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention"])
def test_wrappers_keep_the_reference_signatures(name):
    ref_sig = inspect.signature(getattr(ref_ops, name))
    port_sig = inspect.signature(getattr(port_ops, name))
    assert [(p.name, p.kind, p.default) for p in port_sig.parameters.values()] == \
        [(p.name, p.kind, p.default) for p in ref_sig.parameters.values()]


def test_package_reexports_the_wrappers():
    assert port_kernels.flash_attention is port_ops.flash_attention
    assert port_kernels.decode_attention is port_ops.decode_attention
    assert callable(port_kernels.provision_scan_grid)
    assert callable(port_kernels.provision_scan_stream)
