"""repro_torch.models and the serving engine == repro's, on the CPU.

Every dense reduced config runs with the reference's own random weights,
carried across by ``lm_params_from_numpy``, on token ids made with numpy:
``logits_fn``, ``prefill_fn`` (logits and the cache's k, v and pos) and
four ``decode_fn`` steps fed the same tokens, against the reference's jit
on the CPU (the other families: ``tests/test_torch_families*.py``).  Each
output row (the last axis) must be within ``tol * max|ref row|``: tol 1e-4
with float32 compute and cache (the two packages sum in other orders),
2e-2 in bf16 (the reference's XLA keeps excess precision across fused
ops, so its bf16 roundings fall elsewhere).  At
float32 the greedy tokens must be equal.  Also the port's own
prefill/decode consistency (as ``tests/test_arch_smoke.py`` checks the
reference's), the kernel route's wiring on the CPU, and the refusals of
the entry points without CUDA (the vlm and encoder-decoder:
``tests/test_torch_vlm_encdec.py``).
"""
import numpy as np
import pytest

# The port's tests need torch.  CI's jax-only tier-1 job installs no torch,
# so there these files skip instead of failing at import.
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models as rm  # noqa: E402
import repro_torch.models as pm  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import list_archs as ref_archs  # noqa: E402
from repro.serving import InferenceEngine as RefEngine  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import attention as port_attention  # noqa: E402
from repro_torch.models.layers import activation  # noqa: E402
from repro_torch.serving import InferenceEngine  # noqa: E402

ARCHS = ("llama3.2-1b", "yi-9b", "deepseek-67b", "command-r-plus-104b")
#: the hybrid, moe and ssm archs (their parity: ``tests/test_torch_families*.py``)
FAMILY_ARCHS = ("hymba-1.5b", "llama4-scout-17b-a16e", "qwen3-moe-30b-a3b", "xlstm-1.3b")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
B, S, SLOTS, STEPS = 2, 12, 20, 4


def port_cfg(arch, dtype):
    cfg = get_config(arch, reduced=True)
    if dtype == "float32":
        cfg = cfg.replace(compute_dtype=torch.float32, kv_cache_dtype=torch.float32)
    return cfg


def ref_cfg(arch, dtype):
    cfg = ref_config(arch, reduced=True).replace(remat="none")
    if dtype == "float32":
        cfg = cfg.replace(compute_dtype=jnp.float32, kv_cache_dtype=jnp.float32)
    return cfg


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def row_err(got, want):
    """Largest |got - want| of each row (last axis) over that row's largest
    |want|, at most over all rows; rows of zeros must match exactly."""
    got, want = as_np(got).astype(np.float64), as_np(want).astype(np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max(-1)
    scale = np.abs(want).max(-1)
    assert (err[scale == 0] == 0).all()
    return float((err / np.where(scale == 0, 1.0, scale)).max())


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS for d in TOL],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    """One config through both packages: the reference's outputs, the
    port's on the same weights, and the measured row errors."""
    arch, dtype = request.param
    rc, pc = ref_cfg(arch, dtype), port_cfg(arch, dtype)
    params = rm.init_params(rc, jax.random.key(7))
    pp = lm_params_from_numpy(jax.tree.map(np.asarray, params), pc, device="cpu")
    tokens = np.random.default_rng(1).integers(0, rc.vocab_size, (B, S)).astype(np.int32)
    out = {"arch": arch, "dtype": dtype, "rc": rc, "pc": pc, "params": params, "pp": pp}

    out["ref_logits"] = jax.jit(lambda p, b: rm.logits_fn(p, rc, b))(
        params, {"tokens": jnp.asarray(tokens)})
    out["port_logits"] = pm.logits_fn(pp, pc, {"tokens": torch.as_tensor(tokens)})

    rcache = rm.init_cache(rc, B, SLOTS)
    rlog, rcache = jax.jit(lambda p, b, c: rm.prefill_fn(p, rc, b, c))(
        params, {"tokens": jnp.asarray(tokens)}, rcache)
    pcache = pm.init_cache(pc, B, SLOTS, device="cpu")
    plog, pcache = pm.prefill_fn(pp, pc, {"tokens": torch.as_tensor(tokens)}, pcache)
    out["prefill"] = (rlog, plog, jax.tree.map(np.asarray, rcache["kv"]),
                      type(pcache["kv"])(*(x.clone() for x in pcache["kv"])))

    decode = jax.jit(lambda p, t, n, c: rm.decode_fn(p, rc, t, n, c))
    steps = []
    for i in range(STEPS):
        tok = np.array(jnp.argmax(rlog, axis=-1), np.int32)      # the reference's picks
        port_tok = plog.argmax(-1).to(torch.int32).numpy()
        rlog, rcache = decode(params, jnp.asarray(tok), jnp.int32(S + i), rcache)
        plog, pcache = pm.decode_fn(pp, pc, torch.as_tensor(tok), S + i, pcache)
        steps.append((tok, port_tok, rlog, plog))
    out["decode"] = steps
    out["final_cache"] = (jax.tree.map(np.asarray, rcache["kv"]), pcache["kv"])
    return out


def test_list_archs_is_the_dense_four():
    """The dense four, and since the other families were ported, every
    reference arch: the hybrid, moe and ssm archs, vlm's and the
    encoder-decoder's."""
    assert set(ARCHS + FAMILY_ARCHS) <= set(ref_archs())
    assert list_archs() == sorted(ref_archs())


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS + FAMILY_ARCHS)
def test_config_matches_reference(arch, reduced):
    got, want = get_config(arch, reduced=reduced), ref_config(arch, reduced=reduced)
    dtypes = {"param_dtype": torch.float32, "compute_dtype": torch.bfloat16,
              "kv_cache_dtype": torch.bfloat16}
    for field in want.__dataclass_fields__:
        if field in dtypes:
            assert getattr(got, field) == dtypes[field], field
            assert np.dtype(getattr(want, field)).name == str(dtypes[field]).split(".")[1]
        else:
            assert getattr(got, field) == getattr(want, field), field


@pytest.mark.parametrize("arch", ARCHS + FAMILY_ARCHS)
def test_param_count_matches_reference(arch):
    """At full size from the shapes alone (no allocation), and at the
    reduced size against the parameters ``init_params`` draws."""
    assert pm.param_count(get_config(arch)) == rm.param_count(ref_config(arch))
    assert pm.embedding_param_count(get_config(arch)) == \
        rm.embedding_param_count(ref_config(arch))
    assert pm.active_param_count(get_config(arch)) == rm.active_param_count(ref_config(arch))
    cfg = get_config(arch, reduced=True)
    params = pm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    leaves = [params["embed"], params["final_ln"]] + ([params["unembed"]]
                                                       if "unembed" in params else [])
    for layer in params["blocks"]:
        for v in layer.values():
            leaves += list(v.values()) if isinstance(v, dict) else [v]
    assert sum(t.numel() for t in leaves) == pm.param_count(cfg)


def test_lm_params_from_numpy_layout(pair):
    rc, pp, params = pair["rc"], pair["pp"], pair["params"]
    assert len(pp["blocks"]) == rc.n_layers
    for i, layer in enumerate(pp["blocks"]):
        for name in ("wq", "wk", "wv", "wo"):
            assert np.array_equal(layer["attn"][name].numpy(),
                                  np.asarray(params["blocks"]["attn"][name][i]))
        assert np.array_equal(layer["mlp"]["wo"].numpy(),
                              np.asarray(params["blocks"]["mlp"]["wo"][i]))
    assert np.array_equal(pp["embed"].numpy(), np.asarray(params["embed"]))
    assert pp["embed"].dtype == torch.float32


def test_logits_match_reference(pair):
    assert pair["port_logits"].dtype == torch.float32
    assert row_err(pair["port_logits"], pair["ref_logits"]) <= TOL[pair["dtype"]]


def test_prefill_matches_reference(pair):
    rlog, plog, rkv, pkv = pair["prefill"]
    tol = TOL[pair["dtype"]]
    assert row_err(plog, rlog) <= tol
    assert pkv.k.dtype == pair["pc"].kv_cache_dtype
    assert row_err(pkv.k, rkv.k) <= tol
    assert row_err(pkv.v, rkv.v) <= tol
    assert np.array_equal(pkv.pos.numpy(), rkv.pos)


def test_decode_matches_reference(pair):
    tol = TOL[pair["dtype"]]
    for tok, port_tok, rlog, plog in pair["decode"]:
        assert row_err(plog, rlog) <= tol
        if pair["dtype"] == "float32":
            assert np.array_equal(port_tok, tok)
    rkv, pkv = pair["final_cache"]
    assert np.array_equal(pkv.pos.numpy(), rkv.pos)
    assert row_err(pkv.k, rkv.k) <= tol


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_match_reference_at_f32(arch):
    rc, pc = ref_cfg(arch, "float32"), port_cfg(arch, "float32")
    params = rm.init_params(rc, jax.random.key(3))
    prompt = np.random.default_rng(4).integers(0, rc.vocab_size, (3, 9)).astype(np.int32)
    want = RefEngine(rc, params, max_batch=4, max_seq=32).generate(prompt, 8)
    got = InferenceEngine(pc, lm_params_from_numpy(jax.tree.map(np.asarray, params), pc,
                                                   device="cpu"),
                          max_batch=4, max_seq=32, device="cpu").generate(prompt, 8)
    assert got.prefill_len == want.prefill_len == 9
    assert got.tokens.shape == (3, 8) and got.tokens.dtype == np.int32
    assert np.array_equal(got.tokens, want.tokens)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    """decode(tokens[S]) after prefill(tokens[:S]) == teacher-forced logits,
    at the reference test's tolerance (bf16 compute)."""
    cfg = get_config(arch, reduced=True)
    params = pm.init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 12)))
    full = pm.logits_fn(params, cfg, {"tokens": tokens})
    cache = pm.init_cache(cfg, 2, 11 + 8, device="cpu")
    pre, cache = pm.prefill_fn(params, cfg, {"tokens": tokens[:, :-1]}, cache)
    np.testing.assert_allclose(pre.numpy(), full[:, -2].numpy(), rtol=2e-2, atol=2e-2)
    dec, _ = pm.decode_fn(params, cfg, tokens[:, -1], 11, cache)
    np.testing.assert_allclose(dec.numpy(), full[:, -1].numpy(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_route_wiring_on_cpu_tensors(arch, monkeypatch):
    """The card's route, run on CPU tensors: K3's and K4's wrappers (their
    plain versions here) in place of the einsum path, one K3 call per layer
    per prefill and one K4 call per layer per decode step, and the same
    logits at f32 (causal K3 over unexpanded KV; K4 over cur_len + 1 slots)."""
    cfg = port_cfg(arch, "float32")
    params = pm.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 7)))
    calls = {"flash": 0, "decode": 0}
    flash, decode = port_attention.ops.flash_attention, port_attention.ops.decode_attention

    def counted(name, fn):
        def run(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return run

    def both(fn):
        outs = []
        for kernel in (False, True):
            monkeypatch.setattr(port_attention, "_kernel_route", lambda x, k: k)
            outs.append(fn(kernel))
        return outs

    monkeypatch.setattr(port_attention.ops, "flash_attention", counted("flash", flash))
    monkeypatch.setattr(port_attention.ops, "decode_attention", counted("decode", decode))

    def serve(kernel):
        cache = pm.init_cache(cfg, 2, 12, device="cpu")
        logits, cache = pm.prefill_fn(params, cfg, {"tokens": tokens}, cache, kernel=kernel)
        steps = [logits]
        for i in range(3):
            logits, cache = pm.decode_fn(params, cfg, logits.argmax(-1), 7 + i, cache,
                                         kernel=kernel)
            steps.append(logits)
        return steps

    plain, kernel = both(serve)
    assert calls == {"flash": cfg.n_layers, "decode": 3 * cfg.n_layers}
    for a, b in zip(kernel, plain):
        assert row_err(a, b) <= TOL["float32"]
    full_plain, full_kernel = both(
        lambda kernel: pm.logits_fn(params, cfg, {"tokens": tokens}, kernel=kernel))
    assert row_err(full_kernel, full_plain) <= TOL["float32"]


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_activation_matches_reference(act):
    x = np.random.default_rng(6).standard_normal((4, 33)).astype(np.float32) * 3
    want = jax.nn.silu(x) if act == "silu" else jax.nn.gelu(x)
    np.testing.assert_allclose(activation(torch.as_tensor(x), act).numpy(), want,
                               rtol=1e-6, atol=1e-6)


def test_entry_points_need_cuda_unless_given_cpu():
    if torch.cuda.is_available():
        pytest.skip("the refusal needs a machine without CUDA")
    cfg = get_config("llama3.2-1b", reduced=True)
    gen = torch.Generator().manual_seed(0)
    params = pm.init_params(cfg, gen, device="cpu")
    tree = {"embed": params["embed"].numpy(), "final_ln": params["final_ln"].numpy(),
            "blocks": jax.tree.map(lambda *xs: np.stack([x.numpy() for x in xs]),
                                   *params["blocks"])}
    for name, call in (
            ("init_params", lambda: pm.init_params(cfg, gen)),
            ("init_cache", lambda: pm.init_cache(cfg, 1, 8)),
            ("InferenceEngine", lambda: InferenceEngine(cfg, params)),
            ("lm_params_from_numpy", lambda: lm_params_from_numpy(tree, cfg))):
        with pytest.raises(RuntimeError, match=f"{name}.*CUDA is not available"):
            call()
    got = lm_params_from_numpy(tree, cfg, device="cpu")
    assert torch.equal(got["blocks"][1]["attn"]["wq"], params["blocks"][1]["attn"]["wq"])


def test_engine_rejects_what_does_not_fit():
    cfg = get_config("llama3.2-1b", reduced=True)
    params = pm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = InferenceEngine(cfg, params, max_batch=2, max_seq=16, device="cpu")
    with pytest.raises(ValueError, match="max_batch"):
        eng.generate(np.zeros((3, 4), np.int32), 2)
    with pytest.raises(ValueError, match="max_seq"):
        eng.generate(np.zeros((1, 10), np.int32), 7)
    # below the engine, a sequence that outgrows its cache is kept as the
    # reference keeps it (ROADMAP.md § 3.10): the prefill's last 4 tokens,
    # then each step over slot cur_len % 4
    cache = pm.init_cache(cfg, 1, 4, device="cpu")
    pm.prefill_fn(params, cfg, {"tokens": torch.zeros((1, 5), dtype=torch.int64)}, cache)
    assert cache["kv"].pos[0].tolist() == [1, 2, 3, 4]
    pm.decode_fn(params, cfg, torch.zeros((1,), dtype=torch.int64), 5, cache)
    assert cache["kv"].pos[0].tolist() == [1, 5, 3, 4]


def test_engine_forced_decode_and_logits():
    """``_generate(forced=...)`` feeds the given tokens: with the engine's
    own picks forced it reproduces ``generate``, and its logits are the
    picks' source."""
    cfg = port_cfg("llama3.2-1b", "float32")
    params = pm.init_params(cfg, torch.Generator().manual_seed(8), device="cpu")
    eng = InferenceEngine(cfg, params, max_batch=2, max_seq=24, device="cpu")
    prompt = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 5)).astype(np.int32)
    free = eng.generate(prompt, 6).tokens
    forced, logits = eng._generate(prompt, 6, forced=free, keep_logits=True)
    assert np.array_equal(forced, free) and len(logits) == 6
    assert np.array_equal(torch.stack(logits, 1).argmax(-1).numpy(), free)
    other = (free + 1) % cfg.vocab_size
    picks, _ = eng._generate(prompt, 6, forced=other)
    assert np.array_equal(picks[:, 0], free[:, 0]) and not np.array_equal(picks, free)
