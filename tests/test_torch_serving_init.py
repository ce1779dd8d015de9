"""repro_torch's served tree, drawn leaf by leaf, and the serving
launcher's fit check, on the CPU.

``init_served_params`` draws the same float32 normals in the same order as
``init_params`` and casts each leaf to its served dtype as soon as it is
drawn (``layers.leaf_dtype``, the one rule that ``serving_params`` casts
by): for every arch's reduced config its tree must equal
``serving_params(init_params(...))`` bit for bit, leaf by leaf, in dtype
and value.  ``served_param_bytes`` counts that tree from the meta shapes
alone; at full size it gives the figures the launcher refuses by.  The
launcher's fit check is a plain function of the free bytes, so its
refusals and acceptances run here without a card.  The reduced
qwen3-moe-30b-a3b, on the reference's weights carried across and then
served, must equal the reference's prefill and two decode steps (per row,
2e-2 in bf16, 1e-4 in float32; a row of a sequence is held up to its first
top-k routing flip between the packages, which are counted, as in
``tests/test_torch_families.py``).  ``serving.layer_hold.layers_held``,
the teacher-forced per-layer hold of ``chip_smoke.py`` phase 22, gives 0
run on the plain route against itself and must reject a planted fault.
"""
import numpy as np
import pytest

# The port's tests need torch.  CI's jax-only tier-1 job installs no torch,
# so there these files skip instead of failing at import.
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models as rm  # noqa: E402
import repro.models.blocks as ref_blocks  # noqa: E402
import repro_torch.models as pm  # noqa: E402
import repro_torch.models.blocks as port_blocks  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models.layers import MATRICES  # noqa: E402
from repro_torch.serving.engine import serving_params  # noqa: E402
from repro_torch.serving.layer_hold import LayerHoldError, layers_held  # noqa: E402

ARCHS = ("command-r-plus-104b", "deepseek-67b", "hymba-1.5b", "llama3.2-1b",
         "llama4-scout-17b-a16e", "paligemma-3b", "qwen3-moe-30b-a3b",
         "seamless-m4t-large-v2", "xlstm-1.3b", "yi-9b")
#: at full size, GB (1e9 bytes): the float32 tree (to 0.1), the served tree
#: and the largest float32 leaf (to 0.01), as counted on meta tensors
FULL_GB = {"qwen3-moe-30b-a3b": (120.3, 61.43, 1.24), "yi-9b": (35.3, 18.71, 1.05),
           "deepseek-67b": (269.7, 138.21, 3.36), "llama4-scout-17b-a16e": (406.9, 207.61, 4.14),
           "command-r-plus-104b": (415.2, 213.92, 12.58)}
#: the archs whose served tree one card of 80 GB holds (the fit check takes
#: them; the launcher's engines overflow paligemma-3b's cache, ROADMAP.md
#: § 3.10), and those it cannot hold
ONE_CARD = ("llama3.2-1b", "hymba-1.5b", "paligemma-3b", "seamless-m4t-large-v2", "xlstm-1.3b",
            "yi-9b", "qwen3-moe-30b-a3b")
SHARDED = ("deepseek-67b", "llama4-scout-17b-a16e", "command-r-plus-104b")
CARD = 80 * 10 ** 9
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
B, S, SLOTS, STEPS = 2, 12, 16, 2
MOE = "qwen3-moe-30b-a3b"


def leaves(tree):
    return list(pm.param_leaves(tree))


def tree_bytes(tree):
    return sum(x.numel() * x.element_size() for _, x in leaves(tree))


def test_archs_are_the_registered_ones():
    from repro_torch.configs import list_archs

    assert set(ARCHS) == set(list_archs()) == set(ONE_CARD + SHARDED)


@pytest.mark.parametrize("arch", ARCHS)
def test_served_tree_is_serving_params_bit_for_bit(arch):
    cfg = get_config(arch, reduced=True)
    want = serving_params(pm.init_params(cfg, torch.Generator().manual_seed(3), device="cpu"),
                          cfg, "cpu")
    got = pm.init_served_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    want, got = leaves(want), leaves(got)
    assert [name for name, _ in got] == [name for name, _ in want]
    for (name, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name
        assert g.dtype == (cfg.compute_dtype if name in MATRICES else torch.float32), name
    assert {g.dtype for _, g in got} == {torch.bfloat16, torch.float32}


def test_draw_keeps_the_float32_stream():
    """The first leaf is the float32 normals at 0.02, unchanged by the cast
    that follows each draw; the served tree's first matrix is the
    float32 draw after it, cast."""
    cfg = get_config("llama3.2-1b", reduced=True)
    gen = torch.Generator().manual_seed(5)
    table = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen) * 0.02
    wq = (torch.randn((cfg.d_model, cfg.n_heads, cfg.head_dim), generator=gen)
          * cfg.d_model ** -0.5)
    served = pm.init_served_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    assert torch.equal(served["embed"], table)
    assert torch.equal(served["blocks"][0]["attn"]["wq"], wq.to(cfg.compute_dtype))
    params = pm.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    assert torch.equal(params["blocks"][0]["attn"]["wq"], wq)


@pytest.mark.parametrize("arch", ARCHS)
def test_served_param_bytes_counts_the_tree(arch):
    cfg = get_config(arch, reduced=True)
    tree = pm.init_served_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert pm.served_param_bytes(cfg) == tree_bytes(tree)
    assert tree_bytes(pm.init_served_params(cfg, None, device="meta")) == tree_bytes(tree)


@pytest.mark.parametrize("arch", sorted(FULL_GB))
def test_served_param_bytes_at_full_size(arch):
    cfg = get_config(arch)
    f32_gb, served_gb, leaf_gb = FULL_GB[arch]
    tree = pm.abstract_params(cfg)
    assert round(tree_bytes(tree) / 1e9, 1) == f32_gb
    assert round(pm.served_param_bytes(cfg) / 1e9, 2) == served_gb
    assert round(max(x.numel() * 4 for _, x in leaves(tree)) / 1e9, 2) == leaf_gb


@pytest.mark.parametrize("arch", ARCHS)
def test_fit_check_refuses_and_accepts(arch):
    need = port_serve.serving_need(get_config(arch))
    assert need["total"] == need["weights"] + need["cache"] + need["draw"] + need["reserve"]
    assert need["weights"] == pm.served_param_bytes(get_config(arch))
    assert port_serve.fit_refusal(arch, need, need["total"]) is None
    refusal = port_serve.fit_refusal(arch, need, need["total"] - 1)
    assert f"needs {need['total']:,} bytes" in refusal
    assert f"{need['total'] - 1:,} bytes" in refusal
    assert "repro_torch.launch.steps" in refusal
    assert (port_serve.fit_refusal(arch, need, CARD) is None) == (arch in ONE_CARD)


def test_fit_check_refuses_qwen3_moe_on_60_gb():
    need = port_serve.serving_need(get_config(MOE))
    assert 61e9 < need["weights"] < need["total"] < 65e9
    assert port_serve.fit_refusal(MOE, need, 60 * 10 ** 9).startswith(
        f"repro_torch.launch.serve: {MOE} needs {need['total']:,} bytes")


def spy_routing(mp, seen):
    """Both packages' top-k picks, one (B, S, K) array per MoE layer call."""
    ref_moe, port_moe = ref_blocks.moe_layer, port_blocks.moe_layer

    def ref_spy(x, p, cfg):
        probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", x.astype(jnp.float32), p["router"]))
        jax.debug.callback(lambda idx: seen["ref"].append(np.sort(np.asarray(idx), -1)),
                           jax.lax.top_k(probs, cfg.top_k)[1], ordered=True)
        return ref_moe(x, p, cfg)

    def port_spy(x, p, cfg):
        probs = torch.softmax(torch.matmul(x.float(), p["router"]), dim=-1)
        seen["port"].append(np.sort(torch.topk(probs, cfg.top_k, dim=-1).indices.numpy(), -1))
        return port_moe(x, p, cfg)

    mp.setattr(ref_blocks, "moe_layer", ref_spy)
    mp.setattr(port_blocks, "moe_layer", port_spy)


def first_flips(seen, first):
    """``first`` (B,) lowered to each sequence's first position whose expert
    set differs between the packages in the calls since the last; the
    number of (layer, token) flips."""
    jax.effects_barrier()
    assert len(seen["ref"]) == len(seen["port"])
    flips = 0
    for r, p in zip(seen["ref"], seen["port"]):
        diff = (r != p).any(-1)
        flips += int(diff.sum())
        for b in range(B):
            if diff[b].any():
                first[b] = min(first[b], int(np.argmax(diff[b])))
    seen["ref"].clear()
    seen["port"].clear()
    return flips


def row_errs(got, want):
    got = got.float().numpy().astype(np.float64)
    want = np.asarray(want, np.float32).astype(np.float64)
    return np.abs(got - want).max(-1) / np.abs(want).max(-1)


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_reduced_moe_served_matches_reference(dtype):
    rc = ref_config(MOE, reduced=True).replace(remat="none")
    pc = get_config(MOE, reduced=True)
    if dtype == "float32":
        rc = rc.replace(compute_dtype=jnp.float32, kv_cache_dtype=jnp.float32)
        pc = pc.replace(compute_dtype=torch.float32, kv_cache_dtype=torch.float32)
    params = rm.init_params(rc, jax.random.key(11))
    unserved = lm_params_from_numpy(jax.tree.map(np.asarray, params), pc, device="cpu")
    served = serving_params(unserved, pc, "cpu")
    if dtype == "bfloat16":
        assert served["blocks"][0]["moe"]["wi"].dtype == torch.bfloat16
    tokens = np.random.default_rng(2).integers(0, rc.vocab_size, (B, S)).astype(np.int32)
    tol, first, flips, held = TOL[dtype], np.full(B, np.inf), 0, []
    seen = {"ref": [], "port": []}

    def hold(got, want, step):
        """Each sequence's row within ``tol`` unless its routing flipped."""
        errs = row_errs(got, want)
        for b in range(B):
            if first[b] == np.inf:
                assert errs[b] <= tol, f"{dtype} step {step} sequence {b}: {errs[b]:.3e}"
                held.append(errs[b])

    with pytest.MonkeyPatch.context() as mp:
        spy_routing(mp, seen)
        rcache = rm.init_cache(rc, B, SLOTS)
        rlog, rcache = jax.jit(lambda p, b, c: rm.prefill_fn(p, rc, b, c))(
            params, {"tokens": jnp.asarray(tokens)}, rcache)
        batch = {"tokens": torch.as_tensor(tokens)}
        plog, pcache = pm.prefill_fn(served, pc, batch, pm.init_cache(pc, B, SLOTS, device="cpu"))
        ulog, ucache = pm.prefill_fn(unserved, pc, batch,
                                     pm.init_cache(pc, B, SLOTS, device="cpu"))
        seen["port"] = seen["port"][:len(seen["port"]) // 2]     # the unserved pass's own
        flips += first_flips(seen, first)
        hold(plog, rlog, 0)
        assert torch.equal(plog, ulog)
        decode = jax.jit(lambda p, t, n, c: rm.decode_fn(p, rc, t, n, c))
        for i in range(STEPS):
            tok = np.array(jnp.argmax(rlog, axis=-1), np.int32)
            rlog, rcache = decode(params, jnp.asarray(tok), jnp.int32(S + i), rcache)
            plog, pcache = pm.decode_fn(served, pc, torch.as_tensor(tok), S + i, pcache)
            ulog, ucache = pm.decode_fn(unserved, pc, torch.as_tensor(tok), S + i, ucache)
            seen["port"] = seen["port"][:len(seen["port"]) // 2]
            flips += first_flips(seen, first)
            hold(plog, rlog, i + 1)
            assert torch.equal(plog, ulog)
    if dtype == "float32":
        assert flips == 0 and len(held) == B * (STEPS + 1)
    print(f"{MOE} served {dtype}: {len(held)} of {B * (STEPS + 1)} rows held, max "
          f"{max(held, default=0.0):.3e}, {flips} routing flips")
    assert held


def test_layers_held_plain_against_itself_and_a_planted_fault():
    cfg = get_config(MOE, reduced=True)
    served = pm.init_served_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    stats = layers_held(cfg, served, prompt, STEPS + 1, "cpu", TOL["bfloat16"], "cpu")
    assert stats == {"attn": 0.0, "out": 0.0, "left_out": 0,
                     "rows": cfg.n_layers * (B * S + STEPS * B)}
    nxt = served["blocks"][1]["attn"]

    def next_kv(kind, step, layer, p):
        if kind != "prefill" or layer != 0:
            return p
        return dict(p, attn=dict(p["attn"], wk=nxt["wk"], wv=nxt["wv"]))

    with pytest.raises(LayerHoldError, match="prefill step 0 layer 0: the kernel route's "
                                              "attention output"):
        layers_held(cfg, served, prompt, 1, "cpu", TOL["bfloat16"], "cpu", fault=next_kv)

    def late(kind, step, layer, p):          # the first decode step's last layer
        if kind != "decode" or layer != cfg.n_layers - 1:
            return p
        return dict(p, attn=dict(p["attn"], wv=p["attn"]["wv"] * 2))

    with pytest.raises(LayerHoldError, match=f"decode step 0 layer {cfg.n_layers - 1}"):
        layers_held(cfg, served, prompt, 2, "cpu", TOL["bfloat16"], "cpu", fault=late)
