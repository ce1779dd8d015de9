"""The parts of repro_torch's hybrid, moe and ssm families == repro's, on the
CPU, and the ring cache of the windowed layers.

* The ring: the reduced hymba-1.5b (window W = 16, float32) through prefill
  and decode steps past the ring's wrap, prompts of 12, 16, 32 and 20
  tokens.  The port equals the reference on every step, the slot layout and
  ``pos`` included.  Where the prompt fits the ring or is a multiple of it,
  every step also equals the windowed forward over the whole sequence
  (``logits_fn``); at 20 tokens both packages part from it, the reference's
  fault that the port keeps (ROADMAP.md § 3.9).
* The parts one by one, on inputs made with numpy: ``ssd_chunked`` (with
  and without ``h0``, S not a multiple of the chunk), ``ssd_step``,
  ``_causal_conv`` with state, ``moe_layer`` with drops forced, the routing
  order, ``expert_capacity``, ``_position_in_expert``, ``_local_attention``,
  mLSTM and sLSTM over a sequence and a step, with state.
* The kernel route's wiring on CPU tensors (spies on ``ops``): K3 asked for
  the layer's window, K4 for the ring's prefix or its compacted slots, and
  xLSTM asking for neither.
* The serve launcher with hymba engines, against the reference's (the
  configs and parameter counts: ``tests/test_torch_models.py``).
Float32 throughout: each row within 1e-4 of its largest reference value.
"""
import numpy as np
import pytest

# The port's tests need torch.  CI's jax-only tier-1 job installs no torch,
# so there these files skip instead of failing at import.
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models as rm  # noqa: E402
import repro.models.attention as ref_attention  # noqa: E402
import repro.models.moe as ref_moe  # noqa: E402
import repro.models.ssm as ref_ssm  # noqa: E402
import repro.models.xlstm as ref_xlstm  # noqa: E402
import repro_torch.models as pm  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models import attention as port_attention  # noqa: E402
from repro_torch.models import blocks as port_blocks  # noqa: E402
from repro_torch.models import moe as port_moe  # noqa: E402
from repro_torch.models import ssm as port_ssm  # noqa: E402
from repro_torch.models import xlstm as port_xlstm  # noqa: E402

TOL = 1e-4
F32 = {"compute_dtype": torch.float32, "kv_cache_dtype": torch.float32}


def row_err(got, want):
    """Largest |got - want| of each row (last axis) over that row's largest
    |want|, at most over all rows; rows of zeros must match exactly."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    got, want = got.astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max(-1)
    scale = np.abs(want).max(-1)
    assert (err[scale == 0] == 0).all()
    return float((err / np.where(scale == 0, 1.0, scale)).max())


def t(a):
    return torch.as_tensor(np.array(a))


def normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def configs(arch):
    rc = ref_config(arch, reduced=True).replace(remat="none", compute_dtype=jnp.float32,
                                                kv_cache_dtype=jnp.float32)
    return rc, get_config(arch, reduced=True).replace(**F32)


# ---------------------------------------------------------------------------
# The ring cache of the reduced hymba (W = 16)
# ---------------------------------------------------------------------------

RING_B, RING_STEPS = 2, 8


@pytest.fixture(scope="module")
def hymba():
    rc, pc = configs("hymba-1.5b")
    params = rm.init_params(rc, jax.random.key(11))
    pp = lm_params_from_numpy(jax.tree.map(np.asarray, params), pc, device="cpu")
    return rc, pc, params, pp, jax.jit(lambda p, tk, n, c: rm.decode_fn(p, rc, tk, n, c))


def ring_run(hymba, prompt_len):
    """Prefill ``prompt_len`` tokens and decode RING_STEPS more through both
    packages, fed the reference's greedy picks; returns per step (the
    reference's logits, the port's, both caches) and every token fed."""
    rc, pc, params, pp, decode = hymba
    W = rc.window
    rng = np.random.default_rng(prompt_len)
    tokens = rng.integers(0, rc.vocab_size, (RING_B, prompt_len)).astype(np.int32)
    s_max = prompt_len + RING_STEPS
    rcache = rm.init_cache(rc, RING_B, s_max)
    pcache = pm.init_cache(pc, RING_B, s_max, device="cpu")
    assert rcache["kv"].k.shape[2] == pcache["kv"].k.shape[2] == W
    rlog, rcache = jax.jit(lambda p, b, c: rm.prefill_fn(p, rc, b, c))(
        params, {"tokens": jnp.asarray(tokens)}, rcache)
    plog, pcache = pm.prefill_fn(pp, pc, {"tokens": t(tokens)}, pcache)
    steps = [(rlog, plog.clone(), jax.tree.map(np.asarray, rcache),
              {k: type(v)(*(x.clone() for x in v)) for k, v in pcache.items()})]
    fed = [tokens]
    for i in range(RING_STEPS):
        tok = np.array(jnp.argmax(rlog, axis=-1), np.int32)
        fed.append(tok[:, None])
        rlog, rcache = decode(params, jnp.asarray(tok), jnp.int32(prompt_len + i), rcache)
        plog, pcache = pm.decode_fn(pp, pc, t(tok), prompt_len + i, pcache)
        steps.append((rlog, plog.clone(), jax.tree.map(np.asarray, rcache),
                      {k: type(v)(*(x.clone() for x in v)) for k, v in pcache.items()}))
    full = pm.logits_fn(pp, pc, {"tokens": t(np.concatenate(fed, axis=1))})
    return steps, full


def check_port_equals_reference(steps):
    for rlog, plog, rcache, pcache in steps:
        assert row_err(plog, rlog) <= TOL
        assert np.array_equal(pcache["kv"].pos.numpy(), rcache["kv"].pos)
        for field in ("k", "v"):
            assert row_err(getattr(pcache["kv"], field), getattr(rcache["kv"], field)) <= TOL
        for got, want in zip(pcache["ssm"], rcache["ssm"]):
            assert row_err(got.flatten(2), want.reshape(*want.shape[:2], -1)) <= TOL


def distance_to_full(steps, full, prompt_len):
    """Each step's largest row distance to the windowed forward over the
    whole sequence at the same position."""
    return [row_err(plog, full[:, prompt_len - 1 + i].numpy())
            for i, (_, plog, _, _) in enumerate(steps)]


@pytest.mark.parametrize("prompt_len", [12, 16, 32])
def test_ring_matches_reference_and_windowed_forward(hymba, prompt_len):
    steps, full = ring_run(hymba, prompt_len)
    check_port_equals_reference(steps)
    W = hymba[0].window
    last_pos = steps[-1][2]["kv"].pos[0]            # every layer's is the same
    assert last_pos.max() == prompt_len + RING_STEPS - 1 and (last_pos >= 0).all()
    # the slots past the wrap hold the newest positions, as the ring keeps them
    assert all(last_pos[p % W] == p for p in range(prompt_len + RING_STEPS - W,
                                                   prompt_len + RING_STEPS))
    dist = distance_to_full(steps, full, prompt_len)
    print(f"prompt {prompt_len}: decode steps from the windowed forward {max(dist):.3e}")
    assert max(dist) <= TOL


def test_reference_ring_overwrite_fault_reproduced(hymba):
    """ROADMAP.md § 3.9: a prompt of 20 > W = 16 tokens, not a multiple of
    it.  The reference's prefill keeps positions 4..19 at slots 0..15, so
    the decode step at 20 writes slot 4, over position 8, still inside the
    window; position 4 in slot 0 is masked out.  The port keeps the
    reference's layout and result, and both part from the windowed forward
    over the whole sequence."""
    steps, full = ring_run(hymba, 20)
    check_port_equals_reference(steps)
    assert np.array_equal(steps[0][2]["kv"].pos[0], np.arange(4, 20))
    pos = steps[1][2]["kv"].pos[0]
    assert pos[4] == 20 and pos[0] == 4 and 8 not in pos
    dist = distance_to_full(steps, full, 20)
    print(f"prompt 20: decode steps from the windowed forward {max(dist[1:]):.3e}")
    assert dist[0] <= TOL                   # the prefill itself is right
    assert max(dist[1:]) > 1e-3             # the decode steps are not


# ---------------------------------------------------------------------------
# The parts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("seq,chunk", [(13, 4), (8, 8), (5, 16)])
def test_ssd_chunked_matches_reference(seq, chunk, with_h0):
    rng = np.random.default_rng(seq * 10 + chunk)
    b, nh, dk, dv = 2, 3, 4, 5
    q, k = normal(rng, b, seq, nh, dk), normal(rng, b, seq, nh, dk)
    v = normal(rng, b, seq, nh, dv)
    log_a = -np.abs(normal(rng, b, seq, nh))
    h0 = normal(rng, b, nh, dk, dv) if with_h0 else None
    want_y, want_h = ref_ssm.ssd_chunked(q, k, v, log_a, chunk,
                                         h0=None if h0 is None else jnp.asarray(h0))
    got_y, got_h = port_ssm.ssd_chunked(t(q), t(k), t(v), t(log_a), chunk,
                                        h0=None if h0 is None else t(h0))
    assert got_y.dtype == got_h.dtype == torch.float32
    assert row_err(got_y, want_y) <= TOL and row_err(got_h, want_h) <= TOL
    # padding to a chunk multiple leaves the state as an unpadded run's
    whole_y, whole_h = port_ssm.ssd_chunked(t(q), t(k), t(v), t(log_a), seq,
                                            h0=None if h0 is None else t(h0))
    assert row_err(got_h, whole_h.numpy()) <= TOL and row_err(got_y, whole_y.numpy()) <= TOL


def test_ssd_step_matches_reference():
    rng = np.random.default_rng(3)
    q, k, v = normal(rng, 2, 3, 4), normal(rng, 2, 3, 4), normal(rng, 2, 3, 5)
    log_a, h = -np.abs(normal(rng, 2, 3)), normal(rng, 2, 3, 4, 5)
    want = ref_ssm.ssd_step(q, k, v, log_a, h)
    got = port_ssm.ssd_step(t(q), t(k), t(v), t(log_a), t(h))
    for g, w in zip(got, want):
        assert row_err(g, w) <= TOL


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("seq", [1, 2, 7])
def test_causal_conv_matches_reference(seq, with_state):
    rng = np.random.default_rng(seq)
    x, w = normal(rng, 2, seq, 6), normal(rng, 4, 6)
    state = normal(rng, 2, 3, 6) if with_state else None
    want = ref_ssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                None if state is None else jnp.asarray(state))
    got = port_ssm._causal_conv(t(x), t(w), None if state is None else t(state))
    for g, wv in zip(got, want):
        assert row_err(g, wv) <= TOL


def test_ssm_blocks_match_reference():
    """The hybrid family's SSM half over a sequence (train and prefill, the
    state written in place) and a step after it."""
    rc, pc = configs("hymba-1.5b")
    rng = np.random.default_rng(4)
    tree = jax.tree.map(np.asarray, ref_ssm.init_ssm(jax.random.key(4), rc))
    p = {k: t(v) for k, v in tree.items()}
    x, x1 = normal(rng, 2, 11, rc.d_model), normal(rng, 2, 1, rc.d_model)
    ref_train, ref_prefill, ref_decode = (jax.jit(lambda *a, f=f: f(*a[:2], rc, *a[2:]))
                                          for f in (ref_ssm.ssm_train, ref_ssm.ssm_prefill,
                                                    ref_ssm.ssm_decode))
    assert row_err(port_ssm.ssm_train(t(x), p, pc), ref_train(x, tree)) <= TOL
    want, rstate = ref_prefill(x, tree, ref_ssm.init_ssm_state(rc, 2))
    state = port_ssm.init_ssm_state(pc, 2, "cpu")
    got, _ = port_ssm.ssm_prefill(t(x), p, pc, state)
    assert row_err(got, want) <= TOL
    want, rstate = ref_decode(x1, tree, rstate)
    got, _ = port_ssm.ssm_decode(t(x1), p, pc, state)
    assert row_err(got, want) <= TOL
    for g, w in zip(state, rstate):
        assert row_err(g, w) <= TOL


def moe_inputs(capacity_factor, seed=5, seq=64):
    rc = ref_config("qwen3-moe-30b-a3b", reduced=True).replace(
        compute_dtype=jnp.float32, capacity_factor=capacity_factor, n_experts=4)
    pc = get_config("qwen3-moe-30b-a3b", reduced=True).replace(
        compute_dtype=torch.float32, capacity_factor=capacity_factor, n_experts=4)
    tree = jax.tree.map(np.asarray, ref_moe.init_moe(jax.random.key(seed), rc))
    x = normal(np.random.default_rng(seed), 2, seq, rc.d_model)
    return rc, pc, tree, x


@pytest.mark.parametrize("capacity_factor", [0.25, 1.25, 4.0])
def test_moe_layer_matches_reference(capacity_factor):
    """Top-2 of 4 experts over 64 tokens: at capacity factor 0.25 (C = 8 of
    about 32 picks per expert) most pairs are dropped, at 4.0 none."""
    rc, pc, tree, x = moe_inputs(capacity_factor)
    want_y, want_aux = ref_moe.moe_layer(jnp.asarray(x), tree, rc)
    got_y, got_aux = port_moe.moe_layer(t(x), {k: t(v) for k, v in tree.items()}, pc)
    assert row_err(got_y, want_y) <= TOL
    assert float(got_aux) == pytest.approx(float(want_aux), rel=1e-6)
    # how many pairs the capacity drops, the same in both
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", x, tree["router"]))
    ref_idx = np.asarray(jax.lax.top_k(probs, rc.top_k)[1])
    got_idx = torch.topk(torch.softmax(t(x) @ t(tree["router"]), -1), pc.top_k, -1).indices
    assert np.array_equal(got_idx.numpy(), ref_idx)              # lax.top_k's order
    C = port_moe.expert_capacity(pc, x.shape[1])
    pos = port_moe._position_in_expert(got_idx.reshape(2, -1), pc.n_experts)
    dropped = int((pos >= C).sum())
    assert (dropped > 0) == (capacity_factor < 1.0)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "llama4-scout-17b-a16e"])
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("tokens", [1, 7, 192, 4096])
def test_expert_capacity_matches_reference(arch, reduced, tokens):
    assert port_moe.expert_capacity(get_config(arch, reduced=reduced), tokens) == \
        ref_moe.expert_capacity(ref_config(arch, reduced=reduced), tokens)


@pytest.mark.parametrize("n,experts", [(1, 4), (40, 4), (96, 128), (33, 16)])
def test_position_in_expert_matches_reference(n, experts):
    flat = np.random.default_rng(n).integers(0, experts, (3, n))
    want = np.stack([np.asarray(ref_moe._position_in_expert(jnp.asarray(f), experts))
                     for f in flat])
    got = port_moe._position_in_expert(t(flat), experts)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("window,seq", [(4, 8), (4, 16), (8, 24)])
def test_local_attention_matches_reference(window, seq):
    rng = np.random.default_rng(window + seq)
    q, k, v = (normal(rng, 2, seq, 3, 8) for _ in range(3))
    want = ref_attention._local_attention(q, k, v, window, jnp.float32)
    got = port_attention._local_attention(t(q), t(k), t(v), window, torch.float32)
    assert row_err(got, want) <= TOL
    mask = port_attention._causal_mask(seq, seq, window)[None, None]
    masked = port_attention._sdpa(t(q), t(k), t(v), mask, torch.float32)
    assert row_err(got, masked.numpy()) <= TOL


def test_local_attention_model_matches_reference():
    """hymba with ``local_attention`` at S = 2W takes the banded path in
    both packages (and on the kernel route K3's window computes it)."""
    rc, pc = configs("hymba-1.5b")
    rc, pc = rc.replace(local_attention=True), pc.replace(local_attention=True)
    params = rm.init_params(rc, jax.random.key(12))
    pp = lm_params_from_numpy(jax.tree.map(np.asarray, params), pc, device="cpu")
    tokens = np.random.default_rng(12).integers(0, rc.vocab_size, (2, 2 * rc.window))
    assert port_attention._banded(pc, tokens.shape[1], rc.window)
    want = rm.logits_fn(params, rc, {"tokens": jnp.asarray(tokens)})
    assert row_err(pm.logits_fn(pp, pc, {"tokens": t(tokens)}), want) <= TOL


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_blocks_match_reference(kind):
    """mLSTM and sLSTM over a sequence from a given state (written in place)
    and a step after it; the sLSTM stabilizer starts at -1e9 without NaN."""
    rc, pc = configs("xlstm-1.3b")
    init = getattr(ref_xlstm, f"init_{kind}")
    tree = jax.tree.map(np.asarray, init(jax.random.key(6), rc))
    p = {k: t(v) for k, v in tree.items()}
    rng = np.random.default_rng(6)
    x, x1 = normal(rng, 2, 9, rc.d_model), normal(rng, 2, 1, rc.d_model)
    ref_train = getattr(ref_xlstm, f"{kind}_train")
    port_train, port_dec = (getattr(port_xlstm, f"{kind}_{f}") for f in ("train", "decode"))
    ref_dec = jax.jit(lambda xx, pp, st: getattr(ref_xlstm, f"{kind}_decode")(xx, pp, rc, st))
    rstate = getattr(ref_xlstm, f"init_{kind}_state")(rc, 2)
    state = getattr(port_xlstm, f"init_{kind}_state")(pc, 2, "cpu")
    want = jax.jit(lambda xx, pp: ref_train(xx, pp, rc))(x, tree)
    assert row_err(port_train(t(x), p, pc), want) <= TOL
    want, rstate = jax.jit(lambda xx, pp, st: ref_train(xx, pp, rc, state=st, return_state=True))(
        x, tree, rstate)
    got = port_train(t(x), p, pc, state=state)
    assert row_err(got, want) <= TOL and bool(torch.isfinite(got).all())
    want, rstate = ref_dec(x1, tree, rstate)
    got, _ = port_dec(t(x1), p, pc, state)
    assert row_err(got, want) <= TOL
    for g, w in zip(state, rstate):
        assert row_err(g, w) <= TOL


# ---------------------------------------------------------------------------
# The kernel route's wiring, on CPU tensors
# ---------------------------------------------------------------------------

@pytest.fixture
def spied(monkeypatch):
    """Force the kernel route on CPU tensors; record each call of K3's and
    K4's wrappers (whose CPU route is their plain version)."""
    calls = {"K3": [], "K4": []}
    flash, decode = port_attention.ops.flash_attention, port_attention.ops.decode_attention

    def k3(q, k, v, **kw):
        calls["K3"].append(kw)
        return flash(q, k, v, **kw)

    def k4(q, k_cache, v_cache, lengths, **kw):
        calls["K4"].append((k_cache.clone(), lengths.clone()))
        return decode(q, k_cache, v_cache, lengths, **kw)

    monkeypatch.setattr(port_attention.ops, "flash_attention", k3)
    monkeypatch.setattr(port_attention.ops, "decode_attention", k4)
    return calls


def serve(pc, pp, tokens, steps, kernel, monkeypatch):
    monkeypatch.setattr(port_attention, "_kernel_route", lambda x, k: k)
    S = tokens.shape[1]
    cache = pm.init_cache(pc, tokens.shape[0], S + steps, device="cpu")
    logits, cache = pm.prefill_fn(pp, pc, {"tokens": t(tokens)}, cache, kernel=kernel)
    out, caches = [logits], []
    for i in range(steps):
        logits, cache = pm.decode_fn(pp, pc, logits.argmax(-1), S + i, cache, kernel=kernel)
        out.append(logits)
        caches.append(type(cache["kv"])(*(x.clone() for x in cache["kv"])) if "kv" in cache
                      else None)
    return out, caches


@pytest.mark.parametrize("prompt_len", [12, 32, 20])
def test_hybrid_kernel_route_wiring(prompt_len, spied, monkeypatch):
    """K3 gets the layer's window (2048 at full size), once per layer per
    prefill; K4 gets, per layer and step, the ring itself and the count of
    valid slots where those are its first slots (prompts of 12 and 32),
    else the valid slots gathered to the front (20, § 3.9).  Logits equal
    the plain route's."""
    rc, pc = configs("hymba-1.5b")
    assert port_blocks.attn_window(get_config("hymba-1.5b")) == 2048
    pp = pm.init_params(pc, torch.Generator().manual_seed(9), device="cpu")
    tokens = np.random.default_rng(9).integers(0, pc.vocab_size, (2, prompt_len))
    steps = 6
    plain, _ = serve(pc, pp, tokens, steps, False, monkeypatch)
    assert spied == {"K3": [], "K4": []}
    kernel, caches = serve(pc, pp, tokens, steps, True, monkeypatch)
    for a, b in zip(kernel, plain):
        assert row_err(a, b.numpy()) <= TOL
    L, W = pc.n_layers, pc.window
    assert [kw["window"] for kw in spied["K3"]] == [W] * L
    assert all(kw["causal"] for kw in spied["K3"])
    assert len(spied["K4"]) == L * steps
    compacted = 0
    for i, cache in enumerate(caches):
        cur = prompt_len + i
        pos = cache.pos[0]                          # every layer's is the same
        valid = ((pos >= 0) & (pos <= cur) & (pos > cur - W)).numpy()
        n = int(valid.sum())
        assert n == min(cur + 1, W) or prompt_len == 20      # § 3.9 loses positions
        for layer, (k_cache, lengths) in enumerate(spied["K4"][i * L:(i + 1) * L]):
            assert lengths.tolist() == [n, n]
            if valid[:n].all():
                assert torch.equal(k_cache, cache.k[layer])
            else:
                order = np.argsort(~valid, kind="stable")
                assert torch.equal(k_cache, cache.k[layer][:, order])
                compacted += 1
    assert (compacted > 0) == (prompt_len == 20)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "xlstm-1.3b"])
def test_moe_and_xlstm_kernel_route_wiring(arch, spied, monkeypatch):
    """MoE: one K3 call without a window per layer per prefill, one K4 call
    per layer per step over the first cur_len + 1 slots; xLSTM: neither."""
    rc, pc = configs(arch)
    pp = pm.init_params(pc, torch.Generator().manual_seed(10), device="cpu")
    tokens = np.random.default_rng(10).integers(0, pc.vocab_size, (2, 7))
    plain, _ = serve(pc, pp, tokens, 3, False, monkeypatch)
    kernel, _ = serve(pc, pp, tokens, 3, True, monkeypatch)
    for a, b in zip(kernel, plain):
        assert row_err(a, b.numpy()) <= TOL
    if arch.startswith("xlstm"):
        assert spied == {"K3": [], "K4": []}
        return
    assert [kw["window"] for kw in spied["K3"]] == [0] * pc.n_layers
    assert [lengths.tolist() for _, lengths in spied["K4"]] == \
        [[7 + i + 1] * 2 for i in range(3) for _ in range(pc.n_layers)]


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def test_launcher_serves_hymba_as_the_reference(monkeypatch, capsys):
    """``--arch hymba-1.5b --real-tokens --device cpu``: the reduced hymba's
    engines (16-slot rings, prompts up to 32 tokens) serve the reference
    launcher's sessions at its cost, with as many tokens."""
    args = ["--arch", "hymba-1.5b", "--real-tokens", "--slots", "16", "--concurrency", "1.5"]
    monkeypatch.setattr("sys.argv", ["serve"] + args)
    assert ref_serve.main() == 0
    want = capsys.readouterr().out
    assert port_serve.main(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got.rstrip().endswith(" (cpu)") and "tokens=" in got
    assert got.rstrip().removesuffix(" (cpu)") == want.rstrip()
