"""repro_torch's vlm family and encoder-decoder == repro's, on the CPU.

paligemma-3b (vlm: 8 image tokens fused before the text in the reduced
config) and seamless-m4t-large-v2 (the encoder-decoder over audio frames),
each reduced, with the reference's own random weights carried across by
``lm_params_from_numpy``, on token ids and **random** frontend embeddings
made with numpy (zero embeddings would hide a wrong position or a dropped
cross-attention: a zero image token's K and V rows are zero, and zero
frames make the encoder's memory zero).  Against the reference's jit on
the CPU: ``logits_fn``, ``loss_fn`` and every leaf's gradient (against
``jax.grad``), ``prefill_fn`` (the logits and every cache leaf: ``kv``'s k,
v and pos, and ``xk``, ``xv``) and four ``decode_fn`` steps fed the same
tokens.  Each row (the last axis; a KV row is one slot of every kv head)
within ``tol * max|ref row|``: tol 1e-4 with float32 compute and cache, 2e-2
in bf16 (the tolerances of ``tests/test_torch_models.py``).  A float32
gradient is held within 1e-4 of its leaf's largest |g|.  Two bf16
computations that round at other places (the reference's XLA keeps excess
precision across fused ops) part by up to 4e-2 of a leaf's largest |g|,
and seamless's bf16 decode steps (an encoder and cross-attention more
than the other families) by up to 2.5e-2 of a row's largest logit, each
as far from the float32 model as the other; so in bf16 the gradients and
the decode steps' logits are held as the served bf16 logits are on the
card: the port's largest distance to the reference's float32 values at
most ``BF16_SLACK`` times the reference's bf16 values' own.  At float32 the
greedy tokens must be equal.

Then the parts one by one (the bidirectional ``attention_train``,
``cross_attention`` at equal and unequal lengths, ``_cached_cross``,
``encode``, ``_embed_inputs``), K3's plain version at S_q != S_kv, the
engine and the serve and train launchers, the reference's overflowing vlm
cache (ROADMAP.md § 3.10) with K4's ``lengths`` against the mask at every
step, the kernel route's wiring (spies on ``ops``) and the parameter counts
at full size.
"""
import importlib

import numpy as np
import pytest

# The port's tests need torch.  CI's jax-only tier-1 job installs no torch,
# so there these files skip instead of failing at import.
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models as rm  # noqa: E402
import repro.models.attention as ref_attention  # noqa: E402
import repro.models.encdec as ref_encdec  # noqa: E402
import repro.models.transformer as ref_transformer  # noqa: E402
import repro_torch.models as pm  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import list_archs as ref_archs  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.serving import InferenceEngine as RefEngine  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.models import attention as port_attention  # noqa: E402
from repro_torch.models import encdec as port_encdec  # noqa: E402
from repro_torch.models import transformer as port_transformer  # noqa: E402
from repro_torch.serving import InferenceEngine  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_paths  # noqa: E402

# ``repro_torch.kernels`` re-exports the wrapper over the module's name
k3 = importlib.import_module("repro_torch.kernels.flash_attention")

ARCHS = ("paligemma-3b", "seamless-m4t-large-v2")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: bf16 gradients: the port's distance to the float32 gradients over the
#: reference's (``chip_smoke.py``'s rule for the bf16 routes)
BF16_SLACK = 1.25
B, S, SLOTS, STEPS = 2, 12, 32, 4
#: parameters at full size (the reference's ``abstract_params`` leaf sums)
FULL_PARAMS = {"paligemma-3b": 2_512_857_088, "seamless-m4t-large-v2": 1_773_477_888}


def port_cfg(arch, dtype):
    cfg = get_config(arch, reduced=True).replace(remat="none")
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
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def t(a):
    return torch.as_tensor(np.array(a))


def row_err(got, want):
    """Largest |got - want| of each row (last axis) over that row's largest
    |want|, at most over all rows; rows of zeros must match exactly."""
    got, want = as_np(got).astype(np.float64), as_np(want).astype(np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max(-1)
    scale = np.abs(want).max(-1)
    assert (err[scale == 0] == 0).all()
    return float((err / np.where(scale == 0, 1.0, scale)).max())


def frontend_rows(cfg, seq):
    """Rows of the modality stub: the image tokens, or one frame per token."""
    return cfg.n_frontend_tokens if cfg.frontend == "vision_stub" else seq


def prefix_len(cfg, seq):
    """Positions a prefill of ``seq`` text tokens fills in the self cache."""
    return seq + (cfg.n_frontend_tokens if cfg.frontend == "vision_stub" else 0)


def inputs(cfg, seed, batch=B, seq=S, frames=None):
    """Token ids and random frontend embeddings (float32) from ``seed``."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    rows = frames if frames is not None else frontend_rows(cfg, seq)
    return tokens, rng.standard_normal((batch, rows, cfg.d_model)).astype(np.float32)


def batches(tokens, frontend):
    return ({"tokens": jnp.asarray(tokens), "frontend": jnp.asarray(frontend)},
            {"tokens": t(tokens), "frontend": t(frontend)})


def check_cache(got, want, tol, what):
    """Every leaf: ``kv``'s pos equal and its k, v per slot; ``xk`` and
    ``xv`` (the encoder-decoder's cross K/V) per row."""
    assert set(got) == set(want), what
    kv, rkv = got["kv"], want["kv"]
    assert np.array_equal(kv.pos.numpy(), np.asarray(rkv.pos)), what
    for field in ("k", "v"):
        g, w = getattr(kv, field), np.asarray(getattr(rkv, field))
        assert g.dtype == kv.k.dtype and tuple(g.shape) == w.shape, what
        assert row_err(g.flatten(-2), w.reshape(*w.shape[:-2], -1)) <= tol, f"{what} {field}"
    for field in ("xk", "xv"):
        if field in want:
            assert tuple(got[field].shape) == want[field].shape, what
            assert row_err(got[field], want[field]) <= tol, f"{what} {field}"


def cache_copy(cache):
    return {k: type(v)(*(x.clone() for x in v)) if isinstance(v, tuple) else v.clone()
            for k, v in cache.items()}


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS for d in TOL],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    """One config through both packages on the same weights and inputs."""
    arch, dtype = request.param
    rc, pc = ref_cfg(arch, dtype), port_cfg(arch, dtype)
    params = rm.init_params(rc, jax.random.key(7))
    pp = lm_params_from_numpy(jax.tree.map(np.asarray, params), pc, device="cpu")
    tokens, frontend = inputs(rc, 1)
    rb, pb = batches(tokens, frontend)
    out = {"arch": arch, "dtype": dtype, "rc": rc, "pc": pc}
    out["logits"] = (jax.jit(lambda p, b: rm.logits_fn(p, rc, b))(params, rb),
                     pm.logits_fn(pp, pc, pb))
    def ref_grads(cfg):
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p, b: rm.loss_fn(p, cfg, b), has_aux=True))(params, rb)
        return loss, metrics, tree_leaves(lm_params_from_numpy(
            jax.tree.map(np.asarray, grads), pc, device="cpu"))

    loss, metrics, grads = ref_grads(rc)
    grads32 = grads if dtype == "float32" else ref_grads(ref_cfg(arch, "float32"))[2]
    for leaf in tree_leaves(pp):
        leaf.requires_grad_(True)
    port_loss, port_metrics = pm.loss_fn(pp, pc, pb, kernel=False)
    port_loss.backward()
    out["loss"] = (float(loss), float(metrics["ce"]), float(port_loss),
                   float(port_metrics["ce"]), float(port_metrics["aux"]))
    out["grads"] = (tree_paths(pp), [leaf.grad for leaf in tree_leaves(pp)], grads, grads32)
    for leaf in tree_leaves(pp):
        leaf.requires_grad_(False)

    with torch.no_grad():
        rcache = rm.init_cache(rc, B, SLOTS, src_len=S)
        rlog, rcache = jax.jit(lambda p, b, c: rm.prefill_fn(p, rc, b, c))(params, rb, rcache)
        pcache = pm.init_cache(pc, B, SLOTS, src_len=S, device="cpu")
        plog, pcache = pm.prefill_fn(pp, pc, pb, pcache)
        out["prefill"] = (rlog, plog, jax.tree.map(np.asarray, rcache), cache_copy(pcache))
        decode = jax.jit(lambda p, tk, n, c: rm.decode_fn(p, rc, tk, n, c))
        steps, prefix = [], prefix_len(pc, S)
        for i in range(STEPS):
            tok = np.array(jnp.argmax(rlog, axis=-1), np.int32)      # the reference's picks
            port_tok = plog.argmax(-1).to(torch.int32).numpy()
            rlog, rcache = decode(params, jnp.asarray(tok), jnp.int32(prefix + i), rcache)
            plog, pcache = pm.decode_fn(pp, pc, t(tok), prefix + i, pcache)
            steps.append((tok, port_tok, rlog, plog))
        out["decode"] = steps
        out["decode_f32"] = f32_steps(arch, params, rb, [tok for tok, _, _, _ in steps])
        out["final_cache"] = (jax.tree.map(np.asarray, rcache), pcache)
    return out


def f32_steps(arch, params, batch, fed):
    """The reference's float32 model on ``params``: the prefill's logits,
    then each decode step's, fed ``fed``."""
    rc = ref_cfg(arch, "float32")
    cache = rm.init_cache(rc, B, SLOTS, src_len=S)
    logits, cache = jax.jit(lambda p, b, c: rm.prefill_fn(p, rc, b, c))(params, batch, cache)
    out = [logits]
    decode = jax.jit(lambda p, tk, n, c: rm.decode_fn(p, rc, tk, n, c))
    for i, tok in enumerate(fed):
        logits, cache = decode(params, jnp.asarray(tok), jnp.int32(prefix_len(rc, S) + i),
                               cache)
        out.append(logits)
    return out


def test_every_reference_arch_is_registered():
    assert list_archs() == sorted(ref_archs())
    for arch in ARCHS:
        for reduced in (False, True):
            got, want = get_config(arch, reduced=reduced), ref_config(arch, reduced=reduced)
            for field in want.__dataclass_fields__:
                if not field.endswith("dtype"):
                    assert getattr(got, field) == getattr(want, field), (arch, field)


def test_logits_match_reference(pair):
    want, got = pair["logits"]
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert row_err(got, want) <= TOL[pair["dtype"]]


def test_loss_matches_reference(pair):
    loss, ce, got, got_ce, aux = pair["loss"]
    assert abs(got - loss) <= TOL[pair["dtype"]] * abs(loss)
    assert abs(got_ce - ce) <= TOL[pair["dtype"]] * abs(ce)
    assert aux == 0.0


def test_grads_match_reference(pair):
    paths, got, want, want32 = pair["grads"]
    assert len(got) == len(want) == len(want32) > 0
    to_f32 = {"port": 0.0, "reference": 0.0}
    for path, g, w, w32 in zip(paths, got, want, want32):
        assert g is not None and tuple(g.shape) == tuple(w.shape), path
        scale = float(w32.abs().max())
        assert scale > 0, path
        if pair["dtype"] == "float32":
            assert float((g - w).abs().max()) <= TOL["float32"] * scale, path
        for name, x in (("port", g), ("reference", w)):
            to_f32[name] = max(to_f32[name], float((x.float() - w32).abs().max()) / scale)
    print(f"{pair['arch']} {pair['dtype']} gradients from the float32 reference's: {to_f32}")
    assert to_f32["port"] <= BF16_SLACK * to_f32["reference"] + TOL["float32"]


def test_prefill_matches_reference(pair):
    rlog, plog, rcache, pcache = pair["prefill"]
    tol = TOL[pair["dtype"]]
    assert row_err(plog, rlog) <= tol
    assert pcache["kv"].k.dtype == pair["pc"].kv_cache_dtype
    check_cache(pcache, rcache, tol, "prefill")
    n_valid = prefix_len(pair["pc"], S)
    assert (pcache["kv"].pos[:, :n_valid] >= 0).all() and (pcache["kv"].pos[:, n_valid:] < 0).all()


def test_decode_matches_reference(pair):
    tol = TOL[pair["dtype"]]
    to_f32 = {"port": 0.0, "reference": 0.0}
    for (tok, port_tok, rlog, plog), rlog32 in zip(pair["decode"], pair["decode_f32"][1:]):
        if pair["dtype"] == "float32":
            assert row_err(plog, rlog) <= tol
            assert np.array_equal(port_tok, tok)
        to_f32["port"] = max(to_f32["port"], row_err(plog, rlog32))
        to_f32["reference"] = max(to_f32["reference"], row_err(rlog, rlog32))
    print(f"{pair['arch']} {pair['dtype']} decode steps from the float32 reference's: {to_f32}")
    assert to_f32["port"] <= BF16_SLACK * to_f32["reference"] + TOL["float32"]
    rcache, pcache = pair["final_cache"]
    check_cache(pcache, rcache, tol, "after the decode steps")


# ---------------------------------------------------------------------------
# The parts, one by one, in float32
# ---------------------------------------------------------------------------

F32 = {"compute_dtype": torch.float32, "kv_cache_dtype": torch.float32}


def configs(arch):
    return ref_cfg(arch, "float32"), port_cfg(arch, "float32")


def weights(arch, seed=3):
    rc, pc = configs(arch)
    params = rm.init_params(rc, jax.random.key(seed))
    return rc, pc, params, lm_params_from_numpy(jax.tree.map(np.asarray, params), pc,
                                                device="cpu")


def normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_bidirectional_attention_matches_reference():
    rc, pc, params, pp = weights("seamless-m4t-large-v2")
    rng = np.random.default_rng(11)
    x = normal(rng, B, S, pc.d_model)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    p = jax.tree.map(lambda a: a[0], params["encoder"]["attn"])
    want = ref_attention.attention_train(jnp.asarray(x), p, rc, jnp.asarray(pos),
                                         bidirectional=True)
    got = port_attention.attention_train(t(x), pp["encoder"][0]["attn"], pc, t(pos),
                                         bidirectional=True)
    assert row_err(got, want) <= TOL["float32"]
    causal = port_attention.attention_train(t(x), pp["encoder"][0]["attn"], pc, t(pos))
    assert row_err(causal, want) > 1e-2          # the mask matters on these inputs


@pytest.mark.parametrize("s_src", [S, S + 5, 3])
def test_cross_attention_matches_reference(s_src):
    rc, pc, params, pp = weights("seamless-m4t-large-v2")
    rng = np.random.default_rng(s_src)
    x, memory = normal(rng, B, S, pc.d_model), normal(rng, B, s_src, pc.d_model)
    p = jax.tree.map(lambda a: a[1], params["decoder"]["xattn"])
    want = ref_attention.cross_attention(jnp.asarray(x), jnp.asarray(memory), p, rc)
    got = port_attention.cross_attention(t(x), t(memory), pp["decoder"][1]["xattn"], pc)
    assert row_err(got, want) <= TOL["float32"]


def test_cached_cross_matches_reference():
    rc, pc, params, pp = weights("seamless-m4t-large-v2")
    rng = np.random.default_rng(12)
    x = normal(rng, B, 1, pc.d_model)
    xk, xv = (normal(rng, B, 9, pc.n_kv_heads, pc.head_dim) for _ in range(2))
    p = jax.tree.map(lambda a: a[0], params["decoder"]["xattn"])
    want = ref_encdec._cached_cross(jnp.asarray(x), jnp.asarray(xk), jnp.asarray(xv), p, rc)
    got = port_encdec._cached_cross(t(x), t(xk), t(xv), pp["decoder"][0]["xattn"], pc)
    assert row_err(got, want) <= TOL["float32"]


def test_encode_matches_reference():
    rc, pc, params, pp = weights("seamless-m4t-large-v2")
    frames = normal(np.random.default_rng(13), B, 10, pc.d_model)
    want = jax.jit(lambda p, f: ref_encdec.encode(p, rc, f))(params, jnp.asarray(frames))
    got = port_encdec.encode(pp, pc, t(frames))
    assert row_err(got, want) <= TOL["float32"]


def test_embed_inputs_fuses_the_frontend_first():
    rc, pc, params, pp = weights("paligemma-3b")
    tokens, frontend = inputs(pc, 14)
    rb, pb = batches(tokens, frontend)
    want = ref_transformer._embed_inputs(params, rc, rb)
    got = port_transformer._embed_inputs(pp, pc, pb)
    nf = pc.n_frontend_tokens
    assert tuple(got.shape) == (B, nf + S, pc.d_model) == want.shape
    assert row_err(got, want) <= TOL["float32"]
    assert torch.equal(got[:, nf:], pp["embed"][t(tokens).long()])


# ---------------------------------------------------------------------------
# K3's plain version with a key length of its own
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd,heads,s_q,s_kv", [(64, (4, 4), 7, 12), (256, (8, 1), 12, 5),
                                               (64, (6, 2), 9, 9)])
def test_flash_plain_at_unequal_lengths_matches_reference(hd, heads, s_q, s_kv):
    """``flash_attention_plain`` with S_kv keys against the reference's
    ``cross_attention`` core (``_sdpa`` over an all-true mask, KV expanded);
    ``flash_attention`` takes the same on the CPU, and refuses unequal
    lengths under a mask."""
    H, KVH = heads
    rng = np.random.default_rng(hd + s_kv)
    q, k, v = normal(rng, B, s_q, H, hd), normal(rng, B, s_kv, KVH, hd), \
        normal(rng, B, s_kv, KVH, hd)
    mask = jnp.ones((1, 1, s_q, s_kv), dtype=bool)
    want = ref_attention._sdpa(jnp.asarray(q), ref_attention._expand_kv(jnp.asarray(k), H),
                               ref_attention._expand_kv(jnp.asarray(v), H), mask, jnp.float32)
    got = k3.flash_attention_plain(t(q), t(k), t(v), causal=False)
    assert row_err(got, want) <= 2e-5
    assert torch.equal(k3.flash_attention(t(q), t(k), t(v), causal=False), got)
    if s_q != s_kv:
        for kw in ({"causal": True}, {"causal": False, "window": 4}):
            with pytest.raises(ValueError, match="as many keys as queries"):
                k3.flash_attention(t(q), t(k), t(v), **kw)
        with pytest.raises(ValueError, match="multiple of the blocks"):
            k3.flash_attention(t(q), t(k), t(v), causal=False, block_k=s_kv - 1)


# ---------------------------------------------------------------------------
# The engine and the launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_match_reference(arch):
    """The reference's zero frontends, float32: the same greedy tokens."""
    rc, pc, params, pp = weights(arch, seed=4)
    prompt = np.random.default_rng(4).integers(0, rc.vocab_size, (3, 9)).astype(np.int32)
    want = RefEngine(rc, params, max_batch=4, max_seq=40).generate(prompt, 8)
    got = InferenceEngine(pc, pp, max_batch=4, max_seq=40, device="cpu").generate(prompt, 8)
    assert got.prefill_len == want.prefill_len == 9
    assert np.array_equal(got.tokens, want.tokens)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_frontend_feeds_the_model(arch):
    """``_generate(frontend=...)`` is ``prefill_fn`` and ``decode_fn`` on
    that batch, at the positions after the image tokens."""
    _, pc, _, pp = weights(arch, seed=5)
    tokens, frontend = inputs(pc, 5, batch=2, seq=6)
    eng = InferenceEngine(pc, pp, max_batch=2, max_seq=16, device="cpu")
    picks, logits = eng._generate(tokens, 4, keep_logits=True, frontend=t(frontend))
    cache = pm.init_cache(pc, 2, 16, src_len=6, device="cpu")
    want, cache = pm.prefill_fn(pp, pc, batches(tokens, frontend)[1], cache)
    for i in range(4):
        assert torch.equal(logits[i], want)
        if i < 3:
            want, cache = pm.decode_fn(pp, pc, t(picks[:, i]), prefix_len(pc, 6) + i, cache)
    _, zeros = eng._generate(tokens, 4, keep_logits=True)
    assert row_err(zeros[0], logits[0]) > 1e-3


def test_launcher_serves_paligemma_as_the_reference(monkeypatch, capsys):
    """``--arch paligemma-3b --real-tokens --device cpu``: the reduced
    paligemma's 96-slot engines serve the reference launcher's sessions at
    its cost, with as many tokens."""
    args = ["--arch", "paligemma-3b", "--real-tokens", "--slots", "16", "--concurrency", "1.5"]
    monkeypatch.setattr("sys.argv", ["serve"] + args)
    assert ref_serve.main() == 0
    want = capsys.readouterr().out
    assert port_serve.main(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got.rstrip().endswith(" (cpu)") and "tokens=" in got
    assert got.rstrip().removesuffix(" (cpu)") == want.rstrip()


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_trains_both(arch, tmp_path, capsys):
    assert port_train.main(["--arch", arch, "--device", "cpu", "--steps", "2", "--batch", "2",
                            "--seq", "16", "--ckpt-dir", str(tmp_path)]) == 0
    loss = float(capsys.readouterr().out.split("final loss:")[1].split("@")[0])
    assert np.isfinite(loss) and loss > 0


# ---------------------------------------------------------------------------
# The overflowing vlm cache (ROADMAP.md § 3.10)
# ---------------------------------------------------------------------------

OVERFLOW_SLOTS = 16


@pytest.fixture(scope="module")
def paligemma():
    return weights("paligemma-3b", seed=15)


def overflow_run(paligemma, prompt_len, n_new, slots, kernel=False, spy=None):
    """The engine's stream through both packages' ``prefill_fn`` and
    ``decode_fn`` on random image embeddings, fed the reference's picks:
    per step the reference's logits, the port's, both caches; and the
    port's ``logits_fn`` over the whole sequence."""
    rc, pc, params, pp = paligemma
    tokens, frontend = inputs(pc, prompt_len, seq=prompt_len)
    rb, pb = batches(tokens, frontend)
    nf = pc.n_frontend_tokens
    rcache = rm.init_cache(rc, B, slots)
    rlog, rcache = jax.jit(lambda p, b, c: rm.prefill_fn(p, rc, b, c))(params, rb, rcache)
    pcache = pm.init_cache(pc, B, slots, device="cpu")
    plog, pcache = pm.prefill_fn(pp, pc, pb, pcache, kernel=kernel)
    steps = [(rlog, plog, jax.tree.map(np.asarray, rcache), cache_copy(pcache))]
    fed = [tokens]
    decode = jax.jit(lambda p, tk, n, c: rm.decode_fn(p, rc, tk, n, c))
    for i in range(n_new - 1):
        tok = np.array(jnp.argmax(rlog, axis=-1), np.int32)
        fed.append(tok[:, None])
        cur = nf + prompt_len + i
        rlog, rcache = decode(params, jnp.asarray(tok), jnp.int32(cur), rcache)
        plog, pcache = pm.decode_fn(pp, pc, t(tok), cur, pcache, kernel=kernel)
        steps.append((rlog, plog, jax.tree.map(np.asarray, rcache), cache_copy(pcache)))
        if spy is not None:
            spy(cur, pcache["kv"].pos)
    full = pm.logits_fn(pp, pc, {"tokens": t(np.concatenate(fed, axis=1)),
                                 "frontend": t(frontend)}, kernel=False)
    dist = [row_err(plog, full[:, nf + prompt_len - 1 + i])
            for i, (_, plog, _, _) in enumerate(steps)]
    return steps, dist


def test_reference_vlm_cache_overflow_fault_reproduced(paligemma):
    """ROADMAP.md § 3.10.  The engine admits a stream when prompt + new
    tokens fit ``max_seq``, but the prefill puts the 8 image tokens first:
    8 + 8 prompt + 8 new into 16 slots, and 8 + 12 + 4.  The reference's
    full-attention cache then keeps only the last 16 positions and its
    decode steps overwrite slot ``cur_len % 16``.  The port equals the
    reference on every step (logits, k, v and pos); the prefills are right,
    and the decode steps part from ``logits_fn`` over the whole sequence.
    The same stream into 32 slots equals it."""
    for prompt_len, n_new in ((8, 8), (12, 4)):
        steps, dist = overflow_run(paligemma, prompt_len, n_new, OVERFLOW_SLOTS)
        for rlog, plog, rcache, pcache in steps:
            assert row_err(plog, rlog) <= TOL["float32"]
            check_cache(pcache, rcache, TOL["float32"], f"prompt {prompt_len}")
        nf = paligemma[1].n_frontend_tokens
        first = steps[0][3]["kv"].pos[0].numpy()
        assert np.array_equal(first, np.arange(nf + prompt_len - OVERFLOW_SLOTS,
                                               nf + prompt_len))
        print(f"prompt {prompt_len} + {n_new} new into {OVERFLOW_SLOTS} slots: prefill "
              f"{dist[0]:.2e} from the whole forward, decode steps "
              f"{min(dist[1:]):.2f} to {max(dist[1:]):.2f}")
        assert dist[0] <= TOL["float32"]
        assert min(dist[1:]) > 0.05
    steps, dist = overflow_run(paligemma, 8, 8, 2 * OVERFLOW_SLOTS)
    print(f"prompt 8 + 8 new into {2 * OVERFLOW_SLOTS} slots: {max(dist):.2e}")
    assert max(dist) <= TOL["float32"]


@pytest.fixture
def spied(monkeypatch):
    """Force the kernel route on CPU tensors; record each call of K3's and
    K4's wrappers (whose CPU route is their plain version)."""
    calls = {"K3": [], "K4": []}
    flash, decode = port_attention.ops.flash_attention, port_attention.ops.decode_attention

    def k3_spy(q, k, v, **kw):
        calls["K3"].append(dict(kw, s_q=q.shape[1], s_kv=k.shape[1]))
        return flash(q, k, v, **kw)

    def k4_spy(q, k_cache, v_cache, lengths, **kw):
        calls["K4"].append((k_cache.shape[1], lengths.tolist()))
        return decode(q, k_cache, v_cache, lengths, **kw)

    monkeypatch.setattr(port_attention.ops, "flash_attention", k3_spy)
    monkeypatch.setattr(port_attention.ops, "decode_attention", k4_spy)
    for module in (port_attention, port_encdec):
        monkeypatch.setattr(module, "_kernel_route", lambda x, kernel: kernel)
    return calls


@pytest.mark.parametrize("prompt_len,n_new,slots", [(8, 8, 16), (12, 4, 16), (2, 12, 16),
                                                    (8, 8, 32)])
def test_overflow_decode_k4_lengths_are_the_mask(paligemma, spied, prompt_len, n_new, slots):
    """On the kernel route each full-attention layer's decode step asks K4
    for the first ``min(cur_len + 1, cache_len)`` slots: at every step of
    the streams (overflowing from the prefill, wrapping during the decode,
    and fitting) that count is the mask's, and the mask is that prefix.
    The logits equal the reference's."""
    L = paligemma[1].n_layers
    seen = []

    def check_mask(cur, pos):
        mask = ((pos >= 0) & (pos <= cur)).numpy()           # every layer's is the same
        n = int(mask[0].sum())
        assert mask[:, :n].all() and n == min(cur + 1, slots)
        seen.append(n)

    steps, _ = overflow_run(paligemma, prompt_len, n_new, slots, kernel=True, spy=check_mask)
    for rlog, plog, _, _ in steps:
        assert row_err(plog, rlog) <= TOL["float32"]
    assert [c for c in spied["K3"]] == [{"causal": True, "window": 0, "block_q": 8 + prompt_len,
                                         "block_k": 8 + prompt_len, "s_q": 8 + prompt_len,
                                         "s_kv": 8 + prompt_len}] * L
    assert spied["K4"] == [(slots, [n, n]) for n in seen for _ in range(L)]


def test_encdec_kernel_route_wiring(spied):
    """The encoder asks K3 for ``causal=False`` over its frames, the
    decoder's self-attention for causal, its cross-attention for
    ``causal=False`` with the memory's S_kv keys (S - 1 tokens over S
    frames); a decode step asks K4 for the self cache's cur_len + 1 slots
    and for the cross cache's S rows.  Logits equal the einsum route's."""
    _, pc, _, pp = weights("seamless-m4t-large-v2", seed=16)
    tokens, frames = inputs(pc, 16, seq=S - 1, frames=S)
    pb = batches(tokens, frames)[1]
    routes = []
    for kernel in (False, True):
        cache = pm.init_cache(pc, B, SLOTS, src_len=S, device="cpu")
        logits, cache = pm.prefill_fn(pp, pc, pb, cache, kernel=kernel)
        out = [logits]
        for i in range(3):
            logits, cache = pm.decode_fn(pp, pc, out[-1].argmax(-1), S - 1 + i, cache,
                                         kernel=kernel)
            out.append(logits)
        routes.append(out)
    for a, b in zip(*routes):
        assert row_err(a, b) <= TOL["float32"]
    enc = [dict(causal=False, block_q=S, block_k=S, s_q=S, s_kv=S)] * pc.n_enc_layers
    dec = [dict(causal=True, window=0, block_q=S - 1, block_k=S - 1, s_q=S - 1, s_kv=S - 1),
           dict(causal=False, block_q=S - 1, block_k=S, s_q=S - 1, s_kv=S)] * pc.n_dec_layers
    assert spied["K3"] == enc + dec
    assert spied["K4"] == [k4 for i in range(3)
                           for k4 in [(SLOTS, [S + i] * B), (S, [S] * B)] * pc.n_dec_layers]


def test_vlm_kernel_route_loss_under_no_grad(spied):
    """``loss_fn`` on the kernel route (no grad): one causal K3 call per
    layer over [image | text], the einsum route's loss."""
    _, pc, _, pp = weights("paligemma-3b", seed=17)
    tokens, frontend = inputs(pc, 17)
    pb = batches(tokens, frontend)[1]
    with torch.no_grad():
        got, _ = pm.loss_fn(pp, pc, pb, kernel=True)
        want, _ = pm.loss_fn(pp, pc, pb, kernel=False)
    assert len(spied["K3"]) == pc.n_layers
    assert all(c["causal"] and c["s_q"] == c["s_kv"] == 8 + S for c in spied["K3"])
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_at_full_size(arch):
    """From the shapes alone, without allocating: the reference's counts,
    with seamless's one token table; at the reduced size, the leaves that
    ``init_params`` draws."""
    cfg = get_config(arch)
    assert pm.param_count(cfg) == FULL_PARAMS[arch] == rm.param_count(ref_config(arch))
    assert pm.active_param_count(cfg) == FULL_PARAMS[arch]
    assert pm.embedding_param_count(cfg) == rm.embedding_param_count(ref_config(arch)) == \
        cfg.vocab_size * cfg.d_model
    small = get_config(arch, reduced=True)
    params = pm.init_params(small, torch.Generator().manual_seed(0), device="cpu")
    assert sum(x.numel() for x in tree_leaves(params)) == pm.param_count(small)
    ref = rm.init_params(ref_config(arch, reduced=True), jax.random.key(0))
    assert sorted(tree_paths(lm_params_from_numpy(jax.tree.map(np.asarray, ref), small,
                                                  device="cpu"))) == sorted(tree_paths(params))
