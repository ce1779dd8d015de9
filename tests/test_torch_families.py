"""repro_torch's hybrid, moe and ssm families == repro's, on the CPU.

hymba-1.5b (hybrid), qwen3-moe-30b-a3b and llama4-scout-17b-a16e (moe) and
xlstm-1.3b (ssm), each reduced, run with the reference's own random weights
carried across by ``lm_params_from_numpy``, on token ids made with numpy:
``logits_fn``, ``loss_fn`` (loss, ce and aux), ``prefill_fn`` (the logits
and every cache leaf) and four ``decode_fn`` steps fed the same tokens,
against the reference's jit on the CPU.  Each output row must be within
``tol * max|ref row|``: tol 1e-4 with float32 compute and cache, 2e-2 in
bf16 (the tolerances of ``tests/test_torch_models.py``).  A logits row is
the last axis; a KV-cache row is one slot (every kv head's K or V of one
position, sequence and layer: the reduced configs' heads hold 16 values,
too few for a row's largest one to set the scale); a recurrent state (the
SSM's ``h`` and ``conv``, mLSTM's ``h``, sLSTM's ``c``, ``n``, ``m``,
``y``) is compared per layer and sequence, flattened: its elements are sums
with cancellation, so one element's error is measured against the state's
scale.  At float32 the greedy tokens must be equal.

MoE in bf16: the router reads its input in float32, but that input comes
out of bf16 layers that the two packages round at other places, so a token
whose top-k margin is below that rounding can pick another expert, which
moves its output by a whole expert.  Both packages' picks are recorded (a
spy on each ``moe_layer``; ``jax.debug.callback`` inside the reference's
jit), and the flips are counted and printed: a row of a sequence is held to
the tolerance up to the first position at which any of its tokens picked
another expert set in any layer, and not past it.  In float32 no flip is
allowed.
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

ARCHS = ("hymba-1.5b", "qwen3-moe-30b-a3b", "llama4-scout-17b-a16e", "xlstm-1.3b")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
B, S, SLOTS, STEPS = 2, 12, 20, 4
#: cache leaves compared per layer and sequence (recurrent states)
STATES = {"ssm", "mlstm", "slstm"}
NO_FLIP = np.full(B, np.inf)


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


def row_errs(got, want):
    """|got - want| of each row (last axis) over that row's largest |want|;
    rows of zeros must match exactly."""
    got, want = as_np(got).astype(np.float64), as_np(want).astype(np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max(-1)
    scale = np.abs(want).max(-1)
    assert (err[scale == 0] == 0).all()
    return err / np.where(scale == 0, 1.0, scale)


class Routing:
    """Both packages' top-k picks, one (B, S, K) array per MoE layer call."""

    def __init__(self):
        self.ref, self.port = [], []

    def take(self):
        """The first position of each sequence at which the two packages'
        expert sets differ in any layer since the last call (inf where none),
        and the number of (layer, token) flips."""
        assert len(self.ref) == len(self.port)
        first, flips = NO_FLIP.copy(), 0
        for r, p in zip(self.ref, self.port):
            diff = (np.sort(r, -1) != np.sort(p, -1)).any(-1)        # (B, S)
            flips += int(diff.sum())
            for b in range(B):
                if diff[b].any():
                    first[b] = min(first[b], np.argmax(diff[b]))
        self.ref.clear()
        self.port.clear()
        return first, flips


def spy_routing(mp, routing):
    """Record every MoE layer's picks in both packages."""
    ref_moe, port_moe = ref_blocks.moe_layer, port_blocks.moe_layer

    def ref_spy(x, p, cfg):
        probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", x.astype(jnp.float32), p["router"]))
        jax.debug.callback(lambda idx: routing.ref.append(np.asarray(idx)),
                           jax.lax.top_k(probs, cfg.top_k)[1], ordered=True)
        return ref_moe(x, p, cfg)

    def port_spy(x, p, cfg):
        probs = torch.softmax(torch.matmul(x.float(), p["router"]), dim=-1)
        routing.port.append(torch.topk(probs, cfg.top_k, dim=-1).indices.numpy())
        return port_moe(x, p, cfg)

    mp.setattr(ref_blocks, "moe_layer", ref_spy)
    mp.setattr(port_blocks, "moe_layer", port_spy)


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS for d in TOL],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    """One config through both packages: the reference's outputs, the
    port's on the same weights, and where the MoE routing flipped."""
    arch, dtype = request.param
    rc, pc = ref_cfg(arch, dtype), port_cfg(arch, dtype)
    params = rm.init_params(rc, jax.random.key(7))
    pp = lm_params_from_numpy(jax.tree.map(np.asarray, params), pc, device="cpu")
    tokens = np.random.default_rng(1).integers(0, rc.vocab_size, (B, S)).astype(np.int32)
    out = {"arch": arch, "dtype": dtype, "rc": rc, "pc": pc}
    routing = Routing()
    with pytest.MonkeyPatch.context() as mp:
        spy_routing(mp, routing)
        batch = {"tokens": jnp.asarray(tokens)}
        out["ref_logits"] = jax.jit(lambda p, b: rm.logits_fn(p, rc, b))(params, batch)
        out["ref_loss"] = jax.jit(lambda p, b: rm.loss_fn(p, rc, b))(params, batch)
        jax.effects_barrier()
        routing.ref = routing.ref[:len(routing.ref) // 2]       # the loss's own pass
        out["port_logits"] = pm.logits_fn(pp, pc, {"tokens": torch.as_tensor(tokens)})
        out["port_loss"] = pm.loss_fn(pp, pc, {"tokens": torch.as_tensor(tokens)})
        routing.port = routing.port[:len(routing.port) // 2]
        out["logits_flips"] = routing.take()

        rcache = rm.init_cache(rc, B, SLOTS)
        rlog, rcache = jax.jit(lambda p, b, c: rm.prefill_fn(p, rc, b, c))(params, batch, rcache)
        pcache = pm.init_cache(pc, B, SLOTS, device="cpu")
        plog, pcache = pm.prefill_fn(pp, pc, {"tokens": torch.as_tensor(tokens)}, pcache)
        jax.effects_barrier()
        out["prefill"] = (rlog, plog, jax.tree.map(np.asarray, rcache),
                          {k: type(v)(*(x.clone() for x in v)) for k, v in pcache.items()},
                          routing.take())

        decode = jax.jit(lambda p, t, n, c: rm.decode_fn(p, rc, t, n, c))
        steps = []
        for i in range(STEPS):
            tok = np.array(jnp.argmax(rlog, axis=-1), np.int32)   # the reference's picks
            port_tok = plog.argmax(-1).to(torch.int32).numpy()
            rlog, rcache = decode(params, jnp.asarray(tok), jnp.int32(S + i), rcache)
            plog, pcache = pm.decode_fn(pp, pc, torch.as_tensor(tok), S + i, pcache)
            jax.effects_barrier()
            steps.append((tok, port_tok, rlog, plog, routing.take()))
        out["decode"] = steps
        out["final_cache"] = (jax.tree.map(np.asarray, rcache), pcache)
    return out


def held(errs, first_flip, tol, what):
    """``errs`` (B, ...) within ``tol`` for every sequence, at positions
    (second axis, when there is one) before its first routing flip."""
    errs = np.asarray(errs)
    for b in range(B):
        e = errs[b] if errs.ndim == 1 else errs[b, :int(min(first_flip[b], errs.shape[1]))]
        if errs.ndim == 1 and first_flip[b] < np.inf:
            continue
        assert np.all(e <= tol), f"{what}: sequence {b} off by {np.max(e):.3e} (tol {tol})"


def check_cache(got, want, tol, first_flip, what):
    """Every cache leaf of the port against the reference's: positions
    equal, KV rows and per-(layer, sequence) states within ``tol``."""
    assert set(got) == set(want)
    for name in want:
        assert type(got[name])._fields == want[name]._fields
        for field, g, w in zip(want[name]._fields, got[name], want[name]):
            where = f"{what} {name}.{field}"
            assert tuple(g.shape) == w.shape, where
            if field == "pos":
                assert np.array_equal(g.numpy(), w), where
            elif name in STATES:
                assert g.dtype == torch.float32, where
                e = row_errs(g.reshape(*g.shape[:2], -1), w.reshape(*w.shape[:2], -1))
                assert (e <= tol).all(), f"{where}: {e.max():.3e}"
            else:                        # KV: (L, B, S_cache, KVH, hd)
                e = row_errs(g.flatten(-2), w.reshape(*w.shape[:3], -1)).max(axis=0)
                held(e, first_flip, tol, where)


def test_list_archs_holds_the_families():
    from repro.configs import list_archs as ref_archs
    from repro_torch.configs import list_archs

    assert set(ARCHS) <= set(list_archs()) == set(ref_archs())


def test_logits_match_reference(pair):
    assert pair["port_logits"].dtype == torch.float32
    first, flips = pair["logits_flips"]
    if pair["dtype"] == "float32":
        assert flips == 0
    errs = row_errs(pair["port_logits"], pair["ref_logits"])          # (B, S)
    held(errs, first, TOL[pair["dtype"]], "logits")
    print(f"{pair['arch']} {pair['dtype']}: logits max row err {errs.max():.3e}, "
          f"{flips} routing flips")


def test_loss_matches_reference(pair):
    (rloss, rmet), (ploss, pmet) = pair["ref_loss"], pair["port_loss"]
    tol = TOL[pair["dtype"]]
    for got, want in ((ploss, rloss), (pmet["ce"], rmet["ce"]), (pmet["aux"], rmet["aux"])):
        assert abs(float(got) - float(want)) <= tol * abs(float(want)) + 1e-7
    assert (float(pmet["aux"]) > 0) == bool(pair["pc"].n_experts)
    if pair["pc"].n_experts:
        assert float(ploss) == pytest.approx(float(pmet["ce"]) + 0.01 * float(pmet["aux"]))


def test_prefill_matches_reference(pair):
    rlog, plog, rcache, pcache, (first, flips) = pair["prefill"]
    tol = TOL[pair["dtype"]]
    if pair["dtype"] == "float32":
        assert flips == 0
    held(row_errs(plog, rlog), first, tol, "prefill logits")
    check_cache(pcache, rcache, tol, first, "prefill")
    for name, state in pcache.items():       # the layers wrote their states
        if name in STATES:
            assert any(bool(x.abs().sum() > 0) for x in state), name


def test_decode_matches_reference(pair):
    tol = TOL[pair["dtype"]]
    first = pair["prefill"][4][0].copy()
    for tok, port_tok, rlog, plog, (step_first, flips) in pair["decode"]:
        first = np.minimum(first, np.where(step_first < np.inf, 0, np.inf))
        if pair["dtype"] == "float32":
            assert flips == 0
            assert np.array_equal(port_tok, tok)
        held(row_errs(plog, rlog), first, tol, "decode logits")
    rcache, pcache = pair["final_cache"]
    check_cache(pcache, rcache, tol, np.where(first < np.inf, 0, np.inf), "final")
