"""repro_torch's training slice == repro's, on the CPU.

The reduced dense configs at float32 compute with ``remat="none"``, the
port starting from the reference's own parameters (``lm_params_from_numpy``)
and state (``adamw_state_from_numpy``, ``token_batch_from_numpy``):

* ``lm_loss`` within 1e-4 of the reference's, and every parameter's
  gradient within 1e-4 of its leaf's largest |g| of ``jax.grad`` of the
  reference's ``loss_fn``; remat and the streamed chunks change nothing;
* one ``adamw_update`` and ``lr_schedule`` within rtol 1e-6;
* ``TokenPipeline.batch_at(k)``'s ids bit-equal; ``quantize_int8``'s q
  bit-equal and its scale within 1 ulp; the error-feedback residuals too;
* three ``Trainer`` steps from the reference's initial state: every
  parameter within 1e-2 of its leaf's largest three-step update (Adam
  divides each gradient by its own running size, so float32 summation
  order in the tiniest gradients shows as up to 3.7e-3 of the update);
* twins of ``tests/test_fault_tolerance.py`` (checkpoint round trip, the
  atomic tmp directory, retention, crash and restart resumed bitwise,
  compression's error feedback and convergence, the straggler detector)
  and of ``tests/test_data_tokens.py``; the reference's elastic reshard
  across meshes waits for the multi-device route;
* the training launcher.
"""
import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest

# The port's tests need torch.  CI's jax-only tier-1 job installs no torch,
# so there these files skip instead of failing at import.
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.checkpoint as ref_ckpt  # noqa: E402
import repro.distributed.compression as ref_comp  # noqa: E402
import repro.optim as ref_optim  # noqa: E402
import repro.utils as ref_utils  # noqa: E402
import repro_torch.checkpoint as port_ckpt  # noqa: E402
import repro_torch.distributed.compression as port_comp  # noqa: E402
import repro_torch.optim as port_optim  # noqa: E402
import repro_torch.utils as port_utils  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs.base import ModelConfig as RefModelConfig  # noqa: E402
from repro.data import tokens as ref_tokens  # noqa: E402
from repro.distributed.fault_tolerance import StragglerDetector as RefStraggler  # noqa: E402
from repro.models import init_params as ref_init_params  # noqa: E402
from repro.models import model_zoo as ref_zoo  # noqa: E402
from repro.models import transformer as ref_transformer  # noqa: E402
from repro.train.trainer import Trainer as RefTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as RefTrainerConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    adamw_state_from_numpy,
    lm_params_from_numpy,
    token_batch_from_numpy,
)
from repro_torch.data import tokens as port_tokens  # noqa: E402
from repro_torch.distributed.fault_tolerance import StragglerDetector  # noqa: E402
from repro_torch.launch import mesh as port_mesh  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.models import init_params, model_zoo  # noqa: E402
from repro_torch.models import transformer as port_transformer  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map, tree_paths  # noqa: E402

ARCHS = ("llama3.2-1b", "yi-9b", "deepseek-67b", "command-r-plus-104b")
LOSS_TOL = 1e-4     # |loss - reference| and each grad's error over its leaf's max |g|
ADAMW_RTOL = 1e-6
TRAIN_TOL = 1e-2    # three steps: error over the leaf's largest update
B, S = 2, 33


def cfgs(arch, remat="none"):
    """The reduced config of ``arch`` at float32 compute in both packages."""
    rc = ref_config(arch, reduced=True).replace(remat=remat, compute_dtype=jnp.float32)
    pc = get_config(arch, reduced=True).replace(remat=remat, compute_dtype=torch.float32)
    return rc, pc


def as_np(tree):
    return jax.tree.map(np.asarray, tree)


def tokens(cfg, seed=0, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def port_loss(params, cfg, toks, **kw):
    for t in tree_leaves(params):
        t.requires_grad_(True)
        t.grad = None
    loss, metrics = model_zoo.loss_fn(params, cfg, {"tokens": torch.as_tensor(toks)},
                                      kernel=False, **kw)
    loss.backward()
    return loss.detach(), metrics, [t.grad.clone() for t in tree_leaves(params)]


@pytest.fixture(scope="module", params=ARCHS)
def reference_loss(request):
    """One reduced config's loss and gradients in the reference, and the
    port's parameters carried across."""
    rc, pc = cfgs(request.param)
    params = ref_init_params(rc, jax.random.key(0))
    toks = tokens(rc)
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: ref_zoo.loss_fn(p, rc, {"tokens": jnp.asarray(toks)}), has_aux=True)(params)
    return {"rc": rc, "pc": pc, "params": as_np(params), "toks": toks, "loss": float(loss),
            "ce": float(metrics["ce"]),
            "grads": tree_leaves(lm_params_from_numpy(as_np(grads), pc, device="cpu"))}


def test_lm_loss_and_grads_match_reference(reference_loss):
    r = reference_loss
    params = lm_params_from_numpy(r["params"], r["pc"], device="cpu")
    loss, metrics, grads = port_loss(params, r["pc"], r["toks"])
    assert abs(float(loss) - r["loss"]) <= LOSS_TOL
    assert abs(float(metrics["ce"].detach()) - r["ce"]) <= LOSS_TOL
    assert float(metrics["aux"]) == 0.0
    for path, got, want in zip(tree_paths(params), grads, r["grads"]):
        scale = float(want.abs().max())
        assert scale > 0, path
        assert float((got - want).abs().max()) <= LOSS_TOL * scale, path


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_changes_nothing(remat):
    """Recomputing each layer in the backward pass gives the loss and the
    gradients of ``remat="none"``, bit for bit on the CPU."""
    rc, pc = cfgs("llama3.2-1b")
    params = init_params(pc, torch.Generator().manual_seed(3), device="cpu")
    toks = tokens(pc, 3)
    want = port_loss(params, pc, toks)
    got = port_loss(params, pc.replace(remat=remat), toks)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[2], want[2]):
        assert torch.equal(a, b)


def test_streamed_chunks_match_reference(monkeypatch):
    """Several CE chunks with a ragged last one (32 predictions in chunks
    of 7), against the reference at the same chunk size; the port
    recomputes each chunk's logits in the backward pass."""
    rc, pc = cfgs("yi-9b")
    params = ref_init_params(rc, jax.random.key(4))
    toks = tokens(rc, 4)
    monkeypatch.setattr(ref_transformer, "LOSS_CHUNK", 7)
    monkeypatch.setattr(port_transformer, "LOSS_CHUNK", 7)
    (loss, _), grads = jax.value_and_grad(
        lambda p: ref_zoo.loss_fn(p, rc, {"tokens": jnp.asarray(toks)}), has_aux=True)(params)
    port_params = lm_params_from_numpy(as_np(params), pc, device="cpu")
    got, _, got_grads = port_loss(port_params, pc, toks)
    assert abs(float(got) - float(loss)) <= LOSS_TOL
    for a, b in zip(got_grads, tree_leaves(lm_params_from_numpy(as_np(grads), pc,
                                                                 device="cpu"))):
        assert float((a - b).abs().max()) <= LOSS_TOL * float(b.abs().max())
    monkeypatch.setattr(port_transformer, "LOSS_CHUNK", 512)
    whole = port_loss(port_params, pc, toks)
    assert abs(float(got) - float(whole[0])) <= 1e-6


def test_loss_under_no_grad_equals_with_grad():
    rc, pc = cfgs("llama3.2-1b", remat="full")
    params = init_params(pc, torch.Generator().manual_seed(5), device="cpu")
    batch = {"tokens": torch.as_tensor(tokens(pc, 5))}
    with torch.no_grad():
        a, _ = model_zoo.loss_fn(params, pc, batch, kernel=False)
    b, _ = model_zoo.loss_fn(params, pc, batch, kernel=False)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg_kw", [{}, {"warmup_steps": 3, "total_steps": 20},
                                    {"warmup_steps": 0, "total_steps": 10, "clip_norm": 0.05}],
                         ids=["default", "short", "clipped"])
def test_lr_schedule_matches_reference(cfg_kw):
    rcfg, pcfg = ref_optim.AdamWConfig(**cfg_kw), port_optim.AdamWConfig(**cfg_kw)
    for step in (0, 1, 2, 3, 7, 50, 99, 100, 101, 5000, 10_000, 20_000):
        want = float(ref_optim.lr_schedule(rcfg, jnp.int32(step)))
        got = float(port_optim.lr_schedule(pcfg, torch.tensor(step, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=ADAMW_RTOL, abs=0.0), step


@pytest.mark.parametrize("cfg_kw", [{}, {"warmup_steps": 0, "total_steps": 10, "clip_norm": 0.05},
                                    {"warmup_steps": 2, "weight_decay": 0.0}],
                         ids=["default", "clipped", "no-decay"])
@pytest.mark.parametrize("start", [0, 4])
def test_adamw_update_matches_reference(cfg_kw, start):
    """One update from the reference's state (``start`` earlier steps, so
    nonzero moments) against the reference's, carried across by
    ``adamw_state_from_numpy``: parameters, moments and the metrics within
    rtol 1e-6, the step equal.  Each element is held to rtol 1e-6 of itself
    plus 1e-6 of its leaf's largest value: the global norm sums in another
    order, which moves the clip scale by an ulp, and an element that the
    step brings near zero (p - lr * delta cancelling) keeps that absolute
    error, not a relative one."""
    rc, pc = cfgs("llama3.2-1b")
    rcfg, pcfg = ref_optim.AdamWConfig(**cfg_kw), port_optim.AdamWConfig(**cfg_kw)
    params = ref_init_params(rc, jax.random.key(6))
    state = ref_optim.init_adamw(params)
    rng = np.random.default_rng(6)

    def grads_like(p):
        return jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(x.shape) * 0.03,
                                                  jnp.float32), p)

    for _ in range(start):
        params, state, _ = ref_optim.adamw_update(grads_like(params), state, params, rcfg)
    g = grads_like(params)
    want_p, want_s, want_m = ref_optim.adamw_update(g, state, params, rcfg)

    pp = lm_params_from_numpy(as_np(params), pc, device="cpu")
    ps = adamw_state_from_numpy(np.asarray(state.step), as_np(state.m), as_np(state.v), pc,
                                device="cpu")
    pg = lm_params_from_numpy(as_np(g), pc, device="cpu")
    got_p, got_s, got_m = port_optim.adamw_update(pg, ps, pp, pcfg)
    assert got_p is pp and got_s.m is ps.m           # in place
    assert int(got_s.step) == int(want_s.step) == start + 1
    for name in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(got_m[name]), float(want_m[name]), rtol=ADAMW_RTOL)
    for got, want in ((got_p, want_p), (got_s.m, want_s.m), (got_s.v, want_s.v)):
        want = lm_params_from_numpy(as_np(want), pc, device="cpu")
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=ADAMW_RTOL,
                                       atol=ADAMW_RTOL * float(b.abs().max()))


def test_global_norm_and_init_match_reference():
    rc, pc = cfgs("yi-9b")
    params = ref_init_params(rc, jax.random.key(7))
    pp = lm_params_from_numpy(as_np(params), pc, device="cpu")
    np.testing.assert_allclose(float(port_optim.global_norm(pp)),
                               float(ref_optim.global_norm(params)), rtol=ADAMW_RTOL)
    state = port_optim.init_adamw(pp)
    assert state.step.dtype == torch.int32 and int(state.step) == 0
    for m, p in zip(tree_leaves(state.m), tree_leaves(pp)):
        assert m.shape == p.shape and m.dtype == torch.float32 and not m.any()


# ---------------------------------------------------------------------------
# Tokens, compression, utilities
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3.2-1b", "yi-9b"])
def test_token_pipeline_ids_bit_equal(arch):
    rcfg, pcfg = ref_config(arch, reduced=True), get_config(arch, reduced=True)
    ref_pipe = ref_tokens.TokenPipeline(rcfg, batch=3, seq=40, seed=11)
    port_pipe = port_tokens.TokenPipeline(pcfg, batch=3, seq=40, seed=11, device="cpu")
    for step in (0, 1, 7, 123, 10_000):
        want = ref_pipe.batch_at(step)
        got = port_pipe.batch_at(step)
        assert got["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
        carried = token_batch_from_numpy(as_np(want), device="cpu")
        assert torch.equal(carried["tokens"], got["tokens"])


def test_make_token_batch_frontends_match_reference():
    """The modality stubs' tokens and embeddings, drawn from one rng."""
    for frontend, extra in (("vision_stub", {"n_frontend_tokens": 4}), ("audio_stub", {})):
        kw = dict(name="t", family="vlm", n_layers=1, d_model=8, n_heads=2, n_kv_heads=2,
                  d_ff=16, vocab_size=64, frontend=frontend, **extra)
        want = ref_tokens.make_token_batch(RefModelConfig(**kw), np.random.default_rng(2), 2, 12)
        got = port_tokens.make_token_batch(ModelConfig(**kw), np.random.default_rng(2), 2, 12,
                                           device="cpu")
        carried = token_batch_from_numpy(as_np(want), device="cpu")
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == carried[k].dtype
            np.testing.assert_array_equal(got[k].float().numpy(), carried[k].float().numpy())


class _NearOneRng:
    """An rng whose uniforms all land above the float64 CDF endpoint."""

    def uniform(self, size=None):
        return np.full(size, 1.0 - 1e-15)


def test_zipf_ids_stay_in_vocab_when_u_is_near_one():
    """``tests/test_data_tokens.py``'s regressions on the port's sampler."""
    ids = port_tokens._zipf_tokens(_NearOneRng(), 257, (4, 8))
    assert ids.shape == (4, 8) and ids.max() == 256 and ids.min() >= 0
    ids = port_tokens._zipf_tokens(np.random.default_rng(0), 1000, (64, 64))
    np.testing.assert_array_equal(ids, ref_tokens._zipf_tokens(np.random.default_rng(0),
                                                               1000, (64, 64)))
    cfg = ModelConfig(name="t", family="dense", n_layers=1, d_model=8, n_heads=2,
                      n_kv_heads=2, d_ff=16, vocab_size=64)
    pipe = port_tokens.TokenPipeline(cfg, batch=2, seq=16, seed=0, device="cpu")
    toks = pipe.batch_at(0)["tokens"]
    assert int(toks.max()) < cfg.vocab_size
    assert torch.equal(toks, pipe.batch_at(0)["tokens"])


@pytest.mark.parametrize("seed", range(4))
def test_quantize_int8_matches_reference(seed):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal((37, 53)) * 10.0 ** rng.uniform(-6, 2)).astype(np.float32)
    want_q, want_s = ref_comp.quantize_int8(jnp.asarray(g))
    got_q, got_s = port_comp.quantize_int8(torch.as_tensor(g))
    assert got_q.dtype == torch.int8
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    assert abs(float(got_s) - float(want_s)) <= np.spacing(np.float32(want_s))
    np.testing.assert_array_equal(port_comp.dequantize_int8(got_q, got_s).numpy(),
                                  np.asarray(ref_comp.dequantize_int8(want_q, want_s)))


def test_compress_grads_matches_reference():
    """Five chained calls: the decompressed grads and the residuals equal
    the reference's, the residual norm within rtol 1e-6."""
    rng = np.random.default_rng(8)
    g = {"a": rng.standard_normal((16, 8)).astype(np.float32),
         "b": [rng.standard_normal(5).astype(np.float32) * 1e-3]}
    rs = ref_comp.init_error_feedback(jax.tree.map(jnp.asarray, g))
    ps = port_comp.init_error_feedback(tree_map(torch.as_tensor, g))
    for _ in range(5):
        want_g, rs, want_m = ref_comp.compress_grads(jax.tree.map(jnp.asarray, g), rs)
        got_g, ps, got_m = port_comp.compress_grads(tree_map(torch.as_tensor, g), ps)
        for a, b in zip(tree_leaves(got_g) + tree_leaves(ps.residual),
                        jax.tree.leaves(want_g) + jax.tree.leaves(rs.residual)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_allclose(float(got_m["ef_residual_norm"]),
                                   float(want_m["ef_residual_norm"]), rtol=1e-6)
    assert port_comp.compression_ratio(g) == ref_comp.compression_ratio(g)


def test_grad_compression_error_feedback():
    grads = {"w": torch.linspace(-1, 1, 1024).reshape(32, 32)}
    ef = port_comp.init_error_feedback(grads)
    total = torch.zeros_like(grads["w"])
    acc_true = torch.zeros_like(grads["w"])
    for _ in range(50):
        g, ef, _ = port_comp.compress_grads(grads, ef)
        total = total + g["w"]
        acc_true = acc_true + grads["w"]
    rel = float(torch.linalg.norm(total - acc_true) / torch.linalg.norm(acc_true))
    assert rel < 1e-2, rel


def test_straggler_detector():
    for cls in (StragglerDetector, RefStraggler):
        d = cls(threshold=2.0)
        for w in range(8):
            for _ in range(5):
                d.observe(w, 1.0 if w != 3 else 5.0)
        assert d.stragglers() == [3]


def test_utils_match_reference():
    for n in (0, 999, 1023, 1024, 5.5e6, 3e12, -2048):
        assert port_utils.human_bytes(n) == ref_utils.human_bytes(n)
        assert port_utils.human_count(n) == ref_utils.human_count(n)
    d = {"a": {"b": 1, "c": {"d": 2}}, "e": 3}
    assert port_utils.flatten_dict(d) == ref_utils.flatten_dict(d)
    sink = {}
    with port_utils.timed("x", sink):
        pass
    assert sink["x"] >= 0.0


def test_tree_leaves_in_jax_order():
    """The port's fixed leaf order is ``jax.tree.leaves``'s, so a checkpoint
    of the same tree numbers its files alike in both packages."""
    tree = {"z": [1, 2, {"y": 3, "x": 4}], "a": port_optim.AdamWState(5, {"q": 6}, None),
            "m": (7,)}
    assert tree_leaves(tree) == jax.tree.leaves(tree)
    assert tree_paths(tree) == ["a/step", "a/m/q", "m/0", "z/0", "z/1", "z/2/x", "z/2/y"]


# ---------------------------------------------------------------------------
# Checkpoints (twins of tests/test_fault_tolerance.py)
# ---------------------------------------------------------------------------

@pytest.fixture
def tiny():
    return get_config("llama3.2-1b", reduced=True).replace(remat="none")


def test_checkpoint_roundtrip(tmp_path, tiny):
    params = init_params(tiny, torch.Generator().manual_seed(0), device="cpu")
    port_ckpt.save(tmp_path, 7, params)
    assert port_ckpt.latest_step(tmp_path) == 7
    got = port_ckpt.restore(tmp_path, 7, params)
    for a, b in zip(tree_leaves(params), tree_leaves(got)):
        assert torch.equal(a, b) and a.dtype == b.dtype
    manifest = json.loads((tmp_path / "step_00000007" / "manifest.json").read_text())
    assert manifest["paths"] == tree_paths(params)
    assert manifest["n_leaves"] == len(tree_leaves(params))
    with pytest.raises(ValueError, match="leaves"):
        port_ckpt.restore(tmp_path, 7, {"embed": params["embed"]})


def test_checkpoint_files_match_reference_layout(tmp_path):
    """The same tree saved by both packages: the same files, each array
    equal, in the same order."""
    rng = np.random.default_rng(1)
    tree = {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "b": [np.arange(5, dtype=np.int32), {"s": np.float32(2.5)}]}
    ref_ckpt.save(tmp_path / "ref", 3, jax.tree.map(jnp.asarray, tree))
    port_ckpt.save(tmp_path / "port", 3, tree_map(torch.as_tensor, tree))
    ref_dir, port_dir = tmp_path / "ref" / "step_00000003", tmp_path / "port" / "step_00000003"
    assert sorted(p.name for p in port_dir.iterdir()) == sorted(p.name for p in ref_dir.iterdir())
    for i in range(len(jax.tree.leaves(tree))):
        np.testing.assert_array_equal(np.load(port_dir / f"arr_{i}.npy"),
                                      np.load(ref_dir / f"arr_{i}.npy"))


def test_checkpoint_atomic_tmp_never_latest(tmp_path, tiny):
    params = init_params(tiny, torch.Generator().manual_seed(0), device="cpu")
    port_ckpt.save(tmp_path, 1, params)
    (tmp_path / "step_00000002.tmp").mkdir()        # a crashed write
    assert port_ckpt.latest_step(tmp_path) == 1


def test_async_checkpointer_retention_and_copy(tmp_path, tiny):
    """Three saves keep the last two; each save holds the tree as it was
    when saved, though the tensors are updated in place right after."""
    params = init_params(tiny, torch.Generator().manual_seed(1), device="cpu")
    ck = port_ckpt.Checkpointer(tmp_path, keep=2)
    for s in (10, 20, 30):
        saved = params["embed"].clone()
        ck.save_async(s, params)
        with torch.no_grad():
            params["embed"].add_(1.0)
    ck.wait()
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.iterdir() if p.is_dir())
    assert steps == [20, 30]
    got = port_ckpt.restore(tmp_path, 30, params)
    assert torch.equal(got["embed"], saved)
    assert not torch.equal(got["embed"], params["embed"])


def train_cfg(tmp_path, name, **kw):
    base = dict(total_steps=20, batch=2, seq=32, ckpt_every=10, log_every=5,
                ckpt_dir=str(tmp_path / name), device="cpu")
    return TrainerConfig(**{**base, **kw})


def test_crash_restart_resumes_bitwise(tmp_path, tiny):
    """Train 20 steps; crash at 12 after the checkpoint at 10; restart;
    every final parameter equals an uninterrupted run's, bit for bit
    (deterministic data + state restore)."""
    tc = train_cfg(tmp_path, "a")
    with pytest.raises(RuntimeError, match="injected failure"):
        Trainer(tiny, tc).run(fail_at_step=12)
    resumed = Trainer(tiny, tc).run()
    clean = Trainer(tiny, train_cfg(tmp_path, "b")).run()
    assert resumed["final_step"] == clean["final_step"] == 20
    assert resumed["history"][-1] == clean["history"][-1]
    for a, b in zip(tree_leaves(resumed["params"]), tree_leaves(clean["params"])):
        assert torch.equal(a, b)
    assert torch.equal(resumed["opt_state"].step, clean["opt_state"].step)


def test_training_with_compression_converges(tiny, tmp_path):
    out = Trainer(tiny, train_cfg(tmp_path, "c", total_steps=30, ckpt_every=1000,
                                  log_every=10, grad_compression=True)).run()
    losses = [loss for _, loss in out["history"]]
    assert losses[-1] < losses[0], losses


def test_three_trainer_steps_match_reference(tmp_path):
    """Three steps of the port's ``Trainer`` from the reference ``Trainer``'s
    initial state against the reference's: the logged losses within 1e-4,
    every parameter within 1e-2 of its leaf's largest three-step update."""
    rc, pc = cfgs("llama3.2-1b")
    opt = dict(lr_peak=3e-3, warmup_steps=2)
    rt = RefTrainer(rc, RefTrainerConfig(total_steps=3, batch=2, seq=32, ckpt_every=1000,
                                         log_every=1, ckpt_dir=str(tmp_path / "ref"),
                                         opt=ref_optim.AdamWConfig(**opt)))
    init = as_np(rt.init_state()[0])
    want = rt.run()
    start = lm_params_from_numpy(init, pc, device="cpu")
    params = lm_params_from_numpy(init, pc, device="cpu")
    got = Trainer(pc, train_cfg(tmp_path, "port", total_steps=3, ckpt_every=1000,
                                log_every=1, opt=port_optim.AdamWConfig(**opt))).run(
        init=(params, port_optim.init_adamw(params), port_comp.init_error_feedback(params)))
    assert [s for s, _ in got["history"]] == [s for s, _ in want["history"]] == [1, 2, 3]
    for (_, a), (_, b) in zip(got["history"], want["history"]):
        assert abs(a - b) <= LOSS_TOL
    ref_final = lm_params_from_numpy(as_np(want["params"]), pc, device="cpu")
    for path, a, b, s in zip(tree_paths(start), tree_leaves(got["params"]),
                             tree_leaves(ref_final), tree_leaves(start)):
        update = float((b - s).abs().max())
        assert float((a.detach() - b).abs().max()) <= TRAIN_TOL * update, path


def test_trainer_observes_steps_and_stops_on_preemption(tmp_path, tiny):
    """A preemption request checkpoints the step and stops the loop; the
    straggler detector saw every step."""
    tr = Trainer(tiny, train_cfg(tmp_path, "p", total_steps=10, ckpt_every=1000))
    tr.hooks["on_log"] = lambda step, metrics: setattr(tr.guard, "requested", step >= 3)
    out = tr.run()
    assert out["final_step"] == 5           # logs at 1 and 5; stops after the log at 5
    assert port_ckpt.latest_step(tmp_path / "p") == 5
    assert list(tr.straggler.ema) == [0] and tr.straggler.stragglers() == []


# ---------------------------------------------------------------------------
# Launcher and mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flag", ["--dry-run", "--multi-pod"])
def test_launcher_dry_run_and_multi_pod_exit_2(flag, monkeypatch, capsys):
    # --dry-run traces the train step through repro_torch.launch.dryrun.run_cell
    # (exit 0; it starts a process group, so tests/test_torch_dryrun.py runs it in a
    # subprocess and a stand-in records the call here); --multi-pod alone is the
    # local launcher's flag-free run, which exits 2 only where CUDA is missing
    calls = []

    def run_cell(arch, shape, multi_pod, out_dir):
        calls.append((arch, shape, multi_pod))
        return {"hlo_flops_per_device": 2.0e12}

    monkeypatch.setattr("repro_torch.launch.dryrun.run_cell", run_cell)
    if flag == "--dry-run":
        assert port_train.main(["--arch", "llama3.2-1b", flag]) == 0
        assert calls == [("llama3.2-1b", "train_4k", False)]
        assert capsys.readouterr().out == "compiled llama3.2-1b x train_4k: flops/dev=2.000e+12\n"
    elif not torch.cuda.is_available():
        assert port_train.main(["--arch", "llama3.2-1b", flag]) == 2
        assert "--device cpu" in capsys.readouterr().err and not calls


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    argv = ["--arch", "llama3.2-1b", "--steps", "4", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path), "--device", "cpu", "--compress-grads"]
    assert port_train.main(argv) == 0
    assert "final loss" in capsys.readouterr().out
    assert port_ckpt.latest_step(tmp_path) is None           # ckpt_every 50 > 4 steps


def test_launcher_needs_cuda_unless_given_cpu():
    if torch.cuda.is_available():
        pytest.skip("the refusal needs a machine without CUDA")
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                           "llama3.2-1b", "--steps", "1"], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 2 and "--device cpu" in proc.stderr


def test_mesh_stub():
    assert port_mesh.make_host_mesh(1, "cpu") == torch.device("cpu")
    assert port_mesh.make_host_mesh(16, "cpu") == torch.device("cpu")
    # the production mesh needs a running group of 256 (512) ranks; this
    # process runs none (the fake backend's: tests/test_torch_elastic.py)
    with pytest.raises(ValueError, match="512 ranks; none is running"):
        port_mesh.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="256 ranks; none is running"):
        port_mesh.make_production_mesh()


def test_trainer_config_fields_match_reference():
    ref_fields = {f.name for f in dataclasses.fields(RefTrainerConfig)}
    assert ref_fields <= {f.name for f in dataclasses.fields(TrainerConfig)}
    assert dataclasses.asdict(port_optim.AdamWConfig()) == dataclasses.asdict(
        ref_optim.AdamWConfig())
