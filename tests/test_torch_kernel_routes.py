"""Where the port's kernels may run, on the CPU.

K3 and K4 are forward-only: on their route, a call with grad enabled and a
floating input that requires grad must raise ``RuntimeError`` naming the
kernel, and under ``torch.no_grad()`` it must launch.  There is no card
here, so the kernel route is forced on CPU tensors by a spy, as the models'
wiring tests force it: the route predicate answers "kernel" and the launch
is replaced by the plain version, counted.  The trainer's step
(``kernel=False``) never reaches the kernels.  Then the entry points that
default to the card: without CUDA they raise unless given ``"cpu"``.
"""
import importlib

import numpy as np
import pytest

# The port's tests need torch.  CI's jax-only tier-1 job installs no torch,
# so there these files skip instead of failing at import.
torch = pytest.importorskip("torch")

import repro_torch.deferral as pdef  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import tokens as port_tokens  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import attention as model_attention  # noqa: E402
from repro_torch.models import init_params, model_zoo  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

# ``repro_torch.kernels`` re-exports the wrappers over the modules' names
k3 = importlib.import_module("repro_torch.kernels.flash_attention")
k4 = importlib.import_module("repro_torch.kernels.decode_attention")


@pytest.fixture
def launches(monkeypatch):
    """Force both kernels' routes on CPU tensors; each "launch" runs the
    plain version and is counted."""
    calls = {"K3": 0, "K4": 0}

    def flash(q, k, v, causal, window, scale):
        calls["K3"] += 1
        return k3.flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale)

    def decode(q, k_cache, v_cache, lengths, scale):
        calls["K4"] += 1
        return k4.decode_attention_plain(q, k_cache, v_cache, lengths, scale=scale)

    monkeypatch.setattr(k3, "kernel_route", lambda t: True)
    monkeypatch.setattr(k4, "kernel_route", lambda t: True)
    monkeypatch.setattr(k3, "_launch", flash)
    monkeypatch.setattr(k4, "_launch", decode)
    monkeypatch.setattr(model_attention, "_kernel_route", lambda x, kernel: kernel)
    return calls


def qkv(requires_grad, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(2, 16, 4, 64, generator=g).requires_grad_(requires_grad)
    k = torch.randn(2, 16, 2, 64, generator=g)
    v = torch.randn(2, 16, 2, 64, generator=g)
    return q, k, v


def test_k3_route_refuses_autograd(launches):
    q, k, v = qkv(True)
    with pytest.raises(RuntimeError, match="K3.*no backward"):
        ops.flash_attention(q, k, v)
    with pytest.raises(RuntimeError, match="K3.*no backward"):
        k3.flash_attention(q.detach(), k.requires_grad_(True), v)
    assert launches["K3"] == 0
    with torch.no_grad():
        out = ops.flash_attention(q, k, v)
    assert launches["K3"] == 1 and out.grad_fn is None
    want = k3.flash_attention_plain(q.detach(), k.detach(), v)
    assert torch.equal(out, want)


def test_k4_route_refuses_autograd(launches):
    q, k, v = qkv(True, seed=1)
    q1 = q[:, 0]
    lengths = torch.tensor([16, 5], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="K4.*no backward"):
        ops.decode_attention(q1, k, v, lengths)
    assert launches["K4"] == 0
    with torch.no_grad():
        out = ops.decode_attention(q1, k, v, lengths)
    assert launches["K4"] == 1
    assert torch.equal(out, k4.decode_attention_plain(q1.detach(), k, v, lengths))


def test_inputs_without_grad_launch_with_grad_enabled(launches):
    """Grad enabled but nothing to differentiate: the kernels launch."""
    q, k, v = qkv(False, seed=2)
    ops.flash_attention(q, k, v)
    ops.decode_attention(q[:, 0], k, v, torch.tensor([3, 16], dtype=torch.int32))
    assert launches == {"K3": 1, "K4": 1}


def test_plain_route_keeps_its_gradient():
    """On CPU tensors (the plain route) gradients flow, and match the
    plain version's."""
    q, k, v = qkv(True, seed=3)
    ops.flash_attention(q, k, v).square().sum().backward()
    assert q.grad is not None and bool(q.grad.abs().sum() > 0)


def test_lm_loss_kernel_route_raises_under_grad_and_runs_under_no_grad(launches):
    """The model's K3 route in ``lm_loss``: with parameters that require
    grad it raises; under ``no_grad`` it runs, one K3 launch per layer, and
    gives the einsum route's loss."""
    cfg = get_config("llama3.2-1b", reduced=True).replace(remat="none",
                                                          compute_dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    for t in tree_leaves(params):
        t.requires_grad_(True)
    batch = {"tokens": torch.as_tensor(
        np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 12)))}
    with pytest.raises(RuntimeError, match="K3"):
        model_zoo.loss_fn(params, cfg, batch)
    with torch.no_grad():
        got, _ = model_zoo.loss_fn(params, cfg, batch, kernel=True)
        want, _ = model_zoo.loss_fn(params, cfg, batch, kernel=False)
    assert launches["K3"] == cfg.n_layers
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


def test_trainer_step_takes_the_einsum_route(launches, tmp_path):
    """With the kernel route forced, a training step still reaches neither
    kernel (``loss_fn(kernel=False)``), and every parameter gets a nonzero
    gradient."""
    cfg = get_config("llama3.2-1b", reduced=True).replace(remat="full")
    tr = Trainer(cfg, TrainerConfig(total_steps=1, batch=2, seq=16, ckpt_dir=str(tmp_path),
                                    device="cpu"))
    params, opt, ef = tr.init_state()
    for t in tree_leaves(params):
        t.requires_grad_(True)
    tr.train_step(params, opt, ef, tr.pipeline.batch_at(0))
    assert launches == {"K3": 0, "K4": 0}
    for t in tree_leaves(params):
        assert t.grad is not None and float(t.grad.norm()) > 0


# ---------------------------------------------------------------------------
# Entry points that default to the card
# ---------------------------------------------------------------------------

CFG = get_config("llama3.2-1b", reduced=True)
ZEROS = np.zeros((2, 3), np.float32)
DEFAULTS = {
    "defer_stream_init": lambda **kw: pdef.defer_stream_init(3, (2,), **kw),
    "queue_stream_init": lambda **kw: pdef.queue_stream_init(3, (2,), **kw),
    "uniforms_from_numpy": lambda **kw: convert.uniforms_from_numpy(ZEROS, ZEROS, **kw),
    "normals_from_numpy": lambda **kw: convert.normals_from_numpy(ZEROS, **kw),
    "carry_from_numpy": lambda **kw: convert.carry_from_numpy(ZEROS, ZEROS > 0, ZEROS, **kw),
    "adamw_state_from_numpy": lambda **kw: convert.adamw_state_from_numpy(
        0, _tree(), _tree(), CFG, **kw),
    "token_batch_from_numpy": lambda **kw: convert.token_batch_from_numpy(
        {"tokens": np.zeros((2, 4), np.int32)}, **kw),
    "make_token_batch": lambda **kw: port_tokens.make_token_batch(
        CFG, np.random.default_rng(0), 2, 4, **kw),
    "make_host_mesh": lambda **kw: mesh.make_host_mesh(1, **kw),
}


def _tree():
    """A reference-layout (stacked layers) tree of numpy zeros for CFG."""
    p = model_zoo.init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    blocks = {k: ({kk: np.stack([b[k][kk].numpy() * 0 for b in p["blocks"]]) for kk in v}
                  if isinstance(v, dict) else np.stack([b[k].numpy() * 0 for b in p["blocks"]]))
              for k, v in p["blocks"][0].items()}
    return {"embed": p["embed"].numpy() * 0, "final_ln": p["final_ln"].numpy() * 0,
            "blocks": blocks}


@pytest.mark.parametrize("name", sorted(DEFAULTS))
def test_entry_point_needs_cuda_unless_given_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("the refusal needs a machine without CUDA")
    with pytest.raises(RuntimeError, match=f"{name}.*CUDA is not available"):
        DEFAULTS[name]()
    out = DEFAULTS[name](device="cpu")
    leaves = tree_leaves(out) if not isinstance(out, torch.device) else []
    assert all(t.device.type == "cpu" for t in leaves if isinstance(t, torch.Tensor))


def test_token_pipeline_and_trainer_need_cuda_unless_given_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the refusal needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="make_token_batch.*CUDA is not available"):
        port_tokens.TokenPipeline(CFG, 2, 4).batch_at(0)
    with pytest.raises(RuntimeError, match="make_host_mesh.*CUDA is not available"):
        Trainer(CFG, TrainerConfig(ckpt_dir=str(tmp_path)))
    assert Trainer(CFG, TrainerConfig(ckpt_dir=str(tmp_path), device="cpu")).device.type == "cpu"
