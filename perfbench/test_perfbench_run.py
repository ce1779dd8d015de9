"""The benchmark's run on the CPU at a tiny width: the reference against a
hand-built case and against the port, a whole run of the harness, the
comparison failing the control and each fault a served cell can have, and
the command's refusals."""
from __future__ import annotations

import copy
import dataclasses
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from perfbench import check, harness, manifest, readings, reference, run, weights  # noqa: E402
from perfbench.traffic import Schedule, Traffic  # noqa: E402

#: the port's reduced widths (``get_config(..., reduced=True)``) as overrides
TINY = {
    "yi-9b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=160,
                  vocab_size=512),
    "qwen3-moe-30b-a3b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                              d_ff=96, moe_d_ff=96, n_experts=8, top_k=2, vocab_size=512),
}
#: the two sets of numbers the cells compare: the widest distance and gap
#: (the yi-9b cells), the distance at the 75th percentile (the qwen3-moe
#: cells); both hold the exact token excess to 0
LIMITS = {"logit_err": 0.05, "token_gap": 0.5, "token_excess": 0.0}
P75 = {"logit_err_p75": 0.05, "token_excess": 0.0}
SEED = 2 ** 31 + 77


def tiny_cell(workload="yi-9b.longdoc", limits=LIMITS, **over):
    cell = manifest.load_cell(workload)
    conf = copy.deepcopy(cell.config)
    sizes = {**TINY[conf["name"]], **over}
    conf["overrides"] = {**conf["overrides"], **sizes}
    conf["model"].update(sizes)
    return dataclasses.replace(cell, config=conf, traffic=Traffic("tiny", (64, 128, 192), 1),
                               batch=4, check_requests=4, limits=limits)


def test_moe_route_drops_the_pairs_past_capacity_by_hand():
    """Four experts, two per token, capacity 8 (``int(1.0 * 16 * 2 / 4)``):
    every token ranks expert 0 then expert 1 first, so tokens 0-7 keep both
    picks and tokens 8-15 are dropped from both, onto the residual path."""
    model = {"n_experts": 4, "top_k": 2, "capacity_factor": 1.0, "moe_d_ff": 3}
    g = torch.Generator().manual_seed(0)
    h = torch.rand((16, 5), generator=g) + 0.5
    router = torch.tensor([[3.0, 2.0, -1.0, -2.0]] * 5)
    assert reference.capacity(model, 16) == 8
    kept, expert, rank, gate = reference.route(h, router, model)
    assert kept.tolist() == list(range(16))
    assert expert.tolist() == [0, 1] * 8 and rank.tolist() == [r for r in range(8) for _ in "ab"]
    w = {k: torch.randn(shape, generator=g) for k, shape in
         (("wi", (4, 5, 3)), ("wg", (4, 5, 3)), ("wo", (4, 3, 5)))}
    y = reference.moe(h, {**w, "router": router}, model, lowp=False)
    probs = torch.softmax(h @ router, dim=-1)[:, :2]
    gates = probs / probs.sum(-1, keepdim=True)
    want = sum(gates[:8, e:e + 1] * ((h[:8] @ w["wi"][e]) * torch.nn.functional.silu(
        h[:8] @ w["wg"][e]) @ w["wo"][e]) for e in (0, 1))
    torch.testing.assert_close(y[:8], want)
    assert not y[8:].any()


@pytest.mark.parametrize("workload", ["yi-9b.longdoc", "qwen3-moe-30b-a3b.longdoc"])
def test_the_reference_equals_the_port_in_float32(workload):
    """At the tiny width with the port computing in float32, the two agree
    to rounding: every equation, the routing and its capacity drops
    included (capacity 8 for 16 picks of 8 experts per 64 tokens)."""
    from repro_torch.serving import InferenceEngine

    cell = tiny_cell(workload)
    cfg = harness.port_config(cell.config).replace(compute_dtype=torch.float32,
                                                    kv_cache_dtype=torch.float32)
    params = weights.draw(cell.model, SEED, "cpu")
    params["blocks"] = [{k: ({n: w.float() for n, w in v.items()} if isinstance(v, dict) else v)
                         for k, v in b.items()} for b in params["blocks"]]
    engine = InferenceEngine(cfg, params, max_batch=2, max_seq=200, device="cpu")
    tokens = np.random.default_rng(0).integers(0, 512, (2, 128), dtype=np.int32)
    _, logits = engine._generate(tokens, 1, keep_logits=True)
    for got, want in zip(logits[0], reference.last_logits(params, cell.model, list(tokens))):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _run(cell, seconds=0.3):
    return harness.run(cell, SEED, seconds, False, "cpu", 0.0)


def test_a_run_reports_its_metrics_and_is_correct():
    out = _run(tiny_cell())
    # whole rounds of the mix's three lengths, four requests a batch
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] % (4 * 3) == 0
    assert set(out["metrics"]) == {"tokens_per_s", "latency_p95_ms", "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(LIMITS)
    assert out["checks"]["logit_err"]["value"] < LIMITS["logit_err"] / 3
    assert out["checks"]["token_excess"]["value"] <= 0.0


def _layer_unchanged(monkeypatch):
    from repro_torch.models import transformer

    monkeypatch.setattr(transformer, "layer_prefill",
                        lambda p, cfg, x, positions, cache, flag=False, kernel=True: (x, cache))


def _half_batch(monkeypatch):
    from repro_torch.serving import InferenceEngine

    real = InferenceEngine._prefill

    def half(self, params, batch, cache):
        logits, cache = real(self, params, batch, cache)
        n = logits.shape[0] // 2
        return torch.cat([logits[:n], logits[:n].mean(0, keepdim=True).expand(
            logits.shape[0] - n, -1)]), cache

    monkeypatch.setattr(InferenceEngine, "_prefill", half)


def _token_altered(monkeypatch):
    from repro_torch.serving import InferenceEngine

    real = InferenceEngine._generate

    def altered(self, tokens, n_new, **kw):
        out, logits = real(self, tokens, n_new, **kw)
        return (out + 1) % self.cfg.vocab_size, logits

    monkeypatch.setattr(InferenceEngine, "_generate", altered)


@pytest.mark.parametrize("limits", [LIMITS, P75], ids=["widest", "p75"])
@pytest.mark.parametrize("fault", [_layer_unchanged, _half_batch, _token_altered],
                         ids=["layer_returns_its_input", "half_the_batch_left_out",
                              "token_altered"])
def test_each_fault_of_a_served_cell_comes_out_not_correct(monkeypatch, fault, limits):
    """The timed path broken underneath, the rest of a run as it is: a
    layer that returns its state unchanged, half of the batch left out
    (the rest's mean in its place), a served token altered where it is
    made; under each set of numbers a cell compares.  One card has no
    exchange between chips to leave out."""
    assert _run(tiny_cell(limits=limits))["correct"] is True
    fault(monkeypatch)
    assert _run(tiny_cell(limits=limits))["correct"] is False


def test_the_control_reads_above_the_program_and_fails_a_limit_between():
    cell = tiny_cell()
    params, schedule, engine = harness.build(cell, SEED, torch.device("cpu"))
    sampler = harness.Sampler(6, schedule.sampler_rng())
    harness.closed_loop(engine, schedule, 0.0, sampler=sampler, batches=6)
    samples = sampler.samples()
    prompts = harness.prompts_of(samples, schedule)
    ref = reference.last_logits(params, cell.model, prompts)
    program = check.numbers([s.logits for s in samples], [s.token for s in samples], ref)
    control = check.numbers(*check.control(params, cell.model, prompts), ref)
    for k in ("logit_err", "logit_err_p75"):
        assert control[k] >= 3 * program[k] > 0
    assert program["token_excess"] <= 0.0 and control["token_excess"] <= 0.0
    between = {k: (program[k] * control[k]) ** 0.5 for k in ("logit_err", "logit_err_p75")}
    assert check.verdict(program, between) and not check.verdict(control, between)


def test_readings_give_a_line_per_seed_and_the_two_ends(monkeypatch, capsys):
    cell = tiny_cell()
    monkeypatch.setattr(manifest, "load_cell", lambda name: cell)
    monkeypatch.setattr(sys, "path", list(sys.path))
    assert readings.main(["--workload", "tiny", "--seeds", "5,6", "--control", "1",
                          "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x.get("seed") for x in lines[:2]] == [5, 6]
    assert "control" in lines[0] and "control" not in lines[1]
    assert len(lines[0]["rows"]["err"]) == lines[0]["requests"]
    ends = lines[-1]["readings"]
    assert ends["logit_err"]["control_min"] >= 3 * ends["logit_err"]["program_max"]


def test_the_sampler_keeps_the_longest_request_and_a_seeded_reservoir():
    rows = torch.arange(12.0).reshape(4, 3)
    a, b = (harness.Sampler(3, np.random.default_rng(5)) for _ in range(2))
    for s in (a, b):
        for i, length in enumerate((64, 256, 128, 256, 64)):
            s.offer(i, length, np.full((4, 1), i), rows)
    assert [(x.batch, x.row) for x in a.samples()] == [(x.batch, x.row) for x in b.samples()]
    assert (a.longest.batch, a.longest.row) == (1, 0)     # the first at the longest prompt
    assert any(x is a.longest for x in a.samples()) and len(a.samples()) <= 4
    assert a.seen == 20 and len(a.kept) == 3


def test_nan_logits_fail_the_comparison():
    ref = [torch.randn(50)]
    found = check.numbers([torch.full((50,), float("nan"))], [0], ref)
    assert found["logit_err"] == float("inf") and found["token_excess"] == float("inf")
    assert not check.verdict(found, LIMITS) and not check.verdict(found, P75)


def test_the_numbers_by_hand():
    """Three rows at distances 0.1, 0.2 and 0.3 of the reference's norm,
    each serving the best token; then a row that serves a token 2 below the
    best with every logit within 0.4 of the reference's: an excess of
    2 - 0.8, in units of the reference's standard deviation."""
    want = torch.tensor([3.0, 0.0, 0.0, 0.0, 1.0])
    sd = float(want.std())
    rows = [want + torch.tensor([0.0, 0.0, 0.0, f * (10 ** 0.5), 0.0]) for f in (.1, .2, .3)]
    got = check.numbers(rows, [0, 0, 0], [want] * 3)
    assert got["logit_err"] == pytest.approx(0.3) and got["logit_err_p75"] == pytest.approx(0.3)
    assert got["token_gap"] == 0.0 and got["token_excess"] < 0
    row = want + torch.tensor([-0.4, 0.0, 0.0, 0.0, 0.4])
    one = check.numbers([row], [4], [want])
    assert one["token_gap"] == pytest.approx(2.0 / sd)
    assert one["token_excess"] == pytest.approx((2.0 - 0.8) / sd)
    with pytest.raises(ValueError):
        check.verdict(one, {"no_such_number": 1.0})


def test_forbidden_modules_are_matched_by_whole_top_level_names():
    assert harness.loaded_forbidden(["repro_torch.serving", "numpy", "reprox"]) == []
    assert harness.loaded_forbidden(["repro.core.costs", "jax.numpy", "jaxlib"]) == [
        "jax", "jaxlib", "repro"]


@pytest.mark.parametrize("argv", [["--workload", "yi-9b.longdoc"], ["--workload", "no.such"]],
                         ids=["no_card", "unknown_cell"])
def test_the_command_exits_2_and_prints_no_result(monkeypatch, capsys, argv):
    if torch.cuda.is_available() and argv[1] == "yi-9b.longdoc":
        pytest.skip("this machine has a card: the command would run the cell")
    for var in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR"):
        monkeypatch.setenv(var, "unset")
    monkeypatch.setattr(sys, "path", list(sys.path))
    assert run.main(argv + ["--seed", "3", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
