"""K1's reason codes, K2's uniforms route and the routes of the engine, on the CPU.

* K1 under ``record`` also returns the per-slot reason codes that
  ``provision(record_decisions=True)`` puts in ``decisions``: its plain
  version must give the reference's ``decisions`` bit for bit, on the
  reference's own wait draws.
* K2's uniforms route draws each wait from the (B, T, N) uniforms where it is
  consumed; its plain version must equal the table route bit for bit, and
  its waits the reference's.
* The engine's kernel routes (K2 on the uniforms route without record, K1
  with it) run here on CPU tensors, through the kernels' plain versions:
  ``provision()``'s and ``provision_stream()``'s results on these routes
  must equal the reference's on the reference's own uniforms, and the plain
  route's; on the card ``chip_smoke.py`` checks that they launch K2 and K1
  and agree with the plain route there.
* K1 and K2 share one slot step: both CUDA sources include
  ``slot_step.cuh`` and neither writes its own update.

Inputs are made with numpy from fixed seeds; nothing here draws at random.
"""
import importlib
import pathlib
import re

import numpy as np
import pytest

# The port's tests need torch.  CI's jax-only tier-1 job installs no torch,
# so there these files skip instead of failing at import.
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as ref  # noqa: E402
import repro_torch as port  # noqa: E402
from repro.core import jax_provision as ref_engine  # noqa: E402
from repro.core.jax_provision import _uniforms as ref_uniforms  # noqa: E402
from repro_torch.convert import cost_model_from_numpy, uniforms_from_numpy  # noqa: E402
from repro_torch.core import torch_provision as engine  # noqa: E402
from repro_torch.kernels import provision_scan as kernels  # noqa: E402
from repro_torch.obs import provenance as prov  # noqa: E402

port_provision = importlib.import_module("repro_torch.core.provision")

B, T = 3, 48
KEY_SEED = 31
WINDOWS = [0, 2, 5]
COSTS = (2.0, 3.0, 3.0)                  # P, beta_on, beta_off: Δ = 3
CSRC = pathlib.Path(kernels.__file__).resolve().parent / "csrc"


def _demand(seed, top=12):
    rng = np.random.default_rng(seed)
    t = np.arange(T)
    phase = rng.uniform(0, 2 * np.pi, (B, 1))
    wave = top / 2 * (1 + 0.8 * np.sin(2 * np.pi * t / 13 + phase))
    return np.clip(np.rint(wave) + rng.integers(-2, 3, (B, T)), 0, top).astype(np.int32)


def _ref_uniforms(a, n):
    """The reference's wait uniforms for ``a`` (B, T), keyed as its
    ``provision()`` keys them."""
    keys = jax.random.split(jax.random.key(KEY_SEED), a.shape[0])
    u0, u = jax.vmap(lambda k: ref_uniforms(k, a.shape[-1], n))(keys)
    return np.array(u0), np.array(u)


def _port_spec(a, policy, u):
    return port.ProvisionSpec(
        costs=cost_model_from_numpy(*(np.float32(c) for c in COSTS)),
        workload=port.Workload(demand=a),
        policy=port.PolicySpec(policy, windows=WINDOWS,
                               uniforms=None if u is None
                               else uniforms_from_numpy(*u, device="cpu")),
        device="cpu")


def _grid(spec, *, uniform_waits=False):
    """K1's (K2's) keyword arguments for ``spec``, as ``provision()`` makes
    them, and the cell grid's shape."""
    pol = spec.policy.validate()
    pr = port_provision._prepare(spec, pol, torch.device("cpu"))
    inputs, grid = engine._grid_inputs(
        pr["ab"], pr["predb"], pr["windows"], pr["delta_lv"], pr["uniforms"],
        n_levels=pr["n_levels"], max_h=pr["max_h"], policy=pol.name,
        uniform_waits=uniform_waits)
    return inputs, grid


@pytest.mark.parametrize("policy", ["A1", "A2", "A3", "delayedoff"])
def test_k1_codes_equal_reference_decisions(policy):
    a = _demand(1)
    n = int(a.max()) + 1
    u = _ref_uniforms(a, n) if policy in engine.KEYED else None
    want = ref.provision(ref.ProvisionSpec(
        costs=ref.CostModel(*COSTS), workload=ref.Workload(demand=jnp.asarray(a)),
        policy=ref.PolicySpec(policy, windows=jnp.asarray(WINDOWS),
                              key=jax.random.key(KEY_SEED)),
    ), record_decisions=True)
    inputs, (S, Wc, Bc) = _grid(_port_spec(a, policy, u))
    ons, counts, codes = kernels.provision_scan_grid(**inputs, record=True, codes=True)
    assert codes.dtype == torch.uint8 and tuple(codes.shape) == (S * Wc * Bc, T, n)
    codes = codes.reshape(Wc, Bc, T, n).expand(len(WINDOWS), Bc, T, n)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want.decisions))
    np.testing.assert_array_equal(
        ons.reshape(Wc, Bc, T, n).sum(-1, dtype=torch.int32).expand(len(WINDOWS), Bc, T)
        .numpy(), np.asarray(want.x))
    for i, name in enumerate(prov.COUNT_ORDER):
        np.testing.assert_array_equal(
            counts[:, i].reshape(Wc, Bc, n).expand(len(WINDOWS), Bc, n).numpy(),
            np.asarray(want.decision_counts[name]), err_msg=name)
    # the case exercises every reason
    for bit in prov.COUNT_BITS:
        assert bool((codes & bit).any()) or (policy == "delayedoff" and bit == 4), bit


@pytest.mark.parametrize("record", [False, True], ids=["plain", "record"])
@pytest.mark.parametrize("policy", ["A2", "A3", "AQ-rand"])
def test_uniforms_route_equals_table_route(policy, record):
    """K2's uniforms route, plain version, against the table route: bit for
    bit at a tile of 20 slots (48 = 20 + 20 + 8, a part tile at the end),
    chained across a cut through the carry."""
    a = _demand(2)
    n = int(a.max()) + 1
    u = tuple(np.random.default_rng(3 + i).uniform(size=(B, T, n)).astype(np.float32)
              for i in range(2))
    spec = _port_spec(a, policy, u)
    table, _ = _grid(spec)
    drawn, _ = _grid(spec, uniform_waits=True)
    assert isinstance(drawn["thresholds"], engine.UniformWaits)
    assert (drawn["thresholds"].p0 is None) == (policy != "A3")
    for args in (table, drawn):
        del args["delta"]
    got = kernels.provision_scan_stream(**drawn, t_chunk=20, record=record)
    want = kernels.provision_scan_stream(**table, t_chunk=20, record=record)
    assert torch.equal(got[0], want[0])
    assert sorted(got[1]) == sorted(want[1])
    for k in want[1]:
        assert torch.equal(got[1][k], want[1][k]), k
    for k in want[2]:
        assert torch.equal(got[2][k], want[2][k]), k
    assert int(want[1]["down"].sum()) > 0                   # levels turned off

    def halves(args, sl):
        part = dict(args, traces=args["traces"][:, sl], predicted=args["predicted"][:, sl])
        thr = args["thresholds"]
        if isinstance(thr, engine.UniformWaits):
            part["thresholds"] = thr._replace(
                u=thr.u[:, sl], u0=None if thr.u0 is None else thr.u0[:, sl])
        else:
            part["thresholds"] = thr[:, sl]
        return part

    ends = []
    for args in (drawn, table):
        one = kernels.provision_scan_stream(**halves(args, slice(None, 29)), t_chunk=20,
                                            record=record)
        ends.append(kernels.provision_scan_stream(**halves(args, slice(29, None)), t_chunk=20,
                                                  record=record, carry=one[2]))
    assert torch.equal(ends[0][0], ends[1][0])
    for k in ends[1][1]:
        assert torch.equal(ends[0][1][k], ends[1][1][k]), k


@pytest.mark.parametrize("policy", ["A2", "A3", "AQ-rand"])
def test_uniform_waits_equal_the_table_route_waits(policy):
    """The uniforms route's waits (the probe's plain version) against the
    reference's ``_waits_from_uniforms`` on the same uniforms: the atom
    exactly, the rest within the few ulp of the two ``log1p``s (rtol 1e-6,
    as tests/test_torch_engine.py holds the table route); and equal to the
    port's table route in every bit."""
    a = _demand(4)
    n = int(a.max()) + 1
    u0, u = (np.random.default_rng(5 + i).uniform(size=(B, T, n)).astype(np.float32)
             for i in range(2))
    delta = np.full((n,), 3.0, np.float32)
    windows = [0] if policy == "AQ-rand" else WINDOWS
    span, p0 = engine._wait_rows(policy, windows, torch.as_tensor(delta))
    for k, w in enumerate(windows):
        got = kernels._uniform_waits_probe(
            None if p0 is None else torch.as_tensor(u0), torch.as_tensor(u), span[k],
            None if p0 is None else p0[k])
        want = np.asarray(ref_engine._waits_from_uniforms(policy, u0, u, w, jnp.asarray(delta)))
        np.testing.assert_array_equal(got.numpy() == 0.0, want == 0.0)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
        assert torch.equal(got, engine._waits_from_uniforms(
            policy, torch.as_tensor(u0), torch.as_tensor(u), w, torch.as_tensor(delta)))
    if policy == "A3":
        assert bool((want == 0).any())                      # the atom


RUN_POLICIES = ["A1", "A2", "A3", "delayedoff", "AQ-det", "AQ-rand"]


@pytest.mark.parametrize("record", [False, True], ids=["plain", "record"])
@pytest.mark.parametrize("policy", RUN_POLICIES)
def test_kernel_routes_of_run_equal_the_plain_route(policy, record):
    """``_run(kernel=True)`` — K2 without record, K1 with it — on CPU tensors
    runs the kernels' plain versions: every output equals the plain route's."""
    a = _demand(6)
    n = int(a.max()) + 1
    u = _ref_uniforms(a, n) if policy in engine.KEYED else None
    spec = _port_spec(a, policy, u)
    pr = port_provision._prepare(spec, spec.policy.validate(), torch.device("cpu"))
    args = (pr["ab"], pr["predb"], pr["windows"], pr["delta_lv"], pr["P_lv"], pr["bon_lv"],
            pr["boff_lv"], pr["uniforms"])
    kw = dict(n_levels=pr["n_levels"], max_h=pr["max_h"], policy=policy, record=record)
    got = engine._run(*args, **kw, kernel=True)
    want = engine._run(*args, **kw, kernel=False)
    # the K1 route also hands over K1's counters: the codes' sums
    counts = got.pop("decision_counts", None)
    assert (counts is not None) == record
    assert sorted(got) == sorted(want)
    assert ("decisions" in got) == record
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    if record:
        for i, bit in enumerate(prov.COUNT_BITS):
            assert torch.equal(counts[..., i, :],
                               ((want["decisions"] & bit) != 0).sum(-2, dtype=torch.int32))


def _ref_spec(a, policy):
    return ref.ProvisionSpec(
        costs=ref.CostModel(*COSTS), workload=ref.Workload(demand=jnp.asarray(a)),
        policy=ref.PolicySpec(policy, windows=jnp.asarray(WINDOWS),
                              key=jax.random.key(KEY_SEED)))


def _spy_stream(monkeypatch):
    """Record, for every call of K2's wrapper, whether it took the uniforms
    route."""
    routes = []
    real = kernels.provision_scan_stream

    def spy(*args, **kw):
        routes.append(isinstance(kw["thresholds"], engine.UniformWaits))
        return real(*args, **kw)

    monkeypatch.setattr(kernels, "provision_scan_stream", spy)
    return routes


def _assert_result_equal(got, want, *, decisions):
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
    np.testing.assert_array_equal(got.level_cost.numpy(), np.asarray(want.level_cost))
    for name in ("cost", "energy", "toggle_cost"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    if decisions:
        np.testing.assert_array_equal(got.decisions.numpy(), np.asarray(want.decisions))
    if want.decision_counts is not None:
        assert sorted(got.decision_counts) == sorted(want.decision_counts)
        for k, v in want.decision_counts.items():
            np.testing.assert_array_equal(got.decision_counts[k].numpy(), np.asarray(v),
                                          err_msg=k)


@pytest.mark.parametrize("record", [False, True], ids=["plain", "record"])
@pytest.mark.parametrize("policy", RUN_POLICIES)
def test_kernel_routes_of_provision_equal_the_reference(policy, record, monkeypatch):
    """``provision()``'s kernel routes on CPU tensors — K2 (the uniforms
    route for the keyed policies) without record, K1 with it — against the
    reference's ``provision()`` on its own uniforms: x, every cost, and
    under record the decisions and their counts, bit for bit."""
    a = _demand(6)
    n = int(a.max()) + 1
    u = _ref_uniforms(a, n) if policy in engine.KEYED else None
    routes = _spy_stream(monkeypatch)
    got = port_provision._provision(_port_spec(a, policy, u), record_decisions=record,
                                    kernel=True)
    assert routes == ([] if record else [policy in engine.KEYED])
    want = ref.provision(_ref_spec(a, policy), record_decisions=record)
    _assert_result_equal(got, want, decisions=record)
    assert (got.decisions is None) == (not record)


@pytest.mark.parametrize("policy", ["A2", "A3", "AQ-rand"])
def test_uniforms_route_of_provision_stream_equals_the_reference(policy, monkeypatch):
    """``provision_stream()`` takes K2's uniforms route for the keyed
    policies; at a tile of 20 slots (a part tile at the end) its result
    equals the reference's ``provision_stream()`` on the reference's own
    uniforms, decision counts included, bit for bit."""
    a = _demand(9)
    n = int(a.max()) + 1
    routes = _spy_stream(monkeypatch)
    got = port.provision_stream(_port_spec(a, policy, _ref_uniforms(a, n)), t_chunk=20,
                                record_decisions=True)
    assert routes == [True]
    want = ref.provision_stream(_ref_spec(a, policy), t_chunk=20, record_decisions=True)
    _assert_result_equal(got, want, decisions=False)
    assert int(got.decision_counts["toggle_off"].sum()) > 0


def test_k1_codes_need_record_and_tables():
    a = _demand(7)
    spec = _port_spec(a, "A2", _ref_uniforms(a, int(a.max()) + 1))
    inputs, _ = _grid(spec)
    with pytest.raises(ValueError, match="record=True"):
        kernels.provision_scan_grid(**inputs, codes=True)
    drawn, _ = _grid(spec, uniform_waits=True)
    with pytest.raises(ValueError, match="uniforms route is K2's"):
        kernels.provision_scan_grid(**drawn)


@pytest.mark.parametrize("bad, match", [
    (lambda n: dict(u=np.zeros((B, T - 1, n), np.float32)), "uniforms must be"),
    (lambda n: dict(span=np.zeros((3, n - 1), np.float32)), "span must be"),
    (lambda n: dict(p0=None), "come together"),
    (lambda n: dict(cell=np.zeros(4, np.int32)), "cell map has"),
    (lambda n: dict(cell=np.full(9, B, np.int32)), "indexes rows"),
], ids=["u", "span", "p0", "cell-rows", "cell-range"])
def test_uniforms_route_rejects_bad_arguments(bad, match):
    a = _demand(8)
    n = int(a.max()) + 1
    drawn, _ = _grid(_port_spec(a, "A3", _ref_uniforms(a, n)), uniform_waits=True)
    del drawn["delta"]
    thr = drawn["thresholds"]
    drawn["thresholds"] = thr._replace(**{k: None if v is None else torch.as_tensor(v)
                                          for k, v in bad(n).items()})
    with pytest.raises(ValueError, match=match):
        kernels.provision_scan_stream(**drawn)


def _source(name):
    return (CSRC / name).read_text()


@pytest.mark.parametrize("name", ["provision_scan.cu", "provision_scan_stream.cu"])
def test_both_scan_kernels_run_the_shared_slot_step(name):
    src = _source(name)
    assert '#include "slot_step.cuh"' in src
    assert "scan_cell<" in src                      # the shared loop
    # no update of its own: the idle clock, the wait compare and the
    # dispatcher turn-on are written in slot_step.cuh only
    for pattern in (r"\+=\s*1\.f", r"-\s*1\.f\s*>=", r"on\s*\|\|\s*busy", r"slot_step\("):
        assert not re.search(pattern, src), pattern


def test_slot_step_defines_the_update_once():
    src = _source("slot_step.cuh")
    assert len(re.findall(r"uint32_t slot_step\(", src)) == 1
    assert len(re.findall(r"-\s*1\.f\s*>=", src)) == 1
    assert len(re.findall(r"\+=\s*1\.f", src)) == 1
    # no fast math, and the inverse CDF's products rounded one by one
    assert "__expf" not in src and "__logf" not in src
    assert "__fmul_rn(u, kEMinus1)" in src
