"""repro_torch.deferral == repro.deferral, bit for bit, on the CPU.

The same numpy-made arrivals and capacities go through both packages'
``due_envelope``, ``defer_demand``, ``queue_scan`` and the streaming twins
(``defer_stream``, ``queue_stream``, ``queue_stream_finalize``): every
output must be equal, for the four dispatch rules, scalar and per-slot
slack, with and without a cap.  The port's functions take a batch of rows
where the reference takes one, so each reference row is compared with its
row of one port call.  The laws of ``tests/test_deferral.py`` are carried
over on a seeded sweep (no ``hypothesis``: every draw is from a seeded
numpy generator), the reference's one known law violation is pinned to its
own numbers, and ``provision()`` / ``provision_stream()`` with
``Workload(deferral=...)`` are held to the reference on every leaf.
"""
import numpy as np
import pytest

# The port's tests need torch.  CI's jax-only tier-1 job installs no torch,
# so there these files skip instead of failing at import.
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as ref  # noqa: E402
import repro.deferral as rdef  # noqa: E402
import repro_torch as port  # noqa: E402
import repro_torch.deferral as pdef  # noqa: E402
from repro.core.jax_provision import KEYED  # noqa: E402
from repro.core.jax_provision import _uniforms as ref_uniforms  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    cost_model_from_numpy,
    uniforms_from_numpy,
)

R = 3                       # rows per port call
K = 6                       # the queue's bucket bound in the law checks
KEY_SEED = 31
QUEUE_FIELDS = ("backlog", "served_by_age", "deadline_misses", "unserved",
                "max_delay", "p99_delay")


def _trace(rng, n):
    burst = (rng.random(n) < 0.08) * rng.integers(10, 25)
    return (rng.poisson(rng.uniform(2, 12), n) + burst).astype(np.int32)


def _rows(seed, T=None):
    rng = np.random.default_rng(seed)
    T = T or int(rng.integers(8, 49))
    a = np.stack([_trace(rng, T) for _ in range(R)])
    x = np.stack([_trace(rng, T) for _ in range(R)])
    return rng, a, x


def _slack(rng, kind, T):
    if kind == "scalar":
        return int(rng.integers(0, K + 1))
    # per-slot, non-monotone deadlines included
    return rng.integers(0, K + 1, T).astype(np.int32)


def _t(v):
    return torch.as_tensor(np.asarray(v))


def _eq(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


# ---------------------------------------------------------------------------
# the primitives, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [None, "peak", "tight"])
@pytest.mark.parametrize("slack_kind", ["scalar", "per_slot"])
@pytest.mark.parametrize("seed", range(3))
def test_defer_demand_and_envelope_match_reference(seed, slack_kind, cap):
    rng, a, _ = _rows(seed)
    T = a.shape[1]
    slack = _slack(rng, slack_kind, T)
    c = {None: None, "peak": int(a.max()), "tight": max(int(a.mean()), 1)}[cap]
    got = pdef.defer_demand(_t(a), _t(slack), cap=c)
    env = pdef.due_envelope(_t(a), _t(slack))
    assert got.dtype == env.dtype == torch.int32
    for r in range(R):
        _eq(got[r], rdef.defer_demand(jnp.asarray(a[r]), jnp.asarray(slack), cap=c),
            f"defer_demand row {r}")
        _eq(env[r], rdef.due_envelope(jnp.asarray(a[r]), jnp.asarray(slack)),
            f"due_envelope row {r}")
    # one trace, unbatched
    _eq(pdef.defer_demand(_t(a[0]), _t(slack), cap=c),
        rdef.defer_demand(jnp.asarray(a[0]), jnp.asarray(slack), cap=c), "unbatched")


@pytest.mark.parametrize("rule", rdef.RULES)
@pytest.mark.parametrize("slack_kind", ["scalar", "per_slot"])
@pytest.mark.parametrize("seed", range(3))
def test_queue_scan_matches_reference(seed, slack_kind, rule):
    rng, a, x = _rows(seed + 10)
    slack = _slack(rng, slack_kind, a.shape[1])
    got = pdef.queue_scan(_t(a), _t(x), _t(slack), rule=rule, max_slack=K)
    for r in range(R):
        want = rdef.queue_scan(jnp.asarray(a[r]), jnp.asarray(x[r]), jnp.asarray(slack),
                               rule=rule, max_slack=K)
        for f in QUEUE_FIELDS:
            assert got[f].dtype == torch.int32, f
            _eq(got[f][r], want[f], f"{rule} {f} row {r}")


@pytest.mark.parametrize("cap", [None, 9])
@pytest.mark.parametrize("slack", [0, 1, 4])
@pytest.mark.parametrize("seed", range(2))
def test_defer_stream_matches_reference_across_cuts(seed, slack, cap):
    rng, a, _ = _rows(seed + 20, T=40)
    cuts = (0, 7, 8, 23, 40)                      # chunks of 7, 1, 15 and 17 slots
    valid = rng.random(40) < 0.85
    state = pdef.defer_stream_init(slack, (R,), device="cpu")
    outs = []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        o, state = pdef.defer_stream(_t(a[:, lo:hi]), state, slack=slack, cap=cap,
                                     valid=_t(valid[lo:hi]))
        outs.append(o)
    got = torch.cat(outs, dim=1)
    for r in range(R):
        rs = rdef.defer_stream_init(slack)
        want = []
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            o, rs = rdef.defer_stream(jnp.asarray(a[r, lo:hi]), rs, slack=slack, cap=cap,
                                      valid=jnp.asarray(valid[lo:hi]))
            want.append(np.asarray(o))
        _eq(got[r], np.concatenate(want), f"defer_stream row {r}")
        _eq(state["awin"][r], rs["awin"], "awin")
        _eq(state["served"][r], rs["served"], "served")


@pytest.mark.parametrize("rule", rdef.RULES)
@pytest.mark.parametrize("seed", range(2))
def test_queue_stream_matches_reference_across_cuts(seed, rule):
    rng, a, x = _rows(seed + 30, T=40)
    cuts = (0, 1, 14, 40)
    valid = rng.random(40) < 0.85
    state = pdef.queue_stream_init(K, (R,), device="cpu")
    backlog = []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        b, state = pdef.queue_stream(_t(a[:, lo:hi]), _t(x[:, lo:hi]), state, rule=rule,
                                     max_slack=K, valid=_t(valid[lo:hi]))
        backlog.append(b)
    got = torch.cat(backlog, dim=1)
    fin = pdef.queue_stream_finalize(state, max_slack=K)
    for r in range(R):
        rs = rdef.queue_stream_init(K)
        want = []
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            b, rs = rdef.queue_stream(jnp.asarray(a[r, lo:hi]), jnp.asarray(x[r, lo:hi]), rs,
                                      rule=rule, max_slack=K, valid=jnp.asarray(valid[lo:hi]))
            want.append(np.asarray(b))
        _eq(got[r], np.concatenate(want), f"{rule} backlog row {r}")
        for k in ("w", "miss", "hist"):
            _eq(state[k][r], rs[k], f"{rule} carry {k}")
        rfin = rdef.queue_stream_finalize(rs, max_slack=K)
        for k, v in rfin.items():
            _eq(fin[k][r], v, f"{rule} finalize {k}")


def test_queue_stream_unbatched_equals_queue_scan_at_scalar_slack():
    _, a, x = _rows(40, T=30)
    state = pdef.queue_stream_init(K, device="cpu")
    b, state = pdef.queue_stream(_t(a[0]), _t(x[0]), state, rule="EDF", max_slack=K)
    fin = pdef.queue_stream_finalize(state, max_slack=K)
    scan = pdef.queue_scan(_t(a[0]), _t(x[0]), K, rule="EDF", max_slack=K)
    _eq(b, scan["backlog"].numpy(), "backlog")
    for k, v in fin.items():
        _eq(v, scan[k].numpy(), k)


# ---------------------------------------------------------------------------
# the laws of tests/test_deferral.py, on the port
# ---------------------------------------------------------------------------

def _cum(a):
    return np.cumsum(np.asarray(a, np.int64))


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.mark.parametrize("seed", range(4))
def test_deferral_laws_seeded_sweep(seed):
    rng = np.random.default_rng(seed)
    for _ in range(8):
        a = _t(_trace(rng, int(rng.integers(8, 49))))
        x = _t(_trace(rng, a.shape[0]))
        slack = int(rng.integers(0, 7))
        d = _np(pdef.defer_demand(a, slack))
        # conservation, causality, feasibility
        assert (d >= 0).all() and d.sum() == int(a.sum())
        assert (_cum(d) <= _cum(a)).all()
        assert (_cum(d) >= _np(pdef.due_envelope(a, slack))).all()
        # never roughens
        an = _np(a).astype(np.int64)
        assert d.max() <= an.max()
        assert np.abs(np.diff(d, prepend=0)).sum() <= np.abs(np.diff(an, prepend=0)).sum()
        # zero slack is the identity; the peak falls with slack
        _eq(pdef.defer_demand(a, 0), _np(a), "zero slack")
        s = max(slack, 1)
        assert _np(pdef.defer_demand(a, s)).max() <= _np(pdef.defer_demand(a, s - 1)).max()
        # a cap at the raw peak is feasible
        cap = max(int(a.max()), 1)
        dc = _np(pdef.defer_demand(a, s, cap=cap))
        assert dc.max() <= cap and dc.sum() == int(a.sum())
        # the queue's accounting closes under every rule
        for rule in pdef.RULES:
            m = pdef.queue_scan(a, x, slack, rule=rule, max_slack=K)
            assert int(m["served_by_age"].sum()) + int(m["unserved"]) == int(a.sum())
            assert int(m["backlog"][-1]) == int(m["unserved"])
            assert (_np(m["backlog"]) >= 0).all()
        # provisioning the deferred profile under EDF meets every deadline
        m = pdef.queue_scan(a, _t(d), slack, rule="EDF", max_slack=K)
        assert int(m["deadline_misses"]) == 0 and int(m["unserved"]) == 0
        assert int(m["max_delay"]) <= slack
        assert int(m["p99_delay"]) <= int(m["max_delay"])
        # EDF misses no more than FIFO (on these draws; see the next test)
        edf = pdef.queue_scan(a, x, slack, rule="EDF", max_slack=K)
        fifo = pdef.queue_scan(a, x, slack, rule="FIFO", max_slack=K)
        assert int(edf["deadline_misses"]) <= int(fifo["deadline_misses"])


def test_reference_edf_fifo_fault_reproduced():
    """The reference's queue counts 2 EDF misses and 1 FIFO miss on this
    example, against its own EDF-dominance law (``tests/test_deferral.py::
    check_edf_dominates_fifo``; the unsteady ``hypothesis`` failure of
    ROADMAP § 3).  The port is held to the reference, so it counts the same;
    this pins both to those numbers, so a fix in either shows here."""
    a = np.array([0] * 11 + [1, 0, 1], np.int32)
    x = np.array([0] * 13 + [1], np.int32)
    for rule, misses in (("EDF", 2), ("FIFO", 1)):
        want = rdef.queue_scan(jnp.asarray(a), jnp.asarray(x), 1, rule=rule, max_slack=K)
        got = pdef.queue_scan(_t(a), _t(x), 1, rule=rule, max_slack=K)
        assert int(want["deadline_misses"]) == int(got["deadline_misses"]) == misses
        for f in QUEUE_FIELDS:
            _eq(got[f], want[f], f"{rule} {f}")


# ---------------------------------------------------------------------------
# DeferralSpec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad", [dict(rule="LIFO"), dict(cap=0), dict(slack=-1),
                                 dict(slack=np.zeros((2, 3), np.int32))])
def test_spec_validation_matches_reference(bad):
    with pytest.raises(ValueError) as want:
        rdef.DeferralSpec(**bad).validate()
    with pytest.raises(ValueError) as got:
        pdef.DeferralSpec(**bad).validate()
    assert str(got.value).split(" ")[:3] == str(want.value).split(" ")[:3]


def test_spec_apply_and_metrics_keep_sweep_axes():
    rng, a, _ = _rows(50, T=24)
    slack = rng.integers(0, 4, 24).astype(np.int32)
    rspec = rdef.DeferralSpec(slack=slack, rule="SPT", max_slack=5)
    pspec = pdef.DeferralSpec(slack=slack, rule="SPT", max_slack=5)
    _eq(pspec.apply(_t(a)), rspec.apply(jnp.asarray(a)), "apply")
    x = rng.integers(0, 15, (2, 3, R, 24)).astype(np.int32)
    want = rspec.metrics(jnp.asarray(a), jnp.asarray(x))
    got = pspec.metrics(_t(a), _t(x))
    for f in QUEUE_FIELDS:
        _eq(got[f], want[f], f)
    with pytest.raises(ValueError, match="per-slot slack has length"):
        pdef.DeferralSpec(slack=slack[:5]).apply(_t(a))


# ---------------------------------------------------------------------------
# provision() and provision_stream() with deferral, every leaf
# ---------------------------------------------------------------------------

B, T = 3, 48
RESULT_FIELDS = ("x", "cost", "energy", "toggle_cost", "level_cost", "group_cost",
                 "backlog", "max_delay", "p99_delay", "deadline_misses", "unserved")


def _demand(seed):
    rng = np.random.default_rng(seed)
    t = np.arange(T)
    phase = rng.uniform(0, 2 * np.pi, (B, 1))
    wave = 6 * (1 + 0.8 * np.sin(2 * np.pi * t / 17 + phase))
    return np.clip(np.rint(wave) + rng.integers(-2, 3, (B, T)), 0, 12).astype(np.int32)


def _costs(typed):
    if typed:
        return ref.CostModel.from_groups(
            ref.ServerGroup("small", 8, P=1.0, beta_on=2.0, beta_off=2.0),
            ref.ServerGroup("big", 10, P=2.5, beta_on=4.0, beta_off=4.0),
        )
    return ref.PAPER_COSTS


def _ref_uniforms(policy, n):
    if policy not in KEYED:
        return None
    keys = jax.random.split(jax.random.key(KEY_SEED), B)
    u0, u1 = jax.vmap(lambda k: ref_uniforms(k, T, n))(keys)
    return uniforms_from_numpy(np.array(u0), np.array(u1), device="cpu")


def _pair(a, policy, costs, slack, n_levels=18, windows=(0, 2)):
    """The reference's and the port's spec of one deferred workload."""
    rd = None if slack is None else rdef.DeferralSpec(slack=slack)
    pd = None if slack is None else pdef.DeferralSpec(slack=slack)
    n = costs.n_levels or n_levels
    kw = {} if policy in ("offline", "AQ-det", "AQ-rand", "delayedoff") else dict(
        windows=list(windows))
    rspec = ref.ProvisionSpec(
        costs=costs, workload=ref.Workload(demand=jnp.asarray(a), deferral=rd),
        policy=ref.PolicySpec(policy, key=jax.random.key(KEY_SEED),
                              **{k: jnp.asarray(v) for k, v in kw.items()}),
        n_levels=None if costs.n_levels else n_levels,
    )
    tcosts = cost_model_from_numpy(np.asarray(costs.P), np.asarray(costs.beta_on),
                                   np.asarray(costs.beta_off), costs.group_sizes,
                                   costs.group_names)
    pspec = port.ProvisionSpec(
        costs=tcosts, workload=port.Workload(demand=a, deferral=pd),
        policy=port.PolicySpec(policy, uniforms=_ref_uniforms(policy, n), **kw),
        n_levels=None if costs.n_levels else n_levels, device="cpu",
    )
    return rspec, pspec


def _assert_leaves(want, got, exact=True):
    for f in RESULT_FIELDS:
        w, g = getattr(want, f), getattr(got, f)
        assert (w is None) == (g is None), f
        if w is None:
            continue
        g = g.numpy()
        assert g.shape == np.asarray(w).shape, f
        if exact or f in ("x", "level_cost", "backlog", "max_delay", "p99_delay",
                          "deadline_misses", "unserved"):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=f)
        else:
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, err_msg=f)


@pytest.mark.parametrize("slack", [0, 2, 5])
@pytest.mark.parametrize("policy", ref.POLICIES)
def test_provision_with_deferral_matches_reference(policy, slack):
    a = _demand(1)
    rspec, pspec = _pair(a, policy, ref.PAPER_COSTS, slack)
    want, got = ref.provision(rspec), port.provision(pspec)
    assert got.backlog is not None and got.backlog.dtype == torch.int32
    _assert_leaves(want, got)


def test_zero_slack_is_the_rigid_fixed_point():
    a = _demand(2)
    rigid = port.provision(_pair(a, "A1", ref.PAPER_COSTS, None)[1])
    zero = port.provision(_pair(a, "A1", ref.PAPER_COSTS, 0)[1])
    for f in ("x", "cost", "level_cost"):
        assert torch.equal(getattr(rigid, f), getattr(zero, f)), f
    assert int(zero.deadline_misses.sum()) == int(zero.unserved.sum()) == 0
    assert int(zero.max_delay.max()) == 0 and rigid.backlog is None


@pytest.mark.parametrize("typed", [False, True], ids=["paper", "typed"])
@pytest.mark.parametrize("slack", [None, 3])
@pytest.mark.parametrize("policy", [p for p in ref.POLICIES if p != "offline"])
def test_provision_stream_with_deferral_matches_reference(policy, slack, typed):
    """The reference's streaming exactness matrix (``tests/test_streaming.py``):
    slack {None, 3} × typed × ``t_chunk`` {1, 13, 96}, across packages."""
    a = _demand(3)
    costs = _costs(typed)
    rspec, pspec = _pair(a, policy, costs, slack, windows=(2,))
    want = ref.provision_stream(rspec, t_chunk=13)
    exact = not typed
    for tc in (1, 13, 96):
        _assert_leaves(want, port.provision_stream(pspec, t_chunk=tc), exact)
    _assert_leaves(ref.provision(rspec), port.provision(pspec), exact)
