"""repro_torch.core.costs == repro.core.costs on the same fields."""
import dataclasses

import numpy as np
import pytest

# The port's tests need torch.  CI's jax-only tier-1 job installs no torch,
# so there these files skip instead of failing at import.
torch = pytest.importorskip("torch")

from repro.core import costs as ref  # noqa: E402
from repro_torch.convert import cost_model_from_numpy  # noqa: E402
from repro_torch.core import costs as port  # noqa: E402
from repro_torch.core.stepfn import build  # noqa: E402

N = 13
_rng = np.random.default_rng(3)
FIELDS = {
    "scalar": (1.0, 3.0, 3.0),
    "fractional": (1.0, 1.25, 1.25),
    "per_level_P": (np.where(np.arange(N) % 2 == 0, 1.0, 2.0).astype(np.float32), 3.0, 3.0),
    "per_level_all": tuple(
        _rng.uniform(0.5, 4.0, N).astype(np.float32) for _ in range(3)
    ),
    "float64_arrays": (np.full(N, 0.7), np.full(N, 1.1), np.full(N, 0.9)),
}


def _groups(pkg):
    return (
        pkg.ServerGroup("legacy", 5, P=2.0, beta_on=4.0, beta_off=1.0),
        pkg.ServerGroup("efficient", 4, P=1.0, beta_on=1.5, beta_off=1.0),
        pkg.ServerGroup("mid", 3, P=1.5, beta_on=2.0, beta_off=2.0),
    )


def _pair(case):
    if case == "from_groups":
        return ref.CostModel.from_groups(*_groups(ref)), port.CostModel.from_groups(*_groups(port))
    if case == "from_groups_declared":
        return (ref.CostModel.from_groups(*_groups(ref), order=None),
                port.CostModel.from_groups(*_groups(port), order=None))
    f = FIELDS[case]
    return ref.CostModel(*f), port.CostModel(*f)


CASES = list(FIELDS) + ["from_groups", "from_groups_declared"]


@pytest.mark.parametrize("case", CASES)
def test_cost_model_parity(case):
    jc, tc = _pair(case)
    n = jc.n_levels or N
    assert tc.n_levels == jc.n_levels
    assert tc.is_heterogeneous == jc.is_heterogeneous
    assert tc.delta_slots() == jc.delta_slots()
    np.testing.assert_array_equal(np.asarray(tc.delta), np.asarray(jc.delta))
    for t_f, j_f in zip(tc.per_level(n), jc.per_level(n)):
        assert t_f.dtype == torch.float32 and tuple(t_f.shape) == (n,)
        np.testing.assert_array_equal(t_f.numpy(), np.asarray(j_f))
    assert tc.group_sizes == jc.group_sizes and tc.group_names == jc.group_names
    assert tc.n_groups == jc.n_groups and tc.group_offsets == jc.group_offsets
    v = np.random.default_rng(1).uniform(0, 5, (2, 3, n)).astype(np.float32)
    np.testing.assert_allclose(tc.group_reduce(torch.as_tensor(v)).numpy(),
                               np.asarray(jc.group_reduce(v)), rtol=1e-6)


@pytest.mark.parametrize("case", CASES)
def test_cost_model_from_numpy_round_trip(case):
    jc, _ = _pair(case)
    tc = cost_model_from_numpy(
        np.asarray(jc.P), np.asarray(jc.beta_on), np.asarray(jc.beta_off),
        jc.group_sizes, jc.group_names,
    )
    n = jc.n_levels or N
    np.testing.assert_array_equal(np.asarray(tc.delta, np.float32),
                                  np.asarray(jc.delta, np.float32))
    for t_f, j_f in zip(tc.per_level(n), jc.per_level(n)):
        np.testing.assert_array_equal(t_f.numpy(), np.asarray(j_f))
    if jc.groups is None:
        assert tc.groups is None
    else:
        assert [dataclasses.astuple(g) for g in tc.groups] == [
            dataclasses.astuple(g) for g in jc.groups
        ]


def test_per_level_lands_on_the_requested_device():
    P, bon, boff = port.PAPER_COSTS.per_level(4, "cpu")
    assert P.device.type == "cpu" and bon.shape == (4,) and boff.dtype == torch.float32


def test_from_groups_orders_by_energy():
    tc = port.CostModel.from_groups(*_groups(port))
    assert tc.group_names == ("efficient", "mid", "legacy")
    assert tc.group_sizes == (4, 3, 5)
    assert [g.P for g in tc.groups] == [1.0, 1.5, 2.0]


def _raises_alike(fn_ref, fn_port):
    with pytest.raises(ValueError) as e_ref:
        fn_ref()
    with pytest.raises(ValueError) as e_port:
        fn_port()
    assert str(e_port.value) == str(e_ref.value)


@pytest.mark.parametrize("bad", [
    dict(n_servers=0),
    dict(P=0.0),
    dict(beta_on=-1.0),
])
def test_server_group_validation(bad):
    kw = dict(name="g", n_servers=2) | bad
    _raises_alike(lambda: ref.ServerGroup(**kw).validate(),
                  lambda: port.ServerGroup(**kw).validate())


def test_from_groups_validation():
    _raises_alike(lambda: ref.CostModel.from_groups(),
                  lambda: port.CostModel.from_groups())
    _raises_alike(
        lambda: ref.CostModel.from_groups(ref.ServerGroup("a", 1), ref.ServerGroup("a", 2)),
        lambda: port.CostModel.from_groups(port.ServerGroup("a", 1), port.ServerGroup("a", 2)),
    )
    _raises_alike(
        lambda: ref.CostModel.from_groups(ref.ServerGroup("a", 1), order="power"),
        lambda: port.CostModel.from_groups(port.ServerGroup("a", 1), order="power"),
    )


@pytest.mark.parametrize("kw", [
    dict(group_sizes=(2, 2), group_names=("a",)),
    dict(group_sizes=(4, 0), group_names=("a", "b")),
    dict(group_sizes=(2, 3), group_names=("a", "b")),
])
def test_validate_groups_errors(kw):
    P = np.ones(4, np.float32)
    _raises_alike(lambda: ref.CostModel(P=P, **kw).validate_groups(),
                  lambda: port.CostModel(P=P, **kw).validate_groups())


def test_inconsistent_and_pinned_lengths():
    _raises_alike(lambda: ref.CostModel(P=np.ones(3), beta_on=np.ones(4)).n_levels,
                  lambda: port.CostModel(P=np.ones(3), beta_on=np.ones(4)).n_levels)
    _raises_alike(lambda: ref.CostModel(P=np.ones(3)).per_level(5),
                  lambda: port.CostModel(P=np.ones(3)).per_level(5))


def test_schedule_cost_parity():
    from repro.core.stepfn import build as ref_build

    breaks = [(0.0, 2.0), (1.5, 5.0), (4.0, 1.0), (7.0, 3.0)]
    for final in (None, 0.0, 6.0):
        got = port.schedule_cost(build(10.0, breaks), port.PAPER_COSTS, final_level=final)
        want = ref.schedule_cost(ref_build(10.0, breaks), ref.PAPER_COSTS, final_level=final)
        assert got == want
    _raises_alike(
        lambda: ref.schedule_cost(ref_build(1.0, breaks[:1]), ref.CostModel(P=np.ones(2))),
        lambda: port.schedule_cost(build(1.0, breaks[:1]), port.CostModel(P=np.ones(2))),
    )
