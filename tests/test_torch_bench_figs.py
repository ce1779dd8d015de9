"""repro_torch.bench.paper_figs == benchmarks/paper_figs.py, on the CPU.

The twin's Fig. 3/4b engine sweep (``_sweep_mean_costs``) gets the
reference's own wait uniforms (its key split per trace, as its
``provision()`` splits it) and Fig. 4c the reference's prediction-noise
normals, through the injection points; their mean costs must equal the
reference's to rtol 1e-6.  The draw-free rows (offline, static, LCP, A1,
DELAYEDOFF, Fig. 4d) must print the reference's derived values.  The runs
are cut to 2 replicas (Fig. 3) and the twin's timing loop to one timed
call; neither changes a cost.
"""
import numpy as np
import pytest

# The port's tests need torch.  CI's jax-only tier-1 job installs no torch,
# so there these files skip instead of failing at import.
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks import paper_figs as ref  # noqa: E402
from repro.core.jax_provision import _uniforms as ref_uniforms  # noqa: E402
from repro_torch.bench import paper_figs as port  # noqa: E402
from repro_torch.convert import normals_from_numpy, uniforms_from_numpy  # noqa: E402

WINDOWS = np.arange(0, 6)
RUNS = 2                 # Fig. 3's replicas, cut from 30


@pytest.fixture(scope="module")
def week():
    a = port._trace()
    assert np.array_equal(a, ref._trace())
    return a


def _ref_uniforms(a, runs, seed=0):
    """The reference's wait uniforms for ``runs`` copies of ``a`` under
    ``jax.random.key(seed)``, split per trace as its provision() splits it."""
    keys = jax.random.split(jax.random.key(seed), runs)
    u0, u = jax.vmap(lambda k: ref_uniforms(k, a.shape[-1], int(a.max()) + 1))(keys)
    return uniforms_from_numpy(np.array(u0), np.array(u), device="cpu")


@pytest.fixture(scope="module")
def fig3_means(week):
    """{policy: (reference's, twin's)} (W,) mean costs over Fig. 3's
    windows at ``RUNS`` replicas, the twin given the reference's draws."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port, "TIMED_CALLS", 1)
        for policy in ("A1", "A2", "A3"):
            want, _ = ref._sweep_mean_costs(week, policy, WINDOWS, RUNS)
            u = _ref_uniforms(week, RUNS) if policy in ("A2", "A3") else None
            got, us = port._sweep_mean_costs(week, policy, WINDOWS, RUNS, device="cpu",
                                             uniforms=u)
            assert us > 0
            out[policy] = (np.asarray(want), got)
    return out


@pytest.mark.parametrize("policy", ["A1", "A2", "A3"])
def test_sweep_mean_costs_equal_reference(fig3_means, policy):
    want, got = fig3_means[policy]
    assert got.shape == (len(WINDOWS),)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _derived(rows):
    """{name: derived} of CSV rows (the time column dropped)."""
    return {r.split(",")[0]: r.split(",", 2)[2] for r in rows}


def _cached(means):
    """A stand-in for ``_sweep_mean_costs`` that returns ``means[policy]``."""
    def sweep(a, policy, windows, runs, seed=0, **kw):
        return means[policy], 1.0
    return sweep


@pytest.mark.parametrize("side", [0, 1])
def test_fig3_rows_equal_reference(fig3_means, monkeypatch, side):
    """Fig. 3's rows from the same mean costs (side 0: the reference's, 1: the
    twin's): the twin prints the reference's alpha, empirical and bound."""
    means = {p: v[side] for p, v in fig3_means.items()}
    monkeypatch.setattr(ref, "_sweep_mean_costs", _cached(means))
    monkeypatch.setattr(port, "_sweep_mean_costs", _cached(means))
    want, got = [], []
    ref.fig3_competitive_ratios(want)
    port.fig3_competitive_ratios(got, device="cpu")
    assert [r.split(",")[0] for r in got] == [r.split(",")[0] for r in want]
    assert _derived(got) == _derived(want)
    assert len(got) == 18


def test_fig3_bound_violation_stops_the_run(fig3_means, monkeypatch):
    means = {p: v[1] * 10.0 for p, v in fig3_means.items()}
    monkeypatch.setattr(port, "_sweep_mean_costs", _cached(means))
    with pytest.raises(AssertionError):
        port.fig3_competitive_ratios([], device="cpu")


def test_fig4b_draw_free_rows_equal_reference(monkeypatch):
    """offline, A1 at windows 0..10, LCP w1..10 and DELAYEDOFF: the same
    reductions; the drawn A2/A3 rows are held by the mean-cost test above."""
    monkeypatch.setattr(port, "TIMED_CALLS", 1)
    for module in (ref, port):
        real = module._sweep_mean_costs

        def sweep(a, policy, windows, runs, seed=0, _real=real, **kw):
            if policy in ("A2", "A3"):
                return np.zeros(len(windows)), 1.0
            return _real(a, policy, windows, runs, seed, **kw)

        monkeypatch.setattr(module, "_sweep_mean_costs", sweep)
    want, got = [], []
    ref.fig4b_cost_reduction_vs_window(want)
    port.fig4b_cost_reduction_vs_window(got, device="cpu")
    assert [r.split(",")[0] for r in got] == [r.split(",")[0] for r in want]
    drawn = ("fig4b_A2_", "fig4b_A3_")
    free_want = {k: v for k, v in _derived(want).items() if not k.startswith(drawn)}
    free_got = {k: v for k, v in _derived(got).items() if not k.startswith(drawn)}
    assert len(free_got) == 1 + 11 + 10 + 1
    assert free_got == free_want


def test_fig4c_mean_costs_equal_reference(week):
    """Fig. 4c with the reference's normals injected: (S, W) mean costs to
    rtol 1e-6, and the rows' reductions from them."""
    runs, stds, windows = port.FIG4C_RUNS, port.FIG4C_STDS, port.FIG4C_WINDOWS
    key = jax.random.key(7)
    ab = jnp.asarray(np.tile(week, (runs, 1)), jnp.int32)
    spec = ref.ProvisionSpec(
        costs=ref.COSTS,
        workload=ref.Workload(demand=ab, noise=ref.PredictionNoise(
            std_frac=jnp.asarray(stds, jnp.float32), key=key)),
        policy=ref.PolicySpec("A1", windows=jnp.asarray(windows, jnp.int32)),
        n_levels=int(week.max()) + 1,
    )
    want = np.asarray(ref.provision(spec).cost).mean(axis=-1)          # (S, W)
    z = np.array(jax.vmap(lambda k, ai: jax.random.normal(k, ai.shape))(
        jax.random.split(key, runs), ab.astype(jnp.float32)))
    normals = normals_from_numpy(z, device="cpu")
    got, us = port.fig4c_costs(week, device="cpu", normals=normals)
    assert tuple(got.shape) == (len(stds), len(windows), runs) and us > 0
    np.testing.assert_allclose(got.mean(dim=-1).numpy(), want, rtol=1e-6)
    rows = []
    port.fig4c_prediction_error(rows, device="cpu", normals=normals)
    static = ref.fluid_cost(week, "static", ref.COSTS).cost
    assert _derived(rows) == {
        f"fig4c_A1_w{window}_std{int(std * 100)}":
            f"reduction={1 - float(want[s, w]) / static:.4f}"
        for s, std in enumerate(stds) for w, window in enumerate(windows)}


def test_fig4d_rows_equal_reference():
    want, got = [], []
    ref.fig4d_pmr_sweep(want)
    port.fig4d_pmr_sweep(got)
    assert [r.split(",")[0] for r in got] == [f"fig4d_pmr{p}" for p in (2, 3, 4, 6, 8, 10)]
    assert _derived(got) == _derived(want)
