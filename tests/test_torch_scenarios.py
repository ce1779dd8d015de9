"""repro_torch.scenarios == repro.scenarios, on the CPU.

The port's scenario library is a copy of the reference's (numpy only), with
its own registry, its own ``replay`` sample and a ``make_workload`` that
builds the port's ``Workload``.  Each generator family, the two
combinators and the bridge must give the reference's arrays exactly;
``make_workload``'s noise, driven by the reference's normals, must give the
reference's schedules.
"""
import pathlib
import warnings

import numpy as np
import pytest

# The port's tests need torch.  CI's jax-only tier-1 job installs no torch,
# so there these files skip instead of failing at import.
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as ref  # noqa: E402
import repro.scenarios as rsc  # noqa: E402
import repro_torch as port  # noqa: E402
import repro_torch.scenarios as psc  # noqa: E402
from repro.deferral import DeferralSpec as RefDeferral  # noqa: E402
from repro_torch.deferral import DeferralSpec  # noqa: E402

N_SLOTS = 288
BUILTIN = ("flash_crowd", "heavy_tail_bursts", "msr_diurnal", "replay",
           "sinusoidal", "step_outage")


@pytest.mark.parametrize("sc", rsc.DEFAULT_SCENARIOS, ids=lambda s: s.name)
def test_default_scenarios_generate_the_reference_arrays(sc):
    want = rsc.generate(sc, 5, N_SLOTS)
    port_sc = psc.Scenario(sc.name, params=dict(sc.params), seed=sc.seed,
                           target_pmr=sc.target_pmr, mean_jobs=sc.mean_jobs)
    got = psc.generate(port_sc, 5, N_SLOTS)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert port_sc.describe() == sc.describe()


@pytest.mark.parametrize("name", BUILTIN)
@pytest.mark.parametrize("seed", [0, 3])
def test_every_family_matches_at_other_seeds_and_scales(name, seed):
    kw = dict(seed=seed, target_pmr=None if name == "replay" else 3.0, mean_jobs=12.0)
    np.testing.assert_array_equal(psc.generate(psc.Scenario(name, **kw), 3, 200),
                                  rsc.generate(rsc.Scenario(name, **kw), 3, 200))


def _combinators(pkg):
    mix = pkg.mix(
        pkg.Scenario("msr_diurnal", target_pmr=3.0),
        pkg.Scenario("heavy_tail_bursts", target_pmr=8.0, mean_jobs=8.0),
        weights=(0.7, 0.3), seed=5, target_pmr=4.0,
    )
    concat = pkg.concat(
        pkg.Scenario("sinusoidal", target_pmr=3.0),
        pkg.Scenario("flash_crowd", target_pmr=6.0),
        fractions=(0.75, 0.25), seed=5, target_pmr=4.0,
    )
    return {"mix": mix, "concat": concat}


@pytest.mark.parametrize("which", ["mix", "concat"])
def test_combinators_generate_the_reference_arrays(which):
    want = rsc.generate(_combinators(rsc)[which], 4, N_SLOTS)
    got = psc.generate(_combinators(psc)[which], 4, N_SLOTS)
    np.testing.assert_array_equal(got, want)


def test_registry_and_sample_match_the_reference():
    assert psc.scenario_names() == rsc.scenario_names()
    assert psc.SAMPLE_TRACE_PATH.read_bytes() == rsc.SAMPLE_TRACE_PATH.read_bytes()
    assert psc.SAMPLE_TRACE_PATH.is_relative_to(pathlib.Path(psc.__file__).parent)
    with pytest.raises(ValueError, match="already registered"):
        psc.register_scenario("sinusoidal")(lambda rng, n: np.ones(n))
    with pytest.raises(ValueError, match="msr_diurnal"):
        psc.generate(psc.Scenario("msr_durnal"), 1, N_SLOTS)


def test_unreachable_pmr_warns_as_the_reference_does():
    kw = dict(seed=1, target_pmr=16.0, mean_jobs=32.0)
    with pytest.warns(RuntimeWarning, match="realized PMR"):
        got = psc.generate(psc.Scenario("step_outage", **kw), 2, N_SLOTS)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = rsc.generate(rsc.Scenario("step_outage", **kw), 2, N_SLOTS)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("clip_to", [None, 40])
def test_make_workload_matches_the_reference(clip_to):
    kw = dict(seed=4, target_pmr=6.0, mean_jobs=16.0)
    want = rsc.make_workload(rsc.Scenario("flash_crowd", **kw), 3, N_SLOTS, clip_to=clip_to)
    got = psc.make_workload(psc.Scenario("flash_crowd", **kw), 3, N_SLOTS, clip_to=clip_to)
    assert isinstance(got, port.Workload) and got.demand.dtype == torch.int32
    np.testing.assert_array_equal(got.demand.numpy(), np.asarray(want.demand))
    assert got.noise is None and got.deferral is None
    with pytest.raises(ValueError, match="clip_to"):
        psc.make_workload(psc.Scenario("flash_crowd", **kw), 1, N_SLOTS, clip_to=0)


@pytest.mark.parametrize("spec_cap", [None, 60])
def test_make_workload_with_deferral_matches_the_reference(spec_cap):
    """clip_to with a DeferralSpec becomes the service cap (the smaller of
    the two); the demand is not truncated; provision() then gives the
    reference's schedule and queue metrics."""
    kw = dict(seed=4, target_pmr=3.0, mean_jobs=32.0)
    want = rsc.make_workload(rsc.Scenario("msr_diurnal", **kw), 2, N_SLOTS, clip_to=80,
                             deferral=RefDeferral(slack=8, cap=spec_cap))
    got = psc.make_workload(psc.Scenario("msr_diurnal", **kw), 2, N_SLOTS, clip_to=80,
                            deferral=DeferralSpec(slack=8, cap=spec_cap))
    np.testing.assert_array_equal(got.demand.numpy(), np.asarray(want.demand))
    assert got.deferral.cap == want.deferral.cap == (80 if spec_cap is None else 60)
    n = int(np.asarray(want.demand).max()) + 1
    rres = ref.provision(ref.ProvisionSpec(costs=ref.PAPER_COSTS, workload=want,
                                           policy=ref.PolicySpec("A1"), n_levels=n))
    pres = port.provision(port.ProvisionSpec(costs=port.PAPER_COSTS, workload=got,
                                             policy=port.PolicySpec("A1"), n_levels=n,
                                             device="cpu"))
    for f in ("x", "cost", "backlog", "deadline_misses", "unserved", "p99_delay",
              "max_delay"):
        np.testing.assert_array_equal(getattr(pres, f).numpy(),
                                      np.asarray(getattr(rres, f)), err_msg=f)


def test_make_workload_noise_sweep_with_the_reference_normals():
    sc_kw = dict(seed=4)
    stds = [0.0, 0.3]
    want = rsc.make_workload(rsc.Scenario("sinusoidal", **sc_kw), 3, N_SLOTS,
                             noise_std=jnp.asarray(stds), noise_key=jax.random.key(9))
    # the reference's normals, as its PredictionNoise.apply draws them
    keys = jax.random.split(jax.random.key(9), 3)
    z = np.array(jax.vmap(lambda k: jax.random.normal(k, (N_SLOTS,)))(keys))
    got = psc.make_workload(psc.Scenario("sinusoidal", **sc_kw), 3, N_SLOTS,
                            noise_std=stds, noise_normals=z)
    np.testing.assert_array_equal(
        got.resolve_predicted(got.demand).numpy(),
        np.asarray(want.resolve_predicted(want.demand)))
    # without normals or a generator the port draws from scenario.seed
    own = psc.make_workload(psc.Scenario("sinusoidal", **sc_kw), 3, N_SLOTS, noise_std=stds)
    again = psc.make_workload(psc.Scenario("sinusoidal", **sc_kw), 3, N_SLOTS, noise_std=stds)
    pred = own.resolve_predicted(own.demand)
    assert tuple(pred.shape) == (2, 3, N_SLOTS)
    assert torch.equal(pred, again.resolve_predicted(again.demand))
    assert torch.equal(pred[0], own.demand) and not torch.equal(pred[1], own.demand)
