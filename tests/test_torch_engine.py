"""repro_torch.core.torch_provision == repro.core.jax_provision, piece by piece.

The same numpy-made inputs, and the reference's own uniform draws (taken
from ``_uniforms`` with the keys split as ``provision()`` splits them),
go through both engines.  On-matrices, schedules, decision codes and
per-level cost terms must be bit-exact.  The one tolerance is on the wait
transform itself: ``log1p`` in torch on the CPU and in XLA may differ by a
few ulp (float32), so waits are held to ``rtol=1e-6``; the schedules they
drive are still compared exactly.
"""
import numpy as np
import pytest

# The port's tests need torch.  CI's jax-only tier-1 job installs no torch,
# so there these files skip instead of failing at import.
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import CostModel as RefCostModel  # noqa: E402
from repro.core import jax_provision as ref  # noqa: E402
from repro.core import on_matrix_cost as ref_on_matrix_cost  # noqa: E402
from repro_torch.convert import cost_model_from_numpy, uniforms_from_numpy  # noqa: E402
from repro_torch.core import on_matrix_cost  # noqa: E402
from repro_torch.core import torch_provision as port  # noqa: E402

B, T, N = 3, 40, 14


def _demand(seed, shape=(B, T), top=N - 1):
    """Noisy diurnal-like waves: levels go busy, idle past Δ, and busy again."""
    rng = np.random.default_rng(seed)
    t = np.arange(shape[-1])
    phase = rng.uniform(0, 2 * np.pi, shape[:-1] + (1,))
    wave = top / 2 * (1 + 0.8 * np.sin(2 * np.pi * t / 17 + phase))
    return np.clip(np.rint(wave) + rng.integers(-2, 3, shape), 0, top).astype(np.int32)


def _ref_uniforms(seed, b=B, t=T, n=N):
    keys = jax.random.split(jax.random.key(seed), b)
    u0, u = jax.vmap(lambda k: ref._uniforms(k, t, n))(keys)
    return np.array(u0), np.array(u)


DELTAS = {
    "scalar_6": np.float32(6.0),
    "fractional": np.where(np.arange(N) % 2 == 0, 2.5, 3.0).astype(np.float32),
}


@pytest.mark.parametrize("delta", list(DELTAS))
@pytest.mark.parametrize("window", [0, 2, 4])
@pytest.mark.parametrize("policy", ["A2", "A3", "AQ-rand"])
def test_waits_from_uniforms(policy, window, delta):
    u0, u = _ref_uniforms(1)
    d = np.broadcast_to(DELTAS[delta], (N,)).copy()
    want = np.asarray(ref._waits_from_uniforms(policy, u0, u, window, jnp.asarray(d)))
    got = port._waits_from_uniforms(policy, torch.as_tensor(u0), torch.as_tensor(u),
                                    window, torch.as_tensor(d)).numpy()
    np.testing.assert_array_equal(got == 0.0, want == 0.0)     # A3's atom, exactly
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)  # log1p: a few ulp


@pytest.mark.parametrize("delta", list(DELTAS))
def test_offline_levels(delta):
    a = _demand(2)
    d = np.broadcast_to(DELTAS[delta], (N,)).copy()
    want = np.stack([np.asarray(ref._offline_levels(jnp.asarray(ai), N, jnp.asarray(d)))
                     for ai in a])
    got = port._offline_levels(torch.as_tensor(a), N, torch.as_tensor(d)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()


def test_cost_terms_and_on_matrix_cost():
    rng = np.random.default_rng(3)
    a = _demand(3)
    ons = rng.uniform(size=(2, B, T, N)) < 0.5
    fields = [rng.uniform(0.5, 3.0, N).astype(np.float32) for _ in range(3)]
    want = ref._cost_terms(jnp.asarray(a), jnp.asarray(ons), *map(jnp.asarray, fields))
    got = port._cost_terms(torch.as_tensor(a), torch.as_tensor(ons),
                           *map(torch.as_tensor, fields))
    for k in ("energy", "on_cost", "off_cost"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    costs = RefCostModel(*fields)
    np.testing.assert_allclose(
        on_matrix_cost(a, ons, cost_model_from_numpy(*fields)).numpy(),
        np.asarray(ref_on_matrix_cost(jnp.asarray(a), jnp.asarray(ons), costs)),
        rtol=1e-6,
    )


@pytest.mark.parametrize("delta", list(DELTAS))
@pytest.mark.parametrize("policy", ["A1", "A2", "A3", "delayedoff", "AQ-det", "AQ-rand"])
def test_on_matrix_scan_with_codes(policy, delta):
    """The plain slot loop, one cell, record codes on: bit-exact against the
    reference's lax.scan with the same wait table."""
    a = _demand(4, (T,))
    rng = np.random.default_rng(5)
    pred = np.clip(a + rng.integers(-2, 3, T), 0, None).astype(np.int32)
    d = np.broadcast_to(DELTAS[delta], (N,)).copy()
    max_h, window = int(np.ceil(d.max())), 2
    u0, u = _ref_uniforms(6, b=1)
    waits = (None if policy not in ref.KEYED else
             np.asarray(ref._waits_from_uniforms(policy, u0[0], u[0], window, jnp.asarray(d))))
    want_on, want_codes = ref._on_matrix_scan(
        jnp.asarray(a), jnp.asarray(pred), jnp.arange(N), delta=jnp.asarray(d), max_h=max_h,
        window=window, policy=policy,
        waits=None if waits is None else jnp.asarray(waits), record=True,
    )
    dt = torch.as_tensor(d)
    if waits is not None:
        thr = torch.as_tensor(waits)[None]
    elif policy in port.NO_PEEK:
        thr = dt[None, None]
    else:
        thr = torch.clamp(dt - float(window) - 1.0, min=0.0)[None, None]
    no_peek = policy in port.NO_PEEK
    reach = torch.zeros(N) if no_peek else torch.minimum(torch.tensor(window + 1.0), dt)
    zero = torch.zeros(1, dtype=torch.int32)
    got_on, got_codes = port._on_matrix_scan(
        torch.as_tensor(a)[None], torch.as_tensor(pred)[None], thr, zero, zero, zero, zero,
        level_horizon=reach[None], routes=torch.arange(N, dtype=torch.int32),
        horizon=0 if no_peek else min(window + 1, max_h), record=True,
    )
    np.testing.assert_array_equal(got_on[0].numpy(), np.asarray(want_on))
    np.testing.assert_array_equal(got_codes[0].numpy(), np.asarray(want_codes))
    assert got_codes.dtype == torch.uint8 and (got_codes & 8).any()   # toggles happen


def _engine_inputs(policy, noise_sweep):
    a = _demand(7)
    rng = np.random.default_rng(8)
    S = 2 if noise_sweep else 1
    pred = np.clip(a[None] + rng.integers(-2, 3, (S, B, T)), 0, None).astype(np.int32)
    fields = (np.float32(1.0), np.where(np.arange(N) < 6, 1.25, 1.5).astype(np.float32),
              np.float32(1.25))
    costs = RefCostModel(*fields)
    delta = np.broadcast_to(np.asarray(costs.delta, np.float32), (N,)).copy()
    per_level = [np.asarray(f) for f in costs.per_level(N)]
    u = _ref_uniforms(9) if policy in ref.KEYED else None
    return a, pred, delta, per_level, costs.delta_slots(), u


# offline has no slot scan to record: both engines reject it with record
RUN_CASES = [(p, r) for p in ref.POLICIES for r in (False, True)
             if not (r and p == "offline")]


@pytest.mark.parametrize("noise_sweep", [False, True], ids=["S1", "S2"])
@pytest.mark.parametrize("policy, record", RUN_CASES,
                         ids=[f"{p}-{'record' if r else 'plain'}" for p, r in RUN_CASES])
def test_run_matches_reference_engine(policy, record, noise_sweep):
    a, pred, delta, per_level, max_h, u = _engine_inputs(policy, noise_sweep)
    windows = [0, 2, 4]
    keys = jax.random.split(jax.random.key(9), B) if u is not None else None
    kw = dict(n_levels=N, max_h=max_h, policy=policy, record=record)
    args = (jnp.asarray(a), jnp.asarray(pred if noise_sweep else pred[0]),
            jnp.asarray(windows), jnp.asarray(delta), *map(jnp.asarray, per_level), keys)
    want = (ref._run_noise_sweep if noise_sweep else ref._run)(*args, **kw)
    got = port._run(torch.as_tensor(a), torch.as_tensor(pred), windows,
                    torch.as_tensor(delta), *map(torch.as_tensor, per_level),
                    None if u is None else uniforms_from_numpy(*u, device="cpu"), **kw)
    expect = sorted(want)
    assert sorted(got) == expect
    for k in expect:
        w = np.asarray(want[k])
        g = got[k].numpy()
        if not noise_sweep:
            g = g[0]
        assert g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_window_free_policies_broadcast_over_windows():
    a, pred, delta, per_level, max_h, u = _engine_inputs("AQ-rand", False)
    out = port._run(torch.as_tensor(a), torch.as_tensor(pred), [0, 1, 5],
                    torch.as_tensor(delta), *map(torch.as_tensor, per_level),
                    uniforms_from_numpy(*u, device="cpu"), n_levels=N, max_h=max_h,
                    policy="AQ-rand")
    assert out["x"].shape == (1, 3, B, T)
    assert torch.equal(out["x"][:, 0], out["x"][:, 2])


def test_uniforms_come_from_the_generator():
    draw = [port._uniforms(torch.Generator().manual_seed(s), 2, 5, 3, torch.device("cpu"))
            for s in (4, 4, 5)]
    assert draw[0][0].shape == (2, 5, 3) and draw[0][0].dtype == torch.float32
    assert torch.equal(draw[0][0], draw[1][0]) and torch.equal(draw[0][1], draw[1][1])
    assert not torch.equal(draw[0][0], draw[2][0])
    assert not torch.equal(draw[0][0], draw[0][1])
