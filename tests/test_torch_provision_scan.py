"""K1's plain version == the reference Pallas kernel, bit for bit.

``repro_torch.kernels.provision_scan.provision_scan_grid`` on CPU tensors
runs its plain PyTorch version; the reference ``provision_scan_grid`` runs
its Pallas kernel in interpret mode off-TPU, as the JAX package's own
tests run it.  Inputs are made with numpy from a seed and fed to both.
The CUDA kernel itself is held to the plain version on the card by
``chip_smoke.py``.
"""
import importlib

import numpy as np
import pytest

# The port's tests need torch.  CI's jax-only tier-1 job installs no torch,
# so there these files skip instead of failing at import.
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro_torch.kernels import provision_scan as port  # noqa: E402
from repro_torch.obs import telemetry_session  # noqa: E402

# ``repro.kernels`` re-exports a function named ``provision_scan`` over the
# submodule's name, so import the module by its full name
ref = importlib.import_module("repro.kernels.provision_scan")

B, T, N, K, G = 3, 48, 37, 4, 6


def _inputs(seed, *, time_varying, n=N):
    rng = np.random.default_rng(seed)
    steps = rng.integers(-3, 4, (B, T))
    traces = np.clip(n // 2 + np.cumsum(steps, axis=1), 0, n + 1)
    predicted = np.clip(traces[rng.integers(0, B, B + 1)]
                        + rng.integers(-2, 3, (B + 1, T)), 0, None)
    shape = (K, T if time_varying else 1, n)
    thresholds = np.floor(rng.uniform(0, 12, shape)) / 2
    thresholds[rng.uniform(size=shape) < 0.2] = 0.0          # atoms at 0 (A3)
    # cell_hor stays 0: the default level_horizon has one row
    cells = [rng.integers(0, rows, G) for rows in (B, B + 1, K, 1)]
    return traces.astype(np.int32), predicted.astype(np.int32), \
        thresholds.astype(np.float32), [c.astype(np.int32) for c in cells]


def _typed_routes():
    # the reference's group-aligned layout for groups of 17 and 12 levels:
    # each group padded to a multiple of 8 lanes, pad lanes never on
    routes = np.full(N + 11, port.PAD_ROUTE, np.int32)
    routes[:17] = np.arange(17)
    routes[24:36] = np.arange(17, 29)
    return routes


CASES = {
    "constant": dict(time_varying=False, delta=6, horizon=3),
    "time_varying": dict(time_varying=True, delta=6, horizon=4),
    "fractional_reach": dict(time_varying=True, delta=3, horizon=3, frac=True),
    "no_peek": dict(time_varying=False, delta=6, horizon=0),
    "base_offset": dict(time_varying=True, delta=6, horizon=2, base_level=5),
    "typed_routes": dict(time_varying=True, delta=6, horizon=3, routes=True),
}


@pytest.mark.parametrize("record", [False, True], ids=["plain", "record"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_reference_kernel(case, record):
    c = dict(CASES[case])
    n = N + 11 if c.get("routes") else N
    traces, predicted, thresholds, cells = _inputs(
        list(CASES).index(case), time_varying=c["time_varying"], n=n)
    routes = _typed_routes() if c.get("routes") else None
    level_horizon = None
    if c.get("frac"):
        rng = np.random.default_rng(5)
        level_horizon = np.where(rng.uniform(size=(K, n)) < 0.5, 2.5, 3.0).astype(np.float32)
        cells[3] = rng.integers(0, K, G).astype(np.int32)
    kw = dict(delta=c["delta"], horizon=c["horizon"], base_level=c.get("base_level", 0),
              record=record)
    want = ref.provision_scan_grid(
        jnp.asarray(traces), jnp.asarray(predicted), jnp.asarray(thresholds),
        *map(jnp.asarray, cells),
        routes=None if routes is None else jnp.asarray(routes),
        level_horizon=None if level_horizon is None else jnp.asarray(level_horizon),
        **kw,
    )
    got = port.provision_scan_grid(
        torch.as_tensor(traces), torch.as_tensor(predicted), torch.as_tensor(thresholds),
        *map(torch.as_tensor, cells),
        routes=None if routes is None else torch.as_tensor(routes),
        level_horizon=None if level_horizon is None else torch.as_tensor(level_horizon),
        **kw,
    )
    if record:
        (want, want_counts), (got, got_counts) = want, got
        assert got_counts.dtype == torch.int32 and tuple(got_counts.shape) == (G, 4, n)
        np.testing.assert_array_equal(got_counts.numpy(), np.asarray(want_counts))
    assert got.dtype == torch.bool and tuple(got.shape) == (G, T, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the case must exercise the scan: levels turn both on and off
    assert got.any() and not got.all()
    if routes is not None:
        assert not got[:, :, routes == port.PAD_ROUTE].any()


def test_cpu_tensors_never_reach_the_kernel():
    traces, predicted, thresholds, cells = _inputs(1, time_varying=True)
    before = port.launches
    with telemetry_session() as tel:
        port.provision_scan_grid(
            torch.as_tensor(traces), torch.as_tensor(predicted),
            torch.as_tensor(thresholds), *map(torch.as_tensor, cells),
            delta=6, horizon=3, record=True,
        )
    assert port.launches == before
    assert tel.counter_value("kernels/provision_scan_launches") == 0.0


@pytest.mark.parametrize("table", ["constant", "sampled"])
def test_single_cell_wrapper_matches_reference(table):
    rng = np.random.default_rng(11)
    a = np.clip(8 + np.cumsum(rng.integers(-2, 3, T)), 0, None).astype(np.int32)
    pred = np.clip(a + rng.integers(-2, 3, T), 0, None).astype(np.int32)
    n = int(max(a.max(), pred.max())) + 1
    thr = (np.full(n, 2.0) if table == "constant"
           else np.floor(rng.uniform(0, 8, (T, n))) / 2).astype(np.float32)
    lh = np.where(np.arange(n) % 2 == 0, 2.5, 3.0).astype(np.float32)
    want = ref.provision_scan(jnp.asarray(a), jnp.asarray(thr), delta=3, horizon=3,
                              predicted=jnp.asarray(pred), level_horizon=jnp.asarray(lh))
    got = port.provision_scan(torch.as_tensor(a), torch.as_tensor(thr), delta=3, horizon=3,
                              predicted=torch.as_tensor(pred),
                              level_horizon=torch.as_tensor(lh))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bad, match", [
    (dict(thresholds=np.zeros((K, T - 1, N), np.float32)), "thresholds must be"),
    (dict(horizon=7), "horizon <= delta"),
    (dict(cell_thr=np.full(G, K, np.int32)), "cell_thr indexes rows"),
    (dict(cell_trace=np.full(G, -1, np.int32)), "cell_trace indexes rows"),
    (dict(level_horizon=np.zeros((1, N + 1), np.float32)), "level_horizon must be"),
    (dict(routes=np.arange(N - 1, dtype=np.int32)), "routes must be"),
])
def test_wrapper_rejects_bad_arguments(bad, match):
    traces, predicted, thresholds, cells = _inputs(2, time_varying=False)
    args = dict(traces=traces, predicted=predicted, thresholds=thresholds,
                cell_trace=cells[0], cell_pred=cells[1], cell_thr=cells[2],
                cell_hor=cells[3], delta=6, horizon=3) | bad
    args = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
            for k, v in args.items()}
    with pytest.raises(ValueError, match=match):
        port.provision_scan_grid(**args)


def test_wrapper_rejects_devices_without_a_route():
    traces, predicted, thresholds, cells = _inputs(3, time_varying=False)
    meta = [torch.empty(x.shape, dtype=torch.as_tensor(x).dtype, device="meta")
            for x in (traces, predicted, thresholds)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        port.provision_scan_grid(*meta, *[torch.empty(G, dtype=torch.int32, device="meta")
                                         for _ in range(4)],
                                 delta=6, horizon=3)
