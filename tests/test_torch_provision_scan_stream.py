"""K2's plain version == the reference streaming Pallas kernel, bit for bit.

``repro_torch.kernels.provision_scan.provision_scan_stream`` on CPU tensors
runs its plain PyTorch version; the reference ``provision_scan_stream``
runs its Pallas kernel in interpret mode off-TPU, as the JAX package's own
tests run it.  Inputs are made with numpy from a seed and fed to both, and
``x``, every per-lane total and the carry (r, wait, on) must be equal.  The
CUDA kernel itself is held to the plain version on the card by
``chip_smoke.py``.
"""
import importlib

import numpy as np
import pytest

# The port's tests need torch.  CI's jax-only tier-1 job installs no torch,
# so there these files skip instead of failing at import.
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro_torch.convert import carry_from_numpy  # noqa: E402
from repro_torch.kernels import provision_scan as port  # noqa: E402
from repro_torch.obs import telemetry_session  # noqa: E402

# ``repro.kernels`` re-exports a function named ``provision_scan`` over the
# submodule's name, so import the module by its full name
ref = importlib.import_module("repro.kernels.provision_scan")

B, T, N, K, G = 3, 48, 37, 4, 6
T_CHUNK = 13                    # does not divide T: the pad tail runs


def _inputs(seed, *, time_varying, n=N, atoms=0.2):
    rng = np.random.default_rng(seed)
    steps = rng.integers(-3, 4, (B, T))
    traces = np.clip(n // 2 + np.cumsum(steps, axis=1), 0, n + 1)
    predicted = np.clip(traces[rng.integers(0, B, B + 1)]
                        + rng.integers(-2, 3, (B + 1, T)), 0, None)
    shape = (K, T if time_varying else 1, n)
    thresholds = np.floor(rng.uniform(0, 12, shape)) / 2
    thresholds[rng.uniform(size=shape) < atoms] = 0.0        # atoms at 0 (A3)
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
    "constant": dict(time_varying=False, horizon=3),
    "time_varying": dict(time_varying=True, horizon=4),
    "atoms_at_0": dict(time_varying=True, horizon=2, atoms=0.6),
    "no_peek": dict(time_varying=False, horizon=0),
    "fractional_reach": dict(time_varying=True, horizon=3, frac=True),
    "typed_routes": dict(time_varying=True, horizon=3, routes=True),
    "n_levels_below_N": dict(time_varying=True, horizon=3, n_levels=N - 9),
    "record": dict(time_varying=True, horizon=3, record=True),
}


def _case(name, seed=None):
    """The case's inputs as numpy arrays and keyword arguments."""
    c = CASES[name]
    n = N + 11 if c.get("routes") else N
    traces, predicted, thresholds, cells = _inputs(
        list(CASES).index(name) if seed is None else seed,
        time_varying=c["time_varying"], n=n, atoms=c.get("atoms", 0.2))
    kw = dict(horizon=c["horizon"], record=c.get("record", False),
              n_levels=c.get("n_levels"))
    if c.get("routes"):
        kw["routes"] = _typed_routes()
    if c.get("frac"):
        rng = np.random.default_rng(5)
        kw["level_horizon"] = np.where(rng.uniform(size=(K, n)) < 0.5, 2.5,
                                       3.0).astype(np.float32)
        cells[3] = rng.integers(0, K, G).astype(np.int32)
    return [traces, predicted, thresholds, *cells], kw


def _run_ref(args, kw, t_chunk, carry=None):
    kw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    return ref.provision_scan_stream(*map(jnp.asarray, args), t_chunk=t_chunk,
                                     carry=carry, **kw)


def _run_port(args, kw, t_chunk, carry=None):
    kw = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    return port.provision_scan_stream(*map(torch.as_tensor, args), t_chunk=t_chunk,
                                      carry=carry, **kw)


def _assert_equal(got, want, n):
    (gx, gacc, gcarry), (wx, wacc, wcarry) = got, want
    assert gx.dtype == torch.int32 and tuple(gx.shape) == np.asarray(wx).shape
    np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
    assert sorted(gacc) == sorted(wacc)
    for k, v in wacc.items():
        assert gacc[k].dtype == torch.int32 and tuple(gacc[k].shape) == (G, n)
        np.testing.assert_array_equal(gacc[k].numpy(), np.asarray(v), err_msg=k)
    assert sorted(gcarry) == ["on", "r", "wait"]
    for k, v in wcarry.items():
        np.testing.assert_array_equal(gcarry[k].numpy(), np.asarray(v), err_msg=k)
    assert gcarry["on"].dtype == torch.bool


def _check(name, t_chunk):
    args, kw = _case(name)
    got = _run_port(args, kw, t_chunk)
    _assert_equal(got, _run_ref(args, kw, t_chunk), args[2].shape[-1])
    x, accs, _ = got
    # the case must exercise the scan: levels turn both on and off
    assert accs["up"].sum() > 0 and accs["down"].sum() > 0 and x.max() > 0
    if "routes" in kw:
        assert not accs["run"][:, kw["routes"] == port.PAD_ROUTE].any()
    if kw["n_levels"] is not None:
        assert not accs["run"][:, kw["n_levels"]:].any()
    if kw["record"]:
        assert all(accs[k].sum() > 0 for k in ("demand_rise", "wait_expired",
                                               "peek_fired", "toggle_off"))


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_reference_kernel(case):
    _check(case, T_CHUNK)


@pytest.mark.parametrize("t_chunk", [1, T_CHUNK, T, 2 * T])
def test_tile_size_never_changes_a_result(t_chunk):
    _check("record", t_chunk)


@pytest.mark.parametrize("case", ["constant", "record"])
def test_chained_calls_match_the_reference_chained(case):
    """A trace cut mid-tile and mid-wait, carried across two calls: the
    port's chained result equals the reference's chained result.  (Not the
    one-call result: at the seam the first call's peek reads 0.)"""
    args, kw = _case(case)
    cut = 29                                  # inside the third 13-slot tile

    def part(sl):             # demand, predicted and a time-varying table
        return [a[:, sl] if a.ndim > 1 and a.shape[1] == T else a for a in args]

    first, second = part(slice(None, cut)), part(slice(cut, None))
    want1 = _run_ref(first, kw, T_CHUNK)
    got1 = _run_port(first, kw, T_CHUNK)
    _assert_equal(got1, want1, N)
    carry = {k: np.asarray(v) for k, v in want1[2].items()}
    assert (carry["on"] & (carry["r"] > 0)).any()            # some lane mid-wait
    want2 = _run_ref(second, kw, T_CHUNK, carry=want1[2])
    got2 = _run_port(second, kw, T_CHUNK,
                     carry=carry_from_numpy(carry["r"], carry["on"], carry["wait"], device="cpu"))
    _assert_equal(got2, want2, N)
    # threading the port's own carry gives the same
    _assert_equal(_run_port(second, kw, T_CHUNK, carry=got1[2]), want2, N)


def test_carry_from_numpy_types():
    c = carry_from_numpy(np.ones((2, 3)), np.array([[1, 0, 1]] * 2), np.zeros((2, 3)),
                         device="cpu")
    assert [c[k].dtype for k in ("r", "on", "wait")] == [torch.float32, torch.bool,
                                                        torch.float32]


def test_cpu_tensors_never_reach_the_kernel():
    args, kw = _case("record")
    before = port.stream_launches
    with telemetry_session() as tel:
        _run_port(args, kw, T_CHUNK)
    assert port.stream_launches == before
    assert tel.counter_value("kernels/provision_scan_stream_launches") == 0.0


@pytest.mark.parametrize("bad, match", [
    (dict(carry={"r": np.zeros((G, N - 1)), "on": np.zeros((G, N)),
                 "wait": np.zeros((G, N))}), r"carry\['r'\] must be"),
    (dict(t_chunk=0), "t_chunk must be"),
    (dict(horizon=-1), "horizon"),
    (dict(cell_thr=np.full(G, K, np.int32)), "cell_thr indexes rows"),
    (dict(thresholds=np.zeros((K, T - 1, N), np.float32)), "thresholds must be"),
])
def test_wrapper_rejects_bad_arguments(bad, match):
    args, _ = _case("time_varying")
    names = ("traces", "predicted", "thresholds", "cell_trace", "cell_pred", "cell_thr",
             "cell_hor")
    kw = dict(zip(names, args)) | dict(horizon=3) | bad
    kw = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    with pytest.raises(ValueError, match=match):
        port.provision_scan_stream(**kw)


def test_wrapper_rejects_devices_without_a_route():
    meta = [torch.empty(s, dtype=d, device="meta")
            for s, d in (((B, T), torch.int32), ((B, T), torch.int32),
                         ((K, 1, N), torch.float32))]
    cells = [torch.empty(G, dtype=torch.int32, device="meta") for _ in range(4)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        port.provision_scan_stream(*meta, *cells, horizon=3)
