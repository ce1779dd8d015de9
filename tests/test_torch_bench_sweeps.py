"""repro_torch.bench.provision_bench == the reference's
``benchmarks/provision_bench.py``, on the CPU.

``provision_bench.run_smoke`` must print the reference's row names under the
route mapping (``ROUTE_WORDS``) and its non-time values: the deferral rows'
cost, p99 delay and misses, the brick row's job count, the gates' rows.  The
twin's timing loops run one call here (``mean_us`` replaced), which changes
no value, and both brick simulators are replaced by a no-op, since the job
count is the trace's.  The mesh row's check must reject a route one
server off.  No process group is made in this process: the mesh rows run
in a world of one in a child process.
"""
import pytest

# The port's tests need torch.  CI's jax-only tier-1 job installs no torch,
# so there these files skip instead of failing at import.
torch = pytest.importorskip("torch")

from benchmarks import provision_bench as ref_pb  # noqa: E402
from repro_torch.bench import provision_bench as pb  # noqa: E402


def _names(rows):
    return [r.split(",")[0] for r in rows]


def _derived(rows):
    """{name: derived} of CSV rows (the time column dropped)."""
    return {r.split(",")[0]: r.split(",", 2)[2] for r in rows}


def _one_call(fn, iters, device):
    fn()
    return 1.0


@pytest.fixture(scope="module")
def smoke_rows():
    """(reference's, twin's) rows of ``run_smoke`` on the CPU."""
    want, got = [], []
    ref_pb.run_smoke(want)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pb, "mean_us", _one_call)
        pb.run_smoke(got, device="cpu")
    return want, got


def test_smoke_rows_are_the_references_under_the_route_mapping(smoke_rows):
    want, got = smoke_rows
    assert len(got) == 15
    assert _names(got) == [pb.route_name(n, "cpu") for n in _names(want)]
    assert "torch_provision_levels64" in _names(got)
    assert {"mesh_grid_plain_s2_w2_b2_n32", "mesh_grid_plain_scan_s2_w2_b2_n32",
            "pallas_scan_plain_levels128"} <= set(_names(got))


def test_smoke_non_time_values_equal_reference(smoke_rows):
    want, got = (_derived(rows) for rows in smoke_rows)
    for slack in (0, 4):
        name = f"deferral_slack{slack}_n32"
        assert got[name] == want[name], name
    assert got["deferral_slack0_n32"] == "cost=10097.0;p99=0;miss=14"
    assert got["telemetry_overhead"] == want["telemetry_overhead"]
    # the gates: nothing built on the CPU, where there is no library
    assert got["jit_cache_repricing"] == "entries_added=0"
    assert got["mesh_grid_compiles"] == "cold=0;warm_added=0"


def test_brick_row_job_count_equals_reference(monkeypatch):
    monkeypatch.setattr(ref_pb, "simulate", lambda *a, **k: None)
    monkeypatch.setattr(pb, "simulate", lambda *a, **k: None)
    want, got = [], []
    ref_pb.brick_simulator_throughput(want)
    pb.brick_simulator_throughput(got)
    assert _names(got) == _names(want) == ["brick_sim_6078jobs"]


@pytest.mark.parametrize("device, want", [
    ("cuda", ["mesh_grid_cuda_s2_w4_b8_n256", "mesh_grid_plain_scan_s2_w4_b8_n256",
              "pallas_scan_cuda_levels512", "torch_provision_levels64", "flash_256",
              "provision_long_stream_cuda_long_t1000000n128",
              "provision_grid_contig_cuda_w2b2n64"]),
    ("cpu", ["mesh_grid_plain_s2_w4_b8_n256", "mesh_grid_plain_scan_s2_w4_b8_n256",
             "pallas_scan_plain_levels128", "torch_provision_levels64", "flash_256",
             "provision_long_stream_plain_long_t65536n128",
             "provision_grid_contig_plain_w2b2n64"]),
])
def test_route_name(device, want):
    ref_names = ["mesh_grid_pallas_tpu_s2_w4_b8_n256", "mesh_grid_lax_scan_s2_w4_b8_n256",
                 "pallas_scan_tpu_levels512" if device == "cuda"
                 else "pallas_scan_interpret_levels128",
                 "jax_provision_levels64", "flash_interpret_256",
                 "provision_long_stream_tpu_long_t1000000n128" if device == "cuda"
                 else "provision_long_stream_interpret_long_t65536n128",
                 "provision_grid_contig_interpret_w2b2n64"]
    assert [pb.route_name(n, device) for n in ref_names] == want


def test_mesh_row_rejects_a_route_that_differs(monkeypatch):
    """The mesh row's check is not vacuous: a mesh route one server off the
    plain scan stops the run."""
    def off_by_one(sizes, device, gate):
        n_levels, n_traces, n_windows, n_stds, n_slots = sizes
        ab = pb._mesh_grid_demand(n_levels, n_traces, n_slots, device)
        res = pb._provision(pb._mesh_grid_spec(ab, n_levels, n_windows, n_stds, device),
                            record_decisions=False, kernel=False)
        x = res.x.clone()
        x[0, 0, 0, 0] += 1
        return {"x": x, "cost": res.cost, "level_cost": res.level_cost, "us": 1.0}

    monkeypatch.setattr(pb, "_mesh_world", off_by_one)
    with pytest.raises(AssertionError, match="mesh route's x"):
        pb.mesh_grid_throughput([], n_levels=16, n_traces=1, n_windows=2, n_stds=2,
                                n_slots=48, device="cpu")
