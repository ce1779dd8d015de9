"""repro_torch.bench.kernel_bench == the reference's
``benchmarks/kernel_bench.py``, on the CPU.

The two provisioning grid rows (K1 against its plain version, K1's routed
layout against the contiguous one) must pass their equality checks on the
plain routes, with the reference's row names under the route mapping, and
fail them on a planted fault; so must the long-trace section's K2 == K1
check.  One roofline row is held to a value worked out by hand from the
H100 constants.  The held timer needs the card; on the CPU its rows say so.
The CLI, ``python -m repro_torch.bench``, runs in a subprocess.
"""
import os
import pathlib
import subprocess
import sys

import pytest

# The port's tests need torch.  CI's jax-only tier-1 job installs no torch,
# so there these files skip instead of failing at import.
torch = pytest.importorskip("torch")

from benchmarks import kernel_bench as ref_kb  # noqa: E402
from repro_torch.bench import kernel_bench as kb  # noqa: E402
from repro_torch.bench.provision_bench import route_name  # noqa: E402

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]


def _names(rows):
    return [r.split(",")[0] for r in rows]


@pytest.fixture(scope="module")
def kernel_rows():
    """(reference's, twin's) rows of the two provisioning grid benchmarks."""
    want, got = [], []
    for name in ("provision_grid_vs_lax_scan", "provision_grid_routed"):
        getattr(ref_kb, name)(want)
        getattr(kb, name)(got, device="cpu")
    return want, got


def test_kernel_provisioning_rows_hold_on_the_plain_routes(kernel_rows):
    want, got = kernel_rows
    assert _names(got) == [route_name(n, "cpu") for n in _names(want)]
    assert _names(got) == ["provision_grid_plain_s2w3b2n128",
                           "provision_grid_plain_scan_s2w3b2n128",
                           "provision_grid_contig_plain_w2b2n64",
                           "provision_grid_routed_plain_w2b2n80"]


@pytest.mark.parametrize("name", ["provision_grid_vs_lax_scan", "provision_grid_routed"])
def test_kernel_provisioning_checks_reject_a_planted_fault(monkeypatch, name):
    """One on-bit flipped in the kernel route's output (the routed layout's,
    in the routed benchmark) must stop the section."""
    real = kb._scans.provision_scan_grid

    def flipped(*args, **kw):
        out = real(*args, **kw)
        if name == "provision_grid_routed" and kw.get("routes") is None:
            return out
        out = out.clone()
        out[0, 0, 0] = ~out[0, 0, 0]
        return out

    monkeypatch.setattr(kb._scans, "provision_scan_grid", flipped)
    with pytest.raises(AssertionError):
        getattr(kb, name)([], device="cpu")


def test_flash_roofline_row_by_hand():
    """s = 4096, hd = 128, causal: 4 s^2 hd / 2 = 4.295e9 FLOP over 989e12
    FLOP/s is 4.34 us; q, k, v read and o written in bf16, 4 s hd 2 =
    4,194,304 bytes over 3.35e12 B/s is 1.25 us; K3's bf16 block at hd 128
    holds 1024 + 128*128*2 + 2*3*128*128*2 + 16*3 + 8 = 230,456 bytes."""
    rows = []
    kb.flash_roofline(rows)
    assert rows[0] == ("flash_roofline_s4096,0.0,ai=1024;compute_us=4.3;mem_us=1.3;"
                       "smem_bytes=230456;bound=compute")
    want = []
    ref_kb.flash_roofline(want)
    assert _names(rows) == _names(want)


def test_flash_256_and_held_rows_on_the_cpu():
    rows = []
    kb.interpret_correctness(rows, device="cpu")
    assert _names(rows) == [route_name("flash_interpret_256", "cpu")]
    assert rows[0].endswith("max_err=0.00e+00")     # the CPU call is the plain version
    held = []
    kb.kernel_held_times(held, device="cpu")
    assert held == [f"kernel_held_{k}_{v},0.0,skipped=no_cuda"
                    for k, v in kb.HELD_SHAPES.items()]


def test_stream_long_check_rejects_a_planted_fault(monkeypatch):
    """K2 against K1 summed over levels, at the CI size: a streaming scan one
    server off stops the section before anything is timed (the equal case
    runs on the card, ``chip_smoke.py`` phase 21; on the CPU its timing loops
    would take minutes)."""
    def off_by_one(traces, *args, **kw):
        return torch.ones(traces.shape, dtype=torch.int32), None, None

    monkeypatch.setattr(kb._scans, "provision_scan_stream", off_by_one)
    with pytest.raises(AssertionError, match="K2 != K1"):
        kb.provision_stream_long([], device="cpu")


def _cli(*args, timeout=120):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO_ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", "repro_torch.bench", *args],
                          capture_output=True, text=True, env=env, cwd=REPO_ROOT,
                          timeout=timeout)


def test_cli_smoke_on_the_cpu():
    """``python -m repro_torch.bench --smoke --device cpu`` over a function of
    each module (the whole smoke takes minutes on a CPU): exit 0, the
    header, each function's rows, the row count on stderr; an unknown name
    exits 2."""
    only = "fig4d_pmr_sweep,telemetry_overhead,flash_roofline,kernel_held_times"
    proc = _cli("--smoke", "--device", "cpu", "--only", only)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    names = [line.split(",")[0] for line in lines[1:]]
    assert names[:6] == [f"fig4d_pmr{p}" for p in (2, 3, 4, 6, 8, 10)]
    assert names[6:9] == ["telemetry_overhead", "flash_roofline_s4096", "flash_roofline_s32768"]
    assert [n.split("_")[2] for n in names[9:]] == ["K1", "K2", "K3", "K4"]
    assert f"# {len(names)} benchmark rows" in proc.stderr
    bad = _cli("--device", "cpu", "--only", "fig5")
    assert bad.returncode == 2 and "no benchmark named fig5" in bad.stderr


def test_cli_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("the refusal needs a machine without CUDA")
    proc = _cli("--smoke")
    assert proc.returncode == 2 and "--device cpu" in proc.stderr and not proc.stdout
