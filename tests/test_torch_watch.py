"""The port's build accounting: CompileWatcher, tracer_sanitizer and the
build counter of ``repro_torch.kernels._build``, on the CPU.

There is no ``nvcc`` here, so ``torch.utils.cpp_extension.load`` and
``ctypes.CDLL`` are replaced by fakes: the build step then runs as it does
on the card, without compiling, and the watcher must see each forced build
once and a loader that finds its library loaded not at all.  Mirrors
``tests/test_obs.py`` and ``tests/test_sanitize.py`` for the reference's
jit-cache watcher.
"""
import types

import pytest

# The port's tests need torch.  CI's jax-only tier-1 job installs no torch,
# so there these files skip instead of failing at import.
torch = pytest.importorskip("torch")

import repro_torch.obs as obs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.lint import (  # noqa: E402
    RecompileError,
    UnobservableCacheError,
    tracer_sanitizer,
)
from repro_torch.obs import CompileWatcher, telemetry_session, torchwatch  # noqa: E402


class FakeLib:
    """Stands in for a loaded library: every symbol takes argtypes/restype."""

    def __getattr__(self, name):
        fn = types.SimpleNamespace()
        setattr(self, name, fn)
        return fn


@pytest.fixture
def fake_build(monkeypatch, tmp_path):
    """Builds that compile nothing: ``load`` returns a path, ``CDLL`` a fake;
    the counter, the loaders' caches and the listeners are restored after."""
    from torch.utils import cpp_extension

    calls = []

    def load(**kw):
        calls.append(kw["name"])
        return str(tmp_path / f"{kw['name']}.so")

    monkeypatch.setattr(cpp_extension, "load", load)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: FakeLib())
    monkeypatch.setattr(_build, "builds", {_build.PROVISION_SCAN: 0, _build.ATTENTION: 0})
    monkeypatch.setattr(_build, "build_listeners", [])
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_attention_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return calls


def test_a_forced_build_counts_once_and_a_loaded_library_not_at_all(fake_build):
    with CompileWatcher() as cold:
        _build.load_provision_scan()
    with CompileWatcher() as warm:
        _build.load_provision_scan()
    assert (cold.added, warm.added) == (1, 0)
    assert fake_build == [_build.PROVISION_SCAN]
    assert obs.engine_cache_size() == 1


def test_watcher_counts_the_libraries_it_is_given(fake_build):
    with CompileWatcher(fns=(_build.load_attention,)) as att, \
            CompileWatcher(fns=(_build.PROVISION_SCAN,)) as scan, \
            CompileWatcher() as both:
        _build.load_provision_scan()
        _build.load_attention()
    assert (att.added, scan.added, both.added) == (1, 1, 2)
    assert att.libraries == (_build.ATTENTION,) and both.available
    with pytest.raises(ValueError, match="not a kernel library"):
        CompileWatcher(fns=("libfoo",))


def test_the_build_step_records_into_telemetry(fake_build):
    with telemetry_session() as tel:
        with CompileWatcher():
            _build.load_attention()
    assert tel.counter_value("kernels/builds", library=_build.ATTENTION) == 1
    (ms,) = tel.samples("kernels/build_ms", library=_build.ATTENTION)
    assert ms >= 0
    assert tel.counter_value("torch/compiles") == 1


def test_install_monitoring_forwards_builds_to_its_registry(fake_build, monkeypatch):
    monkeypatch.setattr(torchwatch, "_MONITORING_INSTALLED", False)
    assert obs.install_monitoring() is True and _build.build_listeners == []
    mine = obs.Telemetry()
    assert obs.install_monitoring(mine) is True
    assert obs.install_monitoring(obs.Telemetry()) is True     # once per process
    assert len(_build.build_listeners) == 1
    _build.load_provision_scan()
    assert mine.counter_value("kernels/builds", library=_build.PROVISION_SCAN) == 1
    assert len(mine.samples("kernels/build_ms", library=_build.PROVISION_SCAN)) == 1
    with telemetry_session(mine):                  # the active registry: recorded once
        _build.load_attention()
    assert mine.counter_value("kernels/builds", library=_build.ATTENTION) == 1


def test_sanitizer_raises_past_max_compiles(fake_build):
    with pytest.raises(RecompileError, match="at most 0"):
        with tracer_sanitizer():
            _build.load_provision_scan()
    with tracer_sanitizer() as w:                   # loaded: nothing built
        _build.load_provision_scan()
    assert w.added == 0
    with tracer_sanitizer(max_compiles=1) as w:
        _build.load_attention()
    assert w.added == 1


def test_sanitizer_exact_compiles_pins_the_count(fake_build):
    with tracer_sanitizer(fns=(_build.load_provision_scan,), exact_compiles=1) as w:
        _build.load_provision_scan()
        _build.load_attention()                     # another library: not watched
    assert w.added == 1
    with pytest.raises(RecompileError, match="exactly 1"):
        with tracer_sanitizer(exact_compiles=1):
            _build.load_provision_scan()
    with tracer_sanitizer(max_compiles=None) as w:  # the gate off
        _build._lib = None
        _build.load_provision_scan()
    assert w.added == 1 and _build.builds[_build.PROVISION_SCAN] == 2


def test_cpu_paths_build_nothing():
    """The CPU routes run the kernels' plain versions: no build, so a gate
    over them holds at 0 — the steady state the card must also reach."""
    import numpy as np

    from repro_torch import PAPER_COSTS
    from repro_torch.serving import FleetProvisioner

    prov = FleetProvisioner(PAPER_COSTS, max_replicas=8, device="cpu")
    a = np.random.default_rng(0).integers(0, 8, size=(40,))
    with tracer_sanitizer(exact_compiles=0) as w:
        prov.advance(a[:20])
        prov.advance(a[20:])
        prov.plan(a)
    assert w.added == 0
    assert issubclass(UnobservableCacheError, RuntimeError)
    assert issubclass(RecompileError, AssertionError)


def test_profile_to_writes_a_chrome_trace(tmp_path):
    with obs.profile_to(None):
        pass
    out = tmp_path / "prof"
    with obs.profile_to(out):
        torch.ones(64).cumsum(0)
    trace = (out / "trace.json").read_text()
    assert "traceEvents" in trace and "cumsum" in trace
