"""The twin of ``tests/test_segments.py`` on the port: critical segment
construction and Proposition 1 (paper Section III-A) through
``repro_torch.core``."""
import numpy as np
import pytest

# The port's tests need torch.  CI's jax-only tier-1 job installs no torch,
# so there these files skip instead of failing at import.
torch = pytest.importorskip("torch")

from repro_torch.core import (  # noqa: E402
    SegmentType,
    critical_segments,
    critical_times,
    generate_brick_trace,
    trace_from_intervals,
)


def fig1_like_trace():
    """A trace exercising all four segment types.

    a(t): rises (arrivals), then a departure with no return (step-decreasing),
    then a canyon, then a U-shape.
    """
    # horizon 100
    jobs = [
        (0.5, 30.0),    # long-lived base job
        (1.0, 10.0),    # departs at 10 -> canyon structure below
        (2.0, 6.0),     # quick job: U-shape inside
        (7.0, 9.0),     # returns to level then leaves again
        (12.0, 28.0),   # arrival after canyon
        (40.0, 60.0),   # later activity
        (41.0, 45.0),
        (47.0, 59.0),
    ]
    return trace_from_intervals(jobs, 100.0)


def test_critical_times_cover_horizon():
    tr = fig1_like_trace()
    ct = critical_times(tr)
    assert ct[0] == 0.0
    assert ct[-1] <= tr.horizon
    assert all(b > a for a, b in zip(ct[:-1], ct[1:]))


def test_all_segments_classified():
    tr = fig1_like_trace()
    segs = critical_segments(tr)
    assert segs, "must produce at least one segment"
    for s in segs:
        assert s.seg_type in SegmentType
    # segments tile [0, last critical time]
    for s0, s1 in zip(segs[:-1], segs[1:]):
        assert s0.end == s1.start


def test_type_I_first_segment_when_starting_with_arrivals():
    tr = trace_from_intervals([(1.0, 5.0), (2.0, 6.0), (3.0, 7.0)], 10.0)
    segs = critical_segments(tr)
    assert segs[0].seg_type == SegmentType.TYPE_I
    # first departure at t=5 ends the first segment
    assert segs[0].end == 5.0


def test_type_III_u_shape():
    # one job departs and an identical level returns shortly after
    tr = trace_from_intervals([(0.5, 4.0), (1.0, 3.0), (3.5, 8.0)], 10.0)
    segs = critical_segments(tr)
    types = [s.seg_type for s in segs]
    assert SegmentType.TYPE_III in types


def test_type_II_step_decreasing():
    tr = trace_from_intervals([(1.0, 4.0), (2.0, 6.0)], 10.0)
    segs = critical_segments(tr)
    types = [s.seg_type for s in segs]
    assert SegmentType.TYPE_II in types


@pytest.mark.parametrize("seed", range(8))
def test_random_traces_segments_well_formed(seed):
    rng = np.random.default_rng(seed)
    tr = generate_brick_trace(rng, horizon=60.0, rate=0.8, mean_duration=3.0)
    segs = critical_segments(tr)
    for s in segs:
        assert s.end > s.start
        assert s.seg_type in SegmentType
    # Prop 1, type-specific invariants
    for s in segs:
        if s.seg_type in (SegmentType.TYPE_III, SegmentType.TYPE_IV):
            assert tr.a_at(s.end) == s.start_level
