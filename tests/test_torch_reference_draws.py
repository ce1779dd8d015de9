"""repro_torch.eval.reference_draws == jax.random, bit for bit, on the CPU.

The port's Threefry-2x32 (on int64 tensors masked to 32 bits) must give
``jax.random``'s words for its keys, folds, splits, bits and uniforms, and
``ReferenceDraws.uniforms`` the reference harness's wait uniforms for every
keyed block of the smoke grid and of the full grid (``benchmarks/cr_eval.py``).
The normals fixture ``tests/fixtures/ref_eval_normals_jax0.9.0.npz`` must
equal the reference's normals, which ``ReferenceDraws`` returns as given
and never draws.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest

# The port's tests need torch.  CI's jax-only tier-1 job installs no torch,
# so there these files skip instead of failing at import.
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.extend.random as jex  # noqa: E402

import repro_torch.eval as peval  # noqa: E402
from repro.core.jax_provision import KEYED  # noqa: E402
from repro.core.jax_provision import _uniforms as ref_uniforms  # noqa: E402
from repro_torch.eval import reference_draws as rd  # noqa: E402
from repro_torch.eval.__main__ import FULL_GRID, SMOKE_GRID  # noqa: E402
from repro_torch.eval.harness import DEFERRAL_STREAM, POLICY_STREAM, TYPED_STREAM  # noqa: E402
from repro_torch.scenarios import Scenario  # noqa: E402

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
NORMALS = FIXTURES / "ref_eval_normals_jax0.9.0.npz"
GRIDS = {"smoke": SMOKE_GRID, "full": FULL_GRID}


def _words(a) -> np.ndarray:
    """An array or tensor of 32-bit words or float32s as uint32."""
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a.astype(np.uint32)


def _key_words(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).astype(np.uint32)


def _blocks(grid, name):
    """Every keyed block's ``uniforms`` call of ``grid``: (stream, index,
    (B, T, N)), N the levels of the reference's report; on the full grid the
    first and last index of each stream."""
    n_levels = json.loads((FIXTURES / f"ref_eval_{name}_jax0.9.0.json").read_text())[
        "grid"]["n_levels"]
    typed = sum(g.n_servers for g in grid.typed_groups)
    out = []
    for stream, policies, n in ((POLICY_STREAM, grid.policies, n_levels),
                                (TYPED_STREAM, grid.typed_policies, typed),
                                (DEFERRAL_STREAM, grid.deferral_policies, n_levels)):
        keyed = [i for i, p in enumerate(policies) if p in KEYED]
        if name == "full":
            keyed = sorted({keyed[0], keyed[-1]}) if keyed else []
        out += [(stream, i, (grid.n_traces, grid.n_slots, n)) for i in keyed]
    return out


CALLS = [(name, *call) for name in GRIDS for call in _blocks(GRIDS[name], name)]


def test_keyed_blocks_are_the_grids():
    # A2 and A3 on the policy stream, AQ-rand on the typed one, and no keyed
    # deferral policy, at the levels the reports record
    assert [c[:3] for c in CALLS] == [("smoke", 0, 1), ("smoke", 0, 2), ("smoke", 2, 1),
                                      ("full", 0, 1), ("full", 0, 2), ("full", 2, 1)]
    assert [c[3] for c in CALLS] == [(4, 288, 149)] * 2 + [(4, 288, 192)] \
        + [(16, 1008, 149)] * 2 + [(16, 1008, 192)]


def test_threefry2x32_equals_jax():
    rng = np.random.default_rng(0)
    for _ in range(4):
        k = rng.integers(0, 2**32, 2, dtype=np.uint64).astype(np.uint32)
        x = rng.integers(0, 2**32, 2 * 1000, dtype=np.uint64).astype(np.uint32)
        want = np.asarray(jex.threefry_2x32(jax.numpy.asarray(k), jax.numpy.asarray(x)))
        kt = torch.as_tensor(k.astype(np.int64))
        xt = torch.as_tensor(x.astype(np.int64))
        y0, y1 = rd.threefry2x32(kt[0], kt[1], xt[:1000], xt[1000:])
        assert np.array_equal(np.concatenate([_words(y0), _words(y1)]), want)


@pytest.mark.parametrize("seed", [0, 1, 3, 7, 2**31 - 1])
def test_key_fold_in_and_split_equal_jax(seed):
    k = jax.random.key(seed)
    assert np.array_equal(_words(rd.key(seed)), _key_words(k))
    for data in (0, 1, 5, 2**32 - 1):
        assert np.array_equal(_words(rd.fold_in(rd.key(seed), data)),
                              _key_words(jax.random.fold_in(k, data)))
    for n in (1, 2, 16):
        assert np.array_equal(_words(rd.split(rd.key(seed), n)),
                              _key_words(jax.random.split(k, n)))
    # keys of any leading shape, as ReferenceDraws splits a batch of them
    batch = rd.split(rd.fold_in(rd.key(seed), 3), 4)
    assert np.array_equal(_words(rd.split(batch, 2)),
                          _key_words(jax.vmap(jax.random.split)(
                              jax.random.split(jax.random.fold_in(k, 3), 4))))


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (288, 149)])
def test_bits_and_uniform_equal_jax(shape):
    k = jax.random.fold_in(jax.random.key(11), 2)
    mine = rd.fold_in(rd.key(11), 2)
    assert np.array_equal(_words(rd.random_bits(mine, shape)),
                          np.asarray(jax.random.bits(k, shape, jax.numpy.uint32)))
    got = rd.uniform(mine, shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    # the same key on purpose: a uniform is its key's bits, shifted into a mantissa
    want = jax.random.uniform(k, shape)  # repro-lint: disable=RPL001
    assert np.array_equal(_words(got), _words(want))


@pytest.mark.parametrize("grid,stream,index,shape", CALLS,
                         ids=[f"{c[0]}-stream{c[1]}-policy{c[2]}" for c in CALLS])
def test_uniforms_equal_the_reference_harness(grid, stream, index, shape):
    """The reference's ``_uniforms`` under the harness's keying:
    ``fold_in(key(seed + stream), index)``, split per trace."""
    seed = GRIDS[grid].seed
    key = jax.random.fold_in(jax.random.key(seed + stream), index)
    want = jax.vmap(lambda k: ref_uniforms(k, shape[1], shape[2]))(
        jax.random.split(key, shape[0]))
    draws = peval.ReferenceDraws(seed, np.zeros((1,) + shape[:2], np.float32), device="cpu")
    got = draws.uniforms(stream, index, shape)
    for g, w in zip(got, want):
        assert g.device.type == "cpu" and tuple(g.shape) == shape
        assert np.array_equal(_words(g), _words(w))


@pytest.mark.parametrize("name", list(GRIDS))
def test_normals_fixture_equals_jax(name):
    grid = GRIDS[name]
    stored = np.load(NORMALS)[name]
    assert stored.dtype == np.float32
    assert stored.shape == (len(grid.scenarios), grid.n_traces, grid.n_slots)
    for s in range(len(grid.scenarios)):
        key = jax.random.fold_in(jax.random.key(grid.seed + 1), s)
        want = jax.vmap(lambda k: jax.random.normal(k, (grid.n_slots,)))(
            jax.random.split(key, grid.n_traces))
        assert np.array_equal(_words(stored[s]), _words(want))


def test_normals_are_given_and_never_drawn():
    stored = np.load(NORMALS)["smoke"]
    draws = peval.ReferenceDraws(0, stored, device="cpu")
    for s in range(stored.shape[0]):
        got = draws.normals(s, stored.shape[1:])
        assert np.array_equal(_words(got), _words(stored[s]))
    for s, shape in ((6, (4, 288)), (-1, (4, 288)), (0, (4, 287)), (0, (16, 1008))):
        with pytest.raises(ValueError, match="no reference normals"):
            draws.normals(s, shape)
    with pytest.raises(ValueError, match=r"\(S, B, T\)"):
        peval.ReferenceDraws(0, stored[0], device="cpu")


def test_a_tiny_grid_with_reference_draws_equals_jax_draws():
    """The same port run twice on the CPU, once with the draws made by
    ``jax.random`` and once with ``ReferenceDraws``: equal reports."""
    grid = peval.EvalGrid(
        policies=("A1", "A2", "A3"),
        scenarios=(Scenario("msr_diurnal", seed=3), Scenario("step_outage", seed=4)),
        noise_stds=(0.0, 0.3), windows=(0, 2), n_traces=3, n_slots=48,
        typed_groups=SMOKE_GRID.typed_groups, device="cpu",
    )
    normals = []
    for s in range(len(grid.scenarios)):
        key = jax.random.fold_in(jax.random.key(grid.seed + 1), s)
        normals.append(np.asarray(jax.vmap(lambda k: jax.random.normal(k, (48,)))(
            jax.random.split(key, 3))))

    class JaxDraws:
        def normals(self, si, shape):
            return normals[si]

        def uniforms(self, stream, index, shape):
            key = jax.random.fold_in(jax.random.key(grid.seed + stream), index)
            u0, u = jax.vmap(lambda k: ref_uniforms(k, shape[1], shape[2]))(
                jax.random.split(key, shape[0]))
            return np.asarray(u0), np.asarray(u)

    want = peval.evaluate(grid, draws=JaxDraws())
    got = peval.evaluate(grid, draws=peval.ReferenceDraws(grid.seed, np.stack(normals),
                                                          device="cpu"))
    assert len(got.cells) == 2 * 3 * 2 * 2 + 2 * 2
    assert got.cells == want.cells
    assert dataclasses.replace(got, elapsed_s=0.0, cells=[]) \
        == dataclasses.replace(want, elapsed_s=0.0, cells=[])
