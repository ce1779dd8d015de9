"""What the CPU can check of the attention kernels K3 and K4 themselves.

The kernels run only on the card (``chip_smoke.py`` holds them to their
plain versions there).  Here: K3's choice of kernel by element type, K4's
split plan over any shapes, the alignment the kernels' 16-byte copies
need, the note at the head of each CUDA source, and the build flags.
"""
import importlib
import pathlib
import re

import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis", reason="property tests need hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402

flash = importlib.import_module("repro_torch.kernels.flash_attention")
decode = importlib.import_module("repro_torch.kernels.decode_attention")
CSRC = pathlib.Path(_build.__file__).resolve().parent / "csrc"
REPO = CSRC.parents[3]


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("dtype,kernel", [(torch.bfloat16, "flash_wgmma_kernel"),
                                          (torch.float16, "flash_wgmma_kernel"),
                                          (torch.float32, "flash_kernel")])
def test_k3_picks_its_kernel_by_type(dtype, kernel, hd):
    name, (rows, keys) = flash.k3_instance(dtype, hd)
    assert name == kernel
    if kernel == "flash_wgmma_kernel":   # two warpgroups of 64 rows; accumulators in registers
        assert (rows, keys) == (128, 32 if hd == 256 else 128)
    else:
        assert (rows, keys) == (64, 64)


@pytest.mark.parametrize("dtype,hd", [(torch.float64, 128), (torch.int8, 64), (torch.bfloat16, 96),
                                      (torch.float32, 32), (torch.float16, 512)])
def test_k3_rejects_what_has_no_instance(dtype, hd):
    with pytest.raises(ValueError, match="K3"):
        flash.k3_instance(dtype, hd)


def test_each_k3_kernel_is_in_the_source():
    src = (CSRC / "flash_attention.cu").read_text()
    for name, _ in flash.INSTANCES.values():
        assert re.search(rf"__global__ void __launch_bounds__\([^)]*\)\s*{name}\(", src), name
    # float32 stays off the tensor cores: its kernel has no wgmma or mma
    start = src.index("flash_kernel(const T*")
    simt = src[start:src.index("cudaError_t launch(", start)]
    assert "fmaf(" in simt and "mma" not in simt


@settings(max_examples=200, deadline=None)
@given(b=st.integers(1, 256), kvh=st.integers(1, 16), s=st.integers(1, 1 << 20),
       sms=st.integers(1, 264))
def test_k4_split_plan_covers_the_cache_in_whole_tiles(b, kvh, s, sms):
    """Whatever the shapes, the chunks are whole tiles, no chunk is empty of
    positions below S, and together they cover [0, S): every valid row has
    exactly one block, whatever the lengths (the plan never sees them)."""
    n_split, chunk = decode.splits(b, kvh, s, sms)
    assert chunk % decode.TILE == 0 and chunk >= decode.TILE
    assert n_split >= 1 and (n_split - 1) * chunk < s <= n_split * chunk
    assert n_split <= -(-s // decode.TILE)


@pytest.mark.parametrize("offset", [0, 1, 3, 8])
def test_aligned_gives_16_byte_aligned_tensors(offset):
    base = torch.arange(64, dtype=torch.float32).to(torch.bfloat16)
    view = base[offset:offset + 40]
    out = flash.aligned(view)
    assert out.data_ptr() % 16 == 0 and out.is_contiguous()
    assert torch.equal(out, view)
    if view.data_ptr() % 16 == 0:
        assert out.data_ptr() == view.data_ptr()     # no copy where none is needed


@pytest.mark.parametrize("source,tpu", [
    ("flash_attention.cu", "src/repro/kernels/flash_attention.py:94"),
    ("decode_attention.cu", "src/repro/kernels/decode_attention.py:78"),
])
def test_sources_carry_their_head_note(source, tpu):
    """Each attention source names the TPU kernel it replaces, by file and
    line, what bounds it on the card, and what its design does about it."""
    head = (CSRC / source).read_text().split("#include")[0]
    assert tpu in head
    path, line = tpu.split(":")
    ref = (REPO / path).read_text().splitlines()
    assert ref[int(line) - 1].startswith("def "), "the line is the TPU kernel's function"
    for part in ("Replaces the Pallas TPU kernel", "What bounds it on this card",
                 "What the design does about it"):
        assert part in head
    assert ("Operations" if source.startswith("flash") else "Bytes") in head


def test_build_targets_sm_90a_without_fast_math():
    assert "-gencode=arch=compute_90a,code=sm_90a" in _build.CUDA_FLAGS
    assert not any("fast_math" in f or "fast-math" in f for f in _build.CUDA_FLAGS)
    for src in CSRC.glob("*.cu"):     # nor the fast exponent in the code (comments aside)
        assert "__expf" not in re.sub(r"//[^\n]*", "", src.read_text())
