"""Build and bind the port's CUDA kernels at first use.

The kernels are compiled from the sources in ``csrc/`` with
``torch.utils.cpp_extension.load`` for ``sm_90a`` (``-O3``, no
``--use_fast_math``: the scans compare float32 values exactly, and the
attention kernels are held to the reference's float32 tolerance), into two
libraries under ``build/repro_torch_kernels/`` at the root of the checkout:
the provisioning scans K1 and K2 there, the attention kernels K3 and K4 in
``attention/`` below it.  ``load`` hands a library's sources to ninja,
which runs one ``nvcc`` for each, all at once.  The sources include no
PyTorch header and export a plain C interface, so the build takes
seconds, and the library is bound with ``ctypes``; pointers and the stream
travel as integers.  ``load`` caches by content: a second process reuses
the library built by the first.

:data:`builds` counts, per library, the builds and loads of this process:
the port has no ``torch.compile``, so a library built (or found on disk and
loaded) by ``nvcc`` through ``load`` is its one compile step, the
counterpart of a jit program compiled in the reference.  A loader that
finds its library already open in the process adds nothing.
:class:`repro_torch.obs.CompileWatcher` reads the count, and each build's
seconds go to the active telemetry as ``kernels/build_ms``.

Nothing here runs at import time: the CPU tests import every module, and
the CPU has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import pathlib
import time

from ..obs.telemetry import get_telemetry

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
#: build/repro_torch_kernels at the root of the checkout (src/repro_torch/kernels/..)
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]

#: the two libraries, by the names their builds are counted under
PROVISION_SCAN = "repro_torch_provision_scan"
ATTENTION = "repro_torch_attention"

_lib: ctypes.CDLL | None = None
_attention_lib: ctypes.CDLL | None = None

#: builds and loads of each library in this process (the loaders build each
#: at most once, so a count above 1 means a caller reset a loader's cache)
builds: dict[str, int] = {PROVISION_SCAN: 0, ATTENTION: 0}

#: callables ``(library name, seconds)`` told of every build
#: (:func:`repro_torch.obs.install_monitoring` adds one)
build_listeners: list = []


def _compile(name, sources, build_dir) -> ctypes.CDLL:
    """Build the library ``name`` from ``csrc/`` sources into ``build_dir``
    (or reuse the build there) and open it."""
    from torch.utils.cpp_extension import load

    t0 = time.perf_counter()
    build_dir.mkdir(parents=True, exist_ok=True)
    path = load(
        name=name,
        sources=[str(_CSRC / source) for source in sources],
        extra_cuda_cflags=CUDA_FLAGS,
        build_directory=str(build_dir),
        is_python_module=False,
        verbose=False,
    )
    lib = ctypes.CDLL(path)
    seconds = time.perf_counter() - t0
    builds[name] += 1
    tel = get_telemetry()
    tel.count("kernels/builds", library=name)
    tel.observe("kernels/build_ms", seconds * 1e3, library=name)
    for listener in build_listeners:
        listener(name, seconds)
    return lib


def load_provision_scan() -> ctypes.CDLL:
    """Build (once per process, cached on disk) and bind the library of K1
    (``provision_scan.cu``) and K2 (``provision_scan_stream.cu``), which
    share the slot loop of ``slot_step.cuh``."""
    global _lib
    if _lib is None:
        lib = _compile(PROVISION_SCAN,
                       ("provision_scan.cu", "provision_scan_stream.cu"), BUILD_DIR)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.repro_provision_scan_grid.argtypes = [ptr] * 13 + [i32] * 6 + [ptr]
        lib.repro_provision_scan_grid.restype = i32
        lib.repro_provision_scan_max_horizon.argtypes = []
        lib.repro_provision_scan_max_horizon.restype = i32
        lib.repro_provision_scan_stream.argtypes = [ptr] * 22 + [i32] * 8 + [ptr]
        lib.repro_provision_scan_stream.restype = i32
        lib.repro_uniform_waits.argtypes = [ptr] * 5 + [ctypes.c_longlong] + [i32] * 2 + [ptr]
        lib.repro_uniform_waits.restype = i32
        lib.repro_provision_scan_stream_max_tile.argtypes = [i32, i32]
        lib.repro_provision_scan_stream_max_tile.restype = i32
        lib.repro_cuda_error_string.argtypes = [i32]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def load_attention() -> ctypes.CDLL:
    """Build (once per process, cached on disk) and bind the library of K3
    (``flash_attention.cu``) and K4 (``decode_attention.cu``)."""
    global _attention_lib
    if _attention_lib is None:
        lib = _compile(ATTENTION,
                       ("flash_attention.cu", "decode_attention.cu"), BUILD_DIR / "attention")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.repro_flash_attention.argtypes = [ptr] * 4 + [i32] * 9 + [f32, ptr]
        lib.repro_flash_attention.restype = i32
        lib.repro_decode_attention.argtypes = [ptr] * 8 + [i32] * 8 + [f32, ptr]
        lib.repro_decode_attention.restype = i32
        lib.repro_decode_attention_max_rep.argtypes = [i32]
        lib.repro_decode_attention_max_rep.restype = i32
        lib.repro_attention_error_string.argtypes = [i32]
        lib.repro_attention_error_string.restype = ctypes.c_char_p
        _attention_lib = lib
    return _attention_lib
