"""RPT003 fixture: a build outside the builder, an nvcc subprocess and a
fast-math flag."""
import subprocess

from torch.utils.cpp_extension import load

CUDA_FLAGS = ["-O3", "--use_fast_math"]


def build(sources):
    return load(name="side", sources=sources, extra_cuda_cflags=CUDA_FLAGS)


def compile_one(src):
    subprocess.run(["nvcc", "-c", src], check=True)
