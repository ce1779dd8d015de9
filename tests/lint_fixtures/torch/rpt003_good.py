"""RPT003 fixture: kernels come from the builder's loaders, and a
subprocess runs other tools."""
import subprocess

CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]


def attention():
    from repro_torch.kernels._build import load_attention

    return load_attention()


def sass(path):
    return subprocess.run(["cuobjdump", "--dump-sass", path], capture_output=True)
