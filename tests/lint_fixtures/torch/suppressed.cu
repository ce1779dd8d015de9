// Suppression fixture for a CUDA source.
__device__ float fast_exp(float x) {
  return __expf(x);  // repro-torch-lint: disable=RPT003
}
