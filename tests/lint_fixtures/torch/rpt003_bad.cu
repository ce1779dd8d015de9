// RPT003 fixture: fast-math intrinsics in a kernel held to f32 parity.
__global__ void softmax_row(const float* x, float* y, int n) {
  int i = threadIdx.x;
  if (i < n) y[i] = __expf(x[i]) + __fdividef(1.f, x[i]);
}
