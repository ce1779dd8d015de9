// RPT003 fixture: the accurate functions.  A comment may name __expf, and
// so may a string or a block comment.
/* no __logf here either */
__global__ void softmax_row(const float* x, float* y, int n) {
  const char* note = "__expf is not used";
  int i = threadIdx.x;
  if (i < n) y[i] = expf(x[i]) + 1.f / x[i];
}
