// One-pass AdamW step for Hopper (sm_90a), in the eager op order.
//
// Replaces: paddle2_tpu/kernels/pallas_fused.py `_adamw_step_kernel`,
// driven by `fused_adamw_step`. One pass over flat f32 (p, g, m, v) writes
// (p, m, v) in place:
//   m  = b1*m + (1-b1)*g
//   v  = b2*v + (1-b2)*(g*g)
//   p' = p - (lr*(m/bc1)) / (sqrt(v/bc2) + eps)
//   p' = p' - (lr*wd)*p          (decoupled decay, against the old p)
// with every scalar staged on the host in f32 by the wrapper (1-b1 from the
// Python double, bc1 = 1 - b1**t in f32 from the integer step), as the
// Pallas wrapper stages them.
//
// The contract is bitwise: the result equals the port's eager AdamW, one
// torch op per line above, on f32 state. nvcc would contract a*b + c into a
// fused multiply-add, which rounds once where the eager chain rounds twice,
// so every operation is written with its round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn), which nvcc
// never contracts.
//
// What bounds it on the H100: bytes. 28 bytes an element (four f32 streams
// in, three out) against 20 operations: 0.7 operations a byte, far below
// the card's ~20 f32 operations a byte. The grid-stride loop reads each
// element once, with neighbouring threads on neighbouring addresses.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;

struct Scalars {
  float lr, b1, om1, b2, om2, eps, wd, bc1, bc2;
};

__global__ void __launch_bounds__(NT)
    adamw_step_kernel(float* __restrict__ p, const float* __restrict__ g,
                      float* __restrict__ m, float* __restrict__ v,
                      long long n, Scalars s, int apply_wd) {
  const float lr_wd = __fmul_rn(s.lr, s.wd);
  const long long stride = (long long)gridDim.x * NT;
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < n;
       i += stride) {
    const float gi = g[i];
    const float pi = p[i];
    const float mi = __fadd_rn(__fmul_rn(s.b1, m[i]), __fmul_rn(s.om1, gi));
    const float vi = __fadd_rn(__fmul_rn(s.b2, v[i]),
                               __fmul_rn(s.om2, __fmul_rn(gi, gi)));
    const float mhat = __fdiv_rn(mi, s.bc1);
    const float vhat = __fdiv_rn(vi, s.bc2);
    float np = __fsub_rn(pi, __fdiv_rn(__fmul_rn(s.lr, mhat),
                                       __fadd_rn(__fsqrt_rn(vhat), s.eps)));
    if (apply_wd) np = __fsub_rn(np, __fmul_rn(lr_wd, pi));
    p[i] = np;
    m[i] = mi;
    v[i] = vi;
  }
}

}  // namespace

// p, g, m, v: n contiguous f32 each on the current device; p, m, v are
// updated in place.
extern "C" int adamw_step(void* p, const void* g, void* m, void* v,
                          long long n, float lr, float b1, float om1,
                          float b2, float om2, float eps, float wd, float bc1,
                          float bc2, int apply_wd, void* stream) {
  if (n <= 0) return cudaSuccess;
  const long long blocks = (n + NT - 1) / NT;
  // 8 resident blocks of 256 threads (an SM's 2,048) on each of the 132
  // SMs; larger tensors loop
  const int grid = (int)(blocks < 132 * 8 ? blocks : 132 * 8);
  Scalars s{lr, b1, om1, b2, om2, eps, wd, bc1, bc2};
  adamw_step_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<const float*>(g),
      static_cast<float*>(m), static_cast<float*>(v), n, s, apply_wd);
  return cudaGetLastError();
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
