// One-pass (Nesterov) momentum step for Hopper (sm_90a), in the eager op
// order.
//
// Replaces: paddle2_tpu/kernels/pallas_fused.py `_momentum_step_kernel`,
// driven by `fused_momentum_step`. One pass over flat f32 (p, g, v) writes
// (p, v) in place:
//   g  = g + wd*p                (L2 decay folded into the gradient first)
//   v  = mom*v + g
//   p' = p - lr*v                (plain)
//   p' = p - lr*(g + mom*v)      (Nesterov, with the new v)
// with lr, mom and wd staged on the host in f32 by the wrapper, as the
// Pallas wrapper stages them.
//
// The contract is bitwise: the result equals the port's eager Momentum, one
// torch op per line above, on f32 state. nvcc would contract mom*v + g into
// a fused multiply-add, which rounds once where the eager chain rounds
// twice, so every operation is written with its round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn), which nvcc never contracts.
//
// What bounds it on the H100: bytes. 20 bytes an element (three f32 streams
// in, two out) against at most 7 operations: 0.35 operations a byte, far
// below the card's ~20 f32 operations a byte. The grid-stride loop reads
// each element once, with neighbouring threads on neighbouring addresses.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;

template <bool NESTEROV, bool APPLY_WD>
__global__ void __launch_bounds__(NT)
    momentum_step_kernel(float* __restrict__ p, const float* __restrict__ g,
                         float* __restrict__ v, long long n, float lr,
                         float mom, float wd) {
  const long long stride = (long long)gridDim.x * NT;
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < n;
       i += stride) {
    const float pi = p[i];
    float gi = g[i];
    if (APPLY_WD) gi = __fadd_rn(gi, __fmul_rn(wd, pi));
    const float vi = __fadd_rn(__fmul_rn(mom, v[i]), gi);
    const float step =
        NESTEROV ? __fmul_rn(lr, __fadd_rn(gi, __fmul_rn(mom, vi)))
                 : __fmul_rn(lr, vi);
    p[i] = __fsub_rn(pi, step);
    v[i] = vi;
  }
}

template <bool NESTEROV, bool APPLY_WD>
void launch(int grid, cudaStream_t stream, float* p, const float* g,
            float* v, long long n, float lr, float mom, float wd) {
  momentum_step_kernel<NESTEROV, APPLY_WD>
      <<<grid, NT, 0, stream>>>(p, g, v, n, lr, mom, wd);
}

}  // namespace

// p, g, v: n contiguous f32 each on the current device; p and v are updated
// in place.
extern "C" int momentum_step(void* p, const void* g, void* v, long long n,
                             float lr, float mom, float wd, int nesterov,
                             int apply_wd, void* stream) {
  if (n <= 0) return cudaSuccess;
  const long long blocks = (n + NT - 1) / NT;
  // 8 resident blocks of 256 threads (an SM's 2,048) on each of the 132
  // SMs; larger tensors loop
  const int grid = (int)(blocks < 132 * 8 ? blocks : 132 * 8);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(p);
  const float* gp = static_cast<const float*>(g);
  float* vp = static_cast<float*>(v);
  if (nesterov) {
    if (apply_wd) launch<true, true>(grid, s, pp, gp, vp, n, lr, mom, wd);
    else launch<true, false>(grid, s, pp, gp, vp, n, lr, mom, wd);
  } else {
    if (apply_wd) launch<false, true>(grid, s, pp, gp, vp, n, lr, mom, wd);
    else launch<false, false>(grid, s, pp, gp, vp, n, lr, mom, wd);
  }
  return cudaGetLastError();
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
