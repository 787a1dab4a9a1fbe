// Elementwise probe kernel for Hopper (sm_90a): out = x * 2 + 1.
//
// Replaces the TPU kernel tools/probe_same_pallas_two_sigs.py:43 _kernel
// (launched by pallas_fixed :47 and pallas_var :70), which walks a
// (16, width) float32 array in (16, 128) blocks.  Here the array is flat:
// n = 16 * width elements, one launch configuration for every width (a
// fixed grid of BLOCKS x THREADS threads over a grid-stride loop), so one
// built kernel serves every shape a caller interleaves.
//
// What bounds it on the card: bytes, 8 a element, and at the probe's
// shapes (131,072 B at width 1024) the launch itself: the bytes take some
// 0.04 microseconds at 3.35 TB/s, a launch a few microseconds.
//
// Exactness: one FFMA (__fmaf_rn), rounded once.  x * 2 is exact in
// float32, so rounding x * 2 + 1 once or twice gives the same bits, and
// the kernel equals the plain version bit for bit on any input.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS = 64;

__global__ void __launch_bounds__(THREADS)
probe_affine_kernel(const float* __restrict__ x, float* __restrict__ out,
                    long long n)
{
    const long long stride = (long long)gridDim.x * THREADS;
    for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
         i += stride)
        out[i] = __fmaf_rn(x[i], 2.0f, 1.0f);
}

}  // namespace

// C entry point, bound with ctypes.  Returns the CUDA error of the launch
// (0 on success).
extern "C" int ps_probe_affine(const float* x, float* out, long long n,
                               void* stream)
{
    if (n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    probe_affine_kernel<<<BLOCKS, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(x, out, n);
    return (int)cudaGetLastError();
}
