// Elementwise probe kernel for Hopper (sm_90a): out = x * 2 + 1.
//
// Replaces the TPU kernel tools/probe_same_pallas_two_sigs.py:43 _kernel
// (launched by pallas_fixed :47 and pallas_var :70), which walks a
// (16, width) float32 array in (16, 128) blocks.  Here the array is flat:
// n = 16 * width elements, and one built kernel serves every shape a caller
// interleaves.
//
// What bounds it on the card: bytes, 8 a element, and at the probe's
// shapes (131,072 B at width 1024) the launch itself: the bytes take some
// 0.04 microseconds at 3.35 TB/s, a launch a few microseconds.  So the
// kernel is as short as a launch can be: a thread moves one float4 (16-byte
// loads and stores), the grid holds just the blocks that n needs (16 at
// width 1024) and there is no loop.  What n leaves over after its float4s,
// or all of it when a pointer is not 16-byte aligned, goes one float a
// thread.
//
// Exactness: one FFMA (__fmaf_rn) an element, rounded once.  x * 2 is exact
// in float32, so rounding x * 2 + 1 once or twice gives the same bits, and
// the kernel equals the plain version bit for bit on any input.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// Thread i takes float4 i of the first n4 and float 4 * n4 + i of the rest.
__global__ void __launch_bounds__(THREADS)
probe_affine_kernel(const float* __restrict__ x, float* __restrict__ out,
                    long long n4, long long n)
{
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i < n4) {
        float4 v = reinterpret_cast<const float4*>(x)[i];
        v.x = __fmaf_rn(v.x, 2.0f, 1.0f);
        v.y = __fmaf_rn(v.y, 2.0f, 1.0f);
        v.z = __fmaf_rn(v.z, 2.0f, 1.0f);
        v.w = __fmaf_rn(v.w, 2.0f, 1.0f);
        reinterpret_cast<float4*>(out)[i] = v;
    }
    const long long j = 4 * n4 + i;
    if (j < n) out[j] = __fmaf_rn(x[j], 2.0f, 1.0f);
}

}  // namespace

// C entry point, bound with ctypes.  Returns the CUDA error of the launch
// (0 on success).
extern "C" int ps_probe_affine(const float* x, float* out, long long n,
                               void* stream)
{
    if (n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    const bool aligned = ((reinterpret_cast<uintptr_t>(x)
                           | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
    const long long n4 = aligned ? n / 4 : 0;
    const long long threads = n4 > n - 4 * n4 ? n4 : n - 4 * n4;
    const long long grid = (threads + THREADS - 1) / THREADS;
    if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    probe_affine_kernel<<<(unsigned)grid, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(x, out, n4, n);
    return (int)cudaGetLastError();
}
