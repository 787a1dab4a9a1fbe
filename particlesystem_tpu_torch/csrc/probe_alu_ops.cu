// Op-class microbenchmark kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/probe_vpu_ops.py:60 _kernel (launched by
// _call :103).  For every lane of a float32 tile it computes what that
// kernel computes:
//
//   acc = x * 0.5
//   k times:  t = acc + float(j) * 1e-30      (the loop index feeds the
//             acc = body(t, x)                  data, so layers cannot fold)
//
// with one body per variant (c = 1.0000001f):
//
//   fma         t * c + x                      one FFMA
//   mul         t * x
//   cmp         t + float(x > t)
//   select      x > t ? x : t
//   and2        (x > t) & (x < c) ? x : t
//   rsqrt       rsqrt(t + x)
//   chain16     16 times a = a * c + x          (a starts at t)
//   chainmix16  4 times  m = (a > x) & (a < c); a = m ? a * c + x : a
//
// The TPU kernel walks a grid of 64 steps over one tile held in VMEM.  Here
// the tile is repeated `reps` times over the grid, so that all SMs are
// full: thread g owns LANES consecutive lanes of repeat g / (tile / LANES)
// and keeps their x and acc in registers for the whole loop.  Every repeat
// computes the same values.  Repeat 0 stores them; the other repeats store
// only if their lane sum equals a value no input produces, a test the
// compiler cannot decide, so their loops stay.
//
// What bounds it on the card: operations.  Bytes are one tile read (the
// repeats find it in L2) and one tile written; the work is
// lanes x reps x k layers of the variant's operations plus the one FADD
// of t, against the FP32 rate of the SMs.  The anti-fold term
// float(j) * 1e-30f costs one FADD and one FMUL a thread and layer, shared
// by the thread's LANES lanes.
//
// Exactness: every arithmetic step is an explicitly rounded intrinsic, so
// nvcc contracts nothing on its own: fma, chain16 and chainmix16 round
// t * c + x once (__fmaf_rn; the plain version computes the same single
// rounding through float64), mul and the adds round once as written.  No
// -use_fast_math and no flush to zero: 1e-30f * j stays a normal float32.
// rsqrt is rsqrtf, MUFU.RSQ with 2 ulp of error, and is compared with a
// tolerance.

#include <cuda_runtime.h>

namespace {

constexpr int LANES = 8;
constexpr int THREADS = 256;
constexpr float C = 1.0000001f;

enum Variant { FMA, MUL, CMP, SELECT, AND2, RSQRT, CHAIN16, CHAINMIX16,
               N_VARIANTS };

template <int V>
__device__ __forceinline__ float body(float t, float x)
{
    if (V == FMA) return __fmaf_rn(t, C, x);
    if (V == MUL) return __fmul_rn(t, x);
    if (V == CMP) return __fadd_rn(t, x > t ? 1.0f : 0.0f);
    if (V == SELECT) return x > t ? x : t;
    if (V == AND2) return ((x > t) & (x < C)) ? x : t;
    if (V == RSQRT) return rsqrtf(__fadd_rn(t, x));
    float a = t;
    if (V == CHAIN16) {
#pragma unroll
        for (int i = 0; i < 16; ++i) a = __fmaf_rn(a, C, x);
    } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const bool m = (a > x) & (a < C);
            a = m ? __fmaf_rn(a, C, x) : a;
        }
    }
    return a;
}

template <int V>
__global__ void __launch_bounds__(THREADS)
probe_alu_kernel(const float* __restrict__ x, float* __restrict__ out,
                 int tile_vecs, long long n_threads, int k)
{
    const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (g >= n_threads) return;
    const int vec = (int)(g % tile_vecs);
    const long long rep = g / tile_vecs;

    const float4* xp = reinterpret_cast<const float4*>(x) + 2 * (long long)vec;
    const float4 x0 = xp[0], x1 = xp[1];
    const float xs[LANES] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    float acc[LANES];
#pragma unroll
    for (int i = 0; i < LANES; ++i) acc[i] = __fmul_rn(xs[i], 0.5f);

    float fj = 0.f;  // float(j), exact for every j a run uses
#pragma unroll 4
    for (int j = 0; j < k; ++j) {
        const float tiny = __fmul_rn(fj, 1e-30f);
#pragma unroll
        for (int i = 0; i < LANES; ++i)
            acc[i] = body<V>(__fadd_rn(acc[i], tiny), xs[i]);
        fj = __fadd_rn(fj, 1.0f);
    }

    float sum = acc[0];
#pragma unroll
    for (int i = 1; i < LANES; ++i) sum = __fadd_rn(sum, acc[i]);
    if (rep == 0 || sum == -1.2345678e-20f) {
        float4* op = reinterpret_cast<float4*>(out) + 2 * (long long)vec;
        op[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
        op[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
}

template <int V>
int launch(const float* x, float* out, long long n_lanes, int reps, int k,
           cudaStream_t stream)
{
    const int tile_vecs = (int)(n_lanes / LANES);
    const long long n_threads = (long long)tile_vecs * reps;
    const long long blocks = (n_threads + THREADS - 1) / THREADS;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    probe_alu_kernel<V><<<(unsigned)blocks, THREADS, 0, stream>>>(
        x, out, tile_vecs, n_threads, k);
    return (int)cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes.  x and out: n_lanes float32 each,
// 16-byte aligned, n_lanes a multiple of 8.  variant indexes the list at
// the top of this file.  Returns the CUDA error of the launch (0 on
// success).
extern "C" int ps_probe_alu_ops(const float* x, float* out, long long n_lanes,
                                int reps, int variant, int k, void* stream)
{
    if (n_lanes <= 0 || n_lanes % LANES || n_lanes / LANES > 0x7fffffffLL
        || reps <= 0 || k < 0 || variant < 0 || variant >= N_VARIANTS)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (variant) {
    case FMA: return launch<FMA>(x, out, n_lanes, reps, k, s);
    case MUL: return launch<MUL>(x, out, n_lanes, reps, k, s);
    case CMP: return launch<CMP>(x, out, n_lanes, reps, k, s);
    case SELECT: return launch<SELECT>(x, out, n_lanes, reps, k, s);
    case AND2: return launch<AND2>(x, out, n_lanes, reps, k, s);
    case RSQRT: return launch<RSQRT>(x, out, n_lanes, reps, k, s);
    case CHAIN16: return launch<CHAIN16>(x, out, n_lanes, reps, k, s);
    default: return launch<CHAINMIX16>(x, out, n_lanes, reps, k, s);
    }
}
