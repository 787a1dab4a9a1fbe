// Cluster-pair neighbor kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel particlesystem_tpu/ops/neighbor_blocks.py::_kernel
// (launched by kernel_call), computing what it computes with acc_mxu=False:
// for every row of a block of b cell-sorted rows, the Plummer gravity sum
//     acc += w_j * d * rsqrt(d2 + eps2)^3
// and the collision key max
//     gmax = max cgid_j over pairs with d2 <= r2   (INT32_MIN if none)
// over the block's listed chunks of sorted snapshot columns, where a pair
// counts when the cell-delta stencil cd2 <= 3.5 holds, gid_j != gid_i and
// the column lies in the chunk's [lo, hi).  Inputs are prepared by
// particlesystem_tpu_torch/ops/neighbor_blocks.py::prepare; the plain
// PyTorch version beside it is cluster_pair_plain.
//
// What bounds it on the card: every candidate pair costs about twenty fp32
// FMA-pipe operations plus one rsqrtf on the special-function unit, and
// nine shared-memory loads of the neighbor column; there is no reuse across
// pairs beyond what the registers hold, so issue slots and shared-memory
// bandwidth, not device memory, set the time.
//
// What the design does about it: one CTA per block; its threads stage each
// chunk's valid columns (x, y, z, i1, i2, i3, w as f32; gid, cgid as int32,
// 36 bytes a column) into shared memory once, and every thread then walks
// the staged columns for ROWS rows held in registers, so each shared load
// (a broadcast: all lanes read the same word) feeds ROWS pairs.  The gravity
// sum is a direct fp32 FMA sum, never TF32 or tensor cores.  d2 and cd2 are
// computed with __fmul_rn/__fadd_rn in the order (dx*dx + dy*dy) + dz*dz, so
// no FMA contraction can move a pair across the stencil or the contact
// radius: gmax, kill and touch agree exactly with the plain version.
// cp.async double buffering, TMA and larger tiles are left for later.

#include <climits>
#include <cuda_runtime.h>

namespace {

template <int ROWS>
__global__ void cluster_pair_kernel(
    const float* __restrict__ fsnap,   // (7, ld): x, y, z, i1, i2, i3, w
    const int* __restrict__ isnap,     // (2, ld): gid, cgid
    long long ld,
    const int* __restrict__ chunks,    // (n_blocks_total, c_max, 4)
    const int* __restrict__ blocks,    // (gridDim.x,) block ids, or null
    int b, int ch, int c_max, float eps2, float r2,
    float* __restrict__ acc,           // (3, acc_ld)
    long long acc_ld,
    int* __restrict__ gmax_out)        // (acc_ld,)
{
    extern __shared__ float smem[];
    float* sx = smem;
    float* sy = sx + ch;
    float* sz = sy + ch;
    float* s1 = sz + ch;
    float* s2 = s1 + ch;
    float* s3 = s2 + ch;
    float* sw = s3 + ch;
    int* sg = reinterpret_cast<int*>(sw + ch);
    int* sc = sg + ch;

    const int blk = blocks ? blocks[blockIdx.x] : blockIdx.x;
    const int* ct = chunks + (long long)blk * c_max * 4;
    const int nact = ct[3];

    float mx[ROWS], my[ROWS], mz[ROWS], m1[ROWS], m2[ROWS], m3[ROWS];
    float ax[ROWS], ay[ROWS], az[ROWS];
    int mg[ROWS], gm[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        const long long row = (long long)blk * b + threadIdx.x + r * blockDim.x;
        mx[r] = fsnap[row];
        my[r] = fsnap[ld + row];
        mz[r] = fsnap[2 * ld + row];
        m1[r] = fsnap[3 * ld + row];
        m2[r] = fsnap[4 * ld + row];
        m3[r] = fsnap[5 * ld + row];
        mg[r] = isnap[row];
        ax[r] = 0.f;
        ay[r] = 0.f;
        az[r] = 0.f;
        gm[r] = INT_MIN;
    }

    for (int j = 0; j < nact; ++j) {
        const long long first = (long long)ct[4 * j] + ct[4 * j + 1];
        const int width = ct[4 * j + 2] - ct[4 * j + 1];
        __syncthreads();  // every thread is done with the previous chunk
        for (int c = threadIdx.x; c < width; c += blockDim.x) {
            const long long col = first + c;
            sx[c] = fsnap[col];
            sy[c] = fsnap[ld + col];
            sz[c] = fsnap[2 * ld + col];
            s1[c] = fsnap[3 * ld + col];
            s2[c] = fsnap[4 * ld + col];
            s3[c] = fsnap[5 * ld + col];
            sw[c] = fsnap[6 * ld + col];
            sg[c] = isnap[col];
            sc[c] = isnap[ld + col];
        }
        __syncthreads();
        for (int c = 0; c < width; ++c) {
            const float n1 = s1[c], n2 = s2[c], n3 = s3[c];
            const int ng = sg[c];
#pragma unroll
            for (int r = 0; r < ROWS; ++r) {
                const float e1 = n1 - m1[r];
                const float e2 = n2 - m2[r];
                const float e3 = n3 - m3[r];
                const float cd2 = __fadd_rn(
                    __fadd_rn(__fmul_rn(e1, e1), __fmul_rn(e2, e2)),
                    __fmul_rn(e3, e3));
                if (cd2 <= 3.5f && ng != mg[r]) {
                    const float dx = sx[c] - mx[r];
                    const float dy = sy[c] - my[r];
                    const float dz = sz[c] - mz[r];
                    const float d2 = __fadd_rn(
                        __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                        __fmul_rn(dz, dz));
                    const float rs = rsqrtf(__fadd_rn(d2, eps2));
                    const float s = rs * rs * rs * sw[c];
                    ax[r] = fmaf(dx, s, ax[r]);
                    ay[r] = fmaf(dy, s, ay[r]);
                    az[r] = fmaf(dz, s, az[r]);
                    if (d2 <= r2) gm[r] = max(gm[r], sc[c]);
                }
            }
        }
    }

#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        const long long out = (long long)blockIdx.x * b + threadIdx.x
                              + r * blockDim.x;
        acc[out] = ax[r];
        acc[acc_ld + out] = ay[r];
        acc[2 * acc_ld + out] = az[r];
        gmax_out[out] = gm[r];
    }
}

template <int ROWS>
int launch(const float* fsnap, const int* isnap, long long ld,
           const int* chunks, const int* blocks, int n_blocks, int b, int ch,
           int c_max, float eps2, float r2, float* acc, long long acc_ld,
           int* gmax, cudaStream_t stream)
{
    const size_t smem = (size_t)ch * (7 * sizeof(float) + 2 * sizeof(int));
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            cluster_pair_kernel<ROWS>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    cluster_pair_kernel<ROWS><<<n_blocks, b / ROWS, smem, stream>>>(
        fsnap, isnap, ld, chunks, blocks, b, ch, c_max, eps2, r2, acc,
        acc_ld, gmax);
    return (int)cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes.  Rows of block blocks[k] (or block k
// when blocks is null) are written to output rows [k*b, (k+1)*b).  Returns
// the CUDA error of the launch (0 on success).
extern "C" int ps_cluster_pair(
    const float* fsnap, const int* isnap, long long ld, const int* chunks,
    const int* blocks, int n_blocks, int b, int ch, int c_max, float eps2,
    float r2, float* acc, long long acc_ld, int* gmax, void* stream)
{
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    // two rows a thread where the block splits evenly into >= 32 threads
    if (b % 2 == 0 && b >= 64 && b / 2 <= 1024)
        return launch<2>(fsnap, isnap, ld, chunks, blocks, n_blocks, b, ch,
                         c_max, eps2, r2, acc, acc_ld, gmax, s);
    if (b > 1024) return (int)cudaErrorInvalidValue;
    return launch<1>(fsnap, isnap, ld, chunks, blocks, n_blocks, b, ch, c_max,
                     eps2, r2, acc, acc_ld, gmax, s);
}
