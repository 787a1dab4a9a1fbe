// Emitter physics-step kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel particlesystem_tpu/ops/pallas_step.py:39 _kernel
// (launched by physics_step_pallas), computing what
// particlesystem_tpu_torch/ops/fused_step.py::physics_step computes (its
// plain version), over the per-field float32 arrays of the emitter engine:
//
//   packed8  x, y, z, vx, vy, vz, age, life
//            alive = age <= life && life > 0; dead rows are frozen;
//            alive rows get age += dt
//   slim     x, y, z, vx, vy, vz, death  (physics_step_slim)
//            rows with death > 0 integrate; nothing else changes
//
// and, for an alive row, a = g + (wind - v) * drag (the drag terms only
// when the scene has drag), semi-implicit Euler, then each plane and each
// sphere in order: push out of contact, reflect the inbound normal velocity
// scaled by restitution, scale the tangential velocity by 1 - friction.
//
// WINDOW (the strided and select allocators): slots i in [c, c + w), with c
// read from a device int32 cursor, take valid[i - c] ? spawn row : physics.
// The spawn rows are (n_fields, w) float32; the cursor is not advanced here.
//
// In place: each slot reads only its own row and writes only its own row,
// so the kernel updates the fields where they lie (what donate_argnums was
// to the JAX engine).  life (packed8) and death (slim) are written only by
// spawn rows.
//
// What bounds it on the card: device-memory bytes.  Per live slot, packed8
// reads 32 B and writes 28 B, slim reads 28 B and writes 24 B, against
// about 40 float operations (bench scene, no contact): at 3.35 TB/s the
// bytes take some 30 times as long as the arithmetic at 67 TFLOP/s.
//
// What the design does about it: one pass, in place, nothing intermediate
// in device memory.  One thread a slot over a grid-stride loop; neighbouring
// threads read neighbouring words of each field, so every load and store is
// coalesced; the scene constants travel as a kernel argument, the physics
// and the spawn write share the pass, and dead rows are not written at all.
//
// Exactness: every operation is an explicitly rounded intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn) in the plain
// version's order, so no FMA contraction can move a particle across a plane
// (d < 0), a sphere (depth > 0) or vn < 0, and the fields equal the plain
// version's bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_PLANES = 8;
constexpr int MAX_SPHERES = 8;
constexpr int THREADS = 256;

struct Plane {
    float nx, ny, nz, px, py, pz, e, mu1;
};

struct Sphere {
    float cx, cy, cz, r, e, mu1;
};

struct Scene {
    float dt, gx, gy, gz, wx, wy, wz, k;
    int drag, n_planes, n_spheres;
    Plane planes[MAX_PLANES];
    Sphere spheres[MAX_SPHERES];
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// (a*b + c*d) + e*f, each product and sum rounded
__device__ __forceinline__ float dot3(float a, float b, float c, float d,
                                      float e, float f)
{
    return add(add(mul(a, b), mul(c, d)), mul(e, f));
}

// v' = (v - n*vn)*mu1 - (n*vn)*e, the contact response of one component
__device__ __forceinline__ float respond(float v, float n, float vn,
                                         float mu1, float e)
{
    const float nvn = mul(n, vn);
    return sub(mul(sub(v, nvn), mu1), mul(nvn, e));
}

// contact with one plane: push out along the normal, then respond
__device__ __forceinline__ void plane_contact(const Plane& pl, float& x,
                                              float& y, float& z, float& vx,
                                              float& vy, float& vz)
{
    const float d = dot3(sub(x, pl.px), pl.nx, sub(y, pl.py), pl.ny,
                         sub(z, pl.pz), pl.nz);
    if (d < 0.f) {
        x = sub(x, mul(pl.nx, d));
        y = sub(y, mul(pl.ny, d));
        z = sub(z, mul(pl.nz, d));
        const float vn = dot3(vx, pl.nx, vy, pl.ny, vz, pl.nz);
        if (vn < 0.f) {
            vx = respond(vx, pl.nx, vn, pl.mu1, pl.e);
            vy = respond(vy, pl.ny, vn, pl.mu1, pl.e);
            vz = respond(vz, pl.nz, vn, pl.mu1, pl.e);
        }
    }
}

// contact with one sphere: push out along the radial normal, then respond
__device__ __forceinline__ void sphere_contact(const Sphere& sp, float& x,
                                               float& y, float& z, float& vx,
                                               float& vy, float& vz)
{
    const float dx = sub(x, sp.cx), dy = sub(y, sp.cy), dz = sub(z, sp.cz);
    const float dist = __fsqrt_rn(dot3(dx, dx, dy, dy, dz, dz));
    const float depth = sub(sp.r, dist);
    if (depth > 0.f) {
        // max(dist, 1e-20f), a NaN distance passed through as the plain
        // version's clamp passes it
        const float safe = dist < 1e-20f ? 1e-20f : dist;
        const float nx = __fdiv_rn(dx, safe);
        const float ny = __fdiv_rn(dy, safe);
        const float nz = __fdiv_rn(dz, safe);
        x = add(x, mul(nx, depth));
        y = add(y, mul(ny, depth));
        z = add(z, mul(nz, depth));
        const float vn = dot3(vx, nx, vy, ny, vz, nz);
        if (vn < 0.f) {
            vx = respond(vx, nx, vn, sp.mu1, sp.e);
            vy = respond(vy, ny, vn, sp.mu1, sp.e);
            vz = respond(vz, nz, vn, sp.mu1, sp.e);
        }
    }
}

__device__ __forceinline__ void integrate6(const Scene& sc, float& x,
                                           float& y, float& z, float& vx,
                                           float& vy, float& vz)
{
    float ax = sc.gx, ay = sc.gy, az = sc.gz;
    if (sc.drag) {
        ax = add(sc.gx, mul(sub(sc.wx, vx), sc.k));
        ay = add(sc.gy, mul(sub(sc.wy, vy), sc.k));
        az = add(sc.gz, mul(sub(sc.wz, vz), sc.k));
    }
    vx = add(vx, mul(ax, sc.dt));
    vy = add(vy, mul(ay, sc.dt));
    vz = add(vz, mul(az, sc.dt));
    x = add(x, mul(vx, sc.dt));
    y = add(y, mul(vy, sc.dt));
    z = add(z, mul(vz, sc.dt));

    // unrolled to the fixed maximum so that every read of the scene is at a
    // static offset into the kernel's parameters (a dynamic index would copy
    // the whole struct to local memory in every thread)
#pragma unroll
    for (int p = 0; p < MAX_PLANES; ++p)
        if (p < sc.n_planes) plane_contact(sc.planes[p], x, y, z, vx, vy, vz);
#pragma unroll
    for (int s = 0; s < MAX_SPHERES; ++s)
        if (s < sc.n_spheres)
            sphere_contact(sc.spheres[s], x, y, z, vx, vy, vz);
}

template <bool SLIM, bool WINDOW>
__global__ void __launch_bounds__(THREADS) physics_step_kernel(
    float* __restrict__ x, float* __restrict__ y, float* __restrict__ z,
    float* __restrict__ vx, float* __restrict__ vy, float* __restrict__ vz,
    float* __restrict__ f6,            // age (packed8) or death (slim)
    float* __restrict__ f7,            // life (packed8); unused by slim
    long long n, const Scene sc,
    const float* __restrict__ rows,    // (n_fields, w) spawn rows
    const unsigned char* __restrict__ valid,  // (w,)
    int w, const int* __restrict__ cursor)
{
    constexpr int NF = SLIM ? 7 : 8;
    const long long c0 = WINDOW ? (long long)*cursor : 0;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        if (WINDOW) {
            const long long j = i - c0;
            if (j >= 0 && j < w && valid[j]) {
                float* out[8] = {x, y, z, vx, vy, vz, f6, f7};
#pragma unroll
                for (int f = 0; f < NF; ++f) out[f][i] = rows[f * w + j];
                continue;
            }
        }
        const float a6 = f6[i];
        bool live;
        if (SLIM) {
            live = a6 > 0.f;
        } else {
            const float life = f7[i];
            live = a6 <= life && life > 0.f;
        }
        if (!live) continue;
        float px = x[i], py = y[i], pz = z[i];
        float qx = vx[i], qy = vy[i], qz = vz[i];
        integrate6(sc, px, py, pz, qx, qy, qz);
        x[i] = px;
        y[i] = py;
        z[i] = pz;
        vx[i] = qx;
        vy[i] = qy;
        vz[i] = qz;
        if (!SLIM) f6[i] = add(a6, sc.dt);
    }
}

template <bool SLIM, bool WINDOW>
void launch(float* const* f, long long n, const Scene& sc, const float* rows,
            const unsigned char* valid, int w, const int* cursor,
            cudaStream_t stream)
{
    static int blocks_cap = 0;
    if (blocks_cap == 0) {
        int dev = 0, sms = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        blocks_cap = (sms > 0 ? sms : 132) * 16;
    }
    const long long want = (n + THREADS - 1) / THREADS;
    const int blocks = (int)(want < blocks_cap ? want : blocks_cap);
    physics_step_kernel<SLIM, WINDOW><<<blocks, THREADS, 0, stream>>>(
        f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], n, sc, rows, valid,
        w, cursor);
}

}  // namespace

// C entry point, bound with ctypes.  fields: 8 pointers (x, y, z, vx, vy,
// vz, age, life), or 7 and a null for slim.  scene: float32 values dt, g
// (3), wind (3), drag; then per plane nx, ny, nz, px, py, pz, restitution,
// 1 - friction; then per sphere cx, cy, cz, radius, restitution,
// 1 - friction.  rows null: no spawn window.  Returns the CUDA error of the
// launch (0 on success).
extern "C" int ps_physics_step(
    float* x, float* y, float* z, float* vx, float* vy, float* vz, float* f6,
    float* f7, long long n, int slim, const float* scene, int n_planes,
    int n_spheres, const float* rows, const unsigned char* valid, int w,
    const int* cursor, void* stream)
{
    if (n_planes < 0 || n_planes > MAX_PLANES || n_spheres < 0
        || n_spheres > MAX_SPHERES || (!slim && f7 == nullptr))
        return (int)cudaErrorInvalidValue;
    if (n <= 0) return 0;
    Scene sc;
    sc.dt = scene[0];
    sc.gx = scene[1];
    sc.gy = scene[2];
    sc.gz = scene[3];
    sc.wx = scene[4];
    sc.wy = scene[5];
    sc.wz = scene[6];
    sc.k = scene[7];
    sc.drag = scene[7] != 0.f;
    sc.n_planes = n_planes;
    sc.n_spheres = n_spheres;
    const float* p = scene + 8;
    for (int i = 0; i < n_planes; ++i, p += 8)
        sc.planes[i] = {p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7]};
    for (int i = 0; i < n_spheres; ++i, p += 6)
        sc.spheres[i] = {p[0], p[1], p[2], p[3], p[4], p[5]};

    float* f[8] = {x, y, z, vx, vy, vz, f6, f7};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool window = rows != nullptr;
    if (slim && window)
        launch<true, true>(f, n, sc, rows, valid, w, cursor, s);
    else if (slim)
        launch<true, false>(f, n, sc, rows, valid, w, cursor, s);
    else if (window)
        launch<false, true>(f, n, sc, rows, valid, w, cursor, s);
    else
        launch<false, false>(f, n, sc, rows, valid, w, cursor, s);
    return (int)cudaGetLastError();
}
