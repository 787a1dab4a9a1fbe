// Cluster-pair neighbor kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel particlesystem_tpu/ops/neighbor_blocks.py::_kernel
// (launched by kernel_call), computing what it computes with acc_mxu=False:
// for every row of a block of b cell-sorted rows, the Plummer gravity sum
//     acc += w_j * d * rsqrt(d2 + eps2)^3
// and the collision key max
//     gmax = max cgid_j over pairs with d2 <= r2   (INT32_MIN if none)
// over the block's listed chunks of sorted snapshot columns, where a pair
// counts when both lie in the 3x3x3 cell stencil (|i1_j - i1_i| <= 1 and
// likewise i2, i3: for integer coordinates that is cd2 <= 3.5), gid_j !=
// gid_i and the column lies in the chunk's [lo, hi).  Inputs are prepared by
// particlesystem_tpu_torch/ops/neighbor_blocks.py::prepare; the plain
// PyTorch version beside it is cluster_pair_plain.
//
// What bounds it on the card.  prepare gives kid, dead and overflow rows
// out-of-band cell coordinates (i1 < 0) that pass the stencil against no
// row.  In a run's plateau (most survivors are kids) almost no listed pair
// is inside the stencil, and the least the card must do is read the listed
// columns once: bytes.  Straight after a fill every particle is an adult,
// three listed pairs in four are inside the stencil, each costs 27 float
// operations and one rsqrt, and nothing is reused across pairs: operations.
//
// What the design does about each.
// * Bytes, and work that is no work: one CTA a block; it first compacts the
//   block's in-band rows (ballot + popc, order kept), writes acc = 0 and
//   gmax = INT32_MIN for the others, and leaves if none is in band.  The
//   listed columns come in pieces of TW raw columns, fetched with 16-byte
//   cp.async into shared memory one piece ahead of the walk.  Each warp
//   fetches one contiguous segment of the piece and compacts it, again in
//   order, into its own region of a tile: only in-range, in-band columns,
//   two float4 a column (x, y, z, w and i1, i2, i3, gid as bits) and cgid
//   apart.  Regions are walked in warp order, so every row's sum runs in
//   ascending column order whatever was dropped (within a warp group's
//   regions, below): the result does not depend on the culling, nor on the
//   run.  Because a warp reads only what it fetched itself, one
//   __syncthreads() a piece is enough (two tiles).
//   The compaction goes through registers, so TMA's tile copies have no
//   use here.
// * The sort: kept columns are still sorted by cell, so staging cuts each
//   region into groups, runs of at most 32 columns of one cell (a ballot
//   of "my cell differs from the column before").  Each warp holds the box
//   of its rows' cells, which are consecutive in-band rows, and a group
//   whose cell is more than one cell from the box on any axis is skipped
//   by the whole warp.  This removes the row-edge spill that prepare leaves
//   to the per-pair test.  For the groups that stay, whether a row is
//   inside the stencil is one test a group, not one a pair.
// * Operations: a thread keeps WIDE rows in registers, so the LDS.128 of a
//   column (a broadcast) feeds that many pairs, whose terms are computed
//   without a branch and so interleave.  A pair outside the stencil, or a
//   row the thread does not have, computes a term with s = 0.  The contact
//   test leaves the loop: it only notes, by a vote, that some row is within
//   the radius of a column.  The gravity sum is a direct fp32 FMA sum, never
//   TF32 or tensor cores.  d2 is computed with __fmul_rn/__fadd_rn in the
//   order (dx*dx + dy*dy) + dz*dz, so no FMA contraction can move a pair
//   across the contact radius: gmax, kill and touch agree exactly with the
//   plain version.
//
// What bounds it on sparse frames.  In a run's plateau (frame 20 of a 1M
// run, the 786,432-row prefix) 572 of 1,536 blocks hold an in-band row, 12
// a block on average (54 at most), and each lists ~7,000 columns, ~33
// pieces.  572 CTAs fill the card's slots (4 CTAs of 256 threads an SM),
// but in each the one or two warps that hold its rows walk every piece's
// kept columns while the other warps wait at the next piece's barrier:
// the walk of those warps, piece after piece, sets the frame's time.
//
// What the design does about it: warp groups.  A block whose in-band rows
// need at most half the CTA's warps is sparse: its warps form G groups
// (warp_groups), each holding every in-band row and walking only its own
// warps' regions of every piece, and the groups' partial sums are added in
// group order.  A sparse block is walked by a kernel of its own,
// cluster_pair_kernel_sparse, so that the dense walk (cluster_pair_kernel:
// one group, as before) keeps its registers and its 4 CTAs an SM.  Both
// run on one CTA a block: the dense kernel writes the out-of-band rows and
// leaves a sparse block, the sparse kernel leaves every other block.  A
// row's sum is fixed by the state alone (no float atomics, the same bits
// on every run); a dense block sums in ascending column order, bit for bit
// as before.  The sparse kernel counts the passes and the sparse blocks it
// walks (read by ps_cluster_pair_counts).
// Cutting a live block's chunk slots across CTAs would pay only where the
// live blocks cannot fill the card's slots (fewer than 4 x 132 = 528); the
// plateau frames above hold 492-2,048.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int TW = 256;          // raw columns a piece
constexpr int WIDE = 2;          // rows a thread, from 32 * WIDE rows up
constexpr int MAX_WARPS = 16;    // warps a CTA
constexpr int MAX_B = 9 * TW;    // the row list borrows the raw piece's space
constexpr unsigned FULL = 0xffffffffu;
// from this softening up rsqrt(d2 + eps2)^3 * w is finite for every pair
constexpr float MIN_NORMAL_EPS2 = 1e-20f;

// One piece of a block's listed columns: raw columns [start, start + TW) of
// chunk slot j, whose valid columns are [first, last).  Columns are int32,
// as the chunk table's are (the entry point takes ld <= INT_MAX - TW).
struct Piece {
    int j, start, first, last;
};

// pair passes, sparse blocks walked (the sparse kernel's)
__device__ unsigned long long walk_counts[2];

// Moves p to the first piece of the first non-empty chunk at or after p.j.
__device__ __forceinline__ bool seek_chunk(const int4* ct, int nact, Piece& p)
{
    for (; p.j < nact; ++p.j) {
        const int4 c = __ldg(ct + p.j);      // aligned_start, lo, hi, n_active
        if (c.z > c.y) {
            p.first = c.x + c.y;
            p.last = c.x + c.z;
            p.start = p.first & ~3;          // 16-byte aligned fetches
            return true;
        }
    }
    return false;
}

__device__ __forceinline__ bool next_piece(const int4* ct, int nact, Piece& p)
{
    p.start += TW;
    if (p.start < p.last) return true;
    ++p.j;
    return seek_chunk(ct, nact, p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src)
{
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(src) : "memory");
}

// rsqrtf(x).  When x is known to be a normal number (NORMAL: eps2 is at
// least MIN_NORMAL_EPS2, and d2 >= 0) the special-function unit's result
// needs none of rsqrtf's scaling of denormal inputs, and is the same value.
template <bool NORMAL>
__device__ __forceinline__ float rsqrt_of(float x)
{
    if (!NORMAL) return rsqrtf(x);
    float r;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
    return r;
}

// Columns [c0, c1) of a tile, one group (all of one cell), against a
// thread's ROWS rows.  The term of every pair is computed, without a branch,
// so that the rows' chains interleave, and a pair that does not count adds
// s = 0: dx * 0 = 0 changes no bit of a sum begun at +0 (no term is small
// enough to round to -0).  A pair counts when the row is inside the
// stencil of the group's cell (in[r], one test a group) and is not the row
// itself.  The row itself has dx = dy = dz = 0, so with a finite s it adds 0
// untested.  NORMAL says that s is finite for every pair: eps2 is at least
// MIN_NORMAL_EPS2, so rs <= 1e10 and rs^3 * w overflows for no weight below
// 3e8.  Without it (eps2 = 0 makes the row's own rs infinite, and 0 * inf is
// NaN) the ids are compared in the loop.  Contacts are rare (a pair in some
// ten thousand): the loop only notes that some row of the warp is within
// the radius of the column, the row itself included, and the exact test
// with the ids runs apart.
template <int ROWS, bool NORMAL>
__device__ __forceinline__ void walk_columns(
    const float4* tp, const float4* tq, const int* tc, int c0, int c1,
    const bool (&in)[ROWS], const float (&mx)[ROWS],
    const float (&my)[ROWS], const float (&mz)[ROWS],
    const int (&mg)[ROWS], float (&ax)[ROWS], float (&ay)[ROWS],
    float (&az)[ROWS], int (&gm)[ROWS], float eps2, float r2)
{
    for (int c = c0; c < c1; ++c) {
        const float4 p = tp[c];
        float d2[ROWS];
        bool near = false;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
            const float dx = p.x - mx[r];
            const float dy = p.y - my[r];
            const float dz = p.z - mz[r];
            d2[r] = __fadd_rn(
                __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                __fmul_rn(dz, dz));
            const float rs = rsqrt_of<NORMAL>(__fadd_rn(d2[r], eps2));
            const bool ok = in[r]
                && (NORMAL || __float_as_int(tq[c].w) != mg[r]);
            const float s = ok ? rs * rs * rs * p.w : 0.f;
            ax[r] = fmaf(dx, s, ax[r]);
            ay[r] = fmaf(dy, s, ay[r]);
            az[r] = fmaf(dz, s, az[r]);
            near = near || d2[r] <= r2;
        }
        if (__any_sync(FULL, near)) {
            const int ng = __float_as_int(tq[c].w);
            const int cg = tc[c];
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
                if (d2[r] <= r2 && ng != mg[r] && in[r])
                    gm[r] = max(gm[r], cg);
        }
    }
}

// The warp groups of a walk CTA of nw warps, ROWS rows a thread at most, for
// a block with nr rows in band: G groups of nw / G warps, each holding
// every in-band row and walking its own warps' regions of every piece.  G
// is the largest power of two whose groups can still hold the rows (and
// whose partial sums fit the tiles for the combine); 1 where the rows need
// every warp.  A block with G > 1 is sparse and takes the sparse walk.
__device__ __forceinline__ int warp_groups(int nr, int rows, int nw)
{
    const int row_warps = ((nr + rows - 1) / rows + 31) / 32;
    int G = 1;
    while (2 * G * row_warps <= nw && 2 * G * nr <= 2 * TW) G <<= 1;
    return G;
}

// The walk of one block a CTA (blocks[k], or block k, written to output
// rows [k*b, (k+1)*b)): the dense kernel's (one group, the rows handed to
// every warp; it writes the out-of-band rows of every block and leaves a
// sparse one) and the sparse kernel's (warp groups; it leaves every block
// that is not sparse), two kernels so that the dense walk keeps its
// registers to itself.
template <int ROWS, bool NORMAL, bool SPARSE>
__device__ __forceinline__ void walk_block(
    const float* __restrict__ fsnap,   // (7, ld): x, y, z, i1, i2, i3, w
    const int* __restrict__ isnap,     // (2, ld): gid, cgid
    long long ld,
    const int* __restrict__ chunks,    // (n_blocks_total, c_max, 4)
    const int* __restrict__ blocks,    // (gridDim.x,) block ids, or null
    int b, int c_max, float eps2, float r2,
    float* __restrict__ acc,           // (3, acc_ld)
    long long acc_ld,
    int* __restrict__ gmax_out)        // (acc_ld,)
{
    // the fetched piece, field by field: x, y, z, i1, i2, i3, w, gid, cgid
    __shared__ __align__(16) float raw[9][TW];
    __shared__ float4 tile_p[2][TW];   // x, y, z, w
    __shared__ float4 tile_q[2][TW];   // i1, i2, i3, gid as bits
    __shared__ int tile_c[2][TW];      // cgid
    // a tile's groups, region by region: cell (i1, i2, i3) and the group's
    // columns as begin | end << 16
    __shared__ int4 groups[2][TW];
    __shared__ int tile_n[2][MAX_WARPS];   // groups in each warp's region
    __shared__ int row_n[MAX_WARPS];
    __shared__ int groups_of[3];       // warps a group, G, in-band rows

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nthr = blockDim.x, nw = nthr >> 5;
    const unsigned below = (1u << lane) - 1u;
    const int blk = blocks ? blocks[blockIdx.x] : blockIdx.x;
    const long long row0 = (long long)blk * b;
    const long long out0 = (long long)blockIdx.x * b;

    // ---- rows: each warp compacts a contiguous segment, order kept -------
    int* row_list = reinterpret_cast<int*>(&raw[0][0]);
    const int rseg = (b + nw - 1) / nw;
    const int rbeg = warp * rseg;
    const int rend = min(b, rbeg + rseg);
    int kept = 0;
    for (int i = rbeg; i < rend; i += 32) {
        const int r = i + lane;
        const bool in = r < rend;
        const bool keep = in && fsnap[3 * ld + row0 + r] >= 0.f;
        const unsigned m = __ballot_sync(FULL, keep);
        if (keep) {
            row_list[rbeg + kept + __popc(m & below)] = r;
        } else if (in && !SPARSE) {    // kid, dead or overflow: no partner
            acc[out0 + r] = 0.f;
            acc[acc_ld + out0 + r] = 0.f;
            acc[2 * acc_ld + out0 + r] = 0.f;
            gmax_out[out0 + r] = INT_MIN;
        }
        kept += __popc(m);
    }
    if (lane == 0) row_n[warp] = kept;
    __syncthreads();
    int nr = 0;
    for (int w = 0; w < nw; ++w) nr += row_n[w];
    if (SPARSE && blockIdx.x == 0 && tid == 0) atomicAdd(walk_counts, 1ULL);
    // a block with no row in band is done; a sparse block is the sparse
    // kernel's, every other block the dense kernel's
    if (nr == 0 || (warp_groups(nr, ROWS, nw) > 1) != SPARSE) return;

    // warp groups: where the in-band rows need few warps, the CTA's warps
    // form G groups (a power of two; 1 where the rows need every warp), each
    // holding every in-band row and walking its own warps' regions of every
    // piece; the groups' partial sums are added in group order at the end
    const int G = SPARSE ? warp_groups(nr, ROWS, nw) : 1;
    const int wpg = nw / G;                        // warps a group
    const int grp = warp / wpg;
    const int gtid = tid - grp * wpg * 32;         // the thread in its group
    if (SPARSE && tid == 0) {          // read again, not held in registers
        atomicAdd(walk_counts + 1, 1ULL);
        groups_of[0] = wpg;
        groups_of[1] = G;
        groups_of[2] = nr;
    }

    // thread t of a group takes in-band rows [t * rpt, (t + 1) * rpt): a
    // warp's rows are consecutive sorted rows, so their box of cells is small
    const int rpt = (nr + wpg * 32 - 1) / (wpg * 32);  // <= ROWS
    float mx[ROWS], my[ROWS], mz[ROWS], m1[ROWS], m2[ROWS], m3[ROWS];
    float ax[ROWS], ay[ROWS], az[ROWS];
    int mg[ROWS], gm[ROWS], mrow[ROWS];
    int lo1 = INT_MAX, lo2 = INT_MAX, lo3 = INT_MAX;
    int hi1 = INT_MIN, hi2 = INT_MIN, hi3 = INT_MIN;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        const int k = gtid * rpt + r;
        mx[r] = my[r] = mz[r] = m2[r] = m3[r] = 0.f;
        m1[r] = 3e38f;                 // no row: one cell from no column
        ax[r] = ay[r] = az[r] = 0.f;
        mg[r] = 0;
        gm[r] = INT_MIN;
        mrow[r] = -1;
        if (r < rpt && k < nr) {
            int w = 0, base = 0;
            while (base + row_n[w] <= k) base += row_n[w++];
            const int rr = row_list[w * rseg + (k - base)];
            const long long row = row0 + rr;
            mrow[r] = rr;
            mx[r] = fsnap[row];
            my[r] = fsnap[ld + row];
            mz[r] = fsnap[2 * ld + row];
            m1[r] = fsnap[3 * ld + row];
            m2[r] = fsnap[4 * ld + row];
            m3[r] = fsnap[5 * ld + row];
            mg[r] = isnap[row];
            const int c1 = __float2int_rn(m1[r]);
            const int c2 = __float2int_rn(m2[r]);
            const int c3 = __float2int_rn(m3[r]);
            lo1 = min(lo1, c1); hi1 = max(hi1, c1);
            lo2 = min(lo2, c2); hi2 = max(hi2, c2);
            lo3 = min(lo3, c3); hi3 = max(hi3, c3);
        }
    }
    // the warp's box of cells, widened by the stencil's one cell
    lo1 = __reduce_min_sync(FULL, lo1) - 1;
    lo2 = __reduce_min_sync(FULL, lo2) - 1;
    lo3 = __reduce_min_sync(FULL, lo3) - 1;
    hi1 = __reduce_max_sync(FULL, hi1);
    hi2 = __reduce_max_sync(FULL, hi2);
    hi3 = __reduce_max_sync(FULL, hi3);
    const bool walks = hi1 != INT_MIN;             // the warp has a row
    hi1 += walks; hi2 += walks; hi3 += walks;
    __syncthreads();     // row_list is read before the first piece lands on it

    // ---- columns: fetch a piece ahead, compact, walk -----------------------
    const int seg = TW / nw;           // raw columns a warp stages
    const int sbeg = warp * seg;
    const int4* ct = reinterpret_cast<const int4*>(chunks)
                     + (long long)blk * c_max;
    const int nact = __ldg(ct).w;
    const float* isnap_f = reinterpret_cast<const float*>(isnap);

    // the warp's own segment of piece p, 16 bytes a copy, to the chunk's end
    auto fetch = [&](const Piece& p) {
        const int units = seg >> 2;
        for (int q = lane; q < 9 * units; q += 32) {
            const int field = q / units;
            const int c = sbeg + 4 * (q - field * units);
            const int col = p.start + c;
            if (col < p.last) {
                const float* src = field < 7
                    ? fsnap + field * ld + col
                    : isnap_f + (field - 7) * ld + col;
                cp_async16(&raw[field][c], src);
            }
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    };

    Piece next;
    next.j = 0;
    bool more = seek_chunk(ct, nact, next);
    if (more) fetch(next);
    for (int buf = 0; more; buf ^= 1) {
        const Piece cur = next;
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncwarp();

        // compact the segment into the warp's region of tile buf
        int n = 0;
        for (int i = 0; i < seg; i += 32) {
            const int c = sbeg + i + lane;
            const int col = cur.start + c;
            const bool keep = i + lane < seg && col >= cur.first
                              && col < cur.last && raw[3][c] >= 0.f;
            const unsigned m = __ballot_sync(FULL, keep);
            if (keep) {
                const int d = sbeg + n + __popc(m & below);
                tile_p[buf][d] = make_float4(raw[0][c], raw[1][c], raw[2][c],
                                             raw[6][c]);
                tile_q[buf][d] = make_float4(raw[3][c], raw[4][c], raw[5][c],
                                             raw[7][c]);
                tile_c[buf][d] = __float_as_int(raw[8][c]);
            }
            n += __popc(m);
        }
        __syncwarp();
        // the region's groups: runs of kept columns of one cell, at most
        // 32 long (a run starts at lane 0 and wherever the cell changes)
        int ng = 0;
        for (int i = 0; i < n; i += 32) {
            const int d = i + lane;
            float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
            bool starts = false;
            if (d < n) {
                q = tile_q[buf][sbeg + d];
                starts = lane == 0;
                if (lane != 0) {
                    const float4 before = tile_q[buf][sbeg + d - 1];
                    starts = q.x != before.x || q.y != before.y
                             || q.z != before.z;
                }
            }
            const unsigned m = __ballot_sync(FULL, starts);
            if (starts) {
                const unsigned later = m & ~((2u << lane) - 1u);
                const int end = later ? i + __ffs(later) - 1 : min(n, i + 32);
                groups[buf][sbeg + ng + __popc(m & below)] = make_int4(
                    __float2int_rn(q.x), __float2int_rn(q.y),
                    __float2int_rn(q.z), (sbeg + d) | (sbeg + end) << 16);
            }
            ng += __popc(m);
        }
        if (lane == 0) tile_n[buf][warp] = ng;
        __syncwarp();    // every lane has read its raw columns

        more = next_piece(ct, nact, next);
        if (more) fetch(next);
        // tile buf is whole; every warp has left the tile this one replaces
        __syncthreads();
        if (!walks) continue;

        // the group's warps' regions (every warp's, in the dense walk)
        const int w0 = SPARSE ? warp & ~(groups_of[0] - 1) : 0;
        const int w1 = SPARSE ? w0 + groups_of[0] : nw;
        for (int w = w0; w < w1; ++w) {
            const int wn = tile_n[buf][w];
            for (int g = 0; g < wn; ++g) {
                const int4 cell = groups[buf][w * seg + g];
                if (cell.x > hi1 || cell.x < lo1 || cell.y > hi2
                        || cell.y < lo2 || cell.z > hi3 || cell.z < lo3)
                    continue;          // the cell is near none of the rows
                const int c0 = cell.w & 0xffff, c1 = cell.w >> 16;
                bool in[ROWS];         // the row is inside the cell's stencil
#pragma unroll
                for (int r = 0; r < ROWS; ++r)
                    in[r] = fabsf((float)cell.x - m1[r]) <= 1.f
                            && fabsf((float)cell.y - m2[r]) <= 1.f
                            && fabsf((float)cell.z - m3[r]) <= 1.f;
                walk_columns<ROWS, NORMAL>(
                    tile_p[buf], tile_q[buf], tile_c[buf], c0, c1, in, mx, my,
                    mz, mg, ax, ay, az, gm, eps2, r2);
            }
        }
    }

    if (SPARSE) {
        // the groups' partial sums of each row, added in group order, into
        // the first group's threads; the tiles are free once every walk is
        const int ng = groups_of[1], nin = groups_of[2];
        const int gw = groups_of[0] * 32;          // threads a group
        const int gi = tid / gw;                   // this thread's group
        const int kt = (tid - gi * gw) * ((nin + gw - 1) / gw);
        float4* gacc = &tile_p[0][0];              // G * nr <= 2 * TW
        int* ggmax = &tile_c[0][0];
        __syncthreads();
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
            if (mrow[r] < 0) continue;
            const int k = gi * nin + kt + r;
            gacc[k] = make_float4(ax[r], ay[r], az[r], 0.f);
            ggmax[k] = gm[r];
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
            if (mrow[r] < 0) continue;
            if (gi != 0) {
                mrow[r] = -1;
                continue;
            }
            const int k = kt + r;
            for (int q = 1; q < ng; ++q) {
                const float4 s = gacc[q * nin + k];
                ax[r] += s.x;
                ay[r] += s.y;
                az[r] += s.z;
                gm[r] = max(gm[r], ggmax[q * nin + k]);
            }
        }
    }

#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        if (mrow[r] < 0) continue;
        const long long out = out0 + mrow[r];
        acc[out] = ax[r];
        acc[acc_ld + out] = ay[r];
        acc[2 * acc_ld + out] = az[r];
        gmax_out[out] = gm[r];
    }
}

#define WALK_PARAMS                                                          \
    const float* __restrict__ fsnap, const int* __restrict__ isnap,          \
    long long ld, const int* __restrict__ chunks,                            \
    const int* __restrict__ blocks, int b, int c_max, float eps2, float r2,  \
    float* __restrict__ acc, long long acc_ld, int* __restrict__ gmax_out
#define WALK_ARGS                                                            \
    fsnap, isnap, ld, chunks, blocks, b, c_max, eps2, r2, acc, acc_ld, gmax_out

template <int ROWS, bool NORMAL>
__global__ void __launch_bounds__(ROWS == WIDE ? 32 * MAX_WARPS : 32 * WIDE)
cluster_pair_kernel(WALK_PARAMS)
{
    walk_block<ROWS, NORMAL, false>(WALK_ARGS);
}

template <int ROWS, bool NORMAL>
__global__ void __launch_bounds__(ROWS == WIDE ? 32 * MAX_WARPS : 32 * WIDE)
cluster_pair_kernel_sparse(WALK_PARAMS)
{
    walk_block<ROWS, NORMAL, true>(WALK_ARGS);
}

}  // namespace

// The walk counters of the current device (pair passes, sparse blocks
// walked by warp groups) into out[0..1], after the stream's work.
extern "C" int ps_cluster_pair_counts(long long* out, void* stream)
{
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t e = cudaMemcpyFromSymbolAsync(
        out, walk_counts, sizeof(walk_counts), 0, cudaMemcpyDeviceToHost, s);
    if (e == cudaSuccess) e = cudaStreamSynchronize(s);
    return (int)e;
}

// C entry point, bound with ctypes.  Rows of block blocks[k] (or block k
// when blocks is null) are written to output rows [k*b, (k+1)*b).  fsnap,
// isnap and chunks are 16-byte aligned and ld is a multiple of 4.  The
// dense and the sparse walks, one CTA a block each.  Returns the CUDA
// error of the launches (0 on success).
extern "C" int ps_cluster_pair(
    const float* fsnap, const int* isnap, long long ld, const int* chunks,
    const int* blocks, int n_blocks, int b, int c_max, float eps2, float r2,
    float* acc, long long acc_ld, int* gmax, void* stream)
{
    if (b <= 0 || b > MAX_B || b > WIDE * 32 * MAX_WARPS || (ld & 3)
            || ld > INT_MAX - TW || n_blocks < 0)
        return (int)cudaErrorInvalidValue;
    if (n_blocks == 0) return 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    // WIDE rows a thread where that fills a warp; a power of two of warps,
    // so that a piece splits evenly among them
    const int rows = b >= 32 * WIDE ? WIDE : 1;
    int threads = 32;
    while (threads * rows < b) threads <<= 1;
    const bool normal = eps2 >= MIN_NORMAL_EPS2;
    auto dense = rows == WIDE
        ? (normal ? cluster_pair_kernel<WIDE, true>
                  : cluster_pair_kernel<WIDE, false>)
        : (normal ? cluster_pair_kernel<1, true>
                  : cluster_pair_kernel<1, false>);
    auto sparse = rows == WIDE
        ? (normal ? cluster_pair_kernel_sparse<WIDE, true>
                  : cluster_pair_kernel_sparse<WIDE, false>)
        : (normal ? cluster_pair_kernel_sparse<1, true>
                  : cluster_pair_kernel_sparse<1, false>);
    dense<<<n_blocks, threads, 0, s>>>(fsnap, isnap, ld, chunks, blocks, b,
        c_max, eps2, r2, acc, acc_ld, gmax);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    sparse<<<n_blocks, threads, 0, s>>>(fsnap, isnap, ld, chunks, blocks, b,
        c_max, eps2, r2, acc, acc_ld, gmax);
    return (int)cudaGetLastError();
}
