// Longwave no-scattering sweep, one Gauss angle, summed over g (float32).
//
// Replaces two TPU kernels of rte_rrtmgp_tpu/ops/pallas:
//  * solver_kernels.py `lw_sweep_broadband` (body `_lw_kernel`), operands
//    column-major (ncol, nlay|nlev, G): entry rrtmgp_lw_sweep_f32;
//  * solver_layergrid.py `lw_sweep_broadband_lm` (bodies `_lw_down_kernel`,
//    `_lw_up_kernel`), operands layer-major (nlay*ncol, G) with cell
//    (c, l) at row l*ncol + c and the level source in three pieces (level
//    0, levels 1..nlay-1, level nlay): entry rrtmgp_lw_sweep_lm_f32.  The
//    TPU splits the two sweeps into two calls because its grid carries the
//    recurrence; here one launch does both, as for the column-major form.
//
// Per (column, g-point): trans = exp(-tau*D), the linear-in-tau source
// (series below tau_thres), the down sweep from inc/(2*pi*w), the surface
// up = rad*(1-emis) + emis*sfc_src and jac = emis*sfc_src_jac, and the up
// sweep carrying jac*trans (reference rte_solver_kernels.cu:35-193).  up,
// dn and jac are scaled by pi*w and summed over g into (ncol, nlev).
//
// What bounds it on the H100.  By count, bytes: tau, lay_src and lev_src
// (three plane-sized inputs, 75.5 MB each at 2048x72x128) are read once
// per angle; the outputs are (ncol, nlev).  In practice, latency (PERF.md
// §6), on the 12 warps an SM that shared memory leaves room for (three
// blocks of 128 g-points): a (layer, g) costs 61 instructions in the down
// sweep's loop (an exp, a reciprocal, both sources, the staging, the row
// pointers) and 8 in the up sweep's, which the SMs issue at about a third
// of their rate.  More warps (16, a quarter of the pairs held in
// registers) gained 0-6% against this body, within the spread between
// runs; loads further ahead (an L2 prefetch of the next chunks) nothing.  2048 columns are 5.17 waves of 396 blocks, so a
// 128-g chunk's last wave runs mostly empty; a 256-g chunk (10.3 waves)
// runs 5-10% nearer the bound.
//
// Design.  A column is one thread block cluster of ceil(G/gb) blocks (at
// most 8), each a slice of gb consecutive g-points, one g-point a thread
// (threads past the slice's end are masked and add zeros).  The wrapper
// chooses gb (128 by default; PERF.md §6): a wider chunk is split so that
// every block's working set stays small enough for three blocks an SM.
// The down sweep is the only pass that reads the planes.  For every
// (layer, g) it computes trans, the down source and the up source once and
// stages (trans, src_up) in the block's working set, as the TPU kept trans
// and fact in VMEM; the up sweep and the Jacobian read only that.  The
// loads run a chunk of CH layers ahead of the recurrence, which they do
// not depend on: one chunk in registers and the next one loading beside it
// (the compiler waits for a loop's loads at its back edge, so each load
// has a whole chunk of work to arrive in); row pointers advance a layer a
// load and the loads past the last layer are off.  fact's quotient is rcp
// plus one Newton step (within an ulp of the twin's division, without its
// branch).  Each g-point's staged floats are one run of 2*nlay+3 (an odd
// stride: the warp's lanes hit distinct banks), so a thread addresses its
// own run with immediate offsets.  The up sweep overwrites each consumed
// (trans, src_up) with that level's (up, jac) and puts the surface's in
// the run's spare floats.  After one block barrier, the level sums of up
// and jac run over the slice's g in order, one (level, quantity) a thread,
// into the first g-point's run.  dn's sum starts in registers, then a
// fixed butterfly of shuffles sums a chunk of levels across the warp at
// once (9 shuffles for 8 levels, where one warp sum a level takes 40), and
// the warps' partials meet in order in the first warp's row.  After one
// cluster barrier the rank-0 block reads every block's sums (distributed
// shared memory) and adds them in rank order; a second barrier keeps the
// other blocks' shared memory alive until it has.  No atomics: the same
// result on every run.
//
// The working set, block_floats(nlay, gb) floats, lives in shared memory
// (74.6 KB a 128-g block at 72 layers: three blocks an SM).  Where it
// exceeds the 227 KB a block may use (from 223 layers at gb = 128), the
// wrapper passes a device scratch of that size per block and the same
// kernel keeps it there (a template branch on the address space, with the
// runs interleaved so that a warp's accesses coalesce): shapes choose the
// branch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int STAGED = 2;   // floats staged a (layer, g): trans and src_up
constexpr int CH = 8;       // layers a chunk: the dn butterfly's, the lead
constexpr int MAX_CLUSTER = 8;   // blocks of a portable cluster

__host__ __device__ inline int block_threads(int gb)
{
    return (gb + 31) / 32 * 32;
}

// The stride of a g-point's run: STAGED floats a layer, the surface's up
// and jac, and one spare to make it odd.
__host__ __device__ inline int run_stride(int nlay)
{
    return STAGED * nlay + 3;
}

// Floats of one block's working set: a run for each of its gb g-points,
// then each warp's dn partial at every level, rounded up to a multiple of
// 4.
__host__ __device__ inline long long block_floats(int nlay, int gb)
{
    const long long f = (long long)gb * run_stride(nlay)
                      + (long long)(block_threads(gb) / 32) * (nlay + 1);
    return (f + 3) / 4 * 4;
}

struct LwArgs {
    const float* tau;
    const float* lay_src;
    const float* lev0;    // column-major: the whole level plane
    const float* inner;   // layer-major only: levels 1..nlay-1
    const float* last;    // layer-major only: level nlay
    const float* sfc_emis;
    const float* sfc_src;
    const float* sfc_src_jac;
    const float* inc_flux;
    float* up;
    float* dn;
    float* jac;
    float* scratch;       // null unless the device-scratch branch
    int ncol, nlay, G, gb;
    float D, two_pi_w, scale, tau_thres;
};

// Sums N values of every lane over the warp: a fixed butterfly of
// shuffles, after which lane L holds the sum of value L >> (5 - log2 N)
// (each value's sum on 32/N lanes).  N = 1 is one warp sum.
template <int N>
__device__ __forceinline__ float batch_sum(float* v, int lane)
{
    static_assert(N >= 1 && N <= 32 && (N & (N - 1)) == 0, "N: 1..32, 2^k");
    int bit = 16;
    #pragma unroll
    for (int h = N / 2; h >= 1; h /= 2, bit /= 2) {
        const bool upper = (lane & bit) != 0;
        #pragma unroll
        for (int i = 0; i < h; ++i) {
            const float send = upper ? v[i] : v[i + h];
            const float keep = upper ? v[i + h] : v[i];
            v[i] = keep + __shfl_xor_sync(0xffffffffu, send, bit);
        }
    }
    float s = v[0];
    #pragma unroll
    for (; bit >= 1; bit /= 2)
        s += __shfl_xor_sync(0xffffffffu, s, bit);
    return s;
}

// 1/y for a finite normal y: the hardware approximation and one Newton
// step, within 1 ulp of the IEEE quotient and without its range check and
// branch.  Its argument here is tau*D > tau_thres.
__device__ __forceinline__ float rcp(float y)
{
    float r;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(y));
    return fmaf(r, fmaf(-y, r, 1.0f), r);
}

struct LwLayer {
    float trans, src_dn, src_up;
};

// trans and the two directional sources of one (layer, g): the down
// source with the level below the layer, the up source with the level
// above, in the twin's operation order.
__device__ __forceinline__ LwLayer lw_layer(float tau, float lay,
                                            float lev_top, float lev_bot,
                                            float D, float tau_thres)
{
    const float t = tau * D;
    const float trans = expf(-t);
    const float fact = t > tau_thres
        ? (1.0f - trans) * rcp(t) - trans
        : t * (0.5f + t * ((float)(-1.0 / 3.0) + t * (float)(1.0 / 8.0)));
    LwLayer r;
    r.trans = trans;
    r.src_dn = (1.0f - trans) * lev_bot + 2.0f * fact * (lay - lev_bot);
    r.src_up = (1.0f - trans) * lev_top + 2.0f * fact * (lay - lev_top);
    return r;
}

template <bool LM, bool GLOBAL>
__global__ void lw_sweep_kernel(const LwArgs a)
{
    constexpr int LOGC = 3;
    static_assert(CH == 1 << LOGC, "a chunk is 8 layers");
    constexpr int WRITER = (32 >> LOGC) - 1;   // lane & WRITER == 0 writes
    extern __shared__ __align__(16) float smem[];
    // The column's slices are one 1-D cluster of consecutive blocks: the
    // slice is the block's rank in it.
    cg::cluster_group cluster = cg::this_cluster();
    const int G = a.G, gb = a.gb, nlay = a.nlay, nlev = nlay + 1;
    const int nb = (G + gb - 1) / gb;
    const long long c = blockIdx.x / nb;
    const int rank = (int)(blockIdx.x - c * nb);
    const int t = threadIdx.x;
    const int tpc = blockDim.x;
    const int lane = t & 31;
    const int w = t >> 5;
    const int gw = min(gb, G - rank * gb);   // g-points of this slice
    const bool active = t < gw;
    const int S = run_stride(nlay);
    const long long bf = block_floats(nlay, gb);
    // The working set's address space is known at compile time, so the
    // shared branch uses shared-memory loads and stores throughout.
    float* const stage = GLOBAL ? a.scratch + (long long)blockIdx.x * bf
                                : smem;
    float* const part = stage + (long long)gb * S;   // [nwarp][nlev] dn
    // Float j of g-point g's run: contiguous runs in shared memory;
    // interleaved (run j of every g-point together) in the device scratch,
    // where a warp's accesses then coalesce.
    auto at = [&](int g, int j) -> float& {
        return GLOBAL ? stage[(long long)j * gb + g] : stage[g * S + j];
    };
    // This thread's g-point in the column's (ncol, G) rows and in a row of
    // the planes.
    const long long gc = (long long)rank * gb + t;
    const long long cg0 = c * G + gc;
    auto ld = [&](const float* p, bool in) {
        return in && active ? __ldg(p) : 0.0f;
    };

    // --- downward sweep ---
    float rad = ld(a.inc_flux + cg0, true) / a.two_pi_w;
    {
        float s0 = rad;
        s0 = batch_sum<1>(&s0, lane);
        if (lane == 0) part[w * nlev] = s0;
    }

    // The rows of the next layer to load: tau and lay_src, and the level
    // below it (layer-major: a row of the inner levels, or the last level's
    // row for the last layer), advanced one layer a load.  Past the last
    // layer the loads are off and read as zero.
    const long long ls = LM ? (long long)a.ncol * G : G;
    const float* pt = a.tau + (LM ? cg0 : c * nlay * G + gc);
    const float* py = a.lay_src + (LM ? cg0 : c * nlay * G + gc);
    const float* pv = LM ? a.inner + cg0 : a.lev0 + (c * nlev + 1) * G + gc;
    const float* const levn = LM ? a.last + cg0 : nullptr;
    int ln = 0;
    float levp = ld(LM ? a.lev0 + cg0 : a.lev0 + c * nlev * G + gc, true);
    auto load_layer = [&](float& x, float& y, float& z) {
        const bool in = ln < nlay;
        x = ld(pt, in);
        y = ld(py, in);
        z = ld(LM && ln + 1 == nlay ? levn : pv, in);
        pt += ls;
        py += ls;
        pv += ls;
        ++ln;
    };
    // Layer l from its inputs: the recurrence and the staged pair; returns
    // dn at level l+1.
    auto down = [&](int l, float x, float y, float z) {
        const LwLayer r = lw_layer(x, y, levp, z, a.D, a.tau_thres);
        rad = r.trans * rad + r.src_dn;
        if (active) {
            at(t, STAGED * l) = r.trans;
            at(t, STAGED * l + 1) = r.src_up;
        }
        levp = z;
        return rad;
    };
    auto put_dn = [&](int l0, float* s) {
        const float v = batch_sum<CH>(s, lane);
        const int lev = l0 + 1 + (lane >> (5 - LOGC));
        if ((lane & WRITER) == 0 && lev <= nlay) part[w * nlev + lev] = v;
    };

    // One chunk's inputs in registers and the next chunk's loading beside
    // them.
    float ct[CH], cl[CH], cv[CH];   // this chunk
    float nt[CH], nl[CH], nv[CH];   // the next one
    #pragma unroll
    for (int k = 0; k < CH; ++k) load_layer(ct[k], cl[k], cv[k]);
    int l0 = 0;
    for (; l0 + CH <= nlay; l0 += CH) {
        #pragma unroll
        for (int k = 0; k < CH; ++k) load_layer(nt[k], nl[k], nv[k]);
        float s[CH];
        #pragma unroll
        for (int k = 0; k < CH; ++k) s[k] = down(l0 + k, ct[k], cl[k], cv[k]);
        put_dn(l0, s);
        #pragma unroll
        for (int k = 0; k < CH; ++k) {
            ct[k] = nt[k];
            cl[k] = nl[k];
            cv[k] = nv[k];
        }
    }
    if (l0 < nlay) {
        float s[CH];
        #pragma unroll
        for (int k = 0; k < CH; ++k)
            s[k] = l0 + k < nlay ? down(l0 + k, ct[k], cl[k], cv[k]) : 0.0f;
        put_dn(l0, s);
    }

    // --- surface reflection + emission, then the upward sweep with the
    // Jacobian from the staged pairs, one chunk at a time (the ragged chunk
    // first, the full ones without a branch): (up, jac) of level l replace
    // the consumed (trans, src_up) of layer l. ---
    if (active) {
        const float emis = __ldg(a.sfc_emis + cg0);
        float u = rad * (1.0f - emis) + emis * __ldg(a.sfc_src + cg0);
        float j = emis * __ldg(a.sfc_src_jac + cg0);
        at(t, STAGED * nlay) = u;
        at(t, STAGED * nlay + 1) = j;
        auto up_chunk = [&](int c0, auto full_chunk) {
            constexpr bool full = decltype(full_chunk)::value;
            float tr[CH], sr[CH];
            #pragma unroll
            for (int k = 0; k < CH; ++k)
                if (full || c0 + k < nlay) {
                    tr[k] = at(t, STAGED * (c0 + k));
                    sr[k] = at(t, STAGED * (c0 + k) + 1);
                }
            #pragma unroll
            for (int k = CH - 1; k >= 0; --k)
                if (full || c0 + k < nlay) {
                    u = tr[k] * u + sr[k];
                    j = tr[k] * j;
                    at(t, STAGED * (c0 + k)) = u;
                    at(t, STAGED * (c0 + k) + 1) = j;
                }
        };
        const int lt = nlay / CH * CH;
        if (lt < nlay) up_chunk(lt, std::false_type{});
        for (int c0 = lt - CH; c0 >= 0; c0 -= CH)
            up_chunk(c0, std::true_type{});
    }

    // --- the slice's level sums in a fixed order, in place: up and jac
    // over g into the first g-point's run (run float 2*lev + q is level
    // lev's up, q = 0, or jac, q = 1; four interleaved partial sums), dn
    // over the warps into the first warp's row ---
    __syncthreads();
    for (int jr = t; jr < STAGED * nlev; jr += tpc) {
        float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        int k = 0;
        for (; k + 4 <= gw; k += 4) {
            #pragma unroll
            for (int q = 0; q < 4; ++q) p[q] += at(k + q, jr);
        }
        // The ragged tail, with constant indices (p stays in registers).
        #pragma unroll
        for (int q = 0; q < 3; ++q)
            if (k + q < gw) p[q] += at(k + q, jr);
        at(0, jr) = (p[0] + p[1]) + (p[2] + p[3]);
    }
    for (int lev = t; lev < nlev; lev += tpc) {
        float sd = 0.0f;
        for (int v = 0; v < tpc / 32; ++v) sd += part[v * nlev + lev];
        part[lev] = sd;
    }

    // --- the column's sums: rank 0 adds the slices' in rank order, scaled
    // by pi*w ---
    if (GLOBAL) __threadfence();
    cluster.sync();
    if (rank == 0) {
        const long long o = c * nlev;
        for (int i = t; i < 3 * nlev; i += tpc) {
            const int q = i / nlev;   // 0 up, 1 jac, 2 dn
            const int lev = i - q * nlev;
            float sum = 0.0f;
            for (int r = 0; r < nb; ++r) {
                const float* rs = GLOBAL
                    ? a.scratch + (long long)(blockIdx.x + r) * bf
                    : cluster.map_shared_rank(smem, r);
                sum += q == 2 ? rs[(long long)gb * S + lev]
                     : GLOBAL ? rs[(long long)(STAGED * lev + q) * gb]
                              : rs[STAGED * lev + q];
            }
            (q == 0 ? a.up : q == 1 ? a.jac : a.dn)[o + lev] = a.scale * sum;
        }
    }
    cluster.sync();
}

template <bool LM, bool GLOBAL>
int launch_branch(const LwArgs& a, void* stream)
{
    if (a.gb < 1 || a.G < 1 || a.nlay < 1)
        return (int)cudaErrorInvalidConfiguration;
    const int nb = (a.G + a.gb - 1) / a.gb;
    const int threads = block_threads(a.gb);
    if (nb > MAX_CLUSTER || threads > 1024)
        return (int)cudaErrorInvalidConfiguration;
    const size_t smem = GLOBAL ? 0
        : sizeof(float) * (size_t)block_floats(a.nlay, a.gb);
    auto kern = lw_sweep_kernel<LM, GLOBAL>;
    if (smem > 48 * 1024) {
        // Room for as many blocks an SM as shared memory allows.
        cudaError_t err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(
                kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                cudaSharedmemCarveoutMaxShared);
        if (err != cudaSuccess) return (int)err;
    }
    if (a.ncol <= 0) return (int)cudaGetLastError();
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)((long long)a.ncol * nb));
    cfg.blockDim = dim3((unsigned)threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)nb;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    // A launch without the attribute is a cluster of one block; with it,
    // the same launch measured 4-5% slower (PERF.md §6).
    cfg.numAttrs = nb > 1 ? 1 : 0;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, a);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

template <bool LM>
int launch(const LwArgs& a, void* stream)
{
    return a.scratch ? launch_branch<LM, true>(a, stream)
                     : launch_branch<LM, false>(a, stream);
}

}  // namespace

// scratch: null, or ncol * ceil(G/gb) * block_floats(nlay, gb) floats for
// the device-scratch branch; gb: g-points a block (a column's blocks,
// ceil(G/gb), are one cluster of at most 8).
extern "C" int rrtmgp_lw_sweep_f32(
    const float* tau, const float* lay_src, const float* lev_src,
    const float* sfc_emis, const float* sfc_src, const float* sfc_src_jac,
    const float* inc_flux, float* up, float* dn, float* jac, float* scratch,
    int ncol, int nlay, int G, int gb, float D, float two_pi_w, float scale,
    float tau_thres, void* stream)
{
    const LwArgs a{tau, lay_src, lev_src, nullptr, nullptr, sfc_emis,
                   sfc_src, sfc_src_jac, inc_flux, up, dn, jac, scratch,
                   ncol, nlay, G, gb, D, two_pi_w, scale, tau_thres};
    return launch<false>(a, stream);
}

extern "C" int rrtmgp_lw_sweep_lm_f32(
    const float* tau, const float* lay_src, const float* lev0,
    const float* lev_inner, const float* lev_last, const float* sfc_emis,
    const float* sfc_src, const float* sfc_src_jac, const float* inc_flux,
    float* up, float* dn, float* jac, float* scratch, int ncol, int nlay,
    int G, int gb, float D, float two_pi_w, float scale, float tau_thres,
    void* stream)
{
    const LwArgs a{tau, lay_src, lev0, lev_inner, lev_last, sfc_emis,
                   sfc_src, sfc_src_jac, inc_flux, up, dn, jac, scratch,
                   ncol, nlay, G, gb, D, two_pi_w, scale, tau_thres};
    return launch<true>(a, stream);
}
