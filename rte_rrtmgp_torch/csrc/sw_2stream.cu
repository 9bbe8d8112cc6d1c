// Shortwave two-stream + adding solve, summed over g (float32).
//
// Replaces two TPU kernels of rte_rrtmgp_tpu/ops/pallas:
//  * solver_kernels.py `sw_2stream_broadband` (body `_sw_kernel`), operands
//    column-major (ncol, nlay, G): entry rrtmgp_sw_2stream_f32;
//  * solver_layergrid.py `sw_2stream_broadband_lm` (bodies
//    `_sw_dir_kernel`, `_sw_coeff_adding_kernel`, `_sw_flux_dn_kernel`),
//    operands layer-major (nlay*ncol, G) with cell (c, l) at row
//    l*ncol + c: entry rrtmgp_sw_2stream_lm_f32.  The TPU runs three
//    calls (its grid carries each recurrence); here one launch runs the
//    whole solve, as for the column-major form.
// The fused entries rrtmgp_sw_2stream_fused_f32 / _fused_lm_f32 take the
// gas optics as the gas-optics kernel writes them (tau_abs, tau_rayleigh)
// and zero, one or two per-(cell, band) increments (clouds, then
// aerosols), and form tau, ssa and g themselves (step 1 below): no
// per-g-point plane but the two gas planes goes through device memory.
//
// Per (column, g-point): the Meador-Weaver gamma1-gamma4, k^2 floored at
// k_min, rdif/tdif, r_dir/t_dir with the eps guard on 1-(k*mu0)^2 and the
// Ukkonen clamp, the direct beam exp(-tau/mu0), the adding up-sweep of
// albedo and source from the surface and the diffuse down-sweep (reference
// rte_solver_kernels.cu:196-286, 543-655).  up, diffuse dn and dir are
// summed over g into (ncol, nlev); the caller adds the direct beam to dn.
//
// What bounds it on the H100.  By count, bytes: three plane-sized inputs
// (tau, ssa, g), or two in the fused entries (tau_abs, tau_rayleigh, 0.5
// GiB each at 4096x256x128) plus each increment's three values a (cell,
// band), are read once, and the outputs are (ncol, nlev).  In practice,
// latency and instructions: the recurrences over layers are serial per
// (column, g), and each (layer, g) costs ~140 instructions of coefficients
// (two exp, a sqrt, three reciprocals), ~15 more flops and two or three
// divisions with the fused prologue.  The working set of a (column, g)
// pair, nlay-deep arrays that the two sweeps walk in opposite directions,
// stays in shared memory, as the TPU kept it in VMEM: nothing of size
// (cell, g) goes through device memory, and the serial passes touch only
// shared memory.
//
// Design.  A block owns one column and one tile of GT g-points (GT = 32,
// 64 or 128, chosen by the wrapper, with 256 threads, or 1024 where its
// working set leaves no room for a second block on the SM: 256 layers);
// the tiles of one column form a thread
// block cluster whose blocks push their level partials into the rank-0
// block's shared memory, which sums them in rank order after one cluster
// barrier (no atomics, the same result on every run).  Shared memory holds
// five slots S0-S4 of (nlay+1) x GT floats, each reused once its value is
// dead.  Every transcendental and division runs in one layer-parallel
// pass; the serial passes over layers carry only the recurrences:
//   0. cp.async brings tau, ssa and g into S0-S2 (16-byte copies where the
//      planes allow, 4-byte otherwise), with no registers in flight; the
//      fused entries bring tau_abs and tau_rayleigh into S0-S1 and, with
//      increments, the column's values of the bands the tile spans (see
//      below);
//   1. layer-parallel, all threads: in the fused entries first tau, ssa, g
//      of the (layer, g) in registers (sw_optics: the plain chain's
//      combine_abs_and_rayleigh, then increment_2str_by_2str for each
//      increment at the g-point's band value, in its operation order with
//      IEEE-rounded adds, multiplies and divisions, so the result is
//      bit-equal to the planes that chain writes); then the coefficients
//      of every (layer, g): S0-S4 := rdif, tdif, r_dir, t_dir, t_noscat,
//      the reciprocals by rcp below and exp(-tau/mu0) with the column's
//      1/mu0 (the twin divides; the results differ by an ulp or so);
//   2. serial, one thread per g (its own column of the slots, so 2-4 need
//      no barrier): the direct beam, a running product of t_noscat, over
//      S4 in place (row l := the beam incident on layer l, row nlay := the
//      surface beam);
//   3. serial up-sweep from the surface with the direct-beam sources
//      sup = r_dir*fdir, sdn = t_dir*fdir: albedo and source, leaving per
//      layer the four numbers the down-sweep needs (the TPU's form):
//      S0-S3 := c1 = tdif*denom, c0 = (rdif*src_below + sdn)*denom,
//      a1 = alb_below, s1 = src_below, and the top albedo and source in the
//      spare rows nlay of S2, S3;
//   4. serial down-sweep d = c1*d + c0 over S0 (row l := diffuse dn at
//      level l+1, the spare row nlay := level 0);
//   5. layer-parallel: u = d*a1 + s1 at every level, the level sums of u, d
//      and the direct beam, then the cluster's sum.
// The serial passes are latency-bound (32 recurrences a block, one a
// lane), so they are kept short: they load a chunk of 4-8 layers into
// registers at once and run the recurrence over it unpredicated (a scalar
// loop takes the remainder), and the up-sweep's 1/(1 - rdif*alb) is the
// hardware reciprocal refined by one Newton step (see rcp) rather than an
// IEEE division with its range check and branch, with explicit fused
// multiply-adds on the albedo chain (1 - rdif*alb and the new albedo).
//
// The band values of the fused entries.  A tile's g-points span few bands
// (2 of 16-g bands at GT = 32), so the column's values of those bands,
// nlay x nbt x 3 per increment (6 KB at 256 layers, nbt = 2), are copied
// into shared memory behind the level partials in step 0, with the planes
// and under the same wait; step 1 then reads them from shared memory (a
// warp's lanes share two or three addresses: broadcasts).  Read in step 1
// from device memory instead, each (layer, g) would wait on a load with
// one block an SM (the slots take ~177 KB) and nothing to hide it.
//
// The global-scratch branch.  Shared memory holds NSLOT*(nlay+1)*GT floats
// and 3*(nlay+1) level partials for each of the column's tiles (and the
// band values).  Where that exceeds the 227 KB a block may use even at the
// narrowest tile the cluster limit allows (GT = 32: from nlay = 337 at
// G = 97..128, from nlay = 356 at G <= 32), the wrapper passes a device
// scratch of that size per block and the same kernel keeps its slots there
// (plain loads instead of cp.async).  Shapes choose the branch; nothing
// else differs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NSLOT = 5;
constexpr int MAX_INC = 2;   // per-band increments a fused launch adds

// The per-band increments of a fused launch: inc[i] = (tau, ssa, g) of
// increment i, each nbnd values a cell with the cells in the planes'
// order; band (G,) the band of each g-point of the chunk, nondecreasing;
// nbt the most bands one g-tile spans (0 without increments).
struct Bands {
    const float* inc[MAX_INC][3];
    const int* band;
    int n;
    int nbnd;
    int nbt;
};

// Everything a launch reads and writes.  p0, p1, p2 are tau, ssa and g,
// or in the fused entries tau_abs and tau_rayleigh (p2 unused).
struct SwArgs {
    const float* p0;
    const float* p1;
    const float* p2;
    const float* mu0;
    const float* alb_dir;
    const float* alb_dif;
    const float* inc_dir;
    const float* inc_dif;
    float* up;
    float* dn;
    float* dir;
    float* scratch;
    int ncol, nlay, G;
    float kmin, tmin;
    Bands bands;
};

// Floats of a fused block's band values: the tile's GT band offsets (ints),
// then [increment][tau, ssa, g][layer][nbt] values; none without
// increments.
__host__ __device__ inline long long band_floats(int nlay, int gt, int ninc,
                                                 int nbt)
{
    return ninc ? gt + 3LL * ninc * nbt * nlay : 0;
}

// Floats of a block's working set: NSLOT slots of (nlay+1) x gt, then the
// level partials (up, dn, dir) of each of the column's tiles, then the
// band values of a fused launch (``extra``).
__host__ __device__ inline long long block_floats(int nlay, int gt,
                                                  int ntiles,
                                                  long long extra)
{
    return ((long long)NSLOT * gt + 3LL * ntiles) * (nlay + 1) + extra;
}

// torch.clamp(x, min=lo): NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo)
{
    return x < lo ? lo : x;
}

// tau, ssa, g of one (cell, g-point) from its gas optics and the band
// values of its increments, as the plain chain computes the planes:
// gas_optics.combine_abs_and_rayleigh, then for each increment
// optics_ops.increment_2str_by_2str (op2 the band value).  Each step is one
// IEEE-rounded operation in the chain's order, so the result is bit-equal.
// v points at increment 0's tau value of the g-point's band; q the stride
// from tau to ssa to g, n the stride from one increment to the next.
__device__ __forceinline__ void sw_optics(float tau_abs, float tau_ray,
                                          const float* v, int ninc,
                                          long long q, long long n,
                                          float eps, float& tau, float& ssa,
                                          float& g)
{
    tau = __fadd_rn(tau_abs, tau_ray);
    ssa = tau > 2.0f * eps ? __fdiv_rn(tau_ray, tau) : 0.0f;
    g = 0.0f;
    #pragma unroll
    for (int i = 0; i < MAX_INC; ++i) {
        if (i >= ninc) break;
        const float t2 = v[i * n];
        const float s2 = v[i * n + q];
        const float g2 = v[i * n + 2 * q];
        const float tau12 = __fadd_rn(tau, t2);
        const float ts1 = __fmul_rn(tau, ssa);
        const float ts2 = __fmul_rn(t2, s2);
        const float tauscat12 = __fadd_rn(ts1, ts2);
        g = __fdiv_rn(__fadd_rn(__fmul_rn(ts1, g), __fmul_rn(ts2, g2)),
                      clamp_min(tauscat12, eps));
        ssa = __fdiv_rn(tauscat12, clamp_min(tau12, eps));
        tau = tau12;
    }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src)
{
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src)
{
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(src) : "memory");
}

// 1/y for a normal y (neither zero nor subnormal): the hardware
// approximation and one Newton step, within 1 ulp of the IEEE quotient and
// without the IEEE division's range check and branch.  Its arguments here
// are 1 - rdif*alb in (0, 1], the two-stream denominator
// k(1+e^2) + gamma1(1-e^2) >= k, and 1 - (k*mu0)^2 of magnitude >= eps.
__device__ __forceinline__ float rcp(float y)
{
    float r;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(y));
    return fmaf(r, fmaf(-y, r, 1.0f), r);
}

// Sums over the tile's active g-points of three values at every level:
// out[q*nlev + lev] = sum_j value(lev, j)[q].  A level's GT g-points are
// split into GT/4 runs of four, one a lane, in consecutive lanes of one
// warp; each lane adds its run in order, then the lanes' sums meet in an
// xor-shuffle tree.
template <int GT, typename V>
__device__ __forceinline__ void level_sums(int nlev, int gw, V value,
                                           float* out)
{
    constexpr int R = GT / 4;   // runs a level: 8, 16 or 32 lanes
    const int n = nlev * R;
    for (int i0 = 0; i0 < n; i0 += blockDim.x) {
        const int i = i0 + threadIdx.x;
        const int lev = i / R;
        const int j0 = (i - lev * R) * 4;
        float3 v = make_float3(0.0f, 0.0f, 0.0f);
        if (i < n) {
            #pragma unroll
            for (int q = 0; q < 4; ++q) {
                if (j0 + q < gw) {
                    const float3 x = value(lev, j0 + q);
                    v.x += x.x;
                    v.y += x.y;
                    v.z += x.z;
                }
            }
        }
        #pragma unroll
        for (int o = R / 2; o > 0; o >>= 1) {
            v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
            v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
            v.z += __shfl_xor_sync(0xffffffffu, v.z, o);
        }
        if (i < n && j0 == 0) {
            out[lev] = v.x;
            out[nlev + lev] = v.y;
            out[2 * nlev + lev] = v.z;
        }
    }
}

template <bool LM, int GT, bool GLOBAL, bool FUSED>
__global__ void __launch_bounds__(1024) sw_2stream_kernel(const SwArgs arg)
{
    extern __shared__ __align__(16) float smem[];
    const float* __restrict__ const tau = arg.p0;   // fused: tau_abs
    const float* __restrict__ const ssa = arg.p1;   // fused: tau_rayleigh
    const float* __restrict__ const gasy = arg.p2;
    const int ncol = arg.ncol;
    const int nlay = arg.nlay;
    const int G = arg.G;
    const int ninc = FUSED ? arg.bands.n : 0;
    const int nbt = arg.bands.nbt;
    const int* __restrict__ const band = arg.bands.band;
    // The column's tiles are one 1-D cluster of consecutive blocks: the
    // tile index is the block's rank in it.
    cg::cluster_group cluster = cg::this_cluster();
    const int ntiles = (G + GT - 1) / GT;
    const long long c = blockIdx.x / ntiles;
    const int rank = (int)(blockIdx.x - c * ntiles);
    const int g0 = rank * GT;
    const int gw = min(GT, G - g0);
    const int tid = threadIdx.x;
    const int nlev = nlay + 1;
    const long long bf = block_floats(
        nlay, GT, ntiles, band_floats(nlay, GT, ninc, nbt));

    // The slots' address space is known at compile time, so the shared
    // branch uses shared-memory loads and stores throughout.
    float* const work = GLOBAL ? arg.scratch + (long long)blockIdx.x * bf
                               : smem;
    const int slot = nlev * GT;
    float* const S0 = work;
    float* const S1 = work + slot;
    float* const S2 = work + 2 * slot;
    float* const S3 = work + 3 * slot;
    float* const S4 = work + 4 * slot;
    // Rank 0's partials [tile][up, dn, dir][nlev], where every tile of the
    // column writes its own.
    float* const part0 = GLOBAL
        ? arg.scratch + (long long)(blockIdx.x - rank) * bf + NSLOT * slot
        : cluster.map_shared_rank(smem, 0) + NSLOT * slot;
    float* const part = part0 + rank * 3 * nlev;
    // This block's band values (fused, with increments): the band offset
    // of each of its g-points, then [i][tau, ssa, g][layer][nbt].
    int* const boff = (int*)(work + (NSLOT * GT + 3 * ntiles) * nlev);
    float* const bval = (float*)(boff + GT);
    const long long bq = (long long)nlay * nbt;   // tau -> ssa -> g

    // Row l of this tile in every plane: base + l*ls.  Column-major
    // (c*nlay + l)*G + g0; layer-major (l*ncol + c)*G + g0.
    const long long ls = LM ? (long long)ncol * G : G;
    const long long base = (LM ? c : c * nlay) * G + g0;
    const long long cg0 = c * G + g0;
    // A block may write into rank 0's shared memory only once every block
    // of the cluster runs: arrive here, wait before the first such write.
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

    // --- 0. tau, ssa, g (fused: tau_abs, tau_rayleigh and the band
    // values) -> S0-S2 ---
    if (GLOBAL) {
        for (int e = tid; e < nlay * GT; e += blockDim.x) {
            const int l = e / GT;
            const int j = e - l * GT;
            if (j >= gw) continue;
            const long long o = base + (long long)l * ls + j;
            S0[e] = tau[o];
            S1[e] = ssa[o];
            if (!FUSED) S2[e] = gasy[o];
        }
    } else if ((G & 3) == 0
               && (((uintptr_t)tau | (uintptr_t)ssa
                    | (FUSED ? 0 : (uintptr_t)gasy)) & 15) == 0) {
        constexpr int Q = GT / 4;
        for (int e = tid; e < nlay * Q; e += blockDim.x) {
            const int l = e / Q;
            const int j = (e - l * Q) * 4;
            if (j >= gw) continue;
            const long long o = base + (long long)l * ls + j;
            cp_async16(S0 + l * GT + j, tau + o);
            cp_async16(S1 + l * GT + j, ssa + o);
            if (!FUSED) cp_async16(S2 + l * GT + j, gasy + o);
        }
    } else {
        for (int e = tid; e < nlay * GT; e += blockDim.x) {
            const int l = e / GT;
            const int j = e - l * GT;
            if (j >= gw) continue;
            const long long o = base + (long long)l * ls + j;
            cp_async4(S0 + e, tau + o);
            cp_async4(S1 + e, ssa + o);
            if (!FUSED) cp_async4(S2 + e, gasy + o);
        }
    }
    if (FUSED && ninc) {
        // The bands blo..blo+nb-1 of the tile's g-points: nb contiguous
        // values a cell in each of the increment's arrays.
        const int blo = band[g0];
        const int nb = band[g0 + gw - 1] - blo + 1;
        if (tid < gw) boff[tid] = band[g0 + tid] - blo;
        const long long cell0 = LM ? c : c * nlay;       // cell of layer 0
        const long long cstep = LM ? ncol : 1;           // cells a layer
        const int per = nlay * nb;
        #pragma unroll
        for (int iq = 0; iq < 3 * MAX_INC; ++iq) {
            if (iq >= 3 * ninc) break;
            const float* const src = arg.bands.inc[iq / 3][iq % 3];
            float* const dst = bval + iq * bq;
            for (int e = tid; e < per; e += blockDim.x) {
                const int l = e / nb;
                const int b = e - l * nb;
                const float* s = src + (cell0 + l * cstep) * arg.bands.nbnd
                                 + blo + b;
                if (GLOBAL)
                    dst[l * nbt + b] = *s;
                else
                    cp_async4(dst + l * nbt + b, s);
            }
        }
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
                 ::: "memory");
    __syncthreads();

    // --- 1. (fused: tau, ssa, g, then) the coefficients of every
    // (layer, g) ---
    const float m = arg.mu0[c];
    const float minv = 1.0f / m;
    const float kmin = arg.kmin;
    const float tmin = arg.tmin;
    for (int e = tid; e < nlay * GT; e += blockDim.x) {
        const int jj = e % GT;
        if (jj >= gw) continue;
        float t, w, a;
        if (FUSED) {
            const float* v = ninc ? bval + (e / GT) * nbt + boff[jj]
                                  : bval;
            sw_optics(S0[e], S1[e], v, ninc, bq, 3 * bq, tmin, t, w, a);
        } else {
            t = S0[e];
            w = S1[e];
            a = S2[e];
        }
        const float gamma1 = (8.0f - w * (5.0f + 3.0f * a)) * 0.25f;
        const float gamma2 = 3.0f * (w * (1.0f - a)) * 0.25f;
        const float gamma3 = (2.0f - 3.0f * m * a) * 0.25f;
        const float gamma4 = 1.0f - gamma3;
        const float alpha1 = gamma1 * gamma4 + gamma2 * gamma3;
        const float alpha2 = gamma1 * gamma3 + gamma2 * gamma4;

        const float k = sqrtf(fmaxf((gamma1 - gamma2) * (gamma1 + gamma2),
                                    kmin));
        const float exp_mkt = expf(-t * k);
        const float exp_m2kt = exp_mkt * exp_mkt;
        const float rt_term = rcp(k * (1.0f + exp_m2kt)
                                  + gamma1 * (1.0f - exp_m2kt));
        const float rdif = rt_term * gamma2 * (1.0f - exp_m2kt);
        const float tdif = rt_term * 2.0f * k * exp_mkt;
        const float t_noscat = expf(-t * minv);

        const float k_mu = k * m;
        const float k_g3 = k * gamma3;
        const float k_g4 = k * gamma4;
        const float one_m = 1.0f - k_mu * k_mu;
        const float fact = (fabsf(one_m) > tmin) ? one_m : tmin;
        const float rt2 = w * rt_term * rcp(fact);
        float r_dir = rt2 * ((1.0f - k_mu) * (alpha2 + k_g3)
                             - (1.0f + k_mu) * (alpha2 - k_g3) * exp_m2kt
                             - 2.0f * (k_g3 - alpha2 * k_mu) * exp_mkt
                                   * t_noscat);
        float t_dir = -rt2 * ((1.0f + k_mu) * (alpha1 + k_g4) * t_noscat
                              - (1.0f - k_mu) * (alpha1 - k_g4) * exp_m2kt
                                    * t_noscat
                              - 2.0f * (k_g4 + alpha1 * k_mu) * exp_mkt);
        // Ukkonen clamp (energy conservation in single precision).
        r_dir = fmaxf(fminf(r_dir, 1.0f - t_noscat), tmin);
        t_dir = fmaxf(fminf(t_dir, 1.0f - t_noscat - r_dir), tmin);

        S0[e] = rdif;
        S1[e] = tdif;
        S2[e] = r_dir;
        S3[e] = t_dir;
        S4[e] = t_noscat;
    }
    __syncthreads();

    // --- 2.-4. the serial passes, one thread per g ---
    if (tid < gw) {
        const int j = tid;
        // 2. direct beam, top down, over S4 in place.
        float fdir = arg.inc_dir[cg0 + j] * m;
        auto beam = [&](int l, float t) {
            S4[l * GT + j] = fdir;
            fdir = t * fdir;
        };
        int l = 0;
        for (; l + 8 <= nlay; l += 8) {
            float t[8];
            #pragma unroll
            for (int k = 0; k < 8; ++k) t[k] = S4[(l + k) * GT + j];
            #pragma unroll
            for (int k = 0; k < 8; ++k) beam(l + k, t[k]);
        }
        for (; l < nlay; ++l) beam(l, S4[l * GT + j]);
        S4[nlay * GT + j] = fdir;

        // 3. adding up-sweep from the surface.
        float alb = arg.alb_dif[cg0 + j];
        float src = fdir * arg.alb_dir[cg0 + j];
        auto adding = [&](int l, float rdif, float tdif, float r_dir,
                          float t_dir, float fd) {
            const int e = l * GT + j;
            const float sup = r_dir * fd;
            const float sdn = t_dir * fd;
            const float denom = rcp(fmaf(-rdif, alb, 1.0f));
            S0[e] = tdif * denom;
            S1[e] = (rdif * src + sdn) * denom;
            S2[e] = alb;
            S3[e] = src;
            src = sup + tdif * denom * (src + alb * sdn);
            alb = fmaf(tdif * tdif * alb, denom, rdif);
        };
        for (l = nlay - 1; l >= 3; l -= 4) {
            float v[5][4];
            #pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int e = (l - k) * GT + j;
                v[0][k] = S0[e];
                v[1][k] = S1[e];
                v[2][k] = S2[e];
                v[3][k] = S3[e];
                v[4][k] = S4[e];
            }
            #pragma unroll
            for (int k = 0; k < 4; ++k)
                adding(l - k, v[0][k], v[1][k], v[2][k], v[3][k], v[4][k]);
        }
        for (; l >= 0; --l) {
            const int e = l * GT + j;
            adding(l, S0[e], S1[e], S2[e], S3[e], S4[e]);
        }
        S2[nlay * GT + j] = alb;
        S3[nlay * GT + j] = src;

        // 4. diffuse down-sweep.
        float d = arg.inc_dif ? arg.inc_dif[cg0 + j] : 0.0f;
        S0[nlay * GT + j] = d;
        auto down = [&](int l, float c1, float c0) {
            d = c1 * d + c0;
            S0[l * GT + j] = d;
        };
        for (l = 0; l + 8 <= nlay; l += 8) {
            float c1[8], c0[8];
            #pragma unroll
            for (int k = 0; k < 8; ++k) {
                c1[k] = S0[(l + k) * GT + j];
                c0[k] = S1[(l + k) * GT + j];
            }
            #pragma unroll
            for (int k = 0; k < 8; ++k) down(l + k, c1[k], c0[k]);
        }
        for (; l < nlay; ++l) down(l, S0[l * GT + j], S1[l * GT + j]);
    }
    __syncthreads();

    // --- 5. level sums of up, dn and the direct beam; the cluster's sum.
    // Level 0 takes d0 and the top albedo and source (rows nlay of S0, S2,
    // S3), level l+1 the d of row l and the a1, s1 of layer l. ---
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    level_sums<GT>(nlev, gw, [&](int lev, int j) {
        const int r = (lev == 0 ? nlay : lev - 1) * GT + j;
        const float d = S0[r];
        return make_float3(d * S2[r] + S3[r], d, S4[lev * GT + j]);
    }, part);
    if (GLOBAL) __threadfence();
    cluster.sync();
    if (rank == 0) {
        float* const out[3] = {arg.up, arg.dn, arg.dir};
        for (int i = tid; i < 3 * nlev; i += blockDim.x) {
            float sum = 0.0f;
            for (int r = 0; r < ntiles; ++r)
                sum += part0[r * 3 * nlev + i];
            const int q = i / nlev;
            out[q][c * nlev + (i - q * nlev)] = sum;
        }
    }
}

template <bool LM, int GT, bool GLOBAL, bool FUSED>
int launch_branch(const SwArgs& a, int threads, void* stream)
{
    const int ntiles = (a.G + GT - 1) / GT;
    if (ntiles > 8 || threads < 32 || threads % 32 || threads > 1024)
        return (int)cudaErrorInvalidConfiguration;
    const Bands& b = a.bands;
    if (b.n < 0 || b.n > MAX_INC || (b.n && (!b.band || b.nbnd < 1
                                             || b.nbt < 1)))
        return (int)cudaErrorInvalidValue;
    const size_t smem = a.scratch
        ? 0 : sizeof(float) * (size_t)block_floats(
                  a.nlay, GT, ntiles, band_floats(a.nlay, GT, b.n, b.nbt));
    auto kern = sw_2stream_kernel<LM, GT, GLOBAL, FUSED>;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    if (a.ncol <= 0) return (int)cudaGetLastError();
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)((long long)a.ncol * ntiles));
    cfg.blockDim = dim3((unsigned)threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)ntiles;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, a);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

template <bool LM, bool FUSED, int GT>
int launch_gt(const SwArgs& a, int threads, void* stream)
{
    if (a.scratch)
        return launch_branch<LM, GT, true, FUSED>(a, threads, stream);
    return launch_branch<LM, GT, false, FUSED>(a, threads, stream);
}

template <bool LM, bool FUSED>
int launch(const SwArgs& a, int gt, int threads, void* stream)
{
    switch (gt) {
    case 32:
        return launch_gt<LM, FUSED, 32>(a, threads, stream);
    case 64:
        return launch_gt<LM, FUSED, 64>(a, threads, stream);
    case 128:
        return launch_gt<LM, FUSED, 128>(a, threads, stream);
    default:
        return (int)cudaErrorInvalidValue;
    }
}

SwArgs sw_args(const float* p0, const float* p1, const float* p2,
               const float* mu0, const float* alb_dir, const float* alb_dif,
               const float* inc_dir, const float* inc_dif, float* up,
               float* dn, float* dir, float* scratch, int ncol, int nlay,
               int G, float kmin, float tmin, const Bands& bands)
{
    SwArgs a;
    a.p0 = p0;
    a.p1 = p1;
    a.p2 = p2;
    a.mu0 = mu0;
    a.alb_dir = alb_dir;
    a.alb_dif = alb_dif;
    a.inc_dir = inc_dir;
    a.inc_dif = inc_dif;
    a.up = up;
    a.dn = dn;
    a.dir = dir;
    a.scratch = scratch;
    a.ncol = ncol;
    a.nlay = nlay;
    a.G = G;
    a.kmin = kmin;
    a.tmin = tmin;
    a.bands = bands;
    return a;
}

Bands bands_of(const float* tau1, const float* ssa1, const float* g1,
               const float* tau2, const float* ssa2, const float* g2,
               const int* band, int ninc, int nbnd, int nbt)
{
    Bands b = {{{tau1, ssa1, g1}, {tau2, ssa2, g2}}, band, ninc, nbnd, nbt};
    return b;
}

}  // namespace

// gt: g-points a block (32, 64 or 128; at most 8 tiles a column); threads:
// threads a block (a multiple of 32, at least gt); scratch: null, or
// ncol*ceil(G/gt) blocks of block_floats(nlay, gt, ceil(G/gt), 0) floats
// for the global-scratch branch.
extern "C" int rrtmgp_sw_2stream_f32(
    const float* tau, const float* ssa, const float* g, const float* mu0,
    const float* alb_dir, const float* alb_dif, const float* inc_dir,
    const float* inc_dif, float* up, float* dn, float* dir, float* scratch,
    int ncol, int nlay, int G, int gt, int threads, float kmin, float tmin,
    void* stream)
{
    const Bands none = {};
    return launch<false, false>(
        sw_args(tau, ssa, g, mu0, alb_dir, alb_dif, inc_dir, inc_dif, up, dn,
                dir, scratch, ncol, nlay, G, kmin, tmin, none),
        gt, threads, stream);
}

extern "C" int rrtmgp_sw_2stream_lm_f32(
    const float* tau, const float* ssa, const float* g, const float* mu0,
    const float* alb_dir, const float* alb_dif, const float* inc_dir,
    const float* inc_dif, float* up, float* dn, float* dir, float* scratch,
    int ncol, int nlay, int G, int gt, int threads, float kmin, float tmin,
    void* stream)
{
    const Bands none = {};
    return launch<true, false>(
        sw_args(tau, ssa, g, mu0, alb_dir, alb_dif, inc_dir, inc_dif, up, dn,
                dir, scratch, ncol, nlay, G, kmin, tmin, none),
        gt, threads, stream);
}

// The fused entries: tau_abs and tau_ray in place of tau, ssa, g; ninc
// (0-2) increments (tau1, ssa1, g1), (tau2, ssa2, g2), each nbnd values a
// cell in the planes' cell order; band the (G,) nondecreasing band of each
// g-point; nbt the most bands a g-tile spans; scratch: null, or
// ncol*ceil(G/gt) blocks of block_floats(nlay, gt, ceil(G/gt),
// band_floats(nlay, gt, ninc, nbt)) floats.  The rest as above.
extern "C" int rrtmgp_sw_2stream_fused_f32(
    const float* tau_abs, const float* tau_ray, const float* tau1,
    const float* ssa1, const float* g1, const float* tau2, const float* ssa2,
    const float* g2, const int* band, int ninc, int nbnd, int nbt,
    const float* mu0, const float* alb_dir, const float* alb_dif,
    const float* inc_dir, const float* inc_dif, float* up, float* dn,
    float* dir, float* scratch, int ncol, int nlay, int G, int gt,
    int threads, float kmin, float tmin, void* stream)
{
    return launch<false, true>(
        sw_args(tau_abs, tau_ray, nullptr, mu0, alb_dir, alb_dif, inc_dir,
                inc_dif, up, dn, dir, scratch, ncol, nlay, G, kmin, tmin,
                bands_of(tau1, ssa1, g1, tau2, ssa2, g2, band, ninc, nbnd,
                         nbt)),
        gt, threads, stream);
}

extern "C" int rrtmgp_sw_2stream_fused_lm_f32(
    const float* tau_abs, const float* tau_ray, const float* tau1,
    const float* ssa1, const float* g1, const float* tau2, const float* ssa2,
    const float* g2, const int* band, int ninc, int nbnd, int nbt,
    const float* mu0, const float* alb_dir, const float* alb_dif,
    const float* inc_dir, const float* inc_dif, float* up, float* dn,
    float* dir, float* scratch, int ncol, int nlay, int G, int gt,
    int threads, float kmin, float tmin, void* stream)
{
    return launch<true, true>(
        sw_args(tau_abs, tau_ray, nullptr, mu0, alb_dir, alb_dif, inc_dir,
                inc_dif, up, dn, dir, scratch, ncol, nlay, G, kmin, tmin,
                bands_of(tau1, ssa1, g1, tau2, ssa2, g2, band, ninc, nbnd,
                         nbt)),
        gt, threads, stream);
}
