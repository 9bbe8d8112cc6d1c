// Gas-optics k-table interpolation for one spectral chunk (float32).
//
// Replaces the TPU kernel rte_rrtmgp_tpu/ops/pallas/interp_kernel.py
// `interp_cellw_multi` (body `_kernel_cellw`), the default gas-optics pass
// of the all-sky step: per cell n = (col, lay) and g-point of the chunk,
// resolve g's flavor (gpoint_flavor[itropo]), then the RRTMGP trilinear
// interpolation (reference gas_optics_rrtmgp_kernels.cu:398-443, 458-579,
// 674-718):
//   out_a = sum_itemp col_mix * sum_press sum_eta fmajor * kmajor      (tau)
//         + sum over the minor intervals covering g of ltau * sc
//   out_b = the same 4-corner sum on planck_rows without col_mix  (LW), or
//           2 temperature x 2 eta corners on krayl_rows times the cell's
//           Rayleigh column (col_gas[h2o] + col_gas[0])            (SW),
// where sc, each minor interval's scaling (reference :494-519), comes from
// the cell's pressure, temperature and column amounts.
//
// What bounds it on the H100: bytes by count (the two (N, G) output planes,
// 75.5 MB each at 2048x72x128, and the per-cell weights), but in practice
// the table reads: 8 (SW 6) four-byte table values a thread, 1.2 GB through
// L1/L2 a LW launch, from tables of a few MB that stay in the 50 MB L2.
//
// Design.  A block takes a tile of `tc` cells that share one layer across
// neighbouring columns, times the chunk's G: cells n = c*L + l at fixed l
// when the tile runs along axis 0 of the (C, L) inputs, consecutive n at
// fixed c along axis 1.  The wrapper runs the tile along the longer axis,
// which is the column axis both in the default (ncol, nlay) call and in
// the layer-major (nlay, ncol) one.  Cells of one layer have nearly the
// same pressure and temperature rows and eta indices, so a block's table
// reads fall on a few rows that L1 serves again.
//   * The cells' scalars (itropo, jtemp, jpress, play, tlay), their
//     per-(cell, flavor) weights (jeta, col_mix, fmajor, fminor) and column
//     amounts (col_gas), the chunk's g-point flavors, its minor entry list
//     and its interval descriptors go into shared memory once a block, in
//     coalesced cp.async copies that are all in flight at once.  Then the
//     block computes each cell's scaling of each interval of the cell's
//     atmosphere into shared memory (the other atmosphere's intervals are
//     never read), so no (N, nspec) scaling tensor exists.
//   * A thread computes four consecutive g-points with 16-byte table loads
//     and output stores where the four share a flavor and the tables and
//     outputs allow it (strides multiples of 4, 16-byte aligned, G a
//     multiple of 4; the chunk views at ngpt 256/224 and starts 0/128 do);
//     a ragged tail, mixed flavors or an unaligned view take the scalar
//     code of the same loop.  The minor intervals of such a quad are read
//     the same way where the four g-points share their interval list with
//     consecutive contributor columns from a multiple of 4 (the host marks
//     those quads): 16-byte loads of the minor tables, each interval's
//     weights read once for the four.
//   * Indexing: one 64-bit base per cell; table offsets and everything
//     inside the block are 32-bit (the wrapper checks the tables' extent);
//     no 64-bit division anywhere.
//   * Operation order: the plain twin's (gas_optics.majmin_cells_plain:
//     minor_scaling, majmin_plain, the Rayleigh factor), so the kernel
//     equals its twin bit for bit (with --fmad=false and IEEE division):
//     the major sums per temperature corner, col_mix, then the minor
//     intervals of the cell's atmosphere in interval order (lower then
//     upper).

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

template <int VW>
__device__ __forceinline__ void load(float (&v)[VW], const float* p)
{
    if constexpr (VW == 4) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(p));
        v[0] = t.x;
        v[1] = t.y;
        v[2] = t.z;
        v[3] = t.w;
    } else {
        v[0] = __ldg(p);
    }
}

template <int VW>
__device__ __forceinline__ void store(float* p, const float (&v)[VW])
{
    if constexpr (VW == 4) {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
        p[0] = v[0];
    }
}

// One cell's data in shared memory.
struct Cell {
    int it, jt, jp;
    const int* je;      // [2F]  eta index per (itemp, flavor)
    const float* cm;    // [2F]  col_mix
    const float* fmaj;  // [8F]  (itemp*4 + dp*2 + deta)*F + f
    const float* fmin;  // [4F]  (itemp*2 + deta)*F + f
    const float* sc;    // [nspec] minor scaling per interval
};

struct Tables {
    const float* a;
    int a_sr, a_se;
    const float* b;
    int b_sr, b_se;
    bool rayleigh;
    bool minor_vec;     // minor tables allow 16-byte loads
    const float* kmin_lo;
    int ncont_lo;
    const float* kmin_up;
    int ncont_up;
    int ntemp, neta, F;
    int h2o;            // col_gas index of water vapour
};

// Columns of a minor-interval descriptor row (gas_optics_interp.py
// _minor_desc): atmosphere 0 lower / 1 upper, col_gas index of the
// absorber and of the scaling gas (0: none), scales with density, scale by
// the complement.
constexpr int DESC = 5;

// A cell's factors of gas_optics._spec_scaling, the same for each of its
// intervals: the density factor 0.01 play / tlay, and vmr_fact and
// dry_fact of the scaling gas.  The dry column is floored at FLT_MIN
// (config.tiny), so that a layer with col_dry == 0 gives no NaN.
struct CellScale {
    float density, vmr_fact, dry_fact;
};

__device__ __forceinline__ CellScale cell_scale(const float* cg, float play,
                                                float tlay, int h2o)
{
    CellScale f;
    f.density = (0.01f * play) / tlay;
    f.vmr_fact = 1.0f / (cg[0] < FLT_MIN ? FLT_MIN : cg[0]);
    f.dry_fact = 1.0f / (1.0f + cg[h2o] * f.vmr_fact);
    return f;
}

// The scaling of one minor interval (descriptor row d) in one cell:
// gas_optics._spec_scaling in its float32 operations and order (the
// atmosphere mask, 1 in the cell's own atmosphere, leaves it unchanged).
__device__ __forceinline__ float minor_scale(const int* d, const float* cg,
                                             const CellScale& f)
{
    float s = cg[d[1]];
    if (d[3]) {
        s = s * f.density;
        if (d[2] > 0) {
            const float sx = cg[d[2]] * f.vmr_fact * f.dry_fact;
            s = s * (d[4] ? 1.0f - sx : sx);
        }
    }
    return s;
}

// The major gases of VW consecutive g-points from g that share flavor f.
template <int VW>
__device__ __forceinline__ void major(const Tables& t, const Cell& x, int f,
                                      int g, float (&tau)[VW],
                                      float (&second)[VW])
{
    const int F = t.F;
    #pragma unroll
    for (int v = 0; v < VW; ++v) {
        tau[v] = 0.0f;
        second[v] = 0.0f;
    }
    #pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int je = x.je[i * F + f];
        float acc_a[VW], acc_b[VW];
        #pragma unroll
        for (int v = 0; v < VW; ++v) {
            acc_a[v] = 0.0f;
            acc_b[v] = 0.0f;
        }
        #pragma unroll
        for (int dp = 0; dp < 2; ++dp) {
            const int row = (x.jp + x.it + dp) * t.ntemp + x.jt + i;
            const float w0 = x.fmaj[(i * 4 + dp * 2) * F + f];
            const float w1 = x.fmaj[(i * 4 + dp * 2 + 1) * F + f];
            float a0[VW], a1[VW];
            const float* pa = t.a + row * t.a_sr + je * t.a_se + g;
            load(a0, pa);
            load(a1, pa + t.a_se);
            #pragma unroll
            for (int v = 0; v < VW; ++v)
                acc_a[v] = acc_a[v] + (w0 * a0[v] + w1 * a1[v]);
            if (!t.rayleigh) {
                float b0[VW], b1[VW];
                const float* pb = t.b + row * t.b_sr + je * t.b_se + g;
                load(b0, pb);
                load(b1, pb + t.b_se);
                #pragma unroll
                for (int v = 0; v < VW; ++v)
                    acc_b[v] = acc_b[v] + (w0 * b0[v] + w1 * b1[v]);
            }
        }
        const float cm = x.cm[i * F + f];
        #pragma unroll
        for (int v = 0; v < VW; ++v)
            tau[v] = tau[v] + cm * acc_a[v];
        if (t.rayleigh) {
            const int row = x.it * t.ntemp + x.jt + i;
            const float v0 = x.fmin[(i * 2) * F + f];
            const float v1 = x.fmin[(i * 2 + 1) * F + f];
            float b0[VW], b1[VW];
            const float* pb = t.b + row * t.b_sr + je * t.b_se + g;
            load(b0, pb);
            load(b1, pb + t.b_se);
            #pragma unroll
            for (int v = 0; v < VW; ++v)
                second[v] = second[v] + (v0 * b0[v] + v1 * b1[v]);
        } else {
            #pragma unroll
            for (int v = 0; v < VW; ++v)
                second[v] = second[v] + acc_b[v];
        }
    }
}

// Minor intervals covering g-point gg, in entry order (interval, then
// atmosphere lower before upper): ltau from 2 temperature x 2 eta corners
// of the (ntemp, neta, ncontrib) table, times the interval's scaling.  A
// cell visits only the entries of its own atmosphere (the other's scaling
// is exactly zero).
__device__ __forceinline__ float add_minor(const Tables& t, const Cell& x,
                                           const int* eoff, const int* ents,
                                           int gg, float tau)
{
    const int F = t.F;
    for (int e = eoff[gg]; e < eoff[gg + 1]; ++e) {
        const int* en = ents + 4 * e;
        const int atm = en[1];
        if (atm != x.it) continue;
        const int k = en[0];
        const int col = en[2];
        const int mf = en[3];
        const float* km = atm ? t.kmin_up : t.kmin_lo;
        const int nc = atm ? t.ncont_up : t.ncont_lo;
        const int je0 = x.je[mf];
        const int je1 = x.je[F + mf];
        const float k00 = __ldg(km + (x.jt * t.neta + je0) * nc + col);
        const float k01 = __ldg(km + (x.jt * t.neta + je0 + 1) * nc + col);
        const float k10 = __ldg(km + ((x.jt + 1) * t.neta + je1) * nc + col);
        const float k11 =
            __ldg(km + ((x.jt + 1) * t.neta + je1 + 1) * nc + col);
        const float ltau = (x.fmin[mf] * k00 + x.fmin[F + mf] * k01)
                         + (x.fmin[2 * F + mf] * k10
                            + x.fmin[3 * F + mf] * k11);
        tau = tau + ltau * x.sc[k];
    }
    return tau;
}

// 4-byte copy global -> shared that holds no register while in flight.
__device__ __forceinline__ void cp_async4(void* dst, const void* src)
{
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(s), "l"(src) : "memory");
}

// The minor intervals of a quad of g-points from g whose four entry lists
// match (same intervals, contributor columns col..col+3): the per-g
// arithmetic and order of add_minor, four g-points a load.
__device__ __forceinline__ void add_minor4(const Tables& t, const Cell& x,
                                           const int* eoff, const int* ents,
                                           int g, float (&tau)[4])
{
    const int F = t.F;
    for (int e = eoff[g]; e < eoff[g + 1]; ++e) {
        const int* en = ents + 4 * e;
        const int atm = en[1];
        if (atm != x.it) continue;
        const int k = en[0];
        const int col = en[2];
        const int mf = en[3];
        const float* km = atm ? t.kmin_up : t.kmin_lo;
        const int nc = atm ? t.ncont_up : t.ncont_lo;
        const int je0 = x.je[mf];
        const int je1 = x.je[F + mf];
        float k00[4], k01[4], k10[4], k11[4];
        load(k00, km + (x.jt * t.neta + je0) * nc + col);
        load(k01, km + (x.jt * t.neta + je0 + 1) * nc + col);
        load(k10, km + ((x.jt + 1) * t.neta + je1) * nc + col);
        load(k11, km + ((x.jt + 1) * t.neta + je1 + 1) * nc + col);
        const float f0 = x.fmin[mf], f1 = x.fmin[F + mf];
        const float f2 = x.fmin[2 * F + mf], f3 = x.fmin[3 * F + mf];
        const float scale = x.sc[k];
        #pragma unroll
        for (int v = 0; v < 4; ++v) {
            const float ltau = (f0 * k00[v] + f1 * k01[v])
                             + (f2 * k10[v] + f3 * k11[v]);
            tau[v] = tau[v] + ltau * scale;
        }
    }
}

// w values of each of the block's cells, cell-major: dst[k*w + j] =
// src[n_k*w + j] with n_k = n0 + k*sa (all copies in flight at once).
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src,
                                      int w, long long n0, long long sa,
                                      int ncell)
{
    for (int e = threadIdx.x; e < ncell * w; e += blockDim.x) {
        const int k = e / w;
        cp_async4(dst + e, src + (n0 + k * sa) * w + (e - k * w));
    }
}

__global__ void gas_optics_interp_kernel(
    Tables t,
    const int* __restrict__ jtemp0, const int* __restrict__ jpress0,
    const int* __restrict__ itropo01, const int* __restrict__ jeta0,
    const float* __restrict__ col_mix, const float* __restrict__ fminor,
    const float* __restrict__ fmajor, const int* __restrict__ gflav,
    const float* __restrict__ play, const float* __restrict__ tlay,
    const float* __restrict__ col_gas, int ngc,
    const int* __restrict__ desc, int nspec,
    const int* __restrict__ ent_off, const int* __restrict__ ent, int nent,
    const int* __restrict__ quad_minor, float* __restrict__ out_a,
    float* __restrict__ out_b, int C, int L, int G, int axis, int tc,
    bool vec)
{
    extern __shared__ __align__(16) int sm[];
    const int F = t.F;
    const int nq = (G + 3) >> 2;

    // The tile: cells n = n0 + k*sa, k < ncell, along `axis` at a fixed
    // index of the other axis.
    const int nA = axis ? L : C;
    const long long sa = axis ? 1 : L;
    const long long sb = axis ? L : 1;
    const int ntA = (nA + tc - 1) / tc;
    const int b = blockIdx.x / ntA;
    const int a0 = (blockIdx.x - b * ntA) * tc;
    const int ncell = min(tc, nA - a0);
    const long long n0 = (long long)b * sb + (long long)a0 * sa;

    int* const it_s = sm;
    int* const jt_s = it_s + tc;
    int* const jp_s = jt_s + tc;
    int* const je_s = jp_s + tc;
    float* const cm_s = reinterpret_cast<float*>(je_s + tc * 2 * F);
    float* const fmaj_s = cm_s + tc * 2 * F;
    float* const fmin_s = fmaj_s + tc * 8 * F;
    float* const sc_s = fmin_s + tc * 4 * F;
    float* const pl_s = sc_s + tc * nspec;
    float* const tl_s = pl_s + tc;
    float* const cg_s = tl_s + tc;
    int* const gf_s = reinterpret_cast<int*>(cg_s + tc * ngc);
    int* const qf_s = gf_s + 2 * G;
    int* const qm_s = qf_s + 2 * nq;
    int* const eoff_s = qm_s + nq;
    int* const ent_s = eoff_s + G + 1;
    int* const desc_s = ent_s + 4 * nent;

    stage(it_s, itropo01, 1, n0, sa, ncell);
    stage(jt_s, jtemp0, 1, n0, sa, ncell);
    stage(jp_s, jpress0, 1, n0, sa, ncell);
    stage(je_s, jeta0, 2 * F, n0, sa, ncell);
    stage(cm_s, col_mix, 2 * F, n0, sa, ncell);
    stage(fmaj_s, fmajor, 8 * F, n0, sa, ncell);
    stage(fmin_s, fminor, 4 * F, n0, sa, ncell);
    stage(pl_s, play, 1, n0, sa, ncell);
    stage(tl_s, tlay, 1, n0, sa, ncell);
    stage(cg_s, col_gas, ngc, n0, sa, ncell);
    for (int i = threadIdx.x; i < 2 * G; i += blockDim.x)
        cp_async4(gf_s + i, gflav + i);
    for (int i = threadIdx.x; i < nq; i += blockDim.x)
        cp_async4(qm_s + i, quad_minor + i);
    for (int i = threadIdx.x; i <= G; i += blockDim.x)
        cp_async4(eoff_s + i, ent_off + i);
    for (int i = threadIdx.x; i < 4 * nent; i += blockDim.x)
        cp_async4(ent_s + i, ent + i);
    for (int i = threadIdx.x; i < DESC * nspec; i += blockDim.x)
        cp_async4(desc_s + i, desc + i);
    // Flavor of each aligned quad of g-points in each atmosphere, or -1
    // where the quad is ragged, mixed or the vector path is off.
    for (int i = threadIdx.x; i < 2 * nq; i += blockDim.x) {
        const int atm = i / nq;
        const int g = (i - atm * nq) * 4;
        const int* gf = gflav + atm * G + g;
        int f = -1;
        if (vec && g + 3 < G && gf[1] == gf[0] && gf[2] == gf[0]
            && gf[3] == gf[0])
            f = gf[0];
        qf_s[i] = f;
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
                 ::: "memory");
    __syncthreads();

    // Each cell's scaling of each minor interval of its own atmosphere: a
    // lane takes a cell and its factors, a warp an interval (one
    // descriptor row read by the whole warp; no division in the loop).
    if (nspec > 0) {
        const int lane = threadIdx.x & 31;
        const int nwarp = blockDim.x >> 5;
        for (int k = lane; k < ncell; k += 32) {
            const float* cg = cg_s + k * ngc;
            const CellScale f = cell_scale(cg, pl_s[k], tl_s[k], t.h2o);
            const int it = it_s[k];
            for (int j = threadIdx.x >> 5; j < nspec; j += nwarp) {
                const int* d = desc_s + DESC * j;
                sc_s[k * nspec + j] = d[0] == it ? minor_scale(d, cg, f)
                                                 : 0.0f;
            }
        }
        __syncthreads();
    }

    for (int w = threadIdx.x; w < ncell * nq; w += blockDim.x) {
        const int k = w / nq;
        const int g = (w - k * nq) * 4;
        Cell x;
        x.it = it_s[k];
        x.jt = jt_s[k];
        x.jp = jp_s[k];
        x.je = je_s + k * 2 * F;
        x.cm = cm_s + k * 2 * F;
        x.fmaj = fmaj_s + k * 8 * F;
        x.fmin = fmin_s + k * 4 * F;
        x.sc = sc_s + k * nspec;
        const float* cg = cg_s + k * ngc;
        const long long row = (n0 + k * sa) * G + g;
        const int f4 = qf_s[x.it * nq + (g >> 2)];
        if (f4 >= 0) {
            float tau[4], second[4];
            major<4>(t, x, f4, g, tau, second);
            if (t.minor_vec && qm_s[g >> 2]) {
                add_minor4(t, x, eoff_s, ent_s, g, tau);
            } else {
                #pragma unroll
                for (int v = 0; v < 4; ++v)
                    tau[v] = add_minor(t, x, eoff_s, ent_s, g + v, tau[v]);
            }
            if (t.rayleigh) {
                // The Rayleigh column: h2o plus the dry column.
                const float fac = cg[t.h2o] + cg[0];
                #pragma unroll
                for (int v = 0; v < 4; ++v)
                    second[v] = second[v] * fac;
            }
            store<4>(out_a + row, tau);
            store<4>(out_b + row, second);
        } else {
            for (int v = 0; v < 4 && g + v < G; ++v) {
                float tau[1], second[1];
                major<1>(t, x, gf_s[x.it * G + g + v], g + v, tau, second);
                tau[0] = add_minor(t, x, eoff_s, ent_s, g + v, tau[0]);
                out_a[row + v] = tau[0];
                out_b[row + v] = t.rayleigh ? second[0] * (cg[t.h2o] + cg[0])
                                            : second[0];
            }
        }
    }
}

}  // namespace

// Shared-memory words of a block of tc cells (the wrapper's
// interp_geometry computes the same).
static long long smem_words(int tc, int G, int F, int nspec, int nent,
                            int ngc)
{
    const int nq = (G + 3) / 4;
    return (long long)tc * (5 + 16 * F + ngc + nspec) + 2LL * G + 3LL * nq
           + G + 1 + 4LL * nent + (long long)DESC * nspec;
}

// axis: 0 tiles cells along the first axis of the (C, L) inputs (n = c*L +
// l at fixed l), 1 along the second (consecutive n); tc cells a block,
// `threads` threads a block.  Table offsets must fit in 32 bits.  play,
// tlay (C, L) and col_gas (C, L, ngc) are the cells' inputs; desc holds
// nspec descriptor rows of DESC ints whose col_gas indices, and h2o, are
// below ngc.
extern "C" int rrtmgp_gas_optics_interp_f32(
    const float* tab_a, long long a_sr, long long a_se,
    const float* tab_b, long long b_sr, long long b_se, int b_rayleigh,
    const float* kmin_lo, int ncont_lo, const float* kmin_up, int ncont_up,
    const int* jtemp0, const int* jpress0, const int* itropo01,
    const int* jeta0, const float* col_mix, const float* fminor,
    const float* fmajor, const int* gflav, const float* play,
    const float* tlay, const float* col_gas, int ngc, int h2o,
    const int* desc, int nspec,
    const int* ent_off, const int* ent, int nent, const int* quad_minor,
    float* out_a, float* out_b, int C, int L, int G, int F, int ntemp,
    int neta,
    int axis, int tc, int threads, void* stream)
{
    if (tc <= 0 || threads <= 0 || threads > 1024 || threads % 32)
        return (int)cudaErrorInvalidConfiguration;
    const long long nA = axis ? L : C;
    const long long nB = axis ? C : L;
    const long long blocks = (nA + tc - 1) / tc * nB;
    const size_t smem = sizeof(int) * (size_t)smem_words(tc, G, F, nspec,
                                                         nent, ngc);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            gas_optics_interp_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    if (blocks > 0 && G > 0) {
        Tables t;
        t.a = tab_a;
        t.a_sr = (int)a_sr;
        t.a_se = (int)a_se;
        t.b = tab_b;
        t.b_sr = (int)b_sr;
        t.b_se = (int)b_se;
        t.rayleigh = b_rayleigh != 0;
        t.kmin_lo = kmin_lo;
        t.ncont_lo = ncont_lo;
        t.kmin_up = kmin_up;
        t.ncont_up = ncont_up;
        t.minor_vec = ((ncont_lo | ncont_up) & 3) == 0
            && (((uintptr_t)kmin_lo | (uintptr_t)kmin_up) & 15) == 0;
        t.ntemp = ntemp;
        t.neta = neta;
        t.F = F;
        t.h2o = h2o;
        const bool vec =
            (G & 3) == 0 && ((a_sr | a_se | b_sr | b_se) & 3) == 0
            && (((uintptr_t)tab_a | (uintptr_t)tab_b | (uintptr_t)out_a
                 | (uintptr_t)out_b) & 15) == 0;
        gas_optics_interp_kernel<<<(unsigned int)blocks, threads, smem,
                                   (cudaStream_t)stream>>>(
            t, jtemp0, jpress0, itropo01, jeta0, col_mix, fminor, fmajor,
            gflav, play, tlay, col_gas, ngc, desc, nspec, ent_off, ent, nent,
            quad_minor, out_a, out_b, C, L, G, axis, tc, vec);
    }
    return (int)cudaGetLastError();
}
