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
//           2 temperature x 2 eta corners on krayl_rows           (SW).
//
// What bounds it on the H100: bytes.  Each thread writes two floats and
// reads 8-16 table values plus a few per-cell weights; the two (N, G)
// output planes (75.5 MB each at 2048x72x128) dominate the traffic, the
// tables are a few MB per chunk and stay in the 50 MB L2.
//
// Design: one thread per (cell, g) output with g fastest, so a warp reads
// and writes 32 neighbouring addresses of the g-contiguous row tables and
// output planes, and broadcasts the per-cell indices and weights.  The
// minor intervals are read through a per-g entry list (interval, atmosphere,
// contributor column, flavor) built once per chunk on the host; a cell only
// visits the entries of its own atmosphere (the other's scaling is exactly
// zero).  Entries are visited lower then upper, in interval order, which is
// the addition order of the plain PyTorch twin.  No shape assumption: G
// need not be a multiple of 32 (the last SW chunk has G = 96).

#include <cuda_runtime.h>

namespace {

__global__ void gas_optics_interp_kernel(
    const float* __restrict__ tab_a, long long a_sr, long long a_se,
    const float* __restrict__ tab_b, long long b_sr, long long b_se,
    int b_rayleigh,
    const float* __restrict__ kmin_lo, int ncont_lo,
    const float* __restrict__ kmin_up, int ncont_up,
    const int* __restrict__ jtemp0, const int* __restrict__ jpress0,
    const int* __restrict__ itropo01, const int* __restrict__ jeta0,
    const float* __restrict__ col_mix, const float* __restrict__ fminor,
    const float* __restrict__ fmajor, const int* __restrict__ gflav,
    const float* __restrict__ sc, int nspec,
    const int* __restrict__ ent_off, const int* __restrict__ ent,
    float* __restrict__ out_a, float* __restrict__ out_b,
    long long N, int G, int F, int ntemp, int neta)
{
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= N * G) return;
    const long long n = idx / G;
    const int g = (int)(idx - n * G);

    const int it = itropo01[n];
    const int jt = jtemp0[n];
    const int jp = jpress0[n];
    const int f = gflav[it * G + g];
    const int* je_n = jeta0 + n * 2 * F;
    const float* fmaj = fmajor + n * 8 * F;
    const float* fmin = fminor + n * 4 * F;
    const float* cm = col_mix + n * 2 * F;

    float tau = 0.0f;
    float second = 0.0f;
    for (int i = 0; i < 2; ++i) {
        const int je = je_n[i * F + f];
        float acc_a = 0.0f;
        float acc_b = 0.0f;
        for (int dp = 0; dp < 2; ++dp) {
            const long long row = (long long)(jp + it + dp) * ntemp + jt + i;
            const float w0 = fmaj[(i * 4 + dp * 2) * F + f];
            const float w1 = fmaj[(i * 4 + dp * 2 + 1) * F + f];
            const float* a = tab_a + row * a_sr + (long long)je * a_se + g;
            acc_a = acc_a + (w0 * a[0] + w1 * a[a_se]);
            if (!b_rayleigh) {
                const float* b = tab_b + row * b_sr + (long long)je * b_se + g;
                acc_b = acc_b + (w0 * b[0] + w1 * b[b_se]);
            }
        }
        tau = tau + cm[i * F + f] * acc_a;
        if (b_rayleigh) {
            const long long row = (long long)it * ntemp + jt + i;
            const float v0 = fmin[(i * 2) * F + f];
            const float v1 = fmin[(i * 2 + 1) * F + f];
            const float* b = tab_b + row * b_sr + (long long)je * b_se + g;
            second = second + (v0 * b[0] + v1 * b[b_se]);
        } else {
            second = second + acc_b;
        }
    }

    // Minor intervals covering g: ltau from 2 temperature x 2 eta corners of
    // the (ntemp, neta, ncontrib) table, times the interval's scaling.
    for (int e = ent_off[g]; e < ent_off[g + 1]; ++e) {
        const int k = ent[4 * e];
        const int atm = ent[4 * e + 1];
        if (atm != it) continue;
        const int col = ent[4 * e + 2];
        const int mf = ent[4 * e + 3];
        const float* km = atm ? kmin_up : kmin_lo;
        const long long nc = atm ? ncont_up : ncont_lo;
        const int je0 = je_n[mf];
        const int je1 = je_n[F + mf];
        const float k00 = km[((long long)jt * neta + je0) * nc + col];
        const float k01 = km[((long long)jt * neta + je0 + 1) * nc + col];
        const float k10 = km[((long long)(jt + 1) * neta + je1) * nc + col];
        const float k11 = km[((long long)(jt + 1) * neta + je1 + 1) * nc + col];
        const float ltau = (fmin[mf] * k00 + fmin[F + mf] * k01)
                         + (fmin[2 * F + mf] * k10 + fmin[3 * F + mf] * k11);
        tau = tau + ltau * sc[n * nspec + k];
    }

    out_a[idx] = tau;
    out_b[idx] = second;
}

}  // namespace

extern "C" int rrtmgp_gas_optics_interp_f32(
    const float* tab_a, long long a_sr, long long a_se,
    const float* tab_b, long long b_sr, long long b_se, int b_rayleigh,
    const float* kmin_lo, int ncont_lo, const float* kmin_up, int ncont_up,
    const int* jtemp0, const int* jpress0, const int* itropo01,
    const int* jeta0, const float* col_mix, const float* fminor,
    const float* fmajor, const int* gflav, const float* sc, int nspec,
    const int* ent_off, const int* ent, float* out_a, float* out_b,
    long long N, int G, int F, int ntemp, int neta, void* stream)
{
    const long long total = N * G;
    if (total > 0) {
        const int threads = 256;
        const long long blocks = (total + threads - 1) / threads;
        gas_optics_interp_kernel<<<(unsigned int)blocks, threads, 0,
                                   (cudaStream_t)stream>>>(
            tab_a, a_sr, a_se, tab_b, b_sr, b_se, b_rayleigh,
            kmin_lo, ncont_lo, kmin_up, ncont_up,
            jtemp0, jpress0, itropo01, jeta0, col_mix, fminor, fmajor,
            gflav, sc, nspec, ent_off, ent, out_a, out_b, N, G, F, ntemp,
            neta);
    }
    return (int)cudaGetLastError();
}
