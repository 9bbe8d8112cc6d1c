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
//
// Per (column, g-point): the Meador-Weaver gamma1-gamma4, k^2 floored at
// k_min, rdif/tdif, r_dir/t_dir with the eps guard on 1-(k*mu0)^2 and the
// Ukkonen clamp, the direct beam exp(-tau/mu0), the adding up-sweep of
// albedo and source from the surface and the diffuse down-sweep (reference
// rte_solver_kernels.cu:196-286, 543-655).  up, diffuse dn and dir are
// summed over g into (ncol, nlev); the caller adds the direct beam to dn.
//
// What bounds it on the H100: bytes.  tau, ssa and g (three plane-sized
// inputs, 75.5 MB each at 2048x72x128) are read once; the outputs are
// (ncol, nlev).  This first version also stages rdif, tdif and the two
// direct-beam sources per layer and albedo and source per level in a
// wrapper-allocated scratch (six planes written once and read once), since
// six nlay-deep arrays per thread do not fit in registers.
//
// Design: one block per column, one thread per g-point (whole warps;
// threads past G are masked and add zeros).  The scratch planes take the
// operands' layout, [col][layer][g] or [layer][col][g]; g is contiguous in
// both, so a warp's accesses are coalesced either way.  Level sums go
// through warp shuffles into shared memory (reduce.cuh).

#include <cuda_runtime.h>

#include "reduce.cuh"

namespace {

template <bool LM>
__global__ void sw_2stream_kernel(
    const float* __restrict__ tau, const float* __restrict__ ssa,
    const float* __restrict__ gasy, const float* __restrict__ mu0,
    const float* __restrict__ alb_dir, const float* __restrict__ alb_dif,
    const float* __restrict__ inc_dir, const float* __restrict__ inc_dif,
    float* __restrict__ up, float* __restrict__ dn, float* __restrict__ dir,
    float* __restrict__ scratch, int ncol, int nlay, int G, float kmin,
    float tmin)
{
    extern __shared__ float part[];
    const long long c = blockIdx.x;
    const int g = threadIdx.x;
    const bool active = g < G;
    const int nlev = nlay + 1;
    const int nwarp = blockDim.x >> 5;

    // Row l of the column: offset + l*ls in every plane.  Column-major
    // (c*nrow + l)*G: offset c*nrow*G, stride G; layer-major (l*ncol + c)*G:
    // offset c*G, stride ncol*G.
    const long long lay_plane = (long long)ncol * nlay * G;
    const long long lev_plane = (long long)ncol * nlev * G;
    const long long ls = LM ? (long long)ncol * G : G;
    const long long lay_off = (LM ? c : c * nlay) * G + g;
    const long long lev_off = (LM ? c : c * nlev) * G + g;
    float* rdif_s = scratch + lay_off;
    float* tdif_s = scratch + lay_plane + lay_off;
    float* sup_s = scratch + 2 * lay_plane + lay_off;
    float* sdn_s = scratch + 3 * lay_plane + lay_off;
    float* alb_s = scratch + 4 * lay_plane + lev_off;
    float* src_s = scratch + 4 * lay_plane + lev_plane + lev_off;

    const float m = mu0[c];
    float fdir = active ? inc_dir[c * G + g] * m : 0.0f;
    rrtmgp::level_partial(part, 2, nwarp, nlev, 0, fdir);

    // --- two-stream coefficients + direct-beam sources, top down ---
    for (int l = 0; l < nlay; ++l) {
        if (active) {
            const long long o = (long long)l * ls;
            const float t = tau[lay_off + o];
            const float w = ssa[lay_off + o];
            const float a = gasy[lay_off + o];
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
            const float rt_term = 1.0f / (k * (1.0f + exp_m2kt)
                                          + gamma1 * (1.0f - exp_m2kt));
            const float rdif = rt_term * gamma2 * (1.0f - exp_m2kt);
            const float tdif = rt_term * 2.0f * k * exp_mkt;
            const float t_noscat = expf(-t / m);

            const float k_mu = k * m;
            const float k_g3 = k * gamma3;
            const float k_g4 = k * gamma4;
            const float one_m = 1.0f - k_mu * k_mu;
            const float fact = (fabsf(one_m) > tmin) ? one_m : tmin;
            const float rt2 = w * rt_term / fact;
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

            rdif_s[o] = rdif;
            tdif_s[o] = tdif;
            sup_s[o] = r_dir * fdir;
            sdn_s[o] = t_dir * fdir;
            fdir = t_noscat * fdir;
        }
        rrtmgp::level_partial(part, 2, nwarp, nlev, l + 1, fdir);
    }

    // --- adding: albedo/source up-sweep from the surface ---
    if (active) {
        float alb = alb_dif[c * G + g];
        float src = fdir * alb_dir[c * G + g];
        alb_s[(long long)nlay * ls] = alb;
        src_s[(long long)nlay * ls] = src;
        for (int l = nlay - 1; l >= 0; --l) {
            const long long o = (long long)l * ls;
            const float rdif = rdif_s[o];
            const float tdif = tdif_s[o];
            const float denom = 1.0f / (1.0f - rdif * alb);
            src = sup_s[o] + tdif * denom * (src + alb * sdn_s[o]);
            alb = rdif + tdif * tdif * alb * denom;
            alb_s[o] = alb;
            src_s[o] = src;
        }
    }

    // --- diffuse down-sweep ---
    float d = 0.0f;
    float u = 0.0f;
    if (active) {
        d = inc_dif ? inc_dif[c * G + g] : 0.0f;
        u = d * alb_s[0] + src_s[0];
    }
    rrtmgp::level_partial(part, 0, nwarp, nlev, 0, u);
    rrtmgp::level_partial(part, 1, nwarp, nlev, 0, d);
    for (int l = 0; l < nlay; ++l) {
        if (active) {
            const long long o = (long long)l * ls;
            const float rdif = rdif_s[o];
            const float alb1 = alb_s[o + ls];
            const float src1 = src_s[o + ls];
            const float denom = 1.0f / (1.0f - rdif * alb1);
            d = (tdif_s[o] * d + rdif * src1 + sdn_s[o]) * denom;
            u = d * alb1 + src1;
        }
        rrtmgp::level_partial(part, 0, nwarp, nlev, l + 1, u);
        rrtmgp::level_partial(part, 1, nwarp, nlev, l + 1, d);
    }

    float* const out[3] = {up, dn, dir};
    rrtmgp::write_levels(part, 3, nwarp, nlev, c, out);
}

template <bool LM>
int launch(const float* tau, const float* ssa, const float* g,
           const float* mu0, const float* alb_dir, const float* alb_dif,
           const float* inc_dir, const float* inc_dif, float* up, float* dn,
           float* dir, float* scratch, int ncol, int nlay, int G, float kmin,
           float tmin, void* stream)
{
    size_t smem = 0;
    cudaError_t err = rrtmgp::partial_smem(sw_2stream_kernel<LM>, 3, G,
                                           nlay + 1, &smem);
    if (err != cudaSuccess) return (int)err;
    if (ncol > 0)
        sw_2stream_kernel<LM><<<ncol, rrtmgp::block_threads(G), smem,
                                (cudaStream_t)stream>>>(
            tau, ssa, g, mu0, alb_dir, alb_dif, inc_dir, inc_dif, up, dn,
            dir, scratch, ncol, nlay, G, kmin, tmin);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rrtmgp_sw_2stream_f32(
    const float* tau, const float* ssa, const float* g, const float* mu0,
    const float* alb_dir, const float* alb_dif, const float* inc_dir,
    const float* inc_dif, float* up, float* dn, float* dir, float* scratch,
    int ncol, int nlay, int G, float kmin, float tmin, void* stream)
{
    return launch<false>(tau, ssa, g, mu0, alb_dir, alb_dif, inc_dir,
                         inc_dif, up, dn, dir, scratch, ncol, nlay, G, kmin,
                         tmin, stream);
}

extern "C" int rrtmgp_sw_2stream_lm_f32(
    const float* tau, const float* ssa, const float* g, const float* mu0,
    const float* alb_dir, const float* alb_dif, const float* inc_dir,
    const float* inc_dif, float* up, float* dn, float* dir, float* scratch,
    int ncol, int nlay, int G, float kmin, float tmin, void* stream)
{
    return launch<true>(tau, ssa, g, mu0, alb_dir, alb_dif, inc_dir,
                        inc_dif, up, dn, dir, scratch, ncol, nlay, G, kmin,
                        tmin, stream);
}
