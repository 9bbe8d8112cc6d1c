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
// What bounds it on the H100: bytes.  tau, lay_src and lev_src (three
// plane-sized inputs, 75.5 MB each at 2048x72x128) are read once per angle
// at the least; the outputs are (ncol, nlev).
//
// Design: one block per column, one thread per g-point (whole warps;
// threads past G are masked and add zeros).  Both layouts keep g
// contiguous, so a warp's reads of one layer are 32 neighbouring floats
// either way; the layout only changes the layer stride (G or ncol*G).  The
// down sweep keeps the radiance in a register; the up sweep recomputes
// trans and the source factor from tau rather than staging them
// (re-reading three planes costs fewer bytes than writing and reading two
// staged ones).  The sum over g at each level goes through warp shuffles
// into shared memory, with no block barrier inside the sweep (reduce.cuh).

#include <cuda_runtime.h>

#include "reduce.cuh"

namespace {

struct LwLayer {
    float trans, src;
};

// trans and the directional source of layer l for the sweep whose boundary
// level is `lev` (the level below the layer going down, above going up).
__device__ __forceinline__ LwLayer lw_layer(float tau, float lay, float lev,
                                            float D, float tau_thres)
{
    const float t = tau * D;
    const float trans = expf(-t);
    float fact;
    if (t > tau_thres) {
        const float safe = (t == 0.0f) ? 1.0f : t;
        fact = (1.0f - trans) / safe - trans;
    } else {
        fact = t * (0.5f + t * ((float)(-1.0 / 3.0) + t * (float)(1.0 / 8.0)));
    }
    LwLayer r;
    r.trans = trans;
    r.src = (1.0f - trans) * lev + 2.0f * fact * (lay - lev);
    return r;
}

// Element offsets of a column's layer l and level l in either layout.
// Column-major: (ncol, nlay, G) layers and one (ncol, nlev, G) level plane.
// Layer-major: (nlay*ncol, G) layers; levels from the three pieces
// lev0 (ncol, G), inner ((nlay-1)*ncol, G) and last (ncol, G).
template <bool LM>
struct LwPlanes {
    const float* lev0;    // column-major: the whole level plane
    const float* inner;   // layer-major only
    const float* last;    // layer-major only
    long long c;
    int ncol, nlay, G, g;

    __device__ __forceinline__ long long lay_at(int l) const
    {
        return (LM ? ((long long)l * ncol + c) : (c * nlay + l)) * G + g;
    }
    __device__ __forceinline__ float lev(int l) const
    {
        if (!LM) return lev0[(c * (nlay + 1) + l) * G + g];
        if (l == 0) return lev0[c * G + g];
        if (l == nlay) return last[c * G + g];
        return inner[((long long)(l - 1) * ncol + c) * G + g];
    }
};

template <bool LM>
__global__ void lw_sweep_kernel(
    const float* __restrict__ tau, const float* __restrict__ lay_src,
    const float* __restrict__ lev0, const float* __restrict__ lev_inner,
    const float* __restrict__ lev_last, const float* __restrict__ sfc_emis,
    const float* __restrict__ sfc_src, const float* __restrict__ sfc_src_jac,
    const float* __restrict__ inc_flux, float* __restrict__ up,
    float* __restrict__ dn, float* __restrict__ jac, int ncol, int nlay,
    int G, float D, float two_pi_w, float scale, float tau_thres)
{
    extern __shared__ float part[];
    const long long c = blockIdx.x;
    const int g = threadIdx.x;
    const bool active = g < G;
    const int nlev = nlay + 1;
    const int nwarp = blockDim.x >> 5;
    const LwPlanes<LM> p{lev0, lev_inner, lev_last, c, ncol, nlay, G, g};

    // --- downward sweep ---
    float rad = active ? inc_flux[c * G + g] / two_pi_w : 0.0f;
    rrtmgp::level_partial(part, 1, nwarp, nlev, 0, scale * rad);
    for (int l = 0; l < nlay; ++l) {
        if (active) {
            const long long o = p.lay_at(l);
            const LwLayer s = lw_layer(tau[o], lay_src[o], p.lev(l + 1), D,
                                       tau_thres);
            rad = s.trans * rad + s.src;
        }
        rrtmgp::level_partial(part, 1, nwarp, nlev, l + 1, scale * rad);
    }

    // --- surface reflection + emission ---
    float u = 0.0f, j = 0.0f;
    if (active) {
        const float emis = sfc_emis[c * G + g];
        u = rad * (1.0f - emis) + emis * sfc_src[c * G + g];
        j = emis * sfc_src_jac[c * G + g];
    }
    rrtmgp::level_partial(part, 0, nwarp, nlev, nlay, scale * u);
    rrtmgp::level_partial(part, 2, nwarp, nlev, nlay, scale * j);

    // --- upward sweep with the Jacobian ---
    for (int l = nlay - 1; l >= 0; --l) {
        if (active) {
            const long long o = p.lay_at(l);
            const LwLayer s = lw_layer(tau[o], lay_src[o], p.lev(l), D,
                                       tau_thres);
            u = s.trans * u + s.src;
            j = s.trans * j;
        }
        rrtmgp::level_partial(part, 0, nwarp, nlev, l, scale * u);
        rrtmgp::level_partial(part, 2, nwarp, nlev, l, scale * j);
    }

    float* const out[3] = {up, dn, jac};
    rrtmgp::write_levels(part, 3, nwarp, nlev, c, out);
}

template <bool LM>
int launch(const float* tau, const float* lay_src, const float* lev0,
           const float* lev_inner, const float* lev_last,
           const float* sfc_emis, const float* sfc_src,
           const float* sfc_src_jac, const float* inc_flux, float* up,
           float* dn, float* jac, int ncol, int nlay, int G, float D,
           float two_pi_w, float scale, float tau_thres, void* stream)
{
    size_t smem = 0;
    cudaError_t err = rrtmgp::partial_smem(lw_sweep_kernel<LM>, 3, G,
                                           nlay + 1, &smem);
    if (err != cudaSuccess) return (int)err;
    if (ncol > 0)
        lw_sweep_kernel<LM><<<ncol, rrtmgp::block_threads(G), smem,
                              (cudaStream_t)stream>>>(
            tau, lay_src, lev0, lev_inner, lev_last, sfc_emis, sfc_src,
            sfc_src_jac, inc_flux, up, dn, jac, ncol, nlay, G, D, two_pi_w,
            scale, tau_thres);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rrtmgp_lw_sweep_f32(
    const float* tau, const float* lay_src, const float* lev_src,
    const float* sfc_emis, const float* sfc_src, const float* sfc_src_jac,
    const float* inc_flux, float* up, float* dn, float* jac, int ncol,
    int nlay, int G, float D, float two_pi_w, float scale, float tau_thres,
    void* stream)
{
    return launch<false>(tau, lay_src, lev_src, nullptr, nullptr, sfc_emis,
                         sfc_src, sfc_src_jac, inc_flux, up, dn, jac, ncol,
                         nlay, G, D, two_pi_w, scale, tau_thres, stream);
}

extern "C" int rrtmgp_lw_sweep_lm_f32(
    const float* tau, const float* lay_src, const float* lev0,
    const float* lev_inner, const float* lev_last, const float* sfc_emis,
    const float* sfc_src, const float* sfc_src_jac, const float* inc_flux,
    float* up, float* dn, float* jac, int ncol, int nlay, int G, float D,
    float two_pi_w, float scale, float tau_thres, void* stream)
{
    return launch<true>(tau, lay_src, lev0, lev_inner, lev_last, sfc_emis,
                        sfc_src, sfc_src_jac, inc_flux, up, dn, jac, ncol,
                        nlay, G, D, two_pi_w, scale, tau_thres, stream);
}
