// K-table interpolation from precomputed per-g weight planes (float32).
//
// Replaces the TPU kernels rte_rrtmgp_tpu/ops/pallas/interp_kernel.py
// `interp_rows_multi` (body `_kernel_multi`) and its single-op entry
// `interp_rows_pallas`: the gas-optics pass of the steps that run with the
// in-kernel weight resolve off, and of the top-level gas_optics_lw/sw.
// Per cell n and g-point (or minor contributor) g of an op's table:
//
//   4 corners (kmajor, planck_frac; rows r = (i0p0, i0p1, i1p0, i1p1)):
//     for each temperature pair i: s_e = (1-fp)*T[r_i0, je_i+e] + fp*T[r_i1, je_i+e]
//                                  pair = fm[2i]*s_0 + fm[2i+1]*s_1  (* cm_i)
//   2 corners (krayl, minor; rows r = (i0, i1)):
//                                  pair = fm[2i]*T[r_i, je_i] + fm[2i+1]*T[r_i, je_i+1]  (* cm_i)
//   out = (0 + pair_0) + pair_1
//
// which is `_kernel_multi`'s order (the pressure pair merged before the eta
// contraction); the plain twin `gas_optics.interp_rows_plain` follows it.
//
// What bounds it on the H100: bytes.  The weight planes arrive from HBM:
// two eta-index planes, four fminor planes and, for tau, two col_mix
// planes, each (N, G); with the two output planes that is ten planes of
// 75.5 MB at 2048x72x128.  The tables are a few MB and stay in L2.  This is
// the price of the weight-plane design next to the per-cell weights of
// gas_optics_interp.cu, which reads no (N, G) input at all.
//
// Design: one thread per (cell, g) with g fastest, so a warp reads and
// writes 32 neighbouring addresses of every plane and of the g-contiguous
// tables (row-major (R, neta, G) with any row / eta stride: chunk views of
// the full tables are read in place).  No eta padding and no shape
// assumption: G (the contributor count CT for the minor pass) need not be
// a multiple of 32.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_OPS = 2;

struct RowsOp {
    const float* tab;        // (R, neta, G) with strides (sr, se, 1)
    long long sr, se;
    const int* rows;         // (N, nc) row indices
    int nc;                  // 4 (with fp) or 2
    const float* cm0;        // (N, G) col_mix planes, or null
    const float* cm1;
    float* out;              // (N, G)
};

struct RowsOps {
    RowsOp op[MAX_OPS];
    int n;
};

__global__ void interp_rows_kernel(
    RowsOps ops, const int* __restrict__ je0, const int* __restrict__ je1,
    const float* __restrict__ fm0, const float* __restrict__ fm1,
    const float* __restrict__ fm2, const float* __restrict__ fm3,
    const float* __restrict__ fp, long long N, int G)
{
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= N * G) return;
    const long long n = idx / G;
    const int g = (int)(idx - n * G);

    const int je[2] = {je0[idx], je1[idx]};
    const float w[4] = {fm0[idx], fm1[idx], fm2[idx], fm3[idx]};

    for (int k = 0; k < ops.n; ++k) {
        const RowsOp& op = ops.op[k];
        const int* r = op.rows + n * op.nc;
        float acc = 0.0f;
        if (op.nc == 4) {
            const float f = fp[n];
            const float omf = 1.0f - f;
            for (int i = 0; i < 2; ++i) {
                const float* a = op.tab + (long long)r[2 * i] * op.sr
                               + (long long)je[i] * op.se + g;
                const float* b = op.tab + (long long)r[2 * i + 1] * op.sr
                               + (long long)je[i] * op.se + g;
                const float s0 = omf * a[0] + f * b[0];
                const float s1 = omf * a[op.se] + f * b[op.se];
                float pair = w[2 * i] * s0 + w[2 * i + 1] * s1;
                if (op.cm0) pair = pair * (i ? op.cm1[idx] : op.cm0[idx]);
                acc = acc + pair;
            }
        } else {
            for (int i = 0; i < 2; ++i) {
                const float* a = op.tab + (long long)r[i] * op.sr
                               + (long long)je[i] * op.se + g;
                float pair = w[2 * i] * a[0] + w[2 * i + 1] * a[op.se];
                if (op.cm0) pair = pair * (i ? op.cm1[idx] : op.cm0[idx]);
                acc = acc + pair;
            }
        }
        op.out[idx] = acc;
    }
}

}  // namespace

// nops (1 or 2) ops share the weight planes je0/je1 (int32) and fm0..fm3,
// and the pressure fraction fp (N,) of the 4-corner ops.  Op k is
// (tab_k, sr_k, se_k, rows_k, nc_k, cm0_k, cm1_k, out_k).
extern "C" int rrtmgp_interp_rows_f32(
    int nops,
    const float* tab0, long long sr0, long long se0, const int* rows0,
    int nc0, const float* cm00, const float* cm01, float* out0,
    const float* tab1, long long sr1, long long se1, const int* rows1,
    int nc1, const float* cm10, const float* cm11, float* out1,
    const int* je0, const int* je1, const float* fm0, const float* fm1,
    const float* fm2, const float* fm3, const float* fp, long long N, int G,
    void* stream)
{
    if (nops < 1 || nops > MAX_OPS) return (int)cudaErrorInvalidValue;
    RowsOps ops;
    ops.n = nops;
    ops.op[0] = RowsOp{tab0, sr0, se0, rows0, nc0, cm00, cm01, out0};
    ops.op[1] = RowsOp{tab1, sr1, se1, rows1, nc1, cm10, cm11, out1};
    const long long total = N * G;
    if (total > 0) {
        const int threads = 256;
        const long long blocks = (total + threads - 1) / threads;
        interp_rows_kernel<<<(unsigned int)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
            ops, je0, je1, fm0, fm1, fm2, fm3, fp, N, G);
    }
    return (int)cudaGetLastError();
}
