// Band-local forward and posterior-backward wavefront kernels of the
// strawman 3-state signal machine (getStrawManStateMachine3), for Hopper
// (sm_90a).  Plain C entry points, loaded with ctypes by
// cpecan_tpu_torch/ops/cuda_build.py and wrapped by
// cpecan_tpu_torch/ops/fb_kernels.py (wavefront_fwd, wavefront_bwd).
//
// Replaces (TPU, Pallas):
//   sm3_fwd_kernel  <- cpecan_tpu/ops/pallas_fb.py _sm3_forward_kernel
//                      (:635, untiled, _StrawmanSpec)
//   sm3_bwd_kernel  <- cpecan_tpu/ops/pallas_fb.py _sm3_backward_kernel
//                      -> _sm3_backward_body_w (:857, :900; with_exp=False,
//                      untiled, _StrawmanSpec)
//
// Layout (identical to the JAX planes, index for index): G groups of R
// reads, one group window of W lanes per diagonal starting at x = win[g, d],
// lane l <-> cell (x = win[g, d] + l, y = d - x).
//   scal   f32 [NS + 3S] = [8 transitions, start(3), end(3), ragged_end(3)]
//   win    i32 [G, NDp]
//   xf     f32 [G*R, 9, X]      per-x model rows (emissions + gap-X table)
//   yf     f32 [G*R, 2, Y]      events, flipped: y <-> column C - y
//   basef, widthf, seedf, raggedf  f32 [G*R, NDp]
//   fwd    f32 [G, ND+1, 3, R, W]
//   posts  f32 [G, ND+1, R, W],  totals f32 [G*R]
//
// Design: one block per read (grid G*R), one thread per lane (W threads).
// Each diagonal depends on the previous one or two through lane shifts of
// the group window, so the carried diagonals live in shared memory (a ring
// of three [3, W] slots; one __syncthreads() per diagonal) and a shifted
// read is a shared-memory read at lane l + s, CPECAN_NEG outside [0, W).
//
// What bounds it on the H100: the sequential chain of ND diagonals, each a
// few dozen dependent flops plus one block barrier (latency, not bandwidth:
// a 64-read chunk launches only 64 blocks on 132 SMs), and the global
// writes of the fwd plane (3 x 4 bytes per cell; ~0.67 GB for the 256-read,
// 1700-diagonal bench batch), which the backward reads back once.  The
// design keeps every carry on chip, issues the plane writes coalesced over
// lanes and never waits for them; the backward's plane reads are coalesced
// and independent of the recurrence, so they overlap it.
#include <cuda_runtime.h>

#include "logspace.cuh"

namespace {

// strawman scalar order (pallas_fb.py T_MM..T_EY) and vector offsets
enum { T_MM, T_XM, T_YM, T_OX, T_EX, T_SX, T_OY, T_EY, NS };
constexpr int S = 3;
constexpr int NSCAL = NS + 3 * S;
constexpr int START = NS, END = NS + S, RAGGED_END = NS + 2 * S;
constexpr int NXF = 9;

__device__ __forceinline__ bool in_band(int x, float base, float width) {
    const float xl = static_cast<float>(x);
    return xl >= base && xl < base + width;
}

// v[state][l + s], CPECAN_NEG where l + s falls outside [0, W)
__device__ __forceinline__ float shifted(const float* v, int l, int s,
                                         int W) {
    const int j = l + s;
    return (j >= 0 && j < W) ? v[j] : CPECAN_NEG;
}

struct Emissions {
    float match, gap_y;
};

// _StrawmanSpec.emissions: Gaussian x Gaussian over (event mean, noise)
__device__ __forceinline__ Emissions emissions_at(const float* xb,
                                                  const float* yb, int X,
                                                  int Y, int x, int ycol) {
    const float mean = yb[ycol];
    const float noise = yb[Y + ycol];
    Emissions e;
    e.match = gauss(mean, xb[0 * X + x], xb[1 * X + x])
              + gauss(noise, xb[2 * X + x], xb[3 * X + x]);
    e.gap_y = gauss(mean, xb[4 * X + x], xb[5 * X + x])
              + gauss(noise, xb[6 * X + x], xb[7 * X + x]);
    return e;
}

__global__ void sm3_fwd_kernel(const float* __restrict__ scal,
                               const int* __restrict__ win,
                               const float* __restrict__ xf,
                               const float* __restrict__ yf,
                               const float* __restrict__ basef,
                               const float* __restrict__ widthf,
                               float* __restrict__ fwd, int R, int W, int ND,
                               int NDp, int X, int C, int Y) {
    extern __shared__ float ring[];  // [3 slots][S][W]: diagonal d in d % 3
    const int b = blockIdx.x;
    const int g = b / R;
    const int r = b - g * R;
    const int l = threadIdx.x;
    float t[NSCAL];
#pragma unroll
    for (int i = 0; i < NSCAL; ++i) t[i] = scal[i];
    const int* wg = win + static_cast<size_t>(g) * NDp;
    const float* xb = xf + static_cast<size_t>(b) * NXF * X;
    const float* yb = yf + static_cast<size_t>(b) * 2 * Y;
    const float* base = basef + static_cast<size_t>(b) * NDp;
    const float* width = widthf + static_cast<size_t>(b) * NDp;
    // fwd[g, d, i, r, l]
    const size_t plane_d = static_cast<size_t>(S) * R * W;
    float* out = fwd + static_cast<size_t>(g) * (ND + 1) * plane_d
                 + static_cast<size_t>(r) * W + l;

    // d = 0: the start vector inside the band; the slot of d = -1 is NEG
    const bool m0 = in_band(wg[0] + l, base[0], width[0]);
#pragma unroll
    for (int i = 0; i < S; ++i) {
        const float v = m0 ? t[START + i] : CPECAN_NEG;
        ring[(0 * S + i) * W + l] = v;
        ring[(2 * S + i) * W + l] = CPECAN_NEG;
        out[static_cast<size_t>(i) * R * W] = v;
    }
    __syncthreads();

    for (int d = 1; d <= ND; ++d) {
        const int w = wg[d];
        const int s1 = w - wg[d - 1];
        const int s2 = w - wg[d >= 2 ? d - 2 : 0];
        const float* p1 = ring + ((d + 2) % 3) * S * W;  // diagonal d - 1
        const float* p2 = ring + ((d + 1) % 3) * S * W;  // diagonal d - 2
        float* cur = ring + (d % 3) * S * W;
        const int x = w + l;
        // lower / middle sources at x - 1, upper at x
        const float p1m0 = shifted(p1, l, s1 - 1, W);
        const float p1m1 = shifted(p1 + W, l, s1 - 1, W);
        const float p1m2 = shifted(p1 + 2 * W, l, s1 - 1, W);
        const float p1a0 = shifted(p1, l, s1, W);
        const float p1a2 = shifted(p1 + 2 * W, l, s1, W);
        const float p2m0 = shifted(p2, l, s2 - 1, W);
        const float p2m1 = shifted(p2 + W, l, s2 - 1, W);
        const float p2m2 = shifted(p2 + 2 * W, l, s2 - 1, W);
        const Emissions e = emissions_at(xb, yb, X, Y, x, C - d + x);
        // _StrawmanSpec.fwd_update_w
        float nm = log_add3(p2m0 + t[T_MM], p2m1 + t[T_XM], p2m2 + t[T_YM])
                   + e.match;
        float nx = log_add3(p1m0 + t[T_OX], p1m1 + t[T_EX], p1m2 + t[T_SX])
                   + xb[8 * X + x];
        float ny = log_add(p1a0 + t[T_OY], p1a2 + t[T_EY]) + e.gap_y;
        if (!in_band(x, base[d], width[d])) {
            nm = nx = ny = CPECAN_NEG;
        }
        cur[l] = nm;
        cur[W + l] = nx;
        cur[2 * W + l] = ny;
        float* od = out + static_cast<size_t>(d) * plane_d;
        od[0] = nm;
        od[static_cast<size_t>(R) * W] = nx;
        od[static_cast<size_t>(2) * R * W] = ny;
        __syncthreads();
    }
}

// Block-wide reductions; every thread gets the result.  W is a multiple of
// 32, and the per-warp partials are combined in a fixed order.
__device__ float block_max(float v, float* red) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) red[warp] = v;
    __syncthreads();
    float m = red[0];
    for (int i = 1; i < static_cast<int>(blockDim.x >> 5); ++i)
        m = fmaxf(m, red[i]);
    __syncthreads();
    return m;
}

__device__ float block_sum(float v, float* red) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) red[warp] = v;
    __syncthreads();
    float s = red[0];
    for (int i = 1; i < static_cast<int>(blockDim.x >> 5); ++i) s += red[i];
    __syncthreads();
    return s;
}

__global__ void sm3_bwd_kernel(const float* __restrict__ scal,
                               const int* __restrict__ win,
                               const float* __restrict__ xf,
                               const float* __restrict__ yf,
                               const float* __restrict__ basef,
                               const float* __restrict__ widthf,
                               const float* __restrict__ seedf,
                               const float* __restrict__ raggedf,
                               const float* __restrict__ fwd,
                               float* __restrict__ posts,
                               float* __restrict__ totals, int R, int W,
                               int ND, int NDp, int X, int C, int Y) {
    // ring [3 slots][S][W]: bwd[d] in slot d % 3 (raw, at window w_d);
    // em [2 slots][W]: match emission of diagonal d + 1 at x = w_d + l in
    // slot d & 1; red [32]: reduction scratch
    extern __shared__ float smem[];
    float* ring = smem;
    float* em = smem + 3 * S * W;
    float* red = em + 2 * W;
    const int b = blockIdx.x;
    const int g = b / R;
    const int r = b - g * R;
    const int l = threadIdx.x;
    float t[NSCAL];
#pragma unroll
    for (int i = 0; i < NSCAL; ++i) t[i] = scal[i];
    const int* wg = win + static_cast<size_t>(g) * NDp;
    const float* xb = xf + static_cast<size_t>(b) * NXF * X;
    const float* yb = yf + static_cast<size_t>(b) * 2 * Y;
    const float* base = basef + static_cast<size_t>(b) * NDp;
    const float* width = widthf + static_cast<size_t>(b) * NDp;
    const float* seed = seedf + static_cast<size_t>(b) * NDp;
    const float* ragged = raggedf + static_cast<size_t>(b) * NDp;
    const size_t fplane_d = static_cast<size_t>(S) * R * W;
    const float* fin = fwd + static_cast<size_t>(g) * (ND + 1) * fplane_d
                       + static_cast<size_t>(r) * W + l;
    const size_t pplane_d = static_cast<size_t>(R) * W;
    float* pout = posts + static_cast<size_t>(g) * (ND + 1) * pplane_d
                  + static_cast<size_t>(r) * W + l;

    // diagonal 0 is never swept: zero it (the saturated-extraction
    // fallback reads the whole plane)
    pout[0] = 0.0f;
    // bwd[ND + 1] = bwd[ND + 2] = NEG; em carry = emissions(ND + 2) at the
    // window of ND + 1
#pragma unroll
    for (int i = 0; i < S; ++i) {
        ring[(((ND + 1) % 3) * S + i) * W + l] = CPECAN_NEG;
        ring[(((ND + 2) % 3) * S + i) * W + l] = CPECAN_NEG;
    }
    {
        const int x = wg[ND + 1] + l;
        em[((ND + 1) & 1) * W + l] =
            emissions_at(xb, yb, X, Y, x, C - (ND + 2) + x).match;
    }
    float total = CPECAN_NEG;
    bool cut_prev = false;  // the seed cut of diagonal d + 1
    __syncthreads();

    for (int d = ND; d >= 1; --d) {
        const int w = wg[d];
        const int o1 = w - wg[d + 1];
        const int o2 = w - wg[d + 2];
        const bool sa = seed[d] != 0.0f;   // block-uniform
        const bool ra = ragged[d] != 0.0f;
        // the seed diagonal cuts the carried bwd[d + 1], bwd[d + 2]; the
        // cut bwd[d + 1] is next step's bwd[d + 2]
        const bool cut1 = sa;
        const bool cut2 = sa || cut_prev;
        const float* n1 = ring + ((d + 1) % 3) * S * W;
        const float* n2 = ring + ((d + 2) % 3) * S * W;
        float* cur = ring + (d % 3) * S * W;
        const int x = w + l;
        // bwd[d+1] at x (n1a) and at x+1 (n1p); bwd[d+2] at x+1 (n2p)
        const float n1a2 = cut1 ? CPECAN_NEG : shifted(n1 + 2 * W, l, o1, W);
        const float n1p1 = cut1 ? CPECAN_NEG : shifted(n1 + W, l, o1 + 1, W);
        const float n2p0 = cut2 ? CPECAN_NEG : shifted(n2, l, o2 + 1, W);
        // emissions(d + 2) at x + 1, carried from the last step
        const float em2p = shifted(em + ((d + 1) & 1) * W, l, o1 + 1, W);
        // emissions(d + 1) at x, fresh (next step's carry)
        const Emissions e1 = emissions_at(xb, yb, X, Y, x, C - (d + 1) + x);
        // gap-X emission at x + 1; the last lane of the last window reads
        // past the x range, which lies outside every band
        const float e_gapx_p = xb[8 * X + min(x + 1, X - 1)];
        // _StrawmanSpec.bwd_update_w
        const float mid = em2p + n2p0;
        float bm = mid + t[T_MM];
        float bx = mid + t[T_XM];
        float by = mid + t[T_YM];
        const float up = e1.gap_y + n1a2;
        bm = log_add(bm, up + t[T_OY]);
        by = log_add(by, up + t[T_EY]);
        const float low = e_gapx_p + n1p1;
        bm = log_add(bm, low + t[T_OX]);
        bx = log_add(bx, low + t[T_EX]);
        by = log_add(by, low + t[T_SX]);
        const bool mask = in_band(x, base[d], width[d]);
        if (!mask) bm = bx = by = CPECAN_NEG;
        if (sa && mask) {
            const int v0 = ra ? RAGGED_END : END;
            bm = t[v0];
            bx = t[v0 + 1];
            by = t[v0 + 2];
        }
        const float* fd = fin + static_cast<size_t>(d) * fplane_d;
        const float f0 = fd[0];
        const float f1 = fd[static_cast<size_t>(R) * W];
        const float f2 = fd[static_cast<size_t>(2) * R * W];
        if (sa) {
            // total = masked log-sum-exp over the read's lanes
            // (pallas_fb.py _masked_lse) at its seed diagonal
            const float prod = log_add(log_add(f0 + bm, f1 + bx), f2 + by);
            const float vv = mask ? prod : CPECAN_NEG;
            const float m = block_max(vv, red);
            const float s = block_sum(mask ? expf(vv - m) : 0.0f, red);
            total = m + logf(fmaxf(s, 1e-37f));
        }
        const float xl = static_cast<float>(x);
        const bool ok = mask && xl > 0.0f && xl < static_cast<float>(d);
        const float z = f0 + bm - total;
        pout[static_cast<size_t>(d) * pplane_d] =
            ok ? expf(fminf(z, 0.69f)) : 0.0f;
        cur[l] = bm;
        cur[W + l] = bx;
        cur[2 * W + l] = by;
        em[(d & 1) * W + l] = e1.match;
        cut_prev = sa;
        __syncthreads();
    }
    if (l == 0) totals[b] = total;
}

int launch_config_error(int W) {
    // one thread per lane: W must fill whole warps and fit one block
    if (W <= 0 || W % 32 != 0 || W > 1024) return cudaErrorInvalidValue;
    return cudaSuccess;
}

}  // namespace

extern "C" {

const char* wavefront_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int wavefront_fwd(const void* scal, const void* win, const void* xf,
                  const void* yf, const void* basef, const void* widthf,
                  void* fwd, int G, int R, int W, int ND, int NDp, int X,
                  int C, int Y, void* stream) {
    if (int e = launch_config_error(W)) return e;
    const size_t smem = sizeof(float) * 3 * S * W;
    if (smem > 48 * 1024) {
        cudaFuncSetAttribute(sm3_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    }
    sm3_fwd_kernel<<<G * R, W, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(scal), static_cast<const int*>(win),
        static_cast<const float*>(xf), static_cast<const float*>(yf),
        static_cast<const float*>(basef), static_cast<const float*>(widthf),
        static_cast<float*>(fwd), R, W, ND, NDp, X, C, Y);
    return static_cast<int>(cudaGetLastError());
}

int wavefront_bwd(const void* scal, const void* win, const void* xf,
                  const void* yf, const void* basef, const void* widthf,
                  const void* seedf, const void* raggedf, const void* fwd,
                  void* posts, void* totals, int G, int R, int W, int ND,
                  int NDp, int X, int C, int Y, void* stream) {
    if (int e = launch_config_error(W)) return e;
    const size_t smem = sizeof(float) * ((3 * S + 2) * W + 32);
    if (smem > 48 * 1024) {
        cudaFuncSetAttribute(sm3_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    }
    sm3_bwd_kernel<<<G * R, W, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(scal), static_cast<const int*>(win),
        static_cast<const float*>(xf), static_cast<const float*>(yf),
        static_cast<const float*>(basef), static_cast<const float*>(widthf),
        static_cast<const float*>(seedf), static_cast<const float*>(raggedf),
        static_cast<const float*>(fwd), static_cast<float*>(posts),
        static_cast<float*>(totals), R, W, ND, NDp, X, C, Y);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
