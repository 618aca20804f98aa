// Band-local forward and posterior-backward wavefront kernels of the
// strawman 3-state signal machine (getStrawManStateMachine3), for Hopper
// (sm_90a).  Plain C entry points, loaded with ctypes by
// cpecan_tpu_torch/ops/cuda_build.py and wrapped by
// cpecan_tpu_torch/ops/fb_kernels.py (wavefront_fwd, wavefront_bwd,
// wavefront_bwd_exp, wavefront_fwd_tiled, wavefront_bwd_tiled).
//
// Replaces (TPU, Pallas):
//   sm3_fwd_kernel<false>  <- cpecan_tpu/ops/pallas_fb.py _sm3_forward_kernel
//                             (:635, untiled, _StrawmanSpec)          K1
//   sm3_bwd_kernel<false, false>
//                          <- cpecan_tpu/ops/pallas_fb.py _sm3_backward_kernel
//                             -> _sm3_backward_body_w (:857, :900;
//                             with_exp=False, untiled, _StrawmanSpec) K2
//   sm3_bwd_kernel<true, false>
//                          <- the same body with with_exp=True (EM
//                             expectations: accumulate_exp :1072 and
//                             _StrawmanSpec.exp_probs_w :215)          K3
//   sm3_fwd_kernel<true>   <- _sm3_forward_kernel(tile=...) (:2304), chained
//                             over the tiles by _run_tiled (:2447) with
//                             _tile_steps.recenter (:2381)            K6a
//   sm3_bwd_kernel<false, true>
//                          <- _sm3_backward_kernel(tile=...) (:2332), the
//                             shifts repaid as shf (:947, :1170, :1193) K6b
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
//   trans  f32 [G*R, 9]  (lanes frm*3 + to),  gapx f32 [G*R, X]  (EM only)
//   shifts f32 [G*R, NT]  (tiled only; NT = ND / TD)
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
//
// The EM expectations (sm3_bwd_kernel<true>) add, per step, the posterior
// transition mass into one target diagonal t from sources on t-1 and t-2.
// The JAX kernel adds target d+2 at step d, which needs fwd[d] shifted in
// the same step it is fetched; here target t = d+3 is added at step d
// instead, from fwd[d+1] and fwd[d+2], which sit in a shared-memory ring of
// three [3, W] slots written one and two barriers ago, so the step keeps a
// single barrier.  The lag is invisible in the result: a target above a
// read's seed diagonal n lies outside its band (width 0), and below it the
// total was already set at step n.  Targets 3, 2 and 1 follow the loop.
// The tiled long-alignment pair (K6a, K6b) sweeps the same recurrences over
// ND = NT * TD diagonals in ONE launch each.  On the TPU a tile keeps VMEM
// O(tile) and lets XLA re-center the carries between calls; here the
// carried diagonals already live in shared memory at any length, so a tile
// is only a boundary where the carries re-center, which is what keeps f32
// posteriors usable past ~16k diagonals:
//  - K6a, before diagonal t*TD + 1 (t >= 1): the block's max m over its two
//    carried diagonals (all states and lanes); if m > -1e20 both ring slots
//    lose m and the running shift A gains it; A after tile t's boundary is
//    shifts[b, t] (0 for t = 0), the shift every row of tile t carries.
//  - K6b, at the top t*TD + TD of every tile below the first: the same on
//    the carried bwd[d+1] and bwd[d+2] (the latter as cut at d+1, since the
//    ring holds it raw) into B; the tile's rows repay shf = shifts[b, t] + B:
//    total = lse + shf at the seed diagonal, z = f + b - total + shf.
// A tiled launch is bound like K1/K2 (the diagonal chain), plus one block
// max and two barriers per tile.
// Where trouble lies, and what the kernel does about it:
//  1. The seed cut: the target backward bwd[t] is the carry after the cuts
//     at t-1 and t-2, applied on read (cut = sa(t-1) || sa(t-2)), as K2
//     applies its cuts.
//  2. total is updated at a step before that step's expectations.
//  3. NEG arithmetic: before a read's seed diagonal total is NEG, so
//     logp - total can be 0 and p 1; the cap min(logp - total, 10) keeps p
//     finite and the multiply by the target's band mask zeroes it.
//  4. A trained machine has a finite gap_switch_to_x (Y -> X); nothing
//     here assumes it is NEG.
//  5. Windows at the top: win is read up to ND + 2 (NDp >= ND + 3).
//  6. No fallback: the build keeps --fmad=false and no fast math, and a
//     failed build or launch raises in the wrapper.
// The 9 transition sums are per-thread registers across the sweep, reduced
// once at the end (block_sum, fixed order).  The gap-X mass goes to the
// read's own row of gapx in global memory, column w_t + l; each column is
// touched by one thread per target and the per-diagonal barrier orders the
// read-modify-writes, so no atomics are needed.
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

// Re-centering of two carried diagonals a, b ([S][W] shared-memory slots;
// b reads as CPECAN_NEG where ``cut_b``): m = the block max over both; if
// m > -1e20 both lose m in this thread's lane and ``shift`` gains it
// (_tile_steps.recenter).  Ends with a barrier, so the shifted slots are
// visible to the next step's shifted reads.
__device__ __forceinline__ void recenter(float* a, float* b, bool cut_b,
                                         int l, int W, float* red,
                                         float& shift) {
    float v = a[l];
#pragma unroll
    for (int i = 0; i < S; ++i) {
        v = fmaxf(v, a[i * W + l]);
        v = fmaxf(v, cut_b ? CPECAN_NEG : b[i * W + l]);
    }
    const float m = block_max(v, red);
    if (m > -1e20f) {
#pragma unroll
        for (int i = 0; i < S; ++i) {
            a[i * W + l] -= m;
            b[i * W + l] -= m;
        }
        shift += m;
    }
    __syncthreads();
}

template <bool TILED>
__global__ void sm3_fwd_kernel(const float* __restrict__ scal,
                               const int* __restrict__ win,
                               const float* __restrict__ xf,
                               const float* __restrict__ yf,
                               const float* __restrict__ basef,
                               const float* __restrict__ widthf,
                               float* __restrict__ fwd,
                               float* __restrict__ shifts, int R, int W,
                               int ND, int NDp, int X, int C, int Y, int TD) {
    // ring [3 slots][S][W]: diagonal d in d % 3; red [32]: reduction
    // scratch (tiled only)
    extern __shared__ float ring[];
    float* red = ring + 3 * S * W;
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
    float shift = 0.0f;   // A, the running re-centering shift (tiled)
    const int NT = TILED ? ND / TD : 0;
    if (TILED && l == 0) shifts[static_cast<size_t>(b) * NT] = 0.0f;
    __syncthreads();

    for (int d = 1; d <= ND; ++d) {
        if constexpr (TILED) {
            if (d > 1 && (d - 1) % TD == 0) {
                // diagonals d - 1 and d - 2 in slots (d + 2) % 3, (d + 1) % 3
                recenter(ring + ((d + 2) % 3) * S * W,
                         ring + ((d + 1) % 3) * S * W, false, l, W, red,
                         shift);
                if (l == 0)
                    shifts[static_cast<size_t>(b) * NT + (d - 1) / TD] =
                        shift;
            }
        }
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

// transition lanes (frm * 3 + to); lane 5 (X -> Y) stays 0
enum { L_MM = 0, L_OX = 1, L_OY = 2, L_XM = 3, L_EX = 4, L_YM = 6, L_SX = 7,
       L_EY = 8, NTRANS = 9 };

__device__ __forceinline__ float exp_prob(float logp, float total) {
    return expf(fminf(logp - total, 10.0f));
}

// Posterior transition mass into target diagonal tt at x = wt + l
// (_StrawmanSpec.exp_probs_w + accumulate_exp): sources fm = fwd[tt - 2]
// at window wm (nullptr for target 1: no middle source) and fl =
// fwd[tt - 1] at window wl, both shared-memory slots [S][W]; b0..b2 the
// target's backward at lane l, already cut.  With ``carried`` the JAX
// kernel takes the target's emissions from last step's carry at window wl,
// so lanes past that window read NEG there, and here.
__device__ __forceinline__ void exp_target(
        const float* t, const float* xb, const float* yb, int X, int Y,
        int C, int tt, int wt, const float* fm, int wm, const float* fl,
        int wl, float b0, float b1, float b2, float total, bool m,
        bool carried, int l, int W, float* acc, float* gap_row) {
    const int x = wt + l;
    Emissions e = emissions_at(xb, yb, X, Y, x, C - tt + x);
    if (carried) {
        const int j = l + (wt - wl);
        if (j < 0 || j >= W) e.match = e.gap_y = CPECAN_NEG;
    }
    const int sm = wt - wm - 1;
    const int s1 = wt - wl;
    const float f0m0 = fm ? shifted(fm, l, sm, W) : CPECAN_NEG;
    const float f0m1 = fm ? shifted(fm + W, l, sm, W) : CPECAN_NEG;
    const float f0m2 = fm ? shifted(fm + 2 * W, l, sm, W) : CPECAN_NEG;
    const float f1m0 = shifted(fl, l, s1 - 1, W);
    const float f1m1 = shifted(fl + W, l, s1 - 1, W);
    const float f1m2 = shifted(fl + 2 * W, l, s1 - 1, W);
    const float f1a0 = shifted(fl, l, s1, W);
    const float f1a2 = shifted(fl + 2 * W, l, s1, W);
    // middle: (tt-2, x-1) -> M; lower: (tt-1, x-1) -> X; upper: (tt-1, x)
    // -> Y
    const float mid = e.match + b0;
    const float low = xb[8 * X + x] + b1;
    const float up = e.gap_y + b2;
    float p[NTRANS];
    p[L_MM] = exp_prob(f0m0 + t[T_MM] + mid, total);
    p[L_XM] = exp_prob(f0m1 + t[T_XM] + mid, total);
    p[L_YM] = exp_prob(f0m2 + t[T_YM] + mid, total);
    p[L_OX] = exp_prob(f1m0 + t[T_OX] + low, total);
    p[L_EX] = exp_prob(f1m1 + t[T_EX] + low, total);
    p[L_SX] = exp_prob(f1m2 + t[T_SX] + low, total);
    p[L_OY] = exp_prob(f1a0 + t[T_OY] + up, total);
    p[L_EY] = exp_prob(f1a2 + t[T_EY] + up, total);
    p[5] = 0.0f;
    const float mf = m ? 1.0f : 0.0f;
#pragma unroll
    for (int k = 0; k < NTRANS; ++k) acc[k] += p[k] * mf;
    gap_row[x] += (p[L_OX] + p[L_EX] + p[L_SX]) * mf;
}

template <bool WITH_EXP, bool TILED>
__global__ void sm3_bwd_kernel(const float* __restrict__ scal,
                               const int* __restrict__ win,
                               const float* __restrict__ xf,
                               const float* __restrict__ yf,
                               const float* __restrict__ basef,
                               const float* __restrict__ widthf,
                               const float* __restrict__ seedf,
                               const float* __restrict__ raggedf,
                               const float* __restrict__ fwd,
                               const float* __restrict__ shifts,
                               float* __restrict__ posts,
                               float* __restrict__ totals,
                               float* __restrict__ trans,
                               float* __restrict__ gapx, int R, int W,
                               int ND, int NDp, int X, int C, int Y,
                               int TD) {
    static_assert(!(WITH_EXP && TILED), "the tiled path has no EM sums");
    // ring [3 slots][S][W]: bwd[d] in slot d % 3 (raw, at window w_d);
    // em [2 slots][W]: match emission of diagonal d + 1 at x = w_d + l in
    // slot d & 1; red [32]: reduction scratch; with the expectations,
    // fsh [3 slots][S][W]: fwd[d] in slot d % 3
    extern __shared__ float smem[];
    float* ring = smem;
    float* em = smem + 3 * S * W;
    float* red = em + 2 * W;
    float* fsh = red + 32;
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
    float shift = 0.0f;     // B, the running re-centering shift (tiled)
    float shf = 0.0f;       // A_t + B, repaid by the rows of tile t
    const int NT = TILED ? ND / TD : 0;
    float acc[NTRANS];      // per-lane transition sums (expectations)
    float* gap_row = nullptr;
    if constexpr (WITH_EXP) {
#pragma unroll
        for (int k = 0; k < NTRANS; ++k) acc[k] = 0.0f;
        gap_row = gapx + static_cast<size_t>(b) * X;
        for (int c = l; c < X; c += W) gap_row[c] = 0.0f;
        // fwd[ND + 1] = NEG: the lower/upper source of target ND + 2
#pragma unroll
        for (int i = 0; i < S; ++i)
            fsh[(((ND + 1) % 3) * S + i) * W + l] = CPECAN_NEG;
    }
    __syncthreads();

    for (int d = ND; d >= 1; --d) {
        if constexpr (TILED) {
            if (d % TD == 0) {
                // the top of tile d / TD - 1; below the first tile the
                // carried bwd[d + 1] and bwd[d + 2] (cut at d + 1) re-center
                if (d < ND)
                    recenter(ring + ((d + 1) % 3) * S * W,
                             ring + ((d + 2) % 3) * S * W, cut_prev, l, W,
                             red, shift);
                shf = shifts[static_cast<size_t>(b) * NT + d / TD - 1] + shift;
            }
        }
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
            if constexpr (TILED) total = total + shf;
        }
        const float xl = static_cast<float>(x);
        const bool ok = mask && xl > 0.0f && xl < static_cast<float>(d);
        float z = f0 + bm - total;
        if constexpr (TILED) z = z + shf;
        pout[static_cast<size_t>(d) * pplane_d] =
            ok ? expf(fminf(z, 0.69f)) : 0.0f;
        if constexpr (WITH_EXP) {
            // target tt = d + 3 from fwd[d + 1] and fwd[d + 2]; its
            // backward bwd[tt] is this lane's entry of the slot that
            // bwd[d] overwrites below (no other thread reads that slot in
            // this step)
            const int tt = d + 3;
            if (tt <= ND + 2) {
                const bool cut = seed[tt - 1] != 0.0f || seed[tt - 2] != 0.0f;
                const int wt = wg[tt];
                exp_target(t, xb, yb, X, Y, C, tt, wt,
                           fsh + ((tt - 2) % 3) * S * W, wg[tt - 2],
                           fsh + ((tt - 1) % 3) * S * W, wg[tt - 1],
                           cut ? CPECAN_NEG : cur[l],
                           cut ? CPECAN_NEG : cur[W + l],
                           cut ? CPECAN_NEG : cur[2 * W + l], total,
                           in_band(wt + l, base[tt], width[tt]), true, l, W,
                           acc, gap_row);
            }
            float* fs = fsh + (d % 3) * S * W;
            fs[l] = f0;
            fs[W + l] = f1;
            fs[2 * W + l] = f2;
        }
        cur[l] = bm;
        cur[W + l] = bx;
        cur[2 * W + l] = by;
        em[(d & 1) * W + l] = e1.match;
        cut_prev = sa;
        __syncthreads();
    }
    if (l == 0) totals[b] = total;
    if constexpr (WITH_EXP) {
        // targets 3, 2 and 1.  The ring holds bwd[1], bwd[2], bwd[3] in
        // slots 1, 2, 0 and fsh holds fwd[1], fwd[2] in slots 1, 2 (NEG
        // where the diagonal lies past ND)
        const float* b3 = ring;
        const bool cut3 = seed[2] != 0.0f || seed[1] != 0.0f;
        exp_target(t, xb, yb, X, Y, C, 3, wg[3], fsh + S * W, wg[1],
                   fsh + 2 * S * W, wg[2], cut3 ? CPECAN_NEG : b3[l],
                   cut3 ? CPECAN_NEG : b3[W + l],
                   cut3 ? CPECAN_NEG : b3[2 * W + l], total,
                   in_band(wg[3] + l, base[3], width[3]), true, l, W, acc,
                   gap_row);
        // fwd[0] into slot 0 (target 3 read slots 1 and 2 only)
#pragma unroll
        for (int i = 0; i < S; ++i)
            fsh[i * W + l] = fin[static_cast<size_t>(i) * R * W];
        __syncthreads();
        const float* b2 = ring + 2 * S * W;
        const bool cut2 = seed[1] != 0.0f;
        exp_target(t, xb, yb, X, Y, C, 2, wg[2], fsh, wg[0], fsh + S * W,
                   wg[1], cut2 ? CPECAN_NEG : b2[l],
                   cut2 ? CPECAN_NEG : b2[W + l],
                   cut2 ? CPECAN_NEG : b2[2 * W + l], total,
                   in_band(wg[2] + l, base[2], width[2]), true, l, W, acc,
                   gap_row);
        __syncthreads();   // orders the gap_row columns of targets 2 and 1
        // target 1: no middle source, emissions(1) fresh (not a carry)
        const float* b1 = ring + S * W;
        exp_target(t, xb, yb, X, Y, C, 1, wg[1], nullptr, 0, fsh, wg[0],
                   b1[l], b1[W + l], b1[2 * W + l], total,
                   in_band(wg[1] + l, base[1], width[1]), false, l, W, acc,
                   gap_row);
#pragma unroll
        for (int k = 0; k < NTRANS; ++k) {
            const float s = block_sum(acc[k], red);
            if (l == 0) trans[static_cast<size_t>(b) * NTRANS + k] = s;
        }
    }
}

int launch_config_error(int W) {
    // one thread per lane: W must fill whole warps and fit one block
    if (W <= 0 || W % 32 != 0 || W > 1024) return cudaErrorInvalidValue;
    return cudaSuccess;
}

template <bool WITH_EXP, bool TILED>
int launch_bwd(const void* scal, const void* win, const void* xf,
               const void* yf, const void* basef, const void* widthf,
               const void* seedf, const void* raggedf, const void* fwd,
               const void* shifts, void* posts, void* totals, void* trans,
               void* gapx, int G, int R, int W, int ND, int NDp, int X,
               int C, int Y, int TD, void* stream) {
    if (int e = launch_config_error(W)) return e;
    if (TILED && (TD <= 0 || ND % TD != 0)) return cudaErrorInvalidValue;
    // ring + em + red, and fsh with the expectations
    const size_t smem =
        sizeof(float) * ((3 * S + 2) * W + 32 + (WITH_EXP ? 3 * S * W : 0));
    if (smem > 48 * 1024) {
        cudaFuncSetAttribute(sm3_bwd_kernel<WITH_EXP, TILED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    }
    sm3_bwd_kernel<WITH_EXP, TILED>
        <<<G * R, W, smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(scal), static_cast<const int*>(win),
            static_cast<const float*>(xf), static_cast<const float*>(yf),
            static_cast<const float*>(basef),
            static_cast<const float*>(widthf),
            static_cast<const float*>(seedf),
            static_cast<const float*>(raggedf),
            static_cast<const float*>(fwd),
            static_cast<const float*>(shifts), static_cast<float*>(posts),
            static_cast<float*>(totals), static_cast<float*>(trans),
            static_cast<float*>(gapx), R, W, ND, NDp, X, C, Y, TD);
    return static_cast<int>(cudaGetLastError());
}

template <bool TILED>
int launch_fwd(const void* scal, const void* win, const void* xf,
               const void* yf, const void* basef, const void* widthf,
               void* fwd, void* shifts, int G, int R, int W, int ND, int NDp,
               int X, int C, int Y, int TD, void* stream) {
    if (int e = launch_config_error(W)) return e;
    if (TILED && (TD <= 0 || ND % TD != 0)) return cudaErrorInvalidValue;
    // ring, and the reduction scratch of the re-centering
    const size_t smem = sizeof(float) * (3 * S * W + (TILED ? 32 : 0));
    if (smem > 48 * 1024) {
        cudaFuncSetAttribute(sm3_fwd_kernel<TILED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    }
    sm3_fwd_kernel<TILED>
        <<<G * R, W, smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(scal), static_cast<const int*>(win),
            static_cast<const float*>(xf), static_cast<const float*>(yf),
            static_cast<const float*>(basef),
            static_cast<const float*>(widthf), static_cast<float*>(fwd),
            static_cast<float*>(shifts), R, W, ND, NDp, X, C, Y, TD);
    return static_cast<int>(cudaGetLastError());
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
    return launch_fwd<false>(scal, win, xf, yf, basef, widthf, fwd, nullptr,
                             G, R, W, ND, NDp, X, C, Y, 0, stream);
}

int wavefront_fwd_tiled(const void* scal, const void* win, const void* xf,
                        const void* yf, const void* basef,
                        const void* widthf, void* fwd, void* shifts, int G,
                        int R, int W, int ND, int NDp, int X, int C, int Y,
                        int TD, void* stream) {
    return launch_fwd<true>(scal, win, xf, yf, basef, widthf, fwd, shifts,
                            G, R, W, ND, NDp, X, C, Y, TD, stream);
}

int wavefront_bwd(const void* scal, const void* win, const void* xf,
                  const void* yf, const void* basef, const void* widthf,
                  const void* seedf, const void* raggedf, const void* fwd,
                  void* posts, void* totals, int G, int R, int W, int ND,
                  int NDp, int X, int C, int Y, void* stream) {
    return launch_bwd<false, false>(scal, win, xf, yf, basef, widthf, seedf,
                                    raggedf, fwd, nullptr, posts, totals,
                                    nullptr, nullptr, G, R, W, ND, NDp, X, C,
                                    Y, 0, stream);
}

int wavefront_bwd_exp(const void* scal, const void* win, const void* xf,
                      const void* yf, const void* basef, const void* widthf,
                      const void* seedf, const void* raggedf,
                      const void* fwd, void* posts, void* totals,
                      void* trans, void* gapx, int G, int R, int W, int ND,
                      int NDp, int X, int C, int Y, void* stream) {
    return launch_bwd<true, false>(scal, win, xf, yf, basef, widthf, seedf,
                                   raggedf, fwd, nullptr, posts, totals,
                                   trans, gapx, G, R, W, ND, NDp, X, C, Y, 0,
                                   stream);
}

int wavefront_bwd_tiled(const void* scal, const void* win, const void* xf,
                        const void* yf, const void* basef,
                        const void* widthf, const void* seedf,
                        const void* raggedf, const void* fwd,
                        const void* shifts, void* posts, void* totals, int G,
                        int R, int W, int ND, int NDp, int X, int C, int Y,
                        int TD, void* stream) {
    return launch_bwd<false, true>(scal, win, xf, yf, basef, widthf, seedf,
                                   raggedf, fwd, shifts, posts, totals,
                                   nullptr, nullptr, G, R, W, ND, NDp, X, C,
                                   Y, TD, stream);
}

}  // extern "C"
