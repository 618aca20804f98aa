// Band-local forward and posterior-backward wavefront kernels of the
// pair-HMM machines, for Hopper (sm_90a): the strawman 3-state signal
// machine (getStrawManStateMachine3), the HDP 3-state signal machine
// (getHdpStateMachine3, streamed emissions), the vanilla 3-state signal machine
// (getSignalStateMachine3Vanilla, signalAlign's default), the 4-state signal
// machine (getStateMachine4, signalAlign's fourState), the 7-state echelon
// signal machine (getStateMachineEchelon, multi-k-mer events, multi-state
// posteriors) and the 5-state DNA machine (getStateMachine5,
// cPecanRealign's).  Both kernels are templates on a machine spec
// (Strawman, Hdp, Vanilla, Sm4, Echelon, Dna5: states, scalars, emissions
// and the forward/backward updates); every instance keeps its JAX spec's
// op order.  Plain C entry points, loaded with ctypes by
// cpecan_tpu_torch/ops/cuda_build.py and wrapped by
// cpecan_tpu_torch/ops/fb_kernels.py (wavefront_fwd, wavefront_bwd,
// wavefront_bwd_exp, wavefront_fwd_tiled, wavefront_bwd_tiled,
// echelon_emissions; the dna5, vanilla, sm4, echelon and hdp instances'
// entry points end in _dna5, _vanilla, _sm4, _echelon and _hdp; echelon
// has K1 and K2 only and its emission pre-pass, hdp K1, K2 and K3).
//
// Replaces (TPU, Pallas):
//   sm3_fwd_tiled_sel<Spec, false>
//                          <- cpecan_tpu/ops/pallas_fb.py _sm3_forward_kernel
//                             (:635, untiled) for _StrawmanSpec (:162),
//                             _Sm4Spec (:257), _Dna5Spec (:340),
//                             _VanillaSpec (:456) and the streamed
//                             _HdpSpec (:2829): the untiled select
//                             forward (the note above
//                             sm3_fwd_tiled_sel); sm3_fwd_kernel<Spec>,
//                             the first port of that kernel, stays in the
//                             source for tests/test_torch_wavefront_
//                             emulated.py, which holds these to it      K1
//   sm3_fwd_tiled_sel<Spec, true>
//                          <- _sm3_forward_kernel(tile=...) (:2304), chained
//                             over the tiles by _run_tiled (:2447) with
//                             _tile_steps.recenter (:2381); _Dna5Spec (the
//                             100 kb pair's path), _StrawmanSpec,
//                             _VanillaSpec, _Sm4Spec (the long signal
//                             reads' path), with the select step (the
//                             note above it)                          K6a
//   sm3_bwd_tiled_sel<Spec, false, true>
//                          <- _sm3_backward_kernel(tile=...) (:2332), the
//                             shifts repaid as shf (:947, :1170, :1193);
//                             _Dna5Spec (the 100 kb pair's path),
//                             _StrawmanSpec, _VanillaSpec, _Sm4Spec (the
//                             long signal reads' path), with the select
//                             step (the note above sm3_fwd_tiled_sel)  K6b
//   sm3_bwd_tiled_sel<Spec, false, false>
//                          <- K2 (the same body, with_exp=False) for the
//                             5-state DNA machine (the realigner's
//                             posteriors), _StrawmanSpec and _VanillaSpec
//                             (the signal posterior chunks), _Sm4Spec (the
//                             fourState pipeline's chunks) and the
//                             streamed _HdpSpec: the untiled posterior
//                             form, with the select step
//   sm3_bwd_tiled_sel<Spec, true, false>
//                          <- cpecan_tpu/ops/pallas_fb.py _sm3_backward_kernel
//                             -> _sm3_backward_body_w (:857, :900) with
//                             with_exp=True (EM expectations:
//                             accumulate_exp :1072), K3, for the 5-state
//                             DNA machine (cPecanEm's E-step;
//                             _Dna5Spec.exp_probs_w :406), the strawman
//                             (trainModels' threeState E-step;
//                             _StrawmanSpec.exp_probs_w :215), the
//                             4-state machine (the fourState E-step;
//                             _Sm4Spec.exp_probs_w :275), the vanilla
//                             machine (trainModels' -smt vanilla E-step;
//                             _VanillaSpec.exp_probs_w :506) and the
//                             streamed _HdpSpec (the HDP E-step; the
//                             strawman's sums): the untiled expectation
//                             form, with the select step, the strawman's,
//                             sm4's and hdp's targets' emissions from the
//                             carry (the note above sm3_bwd_tiled_sel);
//                             sm3_bwd_kernel<Spec, true>, the first port
//                             of that kernel, stays in the source for
//                             tests/test_torch_wavefront_emulated.py,
//                             which holds these to it                  K3
//   sm3_fwd_tiled_sel<Echelon, false>, sm3_bwd_tiled_sel<Echelon, false,
//   false>                 <- K1 and K2 for the 7-state echelon machine
//                             (_EchelonSpec :528): the untiled forms,
//                             reading the emissions from the plane of
//   sm3_emissions_kernel<Echelon>, which replaces no TPU kernel: the
//                             emission half of those kernels' body,
//                             computed for every cell of the batch first
//                             (the note above it)
//
// Layout (identical to the JAX planes, index for index): G groups of R
// reads, one group window of W lanes per diagonal starting at x = win[g, d],
// lane l <-> cell (x = win[g, d] + l, y = d - x).
//   scal   f32 [NS + 3S] = [NS transitions, start(S), end(S), ragged_end(S)]
//   win    i32 [G, NDp]
//   xf     f32 [G*R, NXF, X]    per-x model rows (emissions + gap-X row)
//   yf     f32 [G*R, YR, Y]     y rows (2; echelon 8), flipped: y <-> column
//                               C - y
//   basef, widthf, seedf, raggedf  f32 [G*R, NDp]
//   fwd    f32 [G, ND+1, S, R, W]
//   posts  f32 [G, ND+1, NPS, R, W] (NPS 1 but for echelon's 5 match
//          states),  totals f32 [G*R]
//   est    f32 [G, ND+3, R, W]  the emission stream of a streamed spec
//          (hdp): diagonal d's match = gap-Y emission at its own window
//   trans  f32 [G*R, S*S]  (lanes frm*S + to; EM only)
//   acc    f32 [G, NACC, R, X]  per-column accumulators (EM only; strawman
//          NACC 1, the gap-X mass; sm4 NACC 1, the shortGapX mass; dna5
//          NACC 20, row to*4 + by the mass into state to at a cell of y base
//          by; vanilla NACC 2, the beta (M -> X) and alpha (X -> X) masses)
//   shifts f32 [G*R, NT]  (tiled only; NT = ND / TD)
// Strawman: S 3, NS 8, NXF 9 (Gaussian model rows 0-7, gap-X row 8), yf =
// (event mean, noise).  Vanilla: S 3, NS 2 (Y -> M, Y -> Y), NXF 13 (match
// and gap-Y model rows 0-7, Gaussian level x inverse-Gaussian noise; rows
// 8-12 the per-column log transitions a_mx, a_xx, a_mm, a_xm, a_my from
// the k-mer skip bins), a silent gap-X, yf as strawman's.  Sm4: S 4 (M,
// shortGapX, shortGapY, longGapX), NS 11, strawman's rows and emissions
// (the gap-X row 8 for both X states).  Dna5: S 5, NS 13, NXF 6 (match
// rows of the x base against y base 0..4, gap-X row 5), yf = (y base index
// as a float, gap-Y emission); the match emission is a sum of five selects
// on the y base, as the JAX spec has it, so a value outside 0..4 gives 0.0.
// Echelon: S 7 (match0, match1..match5, gap-X), NS 0, NXF 33 (rows 4i..4i+3
// the Gaussian level x inverse-Gaussian noise model of the k-mer at offset
// i = 0..4, 20-23 the gap-Y model of the first, 24-27 the skip logs la_mx,
// la_mh, la_xx, la_xh, 28-32 the validity of n = 1..5 k-mers), YR 8 (the
// duration posteriors dur_0..dur_5, the event mean, the noise); its match
// emission is NEM = 5 per-n terms, which the backward carries and
// realigns leaf by leaf, and its posteriors are those of match1..match5.
// Hdp: the strawman's scalars, transitions, gap-X row 8 and expectations;
// its match and gap-Y emission is one value, the k-mer's HDP spline density
// at the event mean, which the host builds per diagonal into est
// (ops/features.py hdp_stream; xf rows 0-7 and yf are zeros and unread).
// On the TPU the stream was double-buffered through VMEM by DMA because
// per-lane table gathers do not vectorize there (pallas_fb.py:737-753,
// :973-1003); here lane l reads est[g, d, r, l] with one coalesced load
// per diagonal, and the backward's reads at another window w are
// est[g, d, r, l + w - win[g, d]], CPECAN_NEG outside [0, W)
// (emissions_at's realignment, pallas_fb.py:990-993): L2, ordinary loads
// and, in the posterior backward, cp.async copies into shared slots take
// the place of the ring.  The stream's layout is offset 0 (row d at d's
// own window; the echelon pre-pass plane's backward slots are at offset
// 1): the posterior backward's step d reads est[d + 1] at lane l + o1 (o1
// = w_d - w_{d+1}) and carries it in the em ring, whose read at lane l +
// o1 + 1 gives est[d + 2] at lane l + o2 + 1 (o2 = w_d - w_{d+2}),
// CPECAN_NEG where either lane falls outside [0, W).
//
// Design: one block per read (grid G*R), one thread per lane (W threads).
// Each diagonal depends on the previous one or two through lane shifts of
// the group window, so the carried diagonals live in shared memory (a ring
// of three [S, W] slots; one __syncthreads() per diagonal) and a shifted
// read is a shared-memory read at lane l + s, CPECAN_NEG outside [0, W).
// The dna5 ring is 3 * 5 * W floats (60 KB at W = 1024, past the 48 KB
// default: the launchers raise the dynamic limit); the echelon forward's
// ring and staged plane slots are 3 * 7 * W + 4 * 6 * W floats (184 KB),
// its backward's ring, staged fwd entries and plane slots 3 * 7 * W + 2 *
// 5 * W + 3 * 6 * W floats (201 KB).
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
// The EM expectations (the WITH_EXP forms) add, per step, the posterior
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
// The machine's transition sums (strawman 9 lanes, sm4 its 11 active ones
// of 16, dna5 its 13 active ones of 25, vanilla none) are per-thread
// registers across the sweep, reduced once at the end (block_sum, fixed
// order); the lanes that are no transition of the machine are written as
// 0.  The per-column accumulators go to the read's own rows of acc in
// global memory, column w_t + l; each column is touched by one thread per
// target and the per-diagonal barrier orders the read-modify-writes, so
// no atomics are needed (dna5's adds are atomic reductions, so that no
// step waits on the read; the barrier orders them alike).  Dna5 reads the
// target's y base fresh (yf row 0
// at column C - t + x, pallas_fb.py:1077; only the emissions are carried)
// and adds a cell's five state masses to the rows of its y base only: the
// other rows' contributions are +0.0, so skipping them leaves every sum
// bit-equal, and an N (base 4) adds nothing.
#include <cuda_runtime.h>

#include "logspace.cuh"

namespace {

// strawman scalar order (pallas_fb.py T_MM..T_EY)
enum { T_MM, T_XM, T_YM, T_OX, T_EX, T_SX, T_OY, T_EY, SM3_NS };
// sm4 scalar order (pallas_fb.py T4_SOX..T4_SEY): lower(5), middle(4),
// upper(2)
enum { T4_SOX, T4_SEX, T4_LOX, T4_LEX, T4_LSX, T4_MM, T4_MSX, T4_MSY,
       T4_MLX, T4_SOY, T4_SEY, SM4_NS };
// dna5 scalar order (pallas_fb.py T5_SOX..T5_LEY): lower(4), middle(5),
// upper(4)
enum { T5_SOX, T5_SEX, T5_LOX, T5_LEX, T5_MM, T5_MSX, T5_MSY, T5_MLX,
       T5_MLY, T5_SOY, T5_SEY, T5_LOY, T5_LEY, DNA5_NS };

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

// the emissions come from the feature rows (false) or from the stream est
// (true; only Hdp); EM_PLANE > 0: the select templates read them, that
// many leaves a cell, from the emission pre-pass's plane (only Echelon)
struct FromRows {
    static constexpr bool STREAMED = false;
    static constexpr int EM_PLANE = 0;
    // whether sm3_bwd_tiled_sel's expectation form takes its targets'
    // emissions from the carry ring (only the Gaussian machines, whose
    // emissions are four gauss a cell) instead of computing them again
    static constexpr bool EXP_CARRY = false;
};

// a match emission of N terms (echelon's per-n terms)
template <int N>
struct EmissionsN {
    float match[N];
    float gap_y;
};

// leaf k of a match emission: what the backward carries
__device__ __forceinline__ float em_leaf(const Emissions& e, int) {
    return e.match;
}

// A machine spec: its S states, NS transition scalars, NXF x-feature rows,
// YR y rows, the NEM leaves of its match emission, the NPS states whose
// posteriors the backward writes (post_state(j)), the emissions of the cell
// (x, y) with y at column ycol of the flipped y rows, and the forward and
// backward updates of one cell.  The update
// arguments arrive aligned to the current window, as in the JAX specs'
// *_update_w: p1m/p2m the sources at x - 1, p1a at x; n1a at x, n1p/n2p at
// x + 1.  Each update reads the x-feature rows it needs itself from the
// read's rows xb (row i at xb[i * X + x']): the forward at x, the backward
// at x and at x + 1, the latter clamped to X - 1 (the last lane of the last
// window reads past the x range, which lies outside every band).  Entries
// a spec does not read are never loaded (the compiler drops them).

__device__ __forceinline__ int next_col(int x, int X) {
    return min(x + 1, X - 1);
}

// the y rows, match emission leaves and posterior states of the machines
// with one match state: (event mean or y base, noise or gap-Y), one leaf,
// the match state's posteriors
struct OneMatch : FromRows {
    static constexpr int YR = 2, NEM = 1, NPS = 1;
    // per-column logs that sm3_bwd_tiled_sel keeps across the steps where
    // the window stays (the signal machines: 4), and whether it reads the
    // transitions from shared memory (the signal machines: their steps
    // need the registers)
    static constexpr int NLSD = 0;
    static constexpr bool T_SHARED = false;
    // per-column transitions (Vanilla): sm3_bwd_tiled_sel loads the rows
    // that row_at_next names at next_col(x) and hands the update all x
    // rows; otherwise the gap-X row alone is loaded there and handed over
    static constexpr bool COL_TRANS = false;
    __host__ __device__ static constexpr int post_state(int) { return 0; }
};

// The forms of sm3_fwd_tiled_sel and sm3_bwd_tiled_sel for the signal
// machines (Strawman, Sm4, Vanilla): in = yf rows 0-1 at the cell's column,
// then the xf rows (the backward's rows of the next column at next_col(x));
// model rows 0-7 are (mean, sd or lambda) pairs, and lsd holds the logs of
// rows 1, 3, 5, 7 at x (col_logs, or col_logs_at from the rows; the
// templates take them again only where the window moves)
struct SignalRows : OneMatch {
    static constexpr int NLSD = 4;
    static constexpr bool T_SHARED = true;
    __device__ __forceinline__ static void col_logs(const float* in,
                                                    float* lsd) {
#pragma unroll
        for (int k = 0; k < NLSD; ++k) lsd[k] = logf(in[YR + 2 * k + 1]);
    }
    __device__ __forceinline__ static void col_logs_at(const float* xb,
                                                       int X, int x,
                                                       float* lsd) {
#pragma unroll
        for (int k = 0; k < NLSD; ++k) lsd[k] = logf(xb[(2 * k + 1) * X + x]);
    }
};

// the strawman's emissions (Strawman, Sm4): Gaussian x Gaussian over
// (event mean, noise)
struct GaussRows : SignalRows {
    static constexpr bool EXP_CARRY = true;
    // written once for both forms: g(v, i) is the Gaussian of v under
    // model rows i (mean) and i + 1 (sd)
    template <class Gauss>
    __device__ __forceinline__ static Emissions emissions_with(
            float mean, float noise, Gauss g) {
        Emissions e;
        e.match = g(mean, 0) + g(noise, 2);
        e.gap_y = g(mean, 4) + g(noise, 6);
        return e;
    }

    __device__ __forceinline__ static Emissions emissions_at(
            const float* xb, const float* yb, int X, int Y, int x,
            int ycol) {
        return emissions_with(yb[ycol], yb[Y + ycol], [&](float v, int i) {
            return gauss(v, xb[i * X + x], xb[(i + 1) * X + x]);
        });
    }

    // the select templates' form: the select-guarded gauss_sel on the
    // kept logs
    __device__ __forceinline__ static Emissions emissions_in(
            const float* in, const float* lsd) {
        return emissions_with(in[0], in[1], [&](float v, int i) {
            return gauss_sel(v, in[YR + i], in[YR + i + 1], lsd[i / 2]);
        });
    }
};

// _StrawmanSpec (pallas_fb.py:162-207)
struct Strawman : GaussRows {
    static constexpr int S = 3, NS = SM3_NS, NXF = 9, GAP_X = 8;

    // _StrawmanSpec.fwd_update_w, written once for both log-adds (LA:
    // LogAddBranch, LogAddSel); e_gapx the gap-X row at x
    template <class LA>
    __device__ __forceinline__ static void fwd_update_with(
            const float* t, const float* p1m, const float* p1a,
            const float* p2m, const Emissions& e, float e_gapx,
            float* out) {
        out[0] = LA::add3(p2m[0] + t[T_MM], p2m[1] + t[T_XM],
                          p2m[2] + t[T_YM]) + e.match;
        out[1] = LA::add3(p1m[0] + t[T_OX], p1m[1] + t[T_EX],
                          p1m[2] + t[T_SX]) + e_gapx;
        out[2] = LA::add(p1a[0] + t[T_OY], p1a[2] + t[T_EY]) + e.gap_y;
    }

    // the branch form, sm3_fwd_kernel's: no entry point launches
    // sm3_fwd_kernel<Strawman> or <Hdp> since K1 strawman and K1 hdp run
    // the untiled select forward, but tests/test_torch_wavefront_emulated.py
    // holds those to it
    __device__ __forceinline__ static void fwd_update(
            const float* t, const float* p1m, const float* p1a,
            const float* p2m, const Emissions& e, const float* xb, int X,
            int x, float* out) {
        fwd_update_with<LogAddBranch>(t, p1m, p1a, p2m, e,
                                      xb[GAP_X * X + x], out);
    }

    __device__ __forceinline__ static void fwd_update_sel(
            const float* t, const float* p1m, const float* p1a,
            const float* p2m, const Emissions& e, float e_gapx,
            float* out) {
        fwd_update_with<LogAddSel>(t, p1m, p1a, p2m, e, e_gapx, out);
    }

    // _StrawmanSpec.bwd_update_w, written once for both log-adds (LA:
    // LogAddBranch, LogAddSel); e_gapx_p the gap-X row at next_col(x)
    template <class LA>
    __device__ __forceinline__ static void bwd_update_with(
            const float* t, float e_gapx_p, float eg1, const float* em2p,
            const float* n1a, const float* n1p, const float* n2p,
            float* out) {
        const float mid = em2p[0] + n2p[0];
        float bm = mid + t[T_MM];
        float bx = mid + t[T_XM];
        float by = mid + t[T_YM];
        const float up = eg1 + n1a[2];
        bm = LA::add(bm, up + t[T_OY]);
        by = LA::add(by, up + t[T_EY]);
        const float low = e_gapx_p + n1p[1];
        bm = LA::add(bm, low + t[T_OX]);
        bx = LA::add(bx, low + t[T_EX]);
        by = LA::add(by, low + t[T_SX]);
        out[0] = bm;
        out[1] = bx;
        out[2] = by;
    }

    // the branch form, sm3_bwd_kernel's: no entry point launches
    // sm3_bwd_kernel<Strawman, ...> or <Hdp, ...> since K2 and K3 of both
    // run the untiled select forms, but
    // tests/test_torch_wavefront_emulated.py holds those to it
    __device__ __forceinline__ static void bwd_update(
            const float* t, const float* xb, int X, int x, float eg1,
            const float* em2p, const float* n1a, const float* n1p,
            const float* n2p, float* out) {
        bwd_update_with<LogAddBranch>(t, xb[GAP_X * X + next_col(x, X)],
                                      eg1, em2p, n1a, n1p, n2p, out);
    }

    __device__ __forceinline__ static void bwd_update_sel(
            const float* t, float e_gapx_p, float eg1, const float* em2p,
            const float* n1a, const float* n1p, const float* n2p,
            float* out) {
        bwd_update_with<LogAddSel>(t, e_gapx_p, eg1, em2p, n1a, n1p, n2p,
                                   out);
    }

    // EM expectations: NLANE per-thread transition sums, sum k of them
    // output lane lane(k) of the S*S table; NACC per-column accumulators
    static constexpr int NLANE = 9, NACC = 1;
    __host__ __device__ static constexpr int lane(int k) { return k; }

    // _StrawmanSpec.exp_probs_w + accumulate_exp at one cell; lanes
    // frm * 3 + to, lane 5 (X -> Y) no transition of the machine
    __device__ __forceinline__ static void exp_probs(
            const float* t, const Emissions& e, const float* xb, int X,
            int x, float /*y*/, const float* f0m, const float* f1m,
            const float* f1a, const float* b, float total, bool m,
            float* acc, float* col, size_t /*row_stride*/);
};

// _HdpSpec (pallas_fb.py:2829): the strawman with streamed emissions (match
// == gap-Y, impl/stateMachine.c:1353-1354); emissions_at is never called
struct Hdp : Strawman {
    static constexpr bool STREAMED = true;
    // the x rows the untiled select forward loads: the gap-X row alone
    __host__ __device__ static constexpr bool fwd_row(int i) {
        return i == GAP_X;
    }
};

// _Sm4Spec (pallas_fb.py:257-337): M, shortGapX, shortGapY, longGapX; the
// strawman's emissions and select forms
struct Sm4 : GaussRows {
    static constexpr int S = 4, NS = SM4_NS, NXF = 9, GAP_X = 8;

    // _Sm4Spec.fwd_update_w, the JAX grouping kept exactly, written once
    // for both log-adds (LA: LogAddBranch, LogAddSel); e_gapx the gap-X
    // row at x
    template <class LA>
    __device__ __forceinline__ static void fwd_update_with(
            const float* t, const float* p1m, const float* p1a,
            const float* p2m, const Emissions& e, float e_gapx,
            float* out) {
        out[0] = LA::add(LA::add(p2m[0] + t[T4_MM], p2m[1] + t[T4_MSX]),
                         LA::add(p2m[2] + t[T4_MSY], p2m[3] + t[T4_MLX]))
                 + e.match;
        out[1] = LA::add(p1m[0] + t[T4_SOX], p1m[1] + t[T4_SEX]) + e_gapx;
        out[2] = LA::add(p1a[0] + t[T4_SOY], p1a[2] + t[T4_SEY]) + e.gap_y;
        out[3] = LA::add3(p1m[0] + t[T4_LOX], p1m[3] + t[T4_LEX],
                          p1m[2] + t[T4_LSX]) + e_gapx;
    }

    // the branch form, sm3_fwd_kernel's: no entry point launches
    // sm3_fwd_kernel<Sm4> since K1 sm4 runs the untiled select forward,
    // but tests/test_torch_wavefront_emulated.py holds that one to it
    __device__ __forceinline__ static void fwd_update(
            const float* t, const float* p1m, const float* p1a,
            const float* p2m, const Emissions& e, const float* xb, int X,
            int x, float* out) {
        fwd_update_with<LogAddBranch>(t, p1m, p1a, p2m, e,
                                      xb[GAP_X * X + x], out);
    }

    __device__ __forceinline__ static void fwd_update_sel(
            const float* t, const float* p1m, const float* p1a,
            const float* p2m, const Emissions& e, float e_gapx,
            float* out) {
        fwd_update_with<LogAddSel>(t, p1m, p1a, p2m, e, e_gapx, out);
    }

    // _Sm4Spec.bwd_update_w, the JAX grouping kept exactly, written once
    // for both log-adds (LA: LogAddBranch, LogAddSel); e_gapx_p the gap-X
    // row at next_col(x)
    template <class LA>
    __device__ __forceinline__ static void bwd_update_with(
            const float* t, float e_gapx_p, float eg1, const float* em2p,
            const float* n1a, const float* n1p, const float* n2p,
            float* out) {
        const float mid = em2p[0] + n2p[0];
        const float low_s = e_gapx_p + n1p[1];
        const float low_l = e_gapx_p + n1p[3];
        const float up = eg1 + n1a[2];
        out[0] = LA::add(LA::add(mid + t[T4_MM], low_s + t[T4_SOX]),
                         LA::add(low_l + t[T4_LOX], up + t[T4_SOY]));
        out[1] = LA::add(mid + t[T4_MSX], low_s + t[T4_SEX]);
        out[2] = LA::add3(mid + t[T4_MSY], low_l + t[T4_LSX],
                          up + t[T4_SEY]);
        out[3] = LA::add(mid + t[T4_MLX], low_l + t[T4_LEX]);
    }

    // the branch form, sm3_bwd_kernel's: no entry point launches
    // sm3_bwd_kernel<Sm4, ...> since K2 and K3 sm4 run the untiled select
    // forms, but tests/test_torch_wavefront_emulated.py holds those to it
    __device__ __forceinline__ static void bwd_update(
            const float* t, const float* xb, int X, int x, float eg1,
            const float* em2p, const float* n1a, const float* n1p,
            const float* n2p, float* out) {
        bwd_update_with<LogAddBranch>(t, xb[GAP_X * X + next_col(x, X)],
                                      eg1, em2p, n1a, n1p, n2p, out);
    }

    __device__ __forceinline__ static void bwd_update_sel(
            const float* t, float e_gapx_p, float eg1, const float* em2p,
            const float* n1a, const float* n1p, const float* n2p,
            float* out) {
        bwd_update_with<LogAddSel>(t, e_gapx_p, eg1, em2p, n1a, n1p, n2p,
                                   out);
    }

    // EM expectations: the 11 transitions (register k -> lane frm*4 + to,
    // in _Sm4Spec.EXP_LANES' order; lanes 6, 7, 9, 13, 14 stay 0) and one
    // accumulator, the shortGapX mass
    static constexpr int NLANE = 11, NACC = 1;
    __host__ __device__ static constexpr int lane(int k) {
        constexpr int L[NLANE] = {0, 4, 8, 12, 1, 5, 3, 15, 11, 2, 10};
        return L[k];
    }

    // _Sm4Spec.exp_probs_w + accumulate_exp at one cell
    __device__ __forceinline__ static void exp_probs(
            const float* t, const Emissions& e, const float* xb, int X,
            int x, float y, const float* f0m, const float* f1m,
            const float* f1a, const float* b, float total, bool m,
            float* acc, float* col, size_t row_stride);
};

// _Dna5Spec (pallas_fb.py:340-392): M, shortGapX, shortGapY, longGapX,
// longGapY
struct Dna5 : OneMatch {
    static constexpr int S = 5, NS = DNA5_NS, NXF = 6, GAP_X = 5;

    // match: the x row of the y base (yf row 0, a float), summed over five
    // selects in the JAX order; gap-Y: yf row 1 as is
    __device__ __forceinline__ static Emissions emissions_at(
            const float* xb, const float* yb, int X, int Y, int x,
            int ycol) {
        const float b = yb[ycol];
        float m = b == 0.0f ? xb[0 * X + x] : 0.0f;
        m = m + (b == 1.0f ? xb[1 * X + x] : 0.0f);
        m = m + (b == 2.0f ? xb[2 * X + x] : 0.0f);
        m = m + (b == 3.0f ? xb[3 * X + x] : 0.0f);
        m = m + (b == 4.0f ? xb[4 * X + x] : 0.0f);
        Emissions e;
        e.match = m;
        e.gap_y = yb[Y + ycol];
        return e;
    }

    // _Dna5Spec.fwd_update_w, the branch form, sm3_fwd_kernel's: no entry
    // point launches sm3_fwd_kernel<Dna5> since K1 dna5 runs the untiled
    // select forward, but tests/test_torch_wavefront_emulated.py holds that
    // one to it
    __device__ __forceinline__ static void fwd_update(
            const float* t, const float* p1m, const float* p1a,
            const float* p2m, const Emissions& e, const float* xb, int X,
            int x, float* out) {
        const float e_gapx = xb[GAP_X * X + x];
        out[0] = log_add(log_add3(p2m[0] + t[T5_MM], p2m[1] + t[T5_MSX],
                                  p2m[2] + t[T5_MSY]),
                         log_add(p2m[3] + t[T5_MLX], p2m[4] + t[T5_MLY]))
                 + e.match;
        out[1] = log_add(p1m[0] + t[T5_SOX], p1m[1] + t[T5_SEX]) + e_gapx;
        out[2] = log_add(p1a[0] + t[T5_SOY], p1a[2] + t[T5_SEY]) + e.gap_y;
        out[3] = log_add(p1m[0] + t[T5_LOX], p1m[3] + t[T5_LEX]) + e_gapx;
        out[4] = log_add(p1a[0] + t[T5_LOY], p1a[4] + t[T5_LEY]) + e.gap_y;
    }

    // The forms of sm3_fwd_tiled_sel and sm3_bwd_tiled_sel (the
    // backward's only form): the arithmetic above on the cell's inputs
    // loaded into registers (in: yf rows 0-1 at the cell's column, then
    // xf rows 0-5), with the branch-free log_add_sel
    __device__ __forceinline__ static Emissions emissions_in(
            const float* in) {
        const float b = in[0];
        float m = b == 0.0f ? in[YR + 0] : 0.0f;
        m = m + (b == 1.0f ? in[YR + 1] : 0.0f);
        m = m + (b == 2.0f ? in[YR + 2] : 0.0f);
        m = m + (b == 3.0f ? in[YR + 3] : 0.0f);
        m = m + (b == 4.0f ? in[YR + 4] : 0.0f);
        Emissions e;
        e.match = m;
        e.gap_y = in[1];
        return e;
    }

    __device__ __forceinline__ static void fwd_update_sel(
            const float* t, const float* p1m, const float* p1a,
            const float* p2m, const Emissions& e, float e_gapx, float* out) {
        out[0] = log_add_sel(log_add3_sel(p2m[0] + t[T5_MM],
                                          p2m[1] + t[T5_MSX],
                                          p2m[2] + t[T5_MSY]),
                             log_add_sel(p2m[3] + t[T5_MLX],
                                         p2m[4] + t[T5_MLY]))
                 + e.match;
        out[1] = log_add_sel(p1m[0] + t[T5_SOX], p1m[1] + t[T5_SEX])
                 + e_gapx;
        out[2] = log_add_sel(p1a[0] + t[T5_SOY], p1a[2] + t[T5_SEY])
                 + e.gap_y;
        out[3] = log_add_sel(p1m[0] + t[T5_LOX], p1m[3] + t[T5_LEX])
                 + e_gapx;
        out[4] = log_add_sel(p1a[0] + t[T5_LOY], p1a[4] + t[T5_LEY])
                 + e.gap_y;
    }

    // _Dna5Spec.bwd_update_w, the JAX grouping kept exactly (log_add is
    // not associative in f32); e_gapx_p: the gap-X row at next_col(x)
    __device__ __forceinline__ static void bwd_update_sel(
            const float* t, float e_gapx_p, float eg1, const float* em2p,
            const float* n1a, const float* n1p, const float* n2p,
            float* out) {
        const float mid = em2p[0] + n2p[0];
        const float low_s = e_gapx_p + n1p[1];
        const float low_l = e_gapx_p + n1p[3];
        const float up_s = eg1 + n1a[2];
        const float up_l = eg1 + n1a[4];
        out[0] = log_add_sel(log_add3_sel(mid + t[T5_MM], low_s + t[T5_SOX],
                                          low_l + t[T5_LOX]),
                             log_add_sel(up_s + t[T5_SOY],
                                         up_l + t[T5_LOY]));
        out[1] = log_add_sel(mid + t[T5_MSX], low_s + t[T5_SEX]);
        out[2] = log_add_sel(mid + t[T5_MSY], up_s + t[T5_SEY]);
        out[3] = log_add_sel(mid + t[T5_MLX], low_l + t[T5_LEX]);
        out[4] = log_add_sel(mid + t[T5_MLY], up_l + t[T5_LEY]);
    }

    // EM expectations: the 13 transitions (register k -> lane frm*5 + to,
    // in _Dna5Spec.EXP_LANES' order) and 20 accumulators to*4 + by
    static constexpr int NLANE = 13, NACC = 20;
    __host__ __device__ static constexpr int lane(int k) {
        constexpr int L[NLANE] = {0, 5, 10, 15, 20, 1, 6, 3, 18, 2, 12, 4,
                                  24};
        return L[k];
    }

    // _Dna5Spec.exp_probs_w + accumulate_exp at one cell
    __device__ __forceinline__ static void exp_probs(
            const float* t, const Emissions& e, const float* xb, int X,
            int x, float y, const float* f0m, const float* f1m,
            const float* f1a, const float* b, float total, bool m,
            float* acc, float* col, size_t row_stride);
};

// vanilla scalar order (pallas_fb.py VA_YM, VA_YY) and x-feature rows
enum { VA_YM, VA_YY, VANILLA_NS };
enum { LA_MX = 8, LA_XX, LA_MM, LA_XM, LA_MY };

// _VanillaSpec (pallas_fb.py:456-517): per-column transitions from the
// k-mer skip bins (rows 8-12), a silent gap-X, Gaussian level x
// inverse-Gaussian noise emissions
struct Vanilla : SignalRows {
    static constexpr int S = 3, NS = VANILLA_NS, NXF = 13;

    // the transitions into M and X at x + 1 are column x + 1's (rows
    // LA_MX .. LA_XM), M -> Y column x's
    static constexpr bool COL_TRANS = true;
    __host__ __device__ static constexpr bool row_at_next(int i) {
        return i >= LA_MX && i <= LA_XM;
    }

    // Gaussian level x inverse-Gaussian noise, written once for both
    // forms: g(v, i) is the Gaussian of v under model rows i (mean) and
    // i + 1 (sd), ig(v, i) the inverse Gaussian under rows i (mean) and
    // i + 1 (lambda)
    template <class Gauss, class InvGauss>
    __device__ __forceinline__ static Emissions emissions_with(
            float mean, float noise, Gauss g, InvGauss ig) {
        Emissions e;
        e.match = g(mean, 0) + ig(noise, 2);
        e.gap_y = g(mean, 4) + ig(noise, 6);
        return e;
    }

    __device__ __forceinline__ static Emissions emissions_at(
            const float* xb, const float* yb, int X, int Y, int x,
            int ycol) {
        return emissions_with(
            yb[ycol], yb[Y + ycol],
            [&](float v, int i) {
                return gauss(v, xb[i * X + x], xb[(i + 1) * X + x]);
            },
            [&](float v, int i) {
                return inv_gauss(v, xb[i * X + x], xb[(i + 1) * X + x]);
            });
    }

    // the select templates' form: gauss_sel and inv_gauss_sel on the kept
    // logs of the sd and lambda rows, the noise's log taken once a cell
    __device__ __forceinline__ static Emissions emissions_in(
            const float* in, const float* lsd) {
        const float lnoise = logf(in[1]);
        return emissions_with(
            in[0], in[1],
            [&](float v, int i) {
                return gauss_sel(v, in[YR + i], in[YR + i + 1], lsd[i / 2]);
            },
            [&](float v, int i) {
                return inv_gauss_sel(v, in[YR + i], in[YR + i + 1],
                                     lsd[i / 2], lnoise);
            });
    }

    // _VanillaSpec.fwd_update_w: the transitions of column x, written
    // once for both log-adds (LA: LogAddBranch, LogAddSel); row(i) the
    // transition row i at x (the forward reads no row at the next column)
    template <class LA, class Rows>
    __device__ __forceinline__ static void fwd_update_with(
            const float* t, Rows row, const float* p1m, const float* p1a,
            const float* p2m, const Emissions& e, float* out) {
        out[0] = LA::add3(p2m[0] + row(LA_MM), p2m[1] + row(LA_XM),
                          p2m[2] + t[VA_YM])
                 + e.match;
        out[1] = LA::add(p1m[0] + row(LA_MX), p1m[1] + row(LA_XX));
        out[2] = LA::add(p1a[0] + row(LA_MY), p1a[2] + t[VA_YY])
                 + e.gap_y;
    }

    // the branch form, sm3_fwd_kernel's: no entry point launches
    // sm3_fwd_kernel<Vanilla> since K1 vanilla runs the untiled select
    // forward, but tests/test_torch_wavefront_emulated.py holds that one
    // to it
    __device__ __forceinline__ static void fwd_update(
            const float* t, const float* p1m, const float* p1a,
            const float* p2m, const Emissions& e, const float* xb, int X,
            int x, float* out) {
        fwd_update_with<LogAddBranch>(
            t, [&](int i) { return xb[i * X + x]; }, p1m, p1a, p2m, e, out);
    }

    // xr: the x rows as sm3_fwd_tiled_sel loads them
    __device__ __forceinline__ static void fwd_update_sel(
            const float* t, const float* p1m, const float* p1a,
            const float* p2m, const Emissions& e, const float* xr,
            float* out) {
        fwd_update_with<LogAddSel>(t, [&](int i) { return xr[i]; }, p1m,
                                   p1a, p2m, e, out);
    }

    // _VanillaSpec.bwd_update_w, written once for both log-adds (LA:
    // LogAddBranch, LogAddSel); row(i) the transition row i at its column
    // (row_at_next)
    template <class LA, class Rows>
    __device__ __forceinline__ static void bwd_update_with(
            const float* t, Rows row, float eg1, const float* em2p,
            const float* n1a, const float* n1p, const float* n2p,
            float* out) {
        const float mid = em2p[0] + n2p[0];
        const float up = eg1 + n1a[2];
        const float low = n1p[1];   // silent gap-X
        out[0] = LA::add3(mid + row(LA_MM), low + row(LA_MX),
                          up + row(LA_MY));
        out[1] = LA::add(mid + row(LA_XM), low + row(LA_XX));
        out[2] = LA::add(mid + t[VA_YM], up + t[VA_YY]);
    }

    __device__ __forceinline__ static void bwd_update(
            const float* t, const float* xb, int X, int x, float eg1,
            const float* em2p, const float* n1a, const float* n1p,
            const float* n2p, float* out) {
        const int xp = next_col(x, X);
        bwd_update_with<LogAddBranch>(
            t, [&](int i) { return xb[i * X + (row_at_next(i) ? xp : x)]; },
            eg1, em2p, n1a, n1p, n2p, out);
    }

    // xr: the x rows as sm3_bwd_tiled_sel loads them
    __device__ __forceinline__ static void bwd_update_sel(
            const float* t, const float* xr, float eg1, const float* em2p,
            const float* n1a, const float* n1p, const float* n2p,
            float* out) {
        bwd_update_with<LogAddSel>(t, [&](int i) { return xr[i]; }, eg1,
                                   em2p, n1a, n1p, n2p, out);
    }

    // EM expectations: no transition lanes; accumulators beta (M -> X) and
    // alpha (X -> X)
    static constexpr int NLANE = 0, NACC = 2;
    __host__ __device__ static constexpr int lane(int k) { return k; }

    // _VanillaSpec.exp_probs_w + accumulate_exp at one cell
    __device__ __forceinline__ static void exp_probs(
            const float* t, const Emissions& e, const float* xb, int X,
            int x, float y, const float* f0m, const float* f1m,
            const float* f1a, const float* b, float total, bool m,
            float* acc, float* col, size_t row_stride);
};

// echelon x-feature rows (pallas_fb.py:536-541)
enum { EC_GAP_Y = 20, EC_LA_MX = 24, EC_LA_MH, EC_LA_XX, EC_LA_XH,
       EC_VALID = 27 };

// _EchelonSpec (pallas_fb.py:528-620): match0 (an extra event), match1..5
// (an event emitting 1..5 k-mers), gap-X (silent); per-column transitions
// (rows 24-27), no transition scalars.  No K3 (the reference defines no
// echelon EM) and no tiled instance.  Its K1 and K2 are the untiled forms
// of the select templates, which read the emissions from the plane of the
// emission pre-pass (EM_PLANE: sm3_emissions_kernel evaluates
// emissions_at for every cell of the batch first) and load only the skip
// logs of a cell (fwd_row, bwd_row, row_at_next).
struct Echelon : FromRows {
    static constexpr int S = 7, NS = 0, NXF = 33, YR = 8, NEM = 5, NPS = 5;
    // the pre-pass plane's leaves: the five match terms, then the gap-Y
    // term
    static constexpr int EM_PLANE = NEM + 1;
    static constexpr int NLSD = 0;
    static constexpr bool T_SHARED = false;
    // the posteriors of match1..match5
    __host__ __device__ static constexpr int post_state(int j) {
        return j + 1;
    }
    // the x rows a step loads: the forward's four skip logs at x; the
    // backward's four at next_col(x) (the transitions into x + 1) and
    // la_mh at x (match1..5 -> match0)
    __host__ __device__ static constexpr bool fwd_row(int i) {
        return i >= EC_LA_MX && i <= EC_LA_XH;
    }
    __host__ __device__ static constexpr bool row_at_next(int i) {
        return i >= EC_LA_MX && i <= EC_LA_XH;
    }
    __host__ __device__ static constexpr bool bwd_row(int i) {
        return i == EC_LA_MH;
    }
    // no expectations: the register array of the template keeps length
    // 1, no accumulator rows
    static constexpr int NLANE = 0, NACC = 0;

    // per n = 1..5: the exact fold of the offsets 0..n-1's Gaussian level x
    // inverse-Gaussian noise terms from 0.0 (the reference's quirk,
    // impl/stateMachine.c:533), minus log n (f32) where n k-mers fit, plus
    // dur_n; the gap-Y term of the first k-mer plus dur_0
    __device__ __forceinline__ static EmissionsN<NEM> emissions_at(
            const float* xb, const float* yb, int X, int Y, int x,
            int ycol) {
        constexpr float LOG_N[NEM] = {0.0f, 0.693147182f, 1.09861231f,
                                      1.38629436f, 1.60943794f};
        const float mean = yb[6 * Y + ycol];
        const float noise = yb[7 * Y + ycol];
        EmissionsN<NEM> e;
        float acc = 0.0f;
#pragma unroll
        for (int i = 0; i < NEM; ++i) {
            const float term =
                gauss(mean, xb[(4 * i) * X + x], xb[(4 * i + 1) * X + x])
                + inv_gauss(noise, xb[(4 * i + 2) * X + x],
                            xb[(4 * i + 3) * X + x]);
            acc = exact_log_add(acc, term);
            const float e_n = xb[(EC_VALID + i + 1) * X + x] > 0.5f
                                  ? acc - LOG_N[i] : CPECAN_NEG;
            e.match[i] = fmaxf(e_n + yb[(i + 1) * Y + ycol], CPECAN_NEG);
        }
        const float e_scaled =
            gauss(mean, xb[EC_GAP_Y * X + x], xb[(EC_GAP_Y + 1) * X + x])
            + inv_gauss(noise, xb[(EC_GAP_Y + 2) * X + x],
                        xb[(EC_GAP_Y + 3) * X + x]);
        e.gap_y = fmaxf(e_scaled + yb[ycol], CPECAN_NEG);
        return e;
    }

    // _EchelonSpec.fwd_update_w with log_add_sel, its grouping kept: the
    // sources of every match_n fold once (one transition for all n); xr
    // the x rows at x (fwd_row).  Reads p2m[0..6], p1a[1..5], p1m[1..6]
    __device__ __forceinline__ static void fwd_update_sel(
            const float* p1m, const float* p1a, const float* p2m,
            const EmissionsN<NEM>& e, const float* xr, float* out) {
        const float la_mx = xr[EC_LA_MX];
        const float la_mh = xr[EC_LA_MH];
        const float la_xx = xr[EC_LA_XX];
        const float la_xh = xr[EC_LA_XH];
        float src_m = p2m[0];
        src_m = log_add_sel(src_m, p2m[1]);
        src_m = log_add_sel(src_m, p2m[2]);
        src_m = log_add_sel(src_m, p2m[3]);
        src_m = log_add_sel(src_m, p2m[4]);
        src_m = log_add_sel(src_m, p2m[5]);
        const float mid = log_add_sel(src_m + la_mh, p2m[6] + la_xh);
        float src_u = p1a[1];
        src_u = log_add_sel(src_u, p1a[2]);
        src_u = log_add_sel(src_u, p1a[3]);
        src_u = log_add_sel(src_u, p1a[4]);
        src_u = log_add_sel(src_u, p1a[5]);
        out[0] = src_u + la_mh + e.gap_y;
        out[1] = mid + e.match[0];
        out[2] = mid + e.match[1];
        out[3] = mid + e.match[2];
        out[4] = mid + e.match[3];
        out[5] = mid + e.match[4];
        float src_l = p1m[1];
        src_l = log_add_sel(src_l, p1m[2]);
        src_l = log_add_sel(src_l, p1m[3]);
        src_l = log_add_sel(src_l, p1m[4]);
        src_l = log_add_sel(src_l, p1m[5]);
        out[6] = log_add_sel(src_l + la_mx, p1m[6] + la_xx);
    }

    // _EchelonSpec.bwd_update_w with log_add_sel, its grouping kept: em2p
    // the per-n terms at (d+2, x+1), eg1 the gap-Y term at (d+1, x); the
    // transitions into x+1 are column x+1's (xrp, the rows at next_col(x)),
    // into match0 column x's (xr, the rows at x).  Reads n1a[0], n1p[6],
    // n2p[1..5]
    __device__ __forceinline__ static void bwd_update_sel(
            const float* xr, const float* xrp, float eg1, const float* em2p,
            const float* n1a, const float* n1p, const float* n2p,
            float* out) {
        float mid = em2p[0] + n2p[1];
        mid = log_add_sel(mid, em2p[1] + n2p[2]);
        mid = log_add_sel(mid, em2p[2] + n2p[3]);
        mid = log_add_sel(mid, em2p[3] + n2p[4]);
        mid = log_add_sel(mid, em2p[4] + n2p[5]);
        const float low = n1p[6];
        const float up = eg1 + n1a[0];
        const float la_mh_p = xrp[EC_LA_MH];
        out[0] = mid + la_mh_p;
        // match1..5 share one outgoing fan
        const float bm = log_add3_sel(mid + la_mh_p, low + xrp[EC_LA_MX],
                                      up + xr[EC_LA_MH]);
        out[1] = bm;
        out[2] = bm;
        out[3] = bm;
        out[4] = bm;
        out[5] = bm;
        out[6] = log_add_sel(mid + xrp[EC_LA_XH], low + xrp[EC_LA_XX]);
    }
};

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
template <int S>
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

// The emissions of diagonal dd at x, which is lane j of dd's own window
// (x = win[dd] + j): the spec's own from the feature rows, or for a
// streamed spec the stream's entry est[dd, j] of this read (eb), CPECAN_NEG
// where j falls outside [0, W) (emissions_at, pallas_fb.py:977-1000).
template <class Spec>
__device__ __forceinline__ auto cell_emissions(const float* xb,
                                               const float* yb,
                                               const float* eb, int X, int Y,
                                               int C, int dd, int x, int j,
                                               int R, int W) {
    if constexpr (Spec::STREAMED) {
        const float v = (j >= 0 && j < W)
                            ? eb[static_cast<size_t>(dd) * R * W + j]
                            : CPECAN_NEG;
        return Emissions{v, v};
    } else {
        return Spec::emissions_at(xb, yb, X, Y, x, C - dd + x);
    }
}

// Every kernel must launch with W threads for any W the wrappers accept
// (at most CPECAN_MAX_W).  One SM's 65,536 registers give 64 a thread at
// 1024 threads; uncapped, the expectation instances compile to 106-114 and
// their launches are refused past ~600 lanes.  The build caps every
// instance at 64 (-maxrregcount, ops/cuda_build.py), which leaves the
// instances that need fewer as they were.
#define CPECAN_MAX_W 1024

template <class Spec>
__global__ void sm3_fwd_kernel(const float* __restrict__ scal,
                               const int* __restrict__ win,
                               const float* __restrict__ xf,
                               const float* __restrict__ yf,
                               const float* __restrict__ basef,
                               const float* __restrict__ widthf,
                               const float* __restrict__ est,
                               float* __restrict__ fwd, int R, int W, int ND,
                               int NDp, int X, int C, int Y) {
    constexpr int S = Spec::S;
    constexpr int NSCAL = Spec::NS + 3 * S;
    constexpr int START = Spec::NS;
    // ring [3 slots][S][W]: diagonal d in d % 3
    extern __shared__ float ring[];
    const int b = blockIdx.x;
    const int g = b / R;
    const int r = b - g * R;
    const int l = threadIdx.x;
    float t[NSCAL];
#pragma unroll
    for (int i = 0; i < NSCAL; ++i) t[i] = scal[i];
    const int* wg = win + static_cast<size_t>(g) * NDp;
    const float* xb = xf + static_cast<size_t>(b) * Spec::NXF * X;
    const float* yb = yf + static_cast<size_t>(b) * Spec::YR * Y;
    const float* base = basef + static_cast<size_t>(b) * NDp;
    const float* width = widthf + static_cast<size_t>(b) * NDp;
    // this read's stream est[g, :, r, :] (streamed specs only)
    const float* eb = Spec::STREAMED
                          ? est + static_cast<size_t>(g) * (ND + 3) * R * W
                                + static_cast<size_t>(r) * W
                          : nullptr;
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
        float p1m[S], p1a[S], p2m[S];
#pragma unroll
        for (int i = 0; i < S; ++i) {
            p1m[i] = shifted(p1 + i * W, l, s1 - 1, W);
            p1a[i] = shifted(p1 + i * W, l, s1, W);
            p2m[i] = shifted(p2 + i * W, l, s2 - 1, W);
        }
        const auto e = cell_emissions<Spec>(xb, yb, eb, X, Y, C, d, x, l, R,
                                            W);
        float nv[S];
        Spec::fwd_update(t, p1m, p1a, p2m, e, xb, X, x, nv);
        const bool mask = in_band(x, base[d], width[d]);
        float* od = out + static_cast<size_t>(d) * plane_d;
#pragma unroll
        for (int i = 0; i < S; ++i) {
            const float v = mask ? nv[i] : CPECAN_NEG;
            cur[i * W + l] = v;
            od[static_cast<size_t>(i) * R * W] = v;
        }
        __syncthreads();
    }
}

// strawman transition lanes (frm * 3 + to); lane 5 (X -> Y) stays 0
enum { L_MM = 0, L_OX = 1, L_OY = 2, L_XM = 3, L_EX = 4, L_YM = 6, L_SX = 7,
       L_EY = 8 };

__device__ __forceinline__ float exp_prob(float logp, float total) {
    return expf(fminf(logp - total, 10.0f));
}

__device__ __forceinline__ void Strawman::exp_probs(
        const float* t, const Emissions& e, const float* xb, int X, int x,
        float, const float* f0m, const float* f1m, const float* f1a,
        const float* b, float total, bool m, float* acc, float* col,
        size_t) {
    // middle: (tt-2, x-1) -> M; lower: (tt-1, x-1) -> X; upper: (tt-1, x)
    // -> Y
    const float e_gapx = xb[GAP_X * X + x];
    const float mid = e.match + b[0];
    const float low = e_gapx + b[1];
    const float up = e.gap_y + b[2];
    float p[NLANE];
    p[L_MM] = exp_prob(f0m[0] + t[T_MM] + mid, total);
    p[L_XM] = exp_prob(f0m[1] + t[T_XM] + mid, total);
    p[L_YM] = exp_prob(f0m[2] + t[T_YM] + mid, total);
    p[L_OX] = exp_prob(f1m[0] + t[T_OX] + low, total);
    p[L_EX] = exp_prob(f1m[1] + t[T_EX] + low, total);
    p[L_SX] = exp_prob(f1m[2] + t[T_SX] + low, total);
    p[L_OY] = exp_prob(f1a[0] + t[T_OY] + up, total);
    p[L_EY] = exp_prob(f1a[2] + t[T_EY] + up, total);
    p[5] = 0.0f;
    const float mf = m ? 1.0f : 0.0f;
#pragma unroll
    for (int k = 0; k < NLANE; ++k) acc[k] += p[k] * mf;
    col[0] += (p[L_OX] + p[L_EX] + p[L_SX]) * mf;
}

__device__ __forceinline__ void Sm4::exp_probs(
        const float* t, const Emissions& e, const float* xb, int X, int x,
        float, const float* f0m, const float* f1m, const float* f1a,
        const float* b, float total, bool m, float* acc, float* col,
        size_t) {
    const float e_gapx = xb[GAP_X * X + x];
    // p[k] in EXP_LANES order: mm sxm sym lxm | msx sxsx | mlx lxlx sylx |
    // msy sysy
    float p[NLANE];
    // middle: (tt-2, x-1) -> M
    const float mid = e.match + b[0];
    p[0] = exp_prob(f0m[0] + t[T4_MM] + mid, total);
    p[1] = exp_prob(f0m[1] + t[T4_MSX] + mid, total);
    p[2] = exp_prob(f0m[2] + t[T4_MSY] + mid, total);
    p[3] = exp_prob(f0m[3] + t[T4_MLX] + mid, total);
    // lower: (tt-1, x-1) -> shortGapX / longGapX
    const float low_s = e_gapx + b[1];
    const float low_l = e_gapx + b[3];
    p[4] = exp_prob(f1m[0] + t[T4_SOX] + low_s, total);
    p[5] = exp_prob(f1m[1] + t[T4_SEX] + low_s, total);
    p[6] = exp_prob(f1m[0] + t[T4_LOX] + low_l, total);
    p[7] = exp_prob(f1m[3] + t[T4_LEX] + low_l, total);
    p[8] = exp_prob(f1m[2] + t[T4_LSX] + low_l, total);
    // upper: (tt-1, x) -> shortGapY
    const float up = e.gap_y + b[2];
    p[9] = exp_prob(f1a[0] + t[T4_SOY] + up, total);
    p[10] = exp_prob(f1a[2] + t[T4_SEY] + up, total);
    const float mf = m ? 1.0f : 0.0f;
#pragma unroll
    for (int k = 0; k < NLANE; ++k) acc[k] += p[k] * mf;
    // the k-mer gap counter: the shortGapX target only
    col[0] += (p[4] + p[5]) * mf;
}

__device__ __forceinline__ void Dna5::exp_probs(
        const float* t, const Emissions& e, const float* xb, int X, int x,
        float y, const float* f0m, const float* f1m, const float* f1a,
        const float* b, float total, bool m, float* acc, float* col,
        size_t row_stride) {
    const float e_gapx = xb[GAP_X * X + x];
    // p[k] in EXP_LANES order: mm sxm sym lxm lym | msx sxsx mlx lxlx |
    // msy sysy mly lyly
    float p[NLANE];
    // middle: (tt-2, x-1) -> M
    const float mid = e.match + b[0];
    p[0] = exp_prob(f0m[0] + t[T5_MM] + mid, total);
    p[1] = exp_prob(f0m[1] + t[T5_MSX] + mid, total);
    p[2] = exp_prob(f0m[2] + t[T5_MSY] + mid, total);
    p[3] = exp_prob(f0m[3] + t[T5_MLX] + mid, total);
    p[4] = exp_prob(f0m[4] + t[T5_MLY] + mid, total);
    // lower: (tt-1, x-1) -> shortGapX / longGapX
    const float low_s = e_gapx + b[1];
    const float low_l = e_gapx + b[3];
    p[5] = exp_prob(f1m[0] + t[T5_SOX] + low_s, total);
    p[6] = exp_prob(f1m[1] + t[T5_SEX] + low_s, total);
    p[7] = exp_prob(f1m[0] + t[T5_LOX] + low_l, total);
    p[8] = exp_prob(f1m[3] + t[T5_LEX] + low_l, total);
    // upper: (tt-1, x) -> shortGapY / longGapY
    const float up_s = e.gap_y + b[2];
    const float up_l = e.gap_y + b[4];
    p[9] = exp_prob(f1a[0] + t[T5_SOY] + up_s, total);
    p[10] = exp_prob(f1a[2] + t[T5_SEY] + up_s, total);
    p[11] = exp_prob(f1a[0] + t[T5_LOY] + up_l, total);
    p[12] = exp_prob(f1a[4] + t[T5_LEY] + up_l, total);
    const float mf = m ? 1.0f : 0.0f;
#pragma unroll
    for (int k = 0; k < NLANE; ++k) acc[k] += p[k] * mf;
    // the y base's rows only (to * 4 + by): the others' contributions,
    // where(y == by, p_to, 0) * m, are +0.0; out of band all are
    int by = -1;
    if (y == 0.0f) by = 0;
    if (y == 1.0f) by = 1;
    if (y == 2.0f) by = 2;
    if (y == 3.0f) by = 3;
    if (m && by >= 0) {
        // the mass into each state, summed in the JAX order
        const float p_to[5] = {p[0] + p[1] + p[2] + p[3] + p[4],
                               p[5] + p[6], p[9] + p[10], p[7] + p[8],
                               p[11] + p[12]};
        // an atomic add (a reduction: nothing waits for it) where the
        // template read-modify-wrote the column; the per-diagonal barrier
        // still orders each column's adds.  The f32 atomic flushes a
        // denormal term to 0, which parity.KERNEL_GAPX_ATOL allows
#pragma unroll
        for (int to = 0; to < 5; ++to)
            atomicAdd(col + (to * 4 + by) * row_stride, p_to[to] * mf);
    }
}

__device__ __forceinline__ void Vanilla::exp_probs(
        const float*, const Emissions&, const float* xb, int X, int x,
        float, const float*, const float* f1m, const float*, const float* b,
        float total, bool m, float*, float* col, size_t row_stride) {
    // lower: (tt-1, x-1) -> shortGapX at x, silent, with column x's
    // transitions
    const float low = b[1];
    const float p_beta = exp_prob(f1m[0] + xb[LA_MX * X + x] + low, total);
    const float p_alpha = exp_prob(f1m[1] + xb[LA_XX * X + x] + low, total);
    const float mf = m ? 1.0f : 0.0f;
    col[0] += p_beta * mf;
    col[row_stride] += p_alpha * mf;
}

// Posterior transition mass into target diagonal tt at x = wt + l (each
// spec's exp_probs_w + accumulate_exp): sources fm = fwd[tt - 2] at window
// wm (nullptr for target 1: no middle source) and fl = fwd[tt - 1] at
// window wl, both shared-memory slots [S][W]; bt the target's backward
// slot [S][W] (raw), read as NEG where ``cut``.  With ``carried`` the JAX
// kernel takes the target's emissions from last step's carry at window wl,
// so lanes past that window read NEG there, and here (a streamed spec's
// carry is the stream of tt realigned to wl, so the same); the y element
// (dna5) is read fresh.  acc the spec's per-thread transition sums, rows its
// NACC accumulator rows of this read (row j at rows + j * row_stride).
// exp_target_with takes the target's emissions e as given (sm3_bwd_tiled_sel
// reads them from its carry ring, EXP_CARRY), exp_target computes them.
template <class Spec>
__device__ __forceinline__ void exp_target_with(
        const float* t, const float* xb, const float* yb, int X, int C,
        int tt, int wt, const Emissions& e, const float* fm, int wm,
        const float* fl, int wl, const float* bt, bool cut, float total,
        bool m, int l, int W, float* acc, float* rows, size_t row_stride) {
    constexpr int S = Spec::S;
    const int x = wt + l;
    const int ycol = C - tt + x;
    const int sm = wt - wm - 1;
    const int s1 = wt - wl;
    float f0m[S], f1m[S], f1a[S], b[S];
#pragma unroll
    for (int i = 0; i < S; ++i) {
        f0m[i] = fm ? shifted(fm + i * W, l, sm, W) : CPECAN_NEG;
        f1m[i] = shifted(fl + i * W, l, s1 - 1, W);
        f1a[i] = shifted(fl + i * W, l, s1, W);
        b[i] = cut ? CPECAN_NEG : bt[i * W + l];
    }
    Spec::exp_probs(t, e, xb, X, x, yb[ycol], f0m, f1m, f1a, b, total, m,
                    acc, rows + x, row_stride);
}

template <class Spec>
__device__ __forceinline__ void exp_target(
        const float* t, const float* xb, const float* yb, const float* eb,
        int X, int Y, int C, int R, int tt, int wt, const float* fm, int wm,
        const float* fl, int wl, const float* bt, bool cut, float total,
        bool m, bool carried, int l, int W, float* acc, float* rows,
        size_t row_stride) {
    const int x = wt + l;
    Emissions e = cell_emissions<Spec>(xb, yb, eb, X, Y, C, tt, x, l, R, W);
    if (carried) {
        const int j = l + (wt - wl);
        if (j < 0 || j >= W) e.match = e.gap_y = CPECAN_NEG;
    }
    exp_target_with<Spec>(t, xb, yb, X, C, tt, wt, e, fm, wm, fl, wl, bt,
                          cut, total, m, l, W, acc, rows, row_stride);
}

// a target's emissions from a slot of sm3_bwd_tiled_sel's em ring ([2][W]:
// the match leaf, then the gap-Y term) at lane l + s, CPECAN_NEG outside
// [0, W): what exp_target computes with ``carried``, where the carry's
// window lies s lanes after the target's
__device__ __forceinline__ Emissions carried_emissions(const float* slot,
                                                       int l, int s, int W) {
    return Emissions{shifted(slot, l, s, W), shifted(slot + W, l, s, W)};
}

template <class Spec, bool WITH_EXP>
__global__ void sm3_bwd_kernel(const float* __restrict__ scal,
                               const int* __restrict__ win,
                               const float* __restrict__ xf,
                               const float* __restrict__ yf,
                               const float* __restrict__ basef,
                               const float* __restrict__ widthf,
                               const float* __restrict__ seedf,
                               const float* __restrict__ raggedf,
                               const float* __restrict__ fwd,
                               const float* __restrict__ est,
                               float* __restrict__ posts,
                               float* __restrict__ totals,
                               float* __restrict__ trans,
                               float* __restrict__ accf, int R, int W,
                               int ND, int NDp, int X, int C, int Y) {
    constexpr int S = Spec::S;
    constexpr int NEM = Spec::NEM;
    constexpr int NSCAL = Spec::NS + 3 * S;
    constexpr int END = Spec::NS + S, RAGGED_END = Spec::NS + 2 * S;
    // ring [3 slots][S][W]: bwd[d] in slot d % 3 (raw, at window w_d);
    // em [2 slots][NEM][W]: the match emission's leaves of diagonal d + 1 at
    // x = w_d + l in slot d & 1; red [32]: reduction scratch; with the
    // expectations, fsh [3 slots][S][W]: fwd[d] in slot d % 3
    extern __shared__ float smem[];
    float* ring = smem;
    float* em = smem + 3 * S * W;
    float* red = em + 2 * NEM * W;
    float* fsh = red + 32;
    const int b = blockIdx.x;
    const int g = b / R;
    const int r = b - g * R;
    const int l = threadIdx.x;
    float t[NSCAL];
#pragma unroll
    for (int i = 0; i < NSCAL; ++i) t[i] = scal[i];
    const int* wg = win + static_cast<size_t>(g) * NDp;
    const float* xb = xf + static_cast<size_t>(b) * Spec::NXF * X;
    const float* yb = yf + static_cast<size_t>(b) * Spec::YR * Y;
    const float* base = basef + static_cast<size_t>(b) * NDp;
    const float* width = widthf + static_cast<size_t>(b) * NDp;
    const float* seed = seedf + static_cast<size_t>(b) * NDp;
    const float* ragged = raggedf + static_cast<size_t>(b) * NDp;
    const float* eb = Spec::STREAMED
                          ? est + static_cast<size_t>(g) * (ND + 3) * R * W
                                + static_cast<size_t>(r) * W
                          : nullptr;
    const size_t fplane_d = static_cast<size_t>(S) * R * W;
    const float* fin = fwd + static_cast<size_t>(g) * (ND + 1) * fplane_d
                       + static_cast<size_t>(r) * W + l;
    // posts[g, d, j, r, l]
    const size_t pstate = static_cast<size_t>(R) * W;
    const size_t pplane_d = Spec::NPS * pstate;
    float* pout = posts + static_cast<size_t>(g) * (ND + 1) * pplane_d
                  + static_cast<size_t>(r) * W + l;

    // diagonal 0 is never swept: zero it for every posterior state (the
    // saturated-extraction fallback reads the whole plane)
#pragma unroll
    for (int j = 0; j < Spec::NPS; ++j) pout[j * pstate] = 0.0f;
    // bwd[ND + 1] = bwd[ND + 2] = NEG; em carry = emissions(ND + 2) at the
    // window of ND + 1
#pragma unroll
    for (int i = 0; i < S; ++i) {
        ring[(((ND + 1) % 3) * S + i) * W + l] = CPECAN_NEG;
        ring[(((ND + 2) % 3) * S + i) * W + l] = CPECAN_NEG;
    }
    {
        const int x = wg[ND + 1] + l;
        const auto e = cell_emissions<Spec>(xb, yb, eb, X, Y, C, ND + 2, x,
                                            x - wg[ND + 2], R, W);
#pragma unroll
        for (int k = 0; k < NEM; ++k)
            em[(((ND + 1) & 1) * NEM + k) * W + l] = em_leaf(e, k);
    }
    float total = CPECAN_NEG;
    bool cut_prev = false;  // the seed cut of diagonal d + 1
    // per-lane transition sums (expectations; a machine without lanes
    // keeps one unused register)
    float acc[Spec::NLANE > 0 ? Spec::NLANE : 1];
    // this read's accumulator rows: acc[g, j, r, :] at rows + j * R * X
    const size_t row_stride = static_cast<size_t>(R) * X;
    float* rows = nullptr;
    if constexpr (WITH_EXP) {
#pragma unroll
        for (int k = 0; k < Spec::NLANE; ++k) acc[k] = 0.0f;
        rows = accf + (static_cast<size_t>(g) * Spec::NACC * R + r) * X;
        for (int j = 0; j < Spec::NACC; ++j)
            for (int c = l; c < X; c += W) rows[j * row_stride + c] = 0.0f;
        // fwd[ND + 1] = NEG: the lower/upper source of target ND + 2
#pragma unroll
        for (int i = 0; i < S; ++i)
            fsh[(((ND + 1) % 3) * S + i) * W + l] = CPECAN_NEG;
    }
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
        float n1a[S], n1p[S], n2p[S];
#pragma unroll
        for (int i = 0; i < S; ++i) {
            n1a[i] = cut1 ? CPECAN_NEG : shifted(n1 + i * W, l, o1, W);
            n1p[i] = cut1 ? CPECAN_NEG : shifted(n1 + i * W, l, o1 + 1, W);
            n2p[i] = cut2 ? CPECAN_NEG : shifted(n2 + i * W, l, o2 + 1, W);
        }
        // emissions(d + 2) at x + 1, carried from the last step (each leaf
        // realigned alike)
        float em2p[NEM];
#pragma unroll
        for (int k = 0; k < NEM; ++k)
            em2p[k] = shifted(em + (((d + 1) & 1) * NEM + k) * W, l, o1 + 1,
                              W);
        // emissions(d + 1) at x, fresh (next step's carry)
        const auto e1 = cell_emissions<Spec>(xb, yb, eb, X, Y, C, d + 1, x,
                                             x - wg[d + 1], R, W);
        float bw[S];
        Spec::bwd_update(t, xb, X, x, e1.gap_y, em2p, n1a, n1p, n2p, bw);
        const bool mask = in_band(x, base[d], width[d]);
        // the seed's end vector, selected per state so that t keeps
        // constant indices (and stays in registers)
#pragma unroll
        for (int i = 0; i < S; ++i) {
            if (!mask) bw[i] = CPECAN_NEG;
            if (sa && mask) bw[i] = ra ? t[RAGGED_END + i] : t[END + i];
        }
        const float* fd = fin + static_cast<size_t>(d) * fplane_d;
        float f[S];
#pragma unroll
        for (int i = 0; i < S; ++i) f[i] = fd[static_cast<size_t>(i) * R * W];
        if (sa) {
            // total = masked log-sum-exp over the read's lanes
            // (pallas_fb.py _masked_lse) at its seed diagonal
            float prod = f[0] + bw[0];
#pragma unroll
            for (int i = 1; i < S; ++i) prod = log_add(prod, f[i] + bw[i]);
            const float vv = mask ? prod : CPECAN_NEG;
            const float m = block_max(vv, red);
            const float s = block_sum(mask ? expf(vv - m) : 0.0f, red);
            total = m + logf(fmaxf(s, 1e-37f));
        }
        const float xl = static_cast<float>(x);
        const bool ok = mask && xl > 0.0f && xl < static_cast<float>(d);
#pragma unroll
        for (int j = 0; j < Spec::NPS; ++j) {
            const int si = Spec::post_state(j);
            const float z = f[si] + bw[si] - total;
            pout[static_cast<size_t>(d) * pplane_d + j * pstate] =
                ok ? expf(fminf(z, 0.69f)) : 0.0f;
        }
        if constexpr (WITH_EXP) {
            // target tt = d + 3 from fwd[d + 1] and fwd[d + 2]; its
            // backward bwd[tt] is this lane's entry of the slot that
            // bwd[d] overwrites below (no other thread reads that slot in
            // this step)
            const int tt = d + 3;
            if (tt <= ND + 2) {
                const bool cut = seed[tt - 1] != 0.0f || seed[tt - 2] != 0.0f;
                const int wt = wg[tt];
                exp_target<Spec>(t, xb, yb, eb, X, Y, C, R, tt, wt,
                                 fsh + ((tt - 2) % 3) * S * W, wg[tt - 2],
                                 fsh + ((tt - 1) % 3) * S * W, wg[tt - 1],
                                 cur, cut, total,
                                 in_band(wt + l, base[tt], width[tt]), true,
                                 l, W, acc, rows, row_stride);
            }
            float* fs = fsh + (d % 3) * S * W;
#pragma unroll
            for (int i = 0; i < S; ++i) fs[i * W + l] = f[i];
        }
#pragma unroll
        for (int i = 0; i < S; ++i) cur[i * W + l] = bw[i];
#pragma unroll
        for (int k = 0; k < NEM; ++k)
            em[((d & 1) * NEM + k) * W + l] = em_leaf(e1, k);
        cut_prev = sa;
        __syncthreads();
    }
    if (l == 0) totals[b] = total;
    if constexpr (WITH_EXP) {
        // targets 3, 2 and 1.  The ring holds bwd[1], bwd[2], bwd[3] in
        // slots 1, 2, 0 and fsh holds fwd[1], fwd[2] in slots 1, 2 (NEG
        // where the diagonal lies past ND)
        const bool cut3 = seed[2] != 0.0f || seed[1] != 0.0f;
        exp_target<Spec>(t, xb, yb, eb, X, Y, C, R, 3, wg[3], fsh + S * W,
                         wg[1],
                         fsh + 2 * S * W, wg[2], ring, cut3, total,
                         in_band(wg[3] + l, base[3], width[3]), true, l, W,
                         acc, rows, row_stride);
        // fwd[0] into slot 0 (target 3 read slots 1 and 2 only)
#pragma unroll
        for (int i = 0; i < S; ++i)
            fsh[i * W + l] = fin[static_cast<size_t>(i) * R * W];
        __syncthreads();
        exp_target<Spec>(t, xb, yb, eb, X, Y, C, R, 2, wg[2], fsh, wg[0],
                         fsh + S * W, wg[1], ring + 2 * S * W,
                         seed[1] != 0.0f, total,
                         in_band(wg[2] + l, base[2], width[2]), true, l, W,
                         acc, rows, row_stride);
        __syncthreads();   // orders the accumulator columns of targets 2, 1
        // target 1: no middle source, emissions(1) fresh (not a carry)
        exp_target<Spec>(t, xb, yb, eb, X, Y, C, R, 1, wg[1], nullptr, 0,
                         fsh,
                         wg[0], ring + S * W, false, total,
                         in_band(wg[1] + l, base[1], width[1]), false, l, W,
                         acc, rows, row_stride);
        // the S*S table: the machine's lanes from their sums, the rest 0
        float* tr = trans + static_cast<size_t>(b) * S * S;
        if (l == 0)
            for (int k = 0; k < S * S; ++k) tr[k] = 0.0f;
#pragma unroll
        for (int k = 0; k < Spec::NLANE; ++k) {
            const float s = block_sum(acc[k], red);
            if (l == 0) tr[Spec::lane(k)] = s;
        }
    }
}

// ---------------------------------------------------------------------------
// The tiled kernels (K6a, K6b), designed first for the 5-state DNA machine:
// the recurrences of the templates above over tiles, computed identically,
// with a shorter step.  On the lone long pair (the
// 100 kb DNA pair: one real block of W = 128 threads, 200,704 diagonals on
// one SM, one warp per scheduler) nothing hides a stall, so a step costs
// its whole instruction stream plus whatever load it waits on (1.30 / 1.79
// us a diagonal on the H100 with sm3_fwd_kernel's and sm3_bwd_kernel's
// tiled forms).  What goes (PERF.md section 6):
//  - divergence: the eight log-adds of a step are log_add_sel, one Horner
//    form on selected coefficients, where lanes of a warp at different
//    gaps walked up to four cubics of the branch log_add (the largest
//    cost of a step);
//  - bookkeeping: the three ring slots rotate as pointers (no % 3 a step)
//    and a down-counter finds the tile boundary (no % TD); the backward's
//    end vectors sit in shared memory, read on seed diagonals only;
//  - waits on memory: the backward's one DRAM read a step, the posterior
//    state's fwd plane entry, is copied F_AHEAD diagonals ahead into
//    shared memory with cp.async (each lane its own entry, one group a
//    step; the other four states' entries are read on the seed diagonal
//    only), and the lines of the band scalars (both kernels) and of the
//    rows (the backward) are prefetched into L1 L1_AHEAD diagonals ahead.
//    The rest of a cell's inputs are L1 hits, loaded unconditionally at the
//    top of the step so that they overlap the log-add chain; staging all
//    of them in shared memory with cp.async made K6a slower and K6b no
//    faster.
// The re-centering, one block per read, one thread per lane, the
// three-slot carried ring and one barrier per diagonal are as in the
// templates above.
// The strawman's backward (K6b strawman: the 64 long signal reads, 8
// blocks of 8 reads, 28,672 diagonals; 2.03 us a diagonal with
// sm3_bwd_kernel's tiled form on an H100 80GB HBM3 at 700 W) runs on the
// same template.
// Its step adds four Gaussians, each an IEEE division and a logf of its sd
// row: the logs of a lane's column are kept in registers while the window
// stays (col_logs again only on the steps where it moves, a block-uniform
// branch), the guard is the select gauss_sel, and the transitions are read
// from shared memory (T_SHARED), which keeps the step at 64 registers
// without a spill.  The strawman's forward (K6a strawman, the same reads;
// 1.49 us a diagonal with the template above on the same card) runs on the
// forward template with the same traits: its four Gaussians, the column
// logs taken first for diagonal 0's window (col_logs_at) and again on the
// steps where the window moves, the scalars in shared memory, the five
// log-adds of Strawman::fwd_update_with as log_add_sel.  K2 for the 5-state
// DNA machine (the realigner's 2 kb pairs, ND ~4,000), whose step was the
// one K6b dna5 had before its redesign, is the untiled posterior form of
// the backward template.  So are K2 strawman and K2 vanilla (the signal
// posterior path's 64-read chunks: 64 blocks of 128 threads, 1,700
// diagonals; ~1,950 and ~2,020 ns a diagonal on sm3_bwd_kernel on the same
// card), with the traits of their K6b below and none of its tile
// bookkeeping, and K2 hdp (bench.py's HDP chunk, the same geometry; ~1,530
// ns a diagonal on sm3_bwd_kernel on the same card), which computes no
// emission: it reads the stream (STREAMED, below: rows staged ahead into
// shared memory) and loads the gap-X row alone, without the column logs
// its SignalRows traits would take.  K1 vanilla and K1 strawman (the same
// chunks; ~1,510 and ~1,380 ns a diagonal on sm3_fwd_kernel) are the
// untiled form of the forward template with their K6a's traits, and so is
// K1 dna5 (the realigner's 32-pair chunks: 32 blocks of 128 threads, one
// warp per scheduler on 32 of the 132 SMs, ~4,000 diagonals; ~1,190 ns a
// diagonal on sm3_fwd_kernel): the select step, its band scalars
// prefetched into L1, its scalars in registers.  The fourState and
// vanilla backwards (K6b sm4 and K6b vanilla, the same long reads; 2.33
// and 2.05 us a diagonal with sm3_bwd_kernel's tiled form on the same
// card) run on the backward template with the signal machines' traits
// (SignalRows: the column logs and the shared transitions): sm4 with the
// strawman's emissions and the seven log-adds of Sm4::bwd_update_with;
// vanilla, whose transitions into M and X come from the next column's
// rows (COL_TRANS, row_at_next), with
// gauss_sel and inv_gauss_sel on the kept logs of its sd and lambda rows
// and the noise's log taken once a cell.  Their forwards (K6a sm4 and K6a
// vanilla, the same reads; 1.78 and 1.58 us a diagonal with
// sm3_fwd_kernel's tiled form on the same card) run on the forward template
// with the same traits: sm4 with the seven log-adds of
// Sm4::fwd_update_with (23 scalars in shared memory, its ring of four
// states past 48 KB at W = 1024); vanilla with all x rows handed to
// Vanilla::fwd_update_with (tiled_fwd_update), every transition read at x.
// K1 and K2 sm4 (the fourState pipeline's chunks: 64 blocks of 256
// threads, ~1,640 diagonals; ~1,840 and ~2,390 ns a diagonal on
// sm3_fwd_kernel and sm3_bwd_kernel on the same card) are the untiled
// forms of both templates with those traits.  K1 and K2 echelon
// (bench.py's echelon chunk: 32 blocks of 128 threads, 1,700 diagonals;
// 4.7 and 5.3 us a diagonal on sm3_fwd_kernel and sm3_bwd_kernel on the
// same card) run the untiled forms of both templates.  Their emissions
// (18 logf and 18 divisions a cell, on each step's one dependent chain,
// and the backward's evaluated again) come from the plane of
// sm3_emissions_kernel, computed first on every SM (EM_PLANE); each step
// stages its plane slot with cp.async (the forward F_AHEAD diagonals
// ahead, the backward E_AHEAD with its five posterior states' fwd
// entries: both fit 227 KB at W = 1024), loads the four skip logs alone
// (fwd_row, bwd_row, row_at_next) and folds with log_add_sel (15 and 7);
// the backward reads the carried match terms across lanes from the
// plane's staged slot of d + 1, so it writes no em ring.
//
// Two rules keep every other instance's SASS as it was.  Both templates
// take one pointer slot, aux, after the fwd plane: the tiled forms' shifts
// (the forward writes them, the backward reads them), the untiled forms'
// emission plane (EM_PLANE specs), else null; an added parameter, even one
// no instance reads, changed the register allocation of the untiled dna5
// backward instances (same instructions).  And the backward names its
// form's constants without a constexpr local that some instance leaves
// unread (the same effect): they are written out or come from functions at
// namespace scope (bwd_ahead, em_ring_leaves).

// 4-byte asynchronous copy global -> shared (sm_80+), and its groups
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a hint to bring p's line into L1 (no register waits on it)
__device__ __forceinline__ void prefetch_l1(const void* p) {
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p));
}

// how many diagonals ahead sm3_bwd_tiled_sel copies its fwd plane entries
// (the posterior forms, and WITH_EXP), and how far ahead the select
// kernels prefetch the lines of their band scalars (one line holds 32
// diagonals) and the backwards those of their rows.  E_AHEAD: how far
// ahead the backward of a spec with an emission plane copies its fwd
// entries and plane slots (ring, five staged fwd entries and the plane's
// slots must fit 227 KB at W = 1024); the forward stages its plane slots
// F_AHEAD ahead
constexpr int F_AHEAD = 3, X_AHEAD = 1, L1_AHEAD = 64, E_AHEAD = 1;

// the staging depth of sm3_bwd_tiled_sel's fwd entries (and plane slots)
template <class Spec, bool WITH_EXP>
__host__ __device__ constexpr int bwd_ahead() {
    return WITH_EXP ? X_AHEAD : Spec::EM_PLANE > 0 ? E_AHEAD : F_AHEAD;
}

// the fwd state whose entries sm3_bwd_tiled_sel stages in slot i: all S
// states WITH_EXP, else the posterior states
template <class Spec, bool WITH_EXP>
__host__ __device__ constexpr int staged_state(int i) {
    return WITH_EXP ? i : Spec::post_state(i);
}

// the staged slot of fwd state i in a posterior form, -1 if the state is
// no posterior state (its entry is read on seed diagonals only)
template <class Spec>
__host__ __device__ constexpr int post_slot(int i) {
    for (int j = 0; j < Spec::NPS; ++j)
        if (Spec::post_state(j) == i) return j;
    return -1;
}

// the leaves of sm3_bwd_tiled_sel's em ring: none with an emission plane
template <class Spec>
__host__ __device__ constexpr int em_ring_leaves() {
    return Spec::EM_PLANE > 0 ? 0 : Spec::NEM;
}

// whether sm3_bwd_tiled_sel's form takes its targets' emissions from the
// em ring (WITH_EXP and EXP_CARRY): then the ring has three slots, each
// with the gap-Y term after the match leaves
template <class Spec, bool WITH_EXP>
__host__ __device__ constexpr bool exp_carry() {
    return WITH_EXP && Spec::EXP_CARRY;
}

// the floats a lane keeps in one slot of sm3_bwd_tiled_sel's em ring, and
// the ring's slots
template <class Spec, bool WITH_EXP>
__host__ __device__ constexpr int em_slot_leaves() {
    return exp_carry<Spec, WITH_EXP>() ? Spec::NEM + 1
                                       : em_ring_leaves<Spec>();
}

template <class Spec, bool WITH_EXP>
__host__ __device__ constexpr int em_ring_slots() {
    return exp_carry<Spec, WITH_EXP>() ? 3 : 2;
}

// the per-lane transition sums that sm3_bwd_tiled_sel keeps in shared
// memory (exp_carry: a slab [W][NLANE], each lane its own row, which keeps
// the step within 64 registers without a spill), else in registers
template <class Spec, bool WITH_EXP>
__host__ __device__ constexpr int acc_slab_lanes() {
    return exp_carry<Spec, WITH_EXP>() ? Spec::NLANE : 0;
}

// the floats a lane keeps in sm3_bwd_tiled_sel between its fwd slots and
// its staged slots ps: a streamed spec's expectation form lays the em
// ring's third slot and the slab there (a spec that stages nothing keeps
// them at ps itself)
template <class Spec, bool WITH_EXP>
__host__ __device__ constexpr int staged_after() {
    return Spec::STREAMED && exp_carry<Spec, WITH_EXP>()
               ? em_slot_leaves<Spec, WITH_EXP>()
                     + acc_slab_lanes<Spec, WITH_EXP>()
               : 0;
}

// a target of sm3_bwd_tiled_sel's expectation form (exp_target's
// arguments; eb a streamed spec's stream, else null): with CARRY
// (exp_carry) and ``carried`` its emissions from the em ring's slot cs at
// lane l + wt - wl, and its sums at acc_s (the slab), else exp_target's
// (acc_s too with CARRY, else acc)
template <class Spec, bool CARRY>
__device__ __forceinline__ void sel_target(
        const float* t, const float* xb, const float* yb, const float* eb,
        int X, int Y, int C, int R, int tt, int wt, const float* fm, int wm,
        const float* fl, int wl, const float* bt, bool cut, float total,
        bool m, bool carried, const float* cs, int l, int W, float* acc,
        float* acc_s, float* rows, size_t row_stride) {
    if constexpr (CARRY) {
        if (carried) {
            exp_target_with<Spec>(t, xb, yb, X, C, tt, wt,
                                  carried_emissions(cs, l, wt - wl, W), fm,
                                  wm, fl, wl, bt, cut, total, m, l, W, acc_s,
                                  rows, row_stride);
        } else {
            exp_target<Spec>(t, xb, yb, eb, X, Y, C, R, tt, wt, fm, wm, fl,
                             wl, bt, cut, total, m, false, l, W, acc_s, rows,
                             row_stride);
        }
    } else {
        exp_target<Spec>(t, xb, yb, eb, X, Y, C, R, tt, wt, fm, wm, fl, wl,
                         bt, cut, total, m, carried, l, W, acc, rows,
                         row_stride);
    }
}

// the leaves a step of sm3_bwd_tiled_sel stages in its shared slots ps:
// an emission plane's, or a streamed spec's one stream row
template <class Spec>
__host__ __device__ constexpr int staged_leaves() {
    return Spec::EM_PLANE > 0 ? Spec::EM_PLANE : Spec::STREAMED ? 1 : 0;
}

// fwd[d] of state i at a seed diagonal in sm3_bwd_tiled_sel: its staged
// entry (f: all S states WITH_EXP, else the posterior states'), or the
// plane's entry fd of a state that is not staged
template <class Spec, bool WITH_EXP>
__device__ __forceinline__ float seed_fwd(const float* f, const float* fd,
                                          int i, int R, int W) {
    const int j = WITH_EXP ? i : post_slot<Spec>(i);
    return j >= 0 ? f[j] : fd[static_cast<size_t>(i) * R * W];
}

// a cell's emissions from a staged slot of the pre-pass plane ([NL][W]:
// the match terms, then the gap-Y term)
template <class Spec>
__device__ __forceinline__ EmissionsN<Spec::NEM> plane_emissions(
        const float* slot, int l, int W) {
    EmissionsN<Spec::NEM> e;
#pragma unroll
    for (int k = 0; k < Spec::NEM; ++k) e.match[k] = slot[k * W + l];
    e.gap_y = slot[Spec::NEM * W + l];
    return e;
}

// ---------------------------------------------------------------------------
// The emission pre-pass of the echelon pair (K1 and K2 echelon).  It
// replaces no TPU kernel: it is the emission half of the TPU kernels' body
// (_EchelonSpec's emissions, pallas_fb.py:528-620, which
// _sm3_forward_kernel and _sm3_backward_body_w evaluate per cell), moved
// off the serial diagonal chain.  A cell's echelon emissions
// (Echelon::emissions_at) take 18 logf, 18 IEEE divisions, 5 expf and 5
// log1pf; inside the recurrences they sat on the one dependent chain of a
// block that has one warp per scheduler (32 blocks of 128 threads on 132
// SMs for bench.py's echelon chunk), and the backward evaluated every
// diagonal's again.  Here one thread a cell, over every (diagonal, read,
// lane) of the batch, evaluates the same device function under the same
// build (--fmad=false, no fast math), so the plane equals what the
// recurrences computed before, bit for bit, on all SMs at once.
// Plane em [G, ND+3, NL, R, W] (NL = Spec::EM_PLANE: the five match terms,
// then the gap-Y term): slot d holds the emissions of diagonal d + k at x =
// win[g, d] + l, in d's own window.  k = 0: what the forward reads
// (cell_emissions(d, w_d + l)); k = 1: what the backward reads, the fresh
// emissions of (d + 1, w_d + l) and, in slot ND + 1, its first carry (ND +
// 2, w_{ND+1} + l), lanes outside the window of d + 1 included.  A slot
// whose diagonal d + k lies past ND + 2 (the last one a pass reads) holds
// CPECAN_NEG.
// Bound: the plane's bytes (NL x 4 B a cell, written once; the feature rows
// it reads are about 1/W of that) at the card's memory rate, against the
// emission arithmetic; the writes are coalesced over lanes.
template <class Spec>
__global__ void sm3_emissions_kernel(const int* __restrict__ win,
                                     const float* __restrict__ xf,
                                     const float* __restrict__ yf,
                                     float* __restrict__ em, int G, int R,
                                     int W, int ND, int NDp, int X, int C,
                                     int Y, int k) {
    constexpr int NL = Spec::EM_PLANE;
    const long long n = static_cast<long long>(G) * (ND + 3) * R * W;
    const long long i =
        static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= n) return;
    // i = ((g * (ND + 3) + d) * R + r) * W + l
    const int l = static_cast<int>(i % W);
    const long long gdr = i / W;
    const int r = static_cast<int>(gdr % R);
    const long long gd = gdr / R;
    const int d = static_cast<int>(gd % (ND + 3));
    const int g = static_cast<int>(gd / (ND + 3));
    const size_t leaf = static_cast<size_t>(R) * W;
    float* out = em + (static_cast<size_t>(gd) * NL * R + r) * W + l;
    const int dd = d + k;
    if (dd > ND + 2) {
#pragma unroll
        for (int j = 0; j < NL; ++j) out[j * leaf] = CPECAN_NEG;
        return;
    }
    const size_t b = static_cast<size_t>(g) * R + r;
    const int x = win[static_cast<size_t>(g) * NDp + d] + l;
    const auto e = Spec::emissions_at(xf + b * Spec::NXF * X,
                                      yf + b * Spec::YR * Y, X, Y, x,
                                      C - dd + x);
#pragma unroll
    for (int j = 0; j < Spec::NEM; ++j) out[j * leaf] = e.match[j];
    out[Spec::NEM * leaf] = e.gap_y;
}

// the emissions of a cell from its inputs in registers, with the spec's
// per-column logs where it keeps them
template <class Spec>
__device__ __forceinline__ Emissions tiled_emissions(const float* in,
                                                     const float* lsd) {
    if constexpr (Spec::NLSD > 0) {
        return Spec::emissions_in(in, lsd);
    } else {
        return Spec::emissions_in(in);
    }
}

// whether sm3_bwd_tiled_sel loads x row i of a cell at next_col(x): the
// gap-X row, or with per-column transitions the rows the spec names
template <class Spec>
__device__ __forceinline__ constexpr bool row_at_next(int i) {
    if constexpr (Spec::COL_TRANS) {
        return Spec::row_at_next(i);
    } else {
        return i == Spec::GAP_X;
    }
}

// the backward update of sm3_bwd_tiled_sel from the cell's inputs in
// registers: the spec's select form takes the gap-X row, or with
// per-column transitions all x rows
template <class Spec>
__device__ __forceinline__ void tiled_bwd_update(
        const float* t, const float* in, float eg1, const float* em2p,
        const float* n1a, const float* n1p, const float* n2p, float* out) {
    if constexpr (Spec::COL_TRANS) {
        Spec::bwd_update_sel(t, in + Spec::YR, eg1, em2p, n1a, n1p, n2p,
                             out);
    } else {
        Spec::bwd_update_sel(t, in[Spec::YR + Spec::GAP_X], eg1, em2p, n1a,
                             n1p, n2p, out);
    }
}

// the forward update of sm3_fwd_tiled_sel from the cell's inputs in
// registers: the spec's select form takes the gap-X row, or with
// per-column transitions all x rows (all read at x)
template <class Spec>
__device__ __forceinline__ void tiled_fwd_update(
        const float* t, const float* in, const float* p1m, const float* p1a,
        const float* p2m, const Emissions& e, float* out) {
    if constexpr (Spec::COL_TRANS) {
        Spec::fwd_update_sel(t, p1m, p1a, p2m, e, in + Spec::YR, out);
    } else {
        Spec::fwd_update_sel(t, p1m, p1a, p2m, e, in[Spec::YR + Spec::GAP_X],
                             out);
    }
}

// The forward in two forms: TILED, the tiled forward (K6a); untiled (K1
// strawman, dna5, vanilla, sm4, echelon and hdp: no tiles, no
// re-centering, no shifts written, aux null but for echelon's plane and
// hdp's stream).  A spec with an emission plane (EM_PLANE: echelon) reads
// each cell's emissions from the pre-pass's plane (slot d at its own
// window, k = 0), staged F_AHEAD diagonals ahead into shared memory with
// cp.async (each lane its own entries, one group a step), and loads only
// the x rows its step reads (fwd_row); a streamed spec (STREAMED: K1 hdp)
// stages the rows of its stream est [G, ND+3, R, W] the same way, one leaf
// a cell (staged_leaves), since row d at d's own window is the match =
// gap-Y emission of lane l, which never leaves [0, W) in the forward; it
// loads the gap-X row alone (fwd_row), takes no column log and folds with
// Strawman::fwd_update_sel (bench.py's HDP chunks: 64 blocks of 128
// threads, 1,700 diagonals; ~400 ns a diagonal against ~665 on
// sm3_fwd_kernel, on an H100 80GB HBM3 at 700 W).  The other specs
// compute their emissions from their rows.  What a form, the plane or the
// stream adds sits under if constexpr, so the tiled instances of the other
// specs compile to the same SASS as without it.
template <class Spec, bool TILED>
__global__ void sm3_fwd_tiled_sel(const float* __restrict__ scal,
                                  const int* __restrict__ win,
                                  const float* __restrict__ xf,
                                  const float* __restrict__ yf,
                                  const float* __restrict__ basef,
                                  const float* __restrict__ widthf,
                                  float* __restrict__ fwd,
                                  float* __restrict__ aux, int R, int W,
                                  int ND, int NDp, int X, int C, int Y,
                                  int TD) {
    constexpr int S = Spec::S;
    constexpr int NSCAL = Spec::NS + 3 * S;
    constexpr int START = Spec::NS;
    constexpr int YR = Spec::YR, NXF = Spec::NXF;
    constexpr bool T_SHARED = Spec::T_SHARED;
    constexpr int NL = staged_leaves<Spec>();
    constexpr int QE = F_AHEAD + 1;
    static_assert(NSCAL <= 32, "the shared scalars fit their 32 floats");
    // ring [3 slots][S][W]; red [32]: the re-centering's scratch; with
    // T_SHARED, the scalars [32]; with an emission plane or a stream, its
    // staged slots [QE][NL][W] (diagonal d in slot d % QE)
    extern __shared__ float ring[];
    float* red = ring + 3 * S * W;
    float* es = red + 64;
    const int b = blockIdx.x;
    const int g = b / R;
    const int r = b - g * R;
    const int l = threadIdx.x;
    // the scalars in registers, or with T_SHARED after red
    float t_reg[T_SHARED ? 1 : NSCAL];
    float* t = T_SHARED ? red + 32 : t_reg;
    if constexpr (T_SHARED) {
        if (l < NSCAL) t[l] = scal[l];
        __syncthreads();
    } else {
#pragma unroll
        for (int i = 0; i < NSCAL; ++i) t[i] = scal[i];
    }
    const int* wg = win + static_cast<size_t>(g) * NDp;
    const float* xb = xf + static_cast<size_t>(b) * NXF * X;
    const float* yb = yf + static_cast<size_t>(b) * YR * Y;
    const float* base = basef + static_cast<size_t>(b) * NDp;
    const float* width = widthf + static_cast<size_t>(b) * NDp;
    const size_t plane_d = static_cast<size_t>(S) * R * W;
    float* od = fwd + static_cast<size_t>(g) * (ND + 1) * plane_d
                + static_cast<size_t>(r) * W + l;
    // this lane's entries of the plane: leaf j of slot d at eb[(d * NL +
    // j) * R * W]; of a stream (NL 1): row d at eb[d * R * W]
    const size_t leaf = static_cast<size_t>(R) * W;
    const float* eb = NL > 0 ? aux + static_cast<size_t>(g) * (ND + 3) * NL
                                         * leaf
                                   + static_cast<size_t>(r) * W + l
                             : nullptr;
    // a spec's per-column logs (NLSD > 0), kept for x = w_{d-1} + l at the
    // top of step d: diagonal 0's window first (none where the emissions
    // are staged)
    float lsd[Spec::NLSD > 0 ? Spec::NLSD : 1];
    if constexpr (Spec::NLSD > 0 && NL == 0)
        Spec::col_logs_at(xb, X, wg[0] + l, lsd);

    // d = 0: the start vector inside the band; the slot of d = -1 is NEG
    const bool m0 = in_band(wg[0] + l, base[0], width[0]);
#pragma unroll
    for (int i = 0; i < S; ++i) {
        const float v = m0 ? t[START + i] : CPECAN_NEG;
        ring[(0 * S + i) * W + l] = v;
        ring[(2 * S + i) * W + l] = CPECAN_NEG;
        od[static_cast<size_t>(i) * R * W] = v;
    }
    float shift = 0.0f;   // A, the running re-centering shift
    const int NT = TILED ? ND / TD : 1;
    if constexpr (TILED) {
        if (l == 0) aux[static_cast<size_t>(b) * NT] = 0.0f;
    }
    // the plane's (or the stream's) slots of diagonals 1 .. F_AHEAD, one
    // group each (empty past ND)
    int rs = 1, is = 0;   // the staged slots of d and of d + F_AHEAD
    if constexpr (NL > 0) {
        for (int j = 1; j <= F_AHEAD; ++j) {
            if (j <= ND) {
#pragma unroll
                for (int k = 0; k < NL; ++k)
                    cp_async4(es + (j * NL + k) * W + l,
                              eb + (j * NL + k) * leaf);
            }
            cp_async_commit();
        }
    }
    __syncthreads();

    float* p1 = ring;              // diagonal d - 1
    float* p2 = ring + 2 * S * W;  // diagonal d - 2
    float* cur = ring + S * W;
    int w1 = wg[0], w2 = wg[0];    // the windows of d - 1 and d - 2
    int left = TD, tile = 0;       // diagonals left in tile ``tile``
    for (int d = 1; d <= ND; ++d) {
        if constexpr (TILED) {
            if (left == 0) {
                // before diagonal tile * TD + 1: re-center d - 1 and d - 2
                recenter<S>(p1, p2, false, l, W, red, shift);
                ++tile;
                if (l == 0) aux[static_cast<size_t>(b) * NT + tile] = shift;
                left = TD;
            }
            --left;
        }
        if (d + L1_AHEAD <= ND) {
            prefetch_l1(wg + d + L1_AHEAD);
            prefetch_l1(base + d + L1_AHEAD);
            prefetch_l1(width + d + L1_AHEAD);
        }
        if constexpr (NL > 0) {
            // the plane's (or the stream's) slot of d + F_AHEAD
            if (d + F_AHEAD <= ND) {
#pragma unroll
                for (int k = 0; k < NL; ++k)
                    cp_async4(es + (is * NL + k) * W + l,
                              eb + ((d + F_AHEAD) * NL + k) * leaf);
            }
            cp_async_commit();
        }
        const float bd = base[d], wd = width[d];
        const int w = wg[d];
        // the cell's inputs: y rows at its column, x rows at x (a spec
        // with an emission plane or a stream: the x rows its step reads)
        float in[YR + NXF];
        {
            const int x = w + l;
            if constexpr (NL > 0) {
#pragma unroll
                for (int i = 0; i < NXF; ++i)
                    if (Spec::fwd_row(i)) in[YR + i] = xb[i * X + x];
            } else {
                const int ycol = C - d + x;
#pragma unroll
                for (int i = 0; i < YR; ++i) in[i] = yb[i * Y + ycol];
#pragma unroll
                for (int i = 0; i < NXF; ++i) in[YR + i] = xb[i * X + x];
            }
        }
        const int s1 = w - w1;
        const int s2 = w - w2;
        // lower / middle sources at x - 1, upper at x
        float p1m[S], p1a[S], p2m[S];
#pragma unroll
        for (int i = 0; i < S; ++i) {
            p1m[i] = shifted(p1 + i * W, l, s1 - 1, W);
            p1a[i] = shifted(p1 + i * W, l, s1, W);
            p2m[i] = shifted(p2 + i * W, l, s2 - 1, W);
        }
        float nv[S];
        if constexpr (NL > 0) {
            // the plane's (or the stream's) slot of d: its group is the
            // F_AHEAD + 1-th newest
            cp_async_wait<F_AHEAD>();
            if constexpr (Spec::STREAMED) {
                // est[d] at this lane: the match and gap-Y emission
                const float v = es[rs * W + l];
                tiled_fwd_update<Spec>(t, in, p1m, p1a, p2m,
                                       Emissions{v, v}, nv);
            } else {
                Spec::fwd_update_sel(p1m, p1a, p2m,
                                     plane_emissions<Spec>(es + rs * NL * W, l,
                                                           W),
                                     in + YR, nv);
            }
            rs = rs + 1 == QE ? 0 : rs + 1;
            is = is + 1 == QE ? 0 : is + 1;
        } else {
            // the column logs change only where the window moves
            if constexpr (Spec::NLSD > 0) {
                if (w != w1) Spec::col_logs(in, lsd);
            }
            const Emissions e = tiled_emissions<Spec>(in, lsd);
            tiled_fwd_update<Spec>(t, in, p1m, p1a, p2m, e, nv);
        }
        const bool mask = in_band(w + l, bd, wd);
        od += plane_d;
#pragma unroll
        for (int i = 0; i < S; ++i) {
            const float v = mask ? nv[i] : CPECAN_NEG;
            cur[i * W + l] = v;
            od[static_cast<size_t>(i) * R * W] = v;
        }
        w2 = w1;
        w1 = w;
        float* const old = p2;
        p2 = p1;
        p1 = cur;
        cur = old;
        __syncthreads();
    }
}

// The posterior backward in three forms: TILED, the tiled backward (K6b);
// neither flag, the untiled posterior backward (K2: no tiles, no
// re-centering and no shift, so total and z lose the shf term; no shifts
// buffer is read); WITH_EXP, the untiled expectation backward (K3; its
// trans and acc come last).  The untiled posterior form is
// sm3_bwd_kernel<Spec, false>'s recurrence, posteriors and totals,
// computed identically, with the tiled form's step.  The expectation form
// is sm3_bwd_kernel<Spec, true>'s recurrence,
// posteriors, totals and EM sums, computed identically (the same targets
// in the same order, the same f32 operations): on the E-step's chunks (64
// blocks of W = 128 threads, 2,000 diagonals; one warp per scheduler) it
// stages all S fwd entries of a diagonal X_AHEAD diagonal ahead (one step
// hides the read; deeper staging measured slower), and the slots of d + 1
// and d + 2 are the targets' sources, so X_AHEAD + 3 slots take the place
// of the other template's fsh ring and its stores; the transitions sit in
// shared memory (64 registers, no spill); the targets are t = d + 3 at
// step d and 3, 2 and 1 after the loop; the column sums are the spec's
// (Dna5::exp_probs: atomic reductions; Strawman's and Sm4's one column,
// Vanilla's two, a plain read-modify-write), each column's adds ordered by
// the per-diagonal barrier.  The vanilla form (K3 vanilla, the vanilla
// E-step's 32-read groups) has no transition lanes (NLANE 0: the table is
// all 0) and no carry (EXP_CARRY false): its targets are silent gap-X
// cells whose masses Vanilla::exp_probs takes from the fwd and bwd
// entries, the total and the rows LA_MX and LA_XX at the target's own
// column, w_{d+3} + l, two fresh loads (the step's rows sit at
// next_col(w_d + l)); the emissions that exp_target evaluates for it are
// read by nothing and compile to nothing (the instance's SASS equals that
// of a variant skipping them).  The Gaussian machines' form (EXP_CARRY: K3
// strawman and K3 sm4, the E-steps' 32-read groups) takes a target's
// emissions from the em ring, as the JAX body takes them from its carry
// (pallas_fb.py:1180-1181), where the other form computes them again at
// every step (four gauss, each a division and a logf): step d writes
// e1, emissions(d + 1) at w_d, match and gap-Y, into its slot; step d
// reads em2p from the slot of d + 1 and target d + 3's emissions, at lane
// l + w_{d+3} - w_{d+2} (CPECAN_NEG outside [0, W)), from the slot of d
// + 2.  Three slots, since a neighbour's write of step d's slot is
// ordered against no read of the same step; targets 3 and 2 read the
// slots of steps 2 and 1, target 1 computes its own.  The values equal
// the fresh ones bit for bit (gauss_sel on the kept logs is gauss).  Its
// per-lane transition sums sit in a shared slab (acc_slab_lanes), each
// lane its own row, the same adds in the same order: in registers the
// forms spilled 8 (strawman) and 16 bytes (sm4).  On an H100 80GB HBM3 at
// 700 W (32 blocks of 128 threads, 1,700 diagonals) the forms run ~1,250
// (strawman) and ~1,390 ns (sm4) a diagonal, against ~2,950 and ~3,330
// on sm3_bwd_kernel; computing the targets' emissions afresh instead
// cost ~600 ns a diagonal more, the sums in registers ~6%.
// Every line either untiled form does not add is
// the tiled form's; what the flags add sits under if constexpr, so each
// form's instances compile to the same SASS as without the others.
// The untiled posterior form of a spec with an emission plane (EM_PLANE:
// K2 echelon) reads a cell's gap-Y term from the pre-pass's plane (slot d,
// k = 1) at its own lane and the carried match terms from slot d + 1 at
// lane l + o1 + 1 (CPECAN_NEG outside [0, W)), as the em ring gave them:
// the plane's slots are staged E_AHEAD diagonals ahead with the fwd entries
// (one cp.async group a step) in E_AHEAD + 2 shared slots, the slot of d +
// 1 read across lanes after the barrier that ends its step, so no em ring
// is written.  It writes NPS posterior planes (echelon: match1..match5),
// stages those states' fwd entries, reads the others' on seed diagonals
// only, and loads only the x rows its step reads (bwd_row at x,
// row_at_next at next_col(x)).
// The untiled posterior form of a streamed spec (STREAMED: K2 hdp) reads
// its emissions from the stream est [G, ND+3, R, W] through aux (row d at
// d's own window): each row is copied F_AHEAD diagonals ahead into one of
// F_AHEAD + 2 shared slots, in the cp.async group of the fwd entries of
// its diagonal, so the wait before step d's fwd read completes row d and
// the barrier that ends step d shows it to every lane; step d - 1 then
// reads it across lanes: est[d + 1] at lane l + o1, CPECAN_NEG outside
// [0, W), at the top of step d.  That value is both the gap-Y term and
// next step's carry in the em ring, whose read at lane l + o1 + 1 is
// est[d + 2] at lane l + o2 + 1 under both lanes' guards.  It loads only
// the gap-X row at next_col(x): no y row, no model row, no column log.
// (On bench.py's HDP chunks, on an H100 80GB HBM3 at 700 W, the staged
// rows beat a plain load of est[d + 1] at the top of the step, its row
// prefetched into L1 64 diagonals ahead: ~555 against ~655 ns a
// diagonal.)
// The expectation form of a streamed spec (K3 hdp, the HDP E-step's
// 32-read groups) is the two above at once: the stream's rows staged as
// in K2 hdp (X_AHEAD ahead, in X_AHEAD + 2 slots, with all S fwd entries)
// and the Gaussian machines' three-slot em ring (Hdp keeps its strawman
// traits' EXP_CARRY), whose slot of step d holds e1 = est[d + 1] at lane l
// + w_d - w_{d+1}, in both leaves; target t = d + 3 reads it from the slot
// of step d + 2 at lane l + w_t - w_{t-1}, which is est[t] at lane l under
// the one guard that the JAX body's carry (pallas_fb.py:1178-1181) and
// sm3_bwd_kernel's exp_target(carried) apply, CPECAN_NEG outside [0, W).
// The ring is chosen over keeping the stream rows of d + 1 .. d + 3
// resident in a deeper slot ring: it is the path that already holds
// strawman and sm4 bit-equal, it costs one shared store a step, and the
// staged slots stay K2 hdp's.  Target 1 reads est[1] at its own lane from
// the stream (eb), as exp_target does.  The ring's third slot and the
// slab of the transition sums sit between the fwd slots and the staged
// rows (staged_after), which keeps every other instance's layout.
template <class Spec, bool WITH_EXP, bool TILED>
__global__ void sm3_bwd_tiled_sel(const float* __restrict__ scal,
                                  const int* __restrict__ win,
                                  const float* __restrict__ xf,
                                  const float* __restrict__ yf,
                                  const float* __restrict__ basef,
                                  const float* __restrict__ widthf,
                                  const float* __restrict__ seedf,
                                  const float* __restrict__ raggedf,
                                  const float* __restrict__ fwd,
                                  const float* __restrict__ aux,
                                  float* __restrict__ posts,
                                  float* __restrict__ totals, int R, int W,
                                  int ND, int NDp, int X, int C, int Y,
                                  int TD, float* __restrict__ trans,
                                  float* __restrict__ accf) {
    constexpr int S = Spec::S;
    constexpr int NEM = Spec::NEM;
    constexpr int END = Spec::NS + S;
    constexpr int YR = Spec::YR, NXF = Spec::NXF;
    constexpr bool T_SHARED = WITH_EXP || Spec::T_SHARED;
    static_assert((Spec::NPS == 1 || (!WITH_EXP && !TILED))
                      && 2 * S + (T_SHARED ? Spec::NS : 0) <= 32
                      && !(Spec::STREAMED && TILED)
                      && !(WITH_EXP && TILED)
                      && !(Spec::EM_PLANE > 0 && TILED)
                      && (!exp_carry<Spec, WITH_EXP>() || NEM == 1),
                  "several posterior planes and the emission plane in the "
                  "untiled posterior form only; the end vectors (and the "
                  "shared transitions) fit tend; the targets' emissions "
                  "come from the rows, the stream or the em ring (one match "
                  "leaf); the tiled path has no EM sums, and its shifts "
                  "take aux, where a stream would be");
    // the fwd slots: the posterior states' entries, copied F_AHEAD
    // diagonals ahead (E_AHEAD with an emission plane), or WITH_EXP all S
    // entries, X_AHEAD diagonals ahead
    constexpr int AHEAD = bwd_ahead<Spec, WITH_EXP>();
    constexpr int QS = WITH_EXP ? S : Spec::NPS;
    constexpr int QF = WITH_EXP ? X_AHEAD + 3 : AHEAD + 1;
    // ring [3 slots][S][W]: bwd[d] raw at w_d; em [2 slots][NEM][W]: the
    // match emission's leaves of diagonal d + 1 at x = w_d + l (with
    // exp_carry [3 slots][NEM + 1][W], the gap-Y term too); red [32];
    // tend [32]: the end and ragged-end vectors (read on seed diagonals
    // only, so they take no registers), then with T_SHARED the
    // transitions; fst [QF][QS][W]: fwd[d] (step j = ND - d + 1 reads slot
    // j % QF), each lane its own entries; with an emission plane (EM_PLANE
    // leaves, no em ring), ps [AHEAD + 2][EM_PLANE][W]: its slot of d (step
    // j reads slot j % (AHEAD + 2), and the previous step's across lanes);
    // a streamed spec's ps [AHEAD + 2][1][W]: the stream's row of d, read
    // across lanes the step after.
    // (The form's constants are written out or taken from functions at
    // namespace scope: a constexpr local that no instance reads changed the
    // SASS of the other untiled instances)
    extern __shared__ float smem[];
    float* ring = smem;
    float* em_rd = smem + 3 * S * W;  // emissions(d + 2) at w_{d+1}
    float* em_wr = em_rd + em_slot_leaves<Spec, WITH_EXP>() * W;
    float* red = em_wr + em_slot_leaves<Spec, WITH_EXP>() * W;
    float* tend = red + 32;
    float* fst = tend + 32;
    float* ps = fst + QF * QS * W;
    // exp_carry: the ring's third slot, emissions(d + 3) at w_{d+2}, then
    // the slab of the transition sums (this lane's row at acc_s, below):
    // where the staged slots begin for a spec that stages none (strawman,
    // sm4), and before them for a streamed spec, whose staged rows move
    // past the slab (staged_after; moving them under if constexpr keeps
    // the other instances' SASS, which one expression for all did not)
    float* em_t2 = ps;
    if constexpr (staged_after<Spec, WITH_EXP>() > 0)
        ps = em_t2 + staged_after<Spec, WITH_EXP>() * W;
    const int b = blockIdx.x;
    const int g = b / R;
    const int r = b - g * R;
    const int l = threadIdx.x;
    float* acc_s = em_t2 + em_slot_leaves<Spec, WITH_EXP>() * W
                   + l * acc_slab_lanes<Spec, WITH_EXP>();
    // the transitions in registers, or with T_SHARED after the end
    // vectors in tend
    float t_reg[T_SHARED || Spec::NS == 0 ? 1 : Spec::NS];
    float* t = T_SHARED ? tend + 2 * S : t_reg;
    if constexpr (T_SHARED) {
        if (l < Spec::NS) t[l] = scal[l];
    } else {
#pragma unroll
        for (int i = 0; i < Spec::NS; ++i) t[i] = scal[i];
    }
    if (l < 2 * S) tend[l] = scal[END + l];
    const int* wg = win + static_cast<size_t>(g) * NDp;
    const float* xb = xf + static_cast<size_t>(b) * NXF * X;
    const float* yb = yf + static_cast<size_t>(b) * YR * Y;
    const float* base = basef + static_cast<size_t>(b) * NDp;
    const float* width = widthf + static_cast<size_t>(b) * NDp;
    const float* seed = seedf + static_cast<size_t>(b) * NDp;
    const float* ragged = raggedf + static_cast<size_t>(b) * NDp;
    const size_t fplane_d = static_cast<size_t>(S) * R * W;
    const size_t fstate = static_cast<size_t>(R) * W;
    const float* fin = fwd + static_cast<size_t>(g) * (ND + 1) * fplane_d
                       + static_cast<size_t>(r) * W + l;
    const size_t pstate = static_cast<size_t>(R) * W;
    const size_t pplane_d = Spec::NPS * pstate;
    float* pout = posts + static_cast<size_t>(g) * (ND + 1) * pplane_d
                  + static_cast<size_t>(r) * W + l;
    // this lane's entries of the plane: leaf j of slot d at eb[(d *
    // EM_PLANE + j) * R * W]; a streamed spec's stream est[g, :, r, :]
    // (row d at eb[d * R * W], read across lanes)
    const size_t leaf = static_cast<size_t>(R) * W;
    const float* eb =
        Spec::EM_PLANE > 0
            ? aux + static_cast<size_t>(g) * (ND + 3) * Spec::EM_PLANE
                           * leaf
                  + static_cast<size_t>(r) * W + l
        : Spec::STREAMED
            ? aux + static_cast<size_t>(g) * (ND + 3) * leaf
                  + static_cast<size_t>(r) * W
            : nullptr;

    // diagonal 0 is never swept
#pragma unroll
    for (int j = 0; j < Spec::NPS; ++j) pout[j * pstate] = 0.0f;
    // bwd[ND + 1] = bwd[ND + 2] = NEG; em carry = emissions(ND + 2) at the
    // window of ND + 1
#pragma unroll
    for (int i = 0; i < S; ++i) {
        ring[(1 * S + i) * W + l] = CPECAN_NEG;
        ring[(2 * S + i) * W + l] = CPECAN_NEG;
    }
    // a spec's per-column logs (NLSD > 0), kept for x = w_{d+1} + l at the
    // top of step d
    float lsd[Spec::NLSD > 0 ? Spec::NLSD : 1];
    if constexpr (Spec::EM_PLANE > 0) {
        // the plane's slot ND + 1 (the first carry) into staged slot 0
#pragma unroll
        for (int k = 0; k < NEM; ++k)
            ps[k * W + l] = eb[((ND + 1) * Spec::EM_PLANE + k) * leaf];
    } else if constexpr (Spec::STREAMED) {
        // the first carry, the stream of ND + 2 at the window of ND + 1
        // (with exp_carry its gap-Y leaf too: the same value), and the
        // stream's row ND + 1 into staged slot 0 (no model rows, no column
        // logs: the stream holds the emissions)
        const float e2 = shifted(eb + (ND + 2) * leaf, l,
                                 wg[ND + 1] - wg[ND + 2], W);
        em_rd[l] = e2;
        if constexpr (exp_carry<Spec, WITH_EXP>()) em_rd[NEM * W + l] = e2;
        ps[l] = eb[(ND + 1) * leaf + l];
    } else {
        const int x = wg[ND + 1] + l;
        const auto e = Spec::emissions_at(xb, yb, X, Y, x, C - (ND + 2) + x);
#pragma unroll
        for (int k = 0; k < NEM; ++k) em_rd[k * W + l] = em_leaf(e, k);
        if constexpr (exp_carry<Spec, WITH_EXP>())
            em_rd[NEM * W + l] = e.gap_y;
        if constexpr (Spec::NLSD > 0) Spec::col_logs_at(xb, X, x, lsd);
    }
    // WITH_EXP: the per-lane transition sums (with exp_carry at acc_s) and
    // this read's accumulator rows (acc[g, j, r, :] at rows + j * R * X);
    // fwd[ND + 1] = NEG (slot 0), the lower/upper source of target ND + 2
    // (a machine without lanes, Vanilla, keeps one unused register)
    float acc[WITH_EXP && !exp_carry<Spec, WITH_EXP>() && Spec::NLANE > 0
                  ? Spec::NLANE : 1];
    const size_t row_stride = static_cast<size_t>(R) * X;
    float* rows = accf + (static_cast<size_t>(g) * Spec::NACC * R + r) * X;
    if constexpr (WITH_EXP) {
        if constexpr (exp_carry<Spec, WITH_EXP>()) {
#pragma unroll
            for (int k = 0; k < Spec::NLANE; ++k) acc_s[k] = 0.0f;
        } else {
#pragma unroll
            for (int k = 0; k < Spec::NLANE; ++k) acc[k] = 0.0f;
        }
        for (int j = 0; j < Spec::NACC; ++j)
            for (int c = l; c < X; c += W) rows[j * row_stride + c] = 0.0f;
#pragma unroll
        for (int i = 0; i < S; ++i) fst[i * W + l] = CPECAN_NEG;
    }
    // the fwd entries (and plane slots or stream rows) of diagonals ND ..
    // ND - AHEAD + 1 into slots 1 .. AHEAD, one group each (empty below
    // diagonal 1)
    for (int j = 1; j <= AHEAD; ++j) {
        const int k = ND + 1 - j;
        if (k >= 1) {
#pragma unroll
            for (int i = 0; i < QS; ++i)
                cp_async4(fst + (j * QS + i) * W + l,
                          fin + k * fplane_d
                              + staged_state<Spec, WITH_EXP>(i) * fstate);
            if constexpr (Spec::EM_PLANE > 0) {
#pragma unroll
                for (int i = 0; i < Spec::EM_PLANE; ++i)
                    cp_async4(ps + (j * Spec::EM_PLANE + i) * W + l,
                              eb + (k * Spec::EM_PLANE + i) * leaf);
            } else if constexpr (Spec::STREAMED) {
                cp_async4(ps + j * W + l, eb + k * leaf + l);
            }
        }
        cp_async_commit();
    }
    __syncthreads();

    float total = CPECAN_NEG;
    bool cut_prev = false;       // the seed cut of diagonal d + 1
    float shift = 0.0f;          // B, the running re-centering shift
    float shf = 0.0f;            // A_t + B, repaid by the rows of tile t
    const int NT = TILED ? ND / TD : 1;
    float* n1 = ring + S * W;      // bwd[d + 1]
    float* n2 = ring + 2 * S * W;  // bwd[d + 2]
    float* cur = ring;             // WITH_EXP: bwd[d + 3] until bwd[d]
    // the windows of d + 1, d + 2 and, WITH_EXP, d + 3 (read from the
    // first target on, d = ND - 1)
    int w1 = wg[ND + 1], w2 = wg[ND + 2], w3 = 0;
    int left = 0;                  // diagonals left in the tile
    // the index of shifts[b, t] (aux) while tile t is swept (the tiles run top
    // down; it starts one past the top tile): a running index keeps no
    // row offset live across the sweep, a register that K6b vanilla needs
    // to stay without a spill
    int sidx = b * NT + NT;
    // the fst slots of d, of d - AHEAD and, WITH_EXP, of d + 1 and d + 2
    int rs = 1, is = (1 + AHEAD) % QF, rs1 = 0, rs2 = QF - 1;
    // the staged slots (plane or stream) of d + 1, of d and of d - AHEAD
    int es1 = 0, es = 1, eis = (1 + AHEAD) % (AHEAD + 2);
    pout += static_cast<size_t>(ND) * pplane_d;
    for (int d = ND; d >= 1; --d) {
        if constexpr (TILED) {
            if (left == 0) {
                // the top of tile d / TD - 1; below the first tile the
                // carried bwd[d + 1] and bwd[d + 2] (cut at d + 1)
                // re-center
                if (d < ND) recenter<S>(n1, n2, cut_prev, l, W, red, shift);
                shf = aux[--sidx] + shift;
                left = TD;
            }
            --left;
        }
        if (d > L1_AHEAD) {
            prefetch_l1(wg + d - L1_AHEAD);
            prefetch_l1(base + d - L1_AHEAD);
            prefetch_l1(width + d - L1_AHEAD);
            prefetch_l1(seed + d - L1_AHEAD);
            prefetch_l1(ragged + d - L1_AHEAD);
        }
        const float bd = base[d], wd = width[d];
        const bool sa = seed[d] != 0.0f;   // block-uniform
        const bool ra = ragged[d] != 0.0f;
        const int w = wg[d];
        const int x = w + l;
        const float* fd = fin + static_cast<size_t>(d) * fplane_d;
        if (d - AHEAD >= 1) {
#pragma unroll
            for (int i = 0; i < QS; ++i)
                cp_async4(fst + (is * QS + i) * W + l,
                          fd - AHEAD * fplane_d
                              + staged_state<Spec, WITH_EXP>(i) * fstate);
            if constexpr (Spec::EM_PLANE > 0) {
#pragma unroll
                for (int i = 0; i < Spec::EM_PLANE; ++i)
                    cp_async4(ps + (eis * Spec::EM_PLANE + i) * W + l,
                              eb + ((d - AHEAD) * Spec::EM_PLANE + i)
                                       * leaf);
            } else if constexpr (Spec::STREAMED) {
                cp_async4(ps + eis * W + l, eb + (d - AHEAD) * leaf + l);
            }
        }
        cp_async_commit();
        // the cell's inputs: emissions(d + 1)'s y rows at column C - (d +
        // 1) + x and x rows at x, the gap-X row at next_col(x); a spec
        // with an emission plane loads only the x rows its step reads, at
        // x (in) and at next_col(x) (inp); a streamed spec only the gap-X
        // row, and emissions(d + 1) at x from the stream (e1, next step's
        // carry too)
        float in[YR + NXF];
        float inp[Spec::EM_PLANE > 0 ? NXF : 1];
        Emissions e1;   // without a plane: next step's carry
        {
            const int ycol = C - (d + 1) + x;
            const int xp = next_col(x, X);
            if constexpr (Spec::EM_PLANE > 0) {
#pragma unroll
                for (int i = 0; i < NXF; ++i) {
                    if (Spec::bwd_row(i)) in[YR + i] = xb[i * X + x];
                    if (Spec::row_at_next(i)) inp[i] = xb[i * X + xp];
                    if (Spec::bwd_row(i) || Spec::row_at_next(i))
                        prefetch_l1(xb + i * X + max(x - L1_AHEAD, 0));
                }
            } else if constexpr (Spec::STREAMED) {
                // est[d + 1] at lane l + w - w_{d+1}, CPECAN_NEG outside
                // [0, W): a read across lanes of its staged slot, complete
                // since the barrier that ended step d + 1
                e1.match = e1.gap_y = shifted(ps + es1 * W, l, w - w1, W);
                in[YR + Spec::GAP_X] = xb[Spec::GAP_X * X + xp];
                prefetch_l1(xb + Spec::GAP_X * X + max(x - L1_AHEAD, 0));
            } else {
#pragma unroll
                for (int i = 0; i < YR; ++i) in[i] = yb[i * Y + ycol];
#pragma unroll
                for (int i = 0; i < NXF; ++i)
                    in[YR + i] = xb[i * X + (row_at_next<Spec>(i) ? xp : x)];
                // the lines the sweep reaches next (x falls, the column
                // rises)
#pragma unroll
                for (int i = 0; i < YR; ++i)
                    prefetch_l1(yb + i * Y + min(ycol + L1_AHEAD, Y - 1));
#pragma unroll
                for (int i = 0; i < NXF; ++i)
                    prefetch_l1(xb + i * X + max(x - L1_AHEAD, 0));
            }
        }
        const int o1 = w - w1;
        const int o2 = w - w2;
        // the seed diagonal cuts the carried bwd[d + 1], bwd[d + 2]
        const bool cut1 = sa;
        const bool cut2 = sa || cut_prev;
        float n1a[S], n1p[S], n2p[S];
#pragma unroll
        for (int i = 0; i < S; ++i) {
            n1a[i] = cut1 ? CPECAN_NEG : shifted(n1 + i * W, l, o1, W);
            n1p[i] = cut1 ? CPECAN_NEG : shifted(n1 + i * W, l, o1 + 1, W);
            n2p[i] = cut2 ? CPECAN_NEG : shifted(n2 + i * W, l, o2 + 1, W);
        }
        float em2p[NEM];
#pragma unroll
        for (int k = 0; k < NEM; ++k) {
            if constexpr (Spec::EM_PLANE > 0) {
                em2p[k] = shifted(ps + (es1 * Spec::EM_PLANE + k) * W, l,
                                  o1 + 1, W);
            } else {
                em2p[k] = shifted(em_rd + k * W, l, o1 + 1, W);
            }
        }
        float bw[S];
        if constexpr (Spec::EM_PLANE > 0) {
            // the plane's slot of d (and fwd[d]): the AHEAD + 1-th newest
            // group
            cp_async_wait<AHEAD>();
            Spec::bwd_update_sel(in + YR, inp,
                                 ps[(es * Spec::EM_PLANE + NEM) * W + l],
                                 em2p, n1a, n1p, n2p, bw);
        } else {
            // emissions(d + 1) at x (next step's carry), but for a
            // streamed spec, which read them above; the column logs
            // change only where the window moves
            if constexpr (!Spec::STREAMED) {
                if constexpr (Spec::NLSD > 0) {
                    if (w != w1) Spec::col_logs(in, lsd);
                }
                e1 = tiled_emissions<Spec>(in, lsd);
            }
            tiled_bwd_update<Spec>(t, in, e1.gap_y, em2p, n1a, n1p, n2p,
                                   bw);
        }
        const bool mask = in_band(x, bd, wd);
#pragma unroll
        for (int i = 0; i < S; ++i) {
            if (!mask) bw[i] = CPECAN_NEG;
            if (sa && mask) bw[i] = tend[(ra ? S : 0) + i];
        }
        // fwd[d] (of the posterior's state: the others' are read on the
        // seed diagonal only, unless WITH_EXP): its group is the AHEAD +
        // 1-th newest
        cp_async_wait<AHEAD>();
        float f[QS];
#pragma unroll
        for (int i = 0; i < QS; ++i) f[i] = fst[(rs * QS + i) * W + l];
        if (sa) {
            // total = masked log-sum-exp over the read's lanes at its seed
            // diagonal (sm3_bwd_kernel's, with the branch log_add)
            float prod = seed_fwd<Spec, WITH_EXP>(f, fd, 0, R, W) + bw[0];
#pragma unroll
            for (int i = 1; i < S; ++i)
                prod = log_add(prod,
                               seed_fwd<Spec, WITH_EXP>(f, fd, i, R, W)
                                   + bw[i]);
            const float vv = mask ? prod : CPECAN_NEG;
            const float m = block_max(vv, red);
            const float s = block_sum(mask ? expf(vv - m) : 0.0f, red);
            total = m + logf(fmaxf(s, 1e-37f));
            if constexpr (TILED) total = total + shf;
        }
        const float xl = static_cast<float>(x);
        const bool ok = mask && xl > 0.0f && xl < static_cast<float>(d);
#pragma unroll
        for (int j = 0; j < Spec::NPS; ++j) {
            float z = f[j] + bw[Spec::post_state(j)] - total;
            if constexpr (TILED) z = z + shf;
            pout[j * pstate] = ok ? expf(fminf(z, 0.69f)) : 0.0f;
        }
        pout -= pplane_d;
        if constexpr (WITH_EXP) {
            if (d < ND) {
                // target tt = d + 3 (<= ND + 2) from fwd[d + 1] and fwd[d
                // + 2]; its backward bwd[tt] is this lane's entry of cur,
                // which bwd[d] overwrites below
                const int tt = d + 3;
                const bool cut = seed[tt - 1] != 0.0f
                                 || seed[tt - 2] != 0.0f;
                // exp_carry: emissions(tt) at w3 + l, step d + 2's e1 (at
                // w2) read across lanes
                sel_target<Spec, exp_carry<Spec, WITH_EXP>()>(
                    t, xb, yb, eb, X, Y, C, R, tt, w3, fst + rs1 * S * W, w1,
                    fst + rs2 * S * W, w2, cur, cut, total,
                    in_band(w3 + l, base[tt], width[tt]), true, em_t2, l, W,
                    acc, acc_s, rows, row_stride);
            }
        }
#pragma unroll
        for (int i = 0; i < S; ++i) cur[i * W + l] = bw[i];
        if constexpr (Spec::EM_PLANE == 0) {
#pragma unroll
            for (int k = 0; k < NEM; ++k) em_wr[k * W + l] = em_leaf(e1, k);
            if constexpr (exp_carry<Spec, WITH_EXP>())
                em_wr[NEM * W + l] = e1.gap_y;
        }
        cut_prev = sa;
        w3 = w2;
        w2 = w1;
        w1 = w;
        float* const old = n2;
        n2 = n1;
        n1 = cur;
        cur = old;
        if constexpr (exp_carry<Spec, WITH_EXP>()) {
            float* const em_old = em_t2;
            em_t2 = em_rd;
            em_rd = em_wr;
            em_wr = em_old;
        } else {
            float* const em_old = em_rd;
            em_rd = em_wr;
            em_wr = em_old;
        }
        rs2 = rs1;
        rs1 = rs;
        rs = (rs + 1) % QF;
        is = (is + 1) % QF;
        if constexpr (Spec::EM_PLANE > 0 || Spec::STREAMED) {
            es1 = es;
            es = es + 1 == AHEAD + 2 ? 0 : es + 1;
            eis = eis + 1 == AHEAD + 2 ? 0 : eis + 1;
        }
        __syncthreads();
    }
    if (l == 0) totals[b] = total;
    if constexpr (WITH_EXP) {
        // targets 3, 2 and 1: cur, n1, n2 hold bwd[3], bwd[1], bwd[2] and
        // the fst slots rs1, rs2 fwd[1], fwd[2] (NEG where the diagonal
        // lies past ND); fwd[0] goes into slot rs (target 3 reads rs1 and
        // rs2 only); with exp_carry the em ring's em_t2 and em_rd hold the
        // e1 of steps 2 and 1, emissions(3) at w_2 and emissions(2) at w_1
        const float* fs1 = fst + rs1 * S * W;
        const float* fs2 = fst + rs2 * S * W;
        float* fs0 = fst + rs * S * W;
        const bool cut3 = seed[2] != 0.0f || seed[1] != 0.0f;
        sel_target<Spec, exp_carry<Spec, WITH_EXP>()>(
            t, xb, yb, eb, X, Y, C, R, 3, wg[3], fs1, wg[1], fs2, wg[2], cur,
            cut3, total, in_band(wg[3] + l, base[3], width[3]), true, em_t2,
            l, W, acc, acc_s, rows, row_stride);
#pragma unroll
        for (int i = 0; i < S; ++i) fs0[i * W + l] = fin[i * fstate];
        __syncthreads();
        sel_target<Spec, exp_carry<Spec, WITH_EXP>()>(
            t, xb, yb, eb, X, Y, C, R, 2, wg[2], fs0, wg[0], fs1, wg[1], n2,
            seed[1] != 0.0f, total, in_band(wg[2] + l, base[2], width[2]),
            true, em_rd, l, W, acc, acc_s, rows, row_stride);
        __syncthreads();   // orders the accumulator columns of targets 2, 1
        // target 1: no middle source, emissions(1) fresh (not a carry; a
        // stream's row 1 at its own lane)
        sel_target<Spec, exp_carry<Spec, WITH_EXP>()>(
            t, xb, yb, eb, X, Y, C, R, 1, wg[1], nullptr, 0, fs0, wg[0], n1,
            false, total, in_band(wg[1] + l, base[1], width[1]), false,
            nullptr, l, W, acc, acc_s, rows, row_stride);
        // the S*S table: the machine's lanes from their sums, the rest 0
        float* tr = trans + static_cast<size_t>(b) * S * S;
        if (l == 0)
            for (int k = 0; k < S * S; ++k) tr[k] = 0.0f;
#pragma unroll
        for (int k = 0; k < Spec::NLANE; ++k) {
            float v;
            if constexpr (exp_carry<Spec, WITH_EXP>()) {
                v = acc_s[k];
            } else {
                v = acc[k];
            }
            const float s = block_sum(v, red);
            if (l == 0) tr[Spec::lane(k)] = s;
        }
    }
}

int launch_config_error(int W) {
    // one thread per lane: W must fill whole warps and fit one block
    if (W <= 0 || W % 32 != 0 || W > CPECAN_MAX_W)
        return cudaErrorInvalidValue;
    return cudaSuccess;
}

template <class Spec, bool WITH_EXP>
int launch_bwd(const void* scal, const void* win, const void* xf,
               const void* yf, const void* basef, const void* widthf,
               const void* seedf, const void* raggedf, const void* fwd,
               const void* est, void* posts, void* totals, void* trans,
               void* accf, int G, int R, int W, int ND, int NDp, int X,
               int C, int Y, void* stream) {
    constexpr int S = Spec::S;
    if (int e = launch_config_error(W)) return e;
    // ring + em + red, and fsh with the expectations
    const size_t smem = sizeof(float) * ((3 * S + 2 * Spec::NEM) * W + 32
                                         + (WITH_EXP ? 3 * S * W : 0));
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            sm3_bwd_kernel<Spec, WITH_EXP>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    sm3_bwd_kernel<Spec, WITH_EXP>
        <<<G * R, W, smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(scal), static_cast<const int*>(win),
            static_cast<const float*>(xf), static_cast<const float*>(yf),
            static_cast<const float*>(basef),
            static_cast<const float*>(widthf),
            static_cast<const float*>(seedf),
            static_cast<const float*>(raggedf),
            static_cast<const float*>(fwd), static_cast<const float*>(est),
            static_cast<float*>(posts), static_cast<float*>(totals),
            static_cast<float*>(trans), static_cast<float*>(accf), R, W, ND,
            NDp, X, C, Y);
    return static_cast<int>(cudaGetLastError());
}

template <class Spec>
int launch_fwd(const void* scal, const void* win, const void* xf,
               const void* yf, const void* basef, const void* widthf,
               const void* est, void* fwd, int G, int R, int W, int ND,
               int NDp, int X, int C, int Y, void* stream) {
    if (int e = launch_config_error(W)) return e;
    // the ring
    const size_t smem = sizeof(float) * 3 * Spec::S * W;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            sm3_fwd_kernel<Spec>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    sm3_fwd_kernel<Spec>
        <<<G * R, W, smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(scal), static_cast<const int*>(win),
            static_cast<const float*>(xf), static_cast<const float*>(yf),
            static_cast<const float*>(basef),
            static_cast<const float*>(widthf),
            static_cast<const float*>(est), static_cast<float*>(fwd), R, W,
            ND, NDp, X, C, Y);
    return static_cast<int>(cudaGetLastError());
}

template <class Spec, bool TILED>
int launch_fwd_sel(const void* scal, const void* win, const void* xf,
                   const void* yf, const void* basef, const void* widthf,
                   void* fwd, void* aux, int G, int R, int W, int ND,
                   int NDp, int X, int C, int Y, int TD, void* stream) {
    if (int e = launch_config_error(W)) return e;
    if (TILED && (TD <= 0 || ND % TD != 0)) return cudaErrorInvalidValue;
    // ring, the reduction scratch of the re-centering, the shared scalars
    // and the emission plane's or the stream's staged slots
    const size_t smem = sizeof(float)
                        * ((3 * Spec::S
                            + (F_AHEAD + 1) * staged_leaves<Spec>())
                               * W
                           + 64);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            sm3_fwd_tiled_sel<Spec, TILED>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    sm3_fwd_tiled_sel<Spec, TILED>
        <<<G * R, W, smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(scal), static_cast<const int*>(win),
            static_cast<const float*>(xf), static_cast<const float*>(yf),
            static_cast<const float*>(basef),
            static_cast<const float*>(widthf), static_cast<float*>(fwd),
            static_cast<float*>(aux), R, W, ND, NDp, X, C, Y, TD);
    return static_cast<int>(cudaGetLastError());
}

template <class Spec, bool WITH_EXP, bool TILED>
int launch_bwd_sel(const void* scal, const void* win, const void* xf,
                   const void* yf, const void* basef, const void* widthf,
                   const void* seedf, const void* raggedf, const void* fwd,
                   const void* aux, void* posts, void* totals,
                   void* trans, void* accf, int G, int R, int W, int ND,
                   int NDp, int X, int C, int Y, int TD, void* stream) {
    if (int e = launch_config_error(W)) return e;
    if (TILED && (TD <= 0 || ND % TD != 0)) return cudaErrorInvalidValue;
    // ring + em + red + the end vectors + the fwd slots + the emission
    // plane's or the stream's staged slots
    constexpr int AHEAD = bwd_ahead<Spec, WITH_EXP>();
    constexpr int NQ = WITH_EXP ? (X_AHEAD + 3) * Spec::S
                                : (AHEAD + 1) * Spec::NPS;
    constexpr int NE = (AHEAD + 2) * staged_leaves<Spec>();
    const size_t smem = sizeof(float)
                        * ((3 * Spec::S
                            + em_ring_slots<Spec, WITH_EXP>()
                                  * em_slot_leaves<Spec, WITH_EXP>()
                            + NQ + NE + acc_slab_lanes<Spec, WITH_EXP>())
                               * W
                           + 64);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            sm3_bwd_tiled_sel<Spec, WITH_EXP, TILED>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    sm3_bwd_tiled_sel<Spec, WITH_EXP, TILED>
        <<<G * R, W, smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(scal), static_cast<const int*>(win),
            static_cast<const float*>(xf), static_cast<const float*>(yf),
            static_cast<const float*>(basef),
            static_cast<const float*>(widthf),
            static_cast<const float*>(seedf),
            static_cast<const float*>(raggedf),
            static_cast<const float*>(fwd),
            static_cast<const float*>(aux),
            static_cast<float*>(posts), static_cast<float*>(totals), R, W,
            ND, NDp, X, C, Y, TD, static_cast<float*>(trans),
            static_cast<float*>(accf));
    return static_cast<int>(cudaGetLastError());
}

template <class Spec>
int launch_emissions(const void* win, const void* xf, const void* yf,
                     void* em, int G, int R, int W, int ND, int NDp, int X,
                     int C, int Y, int k, void* stream) {
    if (int e = launch_config_error(W)) return e;
    if (k < 0 || k > 1) return cudaErrorInvalidValue;
    // one thread a cell of the plane [G, ND+3, R, W]
    constexpr int THREADS = 256;
    const long long n = static_cast<long long>(G) * (ND + 3) * R * W;
    const long long blocks = (n + THREADS - 1) / THREADS;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    sm3_emissions_kernel<Spec>
        <<<static_cast<unsigned>(blocks), THREADS, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int*>(win), static_cast<const float*>(xf),
            static_cast<const float*>(yf), static_cast<float*>(em), G, R, W,
            ND, NDp, X, C, Y, k);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* wavefront_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One entry point per kernel instance; the dna5, vanilla, sm4 and echelon
// ones take the strawman ones' arguments, the hdp ones the stream too.

// the untiled select forward of a spec without an emission plane (K1
// strawman, dna5, vanilla and sm4: sm3_fwd_tiled_sel<Spec, false>)
#define WAVEFRONT_FWD_SEL_ENTRY(NAME, SPEC)                                 \
    int NAME(const void* scal, const void* win, const void* xf,              \
             const void* yf, const void* basef, const void* widthf,          \
             void* fwd, int G, int R, int W, int ND, int NDp, int X, int C,  \
             int Y, void* stream) {                                          \
        return launch_fwd_sel<SPEC, false>(scal, win, xf, yf, basef, widthf, \
                                           fwd, nullptr, G, R, W, ND, NDp,  \
                                           X, C, Y, 0, stream);              \
    }
// the select tiled kernels take the same arguments
#define WAVEFRONT_FWD_TILED_SEL_ENTRY(NAME, SPEC)                           \
    int NAME(const void* scal, const void* win, const void* xf,              \
             const void* yf, const void* basef, const void* widthf,          \
             void* fwd, void* shifts, int G, int R, int W, int ND, int NDp,  \
             int X, int C, int Y, int TD, void* stream) {                    \
        return launch_fwd_sel<SPEC, true>(scal, win, xf, yf, basef, widthf, \
                                          fwd, shifts, G, R, W, ND, NDp, X,  \
                                          C, Y, TD, stream);                 \
    }
#define WAVEFRONT_BWD_TILED_SEL_ENTRY(NAME, SPEC)                           \
    int NAME(const void* scal, const void* win, const void* xf,              \
             const void* yf, const void* basef, const void* widthf,          \
             const void* seedf, const void* raggedf, const void* fwd,        \
             const void* shifts, void* posts, void* totals, int G, int R,    \
             int W, int ND, int NDp, int X, int C, int Y, int TD,            \
             void* stream) {                                                 \
        return launch_bwd_sel<SPEC, false, true>(                            \
            scal, win, xf, yf, basef, widthf, seedf, raggedf, fwd, shifts,   \
            posts, totals, nullptr, nullptr, G, R, W, ND, NDp, X, C, Y, TD,  \
            stream);                                                         \
    }

// the untiled select posterior kernels (K2 dna5, strawman, vanilla and
// sm4: sm3_bwd_tiled_sel<Spec, false, false>)
#define WAVEFRONT_BWD_SEL_ENTRY(NAME, SPEC)                                 \
    int NAME(const void* scal, const void* win, const void* xf,              \
             const void* yf, const void* basef, const void* widthf,          \
             const void* seedf, const void* raggedf, const void* fwd,        \
             void* posts, void* totals, int G, int R, int W, int ND,         \
             int NDp, int X, int C, int Y, void* stream) {                   \
        return launch_bwd_sel<SPEC, false, false>(                           \
            scal, win, xf, yf, basef, widthf, seedf, raggedf, fwd, nullptr,  \
            posts, totals, nullptr, nullptr, G, R, W, ND, NDp, X, C, Y, 0,   \
            stream);                                                         \
    }

// the untiled select expectation kernels (K3 strawman, dna5, vanilla and
// sm4: sm3_bwd_tiled_sel<Spec, true, false>)
#define WAVEFRONT_BWD_EXP_SEL_ENTRY(NAME, SPEC)                             \
    int NAME(const void* scal, const void* win, const void* xf,              \
             const void* yf, const void* basef, const void* widthf,          \
             const void* seedf, const void* raggedf, const void* fwd,        \
             void* posts, void* totals, void* trans, void* acc, int G,       \
             int R, int W, int ND, int NDp, int X, int C, int Y,             \
             void* stream) {                                                 \
        return launch_bwd_sel<SPEC, true, false>(                            \
            scal, win, xf, yf, basef, widthf, seedf, raggedf, fwd, nullptr,  \
            posts, totals, trans, acc, G, R, W, ND, NDp, X, C, Y, 0,         \
            stream);                                                         \
    }

// the untiled select kernels of a spec with an emission plane (echelon)
// take the pre-pass's plane em after the features (forward) or after the
// fwd plane (backward), as the streamed spec's entry points take est; the
// templates read it through aux, the tiled forms' shifts.  The streamed
// spec's forward (K1 hdp) takes its stream est through the forward entry
// too: the untiled select forward stages a stream as a one-leaf plane
#define WAVEFRONT_FWD_PLANE_ENTRY(NAME, SPEC)                               \
    int NAME(const void* scal, const void* win, const void* xf,              \
             const void* yf, const void* basef, const void* widthf,          \
             const void* em, void* fwd, int G, int R, int W, int ND,         \
             int NDp, int X, int C, int Y, void* stream) {                   \
        return launch_fwd_sel<SPEC, false>(                                  \
            scal, win, xf, yf, basef, widthf, fwd, const_cast<void*>(em), G, \
            R, W, ND, NDp, X, C, Y, 0, stream);                              \
    }
#define WAVEFRONT_BWD_PLANE_ENTRY(NAME, SPEC)                               \
    int NAME(const void* scal, const void* win, const void* xf,              \
             const void* yf, const void* basef, const void* widthf,          \
             const void* seedf, const void* raggedf, const void* fwd,        \
             const void* em, void* posts, void* totals, int G, int R, int W, \
             int ND, int NDp, int X, int C, int Y, void* stream) {           \
        return launch_bwd_sel<SPEC, false, false>(                           \
            scal, win, xf, yf, basef, widthf, seedf, raggedf, fwd, em,       \
            posts, totals, nullptr, nullptr, G, R, W, ND, NDp, X, C, Y, 0,   \
            stream);                                                         \
    }
// the emission pre-pass: the plane em [G, ND+3, EM_PLANE, R, W] at offset
// k (0: the forward's, 1: the backward's)
#define WAVEFRONT_EMISSIONS_ENTRY(NAME, SPEC)                               \
    int NAME(const void* win, const void* xf, const void* yf, void* em,      \
             int G, int R, int W, int ND, int NDp, int X, int C, int Y,      \
             int k, void* stream) {                                          \
        return launch_emissions<SPEC>(win, xf, yf, em, G, R, W, ND, NDp, X,  \
                                      C, Y, k, stream);                      \
    }

// the streamed spec's backward entry points take the stream est after the
// fwd plane; its posterior backward (K2 hdp) is the untiled select form
// sm3_bwd_tiled_sel<Spec, false, false>, its expectation backward (K3 hdp)
// the untiled expectation form sm3_bwd_tiled_sel<Spec, true, false>; both
// read est through aux
#define WAVEFRONT_BWD_STREAMED_ENTRY(NAME, SPEC)                            \
    int NAME(const void* scal, const void* win, const void* xf,              \
             const void* yf, const void* basef, const void* widthf,          \
             const void* seedf, const void* raggedf, const void* fwd,        \
             const void* est, void* posts, void* totals, int G, int R,       \
             int W, int ND, int NDp, int X, int C, int Y, void* stream) {    \
        return launch_bwd_sel<SPEC, false, false>(                           \
            scal, win, xf, yf, basef, widthf, seedf, raggedf, fwd, est,      \
            posts, totals, nullptr, nullptr, G, R, W, ND, NDp, X, C, Y, 0,   \
            stream);                                                         \
    }
#define WAVEFRONT_BWD_EXP_STREAMED_ENTRY(NAME, SPEC)                        \
    int NAME(const void* scal, const void* win, const void* xf,              \
             const void* yf, const void* basef, const void* widthf,          \
             const void* seedf, const void* raggedf, const void* fwd,        \
             const void* est, void* posts, void* totals, void* trans,        \
             void* acc, int G, int R, int W, int ND, int NDp, int X, int C,  \
             int Y, void* stream) {                                          \
        return launch_bwd_sel<SPEC, true, false>(                            \
            scal, win, xf, yf, basef, widthf, seedf, raggedf, fwd, est,      \
            posts, totals, trans, acc, G, R, W, ND, NDp, X, C, Y, 0,         \
            stream);                                                         \
    }

WAVEFRONT_FWD_SEL_ENTRY(wavefront_fwd, Strawman)
WAVEFRONT_FWD_SEL_ENTRY(wavefront_fwd_dna5, Dna5)
WAVEFRONT_FWD_TILED_SEL_ENTRY(wavefront_fwd_tiled, Strawman)
WAVEFRONT_FWD_TILED_SEL_ENTRY(wavefront_fwd_tiled_dna5, Dna5)
WAVEFRONT_BWD_SEL_ENTRY(wavefront_bwd, Strawman)
WAVEFRONT_BWD_SEL_ENTRY(wavefront_bwd_dna5, Dna5)
WAVEFRONT_BWD_TILED_SEL_ENTRY(wavefront_bwd_tiled, Strawman)
WAVEFRONT_BWD_TILED_SEL_ENTRY(wavefront_bwd_tiled_dna5, Dna5)

WAVEFRONT_FWD_SEL_ENTRY(wavefront_fwd_vanilla, Vanilla)
WAVEFRONT_FWD_TILED_SEL_ENTRY(wavefront_fwd_tiled_vanilla, Vanilla)
WAVEFRONT_BWD_SEL_ENTRY(wavefront_bwd_vanilla, Vanilla)
WAVEFRONT_BWD_TILED_SEL_ENTRY(wavefront_bwd_tiled_vanilla, Vanilla)

WAVEFRONT_BWD_EXP_SEL_ENTRY(wavefront_bwd_exp, Strawman)
WAVEFRONT_BWD_EXP_SEL_ENTRY(wavefront_bwd_exp_dna5, Dna5)
WAVEFRONT_BWD_EXP_SEL_ENTRY(wavefront_bwd_exp_vanilla, Vanilla)

WAVEFRONT_FWD_SEL_ENTRY(wavefront_fwd_sm4, Sm4)
WAVEFRONT_FWD_TILED_SEL_ENTRY(wavefront_fwd_tiled_sm4, Sm4)
WAVEFRONT_BWD_SEL_ENTRY(wavefront_bwd_sm4, Sm4)
WAVEFRONT_BWD_TILED_SEL_ENTRY(wavefront_bwd_tiled_sm4, Sm4)
WAVEFRONT_BWD_EXP_SEL_ENTRY(wavefront_bwd_exp_sm4, Sm4)

WAVEFRONT_EMISSIONS_ENTRY(wavefront_emissions_echelon, Echelon)
WAVEFRONT_FWD_PLANE_ENTRY(wavefront_fwd_echelon, Echelon)
WAVEFRONT_BWD_PLANE_ENTRY(wavefront_bwd_echelon, Echelon)

WAVEFRONT_FWD_PLANE_ENTRY(wavefront_fwd_hdp, Hdp)
WAVEFRONT_BWD_STREAMED_ENTRY(wavefront_bwd_hdp, Hdp)
WAVEFRONT_BWD_EXP_STREAMED_ENTRY(wavefront_bwd_exp_hdp, Hdp)

}  // extern "C"
