// Log-space helpers of the wavefront kernels, the device twins of
// cpecan_tpu_torch/ops/fb_kernels.py (log_add, log_add3, exact_log_add,
// gauss, inv_gauss) and of cpecan_tpu/ops/pallas_fb.py:44-70, :137 and
// :520-525.
//
// Built with --fmad=false and without fast math, so every expression below
// rounds like the PyTorch version on the same card: each line keeps the
// reference's evaluation order.
#pragma once

#define CPECAN_NEG (-1e30f)  // finite stand-in for LOG_ZERO (no NaNs)

// Reference piecewise-cubic logAdd (impl/pairwiseAligner.c:235-255);
// all-finite with CPECAN_NEG in place of -inf.
__device__ __forceinline__ float log_add(float x, float y) {
    const float lo = fminf(x, y);
    const float hi = fmaxf(x, y);
    const float gap = hi - lo;
    if (gap >= 7.5f) return hi;
    const float d = gap;
    float lk;
    if (d <= 1.0f) {
        lk = ((-0.009350833524763f * d + 0.130659527668286f) * d
              + 0.498799810682272f) * d + 0.693203116424741f;
    } else if (d <= 2.5f) {
        lk = ((-0.014532321752540f * d + 0.139942324101744f) * d
              + 0.495635523139337f) * d + 0.692140569840976f;
    } else if (d <= 4.5f) {
        lk = ((-0.004605031767994f * d + 0.063427417320019f) * d
              + 0.695956496475118f) * d + 0.514272634594009f;
    } else {
        lk = ((-0.000458661602210f * d + 0.009695946122598f) * d
              + 0.930734667215156f) * d + 0.168037164329057f;
    }
    return lk + lo;
}

__device__ __forceinline__ float log_add3(float a, float b, float c) {
    return log_add(log_add(a, b), c);
}

// log_add without branches, for the select kernels (sm3_fwd_tiled_sel,
// sm3_bwd_tiled_sel): the same interval tests select the four coefficients
// of the gap's cubic, then one Horner evaluation.  Under --fmad=false these
// are the same f32 operations, in the same order, as the branch log_add
// takes, so the two agree bit for bit (and with fb_kernels.log_add, which
// evaluates all four cubics and selects); lanes of a warp at different gaps
// no longer diverge.  Coefficients by interval (d <= 1.0, <= 2.5, <= 4.5,
// else), highest power first; a gap >= 7.5 still gives hi.
__device__ __forceinline__ float log_add_sel(float x, float y) {
    const float lo = fminf(x, y);
    const float hi = fmaxf(x, y);
    const float d = hi - lo;
    const bool i0 = d <= 1.0f, i1 = d <= 2.5f, i2 = d <= 4.5f;
    const float c3 = i0 ? -0.009350833524763f : i1 ? -0.014532321752540f
                   : i2 ? -0.004605031767994f : -0.000458661602210f;
    const float c2 = i0 ? 0.130659527668286f : i1 ? 0.139942324101744f
                   : i2 ? 0.063427417320019f : 0.009695946122598f;
    const float c1 = i0 ? 0.498799810682272f : i1 ? 0.495635523139337f
                   : i2 ? 0.695956496475118f : 0.930734667215156f;
    const float c0 = i0 ? 0.693203116424741f : i1 ? 0.692140569840976f
                   : i2 ? 0.514272634594009f : 0.168037164329057f;
    const float lk = ((c3 * d + c2) * d + c1) * d + c0;
    return d >= 7.5f ? hi : lk + lo;
}

__device__ __forceinline__ float log_add3_sel(float a, float b, float c) {
    return log_add_sel(log_add_sel(a, b), c);
}

// The two log-adds as types, for the updates written once for both forms
// (Strawman::fwd_update_with, the bwd_update_with of Strawman, Sm4 and
// Vanilla)
struct LogAddBranch {
    __device__ __forceinline__ static float add(float x, float y) {
        return log_add(x, y);
    }
    __device__ __forceinline__ static float add3(float a, float b,
                                                 float c) {
        return log_add3(a, b, c);
    }
};
struct LogAddSel {
    __device__ __forceinline__ static float add(float x, float y) {
        return log_add_sel(x, y);
    }
    __device__ __forceinline__ static float add3(float a, float b,
                                                 float c) {
        return log_add3_sel(a, b, c);
    }
};

// Exact log(exp(a) + exp(b)) (log1p of exp, not the cubic): the echelon
// multi-k-mer fold (_exact_log_add, pallas_fb.py:520-525).
__device__ __forceinline__ float exact_log_add(float a, float b) {
    const float hi = fmaxf(a, b);
    const float lo = fminf(a, b);
    return hi + log1pf(expf(fmaxf(lo - hi, -80.0f)));
}

// log N(x; mu, sd); CPECAN_NEG where sd <= 0 (the reference's guard).
__device__ __forceinline__ float gauss(float x, float mu, float sd) {
    if (!(sd > 0.0f)) return CPECAN_NEG;
    const float a = (x - mu) / sd;
    return -0.91893853320467267f - logf(sd) - 0.5f * a * a;
}

// gauss with the guard as a select and log(sd) given (logsd = logf(sd),
// computed once per column by the caller): the same f32 operations in the
// same order where sd > 0, so it equals gauss bit for bit; where sd <= 0
// the arithmetic's inf or NaN is discarded for CPECAN_NEG.
__device__ __forceinline__ float gauss_sel(float x, float mu, float sd,
                                           float logsd) {
    const float a = (x - mu) / sd;
    const float v = -0.91893853320467267f - logsd - 0.5f * a * a;
    return sd > 0.0f ? v : CPECAN_NEG;
}

// log inverse-Gaussian pdf (emissions_signal_logInvGaussPdf,
// impl/stateMachine.c:323-332) in the JAX _inv_gauss op order, the halving
// last; CPECAN_NEG where x <= 0, lam <= 0 or mu == 0.
__device__ __forceinline__ float inv_gauss(float x, float mu, float lam) {
    if (x <= 0.0f || lam <= 0.0f || mu == 0.0f) return CPECAN_NEG;
    const float a = (x - mu) / mu;
    return (logf(lam) - 1.8378770664093453f - 3.0f * logf(x)
            - lam * a * a / x) / 2.0f;
}

// inv_gauss with the guard as a select and the logs given (loglam =
// logf(lam), computed once per column by the caller, logx = logf(x), once
// per cell): the same f32 operations in the same order where the guard
// passes, so it equals inv_gauss bit for bit; elsewhere the arithmetic's
// inf or NaN is discarded for CPECAN_NEG.
__device__ __forceinline__ float inv_gauss_sel(float x, float mu, float lam,
                                               float loglam, float logx) {
    const float a = (x - mu) / mu;
    const float v = (loglam - 1.8378770664093453f - 3.0f * logx
                     - lam * a * a / x) / 2.0f;
    return (x <= 0.0f || lam <= 0.0f || mu == 0.0f) ? CPECAN_NEG : v;
}
