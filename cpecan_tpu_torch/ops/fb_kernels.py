"""Band-local forward/backward wavefront of the pair-HMM machines: the
log-space helpers, the machine specs (the strawman 3-state signal machine,
the vanilla 3-state signal machine, the 4-state signal machine, the 7-state
echelon signal machine and the 5-state DNA machine), the
wavefront passes (forward, posterior backward, expectation backward) as
plain PyTorch, and the wrappers that launch their CUDA kernels.

Counterparts in the JAX package (``cpecan_tpu/ops/pallas_fb.py``):

========================  ==============================================
``NEG``, ``log_add``,      ``NEG``, ``_log_add``, ``_log_add3``,
``log_add3``, ``gauss``,   ``_gauss`` (:44-70), ``_inv_gauss`` (:137)
``inv_gauss``
``StrawmanSpec``           ``_StrawmanSpec`` (:162-207)
``HdpSpec``                ``_HdpSpec`` (:2829), streamed emissions
``Sm4Spec``                ``_Sm4Spec`` (:257-337)
``Dna5Spec``               ``_Dna5Spec`` (:340-449)
``VanillaSpec``            ``_VanillaSpec`` (:456-517)
``exact_log_add``,         ``_exact_log_add`` (:520-525),
``EchelonSpec``            ``_EchelonSpec`` (:528-620)
``wavefront_fwd``          ``_sm3_forward_kernel`` (:635), untiled (on the
                           card ``sm3_fwd_tiled_sel<Spec, false>`` for
                           every spec; hdp's stages its stream)
``wavefront_bwd``          ``_sm3_backward_kernel`` -> ``_sm3_backward_body_w``
                           (:857, :900), ``with_exp=False``, untiled
``wavefront_bwd_exp``      the same body with ``with_exp=True`` (EM
                           expectations, ``accumulate_exp`` :1072), untiled
``wavefront_fwd_tiled``    ``_sm3_forward_kernel(tile=...)`` (:2304) chained
                           over the tiles by ``_run_tiled`` (:2447), with
                           ``_tile_steps.recenter`` (:2381)
``wavefront_bwd_tiled``    ``_sm3_backward_kernel(tile=...)`` (:2332) chained
                           the same way, repaying the shifts (``shf``)
``echelon_emissions``      none: the emission half of K1/K2 echelon's body
                           (``_EchelonSpec``'s emissions, :528-620), for
                           every cell first
========================  ==============================================

Layout (the JAX planes, index for index): G groups of R reads; diagonal d
of group g is a window of W lanes starting at x = ``win[g, d]``, lane l
holding cell (x = win[g, d] + l, y = d - x).  ``xf`` [G*R, NXF, X] holds
the per-x model rows, ``yf`` [G*R, 2, C+X+256] the y elements flipped so
that column C - y holds element y (a spec's ``Y_ROWS`` rows, 2 unless it
says otherwise), ``basef``/``widthf``/``seedf``/``raggedf`` [G*R, NDp] the
band metadata.  A streamed spec (``HdpSpec``) reads its match and gap-Y
emissions from ``est`` [G, ND+3, R, W] instead, the emission of diagonal d
at its own window, lane l at x = win[g, d] + l (``features.hdp_stream``);
a pass that needs them at another window realigns them, NEG outside
[0, W) (``emissions_at``, pallas_fb.py:977-1000).  Every pass and
wrapper takes the machine ``spec``
(``StrawmanSpec`` unless given); its S states shape the forward plane
[G, ND+1, S, R, W], and the posterior plane is [G, ND+1, R, W] (the match
state's), or [G, ND+1, NPS, R, W] for a spec with ``POST_STATES`` (echelon:
match1..match5).  A spec's updates read the x-feature rows
they need themselves, from window row views indexed like the full tensor
(``xf[..., i, :]`` -> [G, R, W]): the backward hands it the rows at x and
at x + 1 (clamped to the last column), the expectation sums the rows at
the target's x, as the JAX specs' ``xfw``/``xfp`` are.

Dispatch: every ``wavefront_*`` wrapper runs the plain version for a
tensor on the CPU and launches the CUDA kernel
(``cpecan_tpu_torch/csrc/wavefront.cu``) for a CUDA tensor; nothing falls
back from one to the other.  The tiled pair sweeps all ND = NT * TD
diagonals in one launch each: a tile of the TPU kernels is only a
boundary here, where the carried diagonals re-center.  Every tiled pair
(dna5, strawman, vanilla, sm4) runs the select kernels
(``sm3_fwd_tiled_sel<Spec, true>``, ``sm3_bwd_tiled_sel<Spec, false,
true>``: the same recurrences with a branch-free log-add), as do K2 dna5,
K2 strawman, K2 vanilla, K2 sm4 and K2 hdp (the untiled posterior form
``sm3_bwd_tiled_sel<Spec, false, false>``; hdp's reads its stream ``est``),
K1 strawman, K1 dna5, K1 vanilla, K1 sm4 and K1 hdp (the untiled
forward ``sm3_fwd_tiled_sel<Spec, false>``; hdp's stages the rows of its
stream), K3 dna5, K3 strawman, K3 sm4, K3 vanilla and K3 hdp (the
untiled expectation form ``sm3_bwd_tiled_sel<Spec, true, false>``;
strawman's, sm4's and hdp's targets read their emissions from the carry,
hdp's stages the rows of its stream) and K1/K2 echelon (the untiled forms
``sm3_fwd_tiled_sel<Echelon, false>`` and ``sm3_bwd_tiled_sel<Echelon,
false, false>``, each after the emission pre-pass ``echelon_emissions``,
whose plane the wrapper allocates and drops after the launch).
Every CUDA kernel's launches
are counted in ``KERNEL_LAUNCHES`` under its entry point's name
(``wavefront_fwd``, ``wavefront_fwd_dna5``,
``wavefront_fwd_vanilla``, ``wavefront_fwd_sm4``, ``wavefront_fwd_echelon``,
``wavefront_emissions_echelon``, ``wavefront_fwd_hdp``, ...); a wrapper's
``.launches`` reads its strawman entry there.  Each plain version counts
its calls in ``.calls``.
"""

import ctypes
import functools

import numpy as np
import torch

NEG = -1e30  # finite stand-in for LOG_ZERO inside the passes (no NaNs)

# strawman scalar order: [8 transitions, start(3), end(3), ragged_end(3)]
T_MM, T_XM, T_YM, T_OX, T_EX, T_SX, T_OY, T_EY = range(8)


def log_add(x, y):
    """Reference piecewise-cubic logAdd (impl/pairwiseAligner.c:235-255),
    branch-free; all-finite with NEG in place of -inf."""
    lo = torch.minimum(x, y)
    hi = torch.maximum(x, y)
    d = torch.clamp(hi - lo, max=7.5)
    p1 = ((-0.009350833524763 * d + 0.130659527668286) * d + 0.498799810682272) * d + 0.693203116424741
    p2 = ((-0.014532321752540 * d + 0.139942324101744) * d + 0.495635523139337) * d + 0.692140569840976
    p3 = ((-0.004605031767994 * d + 0.063427417320019) * d + 0.695956496475118) * d + 0.514272634594009
    p4 = ((-0.000458661602210 * d + 0.009695946122598) * d + 0.930734667215156) * d + 0.168037164329057
    lk = torch.where(d <= 1.0, p1, torch.where(
        d <= 2.5, p2, torch.where(d <= 4.5, p3, p4)))
    return torch.where((hi - lo) >= 7.5, hi, lk + lo)


def log_add3(a, b, c):
    return log_add(log_add(a, b), c)


def gauss(x, mu, sd):
    """log N(x; mu, sd); NEG where sd <= 0 (the reference's guard)."""
    log_inv_sqrt_2pi = -0.91893853320467267
    sd_ok = sd > 0.0
    sds = torch.where(sd_ok, sd, 1.0)
    a = (x - mu) / sds
    return torch.where(sd_ok, log_inv_sqrt_2pi - torch.log(sds) - 0.5 * a * a,
                       NEG)


def inv_gauss(x, mu, lam):
    """log inverse-Gaussian pdf (emissions_signal_logInvGaussPdf,
    impl/stateMachine.c:323-332), in the JAX ``_inv_gauss`` op order (the
    halving last); NEG where x <= 0, lam <= 0 or mu == 0."""
    l_two_pi = 1.8378770664093453
    bad = (x <= 0.0) | (lam <= 0.0) | (mu == 0.0)
    sx = torch.where(x > 0.0, x, 1.0)
    smu = torch.where(mu != 0.0, mu, 1.0)
    slam = torch.where(lam > 0.0, lam, 1.0)
    a = (x - smu) / smu
    out = (torch.log(slam) - l_two_pi - 3.0 * torch.log(sx)
           - slam * a * a / sx) / 2.0
    return torch.where(bad, NEG, out)


class StrawmanSpec:
    """3-state strawman signal machine (stateMachine3_cellCalculate,
    impl/stateMachine.c:1306-1335): global scalar transitions, gap-X
    emission from a per-kmer table, Gaussian x Gaussian match emission.

    ``xf`` rows are [..., 9, W] window rows (a tensor or ``_Rows``);
    transition scalars ``t`` are 0-d tensors or floats indexed by
    T_MM..T_EY."""

    NAME = "strawman"
    SUFFIX = ""   # of its CUDA kernels' entry points
    S = 3     # states: M, shortGapX, shortGapY
    NS = 8    # machine scalars
    NXF = 9   # x-feature rows
    GAP_X = 8  # the gap-X emission row of xf

    @staticmethod
    def emissions(xf, mean, noise):
        e_match = (gauss(mean, xf[..., 0, :], xf[..., 1, :])
                   + gauss(noise, xf[..., 2, :], xf[..., 3, :]))
        e_gapy = (gauss(mean, xf[..., 4, :], xf[..., 5, :])
                  + gauss(noise, xf[..., 6, :], xf[..., 7, :]))
        return e_match, e_gapy

    # inputs arrive aligned to the current window: p1m/p2m at source x-1,
    # p1 at x; n1 at x, n1p/n2p/em2p at x+1
    @staticmethod
    def fwd_update_w(t, xf, e_match, e_gapy, p1m, p1, p2m):
        e_gapx = xf[..., StrawmanSpec.GAP_X, :]
        new_x = log_add3(p1m[0] + t[T_OX], p1m[1] + t[T_EX],
                         p1m[2] + t[T_SX]) + e_gapx
        new_m = log_add3(p2m[0] + t[T_MM], p2m[1] + t[T_XM],
                         p2m[2] + t[T_YM]) + e_match
        new_y = log_add(p1[0] + t[T_OY], p1[2] + t[T_EY]) + e_gapy
        return [new_m, new_x, new_y]

    # xf at x, xfp at x+1; eg1 at x, em2p at x+1
    @staticmethod
    def bwd_update_w(t, xf, xfp, eg1, em2p, n1, n1p, n2p):
        e_gapx_p = xfp[..., StrawmanSpec.GAP_X, :]
        mid = em2p + n2p[0]
        bw_m = mid + t[T_MM]
        bw_x = mid + t[T_XM]
        bw_y = mid + t[T_YM]
        up = eg1 + n1[2]
        bw_m = log_add(bw_m, up + t[T_OY])
        bw_y = log_add(bw_y, up + t[T_EY])
        low = e_gapx_p + n1p[1]
        bw_m = log_add(bw_m, low + t[T_OX])
        bw_x = log_add(bw_x, low + t[T_EX])
        bw_y = log_add(bw_y, low + t[T_SX])
        return [bw_m, bw_x, bw_y]

    # transition lanes of the expectation sums: frm * 3 + to
    # (ContinuousPairHmm's [3, 3] transition table order; lane 5, X -> Y,
    # is not a transition of this machine and stays 0)
    EXP_LANES = {"mm": 0, "ox": 1, "oy": 2, "xm": 3, "ex": 4,
                 "ym": 6, "sx": 7, "ey": 8}
    EXP_NACC = 1       # per-column accumulators: the gap-X mass
    EXP_Y_AUX = False  # exp_probs_w reads no y element

    @staticmethod
    def exp_probs_w(t, xfw, em_t, eg_t, y_t, f0m, f1m, f1a, bw2, total):
        """Posterior transition probabilities into one target diagonal
        (cell_signal_updateTransAndKmerSkipExpectations,
        impl/pairwiseAligner.c:442-459): p = exp(min(fwd_src + transition
        + emission + bwd_target - total, 10)), in the target diagonal's
        window.  f0m = fwd[t-2] at source x-1 (middle), f1m = fwd[t-1] at
        x-1 (lower), f1a = fwd[t-1] at x (upper), bw2 = bwd[t] at x,
        em_t/eg_t = emissions(t), xfw the x-feature rows at x and y_t the
        target's y element (None: EXP_Y_AUX is False).  Returns ({name: p}
        keyed like EXP_LANES, (gap-X mass ox + ex + sx,)): the EXP_NACC
        per-column contributions."""
        def p(logp):
            # the cap keeps p finite where total is still NEG (before a
            # read's seed diagonal), so that p * band mask is never NaN
            return torch.exp(torch.clamp(logp - total, max=10.0))

        e_gapx = xfw[..., StrawmanSpec.GAP_X, :]
        mid = em_t + bw2[0]
        probs = {"mm": p(f0m[0] + t[T_MM] + mid),
                 "xm": p(f0m[1] + t[T_XM] + mid),
                 "ym": p(f0m[2] + t[T_YM] + mid)}
        low = e_gapx + bw2[1]
        probs["ox"] = p(f1m[0] + t[T_OX] + low)
        probs["ex"] = p(f1m[1] + t[T_EX] + low)
        probs["sx"] = p(f1m[2] + t[T_SX] + low)
        up = eg_t + bw2[2]
        probs["oy"] = p(f1a[0] + t[T_OY] + up)
        probs["ey"] = p(f1a[2] + t[T_EY] + up)
        return probs, (probs["ox"] + probs["ex"] + probs["sx"],)


class HdpSpec(StrawmanSpec):
    """The strawman machine with HDP k-mer density emissions
    (stateMachine3HDP_cellCalculate, impl/stateMachine.c:1337-1366): the
    strawman's topology, transitions, gap-X row and expectations; the
    match and gap-Y emission is one spline density, streamed
    (``STREAMED``): the passes read it from ``est`` rather than computing
    it from the feature rows (``emissions`` is never called)."""

    NAME = "hdp"
    SUFFIX = "_hdp"
    STREAMED = True


# 4-state signal machine scalar order: lower(5), middle(4), upper(2)
(T4_SOX, T4_SEX, T4_LOX, T4_LEX, T4_LSX,
 T4_MM, T4_MSX, T4_MSY, T4_MLX,
 T4_SOY, T4_SEY) = range(11)


class Sm4Spec:
    """4-state signal machine (stateMachine4_cellCalculate,
    impl/stateMachine.c:868-898): states M, shortGapX, shortGapY, longGapX;
    the strawman's emissions and x-feature rows (gap-X row 8 for both X
    states).  The updates keep the JAX spec's ``log_add`` grouping exactly
    (the piecewise-cubic ``log_add`` is not associative in f32)."""

    NAME = "sm4"
    SUFFIX = "_sm4"
    S = 4
    NS = 11
    NXF = 9
    GAP_X = 8

    emissions = staticmethod(StrawmanSpec.emissions)

    @staticmethod
    def fwd_update_w(t, xf, e_match, e_gapy, p1m, p1, p2m):
        e_gapx = xf[..., Sm4Spec.GAP_X, :]
        new_sx = log_add(p1m[0] + t[T4_SOX], p1m[1] + t[T4_SEX]) + e_gapx
        new_lx = log_add3(p1m[0] + t[T4_LOX], p1m[3] + t[T4_LEX],
                          p1m[2] + t[T4_LSX]) + e_gapx
        new_m = log_add(
            log_add(p2m[0] + t[T4_MM], p2m[1] + t[T4_MSX]),
            log_add(p2m[2] + t[T4_MSY], p2m[3] + t[T4_MLX])) + e_match
        new_sy = log_add(p1[0] + t[T4_SOY], p1[2] + t[T4_SEY]) + e_gapy
        return [new_m, new_sx, new_sy, new_lx]

    @staticmethod
    def bwd_update_w(t, xf, xfp, eg1, em2p, n1, n1p, n2p):
        e_gapx_p = xfp[..., Sm4Spec.GAP_X, :]
        mid = em2p + n2p[0]
        low_s = e_gapx_p + n1p[1]
        low_l = e_gapx_p + n1p[3]
        up = eg1 + n1[2]
        bw_m = log_add(log_add(mid + t[T4_MM], low_s + t[T4_SOX]),
                       log_add(low_l + t[T4_LOX], up + t[T4_SOY]))
        bw_sx = log_add(mid + t[T4_MSX], low_s + t[T4_SEX])
        bw_sy = log_add3(mid + t[T4_MSY], low_l + t[T4_LSX], up + t[T4_SEY])
        bw_lx = log_add(mid + t[T4_MLX], low_l + t[T4_LEX])
        return [bw_m, bw_sx, bw_sy, bw_lx]

    # transition lanes frm * 4 + to over (M, SX, SY, LX): the 11
    # transitions of the machine; lanes 6, 7, 9, 13 and 14 stay 0
    EXP_LANES = {"mm": 0, "sxm": 4, "sym": 8, "lxm": 12,
                 "msx": 1, "sxsx": 5,
                 "mlx": 3, "lxlx": 15, "sylx": 11,
                 "msy": 2, "sysy": 10}
    EXP_NACC = 1       # per-column accumulators: the shortGapX mass
    EXP_Y_AUX = False

    @staticmethod
    def exp_probs_w(t, xfw, em_t, eg_t, y_t, f0m, f1m, f1a, bw2, total):
        """``_Sm4Spec.exp_probs_w`` (pallas_fb.py:275-304, op for op):
        ({name: p} keyed like EXP_LANES, (the k-mer gap mass msx + sxsx,)):
        the reference counts gap-X k-mers into the shortGapX target only
        (impl/pairwiseAligner.c:456-459), not longGapX."""
        def p(logp):
            return torch.exp(torch.clamp(logp - total, max=10.0))

        e_gapx = xfw[..., Sm4Spec.GAP_X, :]
        mid = em_t + bw2[0]
        probs = {"mm": p(f0m[0] + t[T4_MM] + mid),
                 "sxm": p(f0m[1] + t[T4_MSX] + mid),
                 "sym": p(f0m[2] + t[T4_MSY] + mid),
                 "lxm": p(f0m[3] + t[T4_MLX] + mid)}
        low_s = e_gapx + bw2[1]
        low_l = e_gapx + bw2[3]
        probs["msx"] = p(f1m[0] + t[T4_SOX] + low_s)
        probs["sxsx"] = p(f1m[1] + t[T4_SEX] + low_s)
        probs["mlx"] = p(f1m[0] + t[T4_LOX] + low_l)
        probs["lxlx"] = p(f1m[3] + t[T4_LEX] + low_l)
        probs["sylx"] = p(f1m[2] + t[T4_LSX] + low_l)
        up = eg_t + bw2[2]
        probs["msy"] = p(f1a[0] + t[T4_SOY] + up)
        probs["sysy"] = p(f1a[2] + t[T4_SEY] + up)
        return probs, (probs["msx"] + probs["sxsx"],)


# 5-state DNA machine scalar order: lower(4), middle(5), upper(4)
(T5_SOX, T5_SEX, T5_LOX, T5_LEX,
 T5_MM, T5_MSX, T5_MSY, T5_MLX, T5_MLY,
 T5_SOY, T5_SEY, T5_LOY, T5_LEY) = range(13)


class Dna5Spec:
    """Classic 5-state affine-gap DNA pair-HMM (stateMachine5_cellCalculate,
    impl/stateMachine.c:830-866): states M, shortGapX, shortGapY, longGapX,
    longGapY.

    ``xf`` rows 0..4 are the match emissions of the x base against y base
    0..4 (4 = N), row 5 the gap-X emission; ``yf`` row 0 carries the y base
    index as a float, row 1 the gap-Y emission.  EM expectations
    (cell_updateExpectations, impl/pairwiseAligner.c:423-441): the 13
    transitions of the machine and the posterior mass into each state by
    y base (``exp_probs_w``)."""

    NAME = "dna5"
    SUFFIX = "_dna5"
    S = 5
    NS = 13
    NXF = 6
    GAP_X = 5

    @staticmethod
    def emissions(xf, mean, noise):
        # the match row picked by the y base: a sum of five selects, as the
        # JAX spec has it (a value outside 0..4 gives 0.0, not a row)
        e_match = torch.where(mean == 0.0, xf[..., 0, :], 0.0)
        for b in range(1, 5):
            e_match = e_match + torch.where(mean == float(b), xf[..., b, :],
                                            0.0)
        return e_match, noise

    @staticmethod
    def fwd_update_w(t, xf, e_match, e_gapy, p1m, p1, p2m):
        e_gapx = xf[..., Dna5Spec.GAP_X, :]
        new_sx = log_add(p1m[0] + t[T5_SOX], p1m[1] + t[T5_SEX]) + e_gapx
        new_lx = log_add(p1m[0] + t[T5_LOX], p1m[3] + t[T5_LEX]) + e_gapx
        new_m = log_add(
            log_add3(p2m[0] + t[T5_MM], p2m[1] + t[T5_MSX],
                     p2m[2] + t[T5_MSY]),
            log_add(p2m[3] + t[T5_MLX], p2m[4] + t[T5_MLY])) + e_match
        new_sy = log_add(p1[0] + t[T5_SOY], p1[2] + t[T5_SEY]) + e_gapy
        new_ly = log_add(p1[0] + t[T5_LOY], p1[4] + t[T5_LEY]) + e_gapy
        return [new_m, new_sx, new_sy, new_lx, new_ly]

    @staticmethod
    def bwd_update_w(t, xf, xfp, eg1, em2p, n1, n1p, n2p):
        # the JAX grouping, kept exactly: the piecewise-cubic log_add is not
        # associative in f32
        e_gapx_p = xfp[..., Dna5Spec.GAP_X, :]
        mid = em2p + n2p[0]
        low_s = e_gapx_p + n1p[1]
        low_l = e_gapx_p + n1p[3]
        up_s = eg1 + n1[2]
        up_l = eg1 + n1[4]
        bw_m = log_add(
            log_add3(mid + t[T5_MM], low_s + t[T5_SOX], low_l + t[T5_LOX]),
            log_add(up_s + t[T5_SOY], up_l + t[T5_LOY]))
        bw_sx = log_add(mid + t[T5_MSX], low_s + t[T5_SEX])
        bw_sy = log_add(mid + t[T5_MSY], up_s + t[T5_SEY])
        bw_lx = log_add(mid + t[T5_MLX], low_l + t[T5_LEX])
        bw_ly = log_add(mid + t[T5_MLY], up_l + t[T5_LEY])
        return [bw_m, bw_sx, bw_sy, bw_lx, bw_ly]

    # transition lanes frm * 5 + to over (M, SX, SY, LX, LY): the 13
    # transitions of the machine; the other 12 lanes of the [5, 5] table
    # stay 0
    EXP_LANES = {"mm": 0, "sxm": 5, "sym": 10, "lxm": 15, "lym": 20,
                 "msx": 1, "sxsx": 6, "mlx": 3, "lxlx": 18,
                 "msy": 2, "sysy": 12, "mly": 4, "lyly": 24}
    # per-column accumulators to * 4 + by: the mass into state ``to`` at a
    # cell of y base ``by`` (N, base 4, gets none, as in the engine)
    EXP_NACC = 20
    EXP_Y_AUX = True

    @staticmethod
    def exp_probs_w(t, xfw, em_t, eg_t, y_t, f0m, f1m, f1a, bw2, total):
        """``StrawmanSpec.exp_probs_w`` for the 5-state machine
        (``_Dna5Spec.exp_probs_w``, pallas_fb.py:406-449, op for op):
        ({name: p} keyed like EXP_LANES, the 20 contributions
        where(y_t == by, p_to[to], 0) in order to * 4 + by), p_to[to] the
        posterior mass into state ``to`` summed in the JAX order."""
        def p(logp):
            return torch.exp(torch.clamp(logp - total, max=10.0))

        # middle: (t-2, x-1) -> M; lower: (t-1, x-1) -> SX / LX; upper:
        # (t-1, x) -> SY / LY
        e_gapx = xfw[..., Dna5Spec.GAP_X, :]
        mid = em_t + bw2[0]
        probs = {"mm": p(f0m[0] + t[T5_MM] + mid),
                 "sxm": p(f0m[1] + t[T5_MSX] + mid),
                 "sym": p(f0m[2] + t[T5_MSY] + mid),
                 "lxm": p(f0m[3] + t[T5_MLX] + mid),
                 "lym": p(f0m[4] + t[T5_MLY] + mid)}
        low_s = e_gapx + bw2[1]
        low_l = e_gapx + bw2[3]
        probs["msx"] = p(f1m[0] + t[T5_SOX] + low_s)
        probs["sxsx"] = p(f1m[1] + t[T5_SEX] + low_s)
        probs["mlx"] = p(f1m[0] + t[T5_LOX] + low_l)
        probs["lxlx"] = p(f1m[3] + t[T5_LEX] + low_l)
        up_s = eg_t + bw2[2]
        up_l = eg_t + bw2[4]
        probs["msy"] = p(f1a[0] + t[T5_SOY] + up_s)
        probs["sysy"] = p(f1a[2] + t[T5_SEY] + up_s)
        probs["mly"] = p(f1a[0] + t[T5_LOY] + up_l)
        probs["lyly"] = p(f1a[4] + t[T5_LEY] + up_l)
        p_to = [(probs["mm"] + probs["sxm"] + probs["sym"] + probs["lxm"]
                 + probs["lym"]),
                probs["msx"] + probs["sxsx"],
                probs["msy"] + probs["sysy"],
                probs["mlx"] + probs["lxlx"],
                probs["mly"] + probs["lyly"]]
        return probs, tuple(torch.where(y_t == float(by), p_to[to], 0.0)
                            for to in range(5) for by in range(4))


# vanilla machine scalar order
VA_YM, VA_YY = range(2)


class VanillaSpec:
    """Nanopolish-style vanilla 3-state signal machine
    (stateMachine3Vanilla_cellCalculate, impl/stateMachine.c:1368-1409;
    signalAlign's default): states M, shortGapX, shortGapY.

    ``xf`` rows 0-3 are the match model (level mean, level sd, noise mean,
    noise lambda) and rows 4-7 the gap-Y model of the column's k-mer,
    Gaussian x inverse-Gaussian over (event mean, noise); rows 8-12 the
    per-column transitions from the k-mer skip bins: log a_mx, a_xx, a_mm,
    a_xm, a_my.  The two scalars are the strand's Y -> M and Y -> Y.
    Gap-X is silent (no emission).  EM expectations
    (cell_signal_updateBetaAndAlphaProb, impl/pairwiseAligner.c:493-513):
    no transition lanes, two per-column accumulators, the beta (M -> X)
    and alpha (X -> X) masses of each target column."""

    NAME = "vanilla"
    SUFFIX = "_vanilla"
    S = 3
    NS = 2
    NXF = 13
    LA_MX, LA_XX, LA_MM, LA_XM, LA_MY = range(8, 13)

    @staticmethod
    def emissions(xf, mean, noise):
        e_match = (gauss(mean, xf[..., 0, :], xf[..., 1, :])
                   + inv_gauss(noise, xf[..., 2, :], xf[..., 3, :]))
        e_gapy = (gauss(mean, xf[..., 4, :], xf[..., 5, :])
                  + inv_gauss(noise, xf[..., 6, :], xf[..., 7, :]))
        return e_match, e_gapy

    @staticmethod
    def fwd_update_w(t, xf, e_match, e_gapy, p1m, p1, p2m):
        V = VanillaSpec
        new_x = log_add(p1m[0] + xf[..., V.LA_MX, :],
                        p1m[1] + xf[..., V.LA_XX, :])
        new_m = log_add3(p2m[0] + xf[..., V.LA_MM, :],
                         p2m[1] + xf[..., V.LA_XM, :],
                         p2m[2] + t[VA_YM]) + e_match
        new_y = log_add(p1[0] + xf[..., V.LA_MY, :],
                        p1[2] + t[VA_YY]) + e_gapy
        return [new_m, new_x, new_y]

    @staticmethod
    def bwd_update_w(t, xf, xfp, eg1, em2p, n1, n1p, n2p):
        # the transitions into a cell at x+1 are x+1's rows; M -> Y is x's
        V = VanillaSpec
        mid = em2p + n2p[0]
        up = eg1 + n1[2]
        low = n1p[1]   # silent gap-X: no emission on lower
        bw_m = log_add3(mid + xfp[..., V.LA_MM, :], low + xfp[..., V.LA_MX, :],
                        up + xf[..., V.LA_MY, :])
        bw_x = log_add(mid + xfp[..., V.LA_XM, :], low + xfp[..., V.LA_XX, :])
        bw_y = log_add(mid + t[VA_YM], up + t[VA_YY])
        return [bw_m, bw_x, bw_y]

    EXP_LANES = {}
    EXP_NACC = 2       # per-column accumulators: beta (M -> X), alpha (X -> X)
    EXP_Y_AUX = False

    @staticmethod
    def exp_probs_w(t, xfw, em_t, eg_t, y_t, f0m, f1m, f1a, bw2, total):
        """``_VanillaSpec.exp_probs_w`` (pallas_fb.py:506-517): ({}, (beta,
        alpha)), the M -> X and X -> X posterior masses into the target's
        shortGapX at x, with the transitions of the target column."""
        def p(logp):
            return torch.exp(torch.clamp(logp - total, max=10.0))

        low = bw2[1]   # silent gap-X: no emission
        p_beta = p(f1m[0] + xfw[..., VanillaSpec.LA_MX, :] + low)
        p_alpha = p(f1m[1] + xfw[..., VanillaSpec.LA_XX, :] + low)
        return {}, (p_beta, p_alpha)


def exact_log_add(a, b):
    """Exact log(exp(a) + exp(b)) (log1p of exp, not the piecewise cubic):
    the echelon multi-k-mer fold uses the true logAdd in the reference
    too (``_exact_log_add``, pallas_fb.py:520-525)."""
    hi = torch.maximum(a, b)
    lo = torch.minimum(a, b)
    return hi + torch.log1p(torch.exp(torch.clamp(lo - hi, min=-80.0)))


# log(n) of the multi-k-mer split, n = 1..5: float(np.log(n)) rounded to f32
# as the JAX trace rounds the Python constant
_LOG_N = [float(np.float32(np.log(n))) for n in range(1, 6)]
# echelon x-feature rows: per-offset match models 4i..4i+3 (i = 0..4), the
# gap-Y model of the first k-mer 20..23, the skip logs 24..27, the validity
# of n = 1..5 k-mers 28..32
EC_GAP_Y = 20
EC_LA_MX, EC_LA_MH, EC_LA_XX, EC_LA_XH = range(24, 28)
EC_VALID = 27   # + n


class EchelonSpec:
    """7-state echelon signal machine (stateMachineEchelon_cellCalculate,
    impl/stateMachine.c:1411-1459): states match0, match1..match5, gap-X.
    An event emits 1..5 k-mers with a Poisson duration posterior (match_n,
    from any state at (x - 1, y - 1)) or none (match0, an extra event from
    match1..5 at (x, y - 1)); gap-X skips a k-mer silently.  The transitions
    are per column (the skip logs of its k-mer skip bin, rows 24-27); there
    are no transition scalars (NS 0).

    ``xf`` rows: 4i..4i+3 the (level mean, level sd, noise mean, noise
    lambda) of the k-mer at offset i, i = 0..4; 20..23 the gap-Y model of
    the first k-mer; 24..27 la_mx, la_mh, la_xx, la_xh; 28..32 the validity
    of n = 1..5 k-mers.  ``yf`` rows (Y_ROWS 8): 0..5 the duration
    posteriors dur_0..dur_5, 6 the event mean, 7 the noise.  The match
    emission is the 5-tuple of per-n terms, which the backward carries
    and realigns leaf by leaf; the posteriors are those of
    match1..match5 (POST_STATES), expanded to n pairs each on the host
    (diagonalCalculationMultiPosteriorMatchProbs,
    impl/pairwiseAligner.c:824-866).  No K3: the reference defines no
    echelon EM (its cellCalculateUpdateExpectations is NULL,
    impl/stateMachine.c:1823-1833), and no tiled path."""

    NAME = "echelon"
    SUFFIX = "_echelon"
    S = 7
    NS = 0
    NXF = 33
    Y_ROWS = 8
    POST_STATES = (1, 2, 3, 4, 5)
    # the leaves of the emission pre-pass's plane (``echelon_emissions``):
    # the five match terms, then the gap-Y term
    EM_LEAVES = 6

    @staticmethod
    def emissions(xf, *ys):
        """((w_1..w_5), scaled): w_n = max(e_n + dur_n, NEG), e_n the n-k-mer
        match term (the exact fold over offsets 0..n-1, from 0.0, minus
        log n; NEG where n k-mers do not fit), scaled = the gap-Y term of
        the first k-mer + dur_0."""
        dur = ys[:6]
        mean, noise = ys[6], ys[7]
        # multipleKmerMatchProb folds from 0.0, not log-zero: a reference
        # quirk kept bit for bit (impl/stateMachine.c:533)
        acc = torch.zeros_like(mean)
        w_n = []
        for n in range(1, 6):
            i = n - 1
            term = (gauss(mean, xf[..., 4 * i, :], xf[..., 4 * i + 1, :])
                    + inv_gauss(noise, xf[..., 4 * i + 2, :],
                                xf[..., 4 * i + 3, :]))
            acc = exact_log_add(acc, term)
            e_n = torch.where(xf[..., EC_VALID + n, :] > 0.5,
                              acc - _LOG_N[i], NEG)
            w_n.append(torch.clamp(e_n + dur[n], min=NEG))
        e_scaled = (gauss(mean, xf[..., EC_GAP_Y, :], xf[..., EC_GAP_Y + 1, :])
                    + inv_gauss(noise, xf[..., EC_GAP_Y + 2, :],
                                xf[..., EC_GAP_Y + 3, :]))
        return tuple(w_n), torch.clamp(e_scaled + dur[0], min=NEG)

    @staticmethod
    def fwd_update_w(t, xf, e_match, e_gapy, p1m, p1, p2m):
        la_mx = xf[..., EC_LA_MX, :]
        la_mh = xf[..., EC_LA_MH, :]
        la_xx = xf[..., EC_LA_XX, :]
        la_xh = xf[..., EC_LA_XH, :]
        # middle: every state at (d-2, x-1) -> match_n; the transition is
        # the same for every n, so the sources fold once
        src_m = p2m[0]
        for i in range(1, 6):
            src_m = log_add(src_m, p2m[i])
        mid = log_add(src_m + la_mh, p2m[6] + la_xh)
        new_mn = [mid + w for w in e_match]
        # upper: match_1..5 at (d-1, x) -> match0 (an extra event)
        src_u = p1[1]
        for i in range(2, 6):
            src_u = log_add(src_u, p1[i])
        new_m0 = src_u + la_mh + e_gapy
        # lower: match_1..5 / gap-X at (d-1, x-1) -> gap-X (silent)
        src_l = p1m[1]
        for i in range(2, 6):
            src_l = log_add(src_l, p1m[i])
        new_x = log_add(src_l + la_mx, p1m[6] + la_xx)
        return [new_m0] + new_mn + [new_x]

    @staticmethod
    def bwd_update_w(t, xf, xfp, eg1, em2p, n1, n1p, n2p):
        # em2p: the per-n terms at (d+2, x+1); eg1: scaled + dur_0 at
        # (d+1, x); the transitions into x+1 are column x+1's, into match0
        # (at x) column x's
        mid = em2p[0] + n2p[1]
        for n in range(2, 6):
            mid = log_add(mid, em2p[n - 1] + n2p[n])
        low = n1p[6]
        up = eg1 + n1[0]
        la_mh_p = xfp[..., EC_LA_MH, :]
        bw_m0 = mid + la_mh_p
        # match_1..5 share one outgoing fan (they differ in their forward
        # emissions only)
        bw_m = log_add3(mid + la_mh_p, low + xfp[..., EC_LA_MX, :],
                        up + xf[..., EC_LA_MH, :])
        bw_x = log_add(mid + xfp[..., EC_LA_XH, :],
                       low + xfp[..., EC_LA_XX, :])
        return [bw_m0] + [bw_m] * 5 + [bw_x]


def _no_expectations(spec):
    """Refuse an expectation pass for a spec without one."""
    if spec is EchelonSpec:
        raise NotImplementedError(
            "the echelon machine has no EM expectations: the reference "
            "defines none (its cellCalculateUpdateExpectations is NULL, "
            "impl/stateMachine.c:1823-1833)")
    if not hasattr(spec, "exp_probs_w"):
        raise NotImplementedError(
            f"{spec.NAME} EM expectations are not ported yet (ROADMAP Queue "
            f"1 item 3 and Queue 2: the {spec.NAME} spec rows)")


def post_states(spec):
    """The states whose posteriors a spec's backward writes: (0,), the
    match state, unless it names its own (``POST_STATES``)."""
    return getattr(spec, "POST_STATES", (0,))


def post_planes(spec):
    """The state axis of a spec's posterior output: () for the match plane
    alone ([G, ND+1, R, W]), (NPS,) for one plane per state of
    ``POST_STATES`` ([G, ND+1, NPS, R, W]).  Empty (false) for every
    one-match spec."""
    return (len(spec.POST_STATES),) if hasattr(spec, "POST_STATES") else ()


def streamed(spec):
    """Whether a spec reads its emissions from a stream (``HdpSpec``)."""
    return getattr(spec, "STREAMED", False)


def planar(spec):
    """Whether a spec's kernels read their emissions from the plane of an
    emission pre-pass (``EchelonSpec``: ``echelon_emissions``)."""
    return getattr(spec, "EM_LEAVES", 0) > 0


def _tmap(fn, v):
    """fn on each leaf of a spec's emission (a tensor or a tuple of them)."""
    return tuple(fn(x) for x in v) if isinstance(v, tuple) else fn(v)


# ---------------------------------------------------------------------------
# Plain PyTorch passes: every read of every group at once, one Python step
# per diagonal.  Tensors are [G, R, W] per state; the per-group window
# shifts become gathers along the lane axis.
# ---------------------------------------------------------------------------

class _Frame:
    """Per-call views shared by the plain passes; ``plane`` a planar
    spec's emission plane at offset ``k`` (``echelon_emissions_plain``),
    read in place of the inline emissions."""

    def __init__(self, scal, win, xf, yf, basef, widthf, R, W, spec,
                 est=None, plane=None, k=0):
        self.spec = spec
        self.est = est
        self.plane, self.k = plane, k
        self.G = win.shape[0]
        self.R, self.W = R, W
        dev = xf.device
        if scal is not None:
            self.t = scal.reshape(-1).to(torch.float32)
        self.win = win.to(torch.int64)
        self.lane = torch.arange(W, device=dev)
        self.xf = xf.reshape(self.G, R, xf.shape[1], xf.shape[2])
        self.yf = yf.reshape(self.G, R, yf.shape[1], yf.shape[2])
        if basef is not None:
            self.basef = basef.reshape(self.G, R, -1)
            self.widthf = widthf.reshape(self.G, R, -1)

    def align(self, v, s):
        """out[g, r, l] = v[g, r, l + s[g]]; NEG where l + s[g] falls
        outside [0, W) (never a wrap)."""
        j = self.lane[None, :] + s[:, None]                  # [G, W]
        ok = (j >= 0) & (j < self.W)
        jc = j.clamp(0, self.W - 1)[:, None, :].expand_as(v)
        return torch.where(ok[:, None, :], torch.gather(v, 2, jc), NEG)

    def cols(self, plane, start):
        """plane[g, r, row, start[g] + l] -> [G, R, rows, W]."""
        j = (start[:, None] + self.lane[None, :]).clamp(
            max=plane.shape[-1] - 1)
        j = j[:, None, None, :].expand(self.G, self.R, plane.shape[2], self.W)
        return torch.gather(plane, 3, j)

    def xcoord(self, w):
        return (self.lane[None, :] + w[:, None])[:, None, :]   # [G, 1, W]

    def band(self, d, w):
        base = self.basef[:, :, d:d + 1]
        width = self.widthf[:, :, d:d + 1]
        xl = self.xcoord(w).to(torch.float32)
        return (xl >= base) & (xl < base + width)

    def emissions(self, d, w, C):
        """(x-feature rows, match, gap-Y emission) of diagonal d at
        x = w[g] + l; the spec reads its Y_ROWS y rows, a streamed spec
        the stream of d realigned from its own window to w, and given a
        plane the plane's slot d - k (which holds diagonal d at that
        slot's window: the windows the passes ask for)."""
        xfw = self.cols(self.xf, w)
        if self.plane is not None:
            e = self.plane[:, d - self.k]
            n = self.spec.EM_LEAVES - 1
            return xfw, tuple(e[:, j] for j in range(n)), e[:, n]
        if streamed(self.spec):
            e = self.align(self.est[:, d], w - self.win[:, d])
            return xfw, e, e
        ys = self.cols(self.yf, C - d + w)
        n = getattr(self.spec, "Y_ROWS", 2)
        return (xfw,) + self.spec.emissions(xfw, *(ys[:, :, i]
                                                   for i in range(n)))


class _Rows:
    """Lazy window rows of a frame's ``xf`` for the windows starting at
    ``start`` [G]: ``rows[..., i, :]`` is row i at x = start[g] + l
    (clamped to the last column), [G, R, W], gathered when a spec first
    reads it."""

    def __init__(self, fr, start):
        self.fr, self.start, self.got = fr, start, {}

    def __getitem__(self, key):
        i = key[-2]
        if i not in self.got:
            self.got[i] = self.fr.cols(self.fr.xf[:, :, i:i + 1],
                                       self.start)[:, :, 0]
        return self.got[i]


def _recenter(vals, acc):
    """Per-read log-space re-centering of carried diagonals (``_tile_steps.
    recenter``, pallas_fb.py:2381-2394): m = the max over every state and
    lane of ``vals`` ([G, R, W] tensors); where m > -1e20 (the read is
    seeded) subtract it from each and add it to the running shift ``acc``
    [G, R].  Returns (shifted vals, acc)."""
    m = torch.stack(vals).amax(dim=(0, 3))                    # [G, R]
    c = torch.where(m > -1e20, m, 0.0)
    return [v - c[..., None] for v in vals], acc + c


def _forward(scal, win, xf, yf, basef, widthf, R, W, ND, C, TD, spec,
             est=None, plane=None):
    """The plain forward sweep shared by ``forward_plain`` and
    ``forward_tiled_plain``; with ``TD`` the carries re-center at every
    tile boundary (before diagonal t * TD + 1, t >= 1) and the shift each
    tile's rows carry comes back as [G, R, ND // TD]."""
    fr = _Frame(scal, win, xf, yf, basef, widthf, R, W, spec, est, plane, 0)
    t, S = fr.t, spec.S
    out = torch.empty((fr.G, ND + 1, S, R, W), dtype=torch.float32,
                      device=xf.device)
    w0 = fr.win[:, 0]
    m0 = fr.band(0, w0)
    prev1 = [torch.where(m0, t[spec.NS + i], NEG) for i in range(S)]
    prev2 = [torch.full((fr.G, R, W), NEG, device=xf.device)] * S
    if TD:
        acc = torch.zeros((fr.G, R), device=xf.device)
        shifts = torch.zeros((fr.G, R, ND // TD), device=xf.device)
    for i in range(S):
        out[:, 0, i] = prev1[i]
    for d in range(1, ND + 1):
        if TD and d > 1 and (d - 1) % TD == 0:
            both, acc = _recenter(prev1 + prev2, acc)
            prev1, prev2 = both[:S], both[S:]
            shifts[:, :, (d - 1) // TD] = acc
        w = fr.win[:, d]
        s1 = w - fr.win[:, d - 1]
        s2 = w - fr.win[:, max(d - 2, 0)]
        p1m = [fr.align(v, s1 - 1) for v in prev1]
        p1a = [fr.align(v, s1) for v in prev1]
        p2m = [fr.align(v, s2 - 1) for v in prev2]
        xfw, e_match, e_gapy = fr.emissions(d, w, C)
        new = spec.fwd_update_w(t, xfw, e_match, e_gapy, p1m, p1a, p2m)
        mask = fr.band(d, w)
        new = [torch.where(mask, v, NEG) for v in new]
        for i in range(S):
            out[:, d, i] = new[i]
        prev2, prev1 = prev1, new
    return (out, shifts) if TD else out


def forward_plain(scal, win, xf, yf, basef, widthf, *, R, W, ND, C,
                  spec=StrawmanSpec, est=None, plane=None):
    """Plain PyTorch forward pass: fwd plane [G, ND+1, S, R, W] (f32).
    Out-of-band cells hold exactly NEG.  A streamed spec reads its
    emissions from ``est`` [G, ND+3, R, W]; a planar spec reads them from
    ``plane``, the k = 0 plane of ``echelon_emissions_plain``, when given
    (the same values as its inline emissions)."""
    forward_plain.calls += 1
    return _forward(scal, win, xf, yf, basef, widthf, R, W, ND, C, None,
                    spec, est, plane)


forward_plain.calls = 0


def forward_tiled_plain(scal, win, xf, yf, basef, widthf, *, R, W, ND, C,
                        TD, spec=StrawmanSpec):
    """Plain PyTorch tiled forward over ND = NT * TD diagonals (the long-
    alignment forward, ``_sm3_forward_kernel(tile=...)`` chained by
    ``_run_tiled``): (fwd plane [G, ND+1, S, R, W], shifts [G, R, NT]).

    The same recurrence as ``forward_plain``, but before diagonal
    t * TD + 1 (t >= 1) the two carried diagonals of each read re-center:
    their max m over all states and lanes (if > -1e20) is subtracted and
    added to the read's running shift.  The rows of tile t (diagonals
    t * TD + 1 .. t * TD + TD, and diagonal 0 for t = 0) hold the absolute
    forward minus shifts[..., t]; shifts[..., 0] = 0."""
    forward_tiled_plain.calls += 1
    return _forward(scal, win, xf, yf, basef, widthf, R, W, ND, C, TD, spec)


forward_tiled_plain.calls = 0


def _masked_lse(v, mask):
    """Per-read log-sum-exp over the lanes inside ``mask`` -> [G, R, 1],
    the lanes summed in the kernels' ``block_sum`` order."""
    vv = torch.where(mask, v, NEG)
    m = vv.amax(dim=-1, keepdim=True)
    s = block_sum(torch.where(mask, torch.exp(vv - m), 0.0))[..., None]
    return m + torch.log(torch.clamp(s, min=1e-37))


def block_sum(v):
    """Sum over the last axis (W lanes, a multiple of 32) in the CUDA
    kernels' ``block_sum`` order: an xor butterfly inside each warp of 32
    lanes, then the warps' partials left to right."""
    W = v.shape[-1]
    v = v.reshape(v.shape[:-1] + (W // 32, 32))
    lane = torch.arange(32, device=v.device)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lane ^ o]
    parts = v[..., 0]
    s = parts[..., 0]
    for i in range(1, W // 32):
        s = s + parts[..., i]
    return s


class _Expectations:
    """The expectation sums of one plain backward: per-lane transition sums
    (added up over the target diagonals, reduced over lanes at the end, as
    the kernel's per-thread registers are) and the spec's EXP_NACC
    per-column accumulators [G, NACC, R, X] in x frame."""

    def __init__(self, fr, C):
        self.fr, self.C = fr, C
        S = fr.spec.S
        self.acc = [torch.zeros((fr.G, fr.R, fr.W), device=fr.xf.device)
                    for _ in range(S * S)]
        self.cols = torch.zeros(
            (fr.G, fr.spec.EXP_NACC, fr.R, fr.xf.shape[-1]),
            device=fr.xf.device)

    def add(self, d_t, wt, em_t, eg_t, f0m, f1m, f1a, bw2, total):
        """Contributions of target diagonal ``d_t`` (window ``wt``), every
        input aligned to that window (``accumulate_exp``, :1072-1095); the
        target's y element is read fresh at column C - d_t + x
        (pallas_fb.py:1077), not carried."""
        fr = self.fr
        spec = fr.spec
        y_t = (fr.cols(fr.yf[:, :, :1], self.C - d_t + wt)[:, :, 0]
               if spec.EXP_Y_AUX else None)
        probs, contribs = spec.exp_probs_w(fr.t, _Rows(fr, wt), em_t, eg_t,
                                           y_t, f0m, f1m, f1a, bw2, total)
        m = fr.band(d_t, wt).to(torch.float32)
        for name, k in spec.EXP_LANES.items():
            self.acc[k] = self.acc[k] + probs[name] * m
        x = fr.xcoord(wt)[:, None].expand(fr.G, len(contribs), fr.R, fr.W)
        self.add_cols(x, torch.stack(contribs, 1) * m[:, None])

    def add_cols(self, x, v):
        """Add one target's terms ``v`` to the accumulators' columns ``x``.
        Each column of a read takes one term per accumulator from a target,
        so a gather, an add and a scatter sum it; scatter_add_'s atomic
        adds on the card would flush denormal terms that the kernels' plain
        adds keep (dna5's kernel adds atomically: the denormal margin of
        parity.KERNEL_GAPX_ATOL)."""
        self.cols.scatter_(3, x, self.cols.gather(3, x) + v)

    def result(self):
        """(trans [G, R, S*S], per-column accumulators [G, NACC, R, X])."""
        trans = torch.stack([block_sum(a) for a in self.acc], dim=-1)
        return trans, self.cols


def _backward(scal, win, xf, yf, basef, widthf, seedf, raggedf, fwd, R, W,
              ND, C, with_exp, spec, shifts=None, TD=None, est=None,
              plane=None):
    """The plain backward sweep shared by ``backward_plain``,
    ``backward_exp_plain`` and ``backward_tiled_plain``
    (``_sm3_backward_body_w``; with ``TD`` the tiled body)."""
    fr = _Frame(scal, win, xf, yf, basef, widthf, R, W, spec, est, plane, 1)
    t, S, NS = fr.t, spec.S, spec.NS
    G, dev = fr.G, xf.device
    seed = seedf.reshape(G, R, -1)
    ragged = raggedf.reshape(G, R, -1)
    pstates = post_states(spec)
    multi = post_planes(spec)
    posts = torch.empty((G, ND + 1) + multi + (R, W), dtype=torch.float32,
                        device=dev)
    posts[:, 0] = 0.0
    neg = torch.full((G, R, W), NEG, device=dev)
    n1 = [neg] * S          # bwd[d+1], raw at window w_{d+1}
    n2 = [neg] * S          # bwd[d+2], raw at window w_{d+2}
    total = torch.full((G, R, 1), NEG, device=dev)
    # emissions(d+2) at w_{d+1}: match and gap-Y
    _, em_c, eg_c = fr.emissions(ND + 2, fr.win[:, ND + 1], C)
    if with_exp:
        exp = _Expectations(fr, C)
        f1 = [neg] * S      # fwd[d+1], raw at window w_{d+1}
    if TD:
        acc = torch.zeros((G, R), device=dev)       # backward shift B
    for d in range(ND, 0, -1):
        if TD and d % TD == 0:
            # the top of tile d // TD - 1; below the first tile the two
            # carried diagonals re-center first (bwd[d+2] as cut at d+1)
            if d < ND:
                both, acc = _recenter(n1 + n2, acc)
                cut_prev = seed[:, :, d + 1:d + 2] != 0.0
                n1 = both[:S]
                n2 = [torch.where(cut_prev, NEG, v) for v in both[S:]]
            # f in this tile is stored minus A_t, bw minus B: repaid
            # against the absolute total (one f32 add, pallas_fb.py:2430)
            shf = (shifts[:, :, d // TD - 1] + acc)[..., None]
        w = fr.win[:, d]
        w1 = fr.win[:, d + 1]
        w2 = fr.win[:, d + 2]
        sa = seed[:, :, d:d + 1] != 0.0                      # [G, R, 1]
        ra = ragged[:, :, d:d + 1] != 0.0
        n1 = [torch.where(sa, NEG, v) for v in n1]
        n2 = [torch.where(sa, NEG, v) for v in n2]
        o1 = w - w1
        o2 = w - w2
        n1a = [fr.align(v, o1) for v in n1]
        n1p = [fr.align(v, o1 + 1) for v in n1]
        n2p = [fr.align(v, o2 + 1) for v in n2]
        em2p = _tmap(lambda v: fr.align(v, o1 + 1), em_c)
        xfw, em1, eg1 = fr.emissions(d + 1, w, C)
        # the rows at x+1 are clamped at the x range's end: that lane lies
        # outside every band
        bw = spec.bwd_update_w(t, xfw, _Rows(fr, w + 1), eg1, em2p, n1a,
                               n1p, n2p)
        mask = fr.band(d, w)
        seed_in = sa & mask
        bw = [torch.where(seed_in,
                          torch.where(ra, t[NS + 2 * S + i], t[NS + S + i]),
                          torch.where(mask, v, NEG))
              for i, v in enumerate(bw)]
        f = [fwd[:, d, i] for i in range(S)]
        prod = f[0] + bw[0]
        for i in range(1, S):
            prod = log_add(prod, f[i] + bw[i])
        lse = _masked_lse(prod, mask)
        total = torch.where(sa, lse + shf if TD else lse, total)
        if with_exp:
            # target diagonal d+2, after this step's total: middle source
            # fwd[d] @ w, lower/upper fwd[d+1] @ w1, target backward n2
            # (cut at d and at d+1) @ w2, emissions(d+2) carried @ w1
            exp.add(d + 2, w2, fr.align(em_c, w2 - w1),
                    fr.align(eg_c, w2 - w1),
                    [fr.align(v, w2 - w - 1) for v in f],
                    [fr.align(v, w2 - w1 - 1) for v in f1],
                    [fr.align(v, w2 - w1) for v in f1], n2, total)
            f1 = f
        xl = fr.xcoord(w)
        ok = mask & (xl > 0) & (xl < d)

        def post_of(si):
            z = f[si] + bw[si] - total
            if TD:
                z = z + shf
            return torch.where(ok, torch.exp(torch.clamp(z, max=0.69)), 0.0)

        if multi:
            for j, si in enumerate(pstates):
                posts[:, d, j] = post_of(si)
        else:
            posts[:, d] = post_of(0)
        n2, n1, em_c, eg_c = n1, bw, em1, eg1
    if not with_exp:
        return posts, total[..., 0]
    # epilogue: targets 2 and 1 (the loop covered ND+2..3).  n1 = bwd[1]
    # @ w_1, n2 = bwd[2] (cut at 1) @ w_2, f1 = fwd[1], em/eg carry =
    # emissions(2) @ w_1
    w0, w1, w2 = fr.win[:, 0], fr.win[:, 1], fr.win[:, 2]
    f0 = [fwd[:, 0, i] for i in range(S)]
    exp.add(2, w2, fr.align(em_c, w2 - w1), fr.align(eg_c, w2 - w1),
            [fr.align(v, w2 - w0 - 1) for v in f0],
            [fr.align(v, w2 - w1 - 1) for v in f1],
            [fr.align(v, w2 - w1) for v in f1], n2, total)
    # target 1: no middle source (diagonal -1), emissions(1) fresh
    _, em_t, eg_t = fr.emissions(1, w1, C)
    exp.add(1, w1, em_t, eg_t, [neg] * S,
            [fr.align(v, w1 - w0 - 1) for v in f0],
            [fr.align(v, w1 - w0) for v in f0], n1, total)
    return (posts, total[..., 0]) + exp.result()


def backward_plain(scal, win, xf, yf, basef, widthf, seedf, raggedf, fwd, *,
                   R, W, ND, C, spec=StrawmanSpec, est=None, plane=None):
    """Plain PyTorch posterior backward: (posts [G, ND+1, R, W], or
    [G, ND+1, NPS, R, W] for a spec with POST_STATES, totals [G, R]).
    Posterior exp(min(f + b - total, 0.69)) of the match state (or of each
    of the POST_STATES) on in-band cells with 0 < x < d, 0 elsewhere and on
    diagonal 0; the total is the masked log-sum-exp of f + b at each read's
    seed diagonal.  A streamed spec reads its emissions from ``est``; a
    planar spec from ``plane``, the k = 1 plane of
    ``echelon_emissions_plain``, when given."""
    backward_plain.calls += 1
    return _backward(scal, win, xf, yf, basef, widthf, seedf, raggedf, fwd,
                     R, W, ND, C, with_exp=False, spec=spec, est=est,
                     plane=plane)


backward_plain.calls = 0


def echelon_emissions_plain(win, xf, yf, *, R, W, ND, C, k,
                            spec=EchelonSpec):
    """Plain PyTorch emission pre-pass of a planar spec: the plane
    [G, ND+3, EM_LEAVES, R, W] f32 whose slot d holds the emissions of
    diagonal d + k at x = win[g, d] + l, in d's own window (the five match
    terms, then the gap-Y term), NEG where d + k > ND + 2.  k = 0 is what
    the forward reads (diagonal d at its window), k = 1 what the backward
    reads (diagonal d + 1 at the window of d, lanes outside the window of
    d + 1 included; slot ND + 1 its first carry).  Each slot is
    ``_Frame.emissions`` of that diagonal, the inline emissions of the
    plain passes."""
    if k not in (0, 1):
        raise ValueError(f"k={k}: the pre-pass plane is at offset 0 or 1")
    echelon_emissions_plain.calls += 1
    fr = _Frame(None, win, xf, yf, None, None, R, W, spec)
    out = torch.full((fr.G, ND + 3, spec.EM_LEAVES, R, W), NEG,
                     dtype=torch.float32, device=xf.device)
    for d in range(ND + 3 - k):
        _, e_match, e_gapy = fr.emissions(d + k, fr.win[:, d], C)
        for j, v in enumerate(e_match + (e_gapy,)):
            out[:, d, j] = v
    return out


echelon_emissions_plain.calls = 0


def backward_exp_plain(scal, win, xf, yf, basef, widthf, seedf, raggedf,
                       fwd, *, R, W, ND, C, spec=StrawmanSpec, est=None):
    """Plain PyTorch expectation backward: ``backward_plain``'s (posts,
    totals) plus the EM sums (diagonalCalculation(_signal)_Expectations,
    impl/pairwiseAligner.c:868-912) of every read:

    - trans [G, R, S*S]: posterior transition mass, lanes ``frm * S + to``
      (``spec.EXP_LANES``; lanes that are no transition of the machine
      hold 0);
    - acc [G, NACC, R, X]: the spec's EXP_NACC per-column accumulators in
      x frame (the JAX layout, ``_exp_dispatch`` reads it so): strawman the
      gap-X mass per reference column, dna5 the mass into state ``to`` by
      y base ``by`` in row to * 4 + by, vanilla the beta (M -> X) and
      alpha (X -> X) masses in rows 0 and 1.

    Each target diagonal t takes mass from sources on t-1 and t-2 and is
    added at the step of diagonal t-2, after that step's total; the
    epilogue adds targets 2 and 1.  The transition sums are per lane over
    the targets, then over the lanes (``block_sum``), as the kernel
    reduces them.  A spec without ``exp_probs_w`` raises
    (``_no_expectations``); a streamed spec reads its emissions from
    ``est``."""
    _no_expectations(spec)
    backward_exp_plain.calls += 1
    return _backward(scal, win, xf, yf, basef, widthf, seedf, raggedf, fwd,
                     R, W, ND, C, with_exp=True, spec=spec, est=est)


backward_exp_plain.calls = 0


def backward_tiled_plain(scal, win, xf, yf, basef, widthf, seedf, raggedf,
                         fwd, shifts, *, R, W, ND, C, TD, spec=StrawmanSpec):
    """Plain PyTorch tiled posterior backward over ND = NT * TD diagonals
    (``_sm3_backward_kernel(tile=...)`` chained by ``_run_tiled``), fed the
    tiled forward's plane and shifts [G, R, NT]: (posts [G, ND+1, R, W],
    totals [G, R]).

    ``backward_plain``'s sweep, but at the top of every tile below the
    first (diagonal t * TD + TD, t < NT - 1) the carried bwd[d+1] and
    bwd[d+2] of each read re-center into a running shift B, and the tile
    repays shf = shifts[..., t] + B: the total is lse + shf at the seed
    diagonal (absolute) and a posterior is exp(min(f + b - total + shf,
    0.69))."""
    backward_tiled_plain.calls += 1
    return _backward(scal, win, xf, yf, basef, widthf, seedf, raggedf, fwd,
                     R, W, ND, C, with_exp=False, spec=spec, shifts=shifts,
                     TD=TD)


backward_tiled_plain.calls = 0


# ---------------------------------------------------------------------------
# Wrappers: plain version on the CPU, CUDA kernel on the card.
# ---------------------------------------------------------------------------

# launches of each CUDA kernel, by its entry point (spec.SUFFIX included)
KERNEL_LAUNCHES = {}


def _check_cuda_inputs(named, dtypes, device):
    for name, tns in named.items():
        if tns.device != device:
            raise ValueError(f"{name} is on {tns.device}, expected {device}")
        if tns.dtype != dtypes.get(name, torch.float32):
            raise ValueError(f"{name} has dtype {tns.dtype}")
        if not tns.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _ptr(tns):
    return ctypes.c_void_p(tns.data_ptr())


def _raise_on(code, lib, what):
    if code != 0:
        msg = lib.wavefront_error_string(code).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {code} "
                           f"({msg})")


def _counted(entry):
    """Count one launch of kernel ``entry``."""
    KERNEL_LAUNCHES[entry] = KERNEL_LAUNCHES.get(entry, 0) + 1


class _Wrapper:
    """A kernel wrapper whose ``launches`` reads ``KERNEL_LAUNCHES`` for
    its strawman entry point (the wrapper's own name)."""

    def __init__(self, fn):
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs):
        return self.__wrapped__(*args, **kwargs)

    @property
    def launches(self):
        return KERNEL_LAUNCHES.get(self.__name__, 0)


def _stream(spec, est, G, R, W, ND):
    """Check that a streamed spec has its stream est [G, ND+3, R, W] and
    that no other spec is given one."""
    if not streamed(spec):
        if est is not None:
            raise ValueError(f"the {spec.NAME} machine takes no emission "
                             "stream (est)")
        return
    if est is None:
        raise ValueError(f"the {spec.NAME} machine reads its emissions from "
                         "a stream: pass est [G, ND+3, R, W]")
    if tuple(est.shape) != (G, ND + 3, R, W):
        raise ValueError(f"est has shape {tuple(est.shape)}, expected "
                         f"{(G, ND + 3, R, W)}")


def _plane_shape(spec, G, R, W, ND):
    return (G, ND + 3, spec.EM_LEAVES, R, W)


def _geometry(win, xf, yf, scal, R, W, ND, spec, est=None):
    G, NDp = win.shape
    _stream(spec, est, G, R, W, ND)
    if ND + 3 > NDp:
        raise ValueError(f"win has {NDp} diagonals, need ND+3 = {ND + 3}")
    if xf.shape[0] != G * R or yf.shape[0] != G * R:
        raise ValueError(f"xf/yf hold {xf.shape[0]}/{yf.shape[0]} reads, "
                         f"expected G*R = {G * R}")
    if W > 1024 or W % 32:
        raise ValueError(
            f"group window W={W} does not fit one thread per lane (a "
            "multiple of 32, at most 1024): lower the group size or batch "
            "shape-homogeneous reads so that the group window stays narrow")
    if xf.shape[1] != spec.NXF or scal.numel() != spec.NS + 3 * spec.S:
        raise ValueError(
            f"xf has {xf.shape[1]} rows and scal {scal.numel()} values; the "
            f"{spec.NAME} kernels take {spec.NXF} and "
            f"{spec.NS + 3 * spec.S}")
    return G, NDp, xf.shape[2], yf.shape[2]


def _launch_fwd(name, scal, win, xf, yf, basef, widthf, R, W, ND, C, spec,
                TD=None, est=None, plane=None):
    """Launch the forward kernel ``name`` + ``spec.SUFFIX`` of the library
    on CUDA tensors (the tiled one with ``TD``; a streamed spec's with
    ``est``, a planar spec's with its pre-pass ``plane``); returns the fwd
    plane, and with ``TD`` the shifts [G, R, ND // TD]."""
    if xf.device.type != "cuda":
        raise ValueError(f"no wavefront kernel for device {xf.device}")
    from .cuda_build import load_library

    G, NDp, X, Y = _geometry(win, xf, yf, scal, R, W, ND, spec, est)
    named = dict(scal=scal, win=win, xf=xf, yf=yf, basef=basef,
                 widthf=widthf)
    if est is not None:
        named["est"] = est
    if planar(spec):
        if plane is None or tuple(plane.shape) != _plane_shape(spec, G, R,
                                                               W, ND):
            raise ValueError(f"the {spec.NAME} forward reads the k = 0 "
                             "plane of echelon_emissions")
        named["plane"] = plane
    _check_cuda_inputs(named, {"win": torch.int32}, xf.device)
    lib = load_library()
    outs = [torch.empty((G, ND + 1, spec.S, R, W), dtype=torch.float32,
                        device=xf.device)]
    if TD:
        outs.append(torch.empty((G, R, ND // TD), dtype=torch.float32,
                                device=xf.device))
    stream = torch.cuda.current_stream(xf.device).cuda_stream
    entry = name + spec.SUFFIX
    args = [_ptr(v) for v in (*named.values(), *outs)]
    args += [G, R, W, ND, NDp, X, C, Y] + ([TD] if TD else [])
    code = getattr(lib, entry)(*args, ctypes.c_void_p(stream))
    _raise_on(code, lib, entry)
    return entry, (tuple(outs) if TD else outs[0])


@_Wrapper
def echelon_emissions(win, xf, yf, *, R, W, ND, C, k, spec=EchelonSpec):
    """Emission pre-pass of a planar spec -> the plane
    [G, ND+3, EM_LEAVES, R, W] f32 at offset ``k`` (see
    ``echelon_emissions_plain``).  Plain PyTorch for CPU tensors; the CUDA
    kernel ``sm3_emissions_kernel<spec>`` for CUDA tensors (entry
    ``wavefront_emissions`` + ``spec.SUFFIX``; it replaces no TPU kernel:
    it is the emission half of K1/K2 echelon's body, ``_EchelonSpec``
    pallas_fb.py:528-620, for every cell at once).  ``wavefront_fwd`` and
    ``wavefront_bwd`` launch it for a planar spec themselves."""
    if not planar(spec):
        raise ValueError(f"the {spec.NAME} machine has no emission pre-pass")
    if xf.device.type == "cpu":
        return echelon_emissions_plain(win, xf, yf, R=R, W=W, ND=ND, C=C,
                                       k=k, spec=spec)
    if xf.device.type != "cuda":
        raise ValueError(f"no emission kernel for device {xf.device}")
    if k not in (0, 1):
        raise ValueError(f"k={k}: the pre-pass plane is at offset 0 or 1")
    from .cuda_build import load_library

    G, NDp = win.shape
    if ND + 3 > NDp or xf.shape[0] != G * R or yf.shape[0] != G * R:
        raise ValueError(f"win {tuple(win.shape)}, xf/yf {xf.shape[0]}/"
                         f"{yf.shape[0]} reads for R={R}, ND={ND}")
    _check_cuda_inputs(dict(win=win, xf=xf, yf=yf), {"win": torch.int32},
                       xf.device)
    lib = load_library()
    plane = torch.empty(_plane_shape(spec, G, R, W, ND), dtype=torch.float32,
                        device=xf.device)
    entry = "wavefront_emissions" + spec.SUFFIX
    stream = torch.cuda.current_stream(xf.device).cuda_stream
    code = getattr(lib, entry)(_ptr(win), _ptr(xf), _ptr(yf), _ptr(plane),
                               G, R, W, ND, NDp, xf.shape[2], C, yf.shape[2],
                               k, ctypes.c_void_p(stream))
    _raise_on(code, lib, entry)
    _counted(entry)
    return plane


@_Wrapper
def wavefront_fwd(scal, win, xf, yf, basef, widthf, *, R, W, ND, C,
                  spec=StrawmanSpec, est=None):
    """Forward wavefront -> fwd plane [G, ND+1, S, R, W] f32; a streamed
    spec reads its emissions from ``est`` [G, ND+3, R, W].  Plain PyTorch
    for CPU tensors; for CUDA tensors the untiled select forward
    ``sm3_fwd_tiled_sel<spec, false>`` (strawman, dna5, vanilla, sm4, and
    hdp, which stages the rows of ``est``) (replaces
    cpecan_tpu/ops/pallas_fb.py:635 _sm3_forward_kernel; entry
    ``wavefront_fwd`` + ``spec.SUFFIX``); echelon: the emission
    pre-pass (``echelon_emissions``, k = 0), then the untiled select
    forward ``sm3_fwd_tiled_sel<Echelon, false>`` on its plane, which is
    freed after the launch."""
    if xf.device.type == "cpu":
        _stream(spec, est, win.shape[0], R, W, ND)
        return forward_plain(scal, win, xf, yf, basef, widthf, R=R, W=W,
                             ND=ND, C=C, spec=spec, est=est)
    plane = (echelon_emissions(win, xf, yf, R=R, W=W, ND=ND, C=C, k=0,
                               spec=spec)
             if planar(spec) and xf.device.type == "cuda" else None)
    entry, fwd = _launch_fwd("wavefront_fwd", scal, win, xf, yf, basef,
                             widthf, R, W, ND, C, spec, est=est, plane=plane)
    _counted(entry)
    return fwd



@_Wrapper
def wavefront_bwd(scal, win, xf, yf, basef, widthf, seedf, raggedf, fwd, *,
                  R, W, ND, C, spec=StrawmanSpec, est=None):
    """Posterior backward -> (posts [G, ND+1, R, W] or, for a spec with
    POST_STATES, [G, ND+1, NPS, R, W], totals [G, R]) f32; a streamed spec
    reads its emissions from ``est``.  Plain PyTorch for CPU tensors; for
    CUDA tensors the CUDA kernel ``sm3_bwd_tiled_sel<spec, false, false>``,
    the untiled select posterior form (strawman, vanilla, dna5, sm4, hdp,
    which reads ``est`` there, and echelon, after its emission pre-pass at
    k = 1) (replaces cpecan_tpu/ops/pallas_fb.py:857/:900
    _sm3_backward_kernel, with_exp=False)."""
    if xf.device.type == "cpu":
        _stream(spec, est, win.shape[0], R, W, ND)
        return backward_plain(scal, win, xf, yf, basef, widthf, seedf,
                              raggedf, fwd, R=R, W=W, ND=ND, C=C, spec=spec,
                              est=est)
    plane = (echelon_emissions(win, xf, yf, R=R, W=W, ND=ND, C=C, k=1,
                               spec=spec)
             if planar(spec) and xf.device.type == "cuda" else None)
    entry, out = _launch_bwd("wavefront_bwd", scal, win, xf, yf, basef,
                             widthf, seedf, raggedf, fwd, R, W, ND, C,
                             with_exp=False, spec=spec, est=est, plane=plane)
    _counted(entry)
    return out



@_Wrapper
def wavefront_bwd_exp(scal, win, xf, yf, basef, widthf, seedf, raggedf, fwd,
                      *, R, W, ND, C, spec=StrawmanSpec, est=None):
    """Expectation backward -> (posts [G, ND+1, R, W], totals [G, R],
    trans [G, R, S*S], acc [G, NACC, R, X]) f32 (see
    ``backward_exp_plain``); a streamed spec reads its emissions from
    ``est``.  Plain PyTorch for CPU tensors; for CUDA tensors the CUDA
    kernel ``sm3_bwd_tiled_sel<spec, true, false>``, the untiled
    expectation form (dna5, strawman, sm4, vanilla, and hdp, which reads
    ``est`` there) (replaces
    cpecan_tpu/ops/pallas_fb.py:857/:900 _sm3_backward_kernel,
    with_exp=True; entry ``wavefront_bwd_exp`` + ``spec.SUFFIX``)."""
    _no_expectations(spec)
    if xf.device.type == "cpu":
        _stream(spec, est, win.shape[0], R, W, ND)
        return backward_exp_plain(scal, win, xf, yf, basef, widthf, seedf,
                                  raggedf, fwd, R=R, W=W, ND=ND, C=C,
                                  spec=spec, est=est)
    entry, out = _launch_bwd("wavefront_bwd_exp", scal, win, xf, yf, basef,
                             widthf, seedf, raggedf, fwd, R, W, ND, C,
                             with_exp=True, spec=spec, est=est)
    _counted(entry)
    return out



def _tiles(ND, TD, spec):
    if streamed(spec):
        # the JAX package's tiled path refuses a streamed spec too
        # (_run_tiled, pallas_fb.py:2459-2462)
        raise NotImplementedError(
            f"the {spec.NAME} machine has no tiled kernels (streamed "
            "emissions)")
    if post_planes(spec):
        # the JAX package has no multi-state tiled path either: its tiled
        # extraction decodes W lanes per row (ROADMAP Queue 3)
        raise NotImplementedError(
            f"the {spec.NAME} machine has no tiled kernels (multi-state "
            "posteriors)")
    if TD <= 0 or ND % TD:
        raise ValueError(f"ND={ND} is not a whole number of TD={TD} tiles")
    return ND // TD


@_Wrapper
def wavefront_fwd_tiled(scal, win, xf, yf, basef, widthf, *, R, W, ND, C,
                        TD, spec=StrawmanSpec):
    """Tiled forward over ND = NT * TD diagonals -> (fwd plane
    [G, ND+1, S, R, W], shifts [G, R, NT]) f32 (see
    ``forward_tiled_plain``).  Plain PyTorch for CPU tensors; the CUDA
    kernel ``sm3_fwd_tiled_sel<spec, true>`` for CUDA tensors (replaces
    cpecan_tpu/ops/pallas_fb.py:2304 _sm3_forward_kernel(tile=...),
    K6a)."""
    _tiles(ND, TD, spec)
    if xf.device.type == "cpu":
        return forward_tiled_plain(scal, win, xf, yf, basef, widthf, R=R,
                                   W=W, ND=ND, C=C, TD=TD, spec=spec)
    entry, out = _launch_fwd("wavefront_fwd_tiled", scal, win, xf, yf,
                             basef, widthf, R, W, ND, C, spec, TD=TD)
    _counted(entry)
    return out



@_Wrapper
def wavefront_bwd_tiled(scal, win, xf, yf, basef, widthf, seedf, raggedf,
                        fwd, shifts, *, R, W, ND, C, TD, spec=StrawmanSpec):
    """Tiled posterior backward over ND = NT * TD diagonals -> (posts
    [G, ND+1, R, W], totals [G, R]) f32 (see ``backward_tiled_plain``).
    Plain PyTorch for CPU tensors; the CUDA kernel
    ``sm3_bwd_tiled_sel<spec, false, true>`` for CUDA tensors (replaces
    cpecan_tpu/ops/pallas_fb.py:2332 _sm3_backward_kernel(tile=...),
    K6b)."""
    NT = _tiles(ND, TD, spec)
    if xf.device.type == "cpu":
        return backward_tiled_plain(scal, win, xf, yf, basef, widthf, seedf,
                                    raggedf, fwd, shifts, R=R, W=W, ND=ND,
                                    C=C, TD=TD, spec=spec)
    G = win.shape[0]
    if tuple(shifts.shape) != (G, R, NT):
        raise ValueError(f"shifts has shape {tuple(shifts.shape)}, expected "
                         f"{(G, R, NT)}")
    entry, out = _launch_bwd("wavefront_bwd_tiled", scal, win, xf, yf, basef,
                             widthf, seedf, raggedf, fwd, R, W, ND, C,
                             with_exp=False, spec=spec, shifts=shifts, TD=TD)
    _counted(entry)
    return out



def _launch_bwd(name, scal, win, xf, yf, basef, widthf, seedf, raggedf, fwd,
                R, W, ND, C, with_exp, spec, shifts=None, TD=None, est=None,
                plane=None):
    """Launch the backward kernel ``name`` + ``spec.SUFFIX`` of the library
    on CUDA tensors (the tiled one with ``shifts`` and ``TD``; a streamed
    spec's with ``est``, a planar spec's with its pre-pass ``plane``);
    returns (entry point, its outputs)."""
    if xf.device.type != "cuda":
        raise ValueError(f"no wavefront kernel for device {xf.device}")
    from .cuda_build import load_library

    G, NDp, X, Y = _geometry(win, xf, yf, scal, R, W, ND, spec, est)
    if tuple(fwd.shape) != (G, ND + 1, spec.S, R, W):
        raise ValueError(f"fwd plane has shape {tuple(fwd.shape)}")
    named = dict(scal=scal, win=win, xf=xf, yf=yf, basef=basef,
                 widthf=widthf, seedf=seedf, raggedf=raggedf, fwd=fwd)
    if est is not None:
        named["est"] = est
    if planar(spec):
        if plane is None or tuple(plane.shape) != _plane_shape(spec, G, R,
                                                               W, ND):
            raise ValueError(f"the {spec.NAME} backward reads the k = 1 "
                             "plane of echelon_emissions")
        named["plane"] = plane
    if TD:
        named["shifts"] = shifts
    _check_cuda_inputs(named, {"win": torch.int32}, xf.device)
    lib = load_library()

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=xf.device)

    outs = [empty(G, ND + 1, *post_planes(spec), R, W), empty(G, R)]
    if with_exp:
        outs += [empty(G, R, spec.S * spec.S),
                 empty(G, spec.EXP_NACC, R, X)]
    stream = torch.cuda.current_stream(xf.device).cuda_stream
    entry = name + spec.SUFFIX
    args = [_ptr(v) for v in (*named.values(), *outs)]
    args += [G, R, W, ND, NDp, X, C, Y] + ([TD] if TD else [])
    code = getattr(lib, entry)(*args, ctypes.c_void_p(stream))
    _raise_on(code, lib, entry)
    return entry, tuple(outs)


def reset_counts():
    """Zero every launch and plain-call counter of this module."""
    KERNEL_LAUNCHES.clear()
    forward_plain.calls = backward_plain.calls = 0
    backward_exp_plain.calls = 0
    forward_tiled_plain.calls = backward_tiled_plain.calls = 0
    echelon_emissions_plain.calls = 0
