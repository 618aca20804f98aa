"""Per-read feature inputs of the wavefront kernels.

Strawman, host side (numpy): compact uploads, counterparts of
``pallas_fb.py`` ``_quantize_events`` (:1331), ``_base_codes`` (:1360) and
``StrawmanPallasAligner._feature_inputs`` (:1509).  Device side (torch):
``dequantize_events`` (``_dequantize_events`` :1352), ``kx_from_codes``
(``_kx_from_codes`` :1376) and ``assemble_features``
(``StrawmanPallasAligner._assemble_fn`` :1525-1573), which gathers the
per-x model rows ``xf`` [B, 9, X] and lays the events out flipped in ``yf``
[B, 2, C+X+256].

Vanilla: the strawman's host inputs; ``vanilla_kmer_pair``
(``_vanilla_kmer_pair`` :1393), ``vanilla_skip_bins`` and
``assemble_vanilla_features`` (``VanillaPallasAligner._assemble_fn``
:2664-2732), which gathers ``xf`` [B, 13, X]: the match and gap-Y model
rows of each column's k-mer and the five per-column log transitions from
its k-mer skip bin; ``host_bins`` gives the expectation finalize the same
bins on the host.

5-state DNA: ``dna5_feature_inputs`` (``Dna5PallasAligner._feature_inputs``
:3106-3118) on the host; ``dna5_y_values`` (the host half of
``_device_features`` :3154-3166) and ``assemble_dna5_features``
(``_assemble_fn`` :3133-3152), which gathers ``xf`` [B, 6, X] (the match
rows of each x base against y base 0..4, then the gap-X row) and lays the
y side out flipped in ``yf`` [B, 2, C+X+256] (base index as a float, gap-Y
emission).

Echelon: ``echelon_feature_inputs`` (``EchelonPallasAligner.
_feature_inputs`` :3249-3283) on the host: per-offset k-mer indices, the
skip-bin k-mer pair, the multi-k-mer validity bits and the raw f32 events
(echelon does not quantize them); ``echelon_skip_logs`` (the host half of
``_device_features`` :3365-3390), the per-column skip logs in f64 from the
k-mer skip bins of each read's (scaled) level means; and
``assemble_echelon_features`` (``_assemble_fn`` :3301-3363), which gathers
``xf`` [B, 33, X] and lays out ``yf`` [B, 8, C+X+256]: the Poisson duration
posteriors dur_0..dur_5, the event mean and the noise.

HDP: ``hdp_feature_inputs`` (the strawman's base codes and the raw f32
event means: the HDP stream does not quantize them, ``_stream_args``
:2913-2917) on the host; ``assemble_hdp_features``
(``HdpPallasAligner._device_features`` :2846-2866): ``xf`` [B, 9, X] with
only the gap-X row 8 set and a zero one-column ``yf``; and ``hdp_stream``
(``_stream_args`` :2884-3060), the per-diagonal emission windows
[G, ND+3, R, W] of the HDP's spline densities.

Every host array goes to the card through ``upload``: a copy from pinned
memory that does not wait for the kernels already queued, so that a
pipeline can prepare its next chunk while the card runs this one.
"""

import numpy as np
import torch

from ..constants import KMER_LENGTH, N_SENTINEL, NUM_OF_KMERS
from ..models import kmers as K
from .fb_kernels import NEG


def quantize_events(ev):
    """Per-channel affine u16 quantization ([B, E, C] f32 -> u16 codes +
    [2C] f32 scales).  Code 0 is reserved for exact 0.0 (padding), so the
    no-event value survives bit-exactly; real values map to 1..65535."""
    C = ev.shape[-1]
    flat = ev.reshape(-1, C)
    # range over the real (nonzero) values: zeros are padding
    masked = np.where(flat == 0.0, np.nan, flat)
    lo = np.nan_to_num(np.nanmin(masked, axis=0), nan=0.0)
    hi = np.nan_to_num(np.nanmax(masked, axis=0), nan=0.0)
    sc = np.maximum((hi - lo) / 65534.0, 1e-12).astype(np.float32)
    q = np.rint((ev - lo) / sc).astype(np.int64) + 1
    q = np.where(ev == 0.0, 0, np.clip(q, 1, 65535)).astype(np.uint16)
    return q, np.concatenate([sc, lo.astype(np.float32)])


def base_codes(reads, X):
    """Per-read base codes [B, X + KMER_LENGTH - 1] u8: position x holds
    ref[x - 1] as 0..3 (A,C,G,T), 4 for N / padding / the x=0 boundary."""
    codes = np.full((len(reads), X + KMER_LENGTH - 1), 4, dtype=np.uint8)
    for r, (ref, *_rest) in enumerate(reads):
        b = K.seq_to_base_indices(ref)
        codes[r, 1:1 + len(b)] = np.minimum(b, 4)
    return codes


def feature_inputs(reads, X):
    """Compact per-read inputs for the device-side assembly: base codes
    [B, X+5] u8, events [B, E+1, 2] quantized to u16 (+4 f32 scales), and
    the f32 events they came from."""
    B = len(reads)
    max_ev = max(r[1].shape[0] for r in reads)
    ev = np.zeros((B, max_ev + 1, 2), np.float32)
    for r, (_ref, events, _l_x, _l_y, _a) in enumerate(reads):
        ev[r, 1:1 + len(events), :] = events[:, :2]
    evq, evs = quantize_events(ev)
    return dict(ev=ev, codes=base_codes(reads, X), evq=evq, evs=evs)


def upload(a, device):
    """A numpy array as a tensor on ``device``.  To the card it goes from
    pinned memory (torch's caching host allocator, which keeps the buffer
    until the copy has ended) with ``non_blocking=True``: a copy from
    pageable memory would wait for every kernel queued on the stream."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def upload_u16(a, device):
    """A u16 numpy array on ``device`` as its int16 bit pattern (2 bytes
    per value on the wire; torch's uint16 support on CUDA is partial)."""
    return upload(np.ascontiguousarray(a).view(np.int16), device)


def dequantize_events(evq, evs):
    """Inverse of quantize_events on the device: ``evq`` is the int16 bit
    pattern of the u16 codes [..., C] (upload_u16), ``evs`` the [2C] f32
    scales -> f32 [..., C]."""
    C = evq.shape[-1]
    sc, lo = evs[:C], evs[C:]
    q = evq.to(torch.int32) & 0xFFFF
    return torch.where(q == 0, 0.0, _fma(q.to(torch.float32) - 1.0, sc, lo))


def _fma(a, b, c):
    """f32 a * b + c rounded once, like the fused multiply-add that XLA
    emits for the JAX assembly (the f64 product of two f32 is exact)."""
    return (a.to(torch.float64) * b.to(torch.float64)
            + c.to(torch.float64)).to(torch.float32)


def kx_from_codes(codes):
    """[B, X + K - 1] u8 base codes -> [B, X] int64 kmer indices; any
    window holding a non-ACGT code -> N_SENTINEL."""
    c = codes.to(torch.int64)
    X = c.shape[1] - (KMER_LENGTH - 1)
    kx = torch.zeros((c.shape[0], X), dtype=torch.int64, device=c.device)
    ok = torch.ones((c.shape[0], X), dtype=torch.bool, device=c.device)
    for i in range(KMER_LENGTH):
        ci = c[:, i:i + X]
        kx = kx + ci * (4 ** (KMER_LENGTH - 1 - i))
        ok = ok & (ci < 4)
    return torch.where(ok, kx, N_SENTINEL)


def assemble_features(codes, evq, evs, mm, gm, gapx, C, Y, sp=None):
    """(xf [B, 9, X], yf [B, 2, Y]) f32 on the inputs' device.

    ``mm`` [4096, 5] / ``gm`` [4096, 4] / ``gapx`` [4096] are the machine's
    tables.  With ``sp`` [B, 5] = (scale, shift, var, scale_sd, var_sd)
    the match rows are scaled per read (emissions_signal_scaleModel,
    impl/stateMachine.c:632-674), so one unscaled table serves a batch."""
    kx = kx_from_codes(codes)
    ev = dequantize_events(evq, evs)
    valid = kx <= NUM_OF_KMERS
    safe = kx.clamp(0, NUM_OF_KMERS - 1)
    if sp is None:
        rows = [torch.where(valid, mm[safe, c], 0.0) for c in range(4)]
    else:
        scale, shift, var, scale_sd, var_sd = (sp[:, i:i + 1]
                                               for i in range(5))
        lvl_mu = _fma(mm[safe, 0], scale, shift)
        lvl_sd = mm[safe, 1] * var
        nz_mu = mm[safe, 2] * scale_sd
        # x ** 3 as two products, as XLA's integer_pow computes it
        nz_sd = torch.sqrt(nz_mu * nz_mu * nz_mu
                           / torch.clamp(mm[safe, 4] * var_sd, min=1e-30))
        rows = [torch.where(valid, r, 0.0)
                for r in (lvl_mu, lvl_sd, nz_mu, nz_sd)]
    rows += [torch.where(valid, gm[safe, c], 0.0) for c in range(4)]
    rows += [torch.clamp(torch.where(valid, gapx[safe], NEG), min=NEG)]
    xf = torch.stack(rows, dim=1).to(torch.float32)
    B, E, _ = ev.shape
    n = min(E, C + 1)  # y in [0, C] maps to column C - y >= 0
    yf = torch.zeros((B, 2, Y), dtype=torch.float32, device=xf.device)
    yf[:, :, C - n + 1:C + 1] = ev[:, :n, :].flip(1).transpose(1, 2)
    return xf.contiguous(), yf


def vanilla_kmer_pair(kx):
    """The getKmer2 skip-bin k-mer pair of each column from the per-column
    k-mer indices kx [B, X] (kx[x] = the k-mer at ref position x - 1,
    ``kx_from_codes``): kxp[x] = kx[x - 1] for x >= 2, else kx[1], and
    kxn[x] = kx[x] for x >= 2, else kx[2] (StateMachine3Vanilla.x_skip_bins,
    sequence_getKmer2, impl/pairwiseAligner.c:336-341).

    As in the JAX package, kxp at the column x = l_x + 1 is a valid k-mer
    where an index gather with a clipped position would give the sentinel:
    that column lies outside every band (band x <= l_x), so no posterior
    or expectation reads it."""
    kxp = torch.cat([kx[:, 1:2].repeat(1, 2), kx[:, 1:-1]], 1)
    kxn = torch.cat([kx[:, 2:3].repeat(1, 2), kx[:, 2:]], 1)
    return kxp, kxn


def vanilla_skip_bins(kxp, kxn, level_mean, sp=None):
    """Per-column k-mer skip bins [B, X] int64: |level mean(kxn) - level
    mean(kxp)| in 0.5 pA steps, clamped to 29
    (emissions_signal_getKmerSkipBin, impl/stateMachine.c:389-420).
    ``level_mean`` [4096] f32 is the unscaled table; with ``sp`` [B, 5]
    each read's means are scaled, mean * scale + shift rounded once as
    XLA's fused multiply-add rounds it.  An invalid k-mer's mean is 0.0,
    unscaled, so the shift does not cancel there."""
    def mean(idx):
        m = level_mean[idx.clamp(0, NUM_OF_KMERS - 1)]
        if sp is not None:
            m = _fma(m, sp[:, 0:1], sp[:, 1:2])
        return torch.where(idx > NUM_OF_KMERS, 0.0, m)

    d = torch.abs(mean(kxn) - mean(kxp))
    return torch.clamp((d / 0.5).to(torch.int64), max=29)


def assemble_vanilla_features(codes, evq, evs, match4, gap_y4, skip60,
                              t_m2y, C, Y, sp=None):
    """(xf [B, 13, X], yf [B, 2, Y]) f32 on the inputs' device.

    ``match4``/``gap_y4`` [4096, 4] are the machine's model columns (level
    mean, level sd, noise mean, noise lambda), ``skip60`` [60] its skip-bin
    probabilities (beta, then alpha), ``t_m2y`` the strand's M -> Y share
    of the non-skip mass.  With ``sp`` [B, 5] = (scale, shift, var,
    scale_sd, var_sd) the match rows are scaled per read: the noise lambda
    by var_sd directly (``_assemble_fn`` :2684-2688).  Rows 8-12 are
    log a_mx, a_xx, a_mm, a_xm, a_my of the column's skip bin (NEG where
    the k-mer is invalid or the probability 0)."""
    kxp, kxn = vanilla_kmer_pair(kx_from_codes(codes))
    ev = dequantize_events(evq, evs)
    valid = kxn <= NUM_OF_KMERS
    safe = kxn.clamp(0, NUM_OF_KMERS - 1)
    if sp is None:
        rows = [match4[safe, c] for c in range(4)]
    else:
        rows = [_fma(match4[safe, 0], sp[:, 0:1], sp[:, 1:2])]
        rows += [match4[safe, c] * sp[:, c + 1:c + 2] for c in (1, 2, 3)]
    rows = [torch.where(valid, r, 0.0) for r in rows]
    rows += [torch.where(valid, gap_y4[safe, c], 0.0) for c in range(4)]
    b = vanilla_skip_bins(kxp, kxn, match4[:, 0], sp)
    a_mx = skip60[b]
    a_xx = skip60[b + 30]
    a_my = (1.0 - a_mx) * t_m2y
    # XLA fuses 1 - a_my into one multiply-add: a_mm rounds as it does
    a_mm = _fma(1.0 - a_mx, torch.tensor(-t_m2y, dtype=torch.float32),
                torch.tensor(1.0)) - a_mx
    a_xm = 1.0 - a_xx
    for a in (a_mx, a_xx, a_mm, a_xm, a_my):
        rows.append(torch.where(valid & (a > 0.0),
                                torch.log(torch.clamp(a, min=1e-37)), NEG))
    xf = torch.stack(rows, dim=1).to(torch.float32)
    B, E, _ = ev.shape
    n = min(E, C + 1)  # y in [0, C] maps to column C - y >= 0
    yf = torch.zeros((B, 2, Y), dtype=torch.float32, device=xf.device)
    yf[:, :, C - n + 1:C + 1] = ev[:, :n, :].flip(1).transpose(1, 2)
    return xf.contiguous(), yf


def host_bins(codes, level_mean, sp=None):
    """The skip bins of ``assemble_vanilla_features`` on the host (numpy
    int64 [B, X]), by the same torch arithmetic on the CPU, so that the
    expectation finalize scatters each column into the bin whose
    transitions the kernels used (``VanillaPallasAligner._host_bins``
    :2785)."""
    kxp, kxn = vanilla_kmer_pair(kx_from_codes(torch.from_numpy(codes)))
    return vanilla_skip_bins(
        kxp, kxn, torch.from_numpy(level_mean),
        None if sp is None else torch.from_numpy(sp)).numpy()


def dna5_feature_inputs(reads, X):
    """Host inputs of the dna5 features for reads (seq_x, seq_y, l_x, l_y,
    anchors): x base indices ``bx`` [B, X] int16 (x at column 1 + i; N, the
    x = 0 boundary and the padding = 4) and the y-side frame ``ydata``
    [B, max l_y + 1, 2] f32 (zeros; ``dna5_y_values`` fills it)."""
    B = len(reads)
    bx = np.full((B, X), 4, dtype=np.int16)
    max_y = max(r[3] for r in reads)
    ev = np.zeros((B, max_y + 1, 2), np.float32)
    for r, (seq_x, _seq_y, l_x, _l_y, _a) in enumerate(reads):
        b = np.minimum(K.seq_to_base_indices(seq_x), 4)
        bx[r, 1:1 + l_x] = b[:l_x]
    return dict(bx=bx, ydata=ev, reads=list(reads))


def dna5_y_values(ydata, reads, gapy5):
    """The y side as (base index, gap-Y emission) pairs: a filled copy of
    ``ydata``.  Column 0 holds (4.0, gapy5[4]) and column 1 + j y base j;
    columns past a read's l_y keep (0.0, 0.0), so their match emission is
    the A row (outside the band, masked), as in the JAX package."""
    ev = ydata.copy()
    ev[:, 0, 0] = 4.0
    ev[:, 0, 1] = gapy5[4]
    for r, (_sx, seq_y, _lx, l_y, _a) in enumerate(reads):
        by = np.minimum(K.seq_to_base_indices(seq_y), 4)[:l_y]
        ev[r, 1:1 + l_y, 0] = by
        ev[r, 1:1 + l_y, 1] = gapy5[by]
    return ev


def assemble_dna5_features(bx, ev, match5, gapx5, C, Y):
    """(xf [B, 6, X], yf [B, 2, Y]) f32 on the inputs' device from the x
    base indices ``bx`` [B, X], the y values ``ev`` [B, E, 2]
    (``dna5_y_values``) and the machine's ``match5`` [5, 5] and ``gapx5``
    [5] tables."""
    b = bx.to(torch.int64).clamp(0, 4)
    rows = [match5[b, col] for col in range(5)]
    rows.append(torch.clamp(gapx5[b], min=NEG))
    xf = torch.stack(rows, dim=1).to(torch.float32)
    B, E, _ = ev.shape
    n = min(E, C + 1)  # y in [0, C] maps to column C - y >= 0
    yf = torch.zeros((B, 2, Y), dtype=torch.float32, device=xf.device)
    yf[:, :, C - n + 1:C + 1] = ev[:, :n, :].flip(1).transpose(1, 2)
    return xf.contiguous(), yf


def echelon_feature_inputs(reads, X):
    """Host inputs of the echelon features for reads (ref, events [n, 3],
    l_x, l_y, anchors): ``kxp`` [B, X] int16, the previous k-mer of each
    column's skip-bin pair (getKmer2 position); ``kx5`` [B, 5, X] int16,
    the k-mers at that position + 1 + i, i = 0..4 (32767 past the read);
    ``validm`` [B, X] u8, bit n - 1 set where n k-mers fit (the reference's
    last base ``chars[p + 6n]`` upper case); ``ev`` [B, max n + 1, 3] f32
    (mean, noise, duration) from row 1 on."""
    from ..models.state_machines import _getkmer2_positions

    B = len(reads)
    kxp = np.full((B, X), np.int16(32767), dtype=np.int16)
    kx5 = np.full((B, 5, X), np.int16(32767), dtype=np.int16)
    validm = np.zeros((B, X), np.uint8)
    max_ev = max(r[1].shape[0] for r in reads)
    ev = np.zeros((B, max_ev + 1, 3), np.float32)
    for r, (ref, events, l_x, _l_y, _a) in enumerate(reads):
        refp = ref + "n" * 30  # sequence_padSequence
        pos = _getkmer2_positions(l_x)
        n_pos = len(pos)
        # one k-mer pass per read, sliced six ways
        all_idx = K.seq_to_kmer_indices(refp, length=len(refp))
        hi = len(refp) - 1
        kxp[r, :n_pos] = all_idx[np.clip(pos, 0, hi)]
        for i in range(5):
            kx5[r, i, :n_pos] = all_idx[np.clip(pos + 1 + i, 0, hi)]
        chars = np.frombuffer(refp.encode(), dtype=np.uint8)
        bits = np.zeros(n_pos, np.uint8)
        for n in range(1, 6):
            idx = np.clip(pos + 6 * n, 0, len(chars) - 1)
            ok = ((pos + 6 * n < len(chars)) & (chars[idx] >= 65)
                  & (chars[idx] <= 90))
            bits |= ok.astype(np.uint8) << (n - 1)
        validm[r, :n_pos] = bits
        ev[r, 1:1 + len(events), :] = events[:, :3]
    return dict(kxp=kxp, kx5=kx5, validm=validm, ev=ev)


def echelon_skip_logs(sm, kxp, k0, sp=None):
    """Per-column skip transition logs la4 [B, 4, X] f32 (la_mx, la_mh,
    la_xx, la_xh; -inf clamped to NEG) of an echelon machine ``sm``: the
    skip bin of each column's k-mer pair (``kxp`` and ``k0`` = kx5[:, 0])
    from the level means of ``sm.model``, scaled per read in f64 with
    ``sp`` [B, 5] (the bins of the reference's per-read scaled model), the
    machine's ``skip_bin_probs`` at that bin and its ``_skip_logs``.  On the
    host in f64 as the JAX package computes them: a bin that flips changes
    the column's transitions."""
    from ..io.poremodel import kmer_skip_bin_table

    bins = kmer_skip_bin_table(
        sm.model.match_model, kxp.astype(np.int64), k0.astype(np.int64),
        scale=None if sp is None else sp[:, 0:1].astype(np.float64),
        shift=None if sp is None else sp[:, 1:2].astype(np.float64))
    la4 = np.stack(sm._skip_logs(sm.skip_bin_probs[bins]), axis=1)
    return np.maximum(np.nan_to_num(la4, neginf=NEG), NEG).astype(np.float32)


# emissions_signal_getDurationProb (impl/stateMachine.c:552): the Poisson
# duration posterior of n = 0..5 k-mers, dur_n = (n + 1) l_beta + n log lam
# - log n! - 2 lam, lam = duration / c
_DUR_C = 0.00332005312085
_DUR_L_BETA = 0.1397619423751586
_DUR_L_F = (0.0, 0.0, 0.69314718056, 1.79175946923, 3.17805383035,
            4.78749174278)
# XLA rewrites the JAX assembly's arithmetic before it runs, and the port
# rounds as it does: the division by c becomes a product with the f32
# reciprocal (2 lam: with twice it), (n + 1) l_beta - log n! one f32
# constant, and n log lam + that constant and the subtraction of 2 lam
# fused multiply-adds
_DUR_RECIP = float(np.float32(1.0) / np.float32(_DUR_C))
_DUR_RECIP2 = float(np.float32(2.0) * np.float32(_DUR_RECIP))
_DUR_CONST = [float(np.float32(np.float32((n + 1) * _DUR_L_BETA)
                               - np.float32(_DUR_L_F[n]))) for n in range(6)]


def echelon_durations(dur):
    """The duration rows dur_0..dur_5 [B, 6, E] f32 of event durations
    ``dur`` [B, E] f32 (NEG-like where a duration is 0 and n > 0), rounded
    as XLA computes the JAX assembly's (``_DUR_*``)."""
    lam = dur * _DUR_RECIP
    pos = lam > 0.0
    log_lam = torch.log(torch.where(pos, lam, 1.0)).to(torch.float64)
    two_lam = dur.to(torch.float64) * _DUR_RECIP2
    rows = []
    for n in range(6):
        t = torch.where(pos, (log_lam * n + _DUR_CONST[n]).to(torch.float32),
                        _DUR_CONST[0] if n == 0 else NEG)
        rows.append((t.to(torch.float64) - two_lam).to(torch.float32))
    return torch.stack(rows, dim=1)


def assemble_echelon_features(kx5, la4, validm, ev, mm4, gm4, C, Y,
                              sp=None):
    """(xf [B, 33, X], yf [B, 8, Y]) f32 on the inputs' device from the
    host inputs (``echelon_feature_inputs``, ``echelon_skip_logs``) and
    the machine's ``mm4``/``gm4`` [4096, 4] tables.  With ``sp`` [B, 5] =
    (scale, shift, var, scale_sd, var_sd) the five per-offset match-model
    gathers are scaled per read (emissions_signal_scaleModel: level mean *
    scale + shift, level sd * var, noise mean * scale_sd, lambda * var_sd);
    the gap-Y model and the durations are read-independent."""
    rows = []
    kx5 = kx5.to(torch.int64)
    for i in range(5):
        ki = kx5[:, i]
        valid = ki <= NUM_OF_KMERS
        safe = ki.clamp(0, NUM_OF_KMERS - 1)
        if sp is None:
            rows += [torch.where(valid, mm4[safe, c], 0.0) for c in range(4)]
        else:
            lvl_mu = _fma(mm4[safe, 0], sp[:, 0:1], sp[:, 1:2])
            rows += [torch.where(valid, r, 0.0) for r in (
                lvl_mu, mm4[safe, 1] * sp[:, 2:3], mm4[safe, 2] * sp[:, 3:4],
                mm4[safe, 3] * sp[:, 4:5])]
    k0 = kx5[:, 0]
    v0 = k0 <= NUM_OF_KMERS
    s0 = k0.clamp(0, NUM_OF_KMERS - 1)
    rows += [torch.where(v0, gm4[s0, c], 0.0) for c in range(4)]
    rows += [la4[:, i] for i in range(4)]
    vm = validm.to(torch.int32)
    rows += [((vm >> (n - 1)) & 1).to(torch.float32) for n in range(1, 6)]
    xf = torch.stack(rows, dim=1).to(torch.float32)
    B, E, _ = ev.shape
    n = min(E, C + 1)  # y in [0, C] maps to column C - y >= 0
    yf = torch.zeros((B, 8, Y), dtype=torch.float32, device=xf.device)
    yf[:, :6, C - n + 1:C + 1] = echelon_durations(ev[:, :n, 2]).flip(2)
    yf[:, 6:8, C - n + 1:C + 1] = ev[:, :n, :2].flip(1).transpose(1, 2)
    return xf.contiguous(), yf


def hdp_feature_inputs(reads, X):
    """Host inputs of the HDP features: base codes [B, X+5] u8 and the f32
    event means ``evm`` [B, E+1] (row 0 and the rows past a read's events
    0.0, as the strawman's ``ev`` column 0), not quantized."""
    B = len(reads)
    max_ev = max(r[1].shape[0] for r in reads)
    evm = np.zeros((B, max_ev + 1), np.float32)
    for r, (_ref, events, _l_x, _l_y, _a) in enumerate(reads):
        evm[r, 1:1 + len(events)] = events[:, 0]
    return dict(codes=base_codes(reads, X), evm=evm)


def assemble_hdp_features(kx, gapx):
    """(xf [B, 9, X], yf [B, 2, 1]) f32 on ``kx``'s device from the column
    k-mers ``kx`` [B, X] (``kx_from_codes``): xf row 8 is the gap-X log
    probability of the column's k-mer (NEG where the k-mer is invalid),
    the other rows are zeros (``_device_features``, pallas_fb.py:
    2846-2866).  The match and gap-Y emissions come from the stream
    (``hdp_stream``), so the kernels read no y row: yf is a zero
    placeholder of one column, where the JAX package passes zeros
    [B, 2, C+X+256]."""
    valid = kx <= NUM_OF_KMERS
    safe = kx.clamp(0, NUM_OF_KMERS - 1)
    B, X = kx.shape
    xf = torch.zeros((B, 9, X), dtype=torch.float32, device=kx.device)
    xf[:, 8] = torch.clamp(torch.where(valid, gapx[safe], NEG), min=NEG)
    yf = torch.zeros((B, 2, 1), dtype=torch.float32, device=kx.device)
    return xf, yf


# cells of the stream built at once: hdp_stream's per-cell temporaries
# (int64 table rows, gathered weights, masks) take ~40 B a cell, so a block
# holds ~170 MB whatever the batch, on top of the stream itself
HDP_STREAM_BLOCK_CELLS = 2 ** 22
HDP_STREAM_SCRATCH_BYTES = 40 * HDP_STREAM_BLOCK_CELLS


def hdp_stream(win, kx, evm, tables, slopes, grid_scalars, *, R, ND, W,
               log_density):
    """The HDP emission stream est [G, ND+3, R, W] f32: lane l of diagonal d
    of group g holds the emission of cell (x = win[g, d] + l, y = d - x) of
    each read, the spline density of k-mer k(x) at event mean evm[y]
    (``_stream_args``, pallas_fb.py:2884-3060; dir_proc_density,
    impl/hdp.c:2577-2601).

    The JAX package forms it as a matrix product of per-column table rows
    A[x] = (tab[k(x)], slo[k(x)]) with per-event grid weights Wv[y] (the
    cubic interpolation's four coefficients at grid i and i + 1, or the
    end clamps at grid0 and glast) and gathers each diagonal's window from
    it.  A row of Wv has four non-zeros, so here each cell gathers its four
    table entries and sums the four products in the contraction's order:
    f32 throughout, no matrix unit (nothing depends on the caller's TF32
    settings) and no [B, X, E] intermediate.  The cells are independent:
    they are built in blocks of diagonals of at most
    HDP_STREAM_BLOCK_CELLS cells, so that the build needs the stream and
    HDP_STREAM_SCRATCH_BYTES more.

    ``tables``/``slopes`` [4096, Gl] f32, ``grid_scalars`` the grid's
    (first point, step, last point) as f32 values, ``win`` [G, NDp] int,
    ``kx`` [B, X] the column k-mers (``kx_from_codes``), ``evm`` [B, E]
    f32.  Cells with y outside [0, E) have density 0; with
    ``log_density`` a density > 0 becomes its log and the others NEG, else
    (the reference's raw-density mode) the density stays and only invalid
    k-mers are NEG."""
    dev = tables.device
    Gl = tables.shape[1]
    grid0, dx, glast = (torch.tensor(v, dtype=torch.float32, device=dev)
                        for v in grid_scalars)
    B, X = kx.shape
    G = B // R
    E = evm.shape[1]
    valid = kx <= NUM_OF_KMERS
    safe = kx.clamp(0, NUM_OF_KMERS - 1)
    # per event: the grid cell i and the weights of tab[i], tab[i + 1],
    # slo[i], slo[i + 1] (u*y0 + t*y1 + t*u*(a*u + b*t) expanded); below
    # grid0 tab[0] + slo[0] (m - grid0), above glast the last point's
    mean = evm
    i = torch.clamp(((mean - grid0) / dx).to(torch.int32), 0, Gl - 2)
    t = (mean - (grid0 + i.to(torch.float32) * dx)) / dx
    u = 1.0 - t
    w = [u + t * u * u - t * t * u, t + t * t * u - t * u * u,
         t * u * u * dx, -t * t * u * dx]
    low = mean <= grid0
    high = mean >= glast
    zero = torch.zeros_like(mean)
    one = torch.ones_like(mean)
    w = [torch.where(low, e0, torch.where(high, eh, wm)) for wm, e0, eh in (
        (w[0], one, zero), (w[1], zero, one),
        (w[2], mean - grid0, zero), (w[3], zero, mean - glast))]
    i = torch.where(low, 0, torch.where(high, Gl - 2, i)).to(torch.int64)
    tab = tables.reshape(-1)
    slo = slopes.reshape(-1)
    D = ND + 3
    lane = torch.arange(W, device=dev)
    est = torch.empty((G, D, R, W), dtype=torch.float32, device=dev)
    step = max(1, HDP_STREAM_BLOCK_CELLS // (G * R * W))
    for d0 in range(0, D, step):
        d1 = min(D, d0 + step)
        n = d1 - d0
        # the block's cells: x, y and the read
        xg = win[:, d0:d1].to(torch.int64)[:, :, None] + lane    # [G, n, W]
        yg = torch.arange(d0, d1, device=dev)[None, :, None] - xg
        ok = (yg >= 0) & (yg < E)

        def per_cell(v, idx, m):
            """v [B, m] read at idx [G, n, W] for each read ->
            [G, n, R, W]."""
            v = v.reshape(G, 1, R, m).expand(G, n, R, m)
            return torch.gather(v, 3, idx[:, :, None, :].expand(G, n, R, W))

        yc = yg.clamp(0, E - 1)
        xc = xg.clamp(0, X - 1)
        row = per_cell(safe, xc, X) * Gl + per_cell(i, yc, E)
        kv = per_cell(valid, xc, X)
        dens = (per_cell(w[0], yc, E) * tab[row]
                + per_cell(w[1], yc, E) * tab[row + 1]
                + per_cell(w[2], yc, E) * slo[row]
                + per_cell(w[3], yc, E) * slo[row + 1])
        del row
        dens = torch.where(ok[:, :, None, :] & kv,
                           torch.clamp(dens, min=0.0), 0.0)
        if log_density:
            # an invalid k-mer's density is 0 (its table row is zeroed):
            # NEG.  The log is taken in f64 and rounded once to f32, so
            # that a cell's value does not depend on the block it was
            # built in: the CPU's f32 log was seen to round some cells an
            # ulp apart between calls on the same input
            lg = torch.clamp(dens, min=1e-30).double().log_().float()
            est[:, d0:d1] = torch.where(dens > 0.0, lg, NEG)
            del lg
        else:
            est[:, d0:d1] = torch.where(kv, dens, NEG)
    return est
