"""Batched banded forward/backward posterior alignment on the wavefront
kernels (counterpart of ``cpecan_tpu/ops/pallas_fb.py``
``_PallasAlignerBase`` :1431-1477 and ``StrawmanPallasAligner``:
``prepare`` :1599-1702, ``run`` :1778-1922 and ``_run_tiled``
:2447-2616).  ``WavefrontAligner`` holds the machine-independent part;
``StrawmanAligner`` (the strawman 3-state signal machine),
``VanillaAligner`` (the vanilla 3-state signal machine,
``VanillaPallasAligner`` :2619), ``Sm4Aligner`` (the 4-state signal
machine, ``Sm4PallasAligner`` :3063), ``EchelonAligner`` (the 7-state
echelon signal machine with multi-state posteriors,
``EchelonPallasAligner`` :3233), ``HdpAligner`` (the HDP 3-state signal
machine with a streamed emission, ``HdpPallasAligner`` :2840) and
``Dna5Aligner`` (the 5-state DNA machine, ``Dna5PallasAligner`` :3084)
supply the spec, the host feature inputs and the device features.

A batch is packed into groups of R reads.  Each group shares one window of
W lanes per anti-diagonal (``win[g, d]``, covering the union of the
group's bands), so every per-read plane is [ND+1, W] instead of the full
matrix.  ``run`` assembles the features and bands on the device, runs the
forward and posterior-backward wavefronts (``fb_kernels``), and compacts
each read's posteriors to its top-k cells for the host
(``compact.compact_posteriors``).  With ``expectations`` the backward is
the expectation backward instead, and its per-read EM sums come back in
one device-to-host copy (each machine's ``exp_dispatch`` and
``exp_finalize``: the branch at pallas_fb.py:1877-1907 with :2084-2128
and :3168-3203); ``defer_expectations`` leaves that copy to
``finalize_expectations``, so that a caller can queue every chunk's
kernels before the first copy waits.

Long alignments (2^14 estimated diagonals or more, 2^15 reference columns
or more, or any run given ``tile_diag``) take the tiled path
(``_run_tiled``): the planes run to NDT = NT * TD diagonals, the tiled
kernels re-center each read's carries at every TD-diagonal tile boundary
and repay the shifts in the posteriors, and the posteriors compact per
chunk of TD diagonals (``compact.compact_chunks``; extraction:
``compact.extract_pairs_long``).  A machine with multi-state posteriors
(echelon) or a streamed emission (HDP) has no tiled path: such a run
raises before any launch.
"""

import os

import numpy as np
import torch

from ..align import AlignmentParams
from ..constants import NUM_OF_KMERS
from .band import make_bands
from .compact import compact_chunks, compact_posteriors, host_array
from .device_bands import device_bands
from .fb_kernels import (Dna5Spec, EchelonSpec, HdpSpec, Sm4Spec,
                         StrawmanSpec, VanillaSpec, _no_expectations,
                         planar, post_planes, post_states, streamed,
                         wavefront_bwd,
                         wavefront_bwd_exp, wavefront_bwd_tiled,
                         wavefront_fwd, wavefront_fwd_tiled)
from .features import (HDP_STREAM_SCRATCH_BYTES, assemble_dna5_features,
                       assemble_echelon_features, assemble_features,
                       assemble_hdp_features, assemble_vanilla_features,
                       dna5_feature_inputs, dna5_y_values,
                       echelon_feature_inputs, echelon_skip_logs,
                       feature_inputs, hdp_feature_inputs, hdp_stream,
                       host_bins, kx_from_codes, upload, upload_u16)

# f32 posterior precision is bounded by the total log magnitude, which
# grows with the diagonal count: past ~16k diagonals the untiled passes
# distort mid-sequence posteriors (BASELINE.md "Untiled precision wall"),
# and the tiled path with per-tile re-centering is the fix
TILED_MIN_DIAGONALS = 2 ** 14
TILED_MIN_COLUMNS = 2 ** 15
# the tiled path's diagonals per tile unless the caller sets tile_diag
TILE_DIAG = 2048
# share of the device's memory the banded planes may take
PLANE_MEMORY_SHARE = 0.85
SPLIT_REMEDY = ("split the alignment at anchor gaps "
                "(cpecan_tpu_torch.ops.anchors.get_split_points)")


def _round_up(v, m):
    return ((v + m - 1) // m) * m


def _call(_name, fn):
    """The default ``stage`` of ``run``: run the step."""
    return fn()


def device_memory_bytes(device):
    """Total memory of ``device``: the card's for CUDA, the host's RAM for
    the CPU."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


class WavefrontAligner:
    """Group-of-R batched banded forward/backward on the wavefront kernels,
    parameterized by a machine spec (``fb_kernels``' ``StrawmanSpec``,
    ``Dna5Spec``) and the per-machine feature hooks ``feature_inputs``
    (host) and ``device_features``; the machine supplies the kernel
    scalars (``sm.scalars``).

    Exact full backward (no traceback windowing), f32, posteriors emitted
    as band-local [R, W] windows per diagonal.  ``device`` is where the
    passes run: the CUDA device by default, whose CUDA kernels run them;
    ``"cpu"`` runs their plain PyTorch versions.  ``group`` is R (reads per
    kernel block group; 32, the JAX package's compiled default).
    """

    spec = None

    def feature_inputs(self, reads, X):
        """dict of compact host arrays merged into prep."""
        raise NotImplementedError

    def device_features(self, sm, prep):
        """(xf [Bp, NXF, X], yf [Bp, 2, C+X+256]) on ``self.device``."""
        raise NotImplementedError

    def __init__(self, params=None, device="cuda", group=32):
        self.params = params or AlignmentParams()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested, but "
                               "torch.cuda.is_available() is False")
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {self.device}")
        self.group = group

    def prepare(self, sm, reads, ragged_right=False, scale_params=None,
                shape_hint=None, bands=None, tile_diag=None):
        """Host-side packing: bands, compact feature and band-metadata
        uploads, and the per-group windows.  Returns the ``prep`` dict
        (same keys and layout as the JAX aligner's):

        - ``win`` [G, NDp] int32 group window starts, forward-filled over
          diagonals with no active band, monotone non-decreasing in d;
        - ``W`` lanes: 128, widened to cover the widest group union;
        - ``NDp`` = round_up(L + 3, 128) + 128 (the backward reads the
          windows at L + 1 and L + 2), L the planes' last diagonal: ND, or
          with ``tile_diag`` the tile plan's NDT;
        - with ``tile_diag``, ``tiled`` = dict(TD, NT, NDT, DC): TD =
          max(128, tile_diag // 128 * 128) diagonals per tile, NT =
          ceil(ND / TD) tiles, NDT = NT * TD, DC = TD diagonals per
          compaction chunk.  The windows and bands run to NDT's extended
          range (``_run_tiled``'s repeated last window, :2476-2481), and
          the events sit at C = NDT + 3, so that the sweep past ND reads
          inside the feature planes."""
        p = self.params
        R = self.group
        if bands is None:
            bands = make_bands([r[4] for r in reads], [r[2] for r in reads],
                               [r[3] for r in reads], p.diagonal_expansion)
        B = len(reads)
        G = _round_up(B, R) // R
        Bp = G * R
        X = _round_up(max(r[2] for r in reads) + 2, 128)
        ND = max(b.n_diag for b in bands)
        if shape_hint is not None:
            # (max l_x, max n_diag) over a larger batch this chunk belongs
            # to: keeps the shapes of a chunked pipeline fixed
            hx, hnd = shape_hint
            X = max(X, _round_up(hx + 2, 128))
            ND = max(ND, hnd)
        L = ND
        tiled = None
        if tile_diag is not None:
            TD = max(128, int(tile_diag) // 128 * 128)
            NT = -(-ND // TD)
            L = NT * TD
            tiled = dict(TD=TD, NT=NT, NDT=L, DC=TD)
        C = L + 3
        NDp = _round_up(L + 3, 128) + 128

        finputs = self.feature_inputs(reads + [reads[-1]] * (Bp - B), X)
        A_max = max(1, max(len(r[4]) for r in reads))
        # anchors are (x, y) pairs: the wire dtype must cover both axes
        Y_max = max(r[3] for r in reads)
        anch = np.full((Bp, A_max, 2), -1,
                       np.int16 if X < 2 ** 15 and Y_max < 2 ** 15
                       else np.int32)
        meta = np.zeros((Bp, 4), np.int32)
        for r, (_x, _y, l_x, l_y, a) in enumerate(reads):
            if len(a):
                anch[r, : len(a)] = np.asarray(a, np.int64)
            meta[r] = (l_x, l_y, bands[r].n_diag, 1 if ragged_right else 0)
        # padding rows reuse the last read's band (no ragged end)
        for r in range(B, Bp):
            anch[r] = anch[B - 1]
            meta[r] = meta[B - 1]
            meta[r, 3] = 0

        # per-group windows [lo, lo+W) covering the union of the group's
        # bands on every diagonal
        lo_all = np.full((Bp, NDp), np.inf)
        hi_all = np.full((Bp, NDp), -np.inf)
        for r in range(Bp):
            band = bands[min(r, B - 1)]
            n = band.n_diag
            act = band.width > 0
            lo_all[r, : n + 1] = np.where(act, band.x_lo, np.inf)
            hi_all[r, : n + 1] = np.where(act, band.x_lo + band.width,
                                          -np.inf)
        W = 128
        for g in range(G):
            lo = lo_all[g * R:(g + 1) * R].min(axis=0)
            hi = hi_all[g * R:(g + 1) * R].max(axis=0)
            spread = np.where(np.isfinite(lo), hi - lo, 0.0)
            W = max(W, int(_round_up(int(spread.max()), 128)))
        W = min(W, X)
        win = np.zeros((G, NDp), np.int32)
        for g in range(G):
            lo = lo_all[g * R:(g + 1) * R].min(axis=0)
            # forward-fill diagonals with no active band with the last
            # active window start (keeps windows monotone in d)
            fin = np.isfinite(lo)
            idx = np.where(fin, np.arange(lo.size), 0)
            np.maximum.accumulate(idx, out=idx)
            lo = np.where(fin[idx], lo[idx], 0.0)
            win[g] = np.clip(lo.astype(np.int64), 0, X - W)
        if (np.diff(win, axis=1) < 0).any():
            raise ValueError("non-monotone group window starts (anchor "
                             "chain must be monotone)")
        out_extra = {}
        if scale_params is not None:
            sp = np.ones((Bp, 5), np.float32)
            sp[:, 1] = 0.0  # identity: scale 1, shift 0, var/sds 1
            sp[:B] = np.asarray(scale_params, np.float32)
            out_extra["sp"] = sp
        # one int32 upload for (anchors, meta, windows)
        bandmeta = np.concatenate([
            anch.astype(np.int32).ravel(), meta.ravel(),
            win.astype(np.int32).ravel()])
        if tiled is not None:
            out_extra["tiled"] = tiled
        return dict(**finputs, **out_extra, anch=anch, meta=meta,
                    bandmeta=bandmeta, win=win, bands=bands, X=X, ND=ND,
                    C=C, B=B, Bp=Bp, R=R, W=W, NDp=NDp)

    def device_inputs(self, sm, prep, ragged_left=False):
        """The wavefront passes' inputs on ``self.device``: a dict of
        scal, win, xf, yf, basef, widthf, seedf, raggedf."""
        sm = sm.to(self.device)
        xf, yf = self.device_features(sm, prep)
        return dict(self._band_inputs(sm, prep, ragged_left), xf=xf, yf=yf)

    def _band_inputs(self, sm, prep, ragged_left):
        """scal, win, basef, widthf, seedf, raggedf on ``self.device``."""
        dev = self.device
        Bp, A = prep["anch"].shape[:2]
        G, NDp = prep["win"].shape
        bm = upload(prep["bandmeta"], dev)
        na, nm = Bp * A * 2, Bp * 4
        anch = bm[:na].reshape(Bp, A, 2)
        meta = bm[na:na + nm].reshape(Bp, 4)
        win = bm[na + nm:].reshape(G, NDp)
        basef, widthf, seedf, raggedf = device_bands(
            anch, meta, NDp, int(self.params.diagonal_expansion))
        return dict(scal=sm.scalars(ragged_left=ragged_left), win=win,
                    basef=basef, widthf=widthf, seedf=seedf, raggedf=raggedf)

    def _check_planes(self, prep, n_rows):
        """Refuse a batch whose fwd [G, n_rows, S, R, W] and posterior
        [G, n_rows, (NPS,) R, W] planes, and a streamed machine's emission
        stream [G, ND+3, R, W] (n_rows >= ND + 3) with its build's scratch
        (HDP_STREAM_SCRATCH_BYTES), or a planar machine's emission
        pre-pass plane [G, ND+3, EM_LEAVES, R, W] (one lives during each
        pass, beside the fwd plane), would not fit the device's
        PLANE_MEMORY_SHARE, naming the remedies."""
        G, R, W = prep["Bp"] // prep["R"], prep["R"], prep["W"]
        planes = (self.spec.S + len(post_states(self.spec))
                  + int(streamed(self.spec)))
        plane_bytes = 4 * G * n_rows * R * W * planes
        if streamed(self.spec):
            plane_bytes += HDP_STREAM_SCRATCH_BYTES
        if planar(self.spec):
            plane_bytes += (4 * G * (prep["ND"] + 3) * R * W
                            * self.spec.EM_LEAVES)
        limit = PLANE_MEMORY_SHARE * device_memory_bytes(self.device)
        if plane_bytes > limit:
            raise ValueError(
                f"banded planes need ~{plane_bytes / 1e9:.1f} GB of the "
                f"device's {limit / 1e9:.1f} GB (ND={prep['ND']} diagonals, "
                f"{G} groups of {R}): dispatch the batch in smaller chunks, "
                f"lower the group size, or {SPLIT_REMEDY}")

    def exp_dispatch(self, prep, inp, trans, acc, totals):
        """The expectation sums of a run (its ``device_inputs`` ``inp``) as
        ONE [G*R, F] f32 tensor on their device (the machine's
        ``_exp_dispatch``)."""
        raise NotImplementedError

    def exp_finalize(self, prep, flat):
        """Per-read expectations (numpy f64) from the flat host array (the
        machine's ``_exp_finalize``)."""
        raise NotImplementedError

    def emission_stream(self, sm, prep, inp):
        """A streamed machine's emission stream est [G, ND+3, R, W] on
        ``self.device`` (``_stream_args``)."""
        raise NotImplementedError

    def finalize_expectations(self, sm, out):
        """The host half of a deferred E-step (``run(expectations=True,
        defer_expectations=True)``, pallas_fb.py:2084-2090): one
        device-to-host copy of the flat sums, then ``exp_finalize``.
        ``sm`` is unused, as in the JAX signature."""
        return self.exp_finalize(out["prep"],
                                 host_array(out["expectations_flat"]))

    def run(self, sm, reads, ragged_right=False, ragged_left=False,
            compact_k=4096, scale_params=None, shape_hint=None, bands=None,
            expectations=False, defer_expectations=False, mesh=None,
            tile_diag=None, stage=None):
        """Posterior alignment of ``reads`` [(ref, events, l_x, l_y,
        anchors), ...] on machine ``sm``.

        Returns {"compact": (values u16, drow, lane) [G, R, k] on their way
        to the host (compact.compact_posteriors), "posteriors":
        [G, ND+1, R, W] ([G, ND+1, NPS, R, W] for a machine with
        multi-state posteriors, echelon: extract with
        ``compact.extract_echelon_pairs``/``_chunk``) and "totals": [G, R]
        tensors on the device, "prep": prepare's dict}.

        A batch of 2^14 estimated diagonals or more (or 2^15 reference
        columns), or any run given ``tile_diag``, takes the tiled path
        (``_run_tiled``, its own output layout); extract its pairs with
        ``compact.extract_pairs_auto``/``_chunk`` as any other run's.

        With ``expectations`` the backward also sums each read's EM
        expectations and "expectations" replaces "compact": the machine's
        ``exp_finalize`` (strawman {"trans" [B, 3, 3], "kmer_gap"
        [B, NUM_OF_KMERS + 2], "likelihood" [B]}; sm4 the same with
        "trans" [B, 4, 4]; vanilla {"skip_bins"
        [B, 60], "likelihood" [B]}; dna5 {"trans" [B, 5, 5], "emis"
        [B, 5, 4, 4], "likelihood" [B]}), numpy f64.  With
        ``defer_expectations`` as well, the run copies nothing to the host
        and returns {"expectations_flat": the dispatched sums on the device,
        "totals", "prep"} for ``finalize_expectations`` (no posterior
        plane: it frees before the next chunk).

        The compaction's copy to the host only starts: "compact" (the
        tiled path: "compact_chunks") is a ``compact.HostCopy``, which the
        extractors wait for (``compact.fetch(out)`` puts the host arrays in
        its place).  The run returns without waiting for its kernels, so
        that the caller's host work overlaps them (the JAX driver's
        ``copy_to_host_async``).

        ``stage(name, fn)``, when given, runs each step of the run and
        returns ``fn()``: "prepare", "inputs", a streamed machine's
        "stream", "fwd", "bwd", "compact" (the tiled path: "fwd_tiled",
        "bwd_tiled"; with ``expectations``: "bwd_exp", "dispatch",
        "finalize", no "finalize" when deferred), so that a caller can time
        them."""
        if mesh is not None:
            raise NotImplementedError(
                "data-parallel runs are not ported yet (ROADMAP Queue 1 "
                "item 9)")
        if expectations:
            _no_expectations(self.spec)
        stage = stage or _call
        est_x = _round_up(max(r[2] for r in reads) + 2, 128)
        est_nd = est_x + max(r[3] for r in reads) + 3
        if shape_hint is not None:
            est_x = max(est_x, _round_up(shape_hint[0] + 2, 128))
            est_nd = max(est_nd, shape_hint[1])
        long = est_x >= TILED_MIN_COLUMNS or est_nd >= TILED_MIN_DIAGONALS
        # the JAX package routes a multi-state run tiled and decodes its
        # planes with W lanes per row, which gives wrong pairs with no
        # error, and runs a streamed one of 2^14 diagonals or more untiled
        # with a warning (its tiled path raises for it); the port refuses
        # both (ROADMAP Queue 3)
        no_tiles = ("multi-state posteriors" if post_planes(self.spec)
                    else "streamed emissions" if streamed(self.spec)
                    else None)
        if no_tiles and (long or tile_diag is not None):
            raise NotImplementedError(
                f"~{est_nd} diagonals / {est_x} columns"
                + (f", tile_diag={tile_diag}" if tile_diag is not None
                   else "")
                + f": the {self.spec.NAME} machine's {no_tiles} have no "
                "tiled path, and f32 posteriors degrade past ~16k "
                f"diagonals untiled: {SPLIT_REMEDY}")
        if expectations and (long or tile_diag is not None):
            # the JAX package runs long expectation runs untiled with a
            # warning; the port refuses (ROADMAP Queue 3)
            raise NotImplementedError(
                f"~{est_nd} diagonals / {est_x} columns: in-kernel EM "
                "expectations have no tiled variant, and f32 posteriors "
                "degrade past ~16k diagonals untiled (BASELINE.md 'Untiled "
                f"precision wall'): {SPLIT_REMEDY}")
        kw = dict(ragged_right=ragged_right, scale_params=scale_params,
                  shape_hint=shape_hint, bands=bands)
        if long or tile_diag is not None:
            return self._run_tiled(sm, reads, ragged_left=ragged_left,
                                   compact_k=compact_k,
                                   tile_diag=tile_diag or TILE_DIAG,
                                   stage=stage, **kw)
        prep = stage("prepare", lambda: self.prepare(sm, reads, **kw))
        ND, C, W, R = prep["ND"], prep["C"], prep["W"], prep["R"]
        self._check_planes(prep, prep["NDp"])
        inp = stage("inputs", lambda: self.device_inputs(
            sm, prep, ragged_left=ragged_left))
        dims = dict(R=R, W=W, ND=ND, C=C, spec=self.spec)
        if streamed(self.spec):
            dims["est"] = stage("stream", lambda: self.emission_stream(
                sm, prep, inp))
        fwd = stage("fwd", lambda: wavefront_fwd(
            inp["scal"], inp["win"], inp["xf"], inp["yf"], inp["basef"],
            inp["widthf"], **dims))
        bargs = (inp["scal"], inp["win"], inp["xf"], inp["yf"], inp["basef"],
                 inp["widthf"], inp["seedf"], inp["raggedf"], fwd)
        if expectations:
            # E-step consumers read only the expectations: no compaction
            posts, totals, trans, acc = stage(
                "bwd_exp", lambda: wavefront_bwd_exp(*bargs, **dims))
            if defer_expectations:
                flat = stage("dispatch", lambda: self.exp_dispatch(
                    prep, inp, trans, acc, totals))
                return dict(expectations_flat=flat, totals=totals,
                            prep=prep)
            flat = stage("dispatch", lambda: host_array(self.exp_dispatch(
                prep, inp, trans, acc, totals)))
            return dict(expectations=stage(
                "finalize", lambda: self.exp_finalize(prep, flat)),
                posteriors=posts, totals=totals, prep=prep)
        posts, totals = stage("bwd", lambda: wavefront_bwd(*bargs, **dims))
        compact = stage("compact", lambda: compact_posteriors(
            posts, min(compact_k, ND * W)))
        return dict(compact=compact, posteriors=posts, totals=totals,
                    prep=prep)

    def _run_tiled(self, sm, reads, *, ragged_right=False, ragged_left=False,
                   compact_k=4096, scale_params=None, shape_hint=None,
                   bands=None, tile_diag=TILE_DIAG, stage=None):
        """The long-alignment path (``_run_tiled``, pallas_fb.py:2447-2616):
        the tiled forward and backward (``wavefront_fwd_tiled``/
        ``wavefront_bwd_tiled``, one launch each) over NDT = NT * TD
        diagonals, then an exact top-k per chunk of DC = TD diagonals.

        Returns {"compact_chunks": [(off, (values, drow, lane)), ...]
        (``compact.compact_chunks``), "tiled": dict(TD, NT, NDT, DC),
        "posteriors" [G, NDT+1, R, W] (diagonals past a read's n_diag hold
        0), "totals" [G, R], "prep"}."""
        stage = stage or _call
        prep = stage("prepare", lambda: self.prepare(
            sm, reads, ragged_right=ragged_right, scale_params=scale_params,
            shape_hint=shape_hint, bands=bands, tile_diag=tile_diag))
        tiled = prep["tiled"]
        NDT, W = tiled["NDT"], prep["W"]
        self._check_planes(prep, NDT + 1)
        inp = stage("inputs", lambda: self.device_inputs(
            sm, prep, ragged_left=ragged_left))
        dims = dict(R=prep["R"], W=W, ND=NDT, C=prep["C"], TD=tiled["TD"],
                    spec=self.spec)
        fargs = (inp["scal"], inp["win"], inp["xf"], inp["yf"], inp["basef"],
                 inp["widthf"])
        fwd, shifts = stage("fwd_tiled", lambda: wavefront_fwd_tiled(
            *fargs, **dims))
        posts, totals = stage("bwd_tiled", lambda: wavefront_bwd_tiled(
            *fargs, inp["seedf"], inp["raggedf"], fwd, shifts, **dims))
        del fwd   # free the fwd plane before the compaction's copy
        DC = tiled["DC"]
        chunks = stage("compact", lambda: compact_chunks(
            posts, DC, min(compact_k, DC * W)))
        return dict(compact_chunks=chunks, tiled=dict(tiled),
                    posteriors=posts, totals=totals, prep=prep)


class StrawmanAligner(WavefrontAligner):
    """The strawman 3-state signal machine (getStrawManStateMachine3) on
    the wavefront kernels.  Reads are (ref, events [n, >= 2], l_x, l_y,
    anchors)."""

    spec = StrawmanSpec

    def feature_inputs(self, reads, X):
        return feature_inputs(reads, X)

    def device_features(self, sm, prep):
        dev = self.device
        sp = prep.get("sp")
        return assemble_features(
            upload(prep["codes"], dev), upload_u16(prep["evq"], dev),
            upload(prep["evs"], dev), sm.match_model, sm.gap_y_model,
            sm.gap_x, prep["C"], prep["C"] + prep["X"] + 256,
            sp=None if sp is None else upload(sp, dev))

    def exp_dispatch(self, prep, inp, trans, acc, totals):
        return exp_dispatch(trans, acc, totals)

    def exp_finalize(self, prep, flat):
        return exp_finalize(prep, flat, self.spec.S)


class Sm4Aligner(StrawmanAligner):
    """The 4-state signal machine (getStateMachine4; ``models.
    state_machines.StateMachine4``) on the wavefront kernels: the
    strawman's reads, features and emissions, its own spec and scalars
    (``Sm4PallasAligner``, pallas_fb.py:3063).  Expectation runs give
    trans [B, 4, 4] and the shortGapX k-mer gap sums."""

    spec = Sm4Spec


class VanillaAligner(StrawmanAligner):
    """The vanilla 3-state signal machine (getSignalStateMachine3Vanilla,
    signalAlign's default; ``models.state_machines.StateMachine3Vanilla``)
    on the wavefront kernels: the strawman's reads and host inputs, the
    per-column transitions assembled on the device from the k-mer skip
    bins.  Expectation runs give the skip-bin EM sums
    (``vanilla_exp_dispatch``, ``vanilla_exp_finalize``)."""

    spec = VanillaSpec

    def prepare(self, sm, reads, **kw):
        """``WavefrontAligner.prepare`` plus ``level_mean``, the machine's
        host level means, which the finalize bins the columns with."""
        prep = super().prepare(sm, reads, **kw)
        prep["level_mean"] = sm.level_mean
        return prep

    def device_features(self, sm, prep):
        dev = self.device
        sp = prep.get("sp")
        return assemble_vanilla_features(
            upload(prep["codes"], dev), upload_u16(prep["evq"], dev),
            upload(prep["evs"], dev), sm.match4, sm.gap_y4, sm.skip60,
            sm.t_m_to_y_not_x, prep["C"], prep["C"] + prep["X"] + 256,
            sp=None if sp is None else upload(sp, dev))

    def exp_dispatch(self, prep, inp, trans, acc, totals):
        return vanilla_exp_dispatch(acc, totals)

    def exp_finalize(self, prep, flat):
        return vanilla_exp_finalize(prep, flat)


class EchelonAligner(StrawmanAligner):
    """The 7-state echelon signal machine (getStateMachineEchelon;
    ``models.state_machines.StateMachineEchelon`` and
    ``StateMachineEchelonB``) on the wavefront kernels, with multi-state
    posterior windows [G, ND+1, 5, R, W] (match1..match5), extracted with
    ``compact.extract_echelon_pairs``/``_chunk`` (``EchelonPallasAligner``,
    pallas_fb.py:3233-3390).  The skip logs of every column are computed
    on the host through the machine's own ``_skip_logs`` (echelon: per
    k-mer skip bin, alpha = beta; echelonB: four global scalars).

    No expectations (the reference defines no echelon EM) and no tiled
    path: a run of 2^14 estimated diagonals or more, 2^15 columns or more,
    or given ``tile_diag`` raises before any launch."""

    spec = EchelonSpec

    def feature_inputs(self, reads, X):
        return echelon_feature_inputs(reads, X)

    def device_features(self, sm, prep):
        dev = self.device
        sp = prep.get("sp")
        la4 = echelon_skip_logs(sm, prep["kxp"], prep["kx5"][:, 0], sp)
        return assemble_echelon_features(
            upload(prep["kx5"], dev), upload(la4, dev),
            upload(prep["validm"], dev), upload(prep["ev"], dev), sm.mm4,
            sm.gm4, prep["C"], prep["C"] + prep["X"] + 256,
            sp=None if sp is None else upload(sp, dev))


class HdpAligner(StrawmanAligner):
    """The HDP 3-state signal machine (getHdpStateMachine3; ``models.
    state_machines.StateMachine3Hdp``) on the wavefront kernels: the
    strawman's reads, scalars, gap-X row and expectations
    (``exp_dispatch``, ``exp_finalize``: trans [B, 3, 3], kmer_gap,
    likelihood); the match and gap-Y emission is the HDP density of the
    column's k-mer at the event mean, which ``emission_stream`` builds per
    diagonal (``features.hdp_stream``) and the kernels read
    (``HdpPallasAligner``, pallas_fb.py:2840-3060).

    As in the JAX package, the stream takes no ``scale_params`` (a given
    scaling is ignored).  No tiled path (the JAX package has none either) and no data-parallel
    run yet: a run of 2^14 estimated diagonals or more (where the JAX
    package only warns), of 2^15 columns or more, given ``tile_diag`` or
    given ``mesh`` raises before any launch."""

    spec = HdpSpec

    def feature_inputs(self, reads, X):
        return hdp_feature_inputs(reads, X)

    def device_features(self, sm, prep):
        return assemble_hdp_features(self._kmers(prep), sm.gap_x)

    def device_inputs(self, sm, prep, ragged_left=False):
        """The strawman's inputs and "kx" [Bp, X] the column k-mers, which
        the features and the stream (``emission_stream``) read: the codes
        go to the device once."""
        sm = sm.to(self.device)
        kx = self._kmers(prep)
        xf, yf = assemble_hdp_features(kx, sm.gap_x)
        return dict(self._band_inputs(sm, prep, ragged_left), xf=xf, yf=yf,
                    kx=kx)

    def _kmers(self, prep):
        return kx_from_codes(upload(prep["codes"], self.device))

    def emission_stream(self, sm, prep, inp):
        dev = self.device
        sm = sm.to(dev)
        return hdp_stream(inp["win"], inp["kx"], upload(prep["evm"], dev),
                          sm.tables, sm.slopes, sm.grid_scalars(),
                          R=prep["R"], ND=prep["ND"], W=prep["W"],
                          log_density=sm.log_density)


class Dna5Aligner(WavefrontAligner):
    """The classic 5-state DNA pair-HMM (getStateMachine5, cPecanRealign's
    and cPecanEm's machine; ``models.state_machines.StateMachine5``) on the
    wavefront kernels.  Reads are (seq_x, seq_y, l_x, l_y, anchors) with
    both sides DNA strings.  Expectation runs give cPecanEm's E-step sums
    (``dna5_exp_dispatch``, ``dna5_exp_finalize``)."""

    spec = Dna5Spec

    def feature_inputs(self, reads, X):
        return dna5_feature_inputs(reads, X)

    def device_features(self, sm, prep):
        dev = self.device
        # the y values are built on the host (dna5_y_values), from the
        # host copy of the buffer's five values
        ev = dna5_y_values(prep["ydata"], prep["reads"], sm.gapy5_host)
        return assemble_dna5_features(
            upload(prep["bx"], dev), upload(ev, dev), sm.match5, sm.gapx5,
            prep["C"], prep["C"] + prep["X"] + 256)

    def device_inputs(self, sm, prep, ragged_left=False):
        """``WavefrontAligner.device_inputs`` plus ``bx`` [Bp, X], the x
        base indices on the device for the emission contraction."""
        inp = super().device_inputs(sm, prep, ragged_left=ragged_left)
        inp["bx"] = upload(prep["bx"], self.device)
        return inp

    def exp_dispatch(self, prep, inp, trans, acc, totals):
        return dna5_exp_dispatch(trans, acc, totals, inp["bx"])

    def exp_finalize(self, prep, flat):
        return dna5_exp_finalize(prep, flat)


def exp_dispatch(trans, gapx, totals):
    """The strawman or 4-state expectation sums as ONE [G*R, S*S + X + 1]
    f32 tensor on their device (``_exp_dispatch``, pallas_fb.py:2092-2109):
    S*S transition lanes, X per-column gap-X masses (gapx [G, 1, R, X];
    the per-kmer scatter happens on the host, where the base codes are), 1
    total; a single device-to-host copy takes the whole E-step result."""
    G, R = totals.shape
    return torch.cat([trans.reshape(G * R, -1),
                      gapx[:, 0].reshape(G * R, -1),
                      totals.reshape(G * R, 1)], dim=1)


def exp_finalize(prep, flat, S=StrawmanSpec.S):
    """Per-read expectations from the flat host array of an S-state
    machine (``_exp_finalize``, pallas_fb.py:2111-2128): trans [B, S, S],
    kmer_gap [B, NUM_OF_KMERS + 2] (each column's gap-X mass added to the
    bin of its k-mer; k-mers with an N and the padding land in the two bins
    past NUM_OF_KMERS) and likelihood [B] = total * n_diag, as the
    reference has it; all f64."""
    B, X = prep["B"], prep["X"]
    tr = flat[:B, :S * S].reshape(B, S, S).astype(np.float64)
    gc = flat[:B, S * S:S * S + X].astype(np.float64)
    tot = flat[:B, S * S + X].astype(np.float64)
    kx = kx_from_codes(torch.from_numpy(prep["codes"][:B])).numpy()
    nb = NUM_OF_KMERS + 2
    idx = np.clip(kx, 0, nb - 1) + nb * np.arange(B)[:, None]
    # bincount adds in index order, as np.add.at does
    seg = np.bincount(idx.ravel(), weights=gc.ravel(),
                      minlength=B * nb).reshape(B, nb)
    n_diag = np.asarray([b.n_diag for b in prep["bands"]])
    return {"trans": tr, "kmer_gap": seg, "likelihood": tot * n_diag}


def vanilla_exp_dispatch(acc, totals):
    """The vanilla expectation sums as ONE [G*R, 2X + 1] f32 tensor on
    their device (``VanillaPallasAligner._exp_dispatch``, pallas_fb.py:
    2745-2757): each read's beta and alpha rows of acc [G, 2, R, X], then
    its total; the skip-bin scatter happens on the host."""
    G, R = totals.shape
    return torch.cat([acc.permute(0, 2, 1, 3).reshape(G * R, -1),
                      totals.reshape(G * R, 1)], dim=1)


def vanilla_exp_finalize(prep, flat):
    """Per-read vanilla expectations from the flat host array
    (``VanillaPallasAligner._exp_finalize``, pallas_fb.py:2808-2826):
    skip_bins [B, 60], each column's beta mass added to its skip bin and
    its alpha mass to bin + 30 (vanillaHmm k-mer skip expectations,
    impl/continuousHmm.c:410-426), in f64 with the bins of ``host_bins``;
    likelihood [B] = total * n_diag."""
    B, Bp, X = prep["B"], prep["Bp"], prep["X"]
    bins = host_bins(prep["codes"], prep["level_mean"], prep.get("sp"))
    masses = flat[:Bp, :2 * X].reshape(Bp, 2, X).astype(np.float64)
    rows = 60 * np.arange(Bp)[:, None]
    idx = np.concatenate([rows + bins, rows + bins + 30], axis=1)
    # bincount adds in index order, as the JAX package's np.add.at does
    skip = np.bincount(idx.ravel(), weights=masses.reshape(Bp, 2 * X).ravel(),
                       minlength=Bp * 60).reshape(Bp, 60)
    n_diag = np.asarray([b.n_diag for b in prep["bands"]])
    tot = flat[:B, 2 * X].astype(np.float64)
    return {"skip_bins": skip[:B], "likelihood": tot * n_diag}


def dna5_exp_dispatch(trans, acc, totals, bx):
    """The dna5 expectation sums as ONE [G*R, 25 + 80 + 1] f32 tensor on
    their device (``Dna5PallasAligner._exp_dispatch``, pallas_fb.py:
    3168-3191; cell_updateExpectations, impl/pairwiseAligner.c:423-441):
    the 25 transition lanes; the 20 per-column (to-state, y-base)
    accumulators acc [G, 20, R, X] contracted by each column's x base
    ``bx`` [G*R, X] to emis[to, x base, y base] (80 values), the x base
    one-hot 4 wide so that N columns (and the padding, base 4) drop out;
    the total.  The contraction is a masked f32 sum over x, exact f32 on
    every device (no matrix unit, no TF32)."""
    G, R = totals.shape
    X = acc.shape[-1]
    a = acc.permute(0, 2, 1, 3).reshape(G * R, 5, 4, X)
    emis = torch.stack([torch.where((bx == k)[:, None, None, :], a, 0.0)
                        .sum(-1) for k in range(4)], dim=2)
    return torch.cat([trans.reshape(G * R, 25), emis.reshape(G * R, 80),
                      totals.reshape(G * R, 1)], dim=1)


def dna5_exp_finalize(prep, flat):
    """Per-read dna5 expectations from the flat host array
    (``Dna5PallasAligner._exp_finalize``, pallas_fb.py:3193-3203): trans
    [B, 5, 5], emis [B, 5, 4, 4] (to-state, x base, y base) and
    likelihood [B] = total * n_diag; all f64."""
    B = prep["B"]
    n_diag = np.asarray([b.n_diag for b in prep["bands"]])
    return {"trans": flat[:B, :25].reshape(B, 5, 5).astype(np.float64),
            "emis": flat[:B, 25:105].reshape(B, 5, 4, 4).astype(np.float64),
            "likelihood": flat[:B, 105].astype(np.float64) * n_diag}
