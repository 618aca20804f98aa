"""The vanillaAlign-equivalent CLI's helpers and its posterior tsv writer
(a subset of ``cpecan_tpu/cli/signal_align.py``, which imports JAX through
its aligners and so cannot be imported here): the guide-anchor remapping
and event slicing the pipelines share, and ``write_posterior_probs``, the
15-column posterior tsv of the batch pipeline
(``pipeline.signal_align_batch.run_batch_fast``), byte for byte the JAX
package's.  The per-read CLI ``main`` waits for the scan engine (ROADMAP
Queue 1 item 8b, after item 7)."""

from functools import lru_cache

import numpy as np

from ..constants import KMER_LENGTH, PAIR_ALIGNMENT_PROB_1, TEMPLATE
from ..io.fasta import reverse_complement
from ..io.npread import remap_anchor_pairs_with_offset
from ..ops.anchors import filter_to_remove_overlap


def get_remapped_anchor_pairs(unmapped, event_map, map_offset):
    """getRemappedAnchorPairs (vanillaAlign.c:97-102)."""
    remapped = remap_anchor_pairs_with_offset(unmapped, event_map, map_offset)
    return filter_to_remove_overlap(remapped)


def make_event_slice(events, query_start, query_end, event_map):
    """makeEventSequenceFromPairwiseAlignment (vanillaAlign.c:272-287).

    The complement event map runs backwards along the read, so the
    reference's `endIdx - startIdx` length is negative there (undefined
    behaviour in the C).  We take the [min, max) event window instead —
    complement events in increasing index order correspond to the
    reverse-complemented reference in forward order.
    """
    start_idx = int(event_map[query_start])
    end_idx = int(event_map[query_end])
    lo, hi = min(start_idx, end_idx), max(start_idx, end_idx)
    return events[lo:hi], lo


def _native_tsv():
    """The native tsv block formatter (native/tsv_format.cc, loaded once by
    ``native.load_library``), or None when no C++ toolchain is available
    (the Python path runs instead, with identical bytes).  The first call
    builds it: make it before any thread pool writes."""
    import ctypes

    from ..native import load_library
    lib = load_library("tsv_format")[0]
    if lib is not None and lib.tsv_format_rows.argtypes is None:
        lib.tsv_format_rows.restype = ctypes.c_longlong
        lib.tsv_format_rows.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_char_p, ctypes.c_longlong]
    return lib


def tsv_formatter():
    """Which formatter ``write_posterior_probs`` runs, for the log: the
    native library (its path) or the Python one (why)."""
    from ..native import load_library
    lib, note = load_library("tsv_format")
    if _native_tsv() is not None:
        return f"native ({note})"
    return f"python ({note if lib is None else 'native formatter off'})"


def _kmer_windows(seq):
    """All KMER_LENGTH-windows of ``seq`` as an array of byte strings
    (zero-copy byte view; str round-trips below are ASCII)."""
    codes = np.frombuffer(seq.encode(), np.uint8)
    win = np.lib.stride_tricks.sliding_window_view(codes, KMER_LENGTH)
    return np.ascontiguousarray(win).view(f"S{KMER_LENGTH}").ravel()


@lru_cache(maxsize=128)
def _target_columns(target):
    """Per-target tsv columns (kmer indices + kmer byte windows), cached:
    reads of a batch that map to the same guide region share them."""
    from ..models.kmers import seq_to_kmer_indices
    return seq_to_kmer_indices(target, length=len(target)), \
        _kmer_windows(target)


@lru_cache(maxsize=128)
def _rc_windows(target):
    return _kmer_windows(reverse_complement(target))


def write_posterior_probs(fh, read_label, match_model, scale, shift, events,
                          target, forward, contig, event_offset, ref_offset,
                          aligned_pairs, strand):
    """writePosteriorProbs (vanillaAlign.c:26-95), vectorized: one row per
    aligned pair, 15 tab-separated columns (contig, reference position, its
    k-mer, read label, strand, event index, event mean / noise / duration,
    the k-mer's model k-mer, expected level mean and noise, posterior,
    descaled event mean, descaled expected level).  ``aligned_pairs`` may
    be a list of (score, x, y) tuples or an [N, 3] int array."""
    if len(aligned_pairs) == 0:
        return
    strand_label = "t" if strand == TEMPLATE else "c"
    ap = np.asarray(aligned_pairs, dtype=np.int64)
    score, x_i, y0 = ap[:, 0], ap[:, 1], ap[:, 2]
    if (strand == TEMPLATE) == forward:
        x_adj = x_i + ref_offset
    else:
        ref_len = len(target)
        ref_len_in_events = ref_len - KMER_LENGTH
        x_adj = ref_len_in_events - (x_i + (ref_len - ref_offset))
    y = y0 + event_offset
    p = score / PAIR_ALIGNMENT_PROB_1
    ev = events[y]
    descaled_mean = (ev[:, 0] - shift) / scale
    kidx_all, kwin = _target_columns(target)
    k_idx = kidx_all[np.clip(x_i, 0, len(kidx_all) - 1)]
    ok = (k_idx >= 0) & (k_idx < match_model.shape[0])
    safe = np.clip(k_idx, 0, match_model.shape[0] - 1)
    e_level = np.where(ok, match_model[safe, 0], 0.0)
    e_noise = np.where(ok, match_model[safe, 2], 0.0)
    descaled_e_level = (e_level - shift) / scale
    L = len(target)
    k_bytes = kwin[x_i]
    if (strand == TEMPLATE) == forward:
        ref_bytes = k_bytes
    else:
        ref_bytes = _rc_windows(target)[L - x_i - KMER_LENGTH]

    n = len(ap)
    lib = _native_tsv()
    if lib is not None:
        # the native block formatter (native/tsv_format.cc): the same bytes
        # as the %-format pass below
        import ctypes
        cont = np.ascontiguousarray
        ev_c = cont(ev, dtype=np.float64)
        f64 = [cont(a, dtype=np.float64)
               for a in (e_level, e_noise, p, descaled_mean,
                         descaled_e_level)]
        frag0 = (contig + "\t").encode()
        frag2 = ("\t" + read_label + "\t" + strand_label + "\t").encode()
        cap = n * (160 + len(frag0) + len(frag2)) + 4096
        for _ in range(3):
            buf = ctypes.create_string_buffer(cap)
            m = lib.tsv_format_rows(
                frag0, frag2, n,
                cont(x_adj, dtype=np.int64).ctypes.data_as(
                    ctypes.c_void_p),
                cont(ref_bytes).ctypes.data_as(ctypes.c_void_p),
                ref_bytes.dtype.itemsize,
                cont(y, dtype=np.int64).ctypes.data_as(ctypes.c_void_p),
                ev_c.ctypes.data_as(ctypes.c_void_p),
                cont(k_bytes).ctypes.data_as(ctypes.c_void_p),
                k_bytes.dtype.itemsize,
                *(a.ctypes.data_as(ctypes.c_void_p) for a in f64),
                buf, cap)
            if m >= 0:
                fh.write(buf.raw[:m].decode("utf-8"))
                return
            cap *= 8  # snprintf fallback rows (huge magnitudes) blew cap

    # one printf-style pass over the whole block: the per-row format
    # string replicated n times, applied to the row-interleaved values
    k_col = k_bytes.astype("U")
    ref_col = k_col if ref_bytes is k_bytes else ref_bytes.astype("U")
    esc = str.maketrans({"%": "%%"})
    fmt = (f"{contig.translate(esc)}\t%d\t%s\t{read_label.translate(esc)}"
           f"\t{strand_label}\t%d\t%f\t%f\t%f\t%s\t%f\t%f\t%f\t%f\t%f\n")
    obj = np.empty((n, 12), object)
    for j, col in enumerate((x_adj, ref_col, y, ev[:, 0], ev[:, 1],
                             ev[:, 2], k_col, e_level, e_noise, p,
                             descaled_mean, descaled_e_level)):
        obj[:, j] = col
    fh.write((fmt * n) % tuple(obj.ravel().tolist()))
