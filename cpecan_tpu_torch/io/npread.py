"""npRead parser (the part of ``cpecan_tpu/io/npread.py`` that the port
uses).

Parity with nanopore_loadNanoporeReadFromFile (impl/nanopore.c:32-192).
6-line text format:
  1: readLen nTemplateEvents nComplementEvents
     t_scale t_shift t_var t_scale_sd t_var_sd
     c_scale c_shift c_var c_scale_sd c_var_sd
  2: 2D read sequence
  3: template event map  (one int per read position: kmer index -> event idx)
  4: template events     (mean, stdev, duration triples)
  5: complement event map
  6: complement events
"""

from dataclasses import dataclass

import numpy as np

from ..constants import NB_EVENT_PARAMS


@dataclass
class AdjustmentParams:
    scale: float
    shift: float
    var: float
    scale_sd: float
    var_sd: float


@dataclass
class NanoporeRead:
    read_length: int
    template_params: AdjustmentParams
    complement_params: AdjustmentParams
    twod_read: str
    template_event_map: np.ndarray      # [read_length] int64
    template_events: np.ndarray         # [nTemplateEvents, 3] float64
    complement_event_map: np.ndarray
    complement_events: np.ndarray

    @property
    def n_template_events(self):
        return self.template_events.shape[0]


def load_npread(path):
    with open(path) as fh:
        header = fh.readline().split()
        read_len, n_t, n_c = (int(v) for v in header[:3])
        t = [float(v) for v in header[3:8]]
        c = [float(v) for v in header[8:13]]
        twod = fh.readline().split()[0]
        t_map = np.fromstring(fh.readline(), dtype=np.int64, sep=" ")
        t_events = np.fromstring(fh.readline(), dtype=np.float64, sep=" ")
        c_map = np.fromstring(fh.readline(), dtype=np.int64, sep=" ")
        c_events = np.fromstring(fh.readline(), dtype=np.float64, sep=" ")
    if len(t_map) != read_len or len(c_map) != read_len:
        raise ValueError("event map length does not match read length")
    if (len(t_events) != n_t * NB_EVENT_PARAMS
            or len(c_events) != n_c * NB_EVENT_PARAMS):
        raise ValueError("event array length mismatch")
    return NanoporeRead(
        read_length=read_len,
        template_params=AdjustmentParams(*t),
        complement_params=AdjustmentParams(*c),
        twod_read=twod,
        template_event_map=t_map,
        template_events=t_events.reshape(n_t, NB_EVENT_PARAMS),
        complement_event_map=c_map,
        complement_events=c_events.reshape(n_c, NB_EVENT_PARAMS),
    )


def remap_anchor_pairs_with_offset(anchor_pairs, event_map, map_offset):
    """nanopore_remapAnchorPairsWithOffset (impl/nanopore.c:206-218)."""
    off = int(event_map[map_offset])
    return [(x, int(event_map[y]) - off) for x, y in anchor_pairs]
