"""Time four of ``chip_smoke.py``'s host-bound end-to-end rates on the card
with the ``cpecan_tpu_torch`` package found under ``--root``:

- the strawman main path's alignments/s (phase 5): the bench batch
  (``synthetic_batch(256, 905, 800, seed=7)``) through
  ``StrawmanAligner(group=64).run`` in chunks of 64 (compact_k 1024) and
  ``extract_pairs_chunk``;
- ``signal_em_estep_reads_per_sec`` (phase 9, bench.py's signal EM
  shape): ``StrawmanAligner(group=32).run(expectations=True)`` on the
  first 128 reads of the bench batch (``synthetic_batch(256, 905, 800,
  seed=7)``), ragged at both ends, one dispatch;
- the fourState pipeline's reads/s (phase 23): ``run_batch_fast(sm_type=
  "fourState")`` on 64 copies of the Zymo read, each guided by the stored
  guide renamed to it, ``Sm4Aligner(group=32)``, chunk 64, compact_k 2048;
- ``dna_realign_alignments_per_sec`` (phase 15): bench.py's 64 pairs of
  2 kb (``dna_realign_batch()``) through ``Dna5Aligner(group=32).run`` in
  chunks of 32, ragged at both ends, compact_k 4096, the batch's shape
  hint.

Each: one warm-up, then ``--reps`` timed runs, each ended by a
synchronize.  Pointing ``--root`` at two trees unpacked beside each other
(a change and its parent) compares them on one card in one call.  Run the
file by its path (not with ``-m``, which would import the package beside
it instead of the one under ``--root``), the two trees in turns, then
summarize the lines:

    for i in $(seq 10); do
        python cpecan_tpu_torch/tools/path_rates.py --root parent \
            --label parent >> rates.jsonl
        python cpecan_tpu_torch/tools/path_rates.py --root . \
            --label change >> rates.jsonl
    done
    python cpecan_tpu_torch/tools/path_rates.py --summarize rates.jsonl

A run prints one JSON line: the label, the package's path, the card's name
and power limit, each metric's timed runs (s) and rate.  ``--summarize``
prints, per label and metric, the runs' rates in order, their median and
their quartiles, and the share of the pairs (the i-th run of each label)
in which the first label's rate is the higher.  Exits 2 without a CUDA
device.  Imports no JAX.
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time


def _rate(fn, n, reps):
    """(n / median seconds of ``reps`` timed calls after a warm-up, the
    timed seconds)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return n / statistics.median(times), times


RATES = ("main_path_alignments_per_sec", "signal_em_estep_reads_per_sec",
         "fourstate_pipeline_reads_per_sec", "dna_realign_alignments_per_sec")


def summarize(path):
    """Per label and rate: the runs' rates in order, median and quartiles;
    per rate, the pairs in which the first label leads."""
    with open(path) as fh:
        runs = [json.loads(line) for line in fh if line.startswith("{")]
    labels = list(dict.fromkeys(r["label"] for r in runs))
    print(json.dumps({"runs": {lb: sum(r["label"] == lb for r in runs)
                               for lb in labels},
                      "card": sorted({r["card"] for r in runs})}))
    for key in RATES:
        by = {lb: [r[key] for r in runs if r["label"] == lb]
              for lb in labels}
        out = {lb: {"median": statistics.median(v),
                    "quartiles": statistics.quantiles(v, n=4), "rates": v}
               for lb, v in by.items() if len(v) >= 2}
        if len(labels) == 2:
            a, b = (by[lb] for lb in labels)
            out[f"{labels[0]} leads"] = (
                f"{sum(x > y for x, y in zip(a, b))}/{min(len(a), len(b))}")
        print(json.dumps({key: out}))
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=".",
                   help="directory holding the cpecan_tpu_torch package")
    p.add_argument("--label", default="", help="name of the tree in the "
                   "output")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--summarize", metavar="JSONL",
                   help="summarize the JSON lines of earlier runs instead")
    args = p.parse_args(argv)
    if args.summarize:
        return summarize(args.summarize)
    sys.modules["jax"] = sys.modules["cpecan_tpu"] = None
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from cpecan_tpu_torch.align import AlignmentParams
    from cpecan_tpu_torch.fixtures import load_batch_zymo
    from cpecan_tpu_torch.models.state_machines import StateMachine5
    from cpecan_tpu_torch.ops.compact import extract_pairs_chunk
    from cpecan_tpu_torch.ops.fb import (Dna5Aligner, Sm4Aligner,
                                         StrawmanAligner)
    from cpecan_tpu_torch.pipeline.signal_align_batch import run_batch_fast
    from cpecan_tpu_torch.synthetic import dna_realign_batch, synthetic_batch

    out = {"label": args.label,
           "package": os.path.dirname(os.path.dirname(
               os.path.abspath(sys.modules["cpecan_tpu_torch"].__file__)))}
    sm, reads = synthetic_batch(n_reads=256, n_ref=905, n_events=800,
                                seed=7)
    sm = sm.to("cuda")
    mpa = StrawmanAligner(AlignmentParams(), device="cuda", group=64)
    thr = AlignmentParams().threshold

    def main_path():
        for i in range(0, len(reads), 64):
            out = mpa.run(sm, reads[i:i + 64], compact_k=1024)
            nds = [b.n_diag for b in out["prep"]["bands"]]
            extract_pairs_chunk(out, list(range(len(nds))), nds, thr)
        torch.cuda.synchronize()

    rate, times = _rate(main_path, len(reads), args.reps)
    out["main_path_alignments_per_sec"] = rate
    out["main_path_times_s"] = times
    epa = StrawmanAligner(AlignmentParams(), device="cuda", group=32)

    def estep():
        epa.run(sm, reads[:128], expectations=True, ragged_left=True,
                ragged_right=True)
        torch.cuda.synchronize()

    rate, times = _rate(estep, 128, args.reps)
    out["signal_em_estep_reads_per_sec"] = rate
    out["estep_times_s"] = times

    bargs, _ = load_batch_zymo()
    guide = bargs["npread_guide_pairs"][0][1].split()
    with tempfile.TemporaryDirectory() as tmp:
        pairs = []
        for i in range(64):
            label = f"read{i:03d}"
            dst = os.path.join(tmp, label + ".npRead")
            shutil.copy(bargs["npread_guide_pairs"][0][0], dst)
            pairs.append((dst, " ".join([guide[0], label] + guide[2:])))
        pa = Sm4Aligner(AlignmentParams(), device="cuda", group=32)

        def pipeline():
            run_batch_fast(bargs["reference_path"], pairs,
                           os.path.join(tmp, "out"),
                           template_model_file=bargs["template_model_file"],
                           complement_model_file=bargs[
                               "complement_model_file"],
                           log=lambda m: None, aligner=pa,
                           sm_type="fourState", chunk=64, compact_k=2048)
            torch.cuda.synchronize()

        rate, times = _rate(pipeline, 64, args.reps)
    out["fourstate_pipeline_reads_per_sec"] = rate
    out["pipeline_times_s"] = times

    dreads = dna_realign_batch()
    dsm = StateMachine5().to("cuda")
    da = Dna5Aligner(AlignmentParams(), device="cuda", group=32)
    hint = (max(r[2] for r in dreads), da.prepare(dsm, dreads)["ND"])

    def realign():
        for i in range(0, len(dreads), 32):
            da.run(dsm, dreads[i:i + 32], ragged_left=True,
                   ragged_right=True, compact_k=4096, shape_hint=hint)
        torch.cuda.synchronize()

    rate, times = _rate(realign, len(dreads), args.reps)
    out["dna_realign_alignments_per_sec"] = rate
    out["realign_times_s"] = times
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
