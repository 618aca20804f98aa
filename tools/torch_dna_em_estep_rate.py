"""Time bench.py's ``dna_em_estep_alignments_per_sec`` workload on the card
with the ``cpecan_tpu_torch`` package found under ``--root``.

The workload is ``chip_smoke.py`` phase 18's: bench.py's cPecanEm E-step
batch (``synthetic.dna_em_batch()``, 128 x 1 kb alignments, one shard),
the equalised fiveState start, ``Dna5Aligner(group=32)``, the deferred
chunks of 64 of ``pipeline.em.calculate_expectations_pallas``; one warm-up,
then ``--reps`` timed E-steps, each ended by a synchronize.  Pointing
``--root`` at two trees unpacked beside each other (a change and its
parent) compares them on one card in one call; run them in turns:

    python tools/torch_dna_em_estep_rate.py --root parent --label parent
    python tools/torch_dna_em_estep_rate.py --root . --label change

Prints one JSON line: the label, the package's path, the card's name and
power limit, each timed E-step and the median (s), and the rate.  Exits 2
without a CUDA device.  Imports no JAX.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=".",
                   help="directory holding the cpecan_tpu_torch package")
    p.add_argument("--label", default="", help="name of the tree in the "
                   "output")
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)
    sys.modules["jax"] = sys.modules["cpecan_tpu"] = None
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from cpecan_tpu_torch.ops.fb import Dna5Aligner
    from cpecan_tpu_torch.pipeline import em
    from cpecan_tpu_torch.synthetic import dna_em_batch

    seqs, alns, rng = dna_em_batch()
    opts = em.EmOptions(train_emissions=True)
    hmm = em.PipelineHmm("fiveState")
    hmm.equalise()
    sm = hmm.to_state_machine()
    aligner = Dna5Aligner(opts.realign_params, device="cuda", group=32)
    shards = em._shard_alignments(alns, opts, rng)

    def estep():
        em.calculate_expectations_pallas(shards, seqs, sm,
                                         opts.realign_params, aligner)
        torch.cuda.synchronize()

    estep()
    times = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        estep()
        times.append(time.perf_counter() - t0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    med = statistics.median(times)
    print(json.dumps({
        "label": args.label, "package": os.path.dirname(em.__file__),
        "card": smi, "alignments": len(alns), "times_s": times,
        "median_s": med, "dna_em_estep_alignments_per_sec": len(alns) / med}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
