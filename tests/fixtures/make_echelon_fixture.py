"""Build ``echelon_zymo.npz``: what the port's echelon machine in the
signalAlign batch pipeline
(``cpecan_tpu_torch.pipeline.signal_align_batch.run_batch_fast`` with
``sm_type="echelon"``) is held to, on the CPU and on the card, where there
is no JAX.

From the Zymo MinION read and the lastz guide cigar that
``zymo_train.npz`` holds, with the JAX package on the CPU (interpret-mode
Pallas kernels, float64 enabled as in the test suite):

- ``echelon_tsv`` uint8 [n]: the bytes of the read's posterior tsv (both
  strands, the 15 columns of writePosteriorProbs, the multi-state
  posteriors expanded to pairs) that the JAX
  ``cpecan_tpu.pipeline.signal_align_batch.run_batch_fast`` writes with
  ``sm_type="echelon"`` (the untrained machine, the vendored pore models,
  threshold 0.15 as bench.py's echelon pipeline runs it, the default
  ``compact_k``, one read per kernel group);
- ``guide``: the guide cigar line (``zymo_train.npz``'s), ``label``: the
  read's label (its npRead's base name), ``threshold`` and ``group``: the
  run's settings.

Neither lastz nor JAX is needed to use it (``fixtures.load_echelon_zymo``).
``batch_zymo.npz`` holds the other machines' tsvs of the same read.

Run from the repository root (needs JAX; a few minutes):
    python tests/fixtures/make_echelon_fixture.py
"""

import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "echelon_zymo.npz")
THRESHOLD = 0.15
GROUP = 1


def build_fixture():
    """The fixture's arrays (a dict); needs JAX on the CPU."""
    from cpecan_tpu.fixtures import fixture_path
    from cpecan_tpu.pipeline.signal_align_batch import run_batch_fast

    guide = str(np.load(os.path.join(HERE, "zymo_train.npz"))["guide"])
    npread = fixture_path("ZymoC_ch_1_file1.npRead")
    label = os.path.basename(npread).replace(".npRead", "")
    res = dict(guide=np.array(guide), label=np.array(label),
               threshold=np.float64(THRESHOLD), group=np.int64(GROUP))
    with tempfile.TemporaryDirectory() as tmp:
        rows = run_batch_fast(
            fixture_path("ZymoRef.txt"), [(npread, guide)], tmp,
            template_model_file=fixture_path("template_median68pA.model"),
            complement_model_file=fixture_path(
                "complement_median68pA_pop2.model"),
            threshold=THRESHOLD, group=GROUP, log=print, sm_type="echelon")
        if not (len(rows) == 1 and rows[0][1]):
            raise RuntimeError(f"echelon: {rows}")
        with open(os.path.join(tmp, label + ".tsv"), "rb") as fh:
            res["echelon_tsv"] = np.frombuffer(fh.read(), np.uint8)
    print(f"echelon: {rows[0][2]}, {len(res['echelon_tsv'])} bytes")
    return res


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    np.savez_compressed(OUT, **build_fixture())
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
