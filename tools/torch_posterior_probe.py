"""Probe where the posterior backward of the signal machines (K2 and K6b
strawman and vanilla) spends its time beyond its form, on the inputs of
``chip_smoke.py``:

- ``forms``: the untiled posterior form (K2, ``wavefront_bwd``) against
  the tiled one (K6b, ``wavefront_bwd_tiled``) on the same reads: the
  first 64-read chunk of bench.py's 256 signal reads (group 64; K6b over
  one tile of 1,792 diagonals) and phase 12's 64 long reads (group 8;
  K6b at the path's own tile), so that the inputs' cost and the form's
  cost come apart;
- ``padding``: K2 on the bench chunk as it is, and with every entry of
  the model rows that a padding column holds (sd, lambda or a noise mean
  <= 0) and every noise <= 0 set to 1.0, in turns (as is, set, set, as
  is): the time those lanes cost (the outputs then differ, so only times
  are kept);
- ``count``: the share of warp-steps of K2 with a lane whose model sd
  row is <= 0, on the bench chunk and on one group of 8 long reads
  (CPU; from the inputs alone).

    python tools/torch_posterior_probe.py             # all three
    python tools/torch_posterior_probe.py --probe count   # CPU only

Times are CUDA events: the median of 3 (``forms``) or 5 (``padding``)
rounds, each the mean of 3 launches after a warm-up.  Prints one JSON
line per machine and probe, with the card's name and power limit.  The
card's probes exit 2 without a CUDA device; imports no JAX.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = dict(n_reads=256, n_ref=905, n_events=800, seed=7)
CHUNK = 64
LONG_READS, LONG_GROUP = 64, 8
BENCH_TD = 1792   # one tile over the bench chunk's 1,700 diagonals


def cuda_ms(fn, rounds, reps=3):
    import torch

    out = []
    for _ in range(rounds):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def machines(long_reads):
    """{set: (reads, group, tile_diag, {machine: (aligner class, state
    machine, spec)})} for the bench chunk and the long reads."""
    from cpecan_tpu_torch.fixtures import fixture_path, load_long_read
    from cpecan_tpu_torch.io.poremodel import load_pore_model
    from cpecan_tpu_torch.models.state_machines import (
        StateMachine3SignalStrawman, StateMachine3Vanilla)
    from cpecan_tpu_torch.ops import fb_kernels as fk
    from cpecan_tpu_torch.ops.fb import (TILE_DIAG, StrawmanAligner,
                                         VanillaAligner)
    from cpecan_tpu_torch.synthetic import long_signal_read, synthetic_batch

    sm, reads = synthetic_batch(**BENCH)
    tmodel = load_pore_model(fixture_path("template_median68pA.model"))
    sets = {"bench chunk": (reads[:CHUNK], CHUNK, BENCH_TD, {
        "strawman": (StrawmanAligner, sm, fk.StrawmanSpec),
        "vanilla": (VanillaAligner, StateMachine3Vanilla(tmodel),
                    fk.VanillaSpec)})}
    if long_reads:
        lmodel, lread, _ = load_long_read()
        lreads = [long_signal_read(lread[2], lread[3], seed)[1]
                  for seed in range(11, 11 + long_reads)]
        sets[f"{long_reads} long reads"] = (lreads, LONG_GROUP, TILE_DIAG, {
            "strawman": (StrawmanAligner, StateMachine3SignalStrawman(lmodel),
                         fk.StrawmanSpec),
            "vanilla": (VanillaAligner, StateMachine3Vanilla(lmodel),
                        fk.VanillaSpec)})
    return sets


def inputs(cls, machine, spec, reads, group, dev, tile_diag=None):
    """(prep, fwd args, bwd args, dims) as the aligner stages them."""
    from cpecan_tpu_torch.align import AlignmentParams

    al = cls(AlignmentParams(), device=dev, group=group)
    prep = al.prepare(machine, reads, tile_diag=tile_diag)
    inp = al.device_inputs(machine, prep)
    nd = prep["tiled"]["NDT"] if tile_diag else prep["ND"]
    dims = dict(R=prep["R"], W=prep["W"], ND=nd, C=prep["C"], spec=spec)
    if tile_diag:
        dims["TD"] = prep["tiled"]["TD"]
    fa = [inp[k] for k in ("scal", "win", "xf", "yf", "basef", "widthf")]
    return prep, fa, fa + [inp["seedf"], inp["raggedf"]], dims


def forms(dev, card):
    from cpecan_tpu_torch.ops import fb_kernels as fk

    for label, (reads, group, td, specs) in machines(LONG_READS).items():
        for name, (cls, machine, spec) in specs.items():
            row = dict(probe="forms", set=label, machine=name, card=card)
            for form, tdiag in (("K2", None), ("K6b", td)):
                _, fa, ba, d = inputs(cls, machine, spec, reads, group, dev,
                                      tdiag)
                if tdiag:
                    fwd, sh = fk.wavefront_fwd_tiled(*fa, **d)
                    ms = cuda_ms(lambda: fk.wavefront_bwd_tiled(
                        *ba, fwd, sh, **d), 3)
                else:
                    fwd = fk.wavefront_fwd(*fa, **d)
                    ms = cuda_ms(lambda: fk.wavefront_bwd(*ba, fwd, **d), 3)
                row.update({f"{form}_ms": ms, f"{form}_ND": d["ND"],
                            f"{form}_TD": d.get("TD"),
                            f"{form}_ns_per_diagonal": ms * 1e6 / d["ND"]})
                del fwd, fa, ba
            print(json.dumps(row), flush=True)


def padding(dev, card):
    from cpecan_tpu_torch.ops import fb_kernels as fk

    # the rows whose entries a padding column holds as <= 0: the sd rows
    # (strawman), and vanilla's level sd, noise mean and lambda rows
    rows = {"strawman": [1, 3, 5, 7], "vanilla": [1, 2, 3, 5, 6, 7]}
    reads, group, _, specs = machines(0)["bench chunk"]
    for name, (cls, machine, spec) in specs.items():
        _, fa, ba, d = inputs(cls, machine, spec, reads, group, dev)
        xf, yf = fa[2].clone(), fa[3].clone()
        for r in rows[name]:
            xf[:, r][xf[:, r] <= 0] = 1.0
        yf[:, 1][yf[:, 1] <= 0] = 1.0
        variants = {"as_is": (fa, ba),
                    "padding_1": (fa[:2] + [xf, yf] + fa[4:],
                                  ba[:2] + [xf, yf] + ba[4:])}
        row = dict(probe="padding", set="bench chunk", machine=name,
                   ND=d["ND"], card=card)
        for variant in ("as_is", "padding_1", "padding_1", "as_is"):
            f_, b_ = variants[variant]
            fwd = fk.wavefront_fwd(*f_, **d)
            row.setdefault(f"{variant}_bwd_ms", []).append(
                cuda_ms(lambda: fk.wavefront_bwd(*b_, fwd, **d), 5))
            del fwd
        print(json.dumps(row), flush=True)


def count():
    import numpy as np

    for label, (reads, group, _, specs) in machines(LONG_GROUP).items():
        cls, machine, spec = specs["strawman"]
        prep, fa, _, d = inputs(cls, machine, spec, reads, group, "cpu")
        xf, win = fa[2].numpy(), fa[1].numpy()
        R, W, ND, X = d["R"], d["W"], d["ND"], xf.shape[2]
        lanes = np.arange(W)[None]
        bad = steps = 0
        for b in range(win.shape[0] * R):
            # step d reads the rows at x = win[g, d] + l (clamped as the
            # kernels' next_col clamps)
            x = np.minimum(win[b // R, 1:ND + 1][:, None] + lanes, X - 1)
            lane_bad = (xf[b, [1, 3, 5, 7]][:, x] <= 0).any(0)
            warp_bad = lane_bad.reshape(ND, W // 32, 32).any(2)
            bad += int(warp_bad.sum())
            steps += warp_bad.size
        w = win[0, :ND + 3]
        print(json.dumps(dict(
            probe="count", set=label, machine="strawman", ND=ND, W=W,
            warp_steps_with_a_padding_lane=bad / steps,
            window_moves=float(np.mean(np.diff(w) != 0)))), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--probe", choices=("forms", "padding", "count", "all"),
                   default="all")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.modules["jax"] = None
    sys.modules["cpecan_tpu"] = None
    import torch

    if args.probe in ("count", "all"):
        count()
    if args.probe == "count":
        return 0
    if not torch.cuda.is_available():
        print("torch_posterior_probe: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    if args.probe in ("forms", "all"):
        forms(dev, card)
    if args.probe in ("padding", "all"):
        padding(dev, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
