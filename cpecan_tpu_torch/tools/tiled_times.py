"""Time the tiled kernel pair (K6a, K6b) of the strawman, vanilla and
fourState machines as built from several source trees, on the inputs of
``chip_smoke.py``'s phases 12, 21 and 22: the 64 long reads
(``long_signal_read`` of the fixture long read's lengths, seeds 11..74,
group 8) and the 1,500 x 2,550 check read (seed 11, the long reads' tile).

    python cpecan_tpu_torch/tools/tiled_times.py build/parent .

Each tree is a directory holding ``cpecan_tpu_torch/csrc`` (a parent
unpacked with ``git archive`` beside the change, say).  Every tree's
kernel library builds at once with this tree's ``cuda_build.NVCC_FLAGS``
into ``build/tiled_times/``.  For each machine and read set, one staged
run of this tree's aligner (on the first tree's library) gives the
inputs; then each tree's K6a and K6b launch on them in turns, ``--rounds``
rounds of every tree in order, each a mean of 3 launches after a warm-up
(CUDA events), and each tree's outputs must equal the first tree's bit
for bit.  Prints one JSON line per machine, read set and tree: the
median ms of each kernel over the rounds, every round's ms, ns a
diagonal, and the card's name and power limit.  Run the file by its path
(the package beside it is the one measured).  Exits 2 without a CUDA
device, 1 if a build fails; imports no JAX.
"""

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
LONG_READS, LONG_GROUP, LONG_COMPACT_K = 64, 8, 4096
LONG_CHECK = (1500, 2550)


def build(trees, cuda_build):
    """The ctypes handle of each tree's kernel library, all nvcc runs at
    once."""
    out = ROOT / "build" / "tiled_times"
    out.mkdir(parents=True, exist_ok=True)
    libs = [out / f"tree{i}.so" for i in range(len(trees))]
    procs = [subprocess.Popen(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib),
         str(Path(tree) / "cpecan_tpu_torch" / "csrc" / "wavefront.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for tree, lib in zip(trees, libs)]
    handles = []
    for tree, proc, lib in zip(trees, procs, libs):
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"build of {tree} failed:\n{log}")
        handle = ctypes.CDLL(str(lib))
        for name, argtypes in cuda_build._SIGNATURES.items():
            getattr(handle, name).argtypes = argtypes
            getattr(handle, name).restype = ctypes.c_int
        handle.wavefront_error_string.argtypes = [ctypes.c_int]
        handle.wavefront_error_string.restype = ctypes.c_char_p
        handles.append(handle)
    return handles


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("trees", nargs="+", help="source trees, the first the "
                   "reference")
    p.add_argument("--rounds", type=int, default=3)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.modules["jax"] = None
    import torch

    if not torch.cuda.is_available():
        print("tiled_times: no CUDA device", file=sys.stderr)
        return 2
    from cpecan_tpu_torch.align import AlignmentParams
    from cpecan_tpu_torch.fixtures import load_long_read
    from cpecan_tpu_torch.models.state_machines import (
        StateMachine3SignalStrawman, StateMachine3Vanilla, StateMachine4)
    from cpecan_tpu_torch.ops import cuda_build
    from cpecan_tpu_torch.ops import fb_kernels as fk
    from cpecan_tpu_torch.ops.fb import (Sm4Aligner, StrawmanAligner,
                                         VanillaAligner)
    from cpecan_tpu_torch.synthetic import long_signal_read

    try:
        handles = build(args.trees, cuda_build)
    except RuntimeError as exc:
        print(exc)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda")

    def use(handle):
        cuda_build._Library.lib = handle

    def cuda_ms(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    lmodel, lread, _ = load_long_read()
    lreads = [long_signal_read(lread[2], lread[3], seed)[1]
              for seed in range(11, 11 + LONG_READS)]
    cread = long_signal_read(LONG_CHECK[0], LONG_CHECK[1], 11)[1]
    machines = (
        ("strawman", StrawmanAligner, StateMachine3SignalStrawman,
         fk.StrawmanSpec),
        ("vanilla", VanillaAligner, StateMachine3Vanilla, fk.VanillaSpec),
        ("fourState", Sm4Aligner, StateMachine4, fk.Sm4Spec))
    use(handles[0])
    for label, aligner_cls, machine_cls, spec in machines:
        aligner = aligner_cls(AlignmentParams(), device=dev,
                              group=LONG_GROUP)
        machine = machine_cls(lmodel)
        td = None
        for reads_label, reads in (("64 long reads", lreads),
                                   ("check read", [cread])):
            st = {}

            def stage(name, fn):
                st[name] = res = fn()
                return res

            aligner.run(machine, reads, compact_k=LONG_COMPACT_K,
                        tile_diag=td, stage=stage)
            prep, inp = st["prepare"], st["inputs"]
            tl = prep["tiled"]
            td = tl["TD"]
            dims = dict(R=prep["R"], W=prep["W"], ND=tl["NDT"], C=prep["C"],
                        TD=td, spec=spec)
            fa = [inp[k] for k in ("scal", "win", "xf", "yf", "basef",
                                   "widthf")]
            ba = fa + [inp["seedf"], inp["raggedf"]]
            (fwd, sh), (posts, tot) = st["fwd_tiled"], st["bwd_tiled"]
            del st
            times = [dict(fwd=[], bwd=[]) for _ in handles]
            for i, handle in enumerate(handles):
                use(handle)
                got = fk.wavefront_fwd_tiled(*fa, **dims)
                if not (torch.equal(got[0], fwd) and torch.equal(got[1], sh)):
                    raise AssertionError(f"{args.trees[i]}: K6a {label} "
                                         "differs from the first tree's")
                got = fk.wavefront_bwd_tiled(*ba, fwd, sh, **dims)
                if not (torch.equal(got[0], posts)
                        and torch.equal(got[1], tot)):
                    raise AssertionError(f"{args.trees[i]}: K6b {label} "
                                         "differs from the first tree's")
                del got
            for _ in range(args.rounds):
                for i, handle in enumerate(handles):
                    use(handle)
                    times[i]["fwd"].append(cuda_ms(
                        lambda: fk.wavefront_fwd_tiled(*fa, **dims)))
                    times[i]["bwd"].append(cuda_ms(
                        lambda: fk.wavefront_bwd_tiled(*ba, fwd, sh,
                                                       **dims)))
            use(handles[0])
            for tree, t in zip(args.trees, times):
                row = {"machine": label, "reads": reads_label, "tree": tree,
                       "NDT": dims["ND"], "W": dims["W"], "card": smi}
                for k in ("fwd", "bwd"):
                    med = statistics.median(t[k])
                    row.update({f"{k}_ms": med, f"{k}_rounds_ms": t[k],
                                f"{k}_ns_per_diagonal":
                                    med * 1e6 / dims["ND"]})
                print(json.dumps(row), flush=True)
            del fa, ba, fwd, sh, posts, tot, inp, prep
            torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
