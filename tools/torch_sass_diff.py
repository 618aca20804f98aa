"""Build the port's CUDA kernel library from two or more source trees at
once and compare them kernel instance by kernel instance: ptxas's
registers and spill of each, and whether each instance's whole-function
SASS equals the first tree's.

    python tools/torch_sass_diff.py build/parent . \\
        --rename "sm3_bwd_tiled_sel<Dna5, 0>=sm3_bwd_tiled_sel<Dna5, 0, 1>"

Each tree is a directory holding ``cpecan_tpu_torch/csrc`` (a parent
unpacked with ``git archive`` beside the change, say).  Every tree builds
with this tree's ``cuda_build.NVCC_FLAGS``, all nvcc runs at once, into
``build/sass/``.  An instance is keyed by its template and arguments, as
``chip_smoke.py`` names it (``sm3_bwd_tiled_sel<Dna5, 0, 1>``); a
``--rename OLD=NEW`` pairs an instance of the first tree with one whose
template arguments changed.  SASS is compared whole (``cuobjdump -sass``,
the instruction text without addresses and encodings); an instance that
differs only in the offsets of its constant-bank-0 operands (the kernel
parameter block: a parameter removed or added before others) reads
"same SASS but parameter offsets".  Prints one line per instance and
tree; exits 1 if a build fails.  Needs the CUDA toolkit
(the GPU machine); imports no JAX.
"""

import argparse
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
INSTANCE = re.compile(r"(sm3_\w+?)INS_\d+(\w+?)E((?:Lb[01]E)*)")


def instance(mangled):
    """``sm3_bwd_tiled_sel<Dna5, 0, 1>`` for a mangled kernel name, or
    None."""
    m = INSTANCE.search(mangled)
    if not m:
        return None
    flags = "".join(", " + f for f in re.findall(r"Lb([01])E", m.group(3)))
    return f"{m.group(1)}<{m.group(2)}{flags}>"


def ptxas(log):
    """{instance: "registers, spill"} from nvcc's -Xptxas -v output."""
    out, key = {}, None
    for line in log.splitlines():
        name = instance(line) if "Compiling entry" in line else None
        if name:
            key = name
        elif key and ("registers" in line or "spill" in line):
            out[key] = (out.get(key, "") + " " + line.split(":", 1)[-1]
                        .strip()).strip()
    return out


def sass(lib, cuobjdump):
    """{instance: [instruction text]} of a built library."""
    res = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                         text=True, check=True)
    funcs, cur = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = instance(m.group(1))
            if cur:
                funcs[cur] = []
        elif cur and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            funcs[cur].append(re.sub(r"/\*[0-9a-f]{4,}\*/|/\* 0x[0-9a-f]+ \*/",
                                     "", line).strip())
    return funcs


def without_params(code):
    """``code`` with every constant-bank-0 offset blanked."""
    return [re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][.]", i) for i in code]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("trees", nargs="+", help="source trees, the first the "
                   "reference")
    p.add_argument("--rename", action="append", default=[],
                   help="OLD=NEW: the first tree's instance OLD is NEW in "
                   "the others")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from cpecan_tpu_torch.ops import cuda_build

    nvcc = cuda_build._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    out = ROOT / "build" / "sass"
    out.mkdir(parents=True, exist_ok=True)
    libs = [out / f"tree{i}.so" for i in range(len(args.trees))]
    procs = [subprocess.Popen(
        [nvcc, *cuda_build.NVCC_FLAGS, "-o", str(lib),
         str(Path(tree) / "cpecan_tpu_torch" / "csrc" / "wavefront.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for tree, lib in zip(args.trees, libs)]
    logs = [proc.communicate()[0] for proc in procs]
    for tree, proc, log in zip(args.trees, procs, logs):
        if proc.returncode:
            print(f"build of {tree} failed ({proc.returncode}):\n{log}")
            return 1
    rename = dict(r.split("=", 1) for r in args.rename)
    regs = [ptxas(log) for log in logs]
    code = [sass(lib, cuobjdump) for lib in libs]
    ref = code[0]
    paired = set()
    for name in sorted(ref):
        new = rename.get(name, name)
        paired.add(new)
        for tree, funcs, reg in zip(args.trees[1:], code[1:], regs[1:]):
            if new not in funcs:
                state = "gone"
            elif funcs[new] == ref[name]:
                state = "same SASS"
            elif without_params(funcs[new]) == without_params(ref[name]):
                state = "same SASS but parameter offsets"
            else:
                state = "different SASS"
            print(f"{name} -> {tree}: {new}: {state} ({len(ref[name])} / "
                  f"{len(funcs.get(new, []))} instructions); ptxas "
                  f"{regs[0].get(name)} / {reg.get(new)}")
    for tree, funcs, reg in zip(args.trees[1:], code[1:], regs[1:]):
        for name in sorted(set(funcs) - paired):
            print(f"new in {tree}: {name} ({len(funcs[name])} "
                  f"instructions); ptxas {reg.get(name)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
