"""Build and load the port's CUDA kernels (``cpecan_tpu_torch/csrc``).

The sources compile with ``nvcc`` into one shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds).  The library lands in ``build/kernels/`` at the repository root
(gitignored), named by a hash of the sources and flags, beside the output
of the nvcc run that built it (its ptxas report), and is built at first
CUDA use: a fresh checkout builds it on its first call.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("wavefront.cu", "logspace.cuh")
# no fast math; --fmad=false keeps the kernels' rounding equal to the plain
# PyTorch versions' on the same card; 64 registers a thread at most, so
# that every kernel launches with up to 1024 threads (one per lane)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-maxrregcount=64", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # scal win xf yf basef widthf fwd | G R W ND NDp X C Y | stream
    "wavefront_fwd": [_P] * 7 + [_I] * 8 + [_P],
    # scal win xf yf basef widthf seedf raggedf fwd posts totals | ... | stream
    "wavefront_bwd": [_P] * 11 + [_I] * 8 + [_P],
    # ... posts totals trans acc | ... | stream
    "wavefront_bwd_exp": [_P] * 13 + [_I] * 8 + [_P],
    # scal win xf yf basef widthf fwd shifts | G R W ND NDp X C Y TD | stream
    "wavefront_fwd_tiled": [_P] * 8 + [_I] * 9 + [_P],
    # ... raggedf fwd shifts posts totals | ... TD | stream
    "wavefront_bwd_tiled": [_P] * 12 + [_I] * 9 + [_P],
}
# the dna5, vanilla and sm4 instances take their strawman counterparts'
# arguments
_SIGNATURES.update({f"{name}{suffix}": _SIGNATURES[name]
                    for suffix in ("_dna5", "_vanilla", "_sm4") for name in (
                        "wavefront_fwd", "wavefront_bwd",
                        "wavefront_bwd_exp", "wavefront_fwd_tiled",
                        "wavefront_bwd_tiled")})
# hdp (streamed): K1, K2 and K3, each with the stream est after the
# features (K1) or after the fwd plane (K2, K3); echelon: K1 and K2 only,
# each with the emission pre-pass's plane in the same place
_SIGNATURES.update({f"{name}{suffix}": [_P] + _SIGNATURES[name]
                    for suffix, names in (
                        ("_hdp", ("wavefront_fwd", "wavefront_bwd",
                                  "wavefront_bwd_exp")),
                        ("_echelon", ("wavefront_fwd", "wavefront_bwd")))
                    for name in names})
# the echelon emission pre-pass: win xf yf em | G R W ND NDp X C Y k |
# stream
_SIGNATURES["wavefront_emissions_echelon"] = [_P] * 4 + [_I] * 9 + [_P]


class _Library:
    """The loaded kernel library plus what its build reported."""

    lib = None
    path = None
    build_seconds = None   # None when the library was already built
    build_log = ""         # the output of the nvcc run that built it


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels build on first use and need the CUDA toolkit")


def _digest():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _built():
    """(library path, build seconds or None, nvcc/ptxas output): nvcc runs
    when the library or its stored output is missing; a cached library
    comes with the output of the nvcc run that built it (``<lib>.log``,
    written before the library, so a library never lacks it)."""
    path = BUILD_DIR / f"libcpecan_wavefront_{_digest()}.so"
    log = path.with_suffix(".log")
    if path.exists() and log.exists():
        return path, None, log.read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / "wavefront.cu")]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    seconds = time.perf_counter() - t0
    tmp_log = log.with_suffix(f".{os.getpid()}.logtmp")
    tmp_log.write_text(res.stdout + res.stderr)
    os.replace(tmp_log, log)
    os.replace(tmp, path)
    return path, seconds, res.stdout + res.stderr


def load_library():
    """The ctypes handle of the kernel library, built on first call."""
    if _Library.lib is not None:
        return _Library.lib
    path, _Library.build_seconds, _Library.build_log = _built()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.wavefront_error_string.argtypes = [ctypes.c_int]
    lib.wavefront_error_string.restype = ctypes.c_char_p
    _Library.lib, _Library.path = lib, path
    return lib


def build_info():
    """(library path, build seconds or None, nvcc/ptxas output)."""
    return _Library.path, _Library.build_seconds, _Library.build_log
