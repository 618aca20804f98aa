"""Host-side native code of the port: the posterior-tsv block formatter
(``tsv_format.cc``, a copy of ``cpecan_tpu/native/tsv_format.cc``).

A source builds with ``g++`` at its first use into ``build/native/`` at the
repository root (gitignored), named by a hash of the source and flags, and
loads with ``ctypes``.  Callers build it once, before any thread uses it;
where no C++ toolchain is present ``load_library`` returns None and says
why, and the caller's Python path runs instead (identical output).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_LOADED = {}


def load_library(name):
    """(ctypes handle of ``<name>.cc``'s library or None, what happened:
    the library's path, or why it did not build)."""
    with _LOCK:
        if name not in _LOADED:
            _LOADED[name] = _build_and_load(name)
        return _LOADED[name]


def _build_and_load(name):
    src = SRC_DIR / f"{name}.cc"
    h = hashlib.sha256(" ".join(FLAGS).encode() + src.read_bytes())
    path = BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"
    if not path.exists():
        gxx = shutil.which("g++")
        if gxx is None:
            return None, "no g++ on PATH"
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([gxx, *FLAGS, str(src), "-o", str(tmp)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            return None, f"g++ failed ({res.returncode}): {res.stderr[-500:]}"
        os.replace(tmp, path)
    try:
        return ctypes.CDLL(str(path)), str(path)
    except OSError as exc:
        return None, f"could not load {path}: {exc}"
