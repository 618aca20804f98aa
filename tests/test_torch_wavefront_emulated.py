"""``cpecan_tpu_torch/csrc/wavefront.cu`` itself, compiled for the CPU with
g++ against the stand-in ``tests/cuda_emulation/cuda_runtime.h`` (one
fiber per CUDA thread taking turns on the calling thread, a barrier per
``__syncthreads``, cp.async copies done as late as the hardware may do
them): the select instances that
replaced an older kernel against that kernel, both in the same library,
bit for bit, and against the plain PyTorch versions within
``EMULATED_RTOL``, on small synthetic inputs whose windows move (W 32 and
64, ND up to 300).

- ``sm3_fwd_tiled_sel<Vanilla, 0>`` (K1 vanilla, entry
  ``wavefront_fwd_vanilla``) against ``sm3_fwd_kernel<Vanilla>``;
- ``sm3_fwd_tiled_sel<Strawman, 0>`` and ``sm3_fwd_tiled_sel<Dna5, 0>`` (K1
  strawman and K1 dna5, entries ``wavefront_fwd`` and
  ``wavefront_fwd_dna5``) against ``sm3_fwd_kernel<Strawman>`` and
  ``sm3_fwd_kernel<Dna5>``;
- ``sm3_fwd_tiled_sel<Sm4, 0>`` and ``sm3_bwd_tiled_sel<Sm4, 0, 0>`` (K1
  and K2 sm4, entries ``wavefront_fwd_sm4`` and ``wavefront_bwd_sm4``)
  against ``sm3_fwd_kernel<Sm4>`` and ``sm3_bwd_kernel<Sm4, 0>``, K2 on the
  same fwd plane;
- ``sm3_bwd_tiled_sel<Hdp, 0, 0>`` (K2 hdp, entry ``wavefront_bwd_hdp``:
  the streamed posterior form) against ``sm3_bwd_kernel<Hdp, 0>``, on
  bands that cover the windows' edges too.

The old forms stay in the source for the instances that still run them;
this translation unit instantiates them for the redesigned specs itself
(``OLD_ENTRIES``).  Needs g++ (skips without it); the library is built
once into ``build/emulated/`` (~30 s) and reused while the sources stay
the same.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from cpecan_tpu_torch.ops import cuda_build
from cpecan_tpu_torch.ops import fb_kernels as fk
from torch_cases import synthetic_case

REPO = Path(__file__).resolve().parents[1]
SHIM = Path(__file__).resolve().parent / "cuda_emulation"
BUILD_DIR = REPO / "build" / "emulated"
GXX_FLAGS = ("-std=c++17", "-pedantic", "-O2", "-ffp-contract=off",
             "-fPIC", "-shared", "-pthread")
# the kernels' float operations are the plain versions', in the same order,
# but glibc's logf/expf and PyTorch's CPU log/exp round a few values an ulp
# apart, and the recurrences carry such an ulp on: a relative tolerance on
# the fwd plane's finite entries and the totals, an absolute one on the
# posteriors (each in [0, 2))
EMULATED_RTOL = 1e-5
EMULATED_POST_ATOL = 1e-5

# the older kernels of the redesigned instances, with their entry points'
# C signatures
OLD_ENTRIES = r"""
extern "C" {
int emu_old_wavefront_fwd(
        const void* scal, const void* win, const void* xf, const void* yf,
        const void* basef, const void* widthf, void* fwd, int G, int R,
        int W, int ND, int NDp, int X, int C, int Y, void* stream) {
    return launch_fwd<Strawman>(scal, win, xf, yf, basef, widthf, nullptr,
                                fwd, G, R, W, ND, NDp, X, C, Y, stream);
}
int emu_old_wavefront_fwd_dna5(
        const void* scal, const void* win, const void* xf, const void* yf,
        const void* basef, const void* widthf, void* fwd, int G, int R,
        int W, int ND, int NDp, int X, int C, int Y, void* stream) {
    return launch_fwd<Dna5>(scal, win, xf, yf, basef, widthf, nullptr, fwd,
                            G, R, W, ND, NDp, X, C, Y, stream);
}
int emu_old_wavefront_fwd_vanilla(
        const void* scal, const void* win, const void* xf, const void* yf,
        const void* basef, const void* widthf, void* fwd, int G, int R,
        int W, int ND, int NDp, int X, int C, int Y, void* stream) {
    return launch_fwd<Vanilla>(scal, win, xf, yf, basef, widthf, nullptr,
                               fwd, G, R, W, ND, NDp, X, C, Y, stream);
}
int emu_old_wavefront_fwd_sm4(
        const void* scal, const void* win, const void* xf, const void* yf,
        const void* basef, const void* widthf, void* fwd, int G, int R,
        int W, int ND, int NDp, int X, int C, int Y, void* stream) {
    return launch_fwd<Sm4>(scal, win, xf, yf, basef, widthf, nullptr, fwd,
                           G, R, W, ND, NDp, X, C, Y, stream);
}
int emu_old_wavefront_bwd_sm4(
        const void* scal, const void* win, const void* xf, const void* yf,
        const void* basef, const void* widthf, const void* seedf,
        const void* raggedf, const void* fwd, void* posts, void* totals,
        int G, int R, int W, int ND, int NDp, int X, int C, int Y,
        void* stream) {
    return launch_bwd<Sm4, false>(scal, win, xf, yf, basef, widthf, seedf,
                                  raggedf, fwd, nullptr, posts, totals,
                                  nullptr, nullptr, G, R, W, ND, NDp, X, C,
                                  Y, stream);
}
int emu_old_wavefront_bwd_hdp(
        const void* scal, const void* win, const void* xf, const void* yf,
        const void* basef, const void* widthf, const void* seedf,
        const void* raggedf, const void* fwd, const void* est, void* posts,
        void* totals, int G, int R, int W, int ND, int NDp, int X, int C,
        int Y, void* stream) {
    return launch_bwd<Hdp, false>(scal, win, xf, yf, basef, widthf, seedf,
                                  raggedf, fwd, est, posts, totals, nullptr,
                                  nullptr, G, R, W, ND, NDp, X, C, Y,
                                  stream);
}
}
"""


def _replace_body(text, header, body):
    """``text`` with the braces that follow the function header ``header``
    (a regex) replaced by ``body``."""
    m = re.search(header, text)
    assert m, header
    start = text.index("{", m.end())
    depth, i = 0, start
    while True:
        depth += {"{": 1, "}": -1}.get(text[i], 0)
        if depth == 0:
            break
        i += 1
    return text[:start] + body + text[i + 1:]


def _matching(text, start):
    """The index of the parenthesis closing the one at ``start``."""
    depth = 0
    for i in range(start, len(text)):
        depth += {"(": 1, ")": -1}.get(text[i], 0)
        if depth == 0:
            return i
    raise AssertionError("unbalanced parentheses")


def _top_level_args(s):
    """``s`` split at its commas outside parentheses."""
    out, depth, cur = [], 0, ""
    for ch in s:
        depth += {"(": 1, ")": -1}.get(ch, 0)
        if ch == "," and depth == 0:
            out.append(cur.strip())
            cur = ""
        else:
            cur += ch
    return out + [cur.strip()]


def emulated_source(src):
    """``wavefront.cu``'s text rewritten for the stand-in runtime: dynamic
    shared memory from the block's buffer, the cp.async and prefetch
    helpers as the emulated copies and no-ops, each ``kernel<<<grid,
    block, smem, stream>>>(args);`` as ``emu_launch(grid, block, smem,
    [&] { kernel(args); });``."""
    src = re.sub(r"extern __shared__ float (\w+)\[\];",
                 r"float* \1 = emu_shared();", src)
    for header, body in (
            (r"void cp_async4\(float\* dst, const float\* src\)",
             "{ emu_cp_async4(dst, src); }"),
            (r"void cp_async_commit\(\)", "{ emu_cp_async_commit(); }"),
            (r"void cp_async_wait\(\)", "{ emu_cp_async_wait(N); }"),
            (r"void prefetch_l1\(const void\* p\)", "{ (void)p; }")):
        src = _replace_body(src, header, body)
    launch = re.compile(r"(sm3_\w+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\(", re.S)
    while (m := launch.search(src)):
        close = _matching(src, m.end() - 1)
        assert src[close + 1] == ";"
        grid, block, smem = _top_level_args(m.group(2))[:3]
        call = (f"emu_launch({grid}, {block}, {smem}, [&] {{ {m.group(1)}("
                f"{src[m.end():close]}); }})")
        src = src[:m.start()] + call + src[close + 1:]
    assert "<<<" not in src and "asm volatile" not in src
    return src + OLD_ENTRIES


def build_emulated(csrc, out_dir):
    """Compile ``csrc``/wavefront.cu through ``emulated_source`` into a
    library under ``out_dir`` named by a hash of the sources, the shim and
    the flags (reused if present); returns its path."""
    gxx = shutil.which("g++")
    src = emulated_source((Path(csrc) / "wavefront.cu").read_text())
    h = hashlib.sha256(src.encode() + " ".join(GXX_FLAGS).encode())
    for p in (Path(csrc) / "logspace.cuh", SHIM / "cuda_runtime.h"):
        h.update(p.read_bytes())
    lib = Path(out_dir) / f"wavefront_emulated_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    cpp = lib.with_suffix(f".{os.getpid()}.cpp")
    cpp.write_text(src)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([gxx, *GXX_FLAGS, "-x", "c++", "-I", str(SHIM),
                          "-I", str(csrc), "-o", str(tmp), str(cpp)],
                         capture_output=True, text=True)
    cpp.unlink()
    if res.returncode:
        raise RuntimeError(f"g++ failed:\n{res.stdout}{res.stderr}")
    os.replace(tmp, lib)
    return lib


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile csrc/wavefront.cu for the CPU")
    handle = ctypes.CDLL(str(build_emulated(cuda_build.CSRC, BUILD_DIR)))
    names = dict(cuda_build._SIGNATURES)
    names.update({f"emu_old_{n}": cuda_build._SIGNATURES[n]
                  for n in ("wavefront_fwd", "wavefront_fwd_dna5",
                            "wavefront_fwd_vanilla", "wavefront_fwd_sm4",
                            "wavefront_bwd_sm4", "wavefront_bwd_hdp")})
    for name, argtypes in names.items():
        getattr(handle, name).argtypes = argtypes
        getattr(handle, name).restype = ctypes.c_int
    return handle


def _launch(lib, entry, tensors, outs, dims):
    """Call ``entry`` of the emulated library on CPU tensors as the
    wrappers call it on the card: the inputs, a streamed spec's ``est``,
    the outputs, then G R W ND NDp X C Y and a null stream."""
    win, xf, yf = tensors[1:4]
    G, NDp = win.shape
    if "est" in dims:
        tensors = tensors + [dims["est"]]
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in tensors + outs]
    code = getattr(lib, entry)(*ptrs, G, dims["R"], dims["W"], dims["ND"],
                               NDp, xf.shape[2], dims["C"], yf.shape[2],
                               None)
    assert code == 0, entry
    return outs


def _fwd(lib, entry, fa, dims):
    G, S = fa[1].shape[0], dims["spec"].S
    out = torch.empty((G, dims["ND"] + 1, S, dims["R"], dims["W"]))
    return _launch(lib, entry, fa, [out], dims)[0]


def _bwd(lib, entry, ba, fwd, dims):
    G = ba[1].shape[0]
    outs = [torch.empty((G, dims["ND"] + 1, dims["R"], dims["W"])),
            torch.empty((G, dims["R"]))]
    return _launch(lib, entry, ba + [fwd], outs, dims)


def _close(got, want, rtol, atol=0.0):
    """The same NEG cells, the rest within ``rtol`` and ``atol``; returns
    the largest difference."""
    assert torch.equal(got <= -1e29, want <= -1e29)
    assert torch.allclose(got, want, rtol=rtol, atol=atol)
    return float((got - want).abs().max())


CASES = [(32, 2, False), (32, 5, False), (32, 150, True), (64, 300, True),
         (64, 257, False)]


def _check_k1(lib, spec, seed, W, ND, every, ragged):
    """The untiled select forward of ``spec`` (entry ``wavefront_fwd`` +
    its suffix) against its old kernel (``emu_old_`` + that entry) bit for
    bit, and against the plain version within ``EMULATED_RTOL``, on
    ``synthetic_case`` at ``seed``."""
    fa, _, dims = synthetic_case("cpu", spec, W, ND, ragged,
                                 [seed, W, ND, int(ragged)], every=every)
    entry = "wavefront_fwd" + spec.SUFFIX
    new = _fwd(lib, entry, fa, dims)
    old = _fwd(lib, "emu_old_" + entry, fa, dims)
    assert torch.equal(new, old)
    _close(new, fk.forward_plain(*fa, **dims), EMULATED_RTOL)
    assert torch.isfinite(new).all() and (new > -1e29).any()


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("W, ND, every", CASES)
def test_k1_vanilla_select_form_equals_the_old_kernel(lib, W, ND, every,
                                                      ragged):
    """K1 vanilla's ``sm3_fwd_tiled_sel<Vanilla, 0>`` (the untiled select
    forward: no emission plane, the column logs kept while the window
    stays, the scalars in shared memory, every x row read at x) gives
    ``sm3_fwd_kernel<Vanilla>``'s fwd plane bit for bit, and the plain
    version's within ``EMULATED_RTOL``."""
    _check_k1(lib, fk.VanillaSpec, 17, W, ND, every, ragged)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("W, ND, every", CASES)
@pytest.mark.parametrize("spec, seed", [(fk.StrawmanSpec, 23),
                                        (fk.Dna5Spec, 29)],
                         ids=["strawman", "dna5"])
def test_k1_strawman_and_dna5_select_forms_equal_the_old_kernels(
        lib, spec, seed, W, ND, every, ragged):
    """K1 strawman's ``sm3_fwd_tiled_sel<Strawman, 0>`` (the column logs
    of diagonal 0's window, taken again only where the window moves; the
    four Gaussians as ``gauss_sel``; the scalars in shared memory; the five
    log-adds as ``log_add_sel``) and K1 dna5's ``sm3_fwd_tiled_sel<Dna5,
    0>`` (the select emissions on y bases that include N and values outside
    0..4, the eight log-adds as ``log_add_sel``, the scalars in registers)
    give ``sm3_fwd_kernel<Strawman>``'s and ``sm3_fwd_kernel<Dna5>``'s fwd
    planes bit for bit, and the plain versions' within
    ``EMULATED_RTOL``."""
    _check_k1(lib, spec, seed, W, ND, every, ragged)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("W, ND, every", CASES)
def test_k1_sm4_select_form_equals_the_old_kernel(lib, W, ND, every, ragged):
    """K1 sm4's ``sm3_fwd_tiled_sel<Sm4, 0>`` (the strawman's column logs,
    taken again only where the window moves, and ``gauss_sel`` on Gaussian
    rows with a few sd <= 0; the 23 scalars in shared memory; the seven
    log-adds of ``Sm4::fwd_update_with`` as ``log_add_sel``) gives
    ``sm3_fwd_kernel<Sm4>``'s fwd plane bit for bit, and the plain
    version's within ``EMULATED_RTOL``."""
    _check_k1(lib, fk.Sm4Spec, 31, W, ND, every, ragged)


def _check_k2(lib, spec, seed, W, ND, every, ragged, edge=False):
    """The untiled select posterior form of ``spec`` (entry
    ``wavefront_bwd`` + its suffix) against its old kernel (``emu_old_`` +
    that entry) bit for bit on the same fwd plane (that of the spec's K1
    entry), and against the plain version within ``EMULATED_POST_ATOL`` and
    ``EMULATED_RTOL``, on ``synthetic_case`` at ``seed``."""
    _, ba, dims = synthetic_case("cpu", spec, W, ND, ragged,
                                 [seed, W, ND, int(ragged)], every=every,
                                 edge=edge)
    fwd = _fwd(lib, "wavefront_fwd" + spec.SUFFIX, ba[:6], dims)
    _close(fwd, fk.forward_plain(*ba[:6], **dims), EMULATED_RTOL)
    entry = "wavefront_bwd" + spec.SUFFIX
    posts, totals = _bwd(lib, entry, ba, fwd, dims)
    oposts, ototals = _bwd(lib, "emu_old_" + entry, ba, fwd, dims)
    assert torch.equal(posts, oposts) and torch.equal(totals, ototals)
    pposts, ptotals = fk.backward_plain(*ba, fwd, **dims)
    _close(posts, pposts, 0.0, EMULATED_POST_ATOL)
    _close(totals, ptotals, EMULATED_RTOL)
    assert torch.all(posts[:, 0] == 0.0) and torch.isfinite(totals).all()
    assert (posts > 0.0).any() or ND == 2


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("W, ND, every", CASES)
def test_k2_sm4_select_form_equals_the_old_kernel(lib, W, ND, every, ragged):
    """K2 sm4's ``sm3_bwd_tiled_sel<Sm4, 0, 0>`` (the untiled select
    posterior form: the strawman's emissions from the kept column logs, the
    carried match and gap-Y terms through the em ring, the seven log-adds
    of ``Sm4::bwd_update_with`` as ``log_add_sel``) gives
    ``sm3_bwd_kernel<Sm4, 0>``'s posteriors and totals bit for bit on the
    same fwd plane, and the plain version's within ``EMULATED_POST_ATOL``
    and ``EMULATED_RTOL``."""
    _check_k2(lib, fk.Sm4Spec, 37, W, ND, every, ragged)


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("W, ND, every", CASES)
def test_k2_hdp_select_form_equals_the_old_kernel(lib, W, ND, every, ragged,
                                                  edge):
    """K2 hdp's ``sm3_bwd_tiled_sel<Hdp, 0, 0>`` (the untiled select
    posterior form reading the stream: est[d + 1] across lanes, the
    carried est[d + 2] through the em ring, the gap-X row alone) gives
    ``sm3_bwd_kernel<Hdp, 0>``'s posteriors and totals bit for bit on the
    same fwd plane, and the plain version's within ``EMULATED_POST_ATOL``
    and ``EMULATED_RTOL``.  With ``edge`` the bands cover the windows'
    edge lanes, where the carry's two guards (lanes l + o1 + 1 and l + o2 +
    1) part."""
    _check_k2(lib, fk.HdpSpec, 19, W, ND, every, ragged, edge)
