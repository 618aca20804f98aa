"""PyTorch port vs the JAX package: machine, synthetic reads, features,
device bands, host prep, guards and the jax-free import (CPU, no kernel
runs).  Inputs are made with numpy and handed to both packages."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpecan_tpu.align import AlignmentParams
from cpecan_tpu.models.state_machines import StateMachine3SignalStrawman
from cpecan_tpu.ops.band import make_band
from cpecan_tpu.ops.pallas_fb import StrawmanPallasAligner

from cpecan_tpu_torch.align import AlignmentParams as TorchParams
from cpecan_tpu_torch.models.state_machines import machine_from_jax
from cpecan_tpu_torch.ops import fb as tfb
from cpecan_tpu_torch.ops.device_bands import device_bands
from cpecan_tpu_torch.ops.fb import StrawmanAligner
from tests.torch_parity import fixture_reads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def reads(template_model):
    return fixture_reads(template_model)


@pytest.fixture(scope="module")
def machines(template_model):
    rng = np.random.default_rng(11)
    gapx = np.log(rng.uniform(0.05, 0.2, 4096))
    gapx[::97] = -np.inf
    sm = StateMachine3SignalStrawman(template_model, gap_x_log_probs=gapx)
    return sm, machine_from_jax(sm)


@pytest.mark.parametrize("ragged_left", [False, True])
def test_machine_from_jax_is_bit_equal(machines, ragged_left):
    sm, tsm = machines
    pa = StrawmanPallasAligner(AlignmentParams(), interpret=True)
    want = pa._scalars(sm, ragged_left=ragged_left)
    got = tsm.scalars(ragged_left=ragged_left).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    for buf, table in zip((tsm.match_model, tsm.gap_y_model, tsm.gap_x),
                          pa._model_tables(sm)):
        np.testing.assert_array_equal(buf.numpy(), np.asarray(table))
    assert set(dict(tsm.named_buffers())) == {"match_model", "gap_y_model",
                                             "gap_x"}


def test_alignment_params_twin():
    assert TorchParams().__dict__ == AlignmentParams().__dict__


@pytest.mark.parametrize("kw", [
    dict(n_reads=3, n_ref=60, n_events=50, seed=7),
    dict(n_reads=4, n_ref=90, n_events=70, seed=3, shape_jitter=0.3),
])
def test_synthetic_batch_twin_is_byte_identical(kw):
    from __graft_entry__ import _synthetic_batch
    from cpecan_tpu_torch.synthetic import synthetic_batch

    sm, reads = _synthetic_batch(**kw)
    tsm, treads = synthetic_batch(**kw)
    assert len(reads) == len(treads)
    for (ref, ev, lx, ly, a), (tref, tev, tlx, tly, ta) in zip(reads,
                                                              treads):
        assert ref == tref and (lx, ly) == (tlx, tly) and a == ta
        assert ev.dtype == tev.dtype and ev.tobytes() == tev.tobytes()
    assert sm.model.match_model.tobytes() == tsm.model.match_model.tobytes()
    np.testing.assert_array_equal(
        tsm.scalars().numpy(),
        StrawmanPallasAligner(AlignmentParams())._scalars(sm))


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("scaled", [False, True])
def test_prepare_and_features_match_jax(machines, reads, scaled):
    """Host prep equal key for key; unscaled xf/yf exact, per-read scaled
    match rows within 1 ulp (XLA fuses the scaling differently)."""
    sm, tsm = machines
    sp = (np.random.default_rng(2).uniform(0.9, 1.1, (len(reads), 5))
          if scaled else None)
    pa = StrawmanPallasAligner(AlignmentParams(), interpret=True)
    ta = StrawmanAligner(TorchParams(), device="cpu", group=8)
    prep = pa.prepare(sm, reads, scale_params=sp)
    tprep = ta.prepare(tsm, reads, scale_params=sp)
    assert set(prep) == set(tprep)
    for key, want in prep.items():
        got = tprep[key]
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype, key
            np.testing.assert_array_equal(got, want, err_msg=key)
        elif key == "bands":
            for gb, wb in zip(got, want):
                np.testing.assert_array_equal(gb.x_lo, wb.x_lo)
                np.testing.assert_array_equal(gb.width, wb.width)
        else:
            assert got == want, key
    xf, yf = pa._device_features(sm, prep)
    inp = ta.device_inputs(tsm, tprep)
    np.testing.assert_array_equal(inp["yf"].numpy(), np.asarray(yf))
    if scaled:
        assert _ulps(inp["xf"].numpy(), xf).max() <= 1
    else:
        np.testing.assert_array_equal(inp["xf"].numpy(), np.asarray(xf))


def test_device_bands_match_host():
    """Mirror of test_device_band_construction_matches_host: the torch
    band rebuild equals the host band_construct bit for bit."""
    rng = np.random.default_rng(3)
    rows = []
    for i in range(6):
        l_x = int(rng.integers(20, 200))
        l_y = int(rng.integers(20, 200))
        n_anchor = int(rng.integers(0, 8))
        xs = np.sort(rng.choice(np.arange(1, l_x - 1),
                                size=min(n_anchor, l_x - 2),
                                replace=False)) if n_anchor else []
        anchors = []
        py = 0
        for x in xs:
            y = py + 1 + int(rng.integers(0, max((l_y - 1 - py) // 4, 1)))
            if y >= l_y:
                break
            anchors.append((int(x), y))
            py = y
        rows.append((l_x, l_y, anchors))
    NDp = 512
    A_max = max(1, max(len(a) for _, _, a in rows))
    anch = np.full((len(rows), A_max, 2), -1, np.int16)
    meta = np.zeros((len(rows), 4), np.int32)
    bands = []
    for r, (l_x, l_y, a) in enumerate(rows):
        band = make_band(a, l_x, l_y, 20)
        bands.append(band)
        if a:
            anch[r, : len(a)] = np.asarray(a, np.int64)
        meta[r] = (l_x, l_y, band.n_diag, r % 2)
    basef, widthf, seedf, raggedf = device_bands(
        torch.from_numpy(anch), torch.from_numpy(meta), NDp, 20)
    pa = StrawmanPallasAligner(AlignmentParams(diagonal_expansion=20),
                               interpret=True)
    jb = pa._device_bands(NDp, A_max)(jnp.asarray(anch), jnp.asarray(meta))
    for got, want in zip((basef, widthf, seedf, raggedf), jb):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for r, band in enumerate(bands):
        n = band.n_diag
        want_base = np.zeros(NDp)
        want_width = np.zeros(NDp)
        want_base[: n + 1] = band.x_lo
        want_width[: n + 1] = band.width
        np.testing.assert_array_equal(basef[r].numpy(), want_base)
        np.testing.assert_array_equal(widthf[r].numpy(), want_width)
        assert seedf[r].numpy().nonzero()[0].tolist() == [n]
        assert (raggedf[r].numpy().sum() > 0) == bool(r % 2)


def test_routing_and_plane_guards_raise(machines, reads, monkeypatch):
    """Batches the JAX aligner routes to its tiled path (2^14 estimated
    diagonals, 2^15 columns, a shape hint past them, or ``tile_diag``) go
    to the port's tiled path; expectation runs there and mesh runs raise;
    the plane guard sizes from the device."""
    _, tsm = machines
    ta = StrawmanAligner(TorchParams(), device="cpu", group=8)
    routed = []
    monkeypatch.setattr(StrawmanAligner, "_run_tiled",
                        lambda self, sm, reads, **kw: routed.append(kw))
    long_read = ("A" * 505, np.zeros((17000, 3)), 500, 17000,
                 [(100, 3400), (400, 13600)])
    ta.run(tsm, [long_read])
    wide = ("A" * 32775, np.zeros((10, 3)), 32770, 10, [])
    ta.run(tsm, [wide])
    ta.run(tsm, reads, shape_hint=(100, 2 ** 14))
    ta.run(tsm, reads, tile_diag=256)
    assert [kw["tile_diag"] for kw in routed] == [2048, 2048, 2048, 256]
    assert routed[2]["shape_hint"] == (100, 2 ** 14)
    # expectation runs have no tiled variant: past the wall, or with a
    # tile, they are refused with the split named
    for kw in (dict(), dict(tile_diag=256)):
        with pytest.raises(NotImplementedError, match="get_split_points"):
            ta.run(tsm, [long_read], expectations=True, **kw)
    with pytest.raises(NotImplementedError, match="get_split_points"):
        ta.run(tsm, reads, expectations=True, tile_diag=256)
    for kw in (dict(), dict(tile_diag=256)):
        with pytest.raises(NotImplementedError, match="item 9"):
            ta.run(tsm, reads, mesh=object(), **kw)
    assert len(routed) == 4
    monkeypatch.setattr(tfb, "device_memory_bytes", lambda device: 1e6)
    with pytest.raises(ValueError, match="smaller chunks"):
        ta.run(tsm, reads)


def test_cuda_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        StrawmanAligner(device="cuda")


def test_wrappers_take_plain_path_only_on_cpu():
    """A tensor that is on neither the CPU nor a CUDA device gets no
    fallback."""
    from cpecan_tpu_torch.ops.fb_kernels import wavefront_bwd, wavefront_fwd
    meta = torch.empty((8, 9, 128), device="meta")
    with pytest.raises(ValueError, match="no wavefront kernel"):
        wavefront_fwd(None, None, meta, None, None, None, R=8, W=128, ND=4,
                      C=7)
    with pytest.raises(ValueError, match="no wavefront kernel"):
        wavefront_bwd(None, None, meta, None, None, None, None, None, None,
                      R=8, W=128, ND=4, C=7)


def test_port_imports_without_jax():
    """Every cpecan_tpu_torch module imports with jax blocked (the GPU
    machine has no JAX)."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import cpecan_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "cpecan_tpu_torch.__path__, 'cpecan_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert 'jax' not in {m.split('.')[0] for m, v in "
        "sys.modules.items() if v is not None}\n"
        "print(len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 9
