"""On-device band construction from compact anchor chains (counterpart of
``StrawmanPallasAligner._device_bands``, ``pallas_fb.py:1709-1776``).

The vectorized band_construct (``cpecan_tpu/ops/band.py``,
impl/pairwiseAligner.c:131-184) as segment-lookup tensor math: diagonal
d's corners come from the first waypoint segment with nxay >= d, then the
parity fix and the four coordinate bounds apply as arithmetic.  The result
equals the host ``make_band`` bit for bit.
"""

import torch


def _fdiv2(v):
    return torch.div(v, 2, rounding_mode="floor")


def _clip(v, hi):
    return torch.minimum(torch.clamp(v, min=0), hi)


def device_bands(anch, meta, NDp, expansion):
    """f32 (basef, widthf, seedf, raggedf), each [B, NDp].

    ``anch`` [B, A, 2] integer anchor chains (x, y) in sequence
    coordinates, -1 padded; ``meta`` [B, 4] = (l_x, l_y, n_diag, ragged)."""
    a = anch.to(torch.int64)
    m = meta.to(torch.int64)
    dev = a.device
    l_x, l_y, n, ragged = (m[:, i:i + 1] for i in range(4))
    valid = a[..., 0] >= 0
    # matrix coords are sequence coords + 1; padded slots collapse onto the
    # terminal corner (degenerate zero-length segments)
    ax = torch.where(valid, a[..., 0] + 1, l_x)
    ay = torch.where(valid, a[..., 1] + 1, l_y)
    zero = torch.zeros_like(l_x)
    wx = torch.cat([zero, ax, l_x], dim=1)
    wy = torch.cat([zero, ay, l_y], dim=1)
    pxay = wx[:, :-1] + wy[:, :-1]
    pxmy = wx[:, :-1] - wy[:, :-1]
    nxay = wx[:, 1:] + wy[:, 1:]
    nxmy = wx[:, 1:] - wy[:, 1:]
    seg_x_l = _clip(_fdiv2(pxay + (pxmy - expansion)), l_x)
    seg_y_l = _clip(_fdiv2(nxay - (nxmy - expansion)), l_y)
    seg_x_u = _clip(_fdiv2(nxay + (nxmy + expansion)), l_x)
    seg_y_u = _clip(_fdiv2(pxay - (pxmy + expansion)), l_y)
    d = torch.arange(NDp, dtype=torch.int64, device=dev)
    dd = d.expand(a.shape[0], NDp).contiguous()
    # first segment with nxay >= d (nxay is non-decreasing along a chain)
    k = torch.searchsorted(nxay.contiguous(), dd, side="left").clamp(
        max=nxay.shape[1] - 1)
    nz = dd > 0

    def seg(v):
        return torch.where(nz, torch.gather(v, 1, k), 0)

    x_l, y_l, x_u, y_u = (seg(v) for v in (seg_x_l, seg_y_l, seg_x_u,
                                           seg_y_u))
    xmy_l = x_l - y_l
    xmy_r = x_u - y_u
    xmy_l = torch.where((dd + xmy_l) % 2 != 0, xmy_l + 1, xmy_l)
    xmy_r = torch.where((dd + xmy_r) % 2 != 0, xmy_r + 1, xmy_r)
    xmy_l = xmy_l + 2 * torch.clamp(x_l - _fdiv2(dd + xmy_l), min=0)
    xmy_l = xmy_l + 2 * torch.clamp(_fdiv2(dd - xmy_l) - y_l, min=0)
    xmy_r = xmy_r - 2 * torch.clamp(_fdiv2(dd + xmy_r) - x_u, min=0)
    xmy_r = xmy_r - 2 * torch.clamp(y_u - _fdiv2(dd - xmy_r), min=0)
    x_lo = _fdiv2(dd + xmy_l)
    width = _fdiv2(xmy_r - xmy_l) + 1
    in_range = dd <= n
    basef = torch.where(in_range, x_lo, 0).to(torch.float32)
    widthf = torch.where(in_range, width, 0).to(torch.float32)
    seedf = (dd == n).to(torch.float32)
    raggedf = seedf * (ragged > 0)
    return basef, widthf, seedf, raggedf
