"""Fused voxelize + patch-embed over host-built placement chunks
(CUDA kernel ``csrc/voxel_embed.cu``), the dense BEV fill from the same
chunks (CUDA kernel ``csrc/voxel_fill.cu``), and the chunk transport.

Counterpart of ``intentbev/ops/voxel_embed.py``. The host half builds,
stacks, packs and decodes the chunk transport; the device half turns
chunks into patch-embed tokens, equal to conv8x8,s8(voxelize(points)) +
bias, without a dense BEV (the ViT), or into the dense BEV itself (the CNN
family and the chunk train transport).

Chunk format (one sample's BEV is cut into bands of ``rows_per_program``
patch rows; a band's pixels into 64-pixel row-major windows; a window's
occupied cells, one per (pixel, channel) with the per-cell max intensity,
into chunks of up to 64 cells): ``wid`` is a chunk's window within its
band, ``sl`` a cell's pixel within the window, ``ch`` its channel, ``val``
its value, ``count`` the number of real chunks per band.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ._build import check_launch, kernels, require, stream_ptr
from .layernorm import WIDTHS

WINDOW = 64  # pixels per placement window
CAP = 64     # max cells per chunk
ROWS_PER_PROGRAM = 5  # patch rows per band when they divide the grid
# Band geometry of the CNN family's chunks (it has no patch of its own; the
# chunk build and the fill only have to agree on one value)
CNN_CHUNK_PATCH = 8
FILL_SMEM_BYTES = 200 * 1024  # the fill kernel's [64, C] tile must fit a block


class VoxelChunks(NamedTuple):
    """Placement chunks for a batch (numpy on the host, tensors on device)."""

    wid: np.ndarray | torch.Tensor    # i32[B, NB, NC]
    sl: np.ndarray | torch.Tensor     # i32[B, NB, NC, 1, CAP] (u16 packed sl|ch)
    ch: np.ndarray | torch.Tensor     # i32[B, NB, NC, 1, CAP] (empty when packed)
    val: np.ndarray | torch.Tensor    # f32[B, NB, NC, 1, CAP] (u8 when integral)
    count: np.ndarray | torch.Tensor  # i32[B, NB]


def rows_per_program(grid_h: int, patch: int) -> int:
    """Patch rows per band (the banding rule of the JAX package)."""
    return ROWS_PER_PROGRAM if (grid_h // patch) % ROWS_PER_PROGRAM == 0 else 1


def build_voxel_chunks(points: np.ndarray, valid: np.ndarray, grid, patch: int,
                       num_chunks: int, *, on_overflow: str = "raise"
                       ) -> VoxelChunks:
    """One sample's points f32[S, P, 4] + valid bool[S, P] -> chunks with a
    leading batch dim of 1 and a fixed ``num_chunks`` per band (rounded up
    to a multiple of 8). ``on_overflow``: "raise", or "drop" (whole excess
    chunks of a band are dropped). Built by the C++ host library."""
    from ..utils.native import build_chunks_native

    if on_overflow not in ("raise", "drop"):
        raise ValueError(f"on_overflow {on_overflow!r} not in ('raise', 'drop')")
    h, w = grid.height_px, grid.width_px
    rows_band = rows_per_program(h, patch) * patch
    if h % rows_band or (rows_band * w) % WINDOW:
        raise ValueError(f"grid {h}x{w} does not band into {WINDOW}-pixel windows")
    nc = -(-int(num_chunks) // 8) * 8
    wid, sl, ch, val, count, needed = build_chunks_native(
        points, valid, grid, window=WINDOW, cap=CAP, nb=h // rows_band, nc=nc)
    if needed > nc and on_overflow == "raise":
        raise ValueError(f"band needs {needed} chunks > num_chunks={nc}; "
                         "raise num_chunks or pass on_overflow='drop'")
    return VoxelChunks(wid=wid[None], sl=sl[None], ch=ch[None], val=val[None],
                       count=count[None])


def stack_voxel_chunks(samples: list[VoxelChunks]) -> VoxelChunks:
    """Stack per-sample chunks (batch dim 1 each) into one batch, padding
    the chunk axis to the largest sample (zero chunks add nothing)."""
    nc = max(s.wid.shape[2] for s in samples)

    def cat(field):
        parts = []
        for s in samples:
            a = np.asarray(getattr(s, field))
            if field != "count":
                pad = [(0, 0)] * a.ndim
                pad[2] = (0, nc - a.shape[2])
                a = np.pad(a, pad)
            parts.append(a)
        return np.concatenate(parts)

    return VoxelChunks(*(cat(f) for f in VoxelChunks._fields))


def pack_chunk_transport(chunks: VoxelChunks) -> VoxelChunks:
    """Compact host encoding for the host-to-device copy (exact): ``sl`` and
    ``ch`` pack into one u16 per cell (slot in the low 6 bits, channel in
    the high 10; ``ch`` ships empty); ``val`` ships as u8 when every value
    is an integer in [0, 255] (LiDAR intensity is u8)."""
    sl, ch, val = (np.asarray(a) for a in (chunks.sl, chunks.ch, chunks.val))
    if int(ch.max(initial=0)) >= (1 << 10):
        raise ValueError(f"channel {int(ch.max())} does not fit the u16 packing (< 1024)")
    out = chunks._replace(
        wid=np.asarray(chunks.wid).astype(np.int32),
        sl=((ch.astype(np.uint16) << 6) | sl.astype(np.uint16)).astype(np.uint16),
        ch=np.zeros(ch.shape[:-1] + (0,), np.int16),
        count=np.asarray(chunks.count).astype(np.int32))
    if (val.size == 0 or (val.min(initial=0.0) >= 0.0
                          and val.max(initial=0.0) <= 255.0
                          and np.array_equal(val, np.rint(val)))):
        out = out._replace(val=val.astype(np.uint8))
    return out


def decode_chunk_transport(chunks: VoxelChunks) -> VoxelChunks:
    """Device-side inverse of :func:`pack_chunk_transport` (elementwise
    torch ops). Returns contiguous i32 wid/sl/ch/count and f32 val."""
    if chunks.ch.shape[-1] != 0:
        raise ValueError("decode_chunk_transport takes packed chunks (u16 slot|channel)")
    p = chunks.sl.to(torch.int32) & 0xFFFF  # u16 slot|channel, shipped as its i16 bits
    return VoxelChunks(
        wid=chunks.wid.to(torch.int32).contiguous(), sl=(p & 63).contiguous(),
        ch=(p >> 6).contiguous(), val=chunks.val.to(torch.float32).contiguous(),
        count=chunks.count.to(torch.int32).contiguous())


def chunks_to_device(chunks: VoxelChunks, device) -> VoxelChunks:
    """numpy chunk transport -> tensors on ``device`` (pinned, async copy
    when the device is a GPU). u16 arrays travel as their i16 bits, which
    :func:`decode_chunk_transport` reads back."""
    def move(a):
        a = np.ascontiguousarray(a)
        t = torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16 else a)
        if torch.device(device).type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    return VoxelChunks(*(move(a) for a in chunks))


def _geometry(chunks, kernel, patch, grid_hw):
    h, w = grid_hw
    b, nb, nc = chunks.wid.shape
    rpp = rows_per_program(h, patch)
    if nb * rpp * patch != h or w % patch or (rpp * patch * w) % WINDOW:
        raise ValueError(f"{nb} bands do not tile a {h}x{w} grid at patch {patch}")
    p0, p1, c, d = kernel.shape
    if (p0, p1) != (patch, patch):
        raise ValueError(f"kernel {tuple(kernel.shape)} is not [{patch}, {patch}, C, D]")
    return b, nb, nc, rpp, c, d


def _require_decoded(chunks: VoxelChunks, device, name: str) -> None:
    """The kernels' input contract: contiguous decoded chunks on ``device``."""
    b, nb, nc = chunks.wid.shape
    cells = (b, nb, nc, 1, CAP)
    for field, t, dt, shape in (
            ("wid", chunks.wid, torch.int32, (b, nb, nc)),
            ("sl", chunks.sl, torch.int32, cells), ("ch", chunks.ch, torch.int32, cells),
            ("val", chunks.val, torch.float32, cells),
            ("count", chunks.count, torch.int32, (b, nb))):
        require(t.device == device and t.dtype == dt
                and tuple(t.shape) == shape and t.is_contiguous(),
                f"{name}: {field} must be contiguous {dt} {shape} on {device}, "
                f"got {t.dtype} {tuple(t.shape)} {t.device}")


def _hit_cells(chunks: VoxelChunks, channels: int, patch: int, grid_hw):
    """The cells that add into a token, in chunk order, then cell order:
    (band index b * NB + band, band-local token, W row, value)."""
    h, w = grid_hw
    b, nb, nc = chunks.wid.shape
    rpp = rows_per_program(h, patch)
    gw = w // patch
    dev = chunks.wid.device
    cap = chunks.sl.shape[-1]
    real = (torch.arange(nc, device=dev)[None, None, :]
            < chunks.count[:, :, None])                        # [B, NB, NC]
    val = chunks.val.reshape(b, nb, nc, cap)
    ch = chunks.ch.reshape(b, nb, nc, cap).long()
    px = chunks.wid[..., None].long() * WINDOW + chunks.sl.reshape(b, nb, nc, cap).long()
    keep = real[..., None] & (val != 0) & (ch >= 0) & (ch < channels) \
        & (px >= 0) & (px < rpp * patch * w)
    bi, band, _, _ = torch.nonzero(keep, as_tuple=True)
    px, ch, val = px[keep], ch[keep], val[keep]
    rib, col = px // w, px % w
    tok = (rib // patch) * gw + col // patch
    wrow = ((rib % patch) * patch + col % patch) * channels + ch
    return bi * nb + band, tok, wrow, val


def voxel_embed_tokens_plain(chunks: VoxelChunks, kernel, bias, patch: int,
                             grid_hw: tuple[int, int]) -> torch.Tensor:
    """Plain PyTorch version over decoded chunks: gathers one kernel row per
    occupied cell and sums the rows into their tokens (index_add, f32).
    Cell values are rounded to the kernel's dtype first; cells whose channel
    is >= C, and zero-padded slots, add nothing."""
    b, nb, nc, rpp, c, d = _geometry(chunks, kernel, patch, grid_hw)
    h, w = grid_hw
    n_tok = (h // patch) * (w // patch)
    band, tok, wrow, val = _hit_cells(chunks, c, patch, grid_hw)
    wrows = kernel.reshape(-1, d)[wrow].float()
    vals = val.to(kernel.dtype).float()[:, None]
    out = bias.float().expand(b * n_tok, d).clone()
    out.index_add_(0, band * (rpp * (w // patch)) + tok, wrows * vals)
    return out.to(kernel.dtype).reshape(b, n_tok, d)


class VoxelHits(NamedTuple):
    """The token-ordered hit list of row 1's first kernel: per (batch, band),
    its occupied cells sorted by token (stable: chunk order, then cell
    order), ``offsets`` i32 [B, NB, T + 1] each band-local token's first
    position (T = rows_per_program * W/P tokens a band; ``offsets[..., T]``
    the band's total), ``wrow`` i32 [B, NB, NC * CAP] a hit's W row
    ((dy * P + dx) * C + ch) and ``val`` f32 [B, NB, NC * CAP] its value
    rounded to bf16. Entries past a band's total are zero in the plain
    version and unspecified from the kernel."""

    offsets: torch.Tensor
    wrow: torch.Tensor
    val: torch.Tensor


def voxel_hits_plain(chunks: VoxelChunks, channels: int, patch: int,
                     grid_hw: tuple[int, int]) -> VoxelHits:
    """Plain PyTorch version of row 1's first kernel over decoded chunks: a
    stable sort of each band's hits by token (values rounded to bf16)."""
    h, w = grid_hw
    b, nb, nc = chunks.wid.shape
    t_band = rows_per_program(h, patch) * (w // patch)
    n_slots = nc * chunks.sl.shape[-1]
    band, tok, wrow, val = _hit_cells(chunks, channels, patch, grid_hw)
    key = band * t_band + tok
    order = torch.sort(key, stable=True).indices
    per_tok = torch.bincount(key, minlength=b * nb * t_band).reshape(b * nb, t_band)
    offsets = torch.zeros(b * nb, t_band + 1, dtype=torch.int64, device=key.device)
    offsets[:, 1:] = per_tok.cumsum(1)
    band_s = band[order]
    first = torch.cat([torch.zeros(1, dtype=torch.int64, device=key.device),
                       offsets[:, -1].cumsum(0)[:-1]])        # band's first sorted hit
    pos = torch.arange(order.numel(), device=key.device) - first[band_s]
    wrow_out = torch.zeros(b * nb, n_slots, dtype=torch.int32, device=key.device)
    val_out = torch.zeros(b * nb, n_slots, dtype=torch.float32, device=key.device)
    wrow_out[band_s, pos] = wrow[order].to(torch.int32)
    val_out[band_s, pos] = val[order].to(torch.bfloat16).float()
    return VoxelHits(offsets.to(torch.int32).reshape(b, nb, t_band + 1),
                     wrow_out.reshape(b, nb, n_slots), val_out.reshape(b, nb, n_slots))


def _hit_scratch(chunks: VoxelChunks, t_band: int, device):
    """The kernels' hit list ([B, NB, NC * CAP, 2] i32) and offsets."""
    b, nb, nc = chunks.wid.shape
    return (torch.empty(b, nb, nc * CAP, 2, dtype=torch.int32, device=device),
            torch.empty(b, nb, t_band + 1, dtype=torch.int32, device=device))


def voxel_hits(chunks: VoxelChunks, channels: int, patch: int,
               grid_hw: tuple[int, int]) -> VoxelHits:
    """Row 1's first kernel alone (``voxel_hits_kernel``): the token-ordered
    hit list of decoded chunks, values rounded to bf16. A launch counts
    under ``voxel_hits``, not under ``voxel_embed``, whose launches each
    produce tokens. CPU tensors take :func:`voxel_hits_plain`."""
    if chunks.wid.device.type == "cpu":
        return voxel_hits_plain(chunks, channels, patch, grid_hw)
    h, w = grid_hw
    b, nb, nc, _ = _fill_geometry(chunks, grid_hw, patch)
    require(w % patch == 0, f"voxel_hits: width {w} not divisible by {patch}")
    _require_decoded(chunks, chunks.wid.device, "voxel_hits")
    rpp = rows_per_program(h, patch)
    t_band = rpp * (w // patch)
    hits, offsets = _hit_scratch(chunks, t_band, chunks.wid.device)
    err = kernels().ibk_voxel_hits(
        chunks.wid.data_ptr(), chunks.sl.data_ptr(), chunks.ch.data_ptr(),
        chunks.val.data_ptr(), chunks.count.data_ptr(), hits.data_ptr(), offsets.data_ptr(),
        b, nb, nc, channels, w, patch, rpp, stream_ptr(chunks.wid))
    check_launch(err, "voxel_hits")
    hits = hits.reshape(b, nb, nc * CAP, 2)
    return VoxelHits(offsets, hits[..., 0], hits[..., 1].view(torch.float32))


def voxel_embed_tokens(chunks: VoxelChunks, kernel, bias, patch: int,
                       grid_hw: tuple[int, int]) -> torch.Tensor:
    """Decoded chunks -> tokens [B, (H/P)*(W/P), D] in the kernel's dtype.
    ``kernel`` is the patch-embed conv weight [P, P, C, D] (bf16 on CUDA; D
    in ``layernorm.WIDTHS``),
    ``bias`` f32 [D]. On CUDA two kernels run, one launch: the hit list of
    :func:`voxel_hits` into a scratch of NC * 64 entries a band (8 bytes
    each), then a warp a token sums its hits' W rows. CPU tensors take
    :func:`voxel_embed_tokens_plain`."""
    if kernel.device.type == "cpu":
        return voxel_embed_tokens_plain(chunks, kernel, bias, patch, grid_hw)
    b, nb, nc, rpp, c, d = _geometry(chunks, kernel, patch, grid_hw)
    h, w = grid_hw
    require(d in WIDTHS, f"voxel_embed kernel is built for D in {WIDTHS}, got {d}")
    require(kernel.is_cuda and kernel.dtype == torch.bfloat16 and kernel.is_contiguous(),
            "voxel_embed: kernel must be contiguous CUDA bf16")
    require(bias.device == kernel.device and bias.dtype == torch.float32
            and tuple(bias.shape) == (d,) and bias.is_contiguous(),
            "voxel_embed: bias must be contiguous f32 [D] on the kernel's device")
    _require_decoded(chunks, kernel.device, "voxel_embed")
    out = torch.empty(b, (h // patch) * (w // patch), d, dtype=kernel.dtype,
                      device=kernel.device)
    hits, offsets = _hit_scratch(chunks, rpp * (w // patch), kernel.device)
    err = kernels().ibk_voxel_embed(
        chunks.wid.data_ptr(), chunks.sl.data_ptr(), chunks.ch.data_ptr(),
        chunks.val.data_ptr(), chunks.count.data_ptr(), kernel.data_ptr(),
        bias.data_ptr(), out.data_ptr(), hits.data_ptr(), offsets.data_ptr(), b, nb, nc, c, w,
        patch, rpp, d, stream_ptr(kernel))
    check_launch(err, "voxel_embed")
    return out


def _fill_geometry(chunks, grid_hw, patch):
    h, w = grid_hw
    b, nb, nc = chunks.wid.shape
    rows_band = rows_per_program(h, patch) * patch
    if nb * rows_band != h or (rows_band * w) % WINDOW:
        raise ValueError(f"{nb} bands do not tile a {h}x{w} grid at patch {patch}")
    return b, nb, nc, rows_band * w


def voxel_fill_bev_plain(chunks: VoxelChunks, grid_hw: tuple[int, int], channels: int,
                         patch: int, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version over decoded chunks: every cell's value,
    rounded to ``dtype``, is added into a zero f32 BEV at its (pixel,
    channel) (``index_put_`` with accumulate), then cast to ``dtype``.
    Chunks past ``count``, zero-valued slots and cells whose channel lies
    outside [0, channels) or whose pixel lies outside the band add nothing."""
    b, nb, nc, band_px = _fill_geometry(chunks, grid_hw, patch)
    h, w = grid_hw
    dev = chunks.wid.device
    cap = chunks.sl.shape[-1]
    real = torch.arange(nc, device=dev)[None, None, :] < chunks.count[:, :, None]
    val = chunks.val.reshape(b, nb, nc, cap)
    ch = chunks.ch.reshape(b, nb, nc, cap).long()
    sl = chunks.sl.reshape(b, nb, nc, cap).long()
    px = chunks.wid[..., None].long() * WINDOW + sl
    keep = real[..., None] & (val != 0) & (ch >= 0) & (ch < channels) \
        & (sl >= 0) & (sl < WINDOW) & (px >= 0) & (px < band_px)
    bi, band, _, _ = torch.nonzero(keep, as_tuple=True)
    flat = ((bi * nb + band) * band_px + px[keep]) * channels + ch[keep]
    out = torch.zeros(b * h * w * channels, dtype=torch.float32, device=dev)
    out.index_put_((flat,), val[keep].to(dtype).float(), accumulate=True)
    return out.to(dtype).reshape(b, h, w, channels)


def voxel_fill_bev(chunks: VoxelChunks, grid_hw: tuple[int, int], channels: int,
                   patch: int, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Decoded chunks -> dense BEV [B, H, W, channels] in ``dtype`` (bf16 or
    f32), the placement of :func:`voxel_embed_tokens` written out as image
    rows. ``patch`` is the value the chunks were built with (it sets the
    band height). Contract: at most one cell per (pixel, channel), which
    the host chunk build guarantees by deduplicating cells; the kernel stores a
    cell's value where :func:`voxel_fill_bev_plain` adds it into zeros, the
    same result under the contract. CPU tensors take the plain version."""
    if chunks.wid.device.type == "cpu":
        return voxel_fill_bev_plain(chunks, grid_hw, channels, patch, dtype)
    b, nb, nc, band_px = _fill_geometry(chunks, grid_hw, patch)
    h, w = grid_hw
    require(dtype in (torch.bfloat16, torch.float32),
            f"voxel_fill: output dtype must be bf16 or f32, got {dtype}")
    elt = 2 if dtype == torch.bfloat16 else 4
    require(0 < channels and WINDOW * channels * elt <= FILL_SMEM_BYTES,
            f"voxel_fill: a [{WINDOW}, {channels}] {dtype} tile does not fit a block")
    _require_decoded(chunks, chunks.wid.device, "voxel_fill")
    out = torch.empty(b, h, w, channels, dtype=dtype, device=chunks.wid.device)
    err = kernels().ibk_voxel_fill(
        chunks.wid.data_ptr(), chunks.sl.data_ptr(), chunks.ch.data_ptr(),
        chunks.val.data_ptr(), chunks.count.data_ptr(), out.data_ptr(), b, nb, nc,
        channels, band_px, int(dtype == torch.float32), stream_ptr(out))
    check_launch(err, "voxel_fill")
    return out
