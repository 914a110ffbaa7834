"""Map-stream transport: bit-packing of the binary map channels.

Counterpart of the transport part of ``intentbev/bev/rasterize.py``: the
host packs the 0/1 map channels 8 per byte (u8[..., ceil(C/8)], MSB first,
like ``np.packbits``); the device unpacks them with elementwise shifts.
"""

from __future__ import annotations

import numpy as np
import torch


def pack_map_channels(map_bev: np.ndarray) -> np.ndarray:
    """Binary u8/bool[..., C] -> u8[..., ceil(C/8)] (MSB first)."""
    return np.packbits(map_bev.astype(bool), axis=-1)


def unpack_map_channels(packed: torch.Tensor, num_channels: int,
                        dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`pack_map_channels` on a u8 tensor ->
    ``dtype``[..., num_channels]."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    bits = bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8)
    return bits[..., :num_channels].to(dtype)


def decode_map_transport(map_bev: torch.Tensor, num_channels: int,
                         dtype: torch.dtype) -> torch.Tensor:
    """Any map transport encoding -> ``dtype``[..., C]: bit-packed u8
    (channel dim == ceil(C/8)), plain u8 0/1, or float."""
    if (map_bev.dtype == torch.uint8 and num_channels > 1
            and map_bev.shape[-1] == (num_channels + 7) // 8):
        return unpack_map_channels(map_bev, num_channels, dtype)
    return map_bev.to(dtype)
