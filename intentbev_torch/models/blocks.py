"""Residual building blocks at inference (NHWC at the public boundary).

Counterpart of ``intentbev/models/blocks.py``: BasicBlock (conv-BN-ReLU x2
+ identity or 1x1 projection shortcut) with torch-style symmetric padding,
BatchNorm from its running statistics (eps 1e-5) computed in f32 and
rounded to the compute dtype, as flax does. Convolutions are plain
``F.conv2d`` (XLA convolutions in the JAX package).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def batch_norm_infer(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """BN over NCHW with running statistics, math in f32."""
    mul = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    shape = (1, -1, 1, 1)
    y = (x.float() - bn.running_mean.float().view(shape)) * mul.view(shape) \
        + bn.bias.float().view(shape)
    return y.to(x.dtype)


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 kernel_size: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        pad = (kernel_size - 1) // 2
        self.conv1 = nn.Conv2d(in_ch, planes, kernel_size, stride, pad,
                               bias=False, dtype=dtype)
        self.bn1 = nn.BatchNorm2d(planes, eps=1e-5)
        self.conv2 = nn.Conv2d(planes, planes, kernel_size, 1, pad, bias=False,
                               dtype=dtype)
        self.bn2 = nn.BatchNorm2d(planes, eps=1e-5)
        self.proj_conv = self.proj_bn = None
        if stride != 1 or in_ch != planes:
            self.proj_conv = nn.Conv2d(in_ch, planes, 1, stride, bias=False,
                                       dtype=dtype)
            self.proj_bn = nn.BatchNorm2d(planes, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        y = F.relu(batch_norm_infer(self.conv1(x), self.bn1))
        y = batch_norm_infer(self.conv2(y), self.bn2)
        identity = x
        if self.proj_conv is not None:
            identity = batch_norm_infer(self.proj_conv(x), self.proj_bn)
        return F.relu(y + identity)


class ResidualStage(nn.Module):
    """A stack of BasicBlocks; the first carries the stride/projection.
    Takes and returns NHWC (run as channels-last NCHW inside)."""

    def __init__(self, in_ch: int, planes: int, num_blocks: int, stride: int = 1,
                 kernel_size: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.blocks = nn.ModuleList(
            BasicBlock(in_ch if i == 0 else planes, planes,
                       stride if i == 0 else 1, kernel_size, dtype)
            for i in range(num_blocks))

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        x = x_nhwc.permute(0, 3, 1, 2)
        for blk in self.blocks:
            x = blk(x)
        return x.permute(0, 2, 3, 1)
