"""Residual building blocks (NHWC at the public boundary).

Counterpart of ``intentbev/models/blocks.py``: BasicBlock (conv-BN-ReLU x2
+ identity or 1x1 projection shortcut) with torch-style symmetric padding.
BatchNorm (eps 1e-5) is computed in f32 and rounded to the compute dtype,
as flax does: from its running statistics in eval mode; in training mode
from the batch, with the biased (fast) variance max(0, E[x^2] - E[x]^2),
and the running averages follow ra = 0.9 ra + 0.1 batch (flax momentum
0.9; ``nn.BatchNorm2d`` itself would use the unbiased variance). Under data
parallelism (``group``) the statistics are the global batch's, as GSPMD
reduces JAX's over the sharded batch: sum(x), sum(x^2) and the count go
through one differentiable all-reduce over the group.
Convolutions are plain ``F.conv2d`` (XLA convolutions in the JAX package),
with the weights cast to the input's dtype at use.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.distributed import DataGroup, all_reduce_sum

BN_MOMENTUM = 0.9


def batch_norm_infer(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """BN over NCHW with running statistics, math in f32."""
    mul = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    shape = (1, -1, 1, 1)
    y = (x.float() - bn.running_mean.float().view(shape)) * mul.view(shape) \
        + bn.bias.float().view(shape)
    return y.to(x.dtype)


def batch_norm_train(x: torch.Tensor, bn: nn.BatchNorm2d,
                     group: DataGroup | None = None) -> torch.Tensor:
    """BN over NCHW with the batch's f32 statistics (biased variance),
    those of the global batch under ``group``; updates the running averages
    in place."""
    xf = x.float()
    if group is None:
        mean = xf.mean((0, 2, 3))
        sq = (xf * xf).mean((0, 2, 3))
    else:
        n = xf.shape[0] * xf.shape[2] * xf.shape[3]
        sums = torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)),
                          xf.new_full((1,), float(n))])
        sums = all_reduce_sum(sums, group, grad=True)
        c = xf.shape[1]
        mean, sq = sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]
    var = (sq - mean * mean).clamp(min=0.0)
    with torch.no_grad():
        bn.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1 - BN_MOMENTUM)
        bn.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1 - BN_MOMENTUM)
    shape = (1, -1, 1, 1)
    mul = bn.weight.float() * torch.rsqrt(var + bn.eps)
    return ((xf - mean.view(shape)) * mul.view(shape) + bn.bias.float().view(shape)).to(x.dtype)


@torch.no_grad()
def reset_conv_bn(mod: nn.Module, generator: torch.Generator) -> None:
    """Seeded init of one conv or BN module as the JAX models init theirs:
    Kaiming normal (fan-out) for the bias-free backbone convs, LeCun normal
    and a zero bias for the head convs; unit BN scale and running variance,
    zero BN bias and running mean."""
    if isinstance(mod, nn.Conv2d):
        fan_out = mod.out_channels * mod.kernel_size[0] * mod.kernel_size[1]
        fan_in = mod.in_channels * mod.kernel_size[0] * mod.kernel_size[1]
        head = mod.bias is not None
        std = (1.0 / fan_in) ** 0.5 if head else (2.0 / fan_out) ** 0.5
        mod.weight.normal_(0.0, std, generator=generator)
        if head:
            mod.bias.zero_()
    elif isinstance(mod, nn.BatchNorm2d):
        mod.reset_parameters()


def conv(mod: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``mod`` applied with its parameters cast to x's dtype (f32 master
    weights in training; a no-op cast when they already are). On the CPU
    the input is made NCHW-contiguous first: PyTorch's CPU backward of a
    strided 1x1 conv over a channels-last input corrupts the heap (seen with
    torch 2.13, 12 -> 16 channels at stride 2)."""
    if x.device.type == "cpu":
        x = x.contiguous()
    b = None if mod.bias is None else mod.bias.to(x.dtype)
    return F.conv2d(x, mod.weight.to(x.dtype), b, mod.stride, mod.padding)


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

    def forward(self, x: torch.Tensor, group: DataGroup | None = None) -> torch.Tensor:  # NCHW
        """``group``: the data-parallel group whose global batch the
        training statistics cover (None: this batch alone)."""
        def bn(y, mod):
            return batch_norm_train(y, mod, group) if self.training else batch_norm_infer(y, mod)

        y = F.relu(bn(conv(self.conv1, x), self.bn1))
        y = bn(conv(self.conv2, y), self.bn2)
        identity = x
        if self.proj_conv is not None:
            identity = bn(conv(self.proj_conv, x), self.proj_bn)
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

    def forward(self, x_nhwc: torch.Tensor, group: DataGroup | None = None) -> torch.Tensor:
        x = x_nhwc.permute(0, 3, 1, 2)
        for blk in self.blocks:
            x = blk(x, group)
        return x.permute(0, 2, 3, 1)


def ensure_nhwc(x: torch.Tensor, channels: int) -> torch.Tensor:
    """Accept NCHW (the reference's torch layout) or NHWC and return NHWC
    (a permuted view for NCHW)."""
    if x.ndim != 4:
        raise ValueError(f"expected a rank-4 BEV tensor, got shape {tuple(x.shape)}")
    if x.shape[-1] == channels:
        return x
    if x.shape[1] == channels:
        return x.permute(0, 2, 3, 1)
    raise ValueError(f"neither axis 1 nor axis 3 matches channels={channels}: "
                     f"{tuple(x.shape)}")
