"""IntentNetViT: two ViT-S/8 streams, adapters, residual fusion,
detection and intention heads.

Counterpart of ``intentbev/models/vit.py``. In eval mode the module runs
the serving path (``deterministic=True`` with the serving LN chain):

- lidar tokens come from placement chunks through the voxel-embed kernel,
  map tokens from a stride-8 patch embed (a plain matmul over patches);
- CLS token and position embeddings, then per encoder one standalone LN
  kernel for block 0's norm1; every block runs qkv (GEMM), the flash
  kernel, proj (GEMM) + residual, and the fused LN+MLP kernel, whose
  epilogue emits the next block's norm1 and, in the last block, the final
  norm;
- per stream an adapter LN kernel, Linear and exact-erf GELU, reshaped to
  NHWC; the fusion ResidualStage; the heads; f32 logits out.

The kernel switches of ``ViTBackboneConfig`` select the JAX model's other
structures, each kernel where the TPU runs a Pallas kernel and plain
PyTorch where it runs XLA:

- without the chain (``fuse_ln_chain``, ``use_fused_layernorm`` or
  ``use_fused_mlp`` off, or ``fuse_ln_dense`` or ``serving_int8`` on, and
  always in training) every block takes its own norm1, and the stack a
  final norm;
- ``fuse_ln_dense``: norm1 folded into the qkv projection (with the flash
  path; without it the JAX model folds it eagerly) and each adapter's LN ->
  Linear -> GELU as one kernel (``ops/fused_ln_dense``); the tail is the
  LN+MLP kernel without the epilogue;
- ``use_fused_layernorm=False``: LayerNorms in plain PyTorch with the JAX
  FastLayerNorm's rounding, and the tail MLP, if ``use_fused_mlp``, as the
  MLP kernel without LN (``ops/fused_mlp``);
- ``use_fused_mlp=False``: the tail MLP as two Linears and the exact GELU;
- ``use_flash_attention=False``: attention as the JAX model's dense
  ``reference_attention``, in plain PyTorch;
- ``serving_int8`` (serving only): the tail MLP as the W8A8 kernel
  (``ops/fused_mlp_int8``) on codes quantized once, at load, from the f32
  parameters; attention stays bf16, as in the JAX code;
- ``fuse_patch_embed`` (serving only): a dense lidar input of >= 128
  channels embeds through the patch-embed kernel (``ops/patch_embed``).

The unchained structure is written once (``EncoderBlock.forward_unchained``,
the encoder's final norm and the backbone's adapters) and reads the
switches; an :class:`Ops` table gives it its entries. Serving takes the
forward-only kernels (``KERNEL_OPS``, or ``PLAIN_OPS``); training
(``model.train()``, the JAX model's ``deterministic=False``) takes
:func:`train_ops`, the differentiable entries, each a
``torch.autograd.Function`` whose backward is a kernel too; the flash
backward's form (JAX's ``INTENTBEV_BWD_FUSED`` / ``INTENTBEV_BWD_KV_CHUNK``)
is the model's ``bwd_fused`` / ``bwd_kv_chunk``, its forward's softmax form
(JAX's ``fwd_kv_chunk`` / ``unsafe_softmax``) the config's, serving and
training alike (ignored where the heads do not pair, as by JAX's BHTD
fallback), and ``remat``
(``TrainConfig.remat_vit_blocks``) recomputes each encoder block in the
backward (``torch.utils.checkpoint``, JAX's ``nn.remat``). In training the
lidar stream takes a dense BEV through the patch embed (a matmul over
patches), BatchNorm uses the batch statistics, and the drop-path gates
(per sample, 0 or 1/keep, rates linspace(0, rate, depth)) are drawn from
the generator the caller passes. Training raises under ``serving_int8``
(inference only) and for a GELU other than the exact erf.

Tokens are not padded: the flash kernel takes any T and the LN/MLP
kernels any row count. LayerNorm eps is 1e-6 throughout. Weights are held
in ``param_dtype`` (the compute dtype for serving, f32 master weights for
training) and cast to the compute dtype at use; biases and LN parameters
are f32, the rounding the JAX package gets by casting its f32 parameters
at use. ``plain_ops=True`` runs each kernel's plain PyTorch version instead
(the on-card oracle); CPU tensors always take the plain versions.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

import numpy as np

from ..bev.rasterize import decode_map_transport
from ..ops.flash_packed import (MODEL_PAD_ROWS, flash_attention_fn, flash_attention_packed,
                                flash_attention_packed_plain, pad_len, reference_attention)
from ..ops.fused_ln_dense import fused_ln_dense, fused_ln_dense_fn, fused_ln_dense_plain
from ..ops.fused_ln_mlp import (GELU_MODES, fused_ln_mlp, fused_ln_mlp_fn, fused_ln_mlp_plain,
                                fused_ln_mlp_train, fused_ln_mlp_train_plain)
from ..ops.fused_mlp import fused_mlp, fused_mlp_fn, fused_mlp_plain
from ..ops.fused_mlp_int8 import fused_mlp_int8, fused_mlp_int8_plain
from ..ops.int8 import quantize_linear
from ..ops.layernorm import layernorm, layernorm_fn, layernorm_plain
from ..ops.patch_embed import patch_embed, patch_embed_plain
from ..ops.voxel_embed import (VoxelChunks, voxel_embed_tokens,
                               voxel_embed_tokens_plain)
from .blocks import ResidualStage, reset_conv_bn
from .heads import DetectionHead, IntentionHead, flatten_head_outputs

LN_EPS = 1e-6


def _split_qkv(qkv):
    d = qkv.shape[-1] // 3  # q, k, v are column slices: no split copies
    return qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]


class Ops(NamedTuple):
    """The entries a structure calls, by call convention; the serving
    chain's tail, the voxel embed, the W8A8 MLP and the patch embed are
    forward-only (None in training)."""
    layernorm: Callable          # (x, gamma, beta, eps) -> y
    fused_ln_mlp: Callable       # the serving chain's tail
    flash: Callable              # (qkv, num_heads, kv_chunk, unsafe_softmax) -> o
    voxel_embed: Callable
    fused_ln_mlp_tail: Callable  # (x, gamma, beta, w1, b1, w2, b2, gate, eps, gelu) -> y
    fused_mlp: Callable          # (h, w1, b1, w2, b2, residual, gelu, gate) -> y
    fused_mlp_int8: Callable
    fused_ln_dense: Callable     # (x, gamma, beta, w, bias, eps, gelu) -> y
    patch_embed: Callable


def _flash(qkv, num_heads, kv_chunk, unsafe_softmax):
    return flash_attention_packed(*_split_qkv(qkv), num_heads, None, kv_chunk, unsafe_softmax,
                                  pad_len(qkv.shape[1], MODEL_PAD_ROWS))[0]


def _flash_plain(qkv, num_heads, kv_chunk, unsafe_softmax):
    return flash_attention_packed_plain(*_split_qkv(qkv), num_heads, None, kv_chunk,
                                        unsafe_softmax, pad_len(qkv.shape[1], MODEL_PAD_ROWS))[0]


KERNEL_OPS = Ops(layernorm, fused_ln_mlp, _flash, voxel_embed_tokens, fused_ln_mlp_train,
                 fused_mlp, fused_mlp_int8, fused_ln_dense, patch_embed)
PLAIN_OPS = Ops(layernorm_plain, fused_ln_mlp_plain, _flash_plain, voxel_embed_tokens_plain,
                fused_ln_mlp_train_plain, fused_mlp_plain, fused_mlp_int8_plain,
                fused_ln_dense_plain, patch_embed_plain)
PATCH_EMBED_MIN_CHANNELS = 128  # the fused patch embed's gate (JAX: wide inputs only)


def train_ops(plain: bool, bwd_fused: bool = True, bwd_kv_chunk: int = 0) -> Ops:
    """The differentiable entries of a training pass (exact erf GELU):
    kernels forward and backward, or with ``plain`` their plain versions.
    ``bwd_fused`` / ``bwd_kv_chunk`` pick the flash backward's form
    (``ops.flash_packed.bwd_mode``) and the config's ``fwd_kv_chunk`` /
    ``unsafe_softmax`` its forward's (``ops.flash_packed.fwd_form``, as JAX's
    ``_fp_fwd`` applies them in training too), over the token count padded
    as the JAX ViT pads it."""
    return Ops(
        layernorm=partial(layernorm_fn, plain=plain),
        fused_ln_mlp=None,
        flash=lambda qkv, heads, kv_chunk, unsafe_softmax: flash_attention_fn(
            qkv, heads, None, plain, bwd_fused, bwd_kv_chunk,
            pad_len(qkv.shape[1], MODEL_PAD_ROWS), kv_chunk, unsafe_softmax),
        voxel_embed=None,
        fused_ln_mlp_tail=lambda x, g, b, w1, b1, w2, b2, gate, eps, gelu: fused_ln_mlp_fn(
            x, g, b, w1, b1, w2, b2, gate, eps, plain),
        fused_mlp=lambda h, w1, b1, w2, b2, res, gelu, gate: fused_mlp_fn(
            h, w1, b1, w2, b2, res, gate, plain),
        fused_mlp_int8=None,
        fused_ln_dense=lambda x, g, b, w, bias, eps, gelu: fused_ln_dense_fn(
            x, g, b, w, bias, eps, gelu, plain),
        patch_embed=None,
    )


def fast_layernorm(x, gamma, beta, eps: float = LN_EPS):
    """The JAX FastLayerNorm (``use_fused_layernorm=False``) in plain
    PyTorch: elementwise math in x's dtype, f32 accumulation inside the two
    reductions only."""
    dt = x.dtype
    xc = x - x.float().mean(-1, keepdim=True).to(dt)
    var = (xc * xc).float().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(dt)
    return xc * inv * gamma.to(dt) + beta.to(dt)


def folded_layernorm(x, gamma, beta, eps: float = LN_EPS):
    """The JAX Attention's eager fold of norm1 (``fuse_ln_dense`` off the
    flash path): f32 statistics, xc and inv rounded to x's dtype."""
    dt = x.dtype
    xf = x.float()
    xc = xf - xf.mean(-1, keepdim=True)
    inv = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps).to(dt)
    return xc.to(dt) * inv * gamma.to(dt) + beta.to(dt)


def _norm(x, params, ops: Ops, fused: bool):
    """A standalone LayerNorm: the LN kernel, or FastLayerNorm's plain math."""
    if fused:
        return ops.layernorm(x, params.weight, params.bias, LN_EPS)
    return fast_layernorm(x, params.weight, params.bias)


def uses_ln_chain(cfg) -> bool:
    """The JAX gate of the serving LN chain (deterministic passes)."""
    return (cfg.fuse_ln_chain and cfg.use_fused_layernorm and cfg.use_fused_mlp
            and not cfg.fuse_ln_dense and not cfg.serving_int8 and cfg.depth > 0)


def check_trainable(cfg) -> None:
    """Raise for the switches a training step cannot take."""
    if cfg.serving_int8:
        raise NotImplementedError("serving_int8 is inference-only, as in the JAX package")


class LayerNormParams(nn.Module):
    """LayerNorm scale/bias (f32); the math runs in the LN kernels."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


class Linear(nn.Module):
    """Dense layer: weight [out, in] in the parameter dtype, bias in f32,
    both cast to the input's dtype at use, like flax ``nn.Dense(dtype=...)``."""

    def __init__(self, fin: int, fout: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(fout, fin, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(fout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class PatchEmbed(nn.Module):
    """Stride-P patch-embed conv parameters in the JAX layout: weight
    [P, P, C, D] (parameter dtype), bias [D] (f32)."""

    def __init__(self, patch: int, in_ch: int, dim: int, dtype: torch.dtype):
        super().__init__()
        self.patch = patch
        self.weight = nn.Parameter(torch.empty(patch, patch, in_ch, dim, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim))

    def dense(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        """conv_PxP,sP over a dense NHWC input as one matmul over patches."""
        b, h, w, c = x_nhwc.shape
        p = self.patch
        xp = x_nhwc.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        xp = xp.reshape(b, (h // p) * (w // p), p * p * c)
        wt = self.weight.to(x_nhwc.dtype).reshape(p * p * c, -1)
        return torch.matmul(xp, wt) + self.bias.to(x_nhwc.dtype)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool, dtype: torch.dtype):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim, qkv_bias, dtype)
        self.proj = Linear(dim, dim, True, dtype)

    def attend(self, qkv, residual, ops: Ops, cfg, gate=None):
        """residual + gate * proj(attention(qkv)): the flash entry in the
        softmax form of ``cfg.fwd_kv_chunk`` / ``cfg.unsafe_softmax``, or the
        JAX model's dense attention where ``use_flash_attention`` is off;
        ``gate`` per-sample f32 [B] or None."""
        if cfg.use_flash_attention:
            o = ops.flash(qkv, self.num_heads, cfg.fwd_kv_chunk, cfg.unsafe_softmax)
        else:
            o = reference_attention(*_split_qkv(qkv), self.num_heads)
        y = self.proj(o)
        if gate is not None:
            y = y * gate.to(y.dtype)[:, None, None]
        return residual + y


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2. With ``int8`` it also holds the W8A8 codes of
    both weights (int8 [out, in]) and their f32 scales as buffers, computed
    when a state dict is loaded (and at ``reset_parameters``) from the
    weights as they arrive there, f32 from ``from_flax`` or ``init_params``,
    not from the compute-dtype copies."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype, int8: bool = False):
        super().__init__()
        self.fc1 = Linear(dim, hidden, True, dtype)
        self.fc2 = Linear(hidden, dim, True, dtype)
        self.int8 = int8
        if int8:
            for name, shape in (("w1q", (hidden, dim)), ("w2q", (dim, hidden))):
                self.register_buffer(name, torch.zeros(shape, dtype=torch.int8),
                                     persistent=False)
            self.register_buffer("s1", torch.zeros(hidden), persistent=False)
            self.register_buffer("s2", torch.zeros(dim), persistent=False)
            self.register_load_state_dict_pre_hook(Mlp._quantize_on_load)

    @torch.no_grad()
    def quantize(self, w1: torch.Tensor, w2: torch.Tensor) -> None:
        for (q_name, s_name), w in ((("w1q", "s1"), w1), (("w2q", "s2"), w2)):
            q, scale = quantize_linear(w)
            getattr(self, q_name).copy_(q)
            getattr(self, s_name).copy_(scale)

    @staticmethod
    def _quantize_on_load(module, state_dict, prefix, *_):
        w1, w2 = state_dict.get(prefix + "fc1.weight"), state_dict.get(prefix + "fc2.weight")
        if w1 is not None and w2 is not None:
            module.quantize(w1, w2)


class EncoderBlock(nn.Module):
    """Pre-LN block. ``forward`` is the serving LN chain's: takes x and xn =
    norm1(x), returns (x', ln_next(x')); ``forward_unchained`` every other
    structure."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 qkv_bias: bool, dtype: torch.dtype, int8: bool = False):
        super().__init__()
        self.norm1 = LayerNormParams(dim)
        self.attn = Attention(dim, num_heads, qkv_bias, dtype)
        self.norm2 = LayerNormParams(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype, int8)

    def forward(self, x, xn, ln_next: LayerNormParams, ops: Ops, gelu: str, cfg):
        a, m = self.attn, self.mlp
        x = a.attend(a.qkv(xn), x, ops, cfg)
        return ops.fused_ln_mlp(
            x, self.norm2.weight, self.norm2.bias, m.fc1.weight, m.fc1.bias,
            m.fc2.weight, m.fc2.bias, ln_next.weight, ln_next.bias, LN_EPS, gelu)

    def forward_unchained(self, x, ops: Ops, gelu: str, cfg, gates=(None, None)):
        """The JAX block's structures without the chain, serving and
        training alike: takes and returns the residual stream x. ``gates``:
        (attention, MLP) per-sample f32 [B] drop-path gates, each None for
        1 (always None serving)."""
        fused_ln, a, m = cfg.use_fused_layernorm, self.attn, self.mlp
        dt, n1 = x.dtype, self.norm1
        if (fused_ln and cfg.fuse_ln_dense and a.qkv.bias is not None
                and not cfg.serving_int8):
            if cfg.use_flash_attention:
                qkv = ops.fused_ln_dense(x, n1.weight, n1.bias, a.qkv.weight.to(dt),
                                         a.qkv.bias, LN_EPS, None)
            else:
                qkv = a.qkv(folded_layernorm(x, n1.weight, n1.bias))
        else:
            qkv = a.qkv(_norm(x, n1, ops, fused_ln))
        x = a.attend(qkv, x, ops, cfg, gates[0])
        gate = None if gates[1] is None else gates[1][:, None].expand(x.shape[:2])
        if cfg.use_fused_mlp and fused_ln and not cfg.serving_int8:
            return ops.fused_ln_mlp_tail(
                x, self.norm2.weight, self.norm2.bias, m.fc1.weight.to(dt), m.fc1.bias,
                m.fc2.weight.to(dt), m.fc2.bias, gate, LN_EPS, gelu)
        h = _norm(x, self.norm2, ops, fused_ln)
        if cfg.serving_int8:
            return ops.fused_mlp_int8(h, m.w1q, m.s1, m.fc1.bias, m.w2q, m.s2, m.fc2.bias,
                                      x, gelu)
        if cfg.use_fused_mlp:
            return ops.fused_mlp(h, m.fc1.weight.to(dt), m.fc1.bias, m.fc2.weight.to(dt),
                                 m.fc2.bias, x, gelu, gate)
        y = m.fc2(F.gelu(m.fc1(h)))  # XLA in the JAX model: exact erf
        if gate is not None:
            y = y * gate.to(y.dtype)[..., None]
        return x + y


class ViTEncoder(nn.Module):
    """Patch embed + CLS + pos embed + blocks; returns final-normed tokens
    [B, 1+N, D]. With ``remat`` each block of a training pass keeps only
    its input and runs its forward again in the backward."""

    def __init__(self, cfg, in_channels: int, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        self.remat = False
        h, w = cfg.img_size
        p = cfg.patch_size
        n = (h // p) * (w // p)
        d = cfg.embed_dim
        self.patch_embed = PatchEmbed(p, in_channels, d, dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + n, d))
        self.blocks = nn.ModuleList(
            EncoderBlock(d, cfg.num_heads, cfg.mlp_ratio, cfg.qkv_bias, dtype,
                         cfg.serving_int8)
            for _ in range(cfg.depth))
        self.norm = LayerNormParams(d)

    def drop_path_gates(self, batch: int, generator, device):
        """Per block, the (attention, MLP) gates: per sample 0 or 1/keep at
        the block's rate, or None where the rate is 0 or no generator is
        given."""
        rates = np.linspace(0.0, self.cfg.drop_path_rate, self.cfg.depth)
        gates = []
        for rate in rates:
            if rate <= 0 or generator is None:
                gates.append((None, None))
                continue
            keep = 1.0 - float(rate)
            gates.append(tuple(
                (torch.rand(batch, generator=generator, device=device) < keep).float() / keep
                for _ in range(2)))
        return gates

    def forward(self, x, ops: Ops, gelu: str, generator=None) -> torch.Tensor:
        """Lidar chunks or a dense NHWC BEV -> final-normed tokens; in
        training mode the unchained structure with drop-path gates drawn
        from ``generator``."""
        cfg = self.cfg
        pe = self.patch_embed
        if isinstance(x, VoxelChunks):
            tokens = ops.voxel_embed(x, pe.weight, pe.bias, cfg.patch_size,
                                     tuple(cfg.img_size))
        elif (cfg.fuse_patch_embed and not self.training
              and x.shape[-1] >= PATCH_EMBED_MIN_CHANNELS):
            tokens = ops.patch_embed(x, pe.weight.to(x.dtype), pe.bias, cfg.patch_size)
        else:
            tokens = pe.dense(x)
        b, _, d = tokens.shape
        dt = tokens.dtype
        tokens = torch.cat([self.cls_token.to(dt).expand(b, 1, d), tokens], 1)
        tokens = tokens + self.pos_embed.to(dt)
        blocks = self.blocks
        if self.training or not uses_ln_chain(cfg):
            gates = self.drop_path_gates(b, generator if self.training else None,
                                         tokens.device)
            remat = self.training and self.remat
            for blk, g in zip(blocks, gates):  # the gates are drawn: a recompute sees them
                if remat:
                    tokens = checkpoint(blk.forward_unchained, tokens, ops, gelu, cfg, g,
                                        use_reentrant=False)
                else:
                    tokens = blk.forward_unchained(tokens, ops, gelu, cfg, g)
            return _norm(tokens, self.norm, ops, cfg.use_fused_layernorm)
        xn = ops.layernorm(tokens, blocks[0].norm1.weight, blocks[0].norm1.bias, LN_EPS)
        for i, blk in enumerate(blocks):
            nxt = blocks[i + 1].norm1 if i + 1 < len(blocks) else self.norm
            tokens, xn = blk(tokens, xn, nxt, ops, gelu, cfg)
        return xn


class TwoStreamViTBackbone(nn.Module):
    def __init__(self, cfg, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        d, a = cfg.embed_dim, cfg.adapter_out_channels
        self.vit_lidar = ViTEncoder(cfg, cfg.lidar_input_channels, dtype)
        self.vit_map = ViTEncoder(cfg, cfg.map_input_channels, dtype)
        self.adapter_lidar_norm = LayerNormParams(d)
        self.adapter_lidar_proj = Linear(d, a, True, dtype)
        self.adapter_map_norm = LayerNormParams(d)
        self.adapter_map_proj = Linear(d, a, True, dtype)
        self.fusion = ResidualStage(2 * a, cfg.fusion_planes, cfg.fusion_layers,
                                    cfg.fusion_stride, cfg.fusion_kernel_size, dtype)

    def forward(self, lidar, map_nhwc, ops: Ops, gelu: str, generator=None) -> torch.Tensor:
        cfg = self.cfg
        gh, gw = cfg.grid_size

        def stream(enc, norm, proj, x):
            tokens = enc(x, ops, gelu, generator)[:, 1:].contiguous()  # strip CLS
            if cfg.use_fused_layernorm and cfg.fuse_ln_dense:
                # one kernel; its GELU is the block MLPs' (the JAX kernel's _gelu)
                h = ops.fused_ln_dense(tokens, norm.weight, norm.bias,
                                       proj.weight.to(tokens.dtype), proj.bias, LN_EPS, gelu)
            else:
                h = _norm(tokens, norm, ops, cfg.use_fused_layernorm)
                h = F.gelu(proj(h))  # exact erf, as the JAX adapter
            return h.reshape(h.shape[0], gh, gw, -1)

        feats = torch.cat([
            stream(self.vit_lidar, self.adapter_lidar_norm, self.adapter_lidar_proj, lidar),
            stream(self.vit_map, self.adapter_map_norm, self.adapter_map_proj, map_nhwc),
        ], dim=-1)
        return self.fusion(feats)


class IntentNetViT(nn.Module):
    """(lidar: decoded VoxelChunks or an NHWC BEV; map: NHWC, or bit-packed
    u8 [B, H, W, ceil(C/8)]) -> f32 (cls [B, N, 1], box deltas [B, N, 6],
    intent logits [B, N, C]), N = Hf*Wf*A.

    ``dtype`` is the compute dtype, ``param_dtype`` that of the weights
    (default: the compute dtype; training passes f32). In training mode the
    lidar input is a dense NHWC BEV and the block MLPs take the exact erf
    GELU; ``bwd_fused`` and ``bwd_kv_chunk`` pick the flash backward's form
    and ``remat`` recomputes the encoder blocks (:func:`train_ops`,
    :class:`ViTEncoder`)."""

    def __init__(self, cfg, head_cfg, dtype: torch.dtype = torch.float32,
                 gelu: str = "erf", plain_ops: bool = False,
                 param_dtype: torch.dtype | None = None, bwd_fused: bool = True,
                 bwd_kv_chunk: int = 0, remat: bool = False):
        super().__init__()
        if gelu not in GELU_MODES:
            raise ValueError(f"gelu mode {gelu!r} not in {GELU_MODES}")
        pdt = dtype if param_dtype is None else param_dtype
        self.cfg = cfg
        self.dtype = dtype
        self.gelu = gelu
        self.plain_ops = plain_ops
        self.bwd_fused, self.bwd_kv_chunk = bwd_fused, bwd_kv_chunk
        self.backbone = TwoStreamViTBackbone(cfg, pdt)
        self.backbone.vit_lidar.remat = self.backbone.vit_map.remat = remat
        self.det_head = DetectionHead(cfg.fusion_planes, head_cfg.num_anchors,
                                      head_cfg.num_box_params, pdt)
        self.intention_head = IntentionHead(cfg.fusion_planes, head_cfg.num_anchors,
                                            head_cfg.num_intention_classes, pdt)

    def forward(self, lidar, map_bev: torch.Tensor, generator=None):
        """``generator`` draws the drop-path gates in training mode."""
        m = decode_map_transport(map_bev, self.cfg.map_input_channels, self.dtype)
        if self.training:
            check_trainable(self.cfg)
            if self.gelu != "erf":
                raise ValueError("training takes the exact erf GELU")
            ops = train_ops(self.plain_ops, self.bwd_fused, self.bwd_kv_chunk)
            lidar = lidar.to(self.dtype)
        else:
            ops = PLAIN_OPS if self.plain_ops else KERNEL_OPS
        feats = self.backbone(lidar, m, ops, self.gelu, generator)
        cls_l, box = self.det_head(feats)
        intent = self.intention_head(feats)
        return tuple(t.float() for t in flatten_head_outputs(cls_l, box, intent))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded random init: truncated normal (std 0.02, cut at 2 std) for
        dense, patch-embed, CLS and position parameters; Kaiming normal
        (fan-out) for the fusion convs; LeCun normal for the head convs;
        zero biases; unit BN/LN scales and BN running variance."""
        def trunc(t):
            nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04, generator=generator)

        for mod in self.modules():
            if isinstance(mod, (Linear, PatchEmbed)):
                trunc(mod.weight)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, ViTEncoder):
                trunc(mod.cls_token)
                trunc(mod.pos_embed)
            elif isinstance(mod, (nn.Conv2d, nn.BatchNorm2d)):
                reset_conv_bn(mod, generator)
            elif isinstance(mod, LayerNormParams):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        for mod in self.modules():  # after every weight is drawn
            if isinstance(mod, Mlp) and mod.int8:
                mod.quantize(mod.fc1.weight, mod.fc2.weight)
