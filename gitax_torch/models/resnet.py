"""CLIP's ModifiedResNet image encoder, the counterpart of
`gitax.models.resnet` (reference CLIP/model.py:94-159).

No shipped GIT config uses it; it lets a CLIP ResNet checkpoint serve as
an encoder and a CLIP RN archive load whole (`ckpt.clip_archive`).  The
reference's differences from torchvision's ResNet are kept: a 3-conv
stem with an average pool, anti-aliased strided bottlenecks (the average
pool before the strided 1x1 conv and in the downsample branch) and an
attention-pool head.  GIT's `output_grid` mode returns the last spatial
grid as tokens (CLIP/model.py:156-157) and skips the pool.

Parameter names follow the reference's state dict (`conv1.weight`,
`bn1.running_mean`, `layer{g}.{i}.downsample.0.weight`,
`attnpool.q_proj.weight`, ...), so a reference state dict loads with
`ckpt.load_resnet_state_dict`; BatchNorm's `num_batches_tracked` is not
kept (inference reads the running statistics only).

Images come in NHWC, as everywhere in the port; inside, the activations
are NCHW views of channels_last memory and the convolutions are
`F.conv2d` (gitax's are XLA convolutions, not Pallas kernels).  Under
CUDA, cuDNN's TF32 default applies to f32 convolutions unless the caller
turns `torch.backends.cudnn.allow_tf32` off, as the parity checks do.
Inference BatchNorm follows gitax's `_bn` order, not `F.batch_norm`'s:
the scale `gamma * rsqrt(var + eps)` and the shift in f32, both cast to
the activation dtype, then `x * scale + shift`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .nn import Linear, acc_dtype, empty_param, linear


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    layers: Tuple[int, int, int, int] = (3, 4, 6, 3)
    width: int = 64
    output_dim: int = 1024
    heads: int = 32
    input_resolution: int = 224

    @property
    def embed_dim(self):
        return self.width * 32


class Conv(nn.Module):
    """A bias-free convolution's `weight` [out, in, k, k]."""

    def __init__(self, cin, cout, k, device=None, dtype=None):
        super().__init__()
        self.weight = empty_param((cout, cin, k, k), device, dtype)


class BatchNorm(nn.Module):
    """Inference BatchNorm: `weight`, `bias` and the running statistics
    `running_mean`, `running_var` (buffers, as in torch)."""

    def __init__(self, c, device=None, dtype=None, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = empty_param((c,), device, dtype)
        self.bias = empty_param((c,), device, dtype)
        self.register_buffer("running_mean", torch.zeros(c, device=device, dtype=dtype))
        self.register_buffer("running_var", torch.ones(c, device=device, dtype=dtype))


def _bn(x, bn: BatchNorm):
    """gitax's `_bn` (resnet.py:37-45) on NCHW x."""
    acc = acc_dtype(x.dtype)
    inv = torch.rsqrt(bn.running_var.to(acc) + bn.eps)
    gamma = bn.weight.to(acc)
    scale = (gamma * inv).to(x.dtype)
    shift = (bn.bias.to(acc) - bn.running_mean.to(acc) * gamma * inv).to(x.dtype)
    return x * scale[:, None, None] + shift[:, None, None]


def _conv(x, conv: Conv, stride=1, padding=0):
    return F.conv2d(x, conv.weight.to(x.dtype), stride=stride, padding=padding)


class Bottleneck(nn.Module):
    """(reference CLIP/model.py:9-52) Every conv has stride 1; a strided
    block pools after conv2, and its downsample branch pools before its
    1x1 conv."""

    expansion = 4

    def __init__(self, inplanes, planes, stride=1, device=None, dtype=None):
        super().__init__()
        self.stride = stride
        self.conv1 = Conv(inplanes, planes, 1, device, dtype)
        self.bn1 = BatchNorm(planes, device, dtype)
        self.conv2 = Conv(planes, planes, 3, device, dtype)
        self.bn2 = BatchNorm(planes, device, dtype)
        self.conv3 = Conv(planes, planes * self.expansion, 1, device, dtype)
        self.bn3 = BatchNorm(planes * self.expansion, device, dtype)
        self.downsample = None
        if stride > 1 or inplanes != planes * self.expansion:
            # the reference's Sequential('-1': AvgPool2d, '0': conv, '1': bn)
            self.downsample = nn.ModuleDict({
                "0": Conv(inplanes, planes * self.expansion, 1, device, dtype),
                "1": BatchNorm(planes * self.expansion, device, dtype)})

    def forward(self, x):
        out = F.relu(_bn(_conv(x, self.conv1), self.bn1))
        out = F.relu(_bn(_conv(out, self.conv2, padding=1), self.bn2))
        if self.stride > 1:
            out = F.avg_pool2d(out, self.stride)
        out = _bn(_conv(out, self.conv3), self.bn3)
        identity = x
        if self.downsample is not None:
            if self.stride > 1:
                identity = F.avg_pool2d(identity, self.stride)
            identity = _bn(_conv(identity, self.downsample["0"]), self.downsample["1"])
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """(reference CLIP/model.py:55-92) `positional_embedding` [g*g + 1, C]
    and the q, k, v, c projections."""

    def __init__(self, spacial_dim, embed_dim, num_heads, output_dim, device=None, dtype=None):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = empty_param((spacial_dim ** 2 + 1, embed_dim), device, dtype)
        self.k_proj = Linear(embed_dim, embed_dim, device=device, dtype=dtype)
        self.q_proj = Linear(embed_dim, embed_dim, device=device, dtype=dtype)
        self.v_proj = Linear(embed_dim, embed_dim, device=device, dtype=dtype)
        self.c_proj = Linear(embed_dim, output_dim, device=device, dtype=dtype)


def attention_pool(x, pool: AttentionPool2d):
    """NCHW grid [B, C, H, W] -> pooled [B, output_dim] (gitax
    resnet.py:81-111): the mean token prepended, the positional table
    added, one query (the mean token's), f32 scores, the softmax cast to
    v's dtype before probs . v."""
    b, c = x.shape[:2]
    x = x.permute(0, 2, 3, 1).reshape(b, -1, c)
    x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)
    x = x + pool.positional_embedding.to(x.dtype)
    t, h = x.shape[1], pool.num_heads
    dh = c // h
    q = linear(x[:, :1], pool.q_proj).reshape(b, 1, h, dh).transpose(1, 2)
    k = linear(x, pool.k_proj).reshape(b, t, h, dh).transpose(1, 2)
    v = linear(x, pool.v_proj).reshape(b, t, h, dh).transpose(1, 2)
    acc = acc_dtype(x.dtype)
    scores = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) / math.sqrt(dh)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    ctx = torch.matmul(probs, v).transpose(1, 2).reshape(b, c)
    return linear(ctx, pool.c_proj)


class ModifiedResNet(nn.Module):
    """CLIP's ModifiedResNet on `device` (default: the CUDA card, see
    `models.git.resolve_device`) in `dtype`; values random until
    `init_params` or a loader fills them."""

    def __init__(self, cfg: ResNetConfig, device=None, dtype=torch.float32):
        super().__init__()
        from .git import resolve_device

        device = resolve_device(device)
        self.cfg = cfg
        w, half = cfg.width, cfg.width // 2
        self.conv1 = Conv(3, half, 3, device, dtype)
        self.bn1 = BatchNorm(half, device, dtype)
        self.conv2 = Conv(half, half, 3, device, dtype)
        self.bn2 = BatchNorm(half, device, dtype)
        self.conv3 = Conv(half, w, 3, device, dtype)
        self.bn3 = BatchNorm(w, device, dtype)
        inplanes = w
        for gi, n_blocks in enumerate(cfg.layers):
            planes = w * 2 ** gi
            blocks = []
            for bi in range(n_blocks):
                blocks.append(Bottleneck(inplanes, planes, 2 if gi and not bi else 1,
                                         device, dtype))
                inplanes = planes * Bottleneck.expansion
            setattr(self, "layer{}".format(gi + 1), nn.Sequential(*blocks))
        self.attnpool = AttentionPool2d(cfg.input_resolution // 32, cfg.embed_dim, cfg.heads,
                                        cfg.output_dim, device, dtype)

    @torch.no_grad()
    def init_params(self, generator):
        """Random weights drawn from `generator` on the CPU: He-normal
        convs (std sqrt(2 / fan_in)), BatchNorm weights from U(0.5, 1.5),
        biases and running means from U(-0.1, 0.1), running variances
        from U(0.5, 1.5), and the attention pool as the reference's
        `initialize_parameters` (std embed_dim**-0.5, zero biases)."""
        def uniform(t, lo, hi):
            t.copy_(torch.rand(t.shape, generator=generator) * (hi - lo) + lo)

        std = self.cfg.embed_dim ** -0.5
        for m in self.modules():
            if isinstance(m, Conv):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               * (2.0 / fan_in) ** 0.5)
            elif isinstance(m, BatchNorm):
                uniform(m.weight, 0.5, 1.5)
                uniform(m.bias, -0.1, 0.1)
                uniform(m.running_mean, -0.1, 0.1)
                uniform(m.running_var, 0.5, 1.5)
        pool = self.attnpool
        pool.positional_embedding.copy_(
            torch.randn(pool.positional_embedding.shape, generator=generator) * std)
        for lin in (pool.q_proj, pool.k_proj, pool.v_proj, pool.c_proj):
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=generator) * std)
            lin.bias.zero_()
        return self


def resnet_forward(model: ModifiedResNet, images, dtype=torch.float32, output_grid=True):
    """images [B, H, W, 3] (NHWC, normalised) -> tokens [B, (H/32)*(W/32),
    width*32] in output_grid mode (GIT's), else pooled [B, output_dim]."""
    x = images.to(dtype).permute(0, 3, 1, 2)  # NCHW view of channels_last memory
    x = x.contiguous(memory_format=torch.channels_last)
    x = F.relu(_bn(_conv(x, model.conv1, stride=2, padding=1), model.bn1))
    x = F.relu(_bn(_conv(x, model.conv2, padding=1), model.bn2))
    x = F.relu(_bn(_conv(x, model.conv3, padding=1), model.bn3))
    x = F.avg_pool2d(x, 2)
    for gi in range(len(model.cfg.layers)):
        x = getattr(model, "layer{}".format(gi + 1))(x)
    if output_grid:
        b, c = x.shape[:2]
        return x.permute(0, 2, 3, 1).reshape(b, -1, c)
    return attention_pool(x, model.attnpool)
