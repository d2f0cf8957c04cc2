"""ConvNeXt feature-pyramid conditioner (counterpart of
``gecco_tpu/models/convnext.py``).

Activations are channels-last ``[B, H, W, C]`` tensors and the convolution
kernels keep the JAX package's HWIO layout as parameters (so the weights
move across unchanged); each convolution permutes both to PyTorch's NCHW /
OIHW order as views. The input view of a contiguous NHWC tensor is NCHW in
``torch.channels_last`` memory format, the convolution keeps that format,
and the permute back to NHWC is again a view: the pyramid leaves the
extractor contiguous in C, the layout the projective gather reads. The
convolutions are ``torch.nn.functional.conv2d`` calls, as the JAX package
leaves them to XLA. Each stage's blocks are an ``nn.ModuleList`` (the JAX
package stacks them and scans). No stochastic depth.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from gecco_tpu_torch.utils.modules import Linear, resolve_device

__all__ = [
    "ConvNeXt",
    "ConvNeXtBlock",
    "ConvNeXtExtractor",
    "FeaturePyramidContext",
]

# ConvNeXt-tiny (torchvision convnext_tiny) clipped to its first three
# stages: blocks and channels per stage
DEPTHS = (3, 3, 9)
WIDTHS = (96, 192, 384)

_LN_EPS = 1e-6  # torchvision ConvNeXt LayerNorm epsilon


class FeaturePyramidContext(NamedTuple):
    """The conditioner's output: ``features``, a tuple of ``[B, h, w, C_i]``
    maps; ``K [B, 3, 3]``; ``wmat`` as given."""

    features: Any
    K: Any
    wmat: Any = ()


def _trunc_normal(shape, std: float, generator) -> torch.Tensor:
    """N(0, std^2) truncated at two standard deviations, by the inverse CDF
    of a uniform draw on the CPU."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = lo + (1.0 - 2.0 * lo) * torch.rand(shape, generator=generator, dtype=torch.float64)
    return (std * math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)).float()


def _conv(x: torch.Tensor, kernel: torch.Tensor, stride: int, groups: int = 1) -> torch.Tensor:
    """NHWC ``x`` with an HWIO ``kernel``: VALID when the kernel size equals
    the stride (stem 4/4, downsample 2/2), SAME otherwise (the depthwise
    7x7 at stride 1: pad 3)."""
    k = kernel.shape[0]
    if k == stride:
        pad = 0
    elif stride == 1 and k % 2 == 1:
        pad = k // 2
    else:
        raise ValueError(f"no SAME padding rule for kernel {k} at stride {stride}")
    w = kernel.to(x.dtype).permute(3, 2, 0, 1)  # HWIO -> OIHW
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=pad, groups=groups)
    return y.permute(0, 2, 3, 1)


class _LayerNormAffine(nn.Module):
    """LayerNorm over the channel axis, fp32 statistics, output in the
    input's dtype."""

    def __init__(self, dim: int, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.gamma = nn.Parameter(torch.ones(dim, device=dev))
        self.beta = nn.Parameter(torch.zeros(dim, device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = xf.var(-1, unbiased=False, keepdim=True)
        normed = (xf - mean) / torch.sqrt(var + _LN_EPS)
        return (normed * self.gamma + self.beta).to(x.dtype)


class ConvNeXtBlock(nn.Module):
    """dwconv 7x7 -> LN -> Linear(4x) -> exact GELU -> Linear -> layer
    scale, residual."""

    def __init__(self, dim: int, *, device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.dw_kernel = nn.Parameter(_trunc_normal((7, 7, 1, dim), 0.02, generator).to(dev))
        self.dw_bias = nn.Parameter(torch.zeros(dim, device=dev))
        self.norm = _LayerNormAffine(dim, device=dev)
        self.pw1 = Linear(dim, 4 * dim, device=dev, generator=generator)
        self.pw2 = Linear(4 * dim, dim, device=dev, generator=generator)
        self.layer_scale = nn.Parameter(torch.full((dim,), 1e-6, device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _conv(x, self.dw_kernel, stride=1, groups=x.shape[-1]) + self.dw_bias.to(x.dtype)
        y = self.pw2(F.gelu(self.pw1(self.norm(y)), approximate="none"))
        return x + y * self.layer_scale.to(y.dtype)


class _Downsample(nn.Module):
    def __init__(self, c_in: int, c_out: int, *, device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.norm = _LayerNormAffine(c_in, device=dev)
        self.kernel = nn.Parameter(_trunc_normal((2, 2, c_in, c_out), 0.02, generator).to(dev))
        self.bias = nn.Parameter(torch.zeros(c_out, device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv(self.norm(x), self.kernel, stride=2) + self.bias.to(x.dtype)


class ConvNeXt(nn.Module):
    """ConvNeXt-tiny's stem + its first three stages with the downsamples
    between them: maps at strides 4, 8 and 16."""

    def __init__(self, compute_dtype=torch.bfloat16, *, device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(device=dev, generator=generator)
        self.stem_kernel = nn.Parameter(_trunc_normal((4, 4, 3, WIDTHS[0]), 0.02, generator).to(dev))
        self.stem_bias = nn.Parameter(torch.zeros(WIDTHS[0], device=dev))
        self.stem_norm = _LayerNormAffine(WIDTHS[0], device=dev)
        self.stages = nn.ModuleList()
        self.downs = nn.ModuleList()
        for i, (d, w) in enumerate(zip(DEPTHS, WIDTHS)):
            self.stages.append(nn.ModuleList(ConvNeXtBlock(w, **kw) for _ in range(d)))
            if i + 1 < len(WIDTHS):
                self.downs.append(_Downsample(w, WIDTHS[i + 1], **kw))
        self.compute_dtype = compute_dtype

    def forward(self, images: torch.Tensor) -> list:
        """images [B, H, W, 3] -> per-stage maps [B, h_i, w_i, C_i]. Integer
        images are divided by 255 here, on the device, in the compute
        dtype."""
        if not images.is_floating_point():
            images = images.to(self.compute_dtype) / 255.0
        x = images.to(self.compute_dtype)
        x = self.stem_norm(_conv(x, self.stem_kernel, stride=4) + self.stem_bias.to(x.dtype))
        maps = []
        for i, stage in enumerate(self.stages):
            for block in stage:
                x = block(x)
            maps.append(x)
            if i < len(self.downs):
                x = self.downs[i](x)
        return maps


class ConvNeXtExtractor(nn.Module):
    """Conditioner: the ConvNeXt on ``ctx_raw.image`` -> the feature pyramid
    of all three stages (the JAX package's ``size="tiny", mode="local"``)."""

    def __init__(self, compute_dtype=torch.bfloat16, *, device=None, generator=None):
        super().__init__()
        self.backbone = ConvNeXt(compute_dtype, device=device, generator=generator)

    def forward(self, ctx_raw) -> FeaturePyramidContext:
        maps = self.backbone(ctx_raw.image)
        return FeaturePyramidContext(features=tuple(maps), K=ctx_raw.K, wmat=ctx_raw.wmat)
