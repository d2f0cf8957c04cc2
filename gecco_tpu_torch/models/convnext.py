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

``load_torchvision_state_dict`` fills a ConvNeXt of any size from a
torchvision ``convnext_*`` state dict (its OIHW kernels to the HWIO
parameters), ``load_pretrained_npz`` from such a dict saved as an npz. No
weights are fetched.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gecco_tpu_torch.utils.modules import Linear, resolve_device

__all__ = [
    "CONVNEXT_CONFIGS",
    "ConvNeXt",
    "ConvNeXtBlock",
    "ConvNeXtExtractor",
    "FeaturePyramidContext",
    "load_pretrained_npz",
    "load_torchvision_state_dict",
]

# blocks and channels per stage (torchvision convnext_{tiny,small,base,large})
CONVNEXT_CONFIGS = {
    "tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "small": ((3, 3, 27, 3), (96, 192, 384, 768)),
    "base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
    "large": ((3, 3, 27, 3), (192, 384, 768, 1536)),
}

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

    def __init__(self, dim: int, layer_scale_init: float = 1e-6, *, device=None,
                 generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.dw_kernel = nn.Parameter(_trunc_normal((7, 7, 1, dim), 0.02, generator).to(dev))
        self.dw_bias = nn.Parameter(torch.zeros(dim, device=dev))
        self.norm = _LayerNormAffine(dim, device=dev)
        self.pw1 = Linear(dim, 4 * dim, device=dev, generator=generator)
        self.pw2 = Linear(4 * dim, dim, device=dev, generator=generator)
        self.layer_scale = nn.Parameter(torch.full((dim,), layer_scale_init, device=dev))

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
    """The stem and the first ``n_stages`` stages of a torchvision ConvNeXt
    of ``size`` (``CONVNEXT_CONFIGS``), with the downsamples between them;
    the reference clips the rest. At three stages: maps at strides 4, 8 and
    16."""

    def __init__(self, size: str = "tiny", n_stages: int = 3, compute_dtype=torch.bfloat16, *,
                 device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(device=dev, generator=generator)
        depths, widths = (c[:n_stages] for c in CONVNEXT_CONFIGS[size])
        self.stem_kernel = nn.Parameter(_trunc_normal((4, 4, 3, widths[0]), 0.02, generator).to(dev))
        self.stem_bias = nn.Parameter(torch.zeros(widths[0], device=dev))
        self.stem_norm = _LayerNormAffine(widths[0], device=dev)
        self.stages = nn.ModuleList()
        self.downs = nn.ModuleList()
        for i, (d, w) in enumerate(zip(depths, widths)):
            self.stages.append(nn.ModuleList(ConvNeXtBlock(w, **kw) for _ in range(d)))
            if i + 1 < len(widths):
                self.downs.append(_Downsample(w, widths[i + 1], **kw))
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
    """Conditioner: the ConvNeXt of ``size`` on ``ctx_raw.image`` -> the
    feature pyramid; ``mode="local"`` keeps the three stages' maps,
    ``"global"`` the last only (for ``GlobalConditioningNetwork``)."""

    def __init__(self, size: str = "tiny", mode: str = "local", compute_dtype=torch.bfloat16, *,
                 device=None, generator=None):
        super().__init__()
        if mode not in ("local", "global"):
            raise ValueError(f"mode must be 'local' or 'global', got {mode!r}")
        self.backbone = ConvNeXt(size, compute_dtype=compute_dtype, device=device,
                                 generator=generator)
        self.mode = mode

    def forward(self, ctx_raw) -> FeaturePyramidContext:
        maps = self.backbone(ctx_raw.image)
        if self.mode == "global":
            maps = maps[-1:]
        return FeaturePyramidContext(features=tuple(maps), K=ctx_raw.K, wmat=ctx_raw.wmat)


def load_pretrained_npz(extractor: ConvNeXtExtractor, npz_path: str) -> ConvNeXtExtractor:
    """Load a torchvision ``convnext_*`` state dict saved as an npz (an
    array a key) into ``extractor``'s ConvNeXt, in place."""
    with np.load(npz_path) as data:
        state_dict = {k: data[k] for k in data.files}
    load_torchvision_state_dict(extractor.backbone, state_dict)
    return extractor


def load_torchvision_state_dict(model: ConvNeXt, state_dict: Mapping[str, Any]) -> ConvNeXt:
    """Fill ``model`` in place from a torchvision ``convnext_*`` state dict
    (tensors or numpy arrays keyed ``features.{i}...``):

    - ``features.0.{0,1}``: the stem convolution [C, 3, 4, 4] -> HWIO, its
      LayerNorm;
    - ``features.{2k+1}.{j}.block.{0,2,3,5}`` and ``.layer_scale``: block j
      of stage k (the depthwise kernel [C, 1, 7, 7] -> [7, 7, 1, C], the
      LayerNorm, the two linears [out, in] as they are);
    - ``features.{2k+2}.{0,1}``: the downsample's LayerNorm and its
      convolution [C2, C1, 2, 2] -> HWIO.

    The keys of the stages the model clips are not read. Raises
    ``ValueError`` on a shape that does not fit; nothing is copied then."""

    def arr(name):
        t = state_dict[name]
        return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t, np.float32)

    def hwio(name):
        return arr(name).transpose(2, 3, 1, 0)  # OIHW -> HWIO

    values = {"stem_kernel": hwio("features.0.0.weight"), "stem_bias": arr("features.0.0.bias"),
              "stem_norm.gamma": arr("features.0.1.weight"),
              "stem_norm.beta": arr("features.0.1.bias")}
    for k, stage in enumerate(model.stages):
        for j in range(len(stage)):
            p, q = f"features.{2 * k + 1}.{j}", f"stages.{k}.{j}"
            values.update({
                f"{q}.dw_kernel": hwio(f"{p}.block.0.weight"),
                f"{q}.dw_bias": arr(f"{p}.block.0.bias"),
                f"{q}.norm.gamma": arr(f"{p}.block.2.weight"),
                f"{q}.norm.beta": arr(f"{p}.block.2.bias"),
                f"{q}.pw1.weight": arr(f"{p}.block.3.weight"),
                f"{q}.pw1.bias": arr(f"{p}.block.3.bias"),
                f"{q}.pw2.weight": arr(f"{p}.block.5.weight"),
                f"{q}.pw2.bias": arr(f"{p}.block.5.bias"),
                f"{q}.layer_scale": arr(f"{p}.layer_scale").reshape(-1),
            })
    for k in range(len(model.downs)):
        p, q = f"features.{2 * k + 2}", f"downs.{k}"
        values.update({f"{q}.norm.gamma": arr(f"{p}.0.weight"),
                       f"{q}.norm.beta": arr(f"{p}.0.bias"),
                       f"{q}.kernel": hwio(f"{p}.1.weight"), f"{q}.bias": arr(f"{p}.1.bias")})
    params = dict(model.named_parameters())
    for name, value in values.items():
        if tuple(value.shape) != tuple(params[name].shape):
            raise ValueError(f"{name}: state dict shape {value.shape} != model shape "
                             f"{tuple(params[name].shape)}")
    with torch.no_grad():
        for name, value in values.items():
            params[name].copy_(torch.from_numpy(value).to(params[name].device))
    return model
