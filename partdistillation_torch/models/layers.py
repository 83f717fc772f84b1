"""Parameter-holding building blocks with the flax ``linen`` numerics the JAX
package relies on: f32 parameters cast to the module's compute dtype at the
call (Dense, Conv), normalisation statistics in f32 with the fast variance
E[x^2] - E[x]^2 clipped at 0 (LayerNorm, GroupNorm), channel-last tensors.

Parameter names follow ``torch.nn`` (``weight``, ``bias``) so that state dicts
carry detectron2/Mask2Former key names. ``init_weights`` fills a model from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Dense", "Conv", "ConvNorm", "LayerNorm", "GroupNorm", "init_weights",
           "normal_", "zeros_", "scalar_like"]


def scalar_like(value: float, x: torch.Tensor) -> torch.Tensor:
    """A 0-dim tensor of x's dtype: multiplying by it rounds the scalar to that
    dtype first, as a weakly typed Python scalar does in JAX."""
    return torch.tensor(value, dtype=x.dtype)


def _gen_randn(t: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    return torch.randn(t.shape, generator=g, device=t.device, dtype=torch.float32)


def normal_(t: torch.Tensor, g: torch.Generator, std: float = 1.0, truncate: bool = False):
    with torch.no_grad():
        r = _gen_randn(t, g)
        if truncate:
            r = r.clamp_(-2.0, 2.0)
        t.copy_(r * std)


def zeros_(t: torch.Tensor):
    with torch.no_grad():
        t.zero_()


class Dense(nn.Linear):
    """nn.Linear whose weight and bias are cast to ``dtype`` with the input."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        b = None if self.bias is None else self.bias.to(d)
        return F.linear(x.to(d), self.weight.to(d), b)

    def reset_parameters_with(self, g: torch.Generator):
        # flax's lecun_normal: truncated normal, variance 1 / fan_in
        normal_(self.weight, g, std=1.0 / math.sqrt(self.in_features), truncate=True)
        if self.bias is not None:
            zeros_(self.bias)


class Conv(nn.Conv2d):
    """Channel-last (B, H, W, C) convolution with flax's 'SAME' padding; the
    weight (O, I, kh, kw) and bias are cast to ``dtype`` with the input."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, bias: bool = True, dtype=torch.float32,
                 init: str = "lecun"):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         bias=bias)
        self.compute_dtype = dtype
        self.init = init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        k, s = self.kernel_size[0], self.stride[0]
        x = x.to(d).permute(0, 3, 1, 2)
        pads = []
        for size in (x.shape[3], x.shape[2]):  # F.pad order: W then H
            out = -(-size // s)
            total = max((out - 1) * s + k - size, 0)
            pads += [total // 2, total - total // 2]
        if any(pads):
            x = F.pad(x, pads)
        b = None if self.bias is None else self.bias.to(d)
        y = F.conv2d(x, self.weight.to(d), b, stride=s)
        return y.permute(0, 2, 3, 1)

    def reset_parameters_with(self, g: torch.Generator):
        fan_in = self.in_channels * self.kernel_size[0] * self.kernel_size[1]
        if self.init == "xavier":
            fan_out = self.out_channels * self.kernel_size[0] * self.kernel_size[1]
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            with torch.no_grad():
                u = torch.rand(self.weight.shape, generator=g, device=self.weight.device)
                self.weight.copy_((u * 2.0 - 1.0) * limit)
        else:
            normal_(self.weight, g, std=1.0 / math.sqrt(fan_in), truncate=True)
        if self.bias is not None:
            zeros_(self.bias)


def _normalize(x32, mean, var, weight, bias, eps, dtype):
    y = (x32 - mean) * (torch.rsqrt(var + eps) * weight.float()) + bias.float()
    return y.to(dtype)


class LayerNorm(nn.Module):
    """flax nn.LayerNorm: f32 fast-variance statistics, output in ``dtype``."""

    def __init__(self, num_features: int, eps: float = 1e-5, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.eps = eps
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = ((x32 * x32).mean(-1, keepdim=True) - mean * mean).clamp(min=0.0)
        return _normalize(x32, mean, var, self.weight, self.bias, self.eps,
                          self.compute_dtype)

    def reset_parameters_with(self, g: torch.Generator):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()


class GroupNorm(LayerNorm):
    """flax nn.GroupNorm on channel-last input: statistics per (image, group)
    over H, W and the group's channels."""

    def __init__(self, num_groups: int, num_features: int, eps: float = 1e-5,
                 dtype=torch.float32):
        super().__init__(num_features, eps, dtype)
        self.num_groups = num_groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        g = self.num_groups
        x32 = x.float().reshape(b, -1, g, c // g)
        mean = x32.mean(dim=(1, 3), keepdim=True)
        var = ((x32 * x32).mean(dim=(1, 3), keepdim=True) - mean * mean).clamp(min=0.0)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        y = y.reshape(x.shape) * self.weight.float() + self.bias.float()
        return y.to(self.compute_dtype)


class ConvNorm(Conv):
    """detectron2-style Conv2d with an attached ``.norm`` (GroupNorm 32)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 bias: bool = False, dtype=torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, bias=bias,
                         dtype=dtype, init="xavier")
        self.norm = GroupNorm(32, out_channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(super().forward(x))


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Fill every parameter from a seeded generator on the model's device.
    Modules are visited children first, so a parent's own rule (e.g. the
    MSDeformAttn offset grid) overrides its children's defaults."""
    params = list(model.parameters())
    device = params[0].device if params else torch.device("cpu")
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    for m in reversed(list(model.modules())):
        fn = getattr(m, "reset_parameters_with", None)
        if fn is not None:
            fn(g)
    return model
