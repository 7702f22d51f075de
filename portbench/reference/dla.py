# Frozen copy of side_tpu_torch/models/dla.py at commit ca59ff401c87, kept with the benchmark
# so that later changes to the program do not move the yardstick.
# Edits: the DCN is the plain one (deform_conv.py here), no mesh, and
# every conv, dense and BatchNorm reads its operands and writes its result
# through precision.q (the identity unless a control precision is on).
"""DLA-34 backbone with deformable-conv aggregation upsampling, PyTorch.

Port of side_tpu/models/dla.py, for inference (`module.eval()`) and
training (`module.train()`: batch-statistics BatchNorm).  Submodules carry
the names flax gives the JAX modules (`base`, `ConvBN_0`, `Tree_1`,
`BatchNorm_0`, `dla_up/ida_0/proj_1`, `up_1`, `node_1`, `offset_mask`), so
a JAX parameter path maps onto a `state_dict` key by a rename (see
weights.py).

Activations are NCHW tensors in channels-last memory: a DeformBlock views
them as NHWC without a copy for the DCN kernel.  Parameters stay float32;
every conv runs in its input's dtype (the compute dtype), as flax's
`nn.Conv(dtype=...)` does.  The DLA stem is the plain one; the JAX
package's space-to-depth stem computes the same function in a TPU layout.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .precision import q
from .deform_conv import deform_block_om
from .nomesh import active_mesh, all_reduce_sum

BN_EPS = 1e-5


class Conv2d(nn.Conv2d):
    """nn.Conv2d that runs in its input's dtype (weights kept float32)."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return q(F.conv2d(q(x), q(self.weight.to(x.dtype)), b, self.stride,
                          self.padding, self.dilation, self.groups))


class Conv3d(nn.Conv3d):
    """nn.Conv3d that runs in its input's dtype (weights kept float32)."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return q(F.conv3d(q(x), q(self.weight.to(x.dtype)), b, self.stride,
                          self.padding, self.dilation, self.groups))


def conv_init_(w: torch.Tensor, gen: torch.Generator) -> None:
    """flax variance_scaling(1/3, fan_in, uniform) = torch's Conv default."""
    fan_in = w[0].numel()
    bound = math.sqrt(1.0 / fan_in)
    with torch.no_grad():
        w.copy_(torch.rand(w.shape, generator=gen) * 2 * bound - bound)


def msra_init_(w: torch.Tensor, gen: torch.Generator) -> None:
    """flax variance_scaling(2, fan_out, normal)."""
    fan_out = w.shape[0] * w[0, 0].numel()
    with torch.no_grad():
        w.copy_(torch.randn(w.shape, generator=gen) *
                math.sqrt(2.0 / fan_out))


_frozen_statistics = False


@contextlib.contextmanager
def frozen_statistics(on: bool = True):
    """Within the block (when `on`), training-mode BatchNorms normalise with
    the batch statistics but leave their running statistics as they are:
    the backward's recompute of a checkpointed segment (`--remat`) runs its
    BatchNorms a second time, and the statistics blend once per step."""
    global _frozen_statistics
    prev = _frozen_statistics
    _frozen_statistics = prev or on
    try:
        yield
    finally:
        _frozen_statistics = prev


class FoldedBatchNorm(nn.Module):
    """BatchNorm over dim 1 applied as ONE multiply-add (side_tpu
    FoldedBatchNorm): a = scale * rsqrt(var + eps), b = bias - mean * a are
    folded per channel in f32, and under bf16 the apply runs in f32 with a
    single rounding to bf16 (BatchNorm2d in bf16 would round each step).

    In training mode (`module.train()`) mean and var are the batch's, in f32
    over every axis but the channel one, the variance biased and clipped at
    0, max(E[x^2] - mean^2, 0), and the gradient flows through both; the
    running statistics blend as 0.9 * old + 0.1 * batch (flax momentum 0.9).
    F.batch_norm is not used: it would blend the unbiased variance.

    Within `parallel.mesh.data_parallel` the batch is the global one: the
    ranks' per-channel E[x] and E[x^2] (2C values) are summed in one
    all-reduce, with the gradient flowing through, and divided by the world
    size (sync-BN; torch.nn.SyncBatchNorm would blend the unbiased
    variance); every rank blends the same running statistics.  Without a
    mesh no collective runs and nothing else changes."""

    momentum = 0.9
    channel_dim = 1

    def __init__(self, channels: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def statistics(self, x):
        """(mean, var) to normalise with: the batch's in training mode
        (blending the running statistics unless they are frozen), else the
        running ones."""
        if not self.training:
            return self.running_mean, self.running_var
        xf = x.float()
        dims = [d for d in range(x.dim()) if d != self.channel_dim % x.dim()]
        mean = xf.mean(dims)
        square = (xf * xf).mean(dims)
        mesh = active_mesh()
        if mesh is not None:
            # the ranks hold equal shards (shard_batch), so the global
            # means are the ranks' local means summed over the world size
            C = mean.shape[0]
            both = all_reduce_sum(torch.cat([mean, square]), mesh) / mesh.world
            mean, square = both[:C], both[C:]
        var = torch.clamp(square - mean * mean, min=0.0)
        if not _frozen_statistics:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean)
                self.running_var.mul_(m).add_((1 - m) * var)
        return mean, var

    def forward(self, x):
        mean, var = self.statistics(x)
        a = self.weight * torch.rsqrt(var + self.eps)
        b = self.bias - mean * a
        shape = (1, -1) + (1,) * (x.dim() - 2)
        a, b = a.view(shape), b.view(shape)
        if x.dtype == torch.float32:
            return q(x * a + b)
        return (x.float() * a + b).to(x.dtype)


class BatchNorm(FoldedBatchNorm):
    """flax `nn.BatchNorm(dtype=float32)` over the LAST axis: the statistics
    of FoldedBatchNorm, applied in f32 in flax's order, (x - mean) *
    (scale * rsqrt(var + eps)) + bias, with an f32 result.  Used where the
    JAX package has nn.BatchNorm rather than FoldedBatchNorm (the voxel
    net, PointNetDepth, DeconvStage); NCHW inputs pass `channel_dim=1`."""

    def __init__(self, channels: int, channel_dim: int = -1,
                 eps: float = BN_EPS):
        super().__init__(channels, eps)
        self.channel_dim = channel_dim

    def forward(self, x):
        mean, var = self.statistics(x)
        mul = self.weight * torch.rsqrt(var + self.eps)
        shape = [1] * x.dim()
        shape[self.channel_dim % x.dim()] = -1
        return q((x.float() - mean.view(shape)) * mul.view(shape)
                 + self.bias.view(shape))


class Dense(nn.Linear):
    """flax `nn.Dense(dtype=...)`: nn.Linear run in its input's dtype
    (weights kept float32); weight (out, in) is the flax kernel
    transposed."""

    def forward(self, x):
        return q(F.linear(q(x), q(self.weight.to(x.dtype)),
                          self.bias.to(x.dtype)))


class ConvBN(nn.Module):
    """conv (no bias) + BN + optional ReLU."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 dilation: int = 1, relu: bool = True):
        super().__init__()
        self.relu = relu
        self.Conv_0 = Conv2d(cin, cout, kernel, stride,
                             dilation * (kernel - 1) // 2, dilation,
                             bias=False)
        self.BatchNorm_0 = FoldedBatchNorm(cout)

    def forward(self, x):
        x = self.BatchNorm_0(self.Conv_0(x))
        return F.relu(x) if self.relu else x


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.ConvBN_0 = ConvBN(cin, cout, 3, stride, dilation)
        self.ConvBN_1 = ConvBN(cout, cout, 3, 1, dilation, relu=False)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        out = self.ConvBN_1(self.ConvBN_0(x))
        return F.relu(out + residual.to(out.dtype))


class Root(nn.Module):
    def __init__(self, cin: int, cout: int, residual: bool = False):
        super().__init__()
        self.residual = residual
        self.ConvBN_0 = ConvBN(cin, cout, 1, relu=False)

    def forward(self, children: Sequence[torch.Tensor]):
        x = self.ConvBN_0(torch.cat(list(children), dim=1))
        if self.residual:
            x = x + children[0]
        return F.relu(x)


class Tree(nn.Module):
    """Recursive deep-aggregation tree (side_tpu Tree)."""

    def __init__(self, levels: int, cin: int, cout: int, stride: int = 1,
                 level_root: bool = False, root_dim: int = 0,
                 dilation: int = 1, root_residual: bool = False):
        super().__init__()
        self.levels, self.stride, self.level_root = levels, stride, level_root
        root_dim = root_dim or 2 * cout
        if level_root:
            root_dim += cin
        self.project = cin != cout
        if self.project:
            self.ConvBN_0 = ConvBN(cin, cout, 1, relu=False)
        if levels == 1:
            self.BasicBlock_0 = BasicBlock(cin, cout, stride, dilation)
            self.BasicBlock_1 = BasicBlock(cout, cout, 1, dilation)
            self.Root_0 = Root(root_dim, cout, root_residual)
        else:
            self.Tree_0 = Tree(levels - 1, cin, cout, stride,
                               dilation=dilation, root_residual=root_residual)
            self.Tree_1 = Tree(levels - 1, cout, cout,
                               root_dim=root_dim + cout, dilation=dilation,
                               root_residual=root_residual)

    def forward(self, x, children: Optional[List[torch.Tensor]] = None):
        children = [] if children is None else list(children)
        bottom = F.max_pool2d(x, self.stride, self.stride) \
            if self.stride > 1 else x
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            residual = self.ConvBN_0(bottom) if self.project else bottom
            x1 = self.BasicBlock_0(x, residual)
            x2 = self.BasicBlock_1(x1)
            return self.Root_0([x2, x1] + children)
        # the JAX Tree also projects a residual here that nothing reads: in
        # training its BatchNorm still updates the running statistics, so
        # the projection runs (without autograd) for them alone
        if self.training and self.project:
            with torch.no_grad():
                self.ConvBN_0(bottom)
        x1 = self.Tree_0(x)
        children.append(x1)
        return self.Tree_1(x1, children)


class DLA(nn.Module):
    """Six-level DLA-34 trunk returning every level's features, plain stem."""

    def __init__(self, levels=(1, 1, 1, 2, 2, 1),
                 channels=(16, 32, 64, 128, 256, 512),
                 residual_root: bool = False):
        super().__init__()
        if levels[0] != 1 or levels[1] != 1:
            raise ValueError("the ported stem has one conv per level 0/1")
        ch = channels
        self.ConvBN_0 = ConvBN(3, ch[0], 7, 1)
        self.ConvBN_1 = ConvBN(ch[0], ch[0], 3, 1)
        self.ConvBN_2 = ConvBN(ch[0], ch[1], 3, 2)
        self.Tree_0 = Tree(levels[2], ch[1], ch[2], 2, level_root=False,
                           root_residual=residual_root)
        self.Tree_1 = Tree(levels[3], ch[2], ch[3], 2, level_root=True,
                           root_residual=residual_root)
        self.Tree_2 = Tree(levels[4], ch[3], ch[4], 2, level_root=True,
                           root_residual=residual_root)
        self.Tree_3 = Tree(levels[5], ch[4], ch[5], 2, level_root=True,
                           root_residual=residual_root)

    def forward(self, x) -> List[torch.Tensor]:
        y = self.ConvBN_1(self.ConvBN_0(x))
        outs = [y]
        y = self.ConvBN_2(y)
        outs.append(y)
        for tree in (self.Tree_0, self.Tree_1, self.Tree_2, self.Tree_3):
            y = tree(y)
            outs.append(y)
        return outs


def bilinear_kernel(factor: int) -> np.ndarray:
    """Bilinear interpolation kernel of size 2f x 2f."""
    size = 2 * factor
    f = math.ceil(size / 2)
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    r = np.arange(size)
    k1 = 1 - np.abs(r / f - c)
    return np.outer(k1, k1).astype(np.float32)


class BilinearUp(nn.ConvTranspose2d):
    """Learnable depthwise transpose-conv upsampler, bilinear-initialised.

    The JAX (k, k, 1, C) kernel w, applied there as a flipped lhs-dilated
    depthwise conv, is this ConvTranspose2d with weight[c, 0] = w[:, :, 0, c]
    (unflipped)."""

    def __init__(self, channels: int, factor: int):
        if factor < 2:
            raise ValueError("BilinearUp upsamples by a factor of 2 or more")
        super().__init__(channels, channels, 2 * factor, stride=factor,
                         padding=factor // 2, groups=channels, bias=False)
        with torch.no_grad():
            self.weight.copy_(torch.from_numpy(bilinear_kernel(factor))
                              [None, None].expand_as(self.weight))

    def forward(self, x):
        return q(F.conv_transpose2d(q(x), q(self.weight.to(x.dtype)), None,
                                    self.stride, self.padding, 0,
                                    self.groups))


class DeformBlock(nn.Module):
    """DCNv2 3x3 + BN + ReLU (side_tpu DeformBlock).  `offset_mask` is the
    zero-initialised 27-channel conv with per-tap interleaved [dy, dx,
    mask-logit] outputs; `kernel` (3, 3, Cin, Cout) and `bias` are the DCN's
    own parameters in the JAX layout."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.offset_mask = nn.Conv2d(cin, 27, 3, padding=1)
        nn.init.zeros_(self.offset_mask.weight)
        nn.init.zeros_(self.offset_mask.bias)
        self.kernel = nn.Parameter(torch.empty(3, 3, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.BatchNorm_0 = FoldedBatchNorm(cout)

    def forward(self, x):
        y = deform_block_om(x.permute(0, 2, 3, 1), self.offset_mask.weight,
                            self.offset_mask.bias, self.kernel, self.bias)
        return F.relu(self.BatchNorm_0(y.permute(0, 3, 1, 2)))


class IDAUp(nn.Module):
    """Iterative deep aggregation step: project each finer-level input to
    `features` channels (deformable), upsample, fuse with the previous level
    through a deformable node.  layer_channels[j-1] is the channel count of
    the j-th layer after `startp`."""

    def __init__(self, features: int, up_factors: Sequence[int],
                 layer_channels: Sequence[int]):
        super().__init__()
        self.n = len(layer_channels)
        for j, cin in enumerate(layer_channels, start=1):
            setattr(self, f"proj_{j}", DeformBlock(cin, features))
            setattr(self, f"up_{j}", BilinearUp(features, int(up_factors[j])))
            setattr(self, f"node_{j}", DeformBlock(features, features))

    def forward(self, layers: List[torch.Tensor], startp: int, endp: int):
        layers = list(layers)
        for i in range(startp + 1, endp):
            j = i - startp
            x = getattr(self, f"proj_{j}")(layers[i])
            x = getattr(self, f"up_{j}")(x)
            layers[i] = getattr(self, f"node_{j}")(x + layers[i - 1])
        return layers


class DLAUp(nn.Module):
    """Full aggregation pyramid (side_tpu DLAUp)."""

    def __init__(self, channels: Sequence[int]):
        super().__init__()
        channels = list(channels)
        scales = np.array([2 ** i for i in range(len(channels))], int)
        in_channels = list(channels)
        self.n = len(channels)
        for i in range(len(channels) - 1):
            j = -i - 2
            setattr(self, f"ida_{i}", IDAUp(
                channels[j], (scales[j:] // scales[j]).tolist(),
                in_channels[j + 1:]))
            scales[j + 1:] = scales[j]
            in_channels[j + 1:] = [channels[j] for _ in channels[j + 1:]]

    def forward(self, layers: List[torch.Tensor]) -> List[torch.Tensor]:
        layers = list(layers)
        out = [layers[-1]]
        n = len(layers)
        for i in range(self.n - 1):
            layers = getattr(self, f"ida_{i}")(layers, n - i - 2, n)
            out.insert(0, layers[-1])
        return out


class FeatureExtractor(nn.Module):
    """DLA-34 -> DLAUp -> final IDAUp: a 64-channel 1/4-resolution map."""

    channels = (16, 32, 64, 128, 256, 512)

    def __init__(self, down_ratio: int = 4, last_level: int = 5):
        super().__init__()
        self.first = int(np.log2(down_ratio))
        self.last_level = last_level
        ch = self.channels
        self.base = DLA(channels=ch)
        self.dla_up = DLAUp(ch[self.first:])
        n = last_level - self.first
        self.ida_up = IDAUp(ch[self.first], [2 ** i for i in range(n)],
                            ch[self.first + 1:last_level])

    def forward(self, x) -> torch.Tensor:
        feats = self.base(x)
        outs = self.dla_up(feats[self.first:])
        y = list(outs[: self.last_level - self.first])
        return self.ida_up(y, 0, len(y))[-1]


def lecun_init_(w: torch.Tensor, gen: torch.Generator) -> None:
    """flax lecun_normal: a normal truncated at +-2 standard units, scaled
    by fan_in^-0.5 over the truncated unit normal's std (0.8796...), so
    that the variance is 1/fan_in."""
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        w.mul_(w[0].numel() ** -0.5 / 0.87962566103423978)


def init_weights(module: nn.Module, gen: torch.Generator) -> None:
    """Seeded init following the JAX package's initialisers: conv and DCN
    kernels uniform with bound 1/sqrt(fan_in) (msra normal where a conv is
    marked `msra`, lecun normal where it is marked `lecun` and for Dense
    layers), conv and Dense biases zero; offset/mask convs, BN and
    BilinearUp keep the values their constructors set (zero, identity,
    bilinear)."""
    for m in module.modules():
        if isinstance(m, DeformBlock):
            conv_init_(m.kernel.permute(3, 2, 0, 1), gen)
        elif isinstance(m, (Conv2d, Conv3d, Dense)):
            if getattr(m, "msra", False):
                msra_init_(m.weight, gen)
            elif getattr(m, "lecun", False) or isinstance(m, Dense):
                lecun_init_(m.weight, gen)
            else:
                conv_init_(m.weight, gen)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
