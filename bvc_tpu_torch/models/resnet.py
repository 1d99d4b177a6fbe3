"""ResNet-18/34/50 with the SimCLR projection head (counterpart of
:mod:`bvc_tpu.models.resnet`).

The reference's torchvision ResNet with ``fc`` swapped for a 2-layer MLP
(``contrastive/pretrain_simclr.py:71-84``).  Parameter and buffer names are
torchvision's (``conv1``, ``bn1``, ``layer{1-4}.{b}.conv{k}`` /
``.bn{k}``, ``downsample.0`` / ``.1``, ``fc.0``, ``fc.2``), so the model's
state dict is the export layout of ``bvc_tpu.models.torch_interop``'s
``resnet_to_torch_state_dict``, running statistics and
``num_batches_tracked`` included (:mod:`bvc_tpu_torch.models.convert`).

Under the JAX package's dtype policy, kept by explicit casts: parameters
and BatchNorm buffers in f32, convolutions and the head in the compute dtype
(``dtype``, f32 or bf16), BatchNorm statistics in f32 over the compute-dtype
input with the output cast back (``F.batch_norm``'s mixed-dtype path:
the biased variance normalises, the running variance takes the unbiased
one, momentum 0.1, eps 1e-5; eval mode reads the running statistics).
Convolutions pad ``k // 2`` on each side, as the JAX package does (not
SAME, which pads stride-2 convolutions unevenly); the stem's max-pool is
3x3, stride 2, padding 1 with -inf padding.  Input is ``[B, H, W, 3]``: the
model permutes only the logical view, so the convolutions run on
``torch.channels_last`` memory.

Known difference: the head's ``F.linear`` adds its bias inside the product,
where the JAX package adds it after the bf16 product; in bf16 the two round
at different places (the same as the ViT's linears, ``models/vit.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

BLOCKS = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
}
STAGE_WIDTHS = (64, 128, 256, 512)
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def feature_dim(name: str) -> int:
    kind, _ = BLOCKS[name]
    return 512 * (4 if kind == "bottleneck" else 1)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


class _Block(nn.Module):
    """A basic (two 3x3) or bottleneck (1x1, 3x3, 1x1 at 4x width) block,
    the stride on its first 3x3, a 1x1 projection of the identity where the
    shape changes."""

    def __init__(self, kind: str, cin: int, width: int, stride: int):
        super().__init__()
        if kind == "basic":
            shapes = ((cin, width, 3, stride), (width, width, 3, 1))
            cout = width
        else:
            shapes = ((cin, width, 1, 1), (width, width, 3, stride), (width, width * 4, 1, 1))
            cout = width * 4
        for i, (a, b, k, s) in enumerate(shapes, start=1):
            setattr(self, f"conv{i}", _conv(a, b, k, s))
            setattr(self, f"bn{i}", _bn(b))
        self.n_convs = len(shapes)
        self.downsample = (nn.Sequential(_conv(cin, cout, 1, stride), _bn(cout))
                           if stride != 1 or cin != cout else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for i in range(1, self.n_convs + 1):
            y = getattr(self, f"bn{i}")(conv2d(y, getattr(self, f"conv{i}")))
            if i < self.n_convs:
                y = F.relu(y)
        identity = x
        if self.downsample is not None:
            identity = self.downsample[1](conv2d(x, self.downsample[0]))
        return F.relu(y + identity)


def conv2d(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` in ``x``'s dtype: the f32 weight cast per call, as the JAX
    package's ``w.astype(dtype)``."""
    return F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride, conv.padding)


class ResNet(nn.Module):
    """``arch`` in :data:`BLOCKS`; ``head_dim`` the width of both head
    layers (``fc.0`` from :func:`feature_dim`, then ``fc.2``); ``dtype`` the
    compute dtype (``"float32"`` / ``"bfloat16"`` or a torch dtype).

    Init as the JAX package's ``init_params``, drawn from a
    ``torch.Generator`` seeded with ``seed``: convolutions kaiming-normal
    with fan-out (``std = sqrt(2 / (k*k*cout))``), linears torch's default
    uniform (weight and bias within ``sqrt(1 / fan_in)``), BatchNorm scale
    1, bias 0, running mean 0 and variance 1.  ``bn_groups > 1`` (per-replica
    BatchNorm statistics) needs several GPUs and raises."""

    def __init__(self, arch: str = "resnet18", head_dim: int = 512,
                 dtype: str | torch.dtype = torch.float32, bn_groups: int = 1, seed: int = 0):
        super().__init__()
        if arch not in BLOCKS:
            raise ValueError(f"unknown architecture {arch!r} (expected one of {list(BLOCKS)})")
        if bn_groups != 1:
            raise NotImplementedError(
                f"bn_groups={bn_groups}: per-replica BatchNorm statistics come with "
                "multi-GPU training, ROADMAP slice 7")
        self.arch = arch
        self.dtype = _DTYPES[dtype] if isinstance(dtype, str) else dtype
        self.feature_dim = feature_dim(arch)
        kind, reps = BLOCKS[arch]
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = _bn(64)
        cin = 64
        for s, (width, rep) in enumerate(zip(STAGE_WIDTHS, reps)):
            blocks = []
            for b in range(rep):
                blocks.append(_Block(kind, cin, width, 2 if (s > 0 and b == 0) else 1))
                cin = width * (4 if kind == "bottleneck" else 1)
            setattr(self, f"layer{s + 1}", nn.Sequential(*blocks))
        self.fc = nn.Sequential(nn.Linear(self.feature_dim, head_dim), nn.ReLU(),
                                nn.Linear(head_dim, head_dim))
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    kh, kw = m.kernel_size
                    m.weight.normal_(0.0, math.sqrt(2.0 / (kh * kw * m.out_channels)),
                                     generator=gen)
                elif isinstance(m, nn.Linear):
                    bound = math.sqrt(1.0 / m.in_features)
                    m.weight.uniform_(-bound, bound, generator=gen)
                    m.bias.uniform_(-bound, bound, generator=gen)
        self.to(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor, with_head: bool = True) -> torch.Tensor:
        """``[B, H, W, 3] -> [B, head_dim]`` (``with_head``) or the pooled
        ``[B, feature_dim]``, in the compute dtype; train mode normalises by
        the batch's statistics and updates the running ones."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NCHW view of channels_last memory
        x = F.relu(self.bn1(conv2d(x, self.conv1)))
        x = F.max_pool2d(x, 3, 2, 1)
        for s in range(1, 5):
            x = getattr(self, f"layer{s}")(x)
        feats = x.mean(dim=(2, 3))  # global average pool
        if not with_head:
            return feats
        fc0, fc2 = self.fc[0], self.fc[2]
        y = F.relu(F.linear(feats, fc0.weight.to(self.dtype), fc0.bias.to(self.dtype)))
        return F.linear(y, fc2.weight.to(self.dtype), fc2.bias.to(self.dtype))

    def embed(self, video: torch.Tensor) -> torch.Tensor:
        """The SimCLR embedding of clips ``[B, T, H, W, 3]``: the pooled
        features of the last frame only, head stripped, in f32
        (``compute_embeddings_simclr.py:227``); the caller sets eval mode.
        The frames go in as given, as the JAX package's embed takes them
        (the benchmark readers give normalized f32)."""
        return self(video[:, -1], with_head=False).float()
