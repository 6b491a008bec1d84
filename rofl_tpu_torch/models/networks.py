"""Model zoo — counterpart of ``rofl_tpu.models.networks`` as ``torch.nn``
modules: MnistMLP (mnist_dev), MnistCNN, LeNet5 (cifar_lenet5), ResNet18 with
GroupNorm, and CharLSTM (shakespeare).

Each parameter carries its Flax name, layout and initializer, so that the
flat vector of a network is ``ravel_pytree`` of the JAX package's parameters:
submodules are named as Flax names them (``Dense_0``, ``ResNetBlock_3``,
``OptimizedLSTMCell_1/hf``), Dense kernels are (in, out), Conv kernels HWIO,
and ``leaves`` sorts the paths as ``ravel_pytree`` sorts dict keys. Inputs
are NHWC, as in the JAX package; the convolutions run in NCHW inside and
flatten back in NHWC order.

Flax's conventions that torch's layers do not share, written out here:
``SAME`` padding is asymmetric at stride 2 (low = total // 2, the rest
high), GroupNorm's epsilon is 1e-6 and its variance E[x²] - E[x]², and the
LSTM cell is Flax's ``OptimizedLSTMCell`` (gates i, f, g, o; the bias on the
hidden projection only; a zero carry).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from . import flax_init


class Layer(nn.Module):
    """A leaf module of Flax: its parameters in creation order, each with its
    Flax shape and initializer name."""

    def __init__(self, specs: Sequence[tuple[str, tuple, str]]):
        super().__init__()
        self.init_names = {}
        self.creation_order = []
        for name, shape, init in specs:
            self.register_parameter(name, nn.Parameter(torch.zeros(shape)))
            self.init_names[name] = init
            self.creation_order.append(name)


class Dense(Layer):
    def __init__(self, d_in: int, d_out: int, use_bias: bool = True, kernel_init="lecun_normal"):
        specs = [("kernel", (d_in, d_out), kernel_init)]
        if use_bias:
            specs.append(("bias", (d_out,), "zeros"))
        super().__init__(specs)
        self.use_bias = use_bias

    def forward(self, x):
        y = x @ self.kernel
        return y + self.bias if self.use_bias else y


def same_padding(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding of one spatial axis: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Conv(Layer):
    """``nn.Conv`` on NCHW activations with an HWIO kernel."""

    def __init__(self, d_in: int, d_out: int, kernel_size, strides=1, padding="SAME",
                 use_bias: bool = True):
        kh, kw = kernel_size
        specs = [("kernel", (kh, kw, d_in, d_out), "lecun_normal")]
        if use_bias:
            specs.append(("bias", (d_out,), "zeros"))
        super().__init__(specs)
        self.kernel_size = (kh, kw)
        self.strides = (strides, strides) if isinstance(strides, int) else tuple(strides)
        self.padding = padding
        self.use_bias = use_bias

    def forward(self, x):
        if self.padding == "SAME":
            (kh, kw), (sh, sw) = self.kernel_size, self.strides
            top, bottom = same_padding(x.shape[2], kh, sh)
            left, right = same_padding(x.shape[3], kw, sw)
            x = F.pad(x, (left, right, top, bottom))
        weight = self.kernel.permute(3, 2, 0, 1)
        return F.conv2d(x, weight, self.bias if self.use_bias else None, self.strides)


class GroupNorm(Layer):
    """``nn.GroupNorm`` on NCHW activations: statistics over each group's
    channels and the spatial axes, epsilon 1e-6."""

    def __init__(self, channels: int, num_groups: int, epsilon: float = 1e-6):
        super().__init__([("scale", (channels,), "ones"), ("bias", (channels,), "zeros")])
        if channels % num_groups:
            raise ValueError(f"{channels} channels do not split into {num_groups} groups")
        self.num_groups = num_groups
        self.epsilon = epsilon

    def forward(self, x):
        b, c, h, w = x.shape
        g = x.reshape(b, self.num_groups, c // self.num_groups, h, w)
        mean = g.mean((2, 3, 4), keepdim=True)
        mean2 = (g * g).mean((2, 3, 4), keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.epsilon).expand_as(g).reshape(b, c, h, w)
        mul = mul * self.scale.reshape(1, c, 1, 1)
        y = (g - mean).reshape(b, c, h, w) * mul
        return y + self.bias.reshape(1, c, 1, 1)


class Embed(Layer):
    def __init__(self, num_embeddings: int, features: int):
        super().__init__([("embedding", (num_embeddings, features), "embed_normal")])

    def forward(self, x):
        if torch.is_floating_point(x) or torch.is_complex(x):
            raise ValueError("Input type must be an integer or unsigned integer.")
        return self.embedding[x]


def nhwc_to_nchw(x):
    return x.permute(0, 3, 1, 2)


def flatten_nhwc(x):
    """An NCHW activation flattened as Flax flattens its NHWC one."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class MnistMLP(nn.Module):
    """Small MNIST MLP (the mnist_dev family: 19 090 parameters at hidden=24)."""

    def __init__(self, hidden: int = 24, n_classes: int = 10, in_features: int = 784):
        super().__init__()
        self.Dense_0 = Dense(in_features, hidden)
        self.Dense_1 = Dense(hidden, n_classes)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        return self.Dense_1(F.relu(self.Dense_0(x)))


class MnistCNN(nn.Module):
    def __init__(self, n_classes: int = 10):
        super().__init__()
        self.Conv_0 = Conv(1, 16, (5, 5), strides=2)
        self.Conv_1 = Conv(16, 32, (5, 5), strides=2)
        self.Dense_0 = Dense(7 * 7 * 32, n_classes)

    def forward(self, x):
        x = F.relu(self.Conv_0(nhwc_to_nchw(x)))
        x = F.relu(self.Conv_1(x))
        return self.Dense_0(flatten_nhwc(x))


class LeNet5(nn.Module):
    """LeNet5 (cifar_lenet5: VALID convolutions, 62 006 parameters)."""

    def __init__(self, n_classes: int = 10):
        super().__init__()
        self.Conv_0 = Conv(3, 6, (5, 5), padding="VALID")
        self.Conv_1 = Conv(6, 16, (5, 5), padding="VALID")
        self.Dense_0 = Dense(400, 120)
        self.Dense_1 = Dense(120, 84)
        self.Dense_2 = Dense(84, n_classes)

    def forward(self, x):
        x = F.avg_pool2d(F.relu(self.Conv_0(nhwc_to_nchw(x))), 2, 2)
        x = F.avg_pool2d(F.relu(self.Conv_1(x)), 2, 2)
        x = F.relu(self.Dense_0(flatten_nhwc(x)))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x)


class ResNetBlock(nn.Module):
    def __init__(self, d_in: int, filters: int, strides: int = 1):
        super().__init__()
        groups = min(32, filters)
        self.Conv_0 = Conv(d_in, filters, (3, 3), strides, use_bias=False)
        self.GroupNorm_0 = GroupNorm(filters, groups)
        self.Conv_1 = Conv(filters, filters, (3, 3), use_bias=False)
        self.GroupNorm_1 = GroupNorm(filters, groups)
        # Flax adds the projection when the residual's shape differs from y's
        self.project = d_in != filters or strides != 1
        if self.project:
            self.Conv_2 = Conv(d_in, filters, (1, 1), strides, use_bias=False)
            self.GroupNorm_2 = GroupNorm(filters, groups)

    def forward(self, x):
        y = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        y = self.GroupNorm_1(self.Conv_1(y))
        residual = self.GroupNorm_2(self.Conv_2(x)) if self.project else x
        return F.relu(residual + y)


class ResNet18(nn.Module):
    """ResNet-18 with GroupNorm (32 groups in the stem)."""

    def __init__(self, n_classes: int = 10, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 width: int = 64):
        super().__init__()
        self.Conv_0 = Conv(3, width, (3, 3), use_bias=False)
        self.GroupNorm_0 = GroupNorm(width, 32)
        d_in, k = width, 0
        self.blocks = []
        for i, n_blocks in enumerate(stage_sizes):
            filters = width * 2 ** i
            for b in range(n_blocks):
                strides = 2 if b == 0 and i > 0 else 1
                name = f"ResNetBlock_{k}"
                self.add_module(name, ResNetBlock(d_in, filters, strides))
                self.blocks.append(name)
                d_in, k = filters, k + 1
        self.Dense_0 = Dense(d_in, n_classes)

    def forward(self, x):
        x = F.relu(self.GroupNorm_0(self.Conv_0(nhwc_to_nchw(x))))
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.Dense_0(x.mean((2, 3)))


class OptimizedLSTMCell(nn.Module):
    """Flax's ``OptimizedLSTMCell``: input kernels ``ii`` … ``io`` (lecun
    normal, no bias), hidden kernels ``hi`` … ``ho`` (orthogonal) with biases."""

    GATES = ("i", "f", "g", "o")

    def __init__(self, d_in: int, hidden: int):
        super().__init__()
        for gate in self.GATES:
            self.add_module(f"i{gate}", Dense(d_in, hidden, use_bias=False))
            self.add_module(f"h{gate}", Dense(hidden, hidden, kernel_init="orthogonal"))

    def scan(self, xs):
        """nn.RNN over (B, T, d_in) from a zero carry: every step's h."""
        i_kernel = torch.cat([getattr(self, f"i{g}").kernel for g in self.GATES], dim=-1)
        h_kernel = torch.cat([getattr(self, f"h{g}").kernel for g in self.GATES], dim=-1)
        h_bias = torch.cat([getattr(self, f"h{g}").bias for g in self.GATES], dim=-1)
        b, t, _ = xs.shape
        hidden = h_kernel.shape[0]
        c = xs.new_zeros(b, hidden)
        h = xs.new_zeros(b, hidden)
        dense_i = (xs @ i_kernel).unbind(1)
        out = []
        for step in range(t):
            dense_h = h @ h_kernel + h_bias
            hi, hf, hg, ho = dense_h.split(hidden, dim=-1)
            ii, if_, ig, io = dense_i[step].split(hidden, dim=-1)
            i = torch.sigmoid(hi + ii)
            f = torch.sigmoid(hf + if_)
            g = torch.tanh(hg + ig)
            o = torch.sigmoid(ho + io)
            c = f * c + i * g
            h = o * torch.tanh(c)
            out.append(h)
        return torch.stack(out, dim=1)


class CharLSTM(nn.Module):
    """Character LSTM for the Shakespeare next-char task: Embed(vocab, 8),
    `layers` stacked LSTMs, the last step's h → vocab logits."""

    def __init__(self, vocab: int = 90, hidden: int = 128, layers: int = 2):
        super().__init__()
        self.Embed_0 = Embed(vocab, 8)
        d_in = 8
        self.cells = []
        for k in range(layers):
            name = f"OptimizedLSTMCell_{k}"
            self.add_module(name, OptimizedLSTMCell(d_in, hidden))
            self.cells.append(name)
            d_in = hidden
        self.Dense_0 = Dense(hidden, vocab)

    def forward(self, x):
        h = self.Embed_0(x)
        for name in self.cells:
            h = getattr(self, name).scan(h)
        return self.Dense_0(h[:, -1])


MODEL_REGISTRY = {
    "mnist_dev": lambda: (MnistMLP(), (1, 28, 28, 1)),
    "mnist_cnn": lambda: (MnistCNN(), (1, 28, 28, 1)),
    "cifar_lenet5": lambda: (LeNet5(), (1, 32, 32, 3)),
    "resnet18": lambda: (ResNet18(), (1, 32, 32, 3)),
    "shakespeare": lambda: (CharLSTM(), (1, 80)),
}


def build_model(name: str):
    """(module, example input shape) by family name; ``<family>_intrinsic…``
    names the same network (``networks.py:150-155``)."""
    base = name.split("_intrinsic")[0]
    if base not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name}")
    return MODEL_REGISTRY[base]()


# -- parameters as one flat vector ----------------------------------------------------


def leaves(module: nn.Module) -> list[tuple[tuple[str, ...], nn.Parameter]]:
    """(Flax path, parameter) in ``ravel_pytree``'s order: dict keys sorted at
    every level."""
    items = [(tuple(name.split(".")), p) for name, p in module.named_parameters()]
    return sorted(items, key=lambda item: item[0])


def layout(module: nn.Module) -> list[tuple[str, int, tuple]]:
    """("a/b/kernel", offset, Flax shape) of every leaf in the flat vector."""
    out, offset = [], 0
    for path, p in leaves(module):
        out.append(("/".join(path), offset, tuple(p.shape)))
        offset += p.numel()
    return out


def unflatten(module: nn.Module, flat: torch.Tensor) -> dict[str, torch.Tensor]:
    """The parameters of `flat` as views for ``torch.func.functional_call``
    (gradients flow back into `flat`)."""
    params, offset = {}, 0
    for path, p in leaves(module):
        params[".".join(path)] = flat[offset:offset + p.numel()].view(p.shape)
        offset += p.numel()
    if offset != flat.numel():
        raise ValueError(f"flat vector of {flat.numel()} values for {offset} parameters")
    return params


def init_flat(module: nn.Module, seed: int, device="cuda",
              fix_separator: bool = False) -> torch.Tensor:
    """``ravel_pytree(module.init(PRNGKey(seed), x))`` of the JAX counterpart:
    each parameter from the key of its scope's path and its place in the
    scope's creation order."""
    root = flax_init.R.PRNGKey(seed)
    parts = []
    for path, p in leaves(module):
        *scope_path, name = path
        owner = module.get_submodule(".".join(scope_path))
        counter = owner.creation_order.index(name) + 1
        key = flax_init.param_key(root, tuple(scope_path), counter, fix_separator)
        init = flax_init.INITIALIZERS[owner.init_names[name]]
        parts.append(init(key, tuple(p.shape), device).reshape(-1))
    return torch.cat(parts).to(torch.float32)

