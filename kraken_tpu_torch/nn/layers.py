"""
kraken_tpu_torch.nn.layers
~~~~~~~~~~~~~~~~~~~~~~~~~~

VGSL layers as ``torch.nn.Module``s, the counterparts of the JAX package's
``nn/layers.py``.

All data is NCHW with C as the feature dimension (LSTM outputs go into C
like conv filters). Every layer's ``forward(x, seq_len=None,
output_shape=None)`` returns ``(y, seq_len)``: sequence lengths thread
through every layer with the reference's arithmetic so batched
variable-width lines stay correctly masked. ``get_shape(input)`` is the
VGSL shape arithmetic.

Parameters sit in small holder modules whose names make the reference's
torch state-dict keys (``co.weight``, ``lin.bias``,
``layer.weight_ih_l0``, ...), so kraken model files and the JAX package's
``state_dict()`` load without renaming. Fresh parameters follow the
reference's init (uniform(-0.1, 0.1) convolutions, Xavier linear,
orthogonal LSTM with a forget-gate bias of 1, zero peepholes, unit
LayerNorms) drawn from an explicit ``torch.Generator``.

Parameters are made with ``requires_grad=False``: inference keeps them so,
and training (:mod:`kraken_tpu_torch.train`) turns them on. With them on,
the LSTM recurrence and GroupNorm run as autograd functions whose backward
is a hand-written kernel on the card (``ops/lstm.py:LSTMRecurrence``,
``ops/groupnorm.py:GroupNormFunction``) and torch autograd through the
plain versions on the CPU.
"""
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from kraken_tpu_torch.ops.groupnorm import group_norm
from kraken_tpu_torch.ops.lstm import lstm_recurrence

__all__ = ['ActConv2D', 'Addition', 'Dropout', 'GroupNorm', 'Identity',
           'LinSoftmax', 'MaxPool', 'Parallel', 'Reshape', 'Series',
           'TransformerEncoder', 'TransposedSummarizingRNN']

Shape = tuple[int, int, int, int]


class _Params(nn.Module):
    """Holder of named parameters (the middle part of a state-dict key)."""

    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        for name, tensor in tensors.items():
            self.register_parameter(name, nn.Parameter(tensor, requires_grad=False))


def _uniform(shape, lo: float, hi: float, generator: torch.Generator) -> torch.Tensor:
    return torch.empty(shape).uniform_(lo, hi, generator=generator)


def _xavier_uniform(shape, generator: torch.Generator) -> torch.Tensor:
    return nn.init.xavier_uniform_(torch.empty(shape), generator=generator)


def _orthogonal(shape, generator: torch.Generator) -> torch.Tensor:
    return nn.init.orthogonal_(torch.empty(shape), generator=generator)


class Layer(nn.Module):
    """Base class: forward(x, seq_len, output_shape) -> (y, seq_len)."""

    def get_shape(self, input: Shape) -> Shape:
        return input


class Identity(Layer):
    """Identity (used for residual branches in parallel blocks)."""

    def forward(self, x, seq_len=None, output_shape=None):
        return x, seq_len


class Addition(Layer):
    """Splits `dim` into chunks of `chunk_size` and sums the chunks."""

    def __init__(self, dim: int, chunk_size: int):
        super().__init__()
        self.dim = dim
        self.chunk_size = chunk_size

    def forward(self, x, seq_len=None, output_shape=None):
        d = self.dim % x.dim()
        n = x.shape[d] // self.chunk_size
        shape = x.shape[:d] + (n, self.chunk_size) + x.shape[d + 1:]
        return x.reshape(shape).sum(dim=d), seq_len

    def get_shape(self, input: Shape) -> Shape:
        out = list(input)
        out[self.dim] = self.chunk_size
        return tuple(out)


class MaxPool(Layer):
    """2D max pooling, VALID padding."""

    def __init__(self, kernel_size: tuple[int, int], stride: tuple[int, int]):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.stride = tuple(stride)

    def forward(self, x, seq_len=None, output_shape=None):
        y = F.max_pool2d(x, self.kernel_size, self.stride)
        if seq_len is not None:
            seq_len = torch.floor((seq_len - (self.kernel_size[1] - 1) - 1).to(torch.float32)
                                  / self.stride[1] + 1).to(torch.int32)
        return y, seq_len

    def get_shape(self, input: Shape) -> Shape:
        return (input[0], input[1],
                int(math.floor((input[2] - (self.kernel_size[0] - 1) - 1) / self.stride[0] + 1) if input[2] != 0 else 0),
                int(math.floor((input[3] - (self.kernel_size[1] - 1) - 1) / self.stride[1] + 1) if input[3] != 0 else 0))


class Reshape(Layer):
    """
    Splits dimension `src_dim` into (part_a, part_b) and moves one part to
    another dimension. Dimensions are NCHW indices (already mapped from the
    VGSL 0/1/2/3 convention by the parser).
    """

    def __init__(self, src_dim: int, part_a: int, part_b: int, high: int, low: int):
        super().__init__()
        self.src_dim = src_dim
        self.part_a = part_a
        self.part_b = part_b
        self.high = high
        self.low = low

    def forward(self, x, seq_len=None, output_shape=None):
        initial_len = x.shape[3]
        shape = x.shape[:self.src_dim] + (self.part_a, self.part_b) + x.shape[self.src_dim + 1:]
        x = x.reshape(shape)
        dest = self.low
        src_dim = self.src_dim
        if self.high != src_dim:
            dest = self.high
        else:
            src_dim += 1
        perm = list(range(x.dim()))
        step = 1 if dest > src_dim else -1
        for i in range(src_dim, dest, step):
            perm[i], perm[i + step] = perm[i + step], perm[i]
        x = x.permute(perm)
        out = x.reshape(x.shape[:dest] + (x.shape[dest] * x.shape[dest + 1],) + x.shape[dest + 2:])
        if seq_len is not None:
            seq_len = (seq_len * (float(initial_len) / out.shape[3])).to(torch.int32)
        return out, seq_len

    def get_shape(self, input: Shape) -> Shape:
        probe = torch.zeros([x if x else 1 for x in input])
        out, _ = self.forward(probe)
        return tuple(out.shape)


def _dropout(x: torch.Tensor, p: float, mask_shape, generator: Optional[torch.Generator]):
    """x with elements kept with probability 1 - p (a mask of
    `mask_shape`, broadcast over x, drawn from `generator`) and scaled by
    1 / (1 - p), as the JAX package's dropout."""
    keep = torch.rand(mask_shape, generator=generator, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


class Dropout(Layer):
    """
    1D (per-element) or 2D (per-channel) dropout; identity in eval mode.
    In training the mask is one draw of (N, C, 1, 1) for dim 2 and of x's
    whole shape otherwise (the JAX package's shapes) from ``generator``, a
    ``torch.Generator`` on the layer's device that the trainer sets (torch's
    default generator when None).
    """

    def __init__(self, p: float, dim: int):
        super().__init__()
        self.p = p
        self.dim = dim
        self.generator: Optional[torch.Generator] = None

    def forward(self, x, seq_len=None, output_shape=None):
        if not self.training or self.p <= 0:
            return x, seq_len
        shape = x.shape[:2] + (1, 1) if self.dim == 2 else x.shape
        return _dropout(x, self.p, shape, self.generator), seq_len


class GroupNorm(Layer):
    """
    Group normalization, padding-aware: with sequence lengths the
    statistics cover the valid width only, and the pad columns are zeroed
    (so the next convolution reads zero padding). Runs in
    :func:`kraken_tpu_torch.ops.groupnorm.group_norm`: the CUDA kernel on
    the card, its plain version on the CPU.
    """

    def __init__(self, in_channels: int, num_groups: int, eps: float = 1e-5):
        super().__init__()
        self.in_channels = in_channels
        self.num_groups = num_groups
        self.eps = eps
        self.layer = _Params(weight=torch.ones(in_channels), bias=torch.zeros(in_channels))

    def forward(self, x, seq_len=None, output_shape=None):
        y = group_norm(x, self.layer.weight, self.layer.bias, self.num_groups, self.eps, seq_len)
        return y, seq_len


_ACTIVATIONS = {
    's': ('SIGMOID', torch.sigmoid),
    't': ('TANH', torch.tanh),
    'm': ('SOFTMAX', lambda x: torch.softmax(x, dim=1)),
    'r': ('RELU', torch.relu),
    'lr': ('LEAKYRELU', lambda x: F.leaky_relu(x, 0.01)),
    'l': ('LINEAR', lambda x: x),
}


class ActConv2D(Layer):
    """
    Convolution (or transposed convolution) + activation with 'same-ish'
    padding. Sigmoid-activated convolutions emit *logits*, as in the
    reference (the sigmoid is applied downstream).
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: tuple[int, int], stride: tuple[int, int],
                 nl: str = 'l', dilation: tuple[int, int] = (1, 1),
                 transposed: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = tuple(kernel_size)
        self.stride = tuple(stride)
        self.nl = nl
        self.dilation = tuple(dilation)
        self.transposed = transposed
        if transposed:
            w_shape = (in_channels, out_channels, *self.kernel_size)
        else:
            w_shape = (out_channels, in_channels, *self.kernel_size)
        self.co = _Params(weight=_uniform(w_shape, -0.1, 0.1, generator),
                          bias=_uniform((out_channels,), -0.1, 0.1, generator))

    @property
    def padding(self) -> tuple[int, int]:
        return tuple((self.dilation[i] * (self.kernel_size[i] - 1)) // 2 for i in range(2))

    def forward(self, x, seq_len=None, output_shape=None):
        w = self.co.weight.to(x.dtype)
        b = self.co.bias.to(x.dtype)
        p = self.padding
        if self.transposed:
            kh, kw = self.kernel_size
            dh, dw = self.dilation
            min_h = (x.shape[2] - 1) * self.stride[0] - 2 * p[0] + dh * (kh - 1) + 1
            min_w = (x.shape[3] - 1) * self.stride[1] - 2 * p[1] + dw * (kw - 1) + 1
            out_pad = (0, 0)
            if output_shape is not None:
                out_pad = (int(output_shape[0]) - min_h, int(output_shape[1]) - min_w)
            y = F.conv_transpose2d(x, w, b, stride=self.stride, padding=p,
                                   output_padding=out_pad, dilation=self.dilation)
        else:
            y = F.conv2d(x, w, b, stride=self.stride, padding=p, dilation=self.dilation)
        name, fn = _ACTIVATIONS[self.nl]
        if name != 'SIGMOID':
            y = fn(y)
        if seq_len is not None:
            if self.transposed:
                seq_len = torch.floor(((seq_len - 1) * self.stride[1] - 2 * p[1]
                                       + self.dilation[1] * (self.kernel_size[1] - 1) + 1)
                                      .to(torch.float32)).to(torch.int32)
            else:
                seq_len = torch.clamp(torch.floor(
                    (seq_len + 2 * p[1] - self.dilation[1] * (self.kernel_size[1] - 1) - 1).to(torch.float32)
                    / self.stride[1] + 1), min=1).to(torch.int32)
        return y, seq_len

    def get_shape(self, input: Shape, target_shape: Optional[Shape] = None) -> Shape:
        p = self.padding
        if self.transposed:
            min_y = int((input[2] - 1) * self.stride[0] - 2 * p[0] + self.dilation[0] * (self.kernel_size[0] - 1) + 1 if input[2] != 0 else 0)
            target_y = min_y if not target_shape or target_shape[2] == 0 else target_shape[2]
            min_x = int((input[3] - 1) * self.stride[1] - 2 * p[1] + self.dilation[1] * (self.kernel_size[1] - 1) + 1 if input[3] != 0 else 0)
            target_x = min_x if not target_shape or target_shape[3] == 0 else target_shape[3]
            return (input[0], self.out_channels,
                    min(min_y + self.stride[0] - 1, max(target_y, min_y)),
                    min(min_x + self.stride[1] - 1, max(target_x, min_x)))
        return (input[0], self.out_channels,
                int(max(math.floor((input[2] + 2 * p[0] - self.dilation[0] * (self.kernel_size[0] - 1) - 1) / self.stride[0] + 1), 1) if input[2] != 0 else 0),
                int(max(math.floor((input[3] + 2 * p[1] - self.dilation[1] * (self.kernel_size[1] - 1) - 1) / self.stride[1] + 1), 1) if input[3] != 0 else 0))


class LinSoftmax(Layer):
    """
    Linear projection over the feature (C) dimension. The softmax itself is
    applied downstream (decoding, losses).
    """

    def __init__(self, input_size: int, output_size: int, augmentation: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.augmentation = augmentation
        n_in = input_size + 1 if augmentation else input_size
        self.lin = _Params(weight=_xavier_uniform((output_size, n_in), generator),
                           bias=torch.zeros(output_size))

    def forward(self, x, seq_len=None, output_shape=None):
        # NCHW -> NWHC
        x = x.permute(0, 3, 2, 1)
        if self.augmentation:
            x = torch.cat([torch.ones(x.shape[:3] + (1,), dtype=x.dtype, device=x.device), x], dim=3)
        y = x @ self.lin.weight.t().to(x.dtype) + self.lin.bias.to(x.dtype)
        return y.permute(0, 3, 2, 1), seq_len

    def get_shape(self, input: Shape) -> Shape:
        return (input[0], self.output_size, input[2], input[3])


class TransposedSummarizingRNN(Layer):
    """
    LSTM with optional time-axis transposition (recurrence along the
    height) and summarization (only the last step is emitted).

    Parameter names and gate order (i, f, g, o) follow ``torch.nn.LSTM``.
    The biases ``bias_ih`` and ``bias_hh`` stay apart as torch names them
    and are summed at run time. The input projection of both directions is
    one ``torch.matmul``; the recurrence runs in
    :func:`kraken_tpu_torch.ops.lstm.lstm_recurrence`, both directions of a
    bidirectional layer in one call.

    ``legacy='ocropy'`` is the ocropy peephole LSTM (``Lbxo`` specs): no
    biases (the input carries a column of ones in front), peephole weights
    ``weight_{i,f,o}p_l0[_reverse]`` (H,), always both directions, and no
    mask: like the JAX package's ``_peephole_scan`` it runs over the whole
    padded width, its reverse direction starting at the padding's end;
    summarization still takes each row's last valid step. Only the
    bidirectional form exists: ``Lfxo``/``Lrxo`` raise a ValueError.
    """

    def __init__(self, input_size: int, hidden_size: int, direction: str = 'b',
                 transpose: bool = True, summarize: bool = True,
                 legacy: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if legacy == 'ocropy' and direction != 'b':
            raise ValueError(f'ocropy layers are bidirectional: L{direction}x/yo specs have no '
                             'meaning, use Lbxo or Lbyo')
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.direction = direction
        self.transpose = transpose
        self.summarize = summarize
        self.legacy = legacy
        # the recurrence; tests may replace it on an instance to run the
        # plain version on the same tensors
        self.recurrence = lstm_recurrence
        H = hidden_size
        params = {}
        for sfx in self._suffixes:
            params[f'weight_ih_l0{sfx}'] = _orthogonal((4 * H, self._in), generator)
            params[f'weight_hh_l0{sfx}'] = _orthogonal((4 * H, H), generator)
            if legacy == 'ocropy':
                for gate in 'ifo':
                    params[f'weight_{gate}p_l0{sfx}'] = torch.zeros(H)
            elif not legacy:
                bias = torch.zeros(4 * H)
                bias[H:2 * H] = 1.0
                params[f'bias_ih_l0{sfx}'] = bias
                params[f'bias_hh_l0{sfx}'] = bias.clone()
        self.layer = _Params(**params)

    @property
    def bidi(self) -> bool:
        return self.direction == 'b'

    @property
    def _suffixes(self) -> tuple[str, ...]:
        return ('', '_reverse') if self.bidi else ('',)

    @property
    def output_size(self) -> int:
        return 2 * self.hidden_size if self.bidi else self.hidden_size

    @property
    def _in(self) -> int:
        return self.input_size + 1 if self.legacy is not None else self.input_size

    def _run(self, x: torch.Tensor, lens: Optional[torch.Tensor]) -> torch.Tensor:
        """(B, T, C) -> (B, T, O)"""
        B, T, _ = x.shape
        H = self.hidden_size
        p = self.layer
        w_ih = torch.cat([getattr(p, f'weight_ih_l0{s}') for s in self._suffixes]).to(x.dtype)
        gates = x @ w_ih.t()
        if not self.legacy:
            b = torch.cat([getattr(p, f'bias_ih_l0{s}') + getattr(p, f'bias_hh_l0{s}')
                           for s in self._suffixes])
            gates = gates + b.to(x.dtype)
        D = len(self._suffixes)
        gates = gates.reshape(B, T, D, 4 * H)
        w_hh = torch.stack([getattr(p, f'weight_hh_l0{s}') for s in self._suffixes])
        peephole = None
        if self.legacy == 'ocropy':
            peephole = torch.stack([torch.stack([getattr(p, f'weight_{gate}p_l0{s}')
                                                 for gate in 'ifo']) for s in self._suffixes])
            # the peephole scan ignores the lengths
            lens = None
        if lens is None:
            mask = torch.ones((B, T), dtype=torch.bool, device=x.device)
        else:
            mask = torch.arange(T, device=x.device)[None, :] < lens.to(x.device)[:, None]
        # direction 0 runs forward, direction 1 (if any) backward
        ys = self.recurrence(gates, w_hh, mask, False, peephole=peephole)
        return ys.reshape(B, T, D * H)

    def forward(self, x, seq_len=None, output_shape=None):
        # NCHW -> HNWC
        x = x.permute(2, 0, 3, 1)
        if self.transpose:
            # HNWC -> WNHC (recurrence along H)
            x = x.transpose(0, 2)
        if self.legacy is not None:
            x = torch.cat([torch.ones(x.shape[:3] + (1,), dtype=x.dtype, device=x.device), x], dim=3)
        H_, N_, W_, C_ = x.shape
        x = x.reshape(H_ * N_, W_, C_)
        lens = None
        if not self.transpose and seq_len is not None:
            if H_ != 1:
                raise ValueError('Height must be 1 for batched sequence recurrence.')
            lens = seq_len
        ys = self._run(x, lens).reshape(H_, N_, W_, self.output_size)
        if self.summarize:
            if lens is not None:
                # last valid step per row
                idx = torch.clamp(lens.to(ys.device).long() - 1, 0, W_ - 1)
                ys = torch.take_along_dim(ys, idx[None, :, None, None], dim=2)
            else:
                ys = ys[:, :, -1:, :]
        if self.transpose:
            ys = ys.transpose(0, 2)
        # HNWO -> NOHW
        return ys.permute(1, 3, 0, 2), seq_len

    def get_shape(self, input: Shape) -> Shape:
        if self.summarize:
            hw = (1, input[3]) if self.transpose else (input[2], 1)
        else:
            hw = (input[2], input[3])
        return (input[0], self.output_size) + hw


class TransformerEncoder(Layer):
    """
    Pre-LN transformer encoder block over the width axis (the VGSL ``Te``
    block of the JAX package, ``nn/layers.py:TransformerEncoder``): LN →
    multi-head self-attention with rotary position embeddings → residual,
    LN → GELU FFN → residual. Positions beyond a row's ``seq_len`` are
    masked out of the softmax (an additive -1e9 on the keys, the lengths
    clipped to [1, W]) and zeroed on output. Requires H == 1.

    It follows the JAX block op for op, in torch ops: LayerNorm in float32
    with the population variance and eps 1e-5; RoPE on q and k only,
    rotating interleaved pairs (``x[..., 0::2]``, ``x[..., 1::2]``) by
    ``pos · 10000^(-2k/d)`` in float32; scores ``q @ kᵀ`` in float32 over
    ``sqrt(hd)``, then softmax; the tanh approximation of GELU
    (``jax.nn.gelu``'s default). Dropout acts only in training, on the
    attention weights and the FFN's hidden layer, its masks drawn from
    ``generator`` as :class:`Dropout` draws them.
    """

    def __init__(self, input_size: int, heads: int, dim: int, ffn_dim: int,
                 dropout: float = 0.1, generator: Optional[torch.Generator] = None):
        super().__init__()
        if input_size != dim:
            raise ValueError(f'Te input channels ({input_size}) must equal the block dim '
                             f'({dim}); project with e.g. Cl1,1,{{dim}} first')
        if dim % heads:
            raise ValueError(f'Te dim {dim} not divisible by heads {heads}')
        if (dim // heads) % 2:
            raise ValueError('Te head dim must be even for rotary embeddings')
        self.input_size = input_size
        self.heads = heads
        self.dim = dim
        self.ffn_dim = ffn_dim
        self.dropout = dropout
        D, F_ = dim, ffn_dim
        self.norm1 = _Params(weight=torch.ones(D), bias=torch.zeros(D))
        self.attn = nn.Module()
        self.attn.qkv = _Params(weight=_xavier_uniform((3 * D, D), generator),
                                bias=torch.zeros(3 * D))
        self.attn.out = _Params(weight=_xavier_uniform((D, D), generator), bias=torch.zeros(D))
        self.norm2 = _Params(weight=torch.ones(D), bias=torch.zeros(D))
        self.ffn = nn.Module()
        self.ffn.lin1 = _Params(weight=_xavier_uniform((F_, D), generator), bias=torch.zeros(F_))
        self.ffn.lin2 = _Params(weight=_xavier_uniform((D, F_), generator), bias=torch.zeros(D))
        # the source of the training dropout masks (see Dropout)
        self.generator: Optional[torch.Generator] = None

    @property
    def output_size(self) -> int:
        return self.dim

    @staticmethod
    def _layernorm(x: torch.Tensor, p: _Params, eps: float = 1e-5) -> torch.Tensor:
        x32 = x.to(torch.float32)
        mean = x32.mean(dim=-1, keepdim=True)
        var = x32.var(dim=-1, keepdim=True, unbiased=False)
        w, b = p.weight.to(x.dtype), p.bias.to(x.dtype)
        return ((x32 - mean) * torch.rsqrt(var + eps) * w + b).to(x.dtype)

    @staticmethod
    def _rope(x: torch.Tensor) -> torch.Tensor:
        """Rotary position embedding over (B, h, W, d), interleaved pairs."""
        d, W = x.shape[-1], x.shape[-2]
        pos = torch.arange(W, dtype=torch.float32, device=x.device)[:, None]
        inv = 10000.0 ** (-torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
        ang = pos * inv[None, :]
        cos, sin = torch.cos(ang), torch.sin(ang)
        x1, x2 = x[..., 0::2], x[..., 1::2]
        y1 = x1 * cos - x2 * sin
        y2 = x1 * sin + x2 * cos
        return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)

    @staticmethod
    def _linear(x: torch.Tensor, p: _Params) -> torch.Tensor:
        return x @ p.weight.to(x.dtype).t() + p.bias.to(x.dtype)

    def _block(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """(B, W, D) with an additive float32 mask (B, 1, 1, W) or None."""
        B, W, D = x.shape
        h, hd = self.heads, D // self.heads
        y = self._layernorm(x, self.norm1)
        q, k, v = self._linear(y, self.attn.qkv).chunk(3, dim=-1)

        def heads_of(t):
            return t.reshape(B, W, h, hd).transpose(1, 2)  # (B, h, W, hd)
        q, k, v = heads_of(q), heads_of(k), heads_of(v)
        q, k = self._rope(q), self._rope(k)
        scores = (q @ k.transpose(-1, -2)).to(torch.float32) / math.sqrt(hd)
        if mask is not None:
            scores = scores + mask
        attn = torch.softmax(scores, dim=-1).to(x.dtype)
        if self.training and self.dropout > 0:
            attn = _dropout(attn, self.dropout, attn.shape, self.generator)
        ctx = (attn @ v).transpose(1, 2).reshape(B, W, D)
        x = x + self._linear(ctx, self.attn.out)
        y = self._layernorm(x, self.norm2)
        y = F.gelu(self._linear(y, self.ffn.lin1), approximate='tanh')
        if self.training and self.dropout > 0:
            y = _dropout(y, self.dropout, y.shape, self.generator)
        return x + self._linear(y, self.ffn.lin2)

    def forward(self, x, seq_len=None, output_shape=None):
        N, C, H, W = x.shape
        if H != 1:
            raise ValueError('Te blocks require height 1 (apply S1(1x0)1,3 first)')
        y = x[:, :, 0, :].transpose(1, 2)  # (N, W, C)
        mask = None
        if seq_len is not None:
            lens = torch.clamp(seq_len.to(x.device), 1, W)
            valid = torch.arange(W, device=x.device)[None, :] < lens[:, None]
            mask = torch.where(valid, 0.0, -1e9).to(torch.float32)[:, None, None, :]
        y = self._block(y, mask)
        if seq_len is not None:
            y = y * valid[:, :, None].to(y.dtype)
        return y.transpose(1, 2)[:, :, None, :], seq_len

    def get_shape(self, input: Shape) -> Shape:
        return (input[0], self.dim, 1, input[3])


class Series(Layer):
    """
    Sequential container threading (x, seq_len); a target output_shape is
    forwarded only to the final module.
    """

    def __init__(self, layers: tuple = (), names: tuple = ()):
        super().__init__()
        for name, layer in zip(names, layers):
            self.add_module(name, layer)

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(self._modules)

    @property
    def layers(self) -> tuple[Layer, ...]:
        return tuple(self._modules.values())

    def forward(self, x, seq_len=None, output_shape=None):
        n = len(self._modules)
        for i, layer in enumerate(self._modules.values()):
            x, seq_len = layer(x, seq_len, output_shape=output_shape if i == n - 1 else None)
        return x, seq_len

    def get_shape(self, input: Shape) -> Shape:
        for layer in self._modules.values():
            input = layer.get_shape(input)
        return input


class Parallel(Series):
    """
    Parallel container concatenating branch outputs on the channel dim; the
    first branch's spatial output shape becomes the target for later
    branches.
    """

    def forward(self, x, seq_len=None, output_shape=None):
        outputs = []
        out_len = seq_len
        for layer in self._modules.values():
            y, out_len = layer(x, seq_len, output_shape=output_shape)
            outputs.append(y)
            if output_shape is None:
                output_shape = y.shape[2:]
        return torch.cat(outputs, dim=1), out_len

    def get_shape(self, input: Shape) -> Shape:
        shapes = [layer.get_shape(input) for layer in self._modules.values()]
        channels = sum(s[1] for s in shapes)
        return (shapes[0][0], channels, *shapes[0][2:])
