"""
kraken_tpu_torch.vgsl
~~~~~~~~~~~~~~~~~~~~~

VGSL (Variable-size Graph Specification Language) compiler for PyTorch.

Parses Tesseract-style VGSL strings into a tree of ``torch.nn.Module``
layers (:mod:`kraken_tpu_torch.nn.layers`) with the grammar, shape
arithmetic, layer auto-naming and spec round-tripping of the JAX package's
``vgsl.py`` (and of the reference engine), so kraken model files
(safetensors/CoreML) and the JAX package's weights load unmodified.

Spec syntax::

    [1,48,0,1 Cr3,3,32 Do0.1,2 Mp2,2 ... Lbx100 Do O1c10]

    C[T](s|t|r|l|lr|m)<y>,<x>,<d>[,<ystr>,<xstr>][,<ydil>,<xdil>]  conv
    L(f|r|b)(x|y)[s][c|o]<n>    LSTM (dir, axis, summarize, legacy)
    S<d>(<a>x<b>)<e>,<f>        reshape/split-move
    Mp<y>,<x>[,<ystr>,<xstr>]   max pool
    Do[<p>][,<dim>]             dropout
    Gn<groups>                  group norm
    A<dim>,<chunk>              chunked addition
    I                           identity
    Te<h>,<d>,<f>[,<p>]         transformer encoder block (the JAX package's
                                extension): h heads, width d, FFN f,
                                dropout p/100 (default 0.1)
    O(2|1|0)(l|s|c)[a]<n>       output layer
    [...]  serial block         (...)  parallel block

The ocropy peephole LSTM exists only bidirectional (``Lbxo``, ``Lbyo``):
``Lfxo``/``Lrxo`` raise a ValueError. Not ported yet (ROADMAP.md): ``W``
wav2vec2 masking, whose specs raise ``NotImplementedError``.
"""
import json
import logging
import math
import re
from typing import Any, Optional, Sequence, Union

import numpy as np
import torch

from kraken_tpu_torch.codec import Codec
from kraken_tpu_torch.exceptions import KrakenInvalidModelException
from kraken_tpu_torch.nn import layers

__all__ = ['VGSLModel', 'parse_vgsl']

logger = logging.getLogger(__name__)


class _Block:
    """A named spec block (reconstructs `Cr{C_0}3,3,32`-style named specs)."""

    def __init__(self, block: str, layer_type: str, name: Optional[str], idx: int):
        if name:
            name = name[1:-1]
        else:
            name = '{}_{}'.format(re.sub(r'\W+', '_', layer_type), idx)
        block = re.sub(r'\{.+\}', '', block)
        parts = re.split(r'(^[^\d]+)', block)
        parts.insert(-1, '{%s}' % name)
        self.block = ''.join(parts)
        self.name = name
        self.layer_type = layer_type

    def __str__(self):
        return self.block


class _Parser:
    """Stateful VGSL parser producing (layer tree, named spec, output shape)."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        self.idx = -1
        self.generator = generator

    # ------------------------------------------------------------------ ops
    def _rnn(self, input, block, target_output_shape=None):
        m = re.match(r'(?P<type>L|G)(?P<dir>f|r|b)(?P<dim>x|y)(?P<sum>s)?(?P<legacy>c|o)?(?P<name>{\w+})?(?P<out>\d+)', block)
        if not m:
            return None
        legacy = {'c': 'clstm', 'o': 'ocropy'}.get(m.group('legacy'))
        layer = layers.TransposedSummarizingRNN(input[1],
                                                int(m.group('out')),
                                                m.group('dir'),
                                                m.group('dim') == 'y',
                                                m.group('sum') == 's',
                                                legacy,
                                                generator=self.generator)
        self.idx += 1
        return layer.get_shape(input), _Block(block, m.group('type'), m.group('name'), self.idx), layer

    def _transformer(self, input, block, target_output_shape=None):
        # Te<heads>,<dim>,<ffn>[,<dropout·100>]: one pre-LN rotary-attention
        # encoder block over the width axis (the JAX package's grammar
        # extension; nn/layers.py TransformerEncoder)
        m = re.match(r'Te(?P<name>{\w+})?(?P<heads>\d+),(?P<dim>\d+),'
                     r'(?P<ffn>\d+)(?:,(?P<do>\d+))?$', block)
        if not m:
            return None
        layer = layers.TransformerEncoder(
            input[1], int(m.group('heads')), int(m.group('dim')), int(m.group('ffn')),
            int(m.group('do')) / 100.0 if m.group('do') else 0.1,
            generator=self.generator)
        self.idx += 1
        return layer.get_shape(input), _Block(block, 'Te', m.group('name'), self.idx), layer

    def _dropout(self, input, block, target_output_shape=None):
        m = re.match(r'(?P<type>Do)(?P<name>{\w+})?(?P<p>(\d+(\.\d*)?|\.\d+))?(,(?P<dim>\d+))?', block)
        if not m:
            return None
        layer = layers.Dropout(float(m.group('p')) if m.group('p') else 0.5,
                               int(m.group('dim')) if m.group('dim') else 1)
        self.idx += 1
        return input, _Block(block, m.group('type'), m.group('name'), self.idx), layer

    def _addition(self, input, block, target_output_shape=None):
        m = re.match(r'(?P<type>A)(?P<name>{\w+})?(?P<dim>\d+),(?P<chunk_size>\d+)', block)
        if not m:
            return None
        dim = int(m.group('dim'))
        if dim > 3:
            raise ValueError(f'Invalid dimension {dim} in addition block')
        # VGSL dim convention (0=batch, 1=height, 2=width, 3=feature) -> NCHW
        dim = {0: 0, 1: 2, 2: 3, 3: 1}[dim]
        layer = layers.Addition(dim=dim, chunk_size=int(m.group('chunk_size')))
        self.idx += 1
        return layer.get_shape(input), _Block(block, m.group('type'), m.group('name'), self.idx), layer

    def _identity(self, input, block, target_output_shape=None):
        m = re.match(r'(?P<type>I)(?P<name>{\w+})?$', block)
        if not m:
            return None
        self.idx += 1
        return input, _Block(block, m.group('type'), m.group('name'), self.idx), layers.Identity()

    def _groupnorm(self, input, block, target_output_shape=None):
        m = re.match(r'(?P<type>Gn)(?P<name>{\w+})?(?P<groups>\d+)', block)
        if not m:
            return None
        layer = layers.GroupNorm(input[1], int(m.group('groups')))
        self.idx += 1
        return input, _Block(block, m.group('type'), m.group('name'), self.idx), layer

    def _wav2vec2(self, input, block, target_output_shape=None):
        # W<dim>,<width>,<prob>,<neg>: pretraining mask, part of the
        # pretraining slice
        if not re.match(r'(?P<type>W)(?P<name>{\w+})(?P<final_dim>\d+),(?P<mask_width>\d+),'
                        r'(?P<mask_prob>(\d+(\.\d*)?|\.\d+)),(?P<num_negatives>\d+)', block):
            return None
        raise NotImplementedError('the wav2vec2 masking layer (W specs) is not ported yet: '
                                  'ROADMAP.md, queue 1, item 11')

    def _conv(self, input, block, target_output_shape=None):
        m = re.match(r'(?P<type>C)(?P<trans>T)?(?P<nl>s|t|r|l|lr|m)(?P<name>{\w+})?(\d+),'
                     r'(\d+),(?P<out>\d+)(,(?P<stride_y>\d+),(?P<stride_x>\d+))?'
                     r'(,(?P<dilation_y>\d+),(?P<dilation_x>\d+))?', block)
        if not m:
            return None
        layer = layers.ActConv2D(
            input[1], int(m.group('out')),
            (int(m.group(5)), int(m.group(6))),
            (int(m.group('stride_y')), int(m.group('stride_x'))) if m.group('stride_x') else (1, 1),
            m.group('nl'),
            (int(m.group('dilation_y')), int(m.group('dilation_x'))) if m.group('dilation_x') else (1, 1),
            m.group('trans') is not None,
            generator=self.generator)
        self.idx += 1
        return layer.get_shape(input, target_output_shape), _Block(block, m.group('type'), m.group('name'), self.idx), layer

    def _maxpool(self, input, block, target_output_shape=None):
        m = re.match(r'(?P<type>Mp)(?P<name>{\w+})?(\d+),(\d+)(?:,(\d+),(\d+))?', block)
        if not m:
            return None
        kernel = (int(m.group(3)), int(m.group(4)))
        stride = (kernel[0] if not m.group(5) else int(m.group(5)),
                  kernel[1] if not m.group(6) else int(m.group(6)))
        layer = layers.MaxPool(kernel, stride)
        self.idx += 1
        return layer.get_shape(input), _Block(block, m.group('type'), m.group('name'), self.idx), layer

    def _reshape(self, input, block, target_output_shape=None):
        m = re.match(r'(?P<type>S)(?P<name>{\w+})?(?P<dim>\d+)\((?P<part_a>\d+)x'
                     r'(?P<part_b>\d+)\)(?P<high>\d+),(?P<low>\d+)', block)
        if not m:
            return None
        src_dim, part_a, part_b = int(m.group('dim')), int(m.group('part_a')), int(m.group('part_b'))
        high, low = int(m.group('high')), int(m.group('low'))
        if part_a == 0:
            part_a = -1
        elif part_b == 0:
            part_b = -1
        if src_dim != high and src_dim != low:
            raise ValueError(f'Either high ({high}) or low ({low}) must be source dimension ({src_dim})')
        if part_a == -1 and part_b == -1:
            raise ValueError('Only one size may be -1')
        dim_map = {0: 0, 1: 2, 2: 3, 3: 1}
        layer = layers.Reshape(dim_map[src_dim], part_a, part_b, dim_map[high], dim_map[low])
        self.idx += 1
        return layer.get_shape(input), _Block(block, m.group('type'), m.group('name'), self.idx), layer

    def _output(self, input, block, target_output_shape=None):
        m = re.match(r'(O)(?P<name>{\w+})?(?P<dim>2|1|0)(?P<type>l|s|c)(?P<aug>a)?(?P<out>\d+)', block)
        if not m:
            return None
        dim = int(m.group('dim'))
        nl = m.group('type')
        outdim = int(m.group('out'))
        if dim == 0:
            raise ValueError('categorical (c) output layers are not implemented')
        if nl == 'c' and dim == 2:
            raise ValueError('heatmap (2D) outputs cannot train with CTC')
        if nl in ('l', 's') and outdim >= 1:
            self.criterion = 'bce'
        elif nl == 'c':
            self.criterion = 'ctc'
        else:
            raise ValueError('output spec not recognized')
        if dim == 2:
            # heatmap output: 1x1 conv (sigmoid emits logits, see ActConv2D)
            act = 's' if nl == 'l' else 'm'
            layer = layers.ActConv2D(input[1], outdim, (1, 1), (1, 1), act,
                                     generator=self.generator)
            self.idx += 1
            return layer.get_shape(input), _Block(block, m.group('type'), m.group('name'), self.idx), layer
        layer = layers.LinSoftmax(input[1], outdim, bool(m.group('aug')),
                                  generator=self.generator)
        self.idx += 1
        return layer.get_shape(input), _Block(block, m.group(1), m.group('name'), self.idx), layer

    # -------------------------------------------------------------- blocks
    @staticmethod
    def _bracket_count(block: str, op: str, cl: str, other_op: str, other_cl: str) -> int:
        count = 0
        for c in block:
            if c == op:
                count += 1
            elif c != other_op:
                break
        for c in block[::-1]:
            if c == cl:
                count -= 1
            elif c != other_cl:
                break
        return count

    def _series(self, input, blocks, idx, target_output_shape=None):
        if not blocks[idx] or blocks[idx][0] != '[':
            return None, None, None
        if blocks[idx][-1] == ']':
            named_spec, layer, oshape = self.parse(input, [blocks[idx][1:-1]])
            named_spec[0].block = '[' + named_spec[0].block + ']'
            return oshape, named_spec, layer
        depth = 0
        for bl_idx, block in enumerate(blocks[idx:]):
            depth += self._bracket_count(block, '[', ']', '(', ')')
            if depth == 0:
                break
        if depth:
            raise ValueError('Unbalanced brackets in VGSL spec')
        inner = [blocks[idx][1:]] + blocks[idx + 1:idx + bl_idx] + [blocks[idx + bl_idx][:-1]]
        named_spec, layer, oshape = self.parse(input, inner, target_output_shape=target_output_shape)
        named_spec[0].block = '[' + named_spec[0].block
        named_spec[-1].block = named_spec[-1].block + ']'
        return oshape, named_spec, layer

    def _parallel(self, input, blocks, idx, target_output_shape=None):
        if not blocks[idx] or blocks[idx][0] != '(':
            return None, None, None
        if blocks[idx][-1] == ')':
            named_spec, layer, oshape = self.parse(input, [blocks[idx][1:-1]], parallel=True)
            named_spec[0].block = '(' + named_spec[0].block + ')'
            return oshape, named_spec, layer
        depth = 0
        for bl_idx, block in enumerate(blocks[idx:]):
            depth += self._bracket_count(block, '(', ')', '[', ']')
            if depth == 0:
                break
        if depth:
            raise ValueError('VGSL spec has unbalanced brackets')
        inner = [blocks[idx][1:]] + blocks[idx + 1:idx + bl_idx] + [blocks[idx + bl_idx][:-1]]
        named_spec, layer, oshape = self.parse(input, inner, parallel=True, target_output_shape=target_output_shape)
        named_spec[0].block = '(' + named_spec[0].block
        named_spec[-1].block = named_spec[-1].block + ')'
        return oshape, named_spec, layer

    # --------------------------------------------------------------- parse
    def parse(self, input, blocks: Sequence[str], parallel: bool = False,
              target_output_shape=None):
        """
        Parses a list of space-separated VGSL blocks into a Series/Parallel
        layer tree with shape inference.
        """
        ops = [self._addition, self._identity, self._rnn, self._dropout,
               self._maxpool, self._conv, self._output, self._reshape,
               self._wav2vec2, self._groupnorm, self._transformer]
        named_spec: list[_Block] = []
        child_layers = []
        child_names = []
        prev_oshape = None
        channels = 0
        idx = 0
        oshape = None
        while idx < len(blocks):
            oshape = None
            layer = None
            name = None
            block_target = target_output_shape if parallel or idx == len(blocks) - 1 else None
            # nested blocks consume multiple tokens
            res = self._series(input, blocks, idx, target_output_shape=block_target)
            if res[0] is None:
                res = self._parallel(input, blocks, idx, target_output_shape=block_target)
            if res[0] is not None:
                oshape, name, layer = res
            else:
                for op in ops:
                    r = op(input, blocks[idx], target_output_shape=block_target)
                    if r is not None:
                        oshape, name, layer = r
                        name = [name]
                        break
            if not oshape:
                raise ValueError('{} is not a valid VGSL layer definition'.format(blocks[idx]))
            if not parallel:
                input = oshape
            else:
                if prev_oshape and prev_oshape[2:] != oshape[2:]:
                    raise ValueError('Branches of a parallel block must produce identical shapes')
                prev_oshape = oshape
                target_output_shape = oshape
                channels += oshape[1]
            named_spec.extend(name)
            idx += len(name)
            child_layers.append(layer)
            child_names.append(' '.join(n.name for n in name))
        cls = layers.Parallel if parallel else layers.Series
        tree = cls(layers=tuple(child_layers), names=tuple(child_names))
        if parallel:
            return named_spec, tree, (oshape[0], channels, *oshape[2:])
        return named_spec, tree, oshape


def parse_vgsl(spec: str, generator: Optional[torch.Generator] = None
               ) -> tuple[tuple, layers.Series, tuple, Optional[str], list[str]]:
    """
    Parses a full VGSL spec (with input block).

    Returns:
        (input shape NCHW, layer tree, output shape, criterion, named spec list)
    """
    spec = spec.strip()
    if spec[0] != '[' or spec[-1] != ']':
        raise ValueError('Only sequential top-level models are supported')
    blocks = spec[1:-1].split(' ')
    m = re.match(r'(\d+),(\d+),(\d+),(\d+)', blocks[0])
    if not m:
        raise ValueError('Invalid input spec.')
    batch, height, width, channels = (int(x) for x in m.groups())
    input_shape = (batch, channels, height, width)
    parser = _Parser(generator)
    parser.criterion = None
    named_spec, tree, oshape = parser.parse(input_shape, blocks[1:])
    return input_shape, tree, oshape, parser.criterion, [blocks[0]] + [str(x) for x in named_spec]


class VGSLModel:
    """
    A compiled VGSL network: a ``torch.nn.Module`` layer tree (``net``) plus
    codec and metadata, with the public surface of the JAX package's
    ``VGSLModel`` (and of the reference's TorchVGSLModel).

    Attributes:
        spec: VGSL specification string.
        input: expected input shape as NCHW (width/height 0 = variable).
        output: inferred output shape.
        net: the top-level Series module.
        criterion: 'ctc' | 'bce' | None — loss implied by the output layer.
        codec: optional Codec for recognition models.
        user_metadata: free-form metadata dict (persisted in model files).
    """

    _kraken_min_version = '5.0.0'

    def __init__(self, vgsl: Optional[str] = None, codec=None,
                 generator: Optional[torch.Generator] = None, **kwargs) -> None:
        """
        Args:
            vgsl: the VGSL spec.
            codec: a Codec or a charset mapping for recognition models.
            generator: source of the fresh parameters; a generator seeded
                from numpy's global state when omitted.
            kwargs: metadata stored in ``user_metadata``.
        """
        if vgsl is None:
            raise ValueError('model arguments lack a vgsl spec.')
        self.spec = vgsl
        self.codec: Optional[Codec] = None
        self.user_metadata: dict[str, Any] = {'accuracy': [],
                                              'metrics': [],
                                              'seg_type': None,
                                              'one_channel_mode': None,
                                              'model_type': []}
        self.user_metadata.update(**kwargs)
        if codec is not None:
            self.add_codec(codec if isinstance(codec, Codec) else Codec(codec))
        if generator is None:
            generator = torch.Generator().manual_seed(int(np.random.randint(0, 2**31 - 1)))
        self.input, self.net, self.output, self.criterion, self.named_spec = parse_vgsl(vgsl, generator)
        self.net.eval()
        self.user_metadata['vgsl'] = '[' + ' '.join(self.named_spec) + ']'

    # ------------------------------------------------------------ metadata
    def add_codec(self, codec: Codec) -> None:
        self.codec = codec
        self.user_metadata['codec'] = json.dumps(codec.c2l)

    @property
    def one_channel_mode(self):
        return self.user_metadata.get('one_channel_mode')

    @one_channel_mode.setter
    def one_channel_mode(self, val):
        if val not in ('1', 'L', None):
            raise ValueError(f'one_channel_mode {val} is not one of [1, L, None]')
        self.user_metadata['one_channel_mode'] = val

    @property
    def model_type(self):
        return self.user_metadata.get('model_type', [])

    @model_type.setter
    def model_type(self, val):
        if isinstance(val, str):
            val = [val]
        for v in val:
            if v not in ('recognition', 'segmentation'):
                raise ValueError(f'model_type {v} is not one of [recognition, segmentation]')
        self.user_metadata['model_type'] = val

    @property
    def seg_type(self):
        return self.user_metadata.get('seg_type')

    @seg_type.setter
    def seg_type(self, val):
        if val not in ('bbox', 'baselines', None):
            raise ValueError(f'segmentation type {val} is not one of [bbox, baselines, None]')
        self.user_metadata['seg_type'] = val

    @property
    def hyper_params(self):
        return self.user_metadata.setdefault('hyper_params', {})

    @hyper_params.setter
    def hyper_params(self, val):
        self.user_metadata.setdefault('hyper_params', {}).update(val)

    @property
    def use_legacy_polygons(self):
        return self.user_metadata.get('legacy_polygons', True)

    @use_legacy_polygons.setter
    def use_legacy_polygons(self, val: bool):
        self.user_metadata['legacy_polygons'] = val

    @property
    def device(self) -> torch.device:
        """The device the parameters lie on."""
        return next(self.net.parameters()).device

    # ------------------------------------------------------------- forward
    def forward(self, x: torch.Tensor, seq_lens: Optional[torch.Tensor] = None,
                output_shape=None) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Runs the network: (N, C, H, W) input and per-row widths to
        (logits, output widths)."""
        return self.net(x, seq_lens, output_shape=output_shape)

    def __call__(self, x, seq_lens=None, **kwargs):
        return self.forward(x, seq_lens, **kwargs)

    # ----------------------------------------------------------- inference
    def prepare_for_inference(self, config) -> None:
        """
        Configures the model for inference with `config`: device placement
        and precision cast (see
        :func:`kraken_tpu_torch.inference.recognition.prepare_recognition`
        and :func:`kraken_tpu_torch.inference.segmentation.prepare_segmentation`).
        """
        from kraken_tpu_torch.configs import (RecognitionInferenceConfig,
                                              SegmentationInferenceConfig)
        for task, cfg_type in (('recognition', RecognitionInferenceConfig),
                               ('segmentation', SegmentationInferenceConfig)):
            if isinstance(config, cfg_type) and task not in self.model_type:
                raise ValueError(f'{self} is a {self.model_type} model but received '
                                 f'incompatible {type(config).__name__}.')
        if 'recognition' in self.model_type:
            from kraken_tpu_torch.inference.recognition import prepare_recognition
            prepare_recognition(self, config)
        elif 'segmentation' in self.model_type:
            from kraken_tpu_torch.inference.segmentation import prepare_segmentation
            prepare_segmentation(self, config)
        else:
            raise ValueError(f'Model type {self.model_type} has no inference path')

    def predict(self, *args, **kwargs):
        """
        Runs inference: recognition models take (im, segmentation) and yield
        OCR records; segmentation models take (im) and return a
        Segmentation.
        """
        if 'recognition' in self.model_type:
            from kraken_tpu_torch.inference.recognition import recognition_pred
            return recognition_pred(self, *args, **kwargs)
        if 'segmentation' in self.model_type:
            from kraken_tpu_torch.inference.segmentation import segmentation_pred
            return segmentation_pred(self, *args, **kwargs)
        raise ValueError(f'Model type {self.model_type} has no prediction mode')

    # --------------------------------------------------------- state dicts
    def state_dict(self) -> dict[str, torch.Tensor]:
        """Parameters under torch-compatible `nn.`-prefixed keys."""
        return {f'nn.{k}': v.detach() for k, v in self.net.state_dict().items()}

    def _assign(self, arrays: dict[str, Any]) -> None:
        own = self.net.state_dict()
        with torch.no_grad():
            for key, value in arrays.items():
                target = own[key]
                t = value if isinstance(value, torch.Tensor) else torch.from_numpy(np.array(value))
                if tuple(t.shape) != tuple(target.shape):
                    raise KrakenInvalidModelException(
                        f'Shape mismatch for nn.{key}: file {tuple(t.shape)} != model {tuple(target.shape)}')
                target.copy_(t.to(target.dtype))

    def load_state_dict(self, state_dict: dict, prefix: str = 'nn.') -> None:
        """
        Loads a flat torch-style state dict (numpy arrays or tensors) into
        the parameters, validating shapes. Keys outside `prefix` are ignored;
        every parameter must be present.
        """
        arrays = {}
        for key in self.net.state_dict():
            if f'{prefix}{key}' not in state_dict:
                raise KrakenInvalidModelException(f'Missing key {prefix}{key} in state dict')
            arrays[key] = state_dict[f'{prefix}{key}']
        self._assign(arrays)

    def from_jax_state_dict(self, sd: dict[str, np.ndarray]) -> None:
        """
        Loads the output of the JAX package's ``VGSLModel.state_dict()``
        (numpy arrays under ``nn.``-prefixed torch-convention keys).

        Every key must be one of this model's parameters and every parameter
        must be given, with the same layout: convolution weights OIHW
        (transposed convolutions IOHW), linear weights (out, in), LSTM
        ``weight_ih_l0[_reverse]`` (4H, in) and ``weight_hh_l0[_reverse]``
        (4H, H) in gate order i, f, g, o, and ``bias_ih``/``bias_hh`` kept
        apart, ocropy peepholes ``weight_{i,f,o}p_l0[_reverse]`` (H,), and
        a ``Te`` block's ``norm1``, ``attn.qkv``, ``attn.out``, ``norm2``,
        ``ffn.lin1`` and ``ffn.lin2`` weights and biases. An unknown key, a
        missing one or a wrong shape raises.
        """
        own = self.net.state_dict()
        unknown = sorted(k for k in sd if not k.startswith('nn.') or k[3:] not in own)
        if unknown:
            raise KrakenInvalidModelException(f'Unknown keys in JAX state dict: {unknown}')
        missing = sorted(f'nn.{k}' for k in own if f'nn.{k}' not in sd)
        if missing:
            raise KrakenInvalidModelException(f'Missing keys in JAX state dict: {missing}')
        self._assign({k[3:]: v for k, v in sd.items()})

    # ------------------------------------------------------------- editing
    def append(self, idx: int, spec: str, generator: Optional[torch.Generator] = None) -> None:
        """
        Splits the model at layer `idx` (top-level position) and appends the
        layers of `spec` (a bracketed block list without input block), with
        fresh parameters from `generator` (seeded from numpy's global state
        when omitted), on the device and in the type of the kept layers.
        """
        kept = list(zip(self.net.names[:idx], self.net.layers[:idx]))
        self.named_spec = self.named_spec[:idx + 1]
        shape = self.input
        for _, layer in kept:
            shape = layer.get_shape(shape)
        if generator is None:
            generator = torch.Generator().manual_seed(int(np.random.randint(0, 2**31 - 1)))
        parser = _Parser(generator)
        parser.idx = idx - 1
        parser.criterion = None
        new_spec, new_tree, oshape = parser.parse(shape, spec[1:-1].split(' '))
        if parser.criterion:
            self.criterion = parser.criterion
        new_tree.to(**self._placement())
        kept.extend(zip(new_tree.names, new_tree.layers))
        self.net = layers.Series(layers=tuple(m for _, m in kept), names=tuple(n for n, _ in kept))
        self.net.eval()
        self.output = oshape
        self.named_spec.extend(str(x) for x in new_spec)
        self.spec = '[' + ' '.join(self.named_spec) + ']'
        self.user_metadata['vgsl'] = self.spec

    def resize_output(self, output_size: int, del_indices: Optional[Sequence[int]] = None,
                      generator: Optional[torch.Generator] = None) -> None:
        """
        Resizes the final output layer (linear or convolutional): drops the
        output rows in `del_indices`, keeps the others as they are and
        appends fresh rows up to `output_size` (Xavier-uniform weights over
        the row's fan-in and the new rows, as the JAX package draws them,
        from `generator`; zero biases).
        """
        last_name, last = self.net.names[-1], self.net.layers[-1]
        if not isinstance(last, (layers.ActConv2D, layers.LinSoftmax)):
            raise ValueError('output resizing needs a linear or convolutional final layer')
        holder = last.lin if isinstance(last, layers.LinSoftmax) else last.co
        dropped = set(del_indices or [])
        keep = [i for i in range(holder.weight.shape[0]) if i not in dropped]
        if len(keep) > output_size:
            raise ValueError(f'{len(keep)} output rows remain, more than the new size {output_size}')
        weight, bias = holder.weight.detach()[keep], holder.bias.detach()[keep]
        extra = output_size - len(keep)
        if extra:
            if generator is None:
                generator = torch.Generator().manual_seed(int(np.random.randint(0, 2**31 - 1)))
            a = math.sqrt(6.0 / (math.prod(weight.shape[1:]) + extra))
            fresh = torch.empty((extra, *weight.shape[1:])).uniform_(-a, a, generator=generator)
            weight = torch.cat([weight, fresh.to(weight)])
            bias = torch.cat([bias, bias.new_zeros(extra)])
        if isinstance(last, layers.LinSoftmax):
            new_layer = layers.LinSoftmax(last.input_size, output_size, last.augmentation,
                                          generator=torch.Generator())
            new_holder = new_layer.lin
        else:
            new_layer = layers.ActConv2D(last.in_channels, output_size, last.kernel_size,
                                         last.stride, last.nl, last.dilation, last.transposed,
                                         generator=torch.Generator())
            new_holder = new_layer.co
        new_layer.to(**self._placement())
        with torch.no_grad():
            new_holder.weight.copy_(weight)
            new_holder.bias.copy_(bias)
        self.net._modules[last_name] = new_layer.eval()
        self.output = self.output[:1] + (output_size,) + self.output[2:]
        m = re.match(r'(O)(?P<name>{\w+})?(?P<dim>2|1|0)(?P<type>l|s|c)(?P<aug>a)?(?P<out>\d+)',
                     self.named_spec[-1])
        if not m:
            raise ValueError('Cannot parse output spec')
        self.named_spec[-1] = 'O{}{}{}{}{}'.format(m.group('name') or '', m.group('dim'),
                                                  m.group('type'), m.group('aug') or '', output_size)
        self.spec = '[' + ' '.join(self.named_spec) + ']'
        self.user_metadata['vgsl'] = self.spec

    def _placement(self) -> dict:
        """The device and floating type of the parameters (CPU float32 for
        a model without any)."""
        p = next(self.net.parameters(), None)
        return {'device': p.device, 'dtype': p.dtype} if p is not None else \
            {'device': torch.device('cpu'), 'dtype': torch.float32}

    def __repr__(self):
        return f'VGSLModel({self.spec})'
