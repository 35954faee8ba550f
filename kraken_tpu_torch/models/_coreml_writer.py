"""
kraken_tpu_torch.models._coreml_writer
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

CoreML .mlmodel writer on the protobuf wire format, the counterpart of the
JAX package's ``models/_coreml_writer.py`` (and of :mod:`._coreml`'s
reader). The layer messages follow the reference's per-layer serializers
(kraken/lib/vgsl/layers.py), so the files load in the reference engine
through coremltools and in the JAX package. For the same model the bytes
equal the JAX writer's: the same messages in the same order, the weights
as the same little-endian float32 values.
"""
import json
import struct
from typing import Optional

import numpy as np

from kraken_tpu_torch.models.writers import state_arrays

__all__ = ['write_coreml']

# ------------------------------------------------------------- wire writing


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_varint(fnum: int, value: int) -> bytes:
    return _varint(fnum << 3) + _varint(int(value))


def _field_bytes(fnum: int, payload: bytes) -> bytes:
    return _varint((fnum << 3) | 2) + _varint(len(payload)) + payload


def _field_str(fnum: int, s: str) -> bytes:
    return _field_bytes(fnum, s.encode('utf-8'))


def _field_float(fnum: int, value: float) -> bytes:
    return _varint((fnum << 3) | 5) + struct.pack('<f', value)


def _field_double(fnum: int, value: float) -> bytes:
    return _varint((fnum << 3) | 1) + struct.pack('<d', value)


def _packed_uint64(fnum: int, values) -> bytes:
    payload = b''.join(_varint(int(v)) for v in values)
    return _field_bytes(fnum, payload)


def _weight_params(arr: np.ndarray) -> bytes:
    """WeightParams message with packed float32 values."""
    data = np.ascontiguousarray(arr, dtype='<f4').tobytes()
    return _field_bytes(1, data)


# ------------------------------------------------------------ layer messages

def _layer(name: str, inputs: list[str], outputs: list[str],
           oneof_field: int, body: bytes) -> bytes:
    msg = _field_str(1, name)
    for i in inputs:
        msg += _field_str(2, i)
    for o in outputs:
        msg += _field_str(3, o)
    msg += _field_bytes(oneof_field, body)
    return msg


def _activation_body(kind: str) -> bytes:
    # ActivationParams oneof field numbers
    fields = {'LINEAR': 5, 'RELU': 10, 'LEAKYRELU': 15, 'TANH': 30, 'SIGMOID': 40}
    f = fields[kind]
    if kind == 'LEAKYRELU':
        return _field_bytes(f, _field_float(1, 0.01))
    if kind == 'LINEAR':
        return _field_bytes(f, _field_float(1, 1.0) + _field_float(2, 0.0))
    return _field_bytes(f, b'')


def _custom_body(class_name: str, description: str = '',
                 int_params: Optional[dict] = None,
                 double_params: Optional[dict] = None,
                 weights: Optional[list[np.ndarray]] = None) -> bytes:
    body = _field_str(10, class_name)
    for w in (weights or []):
        body += _field_bytes(20, _weight_params(w))
    for key, val in (int_params or {}).items():
        entry = _field_str(1, key) + _field_bytes(2, _field_varint(30, val))
        body += _field_bytes(30, entry)
    for key, val in (double_params or {}).items():
        entry = _field_str(1, key) + _field_bytes(2, _field_double(10, val))
        body += _field_bytes(30, entry)
    if description:
        body += _field_str(40, description)
    return body


def _lstm_weight_params(w_ih, w_hh, bias=None, peep=None) -> bytes:
    """LSTMWeightParams from torch-convention (i, f, g, o) stacked weights:
    CoreML's input, forget, block input and output gate fields."""
    body = b''
    for field, mat in zip((1, 2, 3, 4), np.split(np.asarray(w_ih), 4)):
        body += _field_bytes(field, _weight_params(mat))
    for field, mat in zip((20, 21, 22, 23), np.split(np.asarray(w_hh), 4)):
        body += _field_bytes(field, _weight_params(mat))
    if bias is not None:
        for field, vec in zip((40, 41, 42, 43), np.split(np.asarray(bias), 4)):
            body += _field_bytes(field, _weight_params(vec))
    if peep is not None:
        for field, vec in zip((60, 61, 62), peep):
            body += _field_bytes(field, _weight_params(vec))
    return body


def _lstm_params(has_bias: bool) -> bytes:
    return (_field_varint(10, 1) +          # sequenceOutput
            _field_varint(20, 1 if has_bias else 0) +  # hasBiasVectors
            _field_float(60, 50000.0))      # cellClipThreshold


def _lstm_activation_triple(field: int) -> bytes:
    sigmoid = _field_bytes(40, b'')
    tanh = _field_bytes(30, b'')
    return (_field_bytes(field, sigmoid) +
            _field_bytes(field, tanh) +
            _field_bytes(field, tanh))


# ------------------------------------------------------------- model writer

def _serialize_layers(names, layer_objs, input_name: str, out: list) -> str:
    """Walks the layer tree emitting NeuralNetworkLayer messages; returns the
    final output blob name."""
    from kraken_tpu_torch.nn import layers as L
    from kraken_tpu_torch.pretrain.layers import Wav2Vec2Mask

    current = input_name
    for name, layer in zip(names, layer_objs):
        if isinstance(layer, (L.Series, L.Parallel)):
            current = _serialize_layers(layer.names, layer.layers, current, out)
            continue
        p = state_arrays(layer)
        if isinstance(layer, L.ActConv2D):
            conv_name = f'{name}_conv'
            act_name = f'{name}_act'
            conv_out = name if layer.nl == 's' else conv_name
            body = (_field_varint(1, layer.out_channels) +
                    _field_varint(2, layer.in_channels) +
                    _field_varint(10, 1) +
                    _packed_uint64(20, layer.kernel_size) +
                    _packed_uint64(30, layer.stride) +
                    _packed_uint64(40, layer.dilation) +
                    _field_bytes(51, b'') +            # same padding
                    _field_varint(60, 1 if layer.transposed else 0) +
                    _field_varint(70, 1) +
                    _field_bytes(90, _weight_params(p['co.weight'])) +
                    _field_bytes(91, _weight_params(p['co.bias'])))
            out.append(_layer(conv_name, [current], [conv_out], 100, body))
            act_kind = L._ACTIVATIONS[layer.nl][0]
            if act_kind == 'SOFTMAX':
                out.append(_layer(act_name, [conv_name], [name], 175, b''))
            elif act_kind != 'SIGMOID':
                out.append(_layer(act_name, [conv_name], [name], 130,
                                  _activation_body(act_kind)))
            # sigmoid convs keep their logits: the conv output IS the blob
            current = conv_out if layer.nl == 's' else name
        elif isinstance(layer, L.LinSoftmax):
            lin_name = f'{name}_lin'
            n_in = layer.input_size + 1 if layer.augmentation else layer.input_size
            body = (_field_varint(1, n_in) +
                    _field_varint(2, layer.output_size) +
                    _field_varint(10, 1) +
                    _field_bytes(20, _weight_params(p['lin.weight'])) +
                    _field_bytes(21, _weight_params(p['lin.bias'])))
            out.append(_layer(lin_name, [current], [lin_name], 140, body))
            out.append(_layer(f'{name}_softmax', [lin_name], [name], 175, b''))
            current = name
        elif isinstance(layer, L.TransposedSummarizingRNN):
            current = _serialize_lstm(name, layer, p, current, out)
        elif isinstance(layer, L.MaxPool):
            body = (_field_varint(1, 0) +                    # MAX
                    _packed_uint64(10, layer.kernel_size) +
                    _packed_uint64(20, layer.stride) +
                    _field_bytes(31, b''))                   # same padding
            out.append(_layer(name, [current], [name], 120, body))
            current = name
        elif isinstance(layer, L.GroupNorm):
            body = _custom_body('groupnorm', 'kraken group normalization custom layer',
                                int_params={'in_channels': layer.in_channels,
                                            'num_groups': layer.num_groups},
                                weights=[p['layer.weight'], p['layer.bias']])
            out.append(_layer(name, [current], [name], 500, body))
            current = name
        elif isinstance(layer, L.Dropout):
            body = _custom_body('dropout', 'kraken dropout custom layer',
                                int_params={'dim': layer.dim},
                                double_params={'p': layer.p})
            out.append(_layer(name, [current], [name], 500, body))
            current = name
        elif isinstance(layer, L.Reshape):
            body = _custom_body('reshape', 'kraken reshape custom layer',
                                int_params={'src_dim': layer.src_dim,
                                            'part_a': layer.part_a,
                                            'part_b': layer.part_b,
                                            'high': layer.high,
                                            'low': layer.low})
            out.append(_layer(name, [current], [name], 500, body))
            current = name
        elif isinstance(layer, L.Addition):
            body = _custom_body('addition', 'An addition layer',
                                int_params={'dim': layer.dim,
                                            'chunk_size': layer.chunk_size})
            out.append(_layer(name, [current], [name], 500, body))
            current = name
        elif isinstance(layer, L.Identity):
            body = _custom_body('identity', 'An identity layer')
            out.append(_layer(name, [current], [name], 500, body))
            current = name
        elif isinstance(layer, Wav2Vec2Mask):
            # an embedding and an inner product beside the data path: the
            # next layer reads the masking layer's input
            emb_name = f'{name}_wave2vec2_emb'
            body = (_field_varint(1, layer.context_encoder_input_dim) +
                    _field_varint(2, layer.mask_width) +
                    _field_varint(10, 0) +
                    _field_bytes(20, _weight_params(p['mask_emb.weight'])))
            out.append(_layer(emb_name, [current], [emb_name], 150, body))
            lin_name = f'{name}_wave2vec2_lin'
            body = (_field_varint(1, layer.context_encoder_input_dim) +
                    _field_varint(2, layer.final_dim) +
                    _field_varint(10, 1) +
                    _field_bytes(20, _weight_params(p['project_q.weight'])) +
                    _field_bytes(21, _weight_params(p['project_q.bias'])))
            out.append(_layer(lin_name, [current], [lin_name], 140, body))
        else:
            raise ValueError(f'Cannot serialize layer {type(layer).__name__} to CoreML')
    return current


def _serialize_lstm(name: str, layer, p: dict, current: str, out: list) -> str:
    """An LSTM layer (and the permute in front of a transposed one)."""
    lstm_in = current
    lstm_name = name
    if layer.transpose:
        # permute y/x before the recurrence (PermuteLayerParams.axis)
        perm_out = f'{name}_transposed'
        out.append(_layer(name, [current], [perm_out], 310, _packed_uint64(1, (0, 1, 3, 2))))
        lstm_in = perm_out
        lstm_name = perm_out
    has_bias = 'layer.bias_ih_l0' in p
    directions = [''] + (['_reverse'] if layer.bidi else [])
    weights = b''
    for sfx in directions:
        bias = p[f'layer.bias_ih_l0{sfx}'] + p[f'layer.bias_hh_l0{sfx}'] if has_bias else None
        peep = None
        if layer.legacy == 'ocropy':
            peep = [p[f'layer.weight_{g}p_l0{sfx}'] for g in 'ifo']
        weights += _field_bytes(20, _lstm_weight_params(p[f'layer.weight_ih_l0{sfx}'],
                                                        p[f'layer.weight_hh_l0{sfx}'],
                                                        bias, peep))
    body = _field_varint(1, layer._in) + _field_varint(2, layer.hidden_size)
    body += _lstm_activation_triple(10)
    if layer.bidi:
        body += _lstm_activation_triple(11)
    body += _field_bytes(15, _lstm_params(has_bias)) + weights
    states = ['h', 'c'] + (['h_rev', 'c_rev'] if layer.bidi else [])
    if not layer.bidi and layer.direction == 'r':
        body += _field_varint(100, 1)
    out.append(_layer(lstm_name, [lstm_in] + [f'{lstm_name}_{s}' for s in states],
                      [lstm_name + '_out'] + [f'{lstm_name}_{s}_out' for s in states],
                      430 if layer.bidi else 420, body))
    return lstm_name + '_out'


def _feature_description(name: str, shape) -> bytes:
    arr = _packed_uint64(1, [s if s else 0 for s in shape]) + _field_varint(2, 65600)
    ftype = _field_bytes(5, arr)
    return _field_str(1, name) + _field_bytes(3, ftype)


def _ro_mlp_layers(name: str, romlp, out: list) -> None:
    p = state_arrays(romlp)
    body = (_field_varint(1, romlp.feature_size) +
            _field_varint(2, romlp.hidden_size) +
            _field_varint(10, 1) +
            _field_bytes(20, _weight_params(p['nn.fc1.weight'])) +
            _field_bytes(21, _weight_params(p['nn.fc1.bias'])))
    out.append(_layer(f'{name}_mlp_lin_0', ['input'], [f'{name}_mlp_lin_0'], 140, body))
    out.append(_layer(f'{name}_mlp_lin_0_relu', [f'{name}_mlp_lin_0'],
                      [f'{name}_mlp_lin_0_relu'], 130, _activation_body('RELU')))
    body = (_field_varint(1, romlp.hidden_size) +
            _field_varint(2, 1) +
            _field_varint(10, 1) +
            _field_bytes(20, _weight_params(p['nn.fc2.weight'])) +
            _field_bytes(21, _weight_params(p['nn.fc2.bias'])))
    out.append(_layer(f'{name}_mlp_lin_1', [f'{name}_mlp_lin_0_relu'],
                      [f'{name}_mlp_lin_1'], 140, body))


def write_coreml(models, path) -> None:
    """
    Serializes models into a kraken-compatible CoreML file: the one VGSL
    model becomes the neural network; reading-order models are appended as
    auxiliary layers with an `aux_layers` metadata entry.
    """
    from kraken_tpu_torch.vgsl import VGSLModel

    vgsl_models = [m for m in models if isinstance(m, VGSLModel)]
    aux_models = [m for m in models if type(m).__name__ == 'ROMLP']
    if len(vgsl_models) != 1:
        raise ValueError('CoreML serialization requires exactly one VGSL model '
                         f'(got {len(vgsl_models)}).')
    model = vgsl_models[0]

    layer_msgs: list[bytes] = []
    _serialize_layers(model.net.names, model.net.layers, 'input', layer_msgs)
    aux_meta = {}
    for romlp in aux_models:
        name = 'ro_model' if romlp.level == 'baselines' else 'ro_model_regions'
        _ro_mlp_layers(name, romlp, layer_msgs)
        aux_meta[name] = f'[1,0,0,1 RO{{{name}}}{romlp.feature_size},{romlp.hidden_size}]'

    nn_body = b''.join(_field_bytes(1, m) for m in layer_msgs)

    user_meta = {'vgsl': model.user_metadata.get('vgsl', model.spec),
                 'kraken_meta': json.dumps({**model.user_metadata,
                                            'model_type': (model.model_type[0]
                                                           if model.model_type else 'unknown')},
                                           default=str)}
    if model.codec is not None:
        user_meta['codec'] = json.dumps(model.codec.c2l)
    if aux_meta:
        user_meta['aux_layers'] = json.dumps(aux_meta)

    meta = _field_str(1, 'kraken model')
    for k, v in user_meta.items():
        entry = _field_str(1, k) + _field_str(2, v)
        meta += _field_bytes(100, entry)

    desc = (_field_bytes(1, _feature_description('input', model.input)) +
            _field_bytes(10, _feature_description('output', model.output)) +
            _field_bytes(100, meta))

    doc = (_field_varint(1, 2) +          # specificationVersion
           _field_bytes(2, desc) +
           _field_bytes(500, nn_body))
    with open(path, 'wb') as fp:
        fp.write(doc)
