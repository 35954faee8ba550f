"""
kraken_tpu_torch.models._coreml
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

Self-contained CoreML .mlmodel reader on the protobuf wire format, a copy of
the JAX package's reader whose weight extraction walks the port's modules.

coremltools is not a dependency of this engine; kraken's CoreML files use a
small, fixed subset of the CoreML neural-network spec (convolution,
innerProduct, uni/bidirectional LSTM, custom layers, embedding, activations,
pooling, softmax, permute), so the relevant messages are decoded directly.
Field numbers follow the public CoreML Model.proto/NeuralNetwork.proto
specification and were verified against kraken-produced model files.

Weight extraction mirrors the reference's layer deserializers
(kraken/lib/vgsl/layers.py:563-619,731-740,880-893,990-996
and kraken/models/_coreml.py) producing a torch-style flat
state dict consumed by ``VGSLModel.load_state_dict``.
"""
import struct
from dataclasses import dataclass, field
from typing import Optional, Union

import numpy as np

__all__ = ['parse_mlmodel', 'extract_weights', 'MLModelSpec']


# --------------------------------------------------------------------- wire
class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def eof(self) -> bool:
        return self.pos >= len(self.buf)

    def varint(self) -> int:
        v = 0
        shift = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            v |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                return v

    def fields(self):
        """Yields (field_number, wire_type, value) triples."""
        while not self.eof():
            key = self.varint()
            fnum, wtype = key >> 3, key & 7
            if wtype == 0:
                yield fnum, 0, self.varint()
            elif wtype == 1:
                v = struct.unpack('<d', self.buf[self.pos:self.pos + 8])[0]
                self.pos += 8
                yield fnum, 1, v
            elif wtype == 2:
                ln = self.varint()
                v = self.buf[self.pos:self.pos + ln]
                self.pos += ln
                yield fnum, 2, v
            elif wtype == 5:
                v = struct.unpack('<f', self.buf[self.pos:self.pos + 4])[0]
                self.pos += 4
                yield fnum, 5, v
            else:
                raise ValueError(f'Unsupported wire type {wtype}')


def _submessages(buf: bytes) -> dict[int, list]:
    out: dict[int, list] = {}
    for fnum, _, v in _Reader(buf).fields():
        out.setdefault(fnum, []).append(v)
    return out


def _floats(weight_params: bytes) -> np.ndarray:
    """Decodes a WeightParams message (f1 packed float32, f2 fp16 bytes)."""
    fields = _submessages(weight_params)
    if 1 in fields:
        raw = fields[1][0]
        return np.frombuffer(raw, dtype='<f4') if isinstance(raw, bytes) else np.asarray([raw], dtype=np.float32)
    if 2 in fields:
        return np.frombuffer(fields[2][0], dtype='<f2').astype(np.float32)
    return np.zeros((0,), np.float32)


# ------------------------------------------------------------------- model
# NeuralNetworkLayer oneof field numbers (CoreML NeuralNetwork.proto)
_LAYER_TYPES = {
    100: 'convolution',
    120: 'pooling',
    130: 'activation',
    140: 'innerProduct',
    150: 'embedding',
    175: 'softmax',
    300: 'reshape',
    305: 'flatten',
    310: 'permute',
    400: 'simpleRecurrent',
    410: 'gru',
    420: 'uniDirectionalLSTM',
    430: 'biDirectionalLSTM',
    500: 'custom',
}
_LAYER_FIELDS = {v: k for k, v in _LAYER_TYPES.items()}


@dataclass
class MLLayer:
    name: str
    inputs: list[str]
    outputs: list[str]
    kind: str
    body: bytes


@dataclass
class MLModelSpec:
    specification_version: int = 1
    user_defined_metadata: dict[str, str] = field(default_factory=dict)
    short_description: str = ''
    layers: list[MLLayer] = field(default_factory=list)
    inputs: list[tuple[str, tuple[int, ...]]] = field(default_factory=list)
    outputs: list[tuple[str, tuple[int, ...]]] = field(default_factory=list)

    def layer(self, name: str) -> Optional[MLLayer]:
        for lay in self.layers:
            if lay.name == name:
                return lay
        return None


def parse_mlmodel(data: bytes) -> MLModelSpec:
    """Parses a CoreML Model protobuf into an MLModelSpec."""
    spec = MLModelSpec()
    top = _submessages(data)
    if 1 in top:
        spec.specification_version = top[1][0]
    nn_body = None
    # neuralNetwork / neuralNetworkClassifier / neuralNetworkRegressor
    for f in (500, 402, 401):
        if f in top:
            nn_body = top[f][0]
            break
    if 2 in top:
        desc = _submessages(top[2][0])
        for meta in desc.get(100, []):
            mfields = _submessages(meta)
            if 1 in mfields:
                spec.short_description = mfields[1][0].decode('utf-8', 'replace')
            for entry in mfields.get(100, []):
                kv = _submessages(entry)
                key = kv.get(1, [b''])[0].decode('utf-8')
                val = kv.get(2, [b''])[0].decode('utf-8')
                spec.user_defined_metadata[key] = val
    if nn_body is None:
        raise ValueError('Model contains no neural network')
    nn = _submessages(nn_body)
    for raw in nn.get(1, []):
        lf = _submessages(raw)
        name = lf.get(1, [b''])[0].decode('utf-8')
        inputs = [x.decode('utf-8') for x in lf.get(2, [])]
        outputs = [x.decode('utf-8') for x in lf.get(3, [])]
        kind = 'unknown'
        body = b''
        for fnum, vals in lf.items():
            if fnum in _LAYER_TYPES:
                kind = _LAYER_TYPES[fnum]
                body = vals[0]
                break
        spec.layers.append(MLLayer(name, inputs, outputs, kind, body))
    return spec


# --------------------------------------------------------------- extraction
def _conv_weights(layer: MLLayer, out_ch: int, in_ch: int,
                  kernel: tuple[int, int], transposed: bool) -> tuple[np.ndarray, np.ndarray]:
    f = _submessages(layer.body)
    w = _floats(f[90][0])
    b = _floats(f[91][0]) if 91 in f else np.zeros((out_ch,), np.float32)
    if transposed:
        w = w.reshape(in_ch, out_ch, *kernel)
    else:
        w = w.reshape(out_ch, in_ch, *kernel)
    return w, b


def _lstm_weights(layer: MLLayer, hidden: int, input_size: int) -> list[dict[str, np.ndarray]]:
    """
    Extracts per-direction torch-convention LSTM weights (gate order i,f,g,o)
    from a uni/biDirectionalLSTM layer message.
    """
    f = _submessages(layer.body)
    directions = []
    for wp in f.get(20, []):
        g = _submessages(wp)
        def mat(idx, rows, cols):
            if idx not in g:
                return None
            return _floats(g[idx][0]).reshape(rows, cols)
        w_ih = np.concatenate([mat(i, hidden, input_size) for i in (1, 2, 3, 4)])
        w_hh = np.concatenate([mat(i, hidden, hidden) for i in (20, 21, 22, 23)])
        entry = {'weight_ih_l0': w_ih, 'weight_hh_l0': w_hh}
        if 40 in g:
            bias = np.concatenate([_floats(g[i][0]) for i in (40, 41, 42, 43)])
            entry['bias_hh_l0'] = bias
            entry['bias_ih_l0'] = np.zeros_like(bias)
        if 60 in g:
            entry['weight_ip_l0'] = _floats(g[60][0])
            entry['weight_fp_l0'] = _floats(g[61][0])
            entry['weight_op_l0'] = _floats(g[62][0])
        directions.append(entry)
    return directions


def _custom_weights(layer: MLLayer) -> list[np.ndarray]:
    f = _submessages(layer.body)
    return [_floats(w) for w in f.get(20, [])]


def extract_weights(spec: MLModelSpec, model) -> dict[str, np.ndarray]:
    """
    Walks the VGSLModel's layer tree and pulls matching weights out of the
    CoreML spec, returning a flat torch-style state dict with 'nn.' prefix.
    """
    from kraken_tpu_torch.nn import layers as L

    state: dict[str, np.ndarray] = {}

    def _walk(prefix: str, names, layer_objs):
        for name, layer in zip(names, layer_objs):
            path = f'{prefix}{name}'
            if isinstance(layer, (L.Series, L.Parallel)):
                _walk(f'{path}.', layer.names, layer.layers)
            elif isinstance(layer, L.ActConv2D):
                ml = spec.layer(f'{name}_conv')
                if ml is None:
                    raise ValueError(f'CoreML layer {name}_conv not found')
                w, b = _conv_weights(ml, layer.out_channels, layer.in_channels,
                                     layer.kernel_size, layer.transposed)
                state[f'{path}.co.weight'] = w
                state[f'{path}.co.bias'] = b
            elif isinstance(layer, L.LinSoftmax):
                ml = spec.layer(f'{name}_lin')
                if ml is None:
                    raise ValueError(f'CoreML layer {name}_lin not found')
                f = _submessages(ml.body)
                out_ch = f[2][0]
                in_ch = f[1][0]
                state[f'{path}.lin.weight'] = _floats(f[20][0]).reshape(out_ch, in_ch)
                state[f'{path}.lin.bias'] = _floats(f[21][0]) if 21 in f else np.zeros((out_ch,), np.float32)
            elif isinstance(layer, L.GroupNorm):
                ml = spec.layer(name)
                if ml is None or ml.kind != 'custom':
                    raise ValueError(f'CoreML groupnorm layer {name} not found')
                ws = _custom_weights(ml)
                state[f'{path}.layer.weight'] = ws[0]
                state[f'{path}.layer.bias'] = ws[1]
            elif isinstance(layer, L.TransposedSummarizingRNN):
                # y-axis RNNs are serialized behind a permute with the LSTM
                # layer renamed to '{name}_transposed'
                ml = spec.layer(f'{name}_transposed') or spec.layer(name)
                if ml is None or ml.kind not in ('uniDirectionalLSTM', 'biDirectionalLSTM'):
                    raise ValueError(f'CoreML LSTM layer {name} not found')
                dirs = _lstm_weights(ml, layer.hidden_size, layer._in)
                suffixes = ['']
                if layer.bidi or layer.legacy == 'ocropy':
                    suffixes.append('_reverse')
                for sfx, entry in zip(suffixes, dirs):
                    for k, v in entry.items():
                        state[f'{path}.layer.{k}{sfx}'] = v
            # MaxPool/Reshape/Dropout/Identity/Addition carry no weights

    _walk('nn.', model.net.names, model.net.layers)
    return state
