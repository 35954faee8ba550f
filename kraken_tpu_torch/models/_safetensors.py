"""
kraken_tpu_torch.models._safetensors
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

A small reader and writer of the safetensors format, so that loading or
saving a model needs no ``safetensors`` package: an 8-byte little-endian header length, a JSON
header (tensor name → dtype, shape, byte offsets; ``__metadata__`` →
string map), then the raw little-endian buffers.
"""
import json
import struct
from os import PathLike
from typing import Union

import numpy as np

__all__ = ['read_safetensors', 'write_safetensors']

_DTYPES = {'F64': '<f8', 'F32': '<f4', 'F16': '<f2', 'I64': '<i8', 'I32': '<i4',
           'I16': '<i2', 'I8': 'i1', 'U8': 'u1', 'BOOL': '?', 'BF16': '<u2'}


def read_safetensors(path: Union[str, PathLike]) -> tuple[dict[str, str], dict[str, np.ndarray]]:
    """
    Reads a safetensors file.

    Returns:
        (metadata, tensors): the ``__metadata__`` string map (empty when
        absent) and the tensors as numpy arrays. bfloat16 tensors are
        widened to float32.

    Raises:
        ValueError: when the file is not a well-formed safetensors file.
    """
    with open(path, 'rb') as f:
        data = f.read()
    if len(data) < 8:
        raise ValueError(f'{path} is too short for a safetensors header')
    (n,) = struct.unpack('<Q', data[:8])
    if n > len(data) - 8:
        raise ValueError(f'{path}: header length {n} exceeds the file')
    try:
        header = json.loads(data[8:8 + n])
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f'{path}: unparseable safetensors header: {e}') from e
    if not isinstance(header, dict):
        raise ValueError(f'{path}: safetensors header is not an object')
    metadata = header.pop('__metadata__', None) or {}
    buf = memoryview(data)[8 + n:]
    tensors = {}
    for name, info in header.items():
        try:
            dtype = _DTYPES[info['dtype']]
            shape = tuple(int(s) for s in info['shape'])
            start, end = (int(x) for x in info['data_offsets'])
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f'{path}: bad header entry for {name!r}: {e}') from e
        count = int(np.prod(shape))
        if not 0 <= start <= end <= len(buf) or end - start != count * np.dtype(dtype).itemsize:
            raise ValueError(f'{path}: byte range of {name!r} does not match its shape')
        arr = np.frombuffer(buf[start:end], dtype=dtype).reshape(shape)
        if info['dtype'] == 'BF16':
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        tensors[name] = arr.copy()
    return metadata, tensors


_NAMES = {'<f8': 'F64', '<f4': 'F32', '<f2': 'F16', '<i8': 'I64', '<i4': 'I32', '<i2': 'I16',
          '|i1': 'I8', '|u1': 'U8', '|b1': 'BOOL'}


def write_safetensors(path: Union[str, PathLike], tensors: dict[str, np.ndarray],
                      metadata: dict[str, str]) -> None:
    """
    Writes numpy arrays and a string metadata map as a safetensors file:
    the tensors in name order, their buffers back to back, the JSON header
    padded with spaces to a multiple of 8 bytes as the ``safetensors``
    package pads it.
    """
    header: dict = {'__metadata__': dict(metadata)}
    buffers = []
    offset = 0
    for name in sorted(tensors):
        arr = np.ascontiguousarray(tensors[name])
        arr = arr.astype(arr.dtype.newbyteorder('<'), copy=False)
        dtype = _NAMES.get(arr.dtype.str)
        if dtype is None:
            raise ValueError(f'cannot write {name!r} of type {arr.dtype} to safetensors')
        data = arr.tobytes()
        header[name] = {'dtype': dtype, 'shape': list(arr.shape),
                        'data_offsets': [offset, offset + len(data)]}
        buffers.append(data)
        offset += len(data)
    raw = json.dumps(header, separators=(',', ':')).encode('utf-8')
    raw += b' ' * (-len(raw) % 8)
    with open(path, 'wb') as f:
        f.write(struct.pack('<Q', len(raw)))
        f.write(raw)
        for data in buffers:
            f.write(data)
