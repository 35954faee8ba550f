"""
kraken_tpu_torch.models.writers
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

Model serialization, the counterpart of the JAX package's
``models/writers.py``: the reference engine's multi-model safetensors
container (one key prefix per model, ``kraken_meta`` JSON metadata with
``_model``/``_tasks``/``_kraken_min_version`` plus the model's user
metadata) and CoreML (:mod:`kraken_tpu_torch.models._coreml_writer`), so
files written here load in the JAX package and the reference engine and
vice versa. Parameters are written from the models' ``state_dict()`` under
the keys, shapes and layouts the JAX package writes; bfloat16 and float16
parameters are widened to float32.
"""
import json
import logging
import uuid
from collections.abc import Sequence
from os import PathLike
from typing import Union

import numpy as np
import torch

logger = logging.getLogger(__name__)

__all__ = ['write_models', 'write_safetensors']


def _model_metadata(model) -> dict:
    model_name = 'TorchVGSLModel'
    if type(model).__name__ == 'ROMLP':
        model_name = 'ROMLP'
    meta = {'_kraken_min_version': getattr(model, '_kraken_min_version', '5.0.0'),
            '_tasks': model.model_type if getattr(model, 'model_type', None) else None,
            '_model': model_name}
    user_meta = dict(getattr(model, 'user_metadata', {}))
    codec = getattr(model, 'codec', None)
    if codec is not None:
        user_meta['codec'] = codec.c2l
    elif isinstance(user_meta.get('codec'), str):
        user_meta['codec'] = json.loads(user_meta['codec'])
    meta.update(user_meta)
    return meta


def state_arrays(module) -> dict[str, np.ndarray]:
    """A model's or a layer's ``state_dict()`` as float32 (or integer)
    numpy arrays on the host, under its own keys."""
    out = {}
    for k, v in module.state_dict().items():
        v = v.detach().cpu()
        if v.is_floating_point() and v.dtype != torch.float64:
            v = v.to(torch.float32)
        out[k] = v.contiguous().numpy()
    return out


def write_safetensors(models: Sequence, path: Union[str, PathLike]) -> None:
    """
    Serializes one or more models into a kraken-compatible safetensors file.
    """
    from kraken_tpu_torch.models._safetensors import write_safetensors as write_file

    tensors: dict[str, np.ndarray] = {}
    model_map: dict[str, dict] = {}
    for model in models:
        prefix = str(uuid.uuid4())
        model_map[prefix] = _model_metadata(model)
        for k, v in state_arrays(model).items():
            tensors[f'{prefix}.{k}'] = v
    write_file(path, tensors, {'kraken_meta': json.dumps(model_map)})


def write_models(models: Sequence, path: Union[str, PathLike], format: str = 'safetensors') -> None:
    """
    Writes models to `path` in the requested format: 'safetensors',
    'coreml', or the name of a writer in the ``kraken.writers`` entry-point
    group.
    """
    if format == 'safetensors':
        write_safetensors(models, path)
    elif format == 'coreml':
        from kraken_tpu_torch.models._coreml_writer import write_coreml
        write_coreml(models, path)
    else:
        import importlib.metadata
        for ep in importlib.metadata.entry_points(group='kraken.writers'):
            if ep.name == format:
                ep.load()(models, path)
                return
        raise ValueError(f'Unknown model format {format}')
