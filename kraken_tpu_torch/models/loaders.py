"""
kraken_tpu_torch.models.loaders
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

Weight/metadata loading for kraken model files, the counterpart of the JAX
package's ``models/loaders.py``: multi-model safetensors files with a
`kraken_meta` JSON metadata block and per-model key prefixes (read by the
port's own reader, :mod:`kraken_tpu_torch.models._safetensors`), and
CoreML .mlmodel protobufs (:mod:`kraken_tpu_torch.models._coreml`).

Models are built on the CPU in float32; ``prepare_for_inference`` places
them. A file may hold reading-order models (``ROMLP``): under their own
prefix in safetensors, as auxiliary layers (``aux_layers``) in CoreML.
"""
import json
import logging
from collections.abc import Sequence
from os import PathLike
from pathlib import Path
from typing import Literal, NewType, Optional, Union

import numpy as np

from kraken_tpu_torch.models.utils import create_model

logger = logging.getLogger(__name__)

_T_tasks = NewType('_T_tasks', Literal['segmentation', 'recognition', 'reading_order'])

__all__ = ['load_models', 'load_safetensors', 'load_coreml', 'KRAKEN_COMPAT_VERSION']

# newest reference model-format generation this loader understands; files
# declaring a higher `_kraken_min_version` are skipped with a warning
KRAKEN_COMPAT_VERSION = '7.0.0'


def _version_tuple(v: str) -> tuple:
    parts = []
    for tok in str(v).split('.'):
        digits = ''.join(ch for ch in tok if ch.isdigit())
        parts.append(int(digits) if digits else 0)
    return tuple(parts)


def load_models(path: Union[str, 'PathLike'], tasks: Optional[Sequence[_T_tasks]] = None) -> list:
    """
    Tries the safetensors and the CoreML loader in turn to deserialize the
    models in `path`.
    """
    path = Path(path)
    if not path.is_file():
        raise ValueError(f'{path} is not a regular file.')
    errors = []
    for name, loader in (('safetensors', load_safetensors), ('coreml', load_coreml)):
        try:
            return loader(path, tasks=tasks)
        except ValueError as e:
            logger.debug(f'Loader {name} failed for {path}: {e}')
            errors.append((name, e))
    details = '\n'.join(f'  {name}: {err}' for name, err in errors)
    raise ValueError(f'No loader found for {path}. Tried:\n{details}')


def load_safetensors(path: Union[str, PathLike], tasks: Optional[Sequence[_T_tasks]] = None) -> list:
    """
    Loads one or more models from a kraken safetensors file.

    The file's `kraken_meta` metadata maps per-model key prefixes to model
    construction metadata (`_model` class name, `_tasks`, `vgsl`, `codec`,
    ...). Weight keys are `{prefix}.nn.{layer}.{param}`.

    Args:
        path: safetensors file.
        tasks: optional filter of model task types to load.

    Returns:
        list of models.
    """
    from kraken_tpu_torch.models._safetensors import read_safetensors

    metadata, state_dict = read_safetensors(path)
    if not metadata:
        raise ValueError(f'Missing kraken metadata header in {path}.')
    try:
        model_map = json.loads(metadata.get('kraken_meta', 'null'))
    except json.JSONDecodeError as e:
        raise ValueError(f'Unparseable `kraken_meta` JSON in {path}: {e}') from e
    if not isinstance(model_map, dict):
        raise ValueError(f'Malformed `kraken_meta` record in {path}: expected object, '
                         f'got {type(model_map).__name__}.')

    models = {}
    for prefix, model_data in model_map.items():
        if not isinstance(model_data, dict):
            raise ValueError(f'Malformed metadata entry for model `{prefix}` in {path}: expected '
                             f'object, got {type(model_data).__name__}.')
        model_tasks = model_data.get('_tasks') or []
        if not isinstance(model_tasks, list) or not all(isinstance(x, str) for x in model_tasks):
            raise ValueError(f'Bad `_tasks` field for model `{prefix}` in {path}: needs a list of strings or null.')
        if tasks and not set(tasks).intersection(model_tasks):
            logger.info(f'Model {prefix} in model file {path} not in demanded tasks {tasks}')
            continue
        model_name = model_data.get('_model')
        if not isinstance(model_name, str):
            raise ValueError(f'`_model` entry absent or malformed for model `{prefix}` in {path}.')
        model_args = dict(model_data)
        model_args.pop('_tasks', None)
        model_args.pop('_kraken_min_version', None)
        model_args.pop('_model', None)
        model_args['model_type'] = model_tasks
        try:
            model = create_model(model_name, **model_args)
        except Exception as e:
            raise ValueError(f'Failed to create model {model_name} (prefix {prefix}) from {path}: {e}') from e
        min_ver = getattr(model, '_kraken_min_version', '5.0.0')
        if _version_tuple(min_ver) > _version_tuple(KRAKEN_COMPAT_VERSION):
            logger.warning(f'Model {prefix} in model file {path} declares a minimum supported '
                           f'kraken version of {min_ver} (this build supports {KRAKEN_COMPAT_VERSION})')
            continue
        models[prefix] = model

    # Tied-weight backfill: safetensors writers store shared tensors once,
    # so a model whose weights alias another model's keeps its metadata
    # prefix but loses the duplicate keys. Restore them from the surviving
    # twin: the same per-model key suffix under another prefix.
    by_suffix: dict[str, list[str]] = {}
    for k in state_dict:
        for p in models:
            if k.startswith(p + '.'):
                by_suffix.setdefault(k[len(p) + 1:], []).append(k)
                break
    for prefix, model in models.items():
        sub = {k: v for k, v in state_dict.items() if k.startswith(prefix + '.')}
        for key in model.state_dict():
            full = f'{prefix}.{key}'
            if full not in sub and by_suffix.get(key):
                sub[full] = state_dict[by_suffix[key][0]]
        sub = {k: v.astype(np.float32) if v.dtype == np.float16 else v for k, v in sub.items()}
        try:
            model.load_state_dict(sub, prefix=f'{prefix}.nn.')
        except Exception as e:
            raise RuntimeError(f'Weight tensors failed to apply from {path} for model {prefix}: {e}') from e
    return list(models.values())


def load_coreml(path: Union[str, PathLike], tasks: Optional[Sequence[_T_tasks]] = None) -> list:
    """
    Loads the models of a kraken CoreML .mlmodel file: its network and the
    reading-order models of its auxiliary layers.

    Metadata lives in the protobuf's user-defined metadata dict (`vgsl`,
    `codec`, `kraken_meta`, `aux_layers`); weights are extracted from the
    neural network layer messages (convolution/innerProduct/LSTM/custom).
    """
    from kraken_tpu_torch.models import _coreml

    try:
        spec = _coreml.parse_mlmodel(Path(path).read_bytes())
    except Exception as e:
        raise ValueError(f'CoreML protobuf parse failed: {e}') from e

    user_meta = spec.user_defined_metadata
    has_kraken_meta = 'kraken_meta' in user_meta
    try:
        metadata = json.loads(user_meta.get('kraken_meta', '{}'))
    except json.JSONDecodeError as e:
        raise ValueError(f'Unparseable `kraken_meta` JSON in {path}: {e}') from e
    if not isinstance(metadata, dict):
        raise ValueError(f'Malformed `kraken_meta` record in {path}: expected object, '
                         f'got {type(metadata).__name__}.')
    model_type = metadata.get('model_type')
    if isinstance(model_type, str):
        model_type = [model_type] if model_type else []
    if not isinstance(model_type, list) or not model_type or not all(isinstance(x, str) and x for x in model_type):
        if has_kraken_meta:
            raise ValueError(f'Unrecognized `model_type` metadata in {path}.')
        # pre-kraken_meta model files are always recognition models
        logger.warning(f'`kraken_meta` absent from {path}; treating as a legacy recognition model.')
        model_type = ['recognition']
    metadata['model_type'] = model_type
    vgsl_spec = user_meta.get('vgsl') or metadata.get('vgsl')
    metadata.pop('codec', None)
    metadata.pop('vgsl', None)
    if not vgsl_spec:
        raise ValueError(f'Model metadata lacks a VGSL spec for {path}')
    if tasks and not set(model_type).intersection(tasks):
        logger.info(f'Model file {path} not in demanded tasks {tasks}')
        return []
    codec = json.loads(user_meta.get('codec', 'null'))
    try:
        model = create_model('TorchVGSLModel', vgsl=vgsl_spec, codec=codec, **metadata)
    except Exception as e:
        raise ValueError(f'Failed to create VGSL model from {path}: {e}') from e

    weights = _coreml.extract_weights(spec, model)
    try:
        model.load_state_dict(weights, prefix='nn.')
    except Exception as e:
        raise ValueError(f'CoreML weight import failed for {path}: {e}') from e
    models = [model]

    if 'aux_layers' in user_meta:
        logger.info('Importing auxiliary (reading order) layers.')
        for name in json.loads(user_meta['aux_layers']).keys():
            if name == 'ro_model':
                level = 'baselines'
            elif name == 'ro_model_regions':
                level = 'regions'
            else:
                logger.warning(f'Unrecognized auxiliary layer key {name}, skipping.')
                continue
            class_mapping = model.user_metadata.get('class_mapping', {}).get(level, {})
            try:
                romlp = create_model('ROMLP', class_mapping=class_mapping, level=level)
                romlp.load_coreml_weights(name, spec)
                models.append(romlp)
            except Exception as e:
                logger.warning(f'Failed to load auxiliary layer {name}: {e}')
    return models
