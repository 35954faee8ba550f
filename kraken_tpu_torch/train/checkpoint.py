"""
kraken_tpu_torch.train.checkpoint
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

Training checkpoints, the counterpart of the JAX package's
``train/checkpoint.py``: one safetensors file (the port's own writer,
``models/_safetensors.py``) holding the model's weights in the kraken
container layout, so that every checkpoint is also a model file that both
packages load, plus the optimizer's state under a reserved
``__training__.torch.`` prefix and a ``training_meta`` JSON block (epoch,
step, config, extras).

The optimizer state is the port's own (``train/optim.py:Optimizer``); the
JAX package keeps optax's under ``__training__.opt.``. Resuming from a JAX
checkpoint restores the weights and the counters and skips the optimizer
state with a warning, as the JAX package does when a state does not match.
"""
import json
import logging
import uuid
from os import PathLike
from pathlib import Path
from typing import Any, Optional, Union

import numpy as np
import torch

from kraken_tpu_torch.models.writers import _model_metadata, state_arrays

logger = logging.getLogger(__name__)

__all__ = ['save_checkpoint', 'load_checkpoint', 'convert_checkpoint', 'config_from_checkpoint']

OPT_PREFIX = '__training__.torch.'
JAX_OPT_PREFIX = '__training__.opt.'


def config_from_checkpoint(training_meta: dict):
    """
    Re-inflates the training config recorded in a checkpoint's metadata
    into its class of :mod:`kraken_tpu_torch.configs` (values came through
    JSON with ``default=str``). None when no class is recorded.
    """
    from kraken_tpu_torch import configs
    hyper_params = dict(training_meta.get('hyper_params', {}))
    name = hyper_params.pop('config_class', None)
    if name is None:
        return None
    cls = getattr(configs, name, None)
    if not isinstance(cls, type):
        raise ValueError(f'No config class {name!r}')
    return cls(**hyper_params)


def save_checkpoint(model, optimizer, path: Union[str, PathLike], epoch: int = 0,
                    global_step: int = 0, hyper_params: Optional[dict] = None,
                    extras: Optional[dict[str, Any]] = None,
                    tensors: Optional[dict[str, np.ndarray]] = None) -> None:
    """Writes a resumable checkpoint that also loads as a plain model file;
    `optimizer` is a ``train.optim.Optimizer`` or None, `tensors` arrays
    kept under the model's key prefix beside its parameters (pretraining's
    ``nn.__pretrain__.*``, which the model loaders ignore)."""
    from kraken_tpu_torch.models._safetensors import write_safetensors

    prefix = str(uuid.uuid4())
    arrays = {f'{prefix}.{k}': v for k, v in {**state_arrays(model), **(tensors or {})}.items()}
    if optimizer is not None:
        for k, v in optimizer.state_tensors().items():
            arrays[f'{OPT_PREFIX}{k}'] = v.detach().cpu().numpy()
    meta = {'epoch': epoch, 'global_step': global_step, 'hyper_params': hyper_params or {},
            'prefix': prefix}
    meta.update(extras or {})
    write_safetensors(Path(path), arrays,
                      {'kraken_meta': json.dumps({prefix: _model_metadata(model)}),
                       'training_meta': json.dumps(meta, default=str)})


def load_checkpoint(path: Union[str, PathLike], optimizer=None):
    """
    Loads a checkpoint: returns (model, training_meta). With `optimizer`
    (a ``train.optim.Optimizer`` over the model's parameters in the order
    it was saved with) its state is restored; a checkpoint without the
    port's optimizer state (the JAX package's, or none) leaves it as it is
    and warns.
    """
    from kraken_tpu_torch.models._safetensors import read_safetensors
    from kraken_tpu_torch.models.loaders import load_safetensors

    models = load_safetensors(path)
    if not models:
        raise ValueError(f'No model found in checkpoint {path}')
    metadata, tensors = read_safetensors(path)
    training_meta = json.loads(metadata.get('training_meta', '{}'))
    if optimizer is not None:
        state = {k[len(OPT_PREFIX):]: torch.from_numpy(np.array(v))
                 for k, v in tensors.items() if k.startswith(OPT_PREFIX)}
        if state:
            optimizer.load_state_tensors(state)
        else:
            n_jax = sum(k.startswith(JAX_OPT_PREFIX) for k in tensors)
            logger.warning(f'Optimizer state in {path} does not match this optimizer '
                           f'({n_jax} arrays of the JAX package\'s optax state, none of the '
                           'port\'s); skipping restore.')
    return models[0], training_meta


def convert_checkpoint(path: Union[str, PathLike], output: Union[str, PathLike],
                       format: str = 'safetensors') -> None:
    """Strips the training state from a checkpoint into a plain weights file
    (reference: kraken/models/convert.py convert_models)."""
    from kraken_tpu_torch.models import load_models, write_models
    write_models(load_models(path), output, format=format)
