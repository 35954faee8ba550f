"""
kraken_tpu_torch.ro.layers
~~~~~~~~~~~~~~~~~~~~~~~~~~

Neural reading-order model: a 2-layer MLP scoring pairwise order relations
between line/region spatial features (reference: kraken/lib/ro/layers.py),
the counterpart of the JAX package's ``ro/layers.py``. Feature size is
2·num_classes + 12 (one-hot class + center/start/end points of both
elements). Its forward is two plain linear layers (cuBLAS on the card, as
the JAX package leaves them to XLA).
"""
import logging
from typing import Optional

import numpy as np
import torch

from kraken_tpu_torch.exceptions import KrakenInvalidModelException

logger = logging.getLogger(__name__)

__all__ = ['ROMLP']


class ROMLP(torch.nn.Module):
    """
    A 2-layer MLP for reading order determination. Its parameters are
    ``nn.fc1`` and ``nn.fc2`` (``torch.nn.Linear``), so its state dict has
    the keys of kraken model files (``nn.fc1.weight``, ...). It is built on
    the CPU; :meth:`prepare_for_inference` places it.
    """

    _kraken_min_version = '5.0.0'
    model_type = ['reading_order']

    def __init__(self, generator: Optional[torch.Generator] = None, **kwargs):
        """
        Args:
            generator: source of the fresh parameters; a generator seeded
                from numpy's global state when omitted.
            kwargs: metadata, kept in ``user_metadata``; needs
                `class_mapping` and `level`.
        """
        super().__init__()
        self.class_mapping = kwargs.get('class_mapping')
        if self.class_mapping is None:
            raise ValueError('Reading order model arguments lack `class_mapping`.')
        self.level = kwargs.get('level')
        if self.level is None:
            raise ValueError('Reading order model arguments lack `level`.')
        self.user_metadata = dict(kwargs)
        num_classes = max(0, *self.class_mapping.values()) + 1 if self.class_mapping else 1
        self.feature_size = 2 * num_classes + 12
        self.hidden_size = self.feature_size * 2
        if generator is None:
            generator = torch.Generator().manual_seed(int(np.random.randint(0, 2**31 - 1)))
        self.nn = torch.nn.ModuleDict({'fc1': torch.nn.Linear(self.feature_size, self.hidden_size),
                                       'fc2': torch.nn.Linear(self.hidden_size, 1)})
        for layer in self.nn.values():
            torch.nn.init.xavier_uniform_(layer.weight, generator=generator)
            torch.nn.init.zeros_(layer.bias)
        self.eval()

    @property
    def device(self) -> torch.device:
        """The device the parameters lie on."""
        return self.nn['fc1'].weight.device

    def forward(self, x) -> torch.Tensor:
        """(pairs, feature_size) features, an array or a tensor, to
        (pairs, 1) order logits on the model's device."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        return self.nn['fc2'](torch.relu(self.nn['fc1'](x)))

    def prepare_for_inference(self, config) -> None:
        """Places the model on the device of `config` (raising when a CUDA
        device is asked for and there is none), in float32."""
        from kraken_tpu_torch.inference.recognition import resolve_device
        self.to(device=resolve_device(config.device), dtype=torch.float32)
        self.eval()

    # --------------------------------------------------------- persistence
    def _assign(self, arrays: dict) -> None:
        own = self.state_dict()
        with torch.no_grad():
            for key, value in arrays.items():
                own[key].copy_(torch.as_tensor(np.array(value)).to(own[key].dtype))

    def load_state_dict(self, state_dict: dict, prefix: str = 'nn.') -> None:
        """
        Loads a flat state dict (numpy arrays or tensors) whose keys are
        `prefix` followed by ``fc1.weight``, ... The JAX package's errors:
        a missing key or a wrong shape raises ``ValueError``.
        """
        arrays = {}
        for key, target in self.state_dict().items():
            full = f'{prefix}{key[len("nn."):]}'
            if full not in state_dict:
                raise ValueError(f'Missing key {full} in state dict')
            arr = np.asarray(state_dict[full])
            if arr.shape != tuple(target.shape):
                raise ValueError(f'Shape mismatch for {full}')
            arrays[key] = arr
        self._assign(arrays)

    def from_jax_state_dict(self, sd: dict) -> None:
        """
        Loads the output of the JAX package's ``ROMLP.state_dict()`` (numpy
        arrays under ``nn.fc1.weight``, ...; linear weights (out, in)). An
        unknown key, a missing one or a wrong shape raises.
        """
        own = self.state_dict()
        unknown = sorted(k for k in sd if k not in own)
        if unknown:
            raise KrakenInvalidModelException(f'Unknown keys in JAX state dict: {unknown}')
        missing = sorted(k for k in own if k not in sd)
        if missing:
            raise KrakenInvalidModelException(f'Missing keys in JAX state dict: {missing}')
        bad = sorted(k for k in own if np.shape(sd[k]) != tuple(own[k].shape))
        if bad:
            raise KrakenInvalidModelException(f'Shape mismatch in JAX state dict: {bad}')
        self._assign(sd)

    def load_coreml_weights(self, name: str, spec) -> None:
        """Loads weights from a CoreML spec's `{name}_mlp_lin_{0,1}` layers."""
        from kraken_tpu_torch.models._coreml import _floats, _submessages
        arrays = {}
        for idx, (layer, rows, cols) in enumerate([('fc1', self.hidden_size, self.feature_size),
                                                    ('fc2', 1, self.hidden_size)]):
            coreml_layer = spec.layer(f'{name}_mlp_lin_{idx}')
            if coreml_layer is None:
                raise ValueError(f'CoreML layer {name}_mlp_lin_{idx} not found')
            fields = _submessages(coreml_layer.body)
            arrays[f'nn.{layer}.weight'] = _floats(fields[20][0]).reshape(rows, cols)
            arrays[f'nn.{layer}.bias'] = _floats(fields[21][0])
        self._assign(arrays)
