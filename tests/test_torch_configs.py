"""
The JAX configs' keys in the port's configs (kraken_tpu_torch.configs):
``accelerator``, ``compile``, ``num_threads``, ``linetype`` and
``device_pipeline_depth`` have no consumer in the port, so each is recorded
in PERF.md §6 "Not ported, by decision" and warned about as unknown; the
keys both packages read keep the JAX defaults.
"""
import logging

import pytest

from kraken_tpu.configs import base as jax_configs
from kraken_tpu_torch import configs

# key, config class, value: recorded in PERF.md §6, the port warns
RECORDED = [('accelerator', 'RecognitionInferenceConfig', 'cpu'),
            ('compile', 'SegmentationInferenceConfig', {'mode': 'default'}),
            ('device_pipeline_depth', 'RecognitionInferenceConfig', 2),
            ('num_threads', 'RecognitionInferenceConfig', 4),
            ('num_threads', 'SegmentationInferenceConfig', 4),
            ('linetype', 'RecognitionInferenceConfig', 'bbox')]
# keys both packages read, by config class
SHARED = {'RecognitionInferenceConfig': ('precision', 'batch_size', 'raise_on_error',
                                         'temperature', 'return_logits', 'return_line_image',
                                         'padding', 'num_line_workers', 'no_legacy_polygons',
                                         'bidi_reordering', 'text_direction'),
          'SegmentationInferenceConfig': ('precision', 'batch_size', 'raise_on_error',
                                          'text_direction', 'legacy_scale', 'legacy_maxcolseps',
                                          'legacy_black_colseps', 'legacy_no_hlines',
                                          'bbox_line_padding', 'input_padding',
                                          'ridge_threshold')}


def _warnings(caplog) -> list[str]:
    return [r.getMessage() for r in caplog.records
            if 'Ignoring unknown configuration parameters' in r.getMessage()]


@pytest.mark.parametrize('key, cls, value', RECORDED, ids=[f'{k}-{c}' for k, c, _ in RECORDED])
def test_recorded_key_warns(key, cls, value, caplog):
    caplog.set_level(logging.WARNING)
    config = getattr(configs, cls)(device='cpu', **{key: value})
    assert not hasattr(config, key)
    assert _warnings(caplog) == [f'Ignoring unknown configuration parameters: {[key]}']


@pytest.mark.parametrize('cls', sorted(SHARED))
def test_shared_keys_keep_the_jax_defaults(cls, caplog):
    caplog.set_level(logging.WARNING)
    port, jax = getattr(configs, cls)(), getattr(jax_configs, cls)()
    assert {k: getattr(port, k) for k in SHARED[cls]} == {k: getattr(jax, k) for k in SHARED[cls]}
    assert _warnings(caplog) == []
