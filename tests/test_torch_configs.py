"""
The JAX configs' keys in the port's configs (kraken_tpu_torch.configs):
``accelerator``, ``compile``, ``num_threads``, ``linetype`` and
``device_pipeline_depth`` have no consumer in the port, so each is recorded
in PERF.md §6 "Not ported, by decision" and warned about as unknown; the
keys both packages read keep the JAX defaults.

The training and data configs serve evaluation so far: the keys only a
training loop reads warn that nothing reads them until ROADMAP.md queue 1
item 9b, ``devices`` until item 10, each named in the warning; the keys
evaluation reads keep the JAX defaults.
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


# training keys the port drops until their ROADMAP item, by config class
DEFERRED = [('lrate', 'RecognitionTrainingConfig', 1e-2, '9b'),
            ('optimizer', 'SegmentationTrainingConfig', 'SGD', '9b'),
            ('schedule', 'RecognitionTrainingConfig', 'cosine', '9b'),
            ('spec', 'SegmentationTrainingConfig', '[1,64,0,3 Cr3,3,4]', '9b'),
            ('resize', 'RecognitionTrainingConfig', 'union', '9b'),
            ('epochs', 'TrainingConfig', 3, '9b'),
            ('devices', 'RecognitionTrainingConfig', 4, '10'),
            ('training_data', 'RecognitionTrainingDataConfig', ['a.xml'], '9b'),
            ('partition', 'SegmentationTrainingDataConfig', 0.5, '9b'),
            ('codec', 'RecognitionTrainingDataConfig', {'a': [1]}, '9b'),
            ('topline', 'SegmentationTrainingDataConfig', True, '9b')]
# evaluation keys both packages read, by config class
SHARED_TRAINING = {
    'RecognitionTrainingConfig': ('precision', 'batch_size', 'raise_on_error'),
    'SegmentationTrainingConfig': ('precision', 'batch_size', 'raise_on_error', 'bl_tol'),
    'RecognitionTrainingDataConfig': ('evaluation_data', 'test_data', 'num_workers', 'augment',
                                      'batch_size', 'binary_dataset_split', 'format_type',
                                      'linetype', 'pad', 'normalization',
                                      'normalize_whitespace', 'reorder'),
    'SegmentationTrainingDataConfig': ('evaluation_data', 'test_data', 'num_workers', 'augment',
                                       'batch_size', 'format_type', 'line_width', 'padding')}


@pytest.mark.parametrize('key, cls, value, item', DEFERRED,
                         ids=[f'{k}-{c}' for k, c, _, _ in DEFERRED])
def test_training_key_warns_with_its_item(key, cls, value, item, caplog):
    caplog.set_level(logging.WARNING)
    kwargs = {} if 'Data' in cls else {'device': 'cpu'}
    config = getattr(configs, cls)(**kwargs, **{key: value})
    assert not hasattr(config, key)
    what = {'9b': 'the training loops', '10': 'multi-GPU'}[item]
    assert [r.getMessage() for r in caplog.records] == [
        f'Ignoring configuration parameters {[key]}: nothing reads them until '
        f'ROADMAP.md queue 1 item {item} ({what})']


@pytest.mark.parametrize('cls', sorted(SHARED_TRAINING))
def test_training_keys_keep_the_jax_defaults(cls, caplog):
    caplog.set_level(logging.WARNING)
    port, jax = getattr(configs, cls)(), getattr(jax_configs, cls)()
    keys = SHARED_TRAINING[cls]
    assert {k: getattr(port, k) for k in keys} == {k: getattr(jax, k) for k in keys}
    assert caplog.records == []


def test_class_mappings_count_from_two():
    """Auto-assigned line and region classes share one counter from 2, as
    the JAX package assigns them."""
    port = configs.SegmentationTrainingDataConfig()
    jax = jax_configs.SegmentationTrainingDataConfig()
    for c in (port, jax):
        c.line_class_mapping['a'], c.region_class_mapping['r'], c.line_class_mapping['b']
    assert dict(port.line_class_mapping) == dict(jax.line_class_mapping) == {'a': 2, 'b': 4}
    assert dict(port.region_class_mapping) == dict(jax.region_class_mapping) == {'r': 3}
