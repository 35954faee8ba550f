"""
The JAX configs' keys in the port's configs (kraken_tpu_torch.configs):
``accelerator``, ``compile``, ``num_threads``, ``linetype`` and
``device_pipeline_depth`` have no consumer in the port, so each is recorded
in PERF.md §6 "Not ported, by decision" and warned about as unknown; the
keys both packages read keep the JAX defaults.

The training and data configs keep the JAX keys and defaults; each
training key is stored and reaches its consumer (the optimizer, the
schedule, the data and task modules, the trainer) with no warning;
``devices`` (ROADMAP.md queue 1 item 10, which first left it unread) is
stored too, and asking for more cards than are visible is a usage error.
"""
import tests.test_torch_threads  # noqa: F401  (first: the thread share under xdist)
import logging
from pathlib import Path

import pytest
import torch

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
                                         'bidi_reordering', 'text_direction', 'input_transfer',
                                         'line_extraction', 'devices'),
          'SegmentationInferenceConfig': ('precision', 'batch_size', 'raise_on_error',
                                          'text_direction', 'legacy_scale', 'legacy_maxcolseps',
                                          'legacy_black_colseps', 'legacy_no_hlines',
                                          'bbox_line_padding', 'input_padding',
                                          'ridge_threshold', 'heatmap_precision',
                                          'input_transfer', 'device_vectorize',
                                          'width_bucketing', 'fused_ridge', 'devices')}


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


# training keys and their consumers in the port, by config class (the
# 'devices' case: the key that warned until its ROADMAP item brought its
# consumer)
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
TRAINING_KEYS = [case for case in DEFERRED if case[3] == '9b']
# keys both packages read, by config class
SHARED_TRAINING = {
    'RecognitionTrainingConfig': ('precision', 'batch_size', 'raise_on_error', 'epochs', 'freq',
                                  'optimizer', 'lrate', 'momentum', 'weight_decay',
                                  'gradient_clip_val', 'accumulate_grad_batches', 'schedule',
                                  'warmup', 'step_size', 'gamma', 'rop_factor', 'rop_patience',
                                  'cos_t_max', 'cos_min_lr', 'quit', 'save_top_k', 'min_epochs',
                                  'lag', 'min_delta', 'remat', 'spec', 'resize',
                                  'freeze_backbone', 'devices'),
    'SegmentationTrainingConfig': ('precision', 'batch_size', 'raise_on_error', 'bl_tol', 'spec',
                                   'resize', 'topline', 'dice_weight', 'lrate', 'optimizer'),
    'ReadingOrderTrainingConfig': ('level', 'reading_order', 'lrate', 'optimizer', 'devices'),
    'PretrainingConfig': ('spec', 'mask_width', 'mask_prob', 'num_negatives', 'logit_temp',
                          'lrate', 'optimizer', 'gradient_clip_val', 'epochs', 'freq',
                          'schedule', 'save_top_k'),
    'RecognitionTrainingDataConfig': ('evaluation_data', 'test_data', 'num_workers', 'augment',
                                      'batch_size', 'binary_dataset_split', 'format_type',
                                      'linetype', 'pad', 'normalization',
                                      'normalize_whitespace', 'reorder', 'training_data',
                                      'partition', 'codec'),
    'SegmentationTrainingDataConfig': ('evaluation_data', 'test_data', 'num_workers', 'augment',
                                       'batch_size', 'format_type', 'line_width', 'padding',
                                       'training_data', 'partition', 'topline')}

RESOURCES = Path(__file__).resolve().parent / 'resources'
PAGE = str(RESOURCES / '170025120000003,0074.xml')
LINES = [str(RESOURCES / 'merge_tests' / f'{n}.jpg') for n in ('0006', '0007')]


def _consumes(key, config, tmp_path) -> bool:
    """Whether the key's consumer in the port acts on `config`'s value."""
    from kraken_tpu_torch import train
    from kraken_tpu_torch.models import load_models
    if key in ('lrate', 'optimizer', 'schedule'):
        opt = train.Optimizer([torch.zeros(3, requires_grad=True)], config, steps_per_epoch=1)
        return {'lrate': opt.lr() == 1e-2,
                'optimizer': isinstance(opt.torch_opt, torch.optim.SGD),
                'schedule': train.build_lr_schedule(config, 1)(5) < config.lrate}[key]
    if key == 'spec':
        dm = train.SegmentationDataModule(configs.SegmentationTrainingDataConfig(
            training_data=[PAGE], evaluation_data=[PAGE]))
        dm.setup('fit')
        config.device = 'cpu'
        module = train.SegmentationModel(config)
        module.setup('fit', dm)
        return module.net.spec.startswith('[1,64,0,3 Cr3,3,4 O2l')
    if key == 'resize':
        net = load_models(RESOURCES / 'overfit_bl.safetensors')[0]
        before = net.output[1]
        dm = train.RecognitionDataModule(configs.RecognitionTrainingDataConfig(
            format_type='binary', training_data=[str(RESOURCES / 'merge_tests' / 'base.arrow')]))
        dm.setup('fit')
        config.device = 'cpu'
        train.RecognitionModel(config, net=net).setup('fit', dm)
        return net.output[1] > before
    if key == 'epochs':
        config.device, config.checkpoint_path = 'cpu', str(tmp_path / 'ro')
        trainer = train.KrakenTrainer(config)
        trainer.fit(train.ROModel(config), train.RODataModule(
            configs.TrainingDataConfig(training_data=[PAGE], evaluation_data=[PAGE],
                                       batch_size=4096),
            class_mapping={'default': 0, '$pag': 0, '$tip': 0, '$par': 0, '$pac': 0}))
        return trainer.current_epoch == 2 and trainer.global_step == 3
    if key == 'training_data':
        dm = train.RecognitionDataModule(config)
        with pytest.raises(FileNotFoundError, match='a.xml'):
            dm.setup('fit')
        return True
    if key == 'partition':
        config.training_data = [PAGE, PAGE]
        dm = train.SegmentationDataModule(config)
        dm.setup('fit')
        return len(dm.train_set) == len(dm.val_set) == 1
    if key == 'codec':
        config.format_type, config.training_data, config.evaluation_data = 'path', LINES, LINES
        dm = train.RecognitionDataModule(config)
        dm.setup('fit')
        module = train.RecognitionModel(configs.RecognitionTrainingConfig(
            device='cpu', spec='[1,32,0,1 Cr3,3,4,2,2 S1(1x0)1,3 Lbx8]'))
        module.setup('fit', dm)
        return module.net.codec.c2l == {'a': [1]}
    # topline of the data config: stored as the JAX package stores it (the
    # training config's topline is what the model records)
    return config.topline is getattr(jax_configs.SegmentationTrainingDataConfig(topline=True),
                                     'topline')


@pytest.mark.parametrize('key, cls, value, item', TRAINING_KEYS,
                         ids=[f'{k}-{c}' for k, c, _, _ in TRAINING_KEYS])
def test_training_key_reaches_its_consumer(key, cls, value, item, caplog, tmp_path):
    caplog.set_level(logging.WARNING)
    config = getattr(configs, cls)(**{key: value})
    assert getattr(config, key) == value
    assert caplog.records == []
    assert _consumes(key, config, tmp_path)


@pytest.mark.parametrize('key, cls, value, item', [c for c in DEFERRED if c[3] != '9b'],
                         ids=[f'{k}-{c}' for k, c, _, i in DEFERRED if i != '9b'])
def test_training_key_warns_with_its_item(key, cls, value, item, caplog, monkeypatch):
    """The key that warned until its ROADMAP item (10, multi-GPU) brought its
    consumer: now stored with no warning, and ``ketos --devices`` with more
    cards than are visible is a usage error naming how many are."""
    import click
    from kraken_tpu_torch.ketos.util import build_device_mesh
    caplog.set_level(logging.WARNING)
    kwargs = {} if 'Data' in cls else {'device': 'cpu'}
    config = getattr(configs, cls)(**kwargs, **{key: value})
    assert getattr(config, key) == value
    assert caplog.records == []
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    with pytest.raises(click.UsageError, match=f'--devices {value} requested but only 1 CUDA'):
        build_device_mesh(config.devices, 'cuda')


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
