"""
The port's training loops on the CPU: the JAX package's
``tests/test_training.py`` cases that need no mesh and no pretraining, run
on the port (one-epoch fits of tiny recognition, segmentation and
reading-order models on the test corpus, codec resizing, ``remat``,
resume, ``freeze_backbone``, the abort checkpoint, top-K pruning,
reduce-on-plateau, fractional ``freq``, the ``tpu`` preset, an oversized
batch, a transformer spec), and checkpoints that load as models in both
packages.
"""
import tests.test_torch_threads  # noqa: F401  (first: the thread share under xdist)
import logging
import warnings

import numpy as np
import pytest
import torch

from kraken_tpu_torch.configs import (ReadingOrderTrainingConfig, RecognitionTrainingConfig,
                                      RecognitionTrainingDataConfig, SegmentationTrainingConfig,
                                      SegmentationTrainingDataConfig, TrainingDataConfig)
from kraken_tpu_torch.train import (KrakenTrainer, RecognitionDataModule, RecognitionModel,
                                    RODataModule, ROModel, SegmentationDataModule,
                                    SegmentationModel, load_checkpoint)

TINY_REC_SPEC = '[1,32,0,1 Cr3,3,4,2,2 S1(1x0)1,3 Lbx8 Do0.1,2]'
TINY_SEG_SPEC = '[1,64,0,3 Cr3,3,4,2,2 Gn2]'


@pytest.fixture(scope='module', autouse=True)
def quiet():
    warnings.filterwarnings('ignore')


def _path_data(resources, batch_size, train=('000236.png', 'merge_tests/0006.jpg',
                                             'merge_tests/0007.jpg', 'merge_tests/0008.jpg')):
    return RecognitionTrainingDataConfig(
        format_type='path', training_data=[str(resources / f) for f in train],
        evaluation_data=[str(resources / 'merge_tests' / '0021.jpg')], batch_size=batch_size)


def _binary_data(resources, batch_size=1, **kw):
    return RecognitionTrainingDataConfig(
        format_type='binary', training_data=[str(resources / 'merge_tests' / 'base.arrow')],
        batch_size=batch_size, **kw)


def _rec_config(tmp_path, **kw):
    kw.setdefault('spec', TINY_REC_SPEC)
    kw.setdefault('epochs', 1)
    kw.setdefault('lrate', 1e-3)
    return RecognitionTrainingConfig(checkpoint_path=str(tmp_path / 'model'), device='cpu', **kw)


def test_recognition_training_smoke(resources, tmp_path):
    config = _rec_config(tmp_path, warmup=1)
    dm = RecognitionDataModule(_path_data(resources, 2))
    module = RecognitionModel(config)
    KrakenTrainer(config, fast_dev_run=True).fit(module, dm)
    assert module.net.codec is not None
    ckpts = list(tmp_path.glob('model_*.safetensors'))
    assert ckpts
    # checkpoints load as plain model files, in both packages
    model, meta = load_checkpoint(ckpts[0])
    assert model.codec.c2l == module.net.codec.c2l
    assert meta['global_step'] == 1
    from kraken_tpu.models import load_models as jax_load_models
    jax_model = jax_load_models(ckpts[0])[0]
    assert jax_model.codec.c2l == module.net.codec.c2l
    # the trained net is back in evaluation mode with frozen parameters
    assert not module.net.net.training
    assert not any(p.requires_grad for p in module.net.net.parameters())


def test_recognition_training_binary(resources, tmp_path):
    config = _rec_config(tmp_path)
    dm = RecognitionDataModule(_binary_data(resources, 2))
    module = RecognitionModel(config)
    KrakenTrainer(config, fast_dev_run=True).fit(module, dm)
    assert 'val_accuracy' in module.validate(dm)


def test_recognition_resize_union(resources, tmp_path):
    from kraken_tpu_torch.models import load_models
    net = load_models(resources / 'overfit_bl.safetensors')[0]
    old_out = net.output[1]
    config = _rec_config(tmp_path, resize='union')
    module = RecognitionModel(config, net=net)
    KrakenTrainer(config, fast_dev_run=True).fit(module, RecognitionDataModule(
        _binary_data(resources, 2)))
    assert module.net.output[1] >= old_out


def test_recognition_resize_fail(resources, tmp_path):
    from kraken_tpu_torch.models import load_models
    net = load_models(resources / 'overfit_bl.safetensors')[0]
    config = _rec_config(tmp_path)
    with pytest.raises(ValueError, match='does not cover'):
        KrakenTrainer(config, fast_dev_run=True).fit(RecognitionModel(config, net=net),
                                                     RecognitionDataModule(
                                                         _binary_data(resources, 2)))


def test_segmentation_training_smoke(resources, tmp_path):
    config = SegmentationTrainingConfig(spec=TINY_SEG_SPEC, epochs=1, lrate=1e-3, device='cpu',
                                        checkpoint_path=str(tmp_path / 'segmodel'))
    page = str(resources / '170025120000003,0074.xml')
    dm = SegmentationDataModule(SegmentationTrainingDataConfig(
        training_data=[page], evaluation_data=[page], batch_size=1))
    module = SegmentationModel(config)
    KrakenTrainer(config, fast_dev_run=True).fit(module, dm)
    assert 'class_mapping' in module.net.user_metadata
    assert 0 <= module.validate(dm)['val_mean_iu'] <= 1
    model, _ = load_checkpoint(tmp_path / 'segmodel_best.safetensors')
    assert model.user_metadata['class_mapping'] == module.net.user_metadata['class_mapping']


def test_ro_training_smoke(resources, tmp_path):
    config = ReadingOrderTrainingConfig(epochs=1, lrate=1e-3, device='cpu',
                                        checkpoint_path=str(tmp_path / 'ro'))
    page = str(resources / '170025120000003,0074.xml')
    dm = RODataModule(TrainingDataConfig(training_data=[page], evaluation_data=[page],
                                         batch_size=8),
                      class_mapping={'default': 0, '$pag': 0, '$tip': 0, '$par': 0, '$pac': 0})
    module = ROModel(config)
    KrakenTrainer(config, fast_dev_run=True).fit(module, dm)
    assert 'val_spearman' in module.validate(dm)
    from kraken_tpu.models import load_models as jax_load_models
    assert jax_load_models(tmp_path / 'ro_best.safetensors')


def test_recognition_training_remat(resources, tmp_path):
    """The rematerialised step gives the plain step's loss and gradients,
    dropout masks included (the generator's draws replay)."""
    results = []
    for remat in (False, True):
        config = _rec_config(tmp_path, remat=remat)
        dm = RecognitionDataModule(_binary_data(resources))
        dm.setup('fit')
        np.random.seed(0)
        module = RecognitionModel(config)
        module.setup('fit', dm)
        module.generator = torch.Generator().manual_seed(3)
        for m in module.net.net.modules():
            if hasattr(m, 'generator'):
                m.generator = module.generator
        batch = next(iter(dm.train_dataloader()))
        loss = module.loss_fn(batch)
        loss.backward()
        results.append((loss.item(), [p.grad.clone() for p in module.parameters()]))
    (l0, g0), (l1, g1) = results
    assert np.isfinite(l1) and l0 == l1
    assert any(g.abs().sum() > 0 for g in g1)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b)


def test_recognition_training_resume(resources, tmp_path):
    """A checkpoint resumes with weights, optimizer state and epoch
    counter."""
    config = _rec_config(tmp_path)
    trainer = KrakenTrainer(config, fast_dev_run=True)
    trainer.fit(RecognitionModel(config), RecognitionDataModule(_binary_data(resources)))
    ckpt = trainer._ckpt_path('0')
    assert ckpt.exists()
    config2 = RecognitionTrainingConfig(spec=TINY_REC_SPEC, epochs=2, lrate=1e-3, device='cpu',
                                        checkpoint_path=str(tmp_path / 'model2'))
    trainer2 = KrakenTrainer(config2, fast_dev_run=True)
    module2 = RecognitionModel(config2)
    trainer2.fit(module2, RecognitionDataModule(_binary_data(resources)), resume=str(ckpt))
    assert config2.completed_epochs == 1
    assert trainer2.current_epoch >= 1
    # the optimizer's state came back: its step count continued
    assert trainer2.optimizer.count == trainer.optimizer.count + 1


def test_resume_from_a_jax_checkpoint_skips_its_optimizer_state(resources, tmp_path, caplog):
    from kraken_tpu.configs import RecognitionTrainingConfig as JaxConfig
    from kraken_tpu.train import KrakenTrainer as JaxTrainer
    from kraken_tpu.train import RecognitionDataModule as JaxDM
    from kraken_tpu.train import RecognitionModel as JaxModel
    from kraken_tpu.configs import RecognitionTrainingDataConfig as JaxData
    jconfig = JaxConfig(spec=TINY_REC_SPEC, epochs=1, lrate=1e-3,
                        checkpoint_path=str(tmp_path / 'jax'))
    jtrainer = JaxTrainer(jconfig, fast_dev_run=True)
    jtrainer.fit(JaxModel(jconfig), JaxDM(JaxData(
        format_type='binary', training_data=[str(resources / 'merge_tests' / 'base.arrow')],
        batch_size=1)))
    ckpt = jtrainer._ckpt_path('0')
    config = RecognitionTrainingConfig(spec=TINY_REC_SPEC, epochs=2, lrate=1e-3, device='cpu',
                                       checkpoint_path=str(tmp_path / 'port'))
    trainer = KrakenTrainer(config, fast_dev_run=True)
    with caplog.at_level(logging.WARNING):
        trainer.fit(RecognitionModel(config), RecognitionDataModule(_binary_data(resources)),
                    resume=str(ckpt))
    assert any('skipping restore' in r.message for r in caplog.records)
    assert config.completed_epochs == 1 and trainer.global_step == 2


def test_training_tensorboard_logger(resources, tmp_path):
    pytest.importorskip('torch.utils.tensorboard')
    config = _rec_config(tmp_path, loggers='tensorboard')
    KrakenTrainer(config, fast_dev_run=True, log_dir=str(tmp_path / 'runs')).fit(
        RecognitionModel(config), RecognitionDataModule(_binary_data(resources)))
    assert list((tmp_path / 'runs').glob('events.out.tfevents.*'))


def test_profile_dir_traces_the_first_epoch(resources, tmp_path):
    config = _rec_config(tmp_path, profile_dir=str(tmp_path / 'trace'))
    KrakenTrainer(config, fast_dev_run=True).fit(
        RecognitionModel(config), RecognitionDataModule(_binary_data(resources)))
    assert list((tmp_path / 'trace').glob('*.json'))


def test_freeze_backbone(resources, tmp_path):
    """With freeze_backbone only the output layer changes in early steps,
    AdamW's decoupled weight decay included."""
    config = _rec_config(tmp_path, lrate=1e-2, freeze_backbone=100, weight_decay=0.1)
    dm = RecognitionDataModule(_binary_data(resources))
    module = RecognitionModel(config)
    dm.setup('fit')
    module.setup('fit', dm)
    before = {k: v.clone() for k, v in module.net.net.state_dict().items()}
    KrakenTrainer(config, fast_dev_run=True).fit(module, dm)
    head = module.net.net.names[-1]
    after = module.net.net.state_dict()
    for k, v in before.items():
        changed = not torch.equal(v, after[k])
        assert changed == k.startswith(head + '.'), k


def test_abort_checkpoint_on_exception(resources, tmp_path):
    config = _rec_config(tmp_path)
    module = RecognitionModel(config)

    def boom(datamodule):
        raise RuntimeError('validation crashed')
    module.validate = boom
    with pytest.raises(RuntimeError):
        KrakenTrainer(config, fast_dev_run=True).fit(module, RecognitionDataModule(
            _binary_data(resources)))
    abort = tmp_path / 'model_checkpoint_abort.safetensors'
    model, meta = load_checkpoint(abort)
    assert model.codec is not None


def test_checkpoint_top_k_pruning(resources, tmp_path):
    config = _rec_config(tmp_path, epochs=5, save_top_k=2)
    KrakenTrainer(config).fit(RecognitionModel(config),
                              RecognitionDataModule(_binary_data(resources, 2)))
    epoch_ckpts = [p for p in tmp_path.glob('model_*.safetensors')
                   if p.stem.rsplit('_', 1)[-1].isdigit()]
    assert len(epoch_ckpts) == 2, sorted(p.name for p in tmp_path.iterdir())
    assert (tmp_path / 'model_best.safetensors').exists()


def test_reduce_on_plateau_keeps_optimizer_state(resources, tmp_path):
    config = _rec_config(tmp_path, epochs=4, schedule='reduceonplateau', rop_patience=1,
                         min_delta=100.0)
    trainer = KrakenTrainer(config)
    trainer.fit(RecognitionModel(config), RecognitionDataModule(_path_data(resources, 2)))
    assert trainer.current_epoch == 3
    assert trainer.global_step == 8
    # one optimizer, its count never reset, its lr a thousandth by now
    assert trainer.optimizer.count == 8
    assert abs(trainer.optimizer.lr(0.1 ** 3) - 1e-6) < 1e-12


def test_fractional_freq_sub_epoch_validation(resources, tmp_path):
    config = _rec_config(tmp_path, freq=0.5)
    trainer = KrakenTrainer(config)
    trainer.fit(RecognitionModel(config), RecognitionDataModule(_path_data(resources, 1)))
    assert len(trainer.metrics_history) == 2
    names = sorted(p.name for p in tmp_path.glob('model_0*.safetensors'))
    assert any('_s2' in n for n in names), names


def test_tpu_spec_preset_trains(resources, tmp_path):
    from kraken_tpu.configs.base import RECOGNITION_SPEC_PRESETS
    config = _rec_config(tmp_path, spec='tpu')
    assert config.spec == RECOGNITION_SPEC_PRESETS['tpu']
    module = RecognitionModel(config)
    KrakenTrainer(config, fast_dev_run=True).fit(
        module, RecognitionDataModule(_path_data(resources, 1, train=('000236.png',))))
    assert module.net.output[1] > 0


def test_oversized_batch_clamps_not_zero_steps(resources, tmp_path, caplog):
    config = RecognitionTrainingConfig(spec='[1,48,0,1 Cr3,3,4,2,2 S1(1x0)1,3 O1c4]', epochs=2,
                                       quit='fixed', freq=1, device='cpu',
                                       checkpoint_path=str(tmp_path / 'm'))
    data = _binary_data(resources, 512,
                        evaluation_data=[str(resources / 'merge_tests' / 'base.arrow')])
    module = RecognitionModel(config)
    with caplog.at_level(logging.WARNING):
        KrakenTrainer(config).fit(module, RecognitionDataModule(data))
    assert any('clamping' in r.message for r in caplog.records)
    assert module.net.user_metadata['metrics']
    assert all('loss' in m for _, m in module.net.user_metadata['metrics'])


def test_transformer_recognition_training_smoke(resources, tmp_path):
    spec = '[1,32,0,1 Cr3,3,8,2,2 S1(1x0)1,3 Cl1,1,16 Te2,16,32 Do0.1,2]'
    config = RecognitionTrainingConfig(spec=spec, epochs=1, lrate=1e-3, warmup=1, device='cpu',
                                       checkpoint_path=str(tmp_path / 'te'))
    module = RecognitionModel(config)
    KrakenTrainer(config, fast_dev_run=True).fit(module, RecognitionDataModule(
        _path_data(resources, 2, train=('merge_tests/0006.jpg', 'merge_tests/0007.jpg'))))
    ckpts = list(tmp_path.glob('te_*.safetensors'))
    model, _ = load_checkpoint(ckpts[0])
    y, _ = model(torch.zeros((1, 1, 32, 64)), torch.tensor([64], dtype=torch.int32))
    assert y.shape[1] == model.output[1]


def test_device_defaults_to_the_card(monkeypatch, resources, tmp_path):
    """Training asks for the card unless the config names the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    config = RecognitionTrainingConfig(spec=TINY_REC_SPEC, epochs=1,
                                       checkpoint_path=str(tmp_path / 'm'))
    assert config.device == 'cuda'
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KrakenTrainer(config, fast_dev_run=True).fit(RecognitionModel(config),
                                                     RecognitionDataModule(
                                                         _binary_data(resources)))
