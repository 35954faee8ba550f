"""
Pretraining checkpoints across the packages (the JAX package's
tests/test_cli.py:160-192 in both directions): a checkpoint of the JAX
package's pretraining warm-starts the port's ``ketos train -i --resize
new``, and one of the port's ``ketos pretrain`` the JAX package's
``RecognitionModel.load_from_weights`` and training; neither loads the
pretraining parameters as a part of the network.
"""
import tests.test_torch_threads  # noqa: F401  (first: the thread share under xdist)
import warnings

import numpy as np
import pytest

from tests.test_torch_pretrain import ARROW, TINY, _ketos


@pytest.fixture(scope='module', autouse=True)
def quiet():
    warnings.filterwarnings('ignore')


def test_jax_pretraining_checkpoint_warm_starts_port_training(tmp_path):
    from kraken_tpu.configs import PretrainingConfig as JaxConfig
    from kraken_tpu.configs import RecognitionTrainingDataConfig as JaxData
    from kraken_tpu.pretrain.model import RecognitionPretrainModel as JaxModel
    from kraken_tpu.train import KrakenTrainer as JaxTrainer
    from kraken_tpu.train import RecognitionDataModule as JaxDM
    config = JaxConfig(spec=TINY, epochs=1, lrate=1e-4, mask_width=2, mask_prob=0.5,
                       num_negatives=4, checkpoint_path=str(tmp_path / 'jax'))
    JaxTrainer(config, fast_dev_run=True).fit(
        JaxModel(config), JaxDM(JaxData(format_type='binary', training_data=[ARROW],
                                        batch_size=1)))
    ckpt = tmp_path / 'jax_0.safetensors'
    result = _ketos(['-d', 'cpu', 'train', '-N', '1', '-f', 'binary', '-i', ckpt,
                     '--resize', 'new', '-o', tmp_path / 'rec', ARROW])
    assert result.exit_code == 0, (result.output, result.exception)
    from kraken_tpu_torch.models import load_models
    rec = load_models(tmp_path / 'rec_0.safetensors')[0]
    assert len(rec.codec.c2l) > 1 and rec.spec.startswith('[1,32,0,1 Cr{C_0}3,3,4,2,2')


def test_port_pretraining_checkpoint_warm_starts_jax_training(tmp_path):
    from kraken_tpu.configs import RecognitionTrainingConfig as JaxRecConfig
    from kraken_tpu.configs import RecognitionTrainingDataConfig as JaxData
    from kraken_tpu.train import KrakenTrainer as JaxTrainer
    from kraken_tpu.train import RecognitionDataModule as JaxDM
    from kraken_tpu.train import RecognitionModel as JaxRec
    result = _ketos(['-d', 'cpu', 'pretrain', '-N', '1', '-f', 'binary', '-o', tmp_path / 'pre',
                     '-s', TINY, '--mask-width', '2', '--num-negatives', '4', ARROW])
    assert result.exit_code == 0, (result.output, result.exception)
    config = JaxRecConfig(spec=TINY, epochs=1, lrate=1e-3, resize='new',
                          checkpoint_path=str(tmp_path / 'rec'))
    module = JaxRec.load_from_weights(config, tmp_path / 'pre_0.safetensors')
    assert '__pretrain__' not in module.net.params
    from kraken_tpu_torch.models import load_models
    want = load_models(tmp_path / 'pre_0.safetensors')[0].state_dict()['nn.C_0.co.weight']
    assert np.array_equal(np.asarray(module.net.params['C_0']['co.weight']), want.numpy())
    JaxTrainer(config, fast_dev_run=True).fit(
        module, JaxDM(JaxData(format_type='binary', training_data=[ARROW], batch_size=1)))
    assert module.net.codec is not None
