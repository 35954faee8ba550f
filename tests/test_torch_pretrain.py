"""
The port's pretraining (kraken_tpu_torch.pretrain, ``ketos pretrain``)
against the JAX package's on the CPU:

- ``span_mask`` on the JAX package's uniform draws gives its
  ``compute_mask_indices``; ``Wav2Vec2Mask`` on the same mask and weights
  gives the JAX layer's output dict (1e-6), passes its input through in
  evaluation mode and refuses a height other than 1;
- a ``W`` spec builds with the JAX spec, its ``get_spec`` is the JAX
  string, and its safetensors files load in both packages bit for bit and
  its CoreML bytes equal the JAX writer's;
- the JAX package's tests/test_training.py and tests/test_cli.py
  pretraining cases on the port, ``--resume`` and ``ketos pretrain``'s
  options against the JAX command's.

The loss's parity with the JAX package is held in
tests/test_torch_pretrain_parity.py, the warm starts across the packages in
tests/test_torch_pretrain_checkpoints.py.
"""
import tests.test_torch_threads  # noqa: F401  (first: the thread share under xdist)
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner

RESOURCES = Path(__file__).resolve().parent / 'resources'
ARROW = str(RESOURCES / 'merge_tests' / 'base.arrow')
TINY = '[1,32,0,1 Cr3,3,4,2,2 S1(1x0)1,3 Lbx8 Do0.1,2]'


@pytest.fixture(scope='module', autouse=True)
def quiet():
    warnings.filterwarnings('ignore')


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= rel * scale


def _binary_data(batch_size=1, **kw):
    from kraken_tpu_torch.configs import RecognitionTrainingDataConfig
    return RecognitionTrainingDataConfig(format_type='binary', training_data=[ARROW],
                                         batch_size=batch_size, **kw)


def _config(tmp_path, spec=TINY, **kw):
    from kraken_tpu_torch.configs import PretrainingConfig
    kw = {'epochs': 1, 'lrate': 1e-4, 'mask_width': 2, 'mask_prob': 0.5, 'num_negatives': 4,
          **kw}
    return PretrainingConfig(spec=spec, checkpoint_path=str(tmp_path / 'pre'), device='cpu', **kw)


# ------------------------------------------------------------ masking layer

@pytest.mark.parametrize('shape, prob, width', [((3, 40), 0.5, 4), ((2, 17), 0.3, 1),
                                                ((4, 9), 0.9, 3)])
def test_span_mask_matches_jax(shape, prob, width):
    from kraken_tpu.pretrain.layers import compute_mask_indices as jax_mask
    from kraken_tpu_torch.pretrain.layers import compute_mask_indices, span_mask
    key = jax.random.PRNGKey(shape[1])
    uniform = torch.from_numpy(np.asarray(jax.random.uniform(key, shape)))
    want = np.asarray(jax_mask(key, shape, prob, width))
    assert np.array_equal(span_mask(uniform < prob / width, width).numpy(), want)
    drawn = compute_mask_indices(shape, prob, width, torch.Generator().manual_seed(1))
    again = compute_mask_indices(shape, prob, width, torch.Generator().manual_seed(1))
    assert drawn.dtype == torch.bool and drawn.shape == shape and torch.equal(drawn, again)


def _jax_layer_and_port():
    from kraken_tpu.pretrain.layers import Wav2Vec2Mask as JaxMask
    from kraken_tpu_torch.pretrain.layers import Wav2Vec2Mask
    jl = JaxMask(12, 7, 3, 0.4, 5)
    params = jl.init(jax.random.PRNGKey(3))
    layer = Wav2Vec2Mask(12, 7, 3, 0.4, 5, generator=torch.Generator().manual_seed(0))
    assert sorted(dict(layer.named_parameters())) == sorted(params)
    layer.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in params.items()})
    return jl, params, layer


def test_wav2vec2_mask_matches_jax():
    jl, params, layer = _jax_layer_and_port()
    x = np.random.RandomState(0).randn(2, 12, 1, 21).astype(np.float32)
    seq = np.array([21, 13], np.int32)
    key = jax.random.PRNGKey(9)
    want, want_len = jl.apply(params, jnp.asarray(x), jnp.asarray(seq), train=True, rng=key)
    layer.train()
    got, got_len = layer(torch.from_numpy(x), torch.from_numpy(seq),
                         mask=torch.from_numpy(np.asarray(want['mask'])))
    assert sorted(got) == sorted(want)
    for k in ('output', 'unmasked_features'):
        _close(got[k].detach(), want[k], 1e-6)
    assert np.array_equal(got['mask'].numpy(), np.asarray(want['mask']))
    assert np.array_equal(got['seq_len'].numpy(), np.asarray(want['seq_len']))
    assert got['num_negatives'] == want['num_negatives'] == 5
    assert np.array_equal(got_len.numpy(), np.asarray(want_len))
    drawn, _ = layer(torch.from_numpy(x))
    assert drawn['mask'].shape == (2, 21) and drawn['output'].shape == (2, 12, 1, 21)
    layer.eval()
    same, _ = layer(torch.from_numpy(x), torch.from_numpy(seq))
    assert torch.equal(same, torch.from_numpy(x))
    layer.train()
    with pytest.raises(ValueError, match='Height has to be 1'):
        layer(torch.zeros(1, 12, 2, 5))


def test_get_spec_matches_jax():
    jl, _, layer = _jax_layer_and_port()
    assert layer.get_spec('w2v') == jl.get_spec('w2v') == '[1,7,0,12 W{w2v}7,3,0.4,5]'


W_SPEC = '[1,16,0,1 Cr3,3,8 Mp2,2 S1(1x0)1,3 W{w2v}32,2,0.5,10 Lbx8 O1c5]'


def _w_models():
    from kraken_tpu.codec import Codec as JaxCodec
    from kraken_tpu.vgsl import VGSLModel as JaxVGSL
    from kraken_tpu_torch.codec import Codec
    from kraken_tpu_torch.vgsl import VGSLModel
    jax_net = JaxVGSL(W_SPEC, rng=jax.random.PRNGKey(0))
    jax_net.add_codec(JaxCodec('abcd'))
    jax_net.model_type = ['recognition']
    net = VGSLModel(W_SPEC, generator=torch.Generator().manual_seed(0))
    net.from_jax_state_dict(jax_net.state_dict())
    net.add_codec(Codec('abcd'))
    net.model_type = ['recognition']
    return jax_net, net


def test_w_spec_builds_as_in_jax():
    from kraken_tpu_torch.models.utils import create_model
    from kraken_tpu_torch.pretrain.layers import Wav2Vec2Mask
    jax_net, net = _w_models()
    assert net.spec == jax_net.spec
    assert net.output == jax_net.output
    assert sorted(net.state_dict()) == sorted(jax_net.state_dict())
    assert isinstance(create_model('Wav2Vec2Mask', context_encoder_input_dim=8, final_dim=4,
                                   mask_width=2, mask_prob=0.5, num_negatives=3), Wav2Vec2Mask)
    x = torch.rand(2, 1, 16, 30)
    with torch.no_grad():
        y, lens = net(x, torch.tensor([30, 17], dtype=torch.int32))
    want, want_lens = jax.jit(lambda p, x, n: jax_net.net.apply(p, x, n))(
        jax_net.params, jnp.asarray(x.numpy()), jnp.asarray([30, 17], jnp.int32))
    _close(y, want, 1e-5)
    assert lens.tolist() == np.asarray(want_lens).tolist()


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_w_model_safetensors_round_trip(writer, tmp_path):
    from kraken_tpu.models import load_models as jax_load
    from kraken_tpu.models import write_models as jax_write
    from kraken_tpu_torch.models import load_models, write_models
    jax_net, net = _w_models()
    path = tmp_path / 'w.safetensors'
    (write_models([net], path) if writer == 'port' else jax_write([jax_net], path))
    for model in (jax_load(path)[0], load_models(path)[0]):
        assert model.spec == net.user_metadata['vgsl'] and model.codec.c2l == net.codec.c2l
        for k, v in jax_net.state_dict().items():
            assert np.array_equal(np.asarray(model.state_dict()[k]), np.asarray(v)), k


def test_w_model_coreml_bytes_equal_jax(tmp_path):
    from kraken_tpu.models import write_models as jax_write
    from kraken_tpu_torch.models import write_models
    jax_net, net = _w_models()
    write_models([net], tmp_path / 'port.mlmodel', format='coreml')
    jax_write([jax_net], tmp_path / 'jax.mlmodel', format='coreml')
    data = (tmp_path / 'port.mlmodel').read_bytes()
    assert b'_wave2vec2_emb' in data and b'_wave2vec2_lin' in data
    assert data == (tmp_path / 'jax.mlmodel').read_bytes()


# --------------------------------------------- the JAX package's test cases

def test_pretrain_smoke(tmp_path):
    from kraken_tpu_torch.pretrain import RecognitionPretrainModel
    from kraken_tpu_torch.train import KrakenTrainer, RecognitionDataModule
    config = _config(tmp_path)
    dm = RecognitionDataModule(_binary_data(2))
    module = RecognitionPretrainModel(config)
    KrakenTrainer(config, fast_dev_run=True).fit(module, dm)
    metrics = module.validate(dm)
    assert np.isfinite(metrics['val_ce']) and metrics['val_metric'] == -metrics['val_ce']
    assert module.checkpoint_extras() == {'pretrain': True}


def test_pretrain_padded_batch_gradients_finite(tmp_path):
    """Gradients stay finite on a padded batch over 3 seeds of draws and
    dropout (the regression of NaN norms at zero encoder outputs)."""
    from kraken_tpu_torch.pretrain import RecognitionPretrainModel
    from kraken_tpu_torch.train import RecognitionDataModule
    config = _config(tmp_path, spec='[1,48,0,1 Cr3,13,16 Do0.1,2 Mp2,2 Cr3,9,16 Do0.1,2 Mp2,2 '
                                    'S1(1x0)1,3 Lbx64 Do0.1,2]', lrate=3e-4, num_negatives=8)
    dm = RecognitionDataModule(_binary_data(2, evaluation_data=[ARROW]))
    dm.setup('fit')
    module = RecognitionPretrainModel(config)
    module.setup('fit', dm)
    batch = next(iter(dm.train_dataloader()))
    assert len(set(np.asarray(batch['seq_lens']).tolist())) > 1, 'batch must be padded'
    for seed in range(3):
        for p in module.parameters():
            p.grad = None
        module.generator = torch.Generator().manual_seed(seed)
        for m in module.net.net.modules():
            if hasattr(m, 'generator'):
                m.generator = module.generator
        loss = module.loss_fn(batch)
        loss.backward()
        assert np.isfinite(loss.item())
        assert all(p.grad is None or bool(torch.isfinite(p.grad).all())
                   for p in module.parameters())


def test_pretrain_to_recognition_flow(tmp_path):
    """A pretraining checkpoint warm-starts recognition training: the
    pretraining parameters are not loaded, the backbone's weights are."""
    from kraken_tpu_torch.configs import RecognitionTrainingConfig
    from kraken_tpu_torch.models import load_models
    from kraken_tpu_torch.pretrain import RecognitionPretrainModel
    from kraken_tpu_torch.train import KrakenTrainer, RecognitionDataModule, RecognitionModel
    pre_config = _config(tmp_path)
    pre = RecognitionPretrainModel(pre_config)
    KrakenTrainer(pre_config, fast_dev_run=True).fit(pre, RecognitionDataModule(_binary_data()))
    ckpts = sorted(tmp_path.glob('pre_*.safetensors'))
    assert ckpts
    rec_config = RecognitionTrainingConfig(spec=TINY, epochs=1, lrate=1e-3, resize='new',
                                           device='cpu', checkpoint_path=str(tmp_path / 'rec'))
    module = RecognitionModel.load_from_weights(rec_config, ckpts[0])
    assert not any('__pretrain__' in k for k in module.net.state_dict())
    backbone = load_models(ckpts[0])[0].state_dict()['nn.C_0.co.weight']
    assert torch.equal(module.net.state_dict()['nn.C_0.co.weight'], backbone)
    KrakenTrainer(rec_config, fast_dev_run=True).fit(module, RecognitionDataModule(_binary_data()))
    assert module.net.codec is not None and len(module.net.codec.c2l) > 1


def test_pretrain_resume_restores_the_pretraining_parameters(tmp_path):
    from kraken_tpu_torch.pretrain import RecognitionPretrainModel
    from kraken_tpu_torch.train import KrakenTrainer, RecognitionDataModule
    config = _config(tmp_path)
    first = RecognitionPretrainModel(config)
    KrakenTrainer(config, fast_dev_run=True).fit(first, RecognitionDataModule(_binary_data()))
    saved = {k: v.detach().clone() for k, v in first.pretrain.named_parameters()}
    config2 = _config(tmp_path / 'again', epochs=1, lrate=0.0)
    second = RecognitionPretrainModel(config2)
    trainer = KrakenTrainer(config2, fast_dev_run=True)
    trainer.fit(second, RecognitionDataModule(_binary_data()),
                resume=str(tmp_path / 'pre_0.safetensors'))
    for k, p in second.pretrain.named_parameters():
        torch.testing.assert_close(p.detach(), saved[k], rtol=0, atol=1e-6)


def _ketos(args):
    from kraken_tpu_torch.ketos import cli
    return CliRunner().invoke(cli, [str(a) for a in args])


def test_ketos_pretrain_cli(tmp_path):
    result = _ketos(['-d', 'cpu', 'pretrain', '-N', '1', '-f', 'binary', '-o', tmp_path / 'pre',
                     '-s', TINY, '--mask-width', '2', '--num-negatives', '4', ARROW])
    assert result.exit_code == 0, (result.output, result.exception)
    assert list(tmp_path.glob('pre_*.safetensors')), result.output
    assert 'Pretraining complete' in result.output


def test_ketos_pretrain_needs_a_card_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    result = _ketos(['pretrain', '-N', '1', '-f', 'binary', '-o', tmp_path / 'pre', '-s', TINY,
                     ARROW])
    assert result.exit_code == 2 and 'none is available' in result.output
    assert not list(tmp_path.glob('pre_*'))


def test_ketos_pretrain_options_equal_jax():
    from kraken_tpu.ketos.pretrain import pretrain as jax_pretrain
    from kraken_tpu_torch.ketos.pretrain import pretrain

    def options(cmd):
        return {p.name: (sorted(p.opts), p.default, getattr(p.type, 'choices', None))
                for p in cmd.params}
    assert options(pretrain) == options(jax_pretrain)
