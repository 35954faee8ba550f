"""
The port's VGSL networks (kraken_tpu_torch.vgsl / nn.layers) against the JAX
package: the same weights (moved with ``from_jax_state_dict``) and the same
numpy-seeded ragged batches give the same logits (fp32, atol 1e-5) and the
same output lengths, layer by layer and for whole networks, with the JAX
LSTM on its scan path and on its Pallas kernel (interpret mode).
"""
import tests.test_torch_threads  # noqa: F401  (first: the thread share under xdist)
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from kraken_tpu.nn import layers as jax_layers
from kraken_tpu.vgsl import VGSLModel as JaxVGSLModel
from kraken_tpu_torch.exceptions import KrakenInvalidModelException
from kraken_tpu_torch.nn.layers import GroupNorm, TransposedSummarizingRNN
from kraken_tpu_torch.vgsl import VGSLModel

# the flagship CNN+BiLSTM stack at reduced height, widths and depth
REDUCED_FLAGSHIP = '[1,48,0,1 Cr3,13,8 Mp2,2 Cr3,9,16 Mp2,2 S1(1x0)1,3 Lbx16 Lbx16 O1c20]'
LENS = np.array([64, 40, 17, 9], np.int32)


def _pair(spec, seed=0):
    jm = JaxVGSLModel(vgsl=spec, rng=jax.random.PRNGKey(seed))
    tm = VGSLModel(spec)
    tm.from_jax_state_dict(jm.state_dict())
    return jm, tm


def _batch(shape, lens, seed=0):
    x = np.random.RandomState(seed).rand(*shape).astype(np.float32)
    x *= np.arange(shape[3])[None, None, None, :] < lens[:, None, None, None]
    return x


def _jax_forward(jm, x, lens):
    y, olens = jax.jit(jm.net.apply)(jm.params, jnp.asarray(x), jnp.asarray(lens))
    return np.asarray(y), np.asarray(olens)


def _torch_forward(tm, x, lens):
    with torch.no_grad():
        y, olens = tm(torch.from_numpy(x), torch.from_numpy(lens))
    return y.numpy(), olens.numpy()


@pytest.mark.parametrize('backend', ['scan', 'pallas'])
def test_reduced_flagship_parity(backend):
    jm, tm = _pair(REDUCED_FLAGSHIP)
    x = _batch((4, 1, 48, 64), LENS)
    try:
        jax_layers.set_lstm_backend(backend)
        yj, lj = _jax_forward(jm, x, LENS)
    finally:
        jax_layers.set_lstm_backend('scan')
    yt, lt = _torch_forward(tm, x, LENS)
    np.testing.assert_array_equal(lt, lj)
    np.testing.assert_allclose(yt, yj, atol=1e-5)


def test_reduced_flagship_layer_by_layer():
    jm, tm = _pair(REDUCED_FLAGSHIP, seed=1)
    x = _batch((4, 1, 48, 64), LENS, seed=1)
    xj, lj = jnp.asarray(x), jnp.asarray(LENS)
    xt, lt = torch.from_numpy(x), torch.from_numpy(LENS)
    assert jm.net.names == tm.net.names
    for name, jl, tl in zip(jm.net.names, jm.net.layers, tm.net.layers):
        xj, lj = jl.apply(jm.params.get(name, {}), xj, lj)
        with torch.no_grad():
            xt, lt = tl(xt, lt)
        np.testing.assert_array_equal(lt.numpy(), np.asarray(lj), err_msg=name)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-5, err_msg=name)
        # each layer starts again from the JAX output, so errors do not add up
        xt = torch.from_numpy(np.array(xj))


@pytest.mark.parametrize('spec', [
    # padding-aware group norm, unidirectional LSTM
    '[1,16,0,1 Cr3,3,4 Gn2 Mp2,2 S1(1x0)1,3 Lfx6 O1c5]',
    # strided/dilated convolutions, clstm legacy LSTM, non-square pool
    '[1,16,0,1 Cl3,3,4,1,1,2,2 Mp2,2,2,1 Ct3,3,6,2,2 S1(1x0)1,3 Lrxc5 O1c5]',
    # y-axis summarizing LSTM, then an x-axis summarizing one (last valid step)
    '[1,8,0,1 Cr3,3,4 Lbys4 S1(1x0)1,3 Lbxs3 O1c5]',
    # parallel branches, chunked addition, augmented output, identity
    '[1,8,0,1 Cr3,3,4 (Cr3,3,2 [Cs3,3,2 I]) A3,2 Mp2,2 S1(1x0)1,3 O1ca5]',
])
def test_spec_parity(spec):
    jm, tm = _pair(spec, seed=2)
    lens = np.array([32, 20, 11], np.int32)
    x = _batch((3, 1, int(spec.split(',')[1]), 32), lens, seed=2)
    yj, lj = _jax_forward(jm, x, lens)
    yt, lt = _torch_forward(tm, x, lens)
    np.testing.assert_array_equal(lt, lj)
    np.testing.assert_allclose(yt, yj, atol=1e-5)
    assert tm.named_spec == jm.named_spec and tm.output == jm.output


def test_state_dict_keys_match_jax():
    jm, tm = _pair(REDUCED_FLAGSHIP)
    assert set(tm.state_dict()) == set(jm.state_dict())
    for k, v in jm.state_dict().items():
        assert tuple(tm.state_dict()[k].shape) == v.shape, k


@pytest.mark.parametrize('fault', ['unknown', 'missing', 'shape'])
def test_from_jax_state_dict_fails_loudly(fault):
    jm = JaxVGSLModel(vgsl=REDUCED_FLAGSHIP, rng=jax.random.PRNGKey(0))
    tm = VGSLModel(REDUCED_FLAGSHIP)
    sd = dict(jm.state_dict())
    if fault == 'unknown':
        sd['nn.L_5.layer.weight_ip_l0'] = np.zeros(16, np.float32)
    elif fault == 'missing':
        del sd['nn.L_5.layer.bias_hh_l0_reverse']
    else:
        sd['nn.C_0.co.weight'] = np.transpose(sd['nn.C_0.co.weight'], (2, 3, 1, 0))
    with pytest.raises(KrakenInvalidModelException):
        tm.from_jax_state_dict(sd)


def test_groupnorm_zeroes_padding():
    """Statistics over the valid width only, pad columns zero after the
    affine: a padded row normalizes exactly like the unpadded row."""
    gn = GroupNorm(4, 2)
    with torch.no_grad():
        gn.layer.weight.copy_(torch.tensor([1.5, 0.5, 2.0, 1.0]))
        gn.layer.bias.copy_(torch.tensor([0.3, -0.2, 0.1, 0.7]))
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 4, 3, 10).astype(np.float32))
    lens = torch.tensor([10, 6], dtype=torch.int32)
    y, _ = gn(x, lens)
    assert torch.all(y[1, :, :, 6:] == 0)
    y_short, _ = gn(x[1:, :, :, :6], None)
    torch.testing.assert_close(y[1:, :, :, :6], y_short, atol=1e-6, rtol=0)


def test_summarize_takes_last_valid_step():
    rnn = TransposedSummarizingRNN(3, 5, 'b', transpose=False, summarize=True,
                                   generator=torch.Generator().manual_seed(0))
    full = TransposedSummarizingRNN(3, 5, 'b', transpose=False, summarize=False)
    full.load_state_dict(rnn.state_dict())
    x = torch.from_numpy(np.random.RandomState(4).randn(3, 3, 1, 9).astype(np.float32))
    lens = torch.tensor([9, 4, 1], dtype=torch.int32)
    y, _ = rnn(x, lens)
    y_full, _ = full(x, lens)
    assert y.shape == (3, 10, 1, 1)
    for i, n in enumerate(lens.tolist()):
        torch.testing.assert_close(y[i, :, 0, 0], y_full[i, :, 0, n - 1], atol=0, rtol=0)


def test_unported_layers_raise():
    """The wav2vec2 masking layer (pretraining), the last VGSL layer the
    port lacked, builds now; a ``W`` block without the name its grammar
    requires is no block, as in the JAX package."""
    from kraken_tpu.vgsl import VGSLModel as JaxVGSL
    model = VGSLModel('[1,1,0,16 S1(1x0)1,3 Cr1,1,16 W{w}16,4,0.5,10 O1c5]')
    assert model.spec == '[1,1,0,16 S1(1x0)1,3 Cr1,1,16 W{w}16,4,0.5,10 O1c5]'
    for build in (VGSLModel, JaxVGSL):
        with pytest.raises(ValueError):
            build('[1,1,0,16 S1(1x0)1,3 Cr1,1,16 W16,4,0.5,10 O1c5]')


@pytest.mark.parametrize('block', ['Lfxo16', 'Lrxo16'])
def test_unidirectional_ocropy_layers_raise(block):
    with pytest.raises(ValueError, match='ocropy layers are bidirectional'):
        VGSLModel(f'[1,1,0,16 S1(1x0)1,3 Cr1,1,16 {block} O1c5]')


@pytest.mark.parametrize('block', ['Lbxo16', 'Te2,16,32'])
def test_formerly_unported_layers_run(block):
    model = VGSLModel(f'[1,1,0,16 S1(1x0)1,3 Cr1,1,16 {block} O1c5]',
                      generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        y, lens = model(torch.rand(2, 16, 1, 12), torch.tensor([12, 7], dtype=torch.int32))
    assert y.shape == (2, 5, 1, 12) and bool(torch.isfinite(y).all())
