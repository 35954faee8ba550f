"""
The port's pretraining loss against the JAX package's on the CPU: the loss
and every gradient (the network's, ``mask_emb`` and ``project_q``) equal
``jax.value_and_grad`` of the JAX ``loss_fn`` with the JAX draws fed in
(the same keys), on ragged batches of three feature lengths, with ``Gn``,
with ``Lbxo`` (the peephole backward) and at K = 1: the loss within 1e-5
relative, the gradients within 2e-5 of their largest (1e-4 with ``Gn``,
whose variance the JAX package takes in one pass).
"""
import tests.test_torch_threads  # noqa: F401  (first: the thread share under xdist)
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_pretrain import _close


@pytest.fixture(scope='module', autouse=True)
def quiet():
    warnings.filterwarnings('ignore')


# ------------------------------------------------------------------ the loss

def _modules(spec, mask_width, num_negatives, mask_prob=0.5):
    """The JAX module set up (its pretraining parameters drawn from key 0)
    and the port's with the same network and pretraining parameters."""
    from kraken_tpu.configs import PretrainingConfig as JaxConfig
    from kraken_tpu.pretrain.model import RecognitionPretrainModel as JaxModel
    from kraken_tpu.vgsl import VGSLModel as JaxVGSL
    from kraken_tpu_torch.codec import Codec
    from kraken_tpu_torch.configs import PretrainingConfig
    from kraken_tpu_torch.pretrain import RecognitionPretrainModel
    from kraken_tpu_torch.vgsl import VGSLModel
    kw = dict(mask_width=mask_width, mask_prob=mask_prob, num_negatives=num_negatives,
              logit_temp=0.1)
    jm = JaxModel(JaxConfig(spec=spec, **kw),
                  net=JaxVGSL(spec, rng=jax.random.PRNGKey(0), model_type=['recognition']))
    jm.setup('fit', None)
    net = VGSLModel(jm.net.spec, generator=torch.Generator().manual_seed(0))
    net.from_jax_state_dict({k: v for k, v in jm.net.state_dict().items()
                             if '__pretrain__' not in k})
    net.add_codec(Codec(' '))
    module = RecognitionPretrainModel(PretrainingConfig(spec=spec, device='cpu', **kw), net=net)
    module.setup('fit', None)
    with torch.no_grad():
        for k, p in module.pretrain.named_parameters():
            p.copy_(torch.from_numpy(np.asarray(jm.net.params['__pretrain__'][k])))
    return jm, module


def _jax_draws(rng, N, W, mask_width, num_negatives, mask_prob=0.5):
    """The JAX loss_fn's draws for `rng` (pretrain/model.py:134-151)."""
    K = max(1, int(mask_prob * W / mask_width))
    k_mask, k_neg = jax.random.split(jax.random.fold_in(rng, 1))
    starts = jax.random.randint(k_mask, (N, K), 0, max(1, W - mask_width))
    neg_idx = jax.random.randint(k_neg, (num_negatives, N, K), 0, max(1, K - 1))
    return tuple(torch.from_numpy(np.asarray(a)).long() for a in (starts, neg_idx))


@pytest.mark.parametrize('spec, width, negatives, lens, key', [
    ('[1,24,0,1 Cr3,3,8 Mp2,2 S1(1x0)1,3 Lbx6 Lbx5]', 2, 6, [40, 29, 11], 0),
    ('[1,24,0,1 Cr3,3,8 Gn2 Mp2,2 S1(1x0)1,3 Lbx6]', 3, 5, [40, 23, 9], 1),
    ('[1,24,0,1 Cr3,3,8 Mp2,2 S1(1x0)1,3 Lbxo6]', 2, 4, [36, 29, 17], 2),
    ('[1,24,0,1 Cr3,3,8,2,2 Mp2,2 S1(1x0)1,3 Lbx6]', 4, 3, [24, 13, 5], 3),
], ids=['lstm', 'groupnorm', 'peephole', 'k1'])
def test_loss_and_gradients_match_jax(spec, width, negatives, lens, key):
    jm, module = _modules(spec, width, negatives)
    rng = np.random.RandomState(key)
    batch = {'image': rng.rand(len(lens), 1, 24, max(lens)).astype(np.float32),
             'seq_lens': np.array(lens, np.int32)}
    jrng = jax.random.PRNGKey(100 + key)
    want, grads = jax.jit(jax.value_and_grad(jm.loss_fn))(
        jm.net.params, {k: jnp.asarray(v) for k, v in batch.items()}, jrng)
    with torch.no_grad():
        feats, flens = module._features(torch.from_numpy(batch['image']),
                                        torch.from_numpy(batch['seq_lens']))
    assert len(set(flens.tolist())) == 3, 'three ragged feature lengths'
    N, _, _, W = feats.shape
    indices = _jax_draws(jrng, N, W, width, negatives)
    if key == 3:
        assert indices[0].shape[1] == 1, 'K = 1: the negative is the position itself'
    loss = module.loss_fn(batch, indices=indices)
    loss.backward()
    assert abs(loss.item() - float(want)) <= 1e-5 * abs(float(want))
    tol = 1e-4 if 'Gn' in spec else 2e-5
    got = {f'{name}': p.grad for name, p in module.net.net.named_parameters()}
    got.update({f'__pretrain__.{k}': p.grad for k, p in module.pretrain.named_parameters()})
    want_g = {f'{layer}.{k}': np.asarray(v) for layer, d in grads.items() for k, v in d.items()}
    assert set(got) == set(want_g)
    assert module.parameters()[-3:] == list(module.pretrain.parameters())
    for k, g in want_g.items():
        # the output layer takes no part in the loss (JAX: a zero gradient)
        _close(np.zeros_like(g) if got[k] is None else got[k], g, tol)
    assert np.abs(want_g['__pretrain__.mask_emb']).max() > 0
