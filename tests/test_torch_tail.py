"""
The recognition tail (kraken_tpu_torch.ops.tail) on the CPU, where the
wrapper runs its plain version, against the JAX package's ``_tail`` (the
function its ``prepare_recognition`` jits into the recognition forward,
taken from that forward's closure) on seeded numpy logits: labels equal,
also at exact ties (the first maximal class wins in both) and at a
temperature of 0.7; probs and confidences within 1e-6 of JAX's (which is
up to 5.1e-7 from a float64 witness on these logits) and within 2e-7 of
the witness taken from the same fp32 ``x / T`` (the plain version sums in
fp64). Also: the
posteriors are materialised only when a consumer needs them, and the
recognition forward holds both TF32 flags off while it runs (an fp32 run
keeps parity after a caller's ``torch.set_float32_matmul_precision('high')``)
and restores them after.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from kraken_tpu_torch.ops.tail import recognition_tail, recognition_tail_reference

RESOURCES = Path(__file__).resolve().parent / 'resources'


@pytest.fixture(scope='module')
def jax_tail():
    """The JAX package's `_tail`, from the closure of its jitted forward."""
    from kraken_tpu.configs import RecognitionInferenceConfig
    from kraken_tpu.models import load_models
    model = load_models(RESOURCES / 'overfit_bl.safetensors')[0]
    model.prepare_for_inference(RecognitionInferenceConfig())
    fwd = model._rec_fwd.__wrapped__
    cells = dict(zip(fwd.__code__.co_freevars, (c.cell_contents for c in fwd.__closure__)))
    return cells['_tail']


def logits(N: int, C: int, W: int, seed: int, ties: bool = False) -> np.ndarray:
    x = np.random.default_rng(seed).normal(0, 4, (N, C, 1, W)).astype(np.float32)
    if ties:
        # exact ties: a frame of equal logits, two equal maxima, a
        # maximum repeated at the last class
        x[0, :, 0, 0] = 1.5
        x[0, 3, 0, 1] = x[0, 7 % C, 0, 1] = x[0, :, 0, 1].max() + 1
        x[-1, C - 1, 0, -1] = x[-1, 0, 0, -1] = x[-1, :, 0, -1].max() + 2
    return x


@pytest.mark.parametrize('temperature', [1.0, 0.7])
@pytest.mark.parametrize('N, C, W, ties', [(1, 2, 1, False), (3, 250, 31, False),
                                           (2, 20, 33, True), (4, 250, 128, True),
                                           (2, 4000, 9, True)])
def test_plain_version_equals_jax(jax_tail, N, C, W, ties, temperature):
    x = logits(N, C, W, seed=N * 1000 + W, ties=ties)
    olens = np.full((N,), W, np.int32)
    jprobs, jlabels, jconfs, _ = (np.asarray(a) for a in jax_tail(jnp.asarray(x), olens,
                                                                   temperature))
    probs, labels, confs = recognition_tail(torch.from_numpy(x), temperature, probs=True)
    np.testing.assert_allclose(probs.numpy(), jprobs, atol=1e-6, rtol=0)
    np.testing.assert_allclose(confs.numpy(), jconfs, atol=1e-6, rtol=0)
    # the witness from the same fp32 x / T, in float64 after that
    v = (x[:, :, 0] / np.float32(temperature)).astype(np.float64)
    witness = np.exp(v - v.max(axis=1, keepdims=True))
    witness /= witness.sum(axis=1, keepdims=True)
    np.testing.assert_allclose(probs.numpy(), witness, atol=2e-7, rtol=0)
    assert labels.dtype == torch.int64 and confs.dtype == torch.float32
    np.testing.assert_array_equal(labels.numpy(), jlabels)
    if ties:
        assert labels[0, 0] == 0 and labels[0, 1] == min(3, 7 % C) and labels[-1, -1] == 0


def test_bf16_logits_are_computed_in_fp32(jax_tail):
    x = torch.from_numpy(logits(2, 30, 17, seed=5)).to(torch.bfloat16)
    jprobs, jlabels, jconfs, _ = jax_tail(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                                          np.full((2,), 17, np.int32), 1.0)
    probs, labels, confs = recognition_tail(x, 1.0)
    assert probs.dtype == torch.float32
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))


def test_probs_only_when_asked():
    x = torch.from_numpy(logits(2, 9, 5, seed=1))
    probs, labels, confs = recognition_tail(x, 0.7, probs=False)
    rprobs, rlabels, rconfs = recognition_tail_reference(x, 0.7)
    assert probs is None
    assert torch.equal(labels, rlabels) and torch.equal(confs, rconfs)


@pytest.mark.parametrize('shape', [(2, 9, 5), (2, 9, 2, 5)])
def test_wrong_shape_raises(shape):
    with pytest.raises(ValueError, match=r'\(N, C, 1, W\)'):
        recognition_tail(torch.zeros(shape), 1.0)


@pytest.fixture(scope='module')
def recognizer():
    from kraken_tpu_torch.configs import RecognitionInferenceConfig
    from kraken_tpu_torch.containers import BaselineLine, Segmentation
    from kraken_tpu_torch.models import load_models
    model = load_models(RESOURCES / 'overfit_bl.safetensors')[0]
    model.prepare_for_inference(RecognitionInferenceConfig(device='cpu', num_line_workers=0))
    seg = Segmentation(type='baselines', imagename='000236.png', text_direction='horizontal-lr',
                       script_detection=False,
                       lines=[BaselineLine(id='l0', baseline=[[0, 10], [2543, 10]],
                                           boundary=[[0, 0], [2543, 0], [2543, 155], [0, 155]])])
    return model, Image.open(RESOURCES / '000236.png'), seg


def test_greedy_path_keeps_no_posteriors(recognizer):
    from kraken_tpu_torch.configs import RecognitionInferenceConfig
    from kraken_tpu_torch.ops.ctc import beam_decoder
    model, im, seg = recognizer
    greedy = list(model.predict(im, seg))
    assert model.outputs is None
    model.prepare_for_inference(RecognitionInferenceConfig(device='cpu', num_line_workers=0,
                                                           return_logits=True))
    with_logits = list(model.predict(im, seg))
    assert model.outputs is not None and with_logits[0].logits is not None
    assert with_logits[0].prediction == greedy[0].prediction
    model.prepare_for_inference(RecognitionInferenceConfig(device='cpu', num_line_workers=0,
                                                           decoder=beam_decoder))
    list(model.predict(im, seg))
    assert model.outputs is not None and model.outputs.ndim == 3


def test_forward_holds_tf32_off_and_restores_it(recognizer, monkeypatch):
    from kraken_tpu_torch.configs import RecognitionInferenceConfig
    model, im, seg = recognizer
    model.prepare_for_inference(RecognitionInferenceConfig(device='cpu', num_line_workers=0))
    before = list(model.predict(im, seg))
    seen = []
    net_forward = type(model.net).forward

    def forward(self, *args, **kwargs):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return net_forward(self, *args, **kwargs)

    monkeypatch.setattr(type(model.net), 'forward', forward)
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.set_float32_matmul_precision('high')
        torch.backends.cudnn.allow_tf32 = True
        after = list(model.predict(im, seg))
        assert torch.backends.cuda.matmul.allow_tf32 is True
        assert torch.backends.cudnn.allow_tf32 is True
        assert torch.get_float32_matmul_precision() == 'high'
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    assert seen and all(flags == (False, False) for flags in seen)
    assert [(r.prediction, r.cuts, r.confidences) for r in after] == \
        [(r.prediction, r.cuts, r.confidences) for r in before]
