"""
The legacy ocropy peephole LSTM (``Lbxo``/``Lbyo``/``Lbxso`` specs) in the
port against the JAX package on the CPU, fp32, atol 1e-5:

- the recurrence: the plain version of the ``csrc/lstm.cu`` peephole
  variant (``lstm_recurrence_reference(..., peephole=...)``) against JAX's
  ``_peephole_scan`` in both directions, with nonzero peephole weights;
- the layer and whole networks on ragged batches: the recurrence runs
  over the full padded width (the JAX scan ignores the lengths, its
  reverse direction starts at the padding's end) while summarization
  takes each row's last valid step;
- ``Lfxo``/``Lrxo``: a ValueError at parse time in the port, where the JAX
  package builds a network that fails on its first forward (it runs both
  directions but counts one in ``output_size``);
- ``tests/resources/ocropy_small.mlmodel``, written as CoreML by the JAX
  package, through the port's CoreML reader, and its ``rpred`` records on
  ``bw.png`` (box segmentation) and on the fixture page (baselines) equal
  to the JAX package's (``torch_ocropy_golden.json``).

Write the fixture model and its golden anew with
``JAX_PLATFORMS=cpu python -m tests.test_torch_legacy_lstm``.
"""
import tests.test_torch_threads  # noqa: F401  (first: the thread share under xdist)
import hashlib
import json
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kraken_tpu.nn import layers as jax_layers
from kraken_tpu.vgsl import VGSLModel as JaxVGSLModel
from kraken_tpu_torch.nn.layers import TransposedSummarizingRNN
from kraken_tpu_torch.ops.lstm import lstm_recurrence, lstm_recurrence_reference
from kraken_tpu_torch.vgsl import VGSLModel

RESOURCES = Path(__file__).resolve().parent / 'resources'
MODEL = RESOURCES / 'ocropy_small.mlmodel'
GOLDEN = RESOURCES / 'torch_ocropy_golden.json'
MODEL_SPEC = '[1,48,0,1 S1(1x0)1,3 Lbxo16 O1c30]'
CHARSET = ' abcdefghijklmnopqrstuvwxyz.,'
PAGE_XML = RESOURCES / '170025120000003,0074.xml'
PAGE_JPG = RESOURCES / '170025120000003,0074.jpg'
LENS = np.array([32, 20, 7, 1], np.int32)


def randomized(sd: dict, seed: int, scale: float = 0.3) -> dict:
    """A state dict whose peephole weights (zero at init) are random."""
    rng = np.random.RandomState(seed)
    out = dict(sd)
    for k in sorted(out):
        if any(t in k for t in ('_ip_', '_fp_', '_op_')):
            out[k] = (out[k] + rng.randn(*out[k].shape) * scale).astype(np.float32)
    return out


def pair(spec: str, seed: int = 0):
    jm = JaxVGSLModel(vgsl=spec, rng=jax.random.PRNGKey(seed))
    sd = randomized(jm.state_dict(), seed)
    jm.load_state_dict(sd)
    tm = VGSLModel(spec)
    tm.from_jax_state_dict(sd)
    return jm, tm


def batch(shape, lens, seed=0):
    x = np.random.RandomState(seed).rand(*shape).astype(np.float32)
    x *= np.arange(shape[3])[None, None, None, :] < lens[:, None, None, None]
    return x


@pytest.mark.parametrize('reverse', [False, True])
def test_plain_recurrence_matches_peephole_scan(reverse):
    rng = np.random.RandomState(1)
    B, T, C, H = 3, 17, 6, 5
    x = rng.randn(B, T, C).astype(np.float32)
    w_ih = rng.randn(4 * H, C).astype(np.float32) * 0.3
    w_hh = rng.randn(4 * H, H).astype(np.float32) * 0.3
    peep = rng.randn(3, H).astype(np.float32)
    ref = jax_layers._peephole_scan(jnp.asarray(x), jnp.asarray(w_ih), jnp.asarray(w_hh),
                                    *map(jnp.asarray, peep), reverse)
    gates = torch.from_numpy(x @ w_ih.T)[:, :, None]
    out = lstm_recurrence_reference(gates, torch.from_numpy(w_hh)[None],
                                    torch.ones(B, T, dtype=torch.bool), reverse,
                                    peephole=torch.from_numpy(peep)[None])
    np.testing.assert_allclose(out[:, :, 0].numpy(), np.asarray(ref), atol=1e-5)


def test_peephole_terms_change_the_cell():
    """The plain version with zero peepholes is the plain LSTM, and nonzero
    ones change it: o reads the new cell, i and f the old one."""
    rng = np.random.RandomState(2)
    g = torch.from_numpy(rng.randn(2, 9, 2, 16).astype(np.float32))
    w = torch.from_numpy(rng.randn(2, 16, 4).astype(np.float32) * 0.3)
    m = torch.ones(2, 9, dtype=torch.bool)
    plain = lstm_recurrence_reference(g, w, m)
    zero = lstm_recurrence_reference(g, w, m, peephole=torch.zeros(2, 3, 4))
    assert torch.equal(plain, zero)
    for q in range(3):
        p = torch.zeros(2, 3, 4)
        p[:, q] = 1.0
        assert (lstm_recurrence_reference(g, w, m, peephole=p) - plain).abs().max() > 1e-3


def test_cpu_wrapper_takes_plain_path_with_peephole():
    rng = np.random.RandomState(3)
    g = torch.from_numpy(rng.randn(3, 5, 2, 8).astype(np.float32))
    w = torch.from_numpy(rng.randn(2, 8, 2).astype(np.float32))
    m = torch.ones(3, 5, dtype=torch.bool)
    p = torch.from_numpy(rng.randn(2, 3, 2).astype(np.float32))
    before = (lstm_recurrence.launches, lstm_recurrence.peephole_launches)
    out = lstm_recurrence(g, w, m, True, peephole=p)
    assert torch.equal(out, lstm_recurrence_reference(g, w, m, True, peephole=p))
    assert (lstm_recurrence.launches, lstm_recurrence.peephole_launches) == before
    with pytest.raises(ValueError, match='peephole'):
        lstm_recurrence(g, w, m, peephole=p[:, :2])


@pytest.mark.parametrize('transpose, summarize', [(False, False), (False, True),
                                                  (True, False), (True, True)])
def test_layer_matches_jax(transpose, summarize):
    """Lbxo, Lbxso, Lbyo and Lbyso on a ragged batch (x-axis layers get the
    lengths)."""
    jl = jax_layers.TransposedSummarizingRNN(4, 6, 'b', transpose, summarize, 'ocropy')
    params = randomized({k: np.asarray(v) for k, v in jl.init(jax.random.PRNGKey(4)).items()}, 4)
    tl = TransposedSummarizingRNN(4, 6, 'b', transpose, summarize, 'ocropy')
    tl.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()})
    x = batch((4, 4, 1 if not transpose else 5, 32), LENS, seed=5)
    yj, _ = jl.apply({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
                     jnp.asarray(LENS))
    with torch.no_grad():
        yt, lt = tl(torch.from_numpy(x), torch.from_numpy(LENS))
    assert yt.shape == yj.shape == tuple(tl.get_shape(x.shape))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5)
    assert torch.equal(lt, torch.from_numpy(LENS))


def test_no_mask_and_last_valid_step():
    """The recurrence ignores the lengths (the padding's outputs are the
    full-width run's, nonzero), summarization does not (each row keeps its
    last valid step)."""
    params = randomized({k: v.detach().numpy() for k, v in TransposedSummarizingRNN(
        3, 5, 'b', False, False, 'ocropy',
        generator=torch.Generator().manual_seed(6)).state_dict().items()}, 6)
    full = TransposedSummarizingRNN(3, 5, 'b', False, False, 'ocropy')
    summ = TransposedSummarizingRNN(3, 5, 'b', False, True, 'ocropy')
    for m in (full, summ):
        m.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    x = torch.from_numpy(batch((4, 3, 1, 32), LENS, seed=7))
    lens = torch.from_numpy(LENS)
    with torch.no_grad():
        y_lens, _ = full(x, lens)
        y_none, _ = full(x, None)
        y_sum, _ = summ(x, lens)
    assert torch.equal(y_lens, y_none)
    assert y_lens[3, :, 0, 1:].abs().min() > 0
    for i, n in enumerate(LENS.tolist()):
        assert torch.equal(y_sum[i, :, 0, 0], y_none[i, :, 0, n - 1])


@pytest.mark.parametrize('spec', [
    '[1,16,0,1 S1(1x0)1,3 Lbxo8 O1c5]',
    # a convolutional front and two ocropy layers
    '[1,16,0,1 Cr3,3,4 Mp2,2 S1(1x0)1,3 Lbxo6 Lbxo5 O1c5]',
    # a y-axis ocropy layer, then a summarizing x-axis one
    '[1,16,0,1 Cr3,3,4 Lbyo4 S1(1x0)1,3 Lbxso3 O1c5]',
])
def test_network_matches_jax(spec):
    jm, tm = pair(spec, seed=8)
    x = batch((4, 1, 16, 32), LENS, seed=8)
    yj, lj = jax.jit(jm.net.apply)(jm.params, jnp.asarray(x), jnp.asarray(LENS))
    with torch.no_grad():
        yt, lt = tm(torch.from_numpy(x), torch.from_numpy(LENS))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5)
    assert tm.named_spec == jm.named_spec and tm.output == jm.output
    assert set(tm.state_dict()) == set(jm.state_dict())


@pytest.mark.parametrize('block', ['Lfxo16', 'Lrxo16'])
def test_unidirectional_ocropy_raises_at_parse_time(block):
    with pytest.raises(ValueError, match='ocropy layers are bidirectional'):
        VGSLModel(f'[1,16,0,1 S1(1x0)1,3 {block} O1c5]')


@pytest.mark.parametrize('block', ['Lfxo8', 'Lrxo8'])
def test_jax_fails_on_unidirectional_ocropy(block):
    """The fault of the reference the port does not copy: the JAX package
    builds the layer with both directions but an output size of one, and
    its first forward cannot reshape the result."""
    jm = JaxVGSLModel(vgsl=f'[1,16,0,1 S1(1x0)1,3 {block} O1c5]', rng=jax.random.PRNGKey(0))
    x = jnp.asarray(np.random.RandomState(0).rand(1, 1, 16, 32).astype(np.float32))
    with pytest.raises(TypeError, match='reshape'):
        jm(x, jnp.asarray([32]))


def test_coreml_fixture_loads_like_jax():
    from kraken_tpu.models import load_models as jax_load_models
    from kraken_tpu_torch.models import load_models
    (ours,), (theirs,) = load_models(MODEL), jax_load_models(MODEL)
    assert ours.spec == theirs.spec and ours.model_type == ['recognition']
    sa, sb = ours.state_dict(), theirs.state_dict()
    assert set(sa) == set(sb) and any('weight_ip_l0_reverse' in k for k in sa)
    for k in sb:
        np.testing.assert_array_equal(sa[k].numpy(), sb[k], err_msg=k)
    assert any(np.abs(sb[k]).max() > 0 for k in sb if '_op_' in k)
    assert ours.codec.c2l == theirs.codec.c2l


@pytest.mark.parametrize('fmt', ['coreml', 'safetensors'])
def test_ocropy_layers_through_both_file_formats(tmp_path, fmt):
    """x- and y-axis ocropy layers with random peepholes, written by the JAX
    package's writers, read by the port's: the JAX weights and forward."""
    from kraken_tpu.codec import Codec as JaxCodec
    from kraken_tpu.models import write_models
    from kraken_tpu_torch.models import load_models
    spec = '[1,16,0,1 Cr3,3,4 Lbyo4 S1(1x0)1,3 Lbxo5 O1c6]'
    jm, _ = pair(spec, seed=9)
    jm.add_codec(JaxCodec('abcde'))
    jm.model_type = ['recognition']
    write_models([jm], tmp_path / f'ocropy.{fmt}', format=fmt)
    (tm,) = load_models(tmp_path / f'ocropy.{fmt}')
    sa, sb = tm.state_dict(), jm.state_dict()
    assert set(sa) == set(sb) and sum('_op_l0_reverse' in k for k in sa) == 2
    for k in sb:
        np.testing.assert_array_equal(sa[k].numpy(), sb[k], err_msg=k)
    x = batch((4, 1, 16, 32), LENS, seed=9)
    yj, _ = jax.jit(jm.net.apply)(jm.params, jnp.asarray(x), jnp.asarray(LENS))
    with torch.no_grad():
        yt, _ = tm(torch.from_numpy(x), torch.from_numpy(LENS))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5)


def _records(records) -> list:
    """Records as JSON data: the prediction, a sha256 of the cuts and the
    confidences to 6 decimals."""
    return [{'prediction': r.prediction,
             'cuts_sha256': hashlib.sha256(json.dumps(
                 [[list(map(int, p)) for p in c] for c in r.cuts]).encode()).hexdigest(),
             'confidences': [round(float(c), 6) for c in r.confidences]} for r in records]


def page_records(kind: str, package: str, model: Path = MODEL) -> list:
    """A fixture model's rpred records through `package` (the JAX package
    or the port): bw.png segmented by the box segmenter, or the fixture
    page's baselines."""
    from PIL import Image
    rpred = __import__(f'{package}.rpred', fromlist=['rpred']).rpred
    load_any = __import__(f'{package}.lib.models', fromlist=['load_any']).load_any
    net = load_any(model, device='cpu') if package == 'kraken_tpu_torch' else load_any(model)
    if kind == 'bw':
        segment = __import__(f'{package}.pageseg', fromlist=['segment']).segment
        im = Image.open(RESOURCES / 'bw.png')
        seg = segment(im)
    else:
        XMLPage = __import__(f'{package}.xml', fromlist=['XMLPage']).XMLPage
        im = Image.open(PAGE_JPG)
        seg = XMLPage(PAGE_XML).to_container()
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        return _records(rpred(net, im, seg))


@pytest.mark.parametrize('kind', ['bw', 'page'])
def test_rpred_records_equal_jax(kind):
    golden = json.loads(GOLDEN.read_text(encoding='utf-8'))[kind]
    ours = page_records(kind, 'kraken_tpu_torch')
    assert len(ours) == len(golden) > 20
    assert sum(len(r['prediction']) for r in ours) > 0
    for a, b in zip(ours, golden):
        assert a['prediction'] == b['prediction']
        assert a['cuts_sha256'] == b['cuts_sha256']
        np.testing.assert_allclose(a['confidences'], b['confidences'], atol=1e-5)


def write_fixture(path: Path, spec: str, seed: int, fmt: str) -> None:
    """A recognizer with random weights written by the JAX package: random
    peephole weights and Te LayerNorm weights (zero and one at init),
    convolutions scaled by 8 (so that a line's frames differ) and the
    output layer by 4 (so that a frame's classes rarely tie)."""
    from kraken_tpu.codec import Codec
    from kraken_tpu.models import write_models
    model = JaxVGSLModel(vgsl=spec, rng=jax.random.PRNGKey(seed), codec=Codec(CHARSET))
    model.model_type = 'recognition'
    rng = np.random.RandomState(seed)
    sd = model.state_dict()
    for k in sorted(sd):
        if any(t in k for t in ('_ip_', '_fp_', '_op_')) or ('.Te_' in k and 'norm' in k):
            sd[k] = (sd[k] + rng.randn(*sd[k].shape) * 0.3).astype(np.float32)
        elif k.endswith('co.weight'):
            sd[k] = sd[k] * 8
        elif k.endswith('lin.weight'):
            sd[k] = sd[k] * 4
    model.load_state_dict(sd)
    write_models([model], path, format=fmt)


if __name__ == '__main__':
    write_fixture(MODEL, MODEL_SPEC, 0, 'coreml')
    GOLDEN.write_text(json.dumps({kind: page_records(kind, 'kraken_tpu')
                                  for kind in ('bw', 'page')}, ensure_ascii=False, indent=0),
                      encoding='utf-8')
    print(f'wrote {MODEL} and {GOLDEN}')
