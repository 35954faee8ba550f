"""
The port's forced alignment (kraken_tpu_torch.align, .ops.trellis and
.tasks.align) against the JAX package on the CPU:

- the trellis: the plain version of the kernel of ``csrc/trellis.cu``
  (a batch of ragged lines at once) is equal bit for bit, infinities
  included, to the numpy ``kraken_tpu.align.get_trellis`` of each line,
  and within the JAX test's own rtol=1e-6 (with equal finiteness) of
  ``kraken_tpu.align.get_trellis_device``, whose XLA cumsum reorders the
  sum; ``backtrack`` and ``merge_repeats`` give JAX's paths and segments;
- the task: ``ForcedAlignmentTaskModel`` with ``device='cpu'`` gives the
  JAX task's records on the overfit model's line and on the fixture
  PageXML page (46 lines through ``overfit_bl.safetensors``): predictions
  and cuts equal, confidences within 1e-5 (the port's posteriors come from
  a softmax summed in fp64, JAX's from one summed in fp32), the same
  warnings and ``ValueError``s, and one trellis call a ``predict``;
- the deprecated ``forced_align`` and the contrib overlay script.

``tests/resources/torch_align_page.json`` is the fixture PageXML page as a
Segmentation (with its transcriptions) for the card's machine, which has
no lxml; write it anew with ``python -m tests.test_torch_align``.
"""
import tests.test_torch_threads  # noqa: F401  (first: the thread share under xdist)
import dataclasses
import json
import logging
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import kraken_tpu.align as jax_align
from kraken_tpu_torch import align
from kraken_tpu_torch.ops import trellis as trellis_ops

RESOURCES = Path(__file__).resolve().parent / 'resources'
XML = RESOURCES / '170025120000003,0074.xml'
PAGE_JSON = RESOURCES / 'torch_align_page.json'
BBOX_GOLD = 'ܡ ܘܡ ܗ ܡܕܐ ܐ ܐܐ ܡ ܗܗܐܐܐܕ'


def random_line(rng: np.random.RandomState, T: int, L: int, C: int):
    """A (T, C) emission of log-probabilities as the task builds them (the
    log-softmax of softmax outputs) and L tokens in [1, C)."""
    probs = rng.dirichlet(np.ones(C) * 0.3, size=T).astype(np.float32).T
    shifted = probs - probs.max(axis=0, keepdims=True)
    emission = (shifted - np.log(np.exp(shifted).sum(axis=0, keepdims=True))).T
    return np.ascontiguousarray(emission), rng.randint(1, C, size=L)


def seeded_lines(seed: int) -> list:
    """A ragged batch: T in 1-300, L in 1-T/2 (or 1 where T = 1), C in
    2-300, with a line of T == 2L and a 1-frame line."""
    rng = np.random.RandomState(seed)
    lines = []
    for _ in range(6):
        T = rng.randint(2, 301)
        lines.append(random_line(rng, T, rng.randint(1, T // 2 + 1), rng.randint(2, 301)))
    L = rng.randint(1, 40)
    lines.append(random_line(rng, 2 * L, L, rng.randint(2, 301)))
    lines.append(random_line(rng, 1, 1, rng.randint(2, 301)))
    return lines


def batch(lines: list) -> tuple:
    """The padded tensors :func:`trellis_ops.trellis` takes, on the CPU."""
    return trellis_ops.pad([e for e, _ in lines], [t for _, t in lines], 'cpu')


@pytest.mark.parametrize('seed', range(8))
def test_plain_trellis_equals_numpy(seed):
    lines = seeded_lines(seed)
    args = batch(lines)
    got = trellis_ops.blocks(trellis_ops.trellis(*args), args[2].tolist(), args[3].tolist())
    for (e, t), tr in zip(lines, got):
        want = jax_align.get_trellis(e, t)
        assert np.array_equal(tr.numpy(), want), (e.shape, len(t))
        assert np.array_equal(align.get_trellis(e, t), want)


def test_ragged_batch_edges_equal_numpy():
    """One batch of a 1-frame line, a 1-token line, a line of L + 1 > 1024
    columns, a line of T == 2L and one with L > T (every row of column 0 a
    sentinel): padded frames and tokens are never read as valid."""
    rng = np.random.RandomState(11)
    lines = [random_line(rng, 1, 1, 7), random_line(rng, 40, 1, 3),
             random_line(rng, 2100, 1030, 6), random_line(rng, 16, 8, 50),
             random_line(rng, 3, 5, 9)]
    args = batch(lines)
    got = trellis_ops.blocks(trellis_ops.trellis(*args), args[2].tolist(), args[3].tolist())
    for (e, t), tr in zip(lines, got):
        assert np.array_equal(tr.numpy(), jax_align.get_trellis(e, t)), (e.shape, len(t))
    # the sentinels reached the last column's lower rows (+inf) and row 0 (-inf)
    assert np.isposinf(got[3][-1, 0]) and np.isneginf(got[2][0, 1:]).all()
    assert np.isposinf(got[4][:, 0]).all()


@pytest.mark.parametrize('seed', range(4))
def test_trellis_device_within_jax_device_form(seed):
    """The port's device form against the JAX ``lax.scan`` form, at the JAX
    test's own tolerance (tests/test_tasks.py:test_trellis_device_parity):
    three ragged lines, the line of T == 2L and the 1-frame line of a seed
    (the JAX form compiles once for each shape)."""
    lines = seeded_lines(100 + seed)
    for e, t in lines[:3] + lines[-2:]:
        a = align.get_trellis_device(e, t, device='cpu').numpy()
        b = np.asarray(jax_align.get_trellis_device(e, t))
        mask = np.isfinite(a) & np.isfinite(b)
        np.testing.assert_allclose(a[mask], b[mask], rtol=1e-6)
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        np.testing.assert_array_equal(np.isposinf(a), np.isposinf(b))


@pytest.mark.parametrize('seed', range(4))
def test_backtrack_and_merge_equal_jax(seed):
    rng = np.random.RandomState(200 + seed)
    for _ in range(5):
        T = rng.randint(4, 200)
        e, t = random_line(rng, T, rng.randint(1, T // 2 + 1), rng.randint(2, 60))
        tr = jax_align.get_trellis(e, t)
        text = ''.join(chr(0x61 + (k % 26)) for k in range(len(t)))
        want = jax_align.merge_repeats(jax_align.backtrack(tr, e, t), text)
        got = align.merge_repeats(align.backtrack(tr, e, t), text)
        assert [dataclasses.astuple(s) for s in got] == [dataclasses.astuple(s) for s in want]


def test_batch_form_equals_numpy_on_the_cpu():
    lines = seeded_lines(300)
    for (e, t), tr in zip(lines, align.get_trellis_batch([e for e, _ in lines],
                                                         [t for _, t in lines], device='cpu')):
        assert np.array_equal(tr, jax_align.get_trellis(e, t))
    assert align.get_trellis_batch([], [], device='cpu') == []


@pytest.mark.parametrize('bad', ['nan', 'inf', 'token_high', 'token_negative', 'frames_over',
                                 'no_tokens', 'dtype', 'token_dtype', 'shape'])
def test_wrapper_refuses(bad):
    e, t, fl, tl = batch([random_line(np.random.RandomState(0), 6, 2, 5)])
    err = ValueError
    if bad == 'nan':
        e[0, 2, int(t[0, 1])] = float('nan')
    elif bad == 'inf':
        e[0, 0, 0] = float('-inf')
    elif bad == 'token_high':
        t[0, 0] = 5
    elif bad == 'token_negative':
        t[0, 1] = -1
    elif bad == 'frames_over':
        fl[0] = 7
    elif bad == 'no_tokens':
        tl[0] = 0
    elif bad == 'dtype':
        e, err = e.double(), TypeError
    elif bad == 'token_dtype':
        t, err = t.long(), TypeError
    else:
        e = e[0]
    with pytest.raises(err):
        trellis_ops.trellis(e, t, fl, tl)


def test_wrapper_reads_only_the_blank_and_the_tokens():
    """A class no token names is not read: it may hold anything."""
    e, t, fl, tl = batch([(np.zeros((6, 5), np.float32), np.array([1, 3]))])
    e[0, :, 2] = float('nan')
    e[0, :, 4] = float('inf')
    assert torch.isfinite(trellis_ops.trellis(e, t, fl, tl)[0, :, 0]).any()


def test_without_a_card_the_device_forms_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    e, t = random_line(np.random.RandomState(0), 6, 2, 5)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        align.get_trellis_device(e, t)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        align.get_trellis_batch([e], [t])


# ------------------------------------------------------------------ the task
def jax_task_run(seg, im, **config):
    from kraken_tpu.configs import RecognitionInferenceConfig
    from kraken_tpu.tasks import ForcedAlignmentTaskModel
    task = ForcedAlignmentTaskModel.load_model(RESOURCES / 'overfit.mlmodel')
    return task.predict(im, seg, RecognitionInferenceConfig(**config))


def torch_task_run(seg, im, model='overfit.mlmodel', **config):
    """The port's task on the CPU; the result carries, for a failing
    comparison, each line's smallest backtrack margin."""
    from kraken_tpu_torch.configs import RecognitionInferenceConfig
    from kraken_tpu_torch.tasks import ForcedAlignmentTaskModel
    task = ForcedAlignmentTaskModel.load_model(RESOURCES / model)
    result = task.predict(im, seg, RecognitionInferenceConfig(device='cpu', **config))
    result.margin = lambda idx: backtrack_margin(
        list(task.net.predict(im, seg))[idx].logits, task.net.codec, seg.lines[idx].text)
    return result


def backtrack_margin(logits, codec, text) -> float:
    """The smallest |changed - stayed| of the decisions along a line's
    backtrack between two finite scores (where the +inf sentinels of
    column 0, which run down the diagonal, take part, no small change can
    flip a decision): how near a tie the closest decision was."""
    _, labels, emission = align.prepare_line(logits, codec, text)
    tr = align.get_trellis(emission, labels)
    j = tr.shape[1] - 1
    margins = [float('inf')]
    for t in range(int(np.argmax(tr[:, j])), 0, -1):
        stayed = tr[t - 1, j] + emission[t - 1, 0]
        changed = tr[t - 1, j - 1] + emission[t - 1, labels[j - 1]]
        if np.isfinite(stayed) and np.isfinite(changed):
            margins.append(abs(float(changed - stayed)))
        if changed > stayed:
            j -= 1
            if j == 0:
                break
    return min(margins)


def jax_seg(lines: list):
    from kraken_tpu.containers import BaselineLine, Segmentation
    return Segmentation(type='baselines', imagename=RESOURCES / '000236.png',
                        text_direction='horizontal-lr', script_detection=False,
                        lines=[BaselineLine(id=f'l{i}', baseline=[[0, 10], [2543, 10]],
                                            boundary=[[0, 0], [2543, 0], [2543, 155], [0, 155]],
                                            text=text) for i, text in enumerate(lines)])


def torch_seg(lines: list):
    from kraken_tpu_torch.containers import Segmentation
    return Segmentation(**dataclasses.asdict(jax_seg(lines)))


def assert_same_records(port, jax) -> None:
    """Predictions and cuts equal, confidences within 1e-5, record for
    record; a line that differs is reported with its smallest backtrack
    margin in the port (a flip at a near-tie shows there)."""
    assert len(port.lines) == len(jax.lines)
    for idx, (a, b) in enumerate(zip(port.lines, jax.lines)):
        if (a.prediction, a.cuts) != (b.prediction, b.cuts):
            margin = port.margin(idx) if hasattr(port, 'margin') else None
            pytest.fail(f'line {idx} differs from JAX (port {a.prediction!r}, JAX '
                        f'{b.prediction!r}); its smallest backtrack margin: {margin}')
        assert type(a).__name__ == type(b).__name__
        assert a._display_order == b._display_order
        np.testing.assert_allclose(a.confidences, b.confidences, rtol=0, atol=1e-5)


@pytest.fixture(scope='module')
def line_image():
    return Image.open(RESOURCES / '000236.png')


# the single-line, two-line and empty cases of tests/test_tasks.py, a line
# without text, one the codec cannot encode beside encodable ones, and one
# whose output is too short for its transcription
@pytest.mark.parametrize('lines', [[BBOX_GOLD], [BBOX_GOLD, BBOX_GOLD], [],
                                   [BBOX_GOLD, None, 'Z' * 47, 'ܡ' * 200, 'ܐܐ']],
                         ids=['one', 'two', 'empty', 'mixed'])
def test_task_equals_jax(lines, line_image, caplog, monkeypatch):
    caplog.set_level(logging.WARNING)
    calls = []
    plain = trellis_ops.trellis
    monkeypatch.setattr(trellis_ops, 'trellis', lambda *a: calls.append(a[0].shape) or plain(*a))
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        want = jax_task_run(jax_seg(lines), line_image, padding=1, num_line_workers=0)
        jax_warnings = [r.getMessage() for r in caplog.records if r.levelno >= logging.WARNING
                        and r.name.startswith('kraken_tpu.')]
        caplog.clear()
        got = torch_task_run(torch_seg(lines), line_image, padding=1, num_line_workers=0)
    assert_same_records(got, want)
    port_warnings = [r.getMessage() for r in caplog.records if r.levelno >= logging.WARNING
                     and r.name.startswith('kraken_tpu_torch.')]
    assert port_warnings == jax_warnings
    # one trellis call a predict, for every line that is aligned
    aligned = sum(bool(r.prediction) for r in got.lines)
    assert calls == ([] if not aligned else [calls[0]]) and (not calls or calls[0][0] == aligned)


def test_task_unencodable_raises_as_jax(line_image):
    with warnings.catch_warnings(), pytest.raises(ValueError, match='no transcription shares'):
        warnings.simplefilter('ignore')
        jax_task_run(jax_seg(['Z' * 47]), line_image, padding=1, num_line_workers=0)
    with pytest.raises(ValueError, match='no transcription shares'):
        torch_task_run(torch_seg(['Z' * 47]), line_image, padding=1, num_line_workers=0)


def test_task_enables_logits_and_rejects_non_vgsl(line_image):
    from unittest.mock import MagicMock
    from kraken_tpu_torch.configs import RecognitionInferenceConfig
    from kraken_tpu_torch.tasks import ForcedAlignmentTaskModel
    task = ForcedAlignmentTaskModel.load_model(RESOURCES / 'overfit.mlmodel')
    config = RecognitionInferenceConfig(device='cpu', padding=1, num_line_workers=0)
    task.predict(line_image, torch_seg([BBOX_GOLD]), config)
    assert config.return_logits and config.return_line_image
    mock = MagicMock()
    mock.model_type = ['recognition']
    with pytest.raises(ValueError):
        ForcedAlignmentTaskModel([mock])


def test_task_without_a_card_raises(monkeypatch, line_image):
    from kraken_tpu_torch.configs import RecognitionInferenceConfig
    from kraken_tpu_torch.tasks import ForcedAlignmentTaskModel
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    task = ForcedAlignmentTaskModel.load_model(RESOURCES / 'overfit.mlmodel')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        task.predict(line_image, torch_seg([BBOX_GOLD]), RecognitionInferenceConfig())


def as_page_dict(seg) -> dict:
    """A Segmentation as JSON data, its image named by the file name alone
    (the readers resolve it to a path on the machine that parses the XML)."""
    page = json.loads(json.dumps(dataclasses.asdict(seg), default=str))
    page['imagename'] = Path(page['imagename']).name
    return page


def page_segmentation() -> dict:
    """The fixture PageXML page as a Segmentation dict (the port's reader)."""
    from kraken_tpu_torch.xml import XMLPage
    return as_page_dict(XMLPage(XML).to_container())


def test_page_json_is_the_xml_page():
    """The committed page equals the port's and the JAX package's reading
    of the fixture PageXML."""
    from kraken_tpu.xml import XMLPage as JaxXMLPage
    page = json.loads(PAGE_JSON.read_text(encoding='utf-8'))
    assert page == page_segmentation()
    assert page == as_page_dict(JaxXMLPage(XML).to_container())


def test_task_on_the_xml_page_equals_jax():
    """Every line of the fixture page (46 with text, several with code
    points the codec lacks) through overfit_bl.safetensors."""
    from kraken_tpu.configs import RecognitionInferenceConfig
    from kraken_tpu.containers import Segmentation as JaxSegmentation
    from kraken_tpu.tasks import ForcedAlignmentTaskModel
    from kraken_tpu_torch.containers import Segmentation
    page = json.loads(PAGE_JSON.read_text(encoding='utf-8'))
    im = Image.open(RESOURCES / '170025120000003,0074.jpg')
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        want = ForcedAlignmentTaskModel.load_model(RESOURCES / 'overfit_bl.safetensors').predict(
            im, JaxSegmentation(**page), RecognitionInferenceConfig())
        got = torch_task_run(Segmentation(**page), im, model='overfit_bl.safetensors')
    assert sum(bool(r.prediction) for r in got.lines) > 40
    assert_same_records(got, want)


def test_forced_align_equals_jax(line_image):
    from kraken_tpu.lib.models import load_any as jax_load_any
    from kraken_tpu_torch.lib.models import load_any
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        want = jax_align.forced_align(jax_seg([BBOX_GOLD, 'ܡ' * 200]),
                                      jax_load_any(RESOURCES / 'overfit.mlmodel'))
        got = align.forced_align(torch_seg([BBOX_GOLD, 'ܡ' * 200]),
                                 load_any(RESOURCES / 'overfit.mlmodel', device='cpu'))
    assert got.lines[0].prediction
    assert_same_records(got, want)


def test_overlay_script_draws_jax_cuts(tmp_path):
    """The contrib overlay script of both packages on the fixture PageXML
    draws the same picture."""
    import shutil
    from click.testing import CliRunner
    from kraken_tpu.contrib import forced_alignment_overlay as jax_overlay
    from kraken_tpu_torch.contrib import forced_alignment_overlay as overlay
    pictures = []
    for cli, args in ((jax_overlay.cli, []), (overlay.cli, ['-d', 'cpu'])):
        work = tmp_path / str(len(pictures))
        work.mkdir()
        shutil.copy(XML, work / XML.name)
        shutil.copy(RESOURCES / '170025120000003,0074.jpg', work)
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            result = CliRunner().invoke(cli, ['-m', str(RESOURCES / 'overfit_bl.safetensors'),
                                              *args, str(work / XML.name)])
        assert result.exit_code == 0, (result.output, result.exception)
        pictures.append(np.asarray(Image.open(work / (XML.name + '.align.png'))))
    assert np.array_equal(pictures[0], pictures[1])


def test_overlay_script_without_a_card_is_a_usage_error(monkeypatch, tmp_path):
    from click.testing import CliRunner
    from kraken_tpu_torch.contrib import forced_alignment_overlay as overlay
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    result = CliRunner().invoke(overlay.cli, ['-m', str(RESOURCES / 'overfit_bl.safetensors'),
                                              str(XML)])
    assert result.exit_code == 2 and 'no CUDA device' in result.output


if __name__ == '__main__':
    PAGE_JSON.write_text(json.dumps(page_segmentation(), ensure_ascii=False) + '\n',
                         encoding='utf-8')
    print(f'wrote {PAGE_JSON}')
