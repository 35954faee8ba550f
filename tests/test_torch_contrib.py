"""
The port's contrib scripts (kraken_tpu_torch/contrib) against the JAX
package's: each renders ``--help``, and the cases of tests/test_contrib.py
run through both packages' scripts on the same inputs give

- byte-equal files for ``extract_lines``, ``repolygonize``,
  ``print_word_spreader`` and ``segmentation_overlay`` from XML;
- an overlay within 2 grey levels on at least 99.9% of the pixels for
  ``heatmap_overlay`` (the two forwards differ in summation order, which
  can move a pixel's class or its truncated colour);
- the checked-in ``_bidi_tables.json``, byte for byte, from
  ``generate_bidi_tables`` with its output pointed at a temporary copy;
- byte-equal line files from ``extract_lines -f binary`` (the port reads
  the Arrow file through its ``ArrowIPCRecognitionDataset``);
- for ``set_seg_options`` and ``add_neural_ro`` (model writers), files
  that load in both packages with the JAX script's metadata and
  parameters (bit for bit); for ``test_per_file``, the JAX script's
  output;
- byte-equal target heatmaps and overlays from ``baselineset_overlay``;
  from ``generate_scripts`` the JAX script's JSON, which with no options
  is the checked-in ``dataset/_scripts_ranges.json``, byte for byte.

The scripts that run a model default to ``--device cuda`` and stop with a
usage error without a card; here they run with ``-d cpu``.
"""
import tests.test_torch_threads  # noqa: F401  (first: the thread share under xdist)
import importlib
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

REPO = Path(__file__).resolve().parent.parent
RESOURCES = REPO / 'tests' / 'resources'
PAGE_XML = RESOURCES / '170025120000003,0074.xml'
PAGE_JPG = RESOURCES / '170025120000003,0074.jpg'
PORT = sorted(p.stem for p in (REPO / 'kraken_tpu_torch' / 'contrib').glob('*.py')
              if p.stem != '__init__')
HOCR = ('<html xmlns="http://www.w3.org/1999/xhtml"><body>'
        '<div class="ocr_page" title="bbox 0 0 1000 1000">'
        '<span class="ocr_line" title="bbox 10 10 900 50">'
        '<span class="ocrx_word" title="bbox 10 10 100 50; x_confs 91.5 80.0">foo</span>'
        '<span class="ocrx_word" title="bbox 100 10 120 50"> </span>'
        '<span class="ocrx_word" title="bbox 120 10 300 50; x_confs 70 60.5 99">bar</span>'
        '<span class="ocrx_word" title="bbox 300 10 990 990">huge</span>'
        '</span></div></body></html>')


def _run(package: str, script: str, args: list):
    cli = importlib.import_module(f'{package}.contrib.{script}').cli
    result = CliRunner().invoke(cli, [str(a) for a in args])
    assert result.exit_code == 0, result.output
    return result


def _page_copy(path: Path) -> Path:
    path.mkdir()
    shutil.copy(PAGE_XML, path / 'page.xml')
    shutil.copy(PAGE_JPG, path / PAGE_JPG.name)
    return path / 'page.xml'


def _files(path: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(path.iterdir()) if p.is_file()}


def test_the_six_scripts_exist():
    assert {'extract_lines', 'repolygonize', 'segmentation_overlay', 'heatmap_overlay',
            'print_word_spreader', 'generate_bidi_tables'} <= set(PORT)


@pytest.mark.parametrize('name', PORT)
def test_contrib_help(name):
    result = _run('kraken_tpu_torch', name, ['--help'])
    assert 'Usage' in result.output


def test_extract_lines_xml(tmp_path):
    for package in ('kraken_tpu', 'kraken_tpu_torch'):
        _run(package, 'extract_lines', ['-f', 'xml', '-o', tmp_path / package, PAGE_XML])
    ours, theirs = _files(tmp_path / 'kraken_tpu_torch'), _files(tmp_path / 'kraken_tpu')
    assert len([n for n in ours if n.endswith('.png')]) > 10
    assert ours == theirs


def test_repolygonize(tmp_path):
    """Both scripts write into one directory (the ALTO names the page image
    by its path). The port's ALTO carries the ID that ALTO 4.3 requires on
    the UnorderedGroup of several line orders, which the JAX serializer
    leaves out (tests/test_torch_cli.py:as_jax_alto); every other byte is
    equal."""
    page = _page_copy(tmp_path / 'page')
    out = {}
    for package in ('kraken_tpu', 'kraken_tpu_torch'):
        _run(package, 'repolygonize', ['-f', 'xml', page])
        out[package] = (tmp_path / 'page' / 'page.repoly.xml').read_bytes()
    assert out['kraken_tpu_torch'].count(b'<TextLine') > 10
    group = b'<UnorderedGroup ID="ro_orders">'
    assert out['kraken_tpu_torch'].count(group) == 1
    assert out['kraken_tpu_torch'].replace(group, b'<UnorderedGroup>') == out['kraken_tpu']


@pytest.mark.parametrize('flags', [['-s'], ['-s', '-f', '-c']])
def test_print_word_spreader(tmp_path, flags):
    (tmp_path / 'in').mkdir()
    (tmp_path / 'in' / 't.html').write_text(HOCR)
    for package in ('kraken_tpu', 'kraken_tpu_torch'):
        _run(package, 'print_word_spreader', ['--input-dir', tmp_path / 'in',
                                              '--output-dir', tmp_path / package, *flags])
    ours = (tmp_path / 'kraken_tpu_torch' / 't.html').read_bytes()
    assert b'bbox 10 10 108 50' in ours  # the word widened into the space's gap
    assert ours == (tmp_path / 'kraken_tpu' / 't.html').read_bytes()


def test_segmentation_overlay_from_xml(tmp_path):
    out = {}
    for package in ('kraken_tpu', 'kraken_tpu_torch'):
        page = _page_copy(tmp_path / package)
        _run(package, 'segmentation_overlay', ['-f', 'xml', page])
        out[package] = (tmp_path / package / 'page.xml.overlay.png').read_bytes()
    assert out['kraken_tpu_torch'] == out['kraken_tpu']


def _seg_model(path: Path) -> Path:
    """The segmentation model of tests/test_contrib.py:test_heatmap_overlay,
    written by the JAX package."""
    import jax
    from kraken_tpu.models import write_models
    from kraken_tpu.vgsl import VGSLModel
    model = VGSLModel(vgsl='[1,128,0,3 Cr3,3,8,2,2 Gn2 O2l4]', rng=jax.random.PRNGKey(0))
    model.model_type = 'segmentation'
    model.user_metadata['class_mapping'] = {'aux': {'_start_separator': 0, '_end_separator': 1},
                                            'baselines': {'default': 2}, 'regions': {'text': 3}}
    write_models([model], path)
    return path


def test_heatmap_overlay(tmp_path):
    model = _seg_model(tmp_path / 'seg.safetensors')
    out = {}
    for package, extra in (('kraken_tpu', []), ('kraken_tpu_torch', ['-d', 'cpu'])):
        (tmp_path / package).mkdir()
        shutil.copy(RESOURCES / 'bw.png', tmp_path / package / 'bw.png')
        _run(package, 'heatmap_overlay', ['-i', model, *extra, tmp_path / package / 'bw.png'])
        out[package] = np.asarray(Image.open(tmp_path / package / 'bw.png.heat.png'), np.int16)
    assert out['kraken_tpu_torch'].shape == out['kraken_tpu'].shape
    close = (np.abs(out['kraken_tpu_torch'] - out['kraken_tpu']) <= 2).all(axis=-1)
    assert close.mean() >= 0.999


def test_generate_bidi_tables(tmp_path, monkeypatch):
    from kraken_tpu_torch.contrib import generate_bidi_tables
    checked_in = REPO / 'kraken_tpu_torch' / 'lib' / '_bidi_tables.json'
    copy = tmp_path / '_bidi_tables.json'
    copy.write_bytes(checked_in.read_bytes())
    monkeypatch.setattr(generate_bidi_tables, 'OUT', copy)
    _run('kraken_tpu_torch', 'generate_bidi_tables', [])
    assert copy.read_bytes() == checked_in.read_bytes()


@pytest.mark.parametrize('script, args', [
    ('heatmap_overlay', ['-i', RESOURCES / 'blla_small.safetensors']),
    ('segmentation_overlay', []),
    ('test_per_file', ['-m', RESOURCES / 'overfit.mlmodel']),
])
def test_model_scripts_need_a_card_by_default(monkeypatch, script, args):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    cli = importlib.import_module(f'kraken_tpu_torch.contrib.{script}').cli
    result = CliRunner().invoke(cli, [str(a) for a in args] + [str(RESOURCES / 'bw.png')])
    assert result.exit_code == 2 and 'no CUDA device' in result.output


def test_the_evaluation_scripts_exist():
    assert {'set_seg_options', 'add_neural_ro', 'test_per_file'} <= set(PORT)


@pytest.mark.parametrize('arrow', ['base.arrow', 'merger.arrow'])
def test_extract_lines_binary(tmp_path, arrow):
    for package in ('kraken_tpu', 'kraken_tpu_torch'):
        _run(package, 'extract_lines', ['-f', 'binary', '-o', tmp_path / package,
                                        RESOURCES / 'merge_tests' / arrow])
    ours, theirs = _files(tmp_path / 'kraken_tpu_torch'), _files(tmp_path / 'kraken_tpu')
    assert len([n for n in ours if n.endswith('.png')]) > 0
    assert ours == theirs


def _same_files(a: Path, b: Path) -> None:
    """Both packages load both files to the same models: metadata and
    parameters bit for bit."""
    from kraken_tpu.models import load_models as jax_load
    from kraken_tpu_torch.models import load_models
    for load in (jax_load, load_models):
        for x, y in zip(load(a), load(b), strict=True):
            assert type(x) is type(y) and x.user_metadata == y.user_metadata
            xs, ys = x.state_dict(), y.state_dict()
            assert sorted(xs) == sorted(ys)
            assert all(np.array_equal(np.asarray(xs[k]), np.asarray(ys[k])) for k in xs)


@pytest.mark.parametrize('args', [['-br', 'text', '-br', 'table', '--topline'],
                                  ['--baseline', '--pad', '10', '20']])
def test_set_seg_options(tmp_path, args):
    out = {}
    for package in ('kraken_tpu', 'kraken_tpu_torch'):
        out[package] = _seg_model(tmp_path / f'{package}.safetensors')
        result = _run(package, 'set_seg_options', args + [out[package]])
        out[package, 'echo'] = result.output
    assert out['kraken_tpu_torch', 'echo'] == out['kraken_tpu', 'echo']
    assert 'Metadata updated' in out['kraken_tpu', 'echo']
    _same_files(out['kraken_tpu_torch'], out['kraken_tpu'])


def test_add_neural_ro(tmp_path):
    for package in ('kraken_tpu', 'kraken_tpu_torch'):
        _run(package, 'add_neural_ro', ['-r', RESOURCES / 'ro_small.safetensors',
                                        '-o', tmp_path / f'{package}.safetensors',
                                        RESOURCES / 'blla_small.safetensors'])
    _same_files(tmp_path / 'kraken_tpu_torch.safetensors', tmp_path / 'kraken_tpu.safetensors')
    from kraken_tpu_torch.models import load_models
    assert [type(m).__name__ for m in load_models(tmp_path / 'kraken_tpu_torch.safetensors')] \
        == ['VGSLModel', 'ROMLP']


def test_per_file_equals_jax():
    args = ['-m', RESOURCES / 'overfit_bl.safetensors', '-f', 'xml', PAGE_XML]
    ours = _run('kraken_tpu_torch', 'test_per_file', ['-d', 'cpu'] + args).output
    assert 'TOTAL\tCER' in ours
    assert ours == _run('kraken_tpu', 'test_per_file', args).output


def test_baselineset_overlay(tmp_path):
    out = {}
    for package in ('kraken_tpu', 'kraken_tpu_torch'):
        page = _page_copy(tmp_path / package)
        _run(package, 'baselineset_overlay', [page])
        out[package] = {n: b for n, b in _files(tmp_path / package).items()
                        if n.endswith('.png')}
    names = sorted(out['kraken_tpu_torch'])
    assert any('.heat.' in n for n in names) and any(n.endswith('.overlay.png') for n in names)
    assert out['kraken_tpu_torch'] == out['kraken_tpu']


def test_generate_scripts(tmp_path):
    for package in ('kraken_tpu', 'kraken_tpu_torch'):
        _run(package, 'generate_scripts', ['-o', tmp_path / f'{package}.json'])
    ours = (tmp_path / 'kraken_tpu_torch.json').read_bytes()
    assert ours == (tmp_path / 'kraken_tpu.json').read_bytes()
    assert ours == (REPO / 'kraken_tpu_torch' / 'dataset' / '_scripts_ranges.json').read_bytes()
