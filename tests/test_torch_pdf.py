"""
The port's scanned-PDF extractor (kraken_tpu_torch.lib.pdf) against the JAX
package's (kraken_tpu.lib.pdf).

Each test of tests/test_pdf.py runs again with the extractor's public
functions (``extract_page_images``, ``extract_page_images_lazy``,
``page_count``, ``PDFError``, ``_lzw_decode``) replaced by twins that call
the port's function and hold it to the JAX one on the same input: the same
page images (mode, size and pixels, exactly), the same page count, the same
decoded bytes, and where the JAX extractor raises, the port raises its own
``PDFError`` with the same message. So every assertion of the JAX test holds
of the port's output, and that output equals the JAX output. The CLI's
``-f pdf`` runs in :func:`test_cli_pdf_input` and in tests/test_torch_cli.py;
the lazy page thunks through the port's ``process_pages`` here.
"""
import tests.test_torch_threads  # noqa: F401  (first: the thread share under xdist)
import sys
import types
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import kraken_tpu.lib.pdf as jax_pdf
import kraken_tpu_torch.lib.pdf as torch_pdf
import tests.test_pdf as jax_tests

# the JAX tests, but for the CLI's, which runs the JAX CLI (ported below)
JAX_TESTS = sorted(n for n in dir(jax_tests)
                   if n.startswith('test_') and n != 'test_cli_pdf_input')


def same_image(a: Image.Image, b: Image.Image) -> None:
    assert (a.mode, a.size) == (b.mode, b.size)
    assert np.array_equal(np.asarray(a), np.asarray(b))


def jax_outcome(fn, *args):
    """What the JAX function gives: ('ok', value) or ('raise', message)."""
    try:
        return 'ok', fn(*args)
    except jax_pdf.PDFError as e:
        return 'raise', str(e)


def held(name: str, port_fn, jax_fn, compare):
    """`port_fn`, held to `jax_fn` on the same arguments by `compare`."""
    def call(*args):
        kind, expected = jax_outcome(jax_fn, *args)
        if kind == 'raise':
            with pytest.raises(torch_pdf.PDFError) as e:
                port_fn(*args)
            assert str(e.value) == expected
            raise e.value
        got = port_fn(*args)
        compare(got, expected)
        return got
    call.__name__ = name
    return call


def _pages(got, expected):
    assert len(got) == len(expected)
    for a, b in zip(got, expected):
        same_image(a, b)


def _thunks(got, expected):
    assert len(got) == len(expected) and all(callable(t) for t in got)
    # each page decoded from the port's thunk equals the JAX thunk's,
    # last page first (the thunks decode in any order)
    for a, b in zip(reversed(got), reversed(expected)):
        same_image(a(), b())


def _equal(got, expected):
    assert got == expected


TWINS = {
    'extract_page_images': (lambda p: list(torch_pdf.extract_page_images(p)),
                            lambda p: list(jax_pdf.extract_page_images(p)), _pages),
    'extract_page_images_lazy': (lambda p: list(torch_pdf.extract_page_images_lazy(p)),
                                 lambda p: list(jax_pdf.extract_page_images_lazy(p)), _thunks),
    'page_count': (torch_pdf.page_count, jax_pdf.page_count, _equal),
    '_lzw_decode': (torch_pdf._lzw_decode, jax_pdf._lzw_decode, _equal),
}


@pytest.fixture
def port_extractor(monkeypatch):
    """The JAX test module's names, and what its tests import from
    ``kraken_tpu.lib.pdf`` inside (a stand-in module in ``sys.modules``;
    the JAX module itself is left as it is), as the port's functions held
    to the JAX ones."""
    stand_in = types.ModuleType(jax_pdf.__name__)
    stand_in.PDFError = torch_pdf.PDFError
    monkeypatch.setattr(jax_tests, 'PDFError', torch_pdf.PDFError)
    for name, (port_fn, jax_fn, compare) in TWINS.items():
        twin = held(name, port_fn, jax_fn, compare)
        setattr(stand_in, name, twin)
        if hasattr(jax_tests, name):
            monkeypatch.setattr(jax_tests, name, twin)
    monkeypatch.setitem(sys.modules, jax_pdf.__name__, stand_in)


@pytest.mark.parametrize('name', JAX_TESTS)
def test_jax_pdf_test_holds_for_the_port(name, port_extractor, tmp_path):
    test = getattr(jax_tests, name)
    if 'tmp_path' in test.__code__.co_varnames[:test.__code__.co_argcount]:
        test(tmp_path)
    else:
        test()


def test_cli_pdf_input(tmp_path):
    """kraken -f pdf runs the binarize stage over the extracted pages (the
    JAX test_cli_pdf_input on the port's CLI, on the CPU)."""
    import glob
    import os
    from click.testing import CliRunner
    from kraken_tpu_torch.kraken import cli
    p, _ = jax_tests._classic_jpeg_pdf(tmp_path)
    runner = CliRunner()
    with runner.isolated_filesystem(temp_dir=tmp_path) as fs:
        result = runner.invoke(cli, ['-d', 'cpu', '-f', 'pdf', '-i', str(p), 'out.png',
                                     '-o', '.png', '-p', 'page_{idx:06d}', 'binarize'],
                               catch_exceptions=False)
        assert result.exit_code == 0, result.output
        produced = glob.glob(os.path.join(fs, '**', '*.png'), recursive=True)
        assert produced, result.output


class _VipsPage:
    """A stand-in of a pyvips page: like pyvips.Image it has
    ``write_to_buffer`` and ``get``, and no PIL ``save``."""
    pages = [Image.fromarray(np.random.RandomState(i).randint(0, 256, (20 + i, 30), np.uint8))
             for i in range(3)]

    def __init__(self, page=None):
        self.page = page

    def get(self, name):
        assert name == 'n-pages'
        return len(self.pages)

    def write_to_buffer(self, suffix):
        import io
        assert suffix == '.png'
        buf = io.BytesIO()
        self.pages[self.page].save(buf, format='PNG')
        return buf.getvalue()


def test_cli_pdf_input_through_pyvips(monkeypatch, tmp_path):
    """Where pyvips is installed, ``-f pdf`` takes its rasterized pages (a
    stand-in module here): each page reaches the subcommands as an image
    file, one output a page."""
    from click.testing import CliRunner
    from kraken_tpu_torch.kraken import cli
    calls = []

    def new_from_file(path, n=None, page=None, dpi=None):
        calls.append((n, page, dpi))
        return _VipsPage(page)

    vips = types.ModuleType('pyvips')
    vips.Image = types.SimpleNamespace(new_from_file=new_from_file)
    monkeypatch.setitem(sys.modules, 'pyvips', vips)
    p, _ = jax_tests._classic_jpeg_pdf(tmp_path)
    runner = CliRunner()
    with runner.isolated_filesystem(temp_dir=tmp_path) as fs:
        result = runner.invoke(cli, ['-d', 'cpu', '-f', 'pdf', '-i', str(p), 'out.png',
                                     '-o', '.png', '-p', 'page_{idx:06d}', 'binarize'],
                               catch_exceptions=False)
        assert result.exit_code == 0, result.output
        outs = sorted(Path(fs).glob('page_*.png'))
    assert calls == [(-1, None, None), (None, 0, 300), (None, 1, 300), (None, 2, 300)]
    assert [o.name for o in outs] == [f'page_{i:06d}.png' for i in range(3)]
    for out, page in zip(outs, _VipsPage.pages):
        with Image.open(out) as im:
            assert im.size == page.size


def test_process_pages_takes_lazy_pdf_pages(resources, tmp_path):
    """The port's process_pages decodes lazy PDF page thunks in its
    prefetch pool and segments them with the legacy segmenter: the same
    pages, segmentations and records as the eager images page by page."""
    from kraken_tpu_torch.configs import RecognitionInferenceConfig
    from kraken_tpu_torch.models import load_models
    from kraken_tpu_torch.pageseg import segment
    from kraken_tpu_torch.pipeline import process_pages
    import zlib
    with Image.open(resources / 'bw.png') as im:
        page = im.convert('L').crop((0, 0, 1200, 700))
    objs = jax_tests._doc_skeleton([3, 5])
    raw = zlib.compress(np.asarray(page).tobytes())
    objs[3] = jax_tests._page_obj(3, 2, img_ref=4)
    objs[4] = jax_tests._image_obj(4, raw, page.width, page.height, cs='/DeviceGray',
                                   filt='FlateDecode')
    objs[5] = jax_tests._page_obj(5, 2, img_ref=4, rotate=180)
    pdf = tmp_path / 'doc.pdf'
    pdf.write_bytes(jax_tests._assemble_classic(objs))
    model = load_models(resources / 'overfit.mlmodel')[0]
    model.prepare_for_inference(RecognitionInferenceConfig(device='cpu', batch_size=8,
                                                           num_line_workers=0))
    out = list(process_pages(torch_pdf.extract_page_images_lazy(pdf), model, segment))
    eager = list(torch_pdf.extract_page_images(pdf))
    assert len(out) == 2
    for (im, seg, records), ref in zip(out, eager):
        same_image(im, ref)
        ref_seg = segment(ref)
        assert [line.bbox for line in seg.lines] == [line.bbox for line in ref_seg.lines]
        assert len(seg.lines) > 5
        ref_records = list(model.predict(ref, ref_seg))
        assert [r.prediction for r in records] == [r.prediction for r in ref_records]
        assert [r.cuts for r in records] == [r.cuts for r in ref_records]
