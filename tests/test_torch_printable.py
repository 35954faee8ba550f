"""
The port's ``is_printable``/``make_printable`` (``kraken_tpu_torch/lib/
util.py``) against the JAX package's, over every code point of the Basic
Multilingual Plane.

The two differ at one code point by design: upstream kraken counts only
letters, numbers, punctuation and symbols (categories ``L*``, ``N*``,
``P*``, ``S*``) as printable, so a space is not and is shown by its name
``SPACE``; the JAX package calls a space printable and shows it as a blank
(``kraken_tpu/lib/util.py:82-83``), which the port repairs. Everywhere
else both give the same answer, and so do the alphabet reports of
``ketos compile`` and of a new recognition model's training, but for the
space's line. The cases that compare with the JAX package skip where
``jax`` is absent, as on the card's machine.
"""
import tests.test_torch_threads  # noqa: F401  (first: the thread share under xdist)
import logging
import unicodedata
from pathlib import Path

import pytest

from kraken_tpu_torch.lib.util import is_printable, make_printable

try:
    import jax  # noqa: F401
    HAVE_JAX = True
except ImportError:
    HAVE_JAX = False
needs_jax = pytest.mark.skipif(not HAVE_JAX, reason='compares with the JAX package, which needs jax')

BMP = [chr(c) for c in range(0x10000)]


def test_printable_is_letters_numbers_punctuation_and_symbols():
    for char in BMP:
        assert is_printable(char) == (unicodedata.category(char)[0] in 'LNPS'), hex(ord(char))
    assert not is_printable('')


def test_space_is_named():
    assert not is_printable(' ')
    assert make_printable(' ') == 'SPACE'
    assert make_printable('a b') == 'aSPACEb'
    assert make_printable('　') == 'IDEOGRAPHIC SPACE'
    assert make_printable('') == ''


@needs_jax
@pytest.mark.parametrize('fn', ['is_printable', 'make_printable'])
def test_bmp_equals_jax_but_the_space(fn):
    import kraken_tpu.lib.util as jax_util
    ours, theirs = globals()[fn], getattr(jax_util, fn)
    differ = [char for char in BMP if ours(char) != theirs(char)]
    assert differ == [' ']
    assert ours('') == theirs('')


@needs_jax
def test_jax_package_keeps_the_blank_space():
    import kraken_tpu.lib.util as jax_util
    assert jax_util.is_printable(' ') is True
    assert jax_util.make_printable(' ') == ' '
    assert jax_util.make_printable('a b') == 'a b'


PATH_LINES = [str(Path(__file__).resolve().parent / 'resources' / 'merge_tests' / f'{n}.jpg')
              for n in ('0006', '0007', '0008', '0021')]
TINY_REC_SPEC = '[1,32,0,1 Cr3,3,4,2,2 S1(1x0)1,3 Lbx8]'


def alphabet_lines(caplog, logger: str, level: int) -> list:
    return [r.getMessage() for r in caplog.records
            if r.name == logger and r.levelno == level and '\t' in r.getMessage()]


def space_named(line: str) -> str:
    """A JAX alphabet report line as the port writes it: the space's line
    starts ``SPACE`` where the JAX package prints a tab and a blank."""
    return 'SPACE\t' + line[3:] if line.startswith('\t \t') else line


@needs_jax
def test_compile_alphabet_report_equals_jax_but_the_space(caplog, tmp_path):
    """``ketos compile``'s alphabet report (``dataset/arrow.py``): the JAX
    lines, count for count, with the space's line named."""
    from kraken_tpu.dataset.arrow import build_binary_dataset as jax_build
    from kraken_tpu_torch.dataset.arrow import build_binary_dataset
    reports = []
    for build, logger in ((jax_build, 'kraken_tpu.dataset.arrow'),
                          (build_binary_dataset, 'kraken_tpu_torch.dataset.arrow')):
        caplog.clear()
        with caplog.at_level(logging.INFO, logger=logger):
            build(PATH_LINES, tmp_path / f'{logger}.arrow', format_type='path')
        reports.append(alphabet_lines(caplog, logger, logging.INFO))
    theirs, ours = reports
    assert '\t \t4' in theirs and 'SPACE\t4' in ours
    assert ours == [space_named(line) for line in theirs]


@needs_jax
def test_training_codec_report_equals_jax_but_the_space(caplog):
    """The codec a new recognition model is trained with, as
    ``RecognitionModel.setup`` logs it: the JAX lines with the space's line
    named."""
    from kraken_tpu.configs import RecognitionTrainingConfig as JaxConfig
    from kraken_tpu.configs import RecognitionTrainingDataConfig as JaxDataConfig
    from kraken_tpu.train import RecognitionDataModule as JaxDataModule
    from kraken_tpu.train import RecognitionModel as JaxModel
    from kraken_tpu_torch.configs import (RecognitionTrainingConfig,
                                          RecognitionTrainingDataConfig)
    from kraken_tpu_torch.train import RecognitionDataModule, RecognitionModel
    data = dict(format_type='path', training_data=PATH_LINES[:3],
                evaluation_data=PATH_LINES[3:], batch_size=1)
    reports = []
    for logger, make in (
            ('kraken_tpu.train.recognition',
             lambda: (JaxDataModule(JaxDataConfig(**data)),
                      JaxModel(JaxConfig(spec=TINY_REC_SPEC)))),
            ('kraken_tpu_torch.train.recognition',
             lambda: (RecognitionDataModule(RecognitionTrainingDataConfig(**data)),
                      RecognitionModel(RecognitionTrainingConfig(device='cpu',
                                                                 spec=TINY_REC_SPEC))))):
        caplog.clear()
        dm, module = make()
        dm.setup('fit')
        with caplog.at_level(logging.DEBUG, logger=logger):
            module.setup('fit', dm)
        reports.append(alphabet_lines(caplog, logger, logging.DEBUG))
    theirs, ours = reports
    assert '\t \t[1]' in theirs and 'SPACE\t[1]' in ours
    assert ours == [space_named(line) for line in theirs]
