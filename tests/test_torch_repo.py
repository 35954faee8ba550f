"""
The port's model repository client (``kraken_tpu_torch.repo``,
``lib/iso_names.py``, ``kraken list``/``get``/``show`` of a remote record,
``ketos publish``) against the JAX package's on the CPU, offline, on the
fake ``htrmopo`` of ``tests/test_repo.py``:

- the port passes each of that file's 16 tests (the same assertions, the
  CLI with ``-d cpu``);
- the descriptions, the grouped listings with every version, the
  downloads, the ``publish``/``update`` cards and every recorded
  ``htrmopo`` call with its arguments equal the JAX package's, and so does
  the rendered text of ``show`` (v0 and v1), ``list`` (every flag) and
  ``get``, character for character;
- without ``htrmopo`` each client function raises ``KrakenRepoException``
  and each command exits 1 with the JAX package's message;
- ``iso15924_to_name``/``iso639_3_to_name`` equal the JAX functions over
  every code of their tables and unknown codes, with and without a fake
  ``htrmopo.util``.

One difference is by design: the port names a space grapheme ``SPACE``
where the JAX package prints a blank (``lib/util.py``, held by
``tests/test_torch_printable.py``). A v0 record with a space in its
alphabet is compared with the JAX renderer given that one rule.

The cases that compare with the JAX package skip where ``jax`` is absent,
as on the card's machine; the others need only the port.
"""
import tests.test_torch_threads  # noqa: F401  (first: the thread share under xdist)
import io
import json
import sys
import types
from pathlib import Path

import pytest
from click.testing import CliRunner

from tests.test_repo import LISTING, fake_htrmopo  # noqa: F401  (the shared fake and its fixture)

RESOURCES = Path(__file__).resolve().parent / 'resources'
MODEL = RESOURCES / 'overfit.mlmodel'
NO_HTRMOPO = ('Model repository access requires the `htrmopo` package which is not '
              'installed in this environment.')
# a fixed width, so that rich lays the tables out alike on any terminal
RUNNER_ENV = {'COLUMNS': '120'}

try:
    import jax  # noqa: F401
    HAVE_JAX = True
except ImportError:
    HAVE_JAX = False
needs_jax = pytest.mark.skipif(not HAVE_JAX, reason='compares with the JAX package, which needs jax')

V1_DESC = {
    'version': 'v1', 'summary': 'print transcription model',
    'doi': '10.5281/zenodo.42', 'concept_doi': '10.5281/zenodo.c42',
    'publication_date': '2024-06-01',
    'model_type': ['recognition'],
    'language': ['eng', 'fra', 'zzz-unknown'],
    'script': ['Latn', 'Grek', 'Qxyz'],
    'keywords': ['htr', 'print'],
    'datasets': ['https://example.org/ds'],
    'metrics': {'cer': 0.0413},
    'base_model': ['10.5281/zenodo.7'],
    'software_name': 'kraken',
    'software_hints': ['segmentation=blla'],
    'license': 'Apache-2.0',
    'creators': [{'name': 'A. Scholar', 'orcid': '0000-0001-2345-6789',
                  'affiliation': 'Université de Test'}],
    'description': 'A **markdown** description.',
}
V0_DESC = {
    'version': 'v0', 'summary': 'legacy model',
    'doi': 'x', 'concept_doi': 'y', 'publication_date': '2020-01-01',
    'model_type': ['recognition'],
    'script': ['Arab'],
    'graphemes': ['a', 'b', '́'],
    'keywords': ['kraken_pytorch'],
    'metrics': {},
    'license': 'MIT',
    'creators': [],
    'description': 'old',
}
# a v0 alphabet with a space, a control character and a combining mark
V0_SPACE_DESC = dict(V0_DESC, graphemes=['b', ' ', 'a', '́', '\t', '.'],
                     creators=['Some One', {'name': 'B. Scholar'}])


def port_kraken(args, **kwargs):
    from kraken_tpu_torch.kraken import cli
    return CliRunner().invoke(cli, ['-d', 'cpu', *map(str, args)], env=RUNNER_ENV, **kwargs)


def jax_kraken(args):
    from kraken_tpu.kraken import cli
    return CliRunner().invoke(cli, ['-d', 'cpu', *map(str, args)], env=RUNNER_ENV)


def port_ketos(args):
    from kraken_tpu_torch.ketos import cli
    return CliRunner().invoke(cli, list(map(str, args)))


def jax_ketos(args):
    from kraken_tpu.ketos import cli
    return CliRunner().invoke(cli, list(map(str, args)))


def outcome(result):
    """What a CLI run shows: its exit code, its output and the type of the
    exception it ended on, if any other than the exit."""
    exc = result.exception
    return (result.exit_code, result.output,
            None if exc is None or isinstance(exc, SystemExit) else type(exc))


def render(render_fn, desc, monkeypatch) -> str:
    """The text a remote-description renderer prints, at a fixed width."""
    import rich.console
    console = rich.console.Console(record=True, width=120, file=io.StringIO())
    with monkeypatch.context() as m:
        m.setattr(rich.console, 'Console', lambda *a, **k: console)
        render_fn(desc)
    return console.export_text()


@pytest.fixture
def no_htrmopo(monkeypatch):
    monkeypatch.setitem(sys.modules, 'htrmopo', None)
    monkeypatch.setitem(sys.modules, 'htrmopo.util', None)


# ------------------------------------------ tests/test_repo.py on the port
def test_get_description_kraken_record(fake_htrmopo):
    from kraken_tpu_torch import repo
    desc = repo.get_description('10.5281/zenodo.2')
    assert desc['summary'] == 'new version'
    assert desc['doi'] == '10.5281/zenodo.2'


def test_get_description_legacy_keyword_record(fake_htrmopo):
    from kraken_tpu_torch import repo
    desc = repo.get_description('10.5281/zenodo.3')
    assert desc['summary'] == 'legacy seg model'


def test_get_description_rejects_non_kraken(fake_htrmopo):
    from kraken_tpu_torch import repo
    from kraken_tpu_torch.exceptions import KrakenRepoException
    with pytest.raises(KrakenRepoException, match='not a kraken-compatible'):
        repo.get_description('10.5281/zenodo.4')


def test_get_description_version_passthrough(fake_htrmopo):
    from kraken_tpu_torch import repo
    repo.get_description('10.5281/zenodo.2', version='v0')
    assert ('get_description', '10.5281/zenodo.2', 'v0') in fake_htrmopo.calls


def test_listing_groups_by_concept_and_keeps_newest(fake_htrmopo):
    from kraken_tpu_torch import repo
    listing = repo.get_listing()
    assert listing['10.5281/zenodo.c1']['doi'] == '10.5281/zenodo.2'
    assert listing['10.5281/zenodo.c1']['summary'] == 'new version'
    assert '10.5281/zenodo.c3' in listing
    assert '10.5281/zenodo.c4' not in listing
    assert listing['10.5281/zenodo.c5']['summary'] == 'ro model'
    assert len(listing) == 3


def test_listing_model_type_filter(fake_htrmopo):
    from kraken_tpu_torch import repo
    assert set(repo.get_listing(model_type='segmentation')) == {'10.5281/zenodo.c3'}
    assert set(repo.get_listing(model_type='recognition')) == {'10.5281/zenodo.c1'}


def test_listing_script_language_keyword_filters(fake_htrmopo):
    from kraken_tpu_torch import repo
    assert set(repo.get_listing(script=['Arab'])) == {'10.5281/zenodo.c3'}
    assert set(repo.get_listing(language=['eng'])) == \
        {'10.5281/zenodo.c1', '10.5281/zenodo.c5'}
    assert set(repo.get_listing(keyword=['htr'])) == {'10.5281/zenodo.c3'}
    assert repo.get_listing(script=['Hani']) == {}


def test_get_model_download(fake_htrmopo):
    from kraken_tpu_torch import repo
    path = repo.get_model('10.5281/zenodo.2')
    assert ('get_model', '10.5281/zenodo.2') in fake_htrmopo.calls
    assert Path(path).is_dir()


def test_cli_show_success(fake_htrmopo):
    result = port_kraken(['show', '10.5281/zenodo.2'])
    assert result.exit_code == 0, result.output
    assert 'new version' in result.output
    assert 'Latin' in result.output
    assert 'English' in result.output


def test_show_renders_reference_table_v1(monkeypatch):
    from kraken_tpu_torch.kraken import _render_remote_description
    out = render(_render_remote_description, V1_DESC, monkeypatch)
    assert 'print transcription model' in out
    assert 'Latin' in out and 'Greek' in out
    assert 'Qxyz' in out            # unknown codes fall back to the code
    assert 'English' in out and 'French' in out
    assert 'cer: 0.04' in out
    assert 'A. Scholar (0000-0001-2345-6789) (Université de Test)' in out
    assert '10.5281/zenodo.7' in out


def test_show_renders_reference_table_v0(monkeypatch):
    from kraken_tpu_torch.kraken import _render_remote_description
    out = render(_render_remote_description, V0_DESC, monkeypatch)
    assert 'Arabic' in out
    assert 'a b' in out
    assert 'COMBINING ACUTE ACCENT' in out


def test_cli_list_success(fake_htrmopo):
    result = port_kraken(['list'])
    assert result.exit_code == 0, result.output
    for text in ('10.5281/zenodo.c1', '10.5281/zenodo.2', '10.5281/zenodo.1', 'new version',
                 'old version', 'legacy seg model'):
        assert text in result.output
    assert 'transkribus' not in result.output


def test_cli_list_filtered(fake_htrmopo):
    result = port_kraken(['list', '--segmentation'])
    assert result.exit_code == 0, result.output
    assert 'legacy seg model' in result.output
    assert 'new version' not in result.output


def test_cli_get_success(fake_htrmopo):
    result = port_kraken(['get', '10.5281/zenodo.2'])
    assert result.exit_code == 0, result.output
    assert 'Model dir:' in result.output


def test_ketos_publish_new_record(fake_htrmopo, tmp_path):
    card_path = tmp_path / 'card.json'
    card_path.write_text(json.dumps({'summary': 'test model', 'license': 'Apache-2.0'}))
    result = port_ketos(['publish', '-a', 'tok123', '-i', card_path, MODEL])
    assert result.exit_code == 0, result.output
    assert '10.5281/zenodo.999' in result.output
    _, model_path, card, token, private = next(c for c in fake_htrmopo.calls
                                               if c[0] == 'publish_model')
    assert model_path.endswith('overfit.mlmodel')
    assert token == 'tok123'
    assert private is False
    assert card['summary'] == 'test model'
    assert card['software_name'] == 'kraken'
    assert 'kraken_pytorch' in card['keywords']
    assert card['model_type'] == ['recognition']


def test_ketos_publish_doi_update(fake_htrmopo):
    result = port_ketos(['publish', '-a', 'tok456', '-d', '10.5281/zenodo.2', '--private',
                         MODEL])
    assert result.exit_code == 0, result.output
    assert '10.5281/zenodo.1000' in result.output
    _, _, card, token, model_id, private = next(c for c in fake_htrmopo.calls
                                                if c[0] == 'update_model')
    assert model_id == '10.5281/zenodo.2'
    assert private is True
    assert card['software_name'] == 'kraken'


# ------------------------------------------------- the port against JAX
@needs_jax
@pytest.mark.parametrize('version', [None, 'v0', 'v1'])
@pytest.mark.parametrize('model_id', [*LISTING, '10.5281/zenodo.0'])
def test_description_equals_jax(model_id, version, fake_htrmopo):
    """Every record, and one the repository lacks: the same description,
    or the same exception and message, and the same calls."""
    from kraken_tpu import repo as jax_repo
    from kraken_tpu_torch import repo

    def run(module):
        fake_htrmopo.calls.clear()
        try:
            got = module.get_description(model_id, version=version)
        except Exception as e:
            got = (type(e).__name__, str(e))
        return got, list(fake_htrmopo.calls)
    assert run(repo) == run(jax_repo)


LISTING_FILTERS = [
    {}, {'model_type': 'recognition'}, {'model_type': 'segmentation'},
    {'model_type': 'reading_order'}, {'script': ['Arab']}, {'script': ['Hani']},
    {'language': ['eng']}, {'language': ['eng', 'ara']}, {'keyword': ['htr']},
    {'keyword': ['kraken_pytorch'], 'script': ['Latn'], 'language': ['eng']},
]


@needs_jax
@pytest.mark.parametrize('filters', LISTING_FILTERS, ids=lambda f: ','.join(f) or 'all')
def test_listings_equal_jax(filters, fake_htrmopo):
    """The newest record of each concept and every version of it, newest
    first, and the calls."""
    from kraken_tpu import repo as jax_repo
    from kraken_tpu_torch import repo

    def run(module):
        fake_htrmopo.calls.clear()
        got = (module.get_listing(**filters), module.get_listing_versions(**filters))
        return got, list(fake_htrmopo.calls)
    assert run(repo) == run(jax_repo)


def test_every_version_of_a_concept_newest_first(fake_htrmopo):
    from kraken_tpu_torch import repo
    versions = repo.get_listing_versions()
    assert [v['doi'] for v in versions['10.5281/zenodo.c1']] == \
        ['10.5281/zenodo.2', '10.5281/zenodo.1']
    assert [v['summary'] for v in versions['10.5281/zenodo.c1']] == \
        ['new version', 'old version']


@needs_jax
def test_download_and_uploads_equal_jax(fake_htrmopo, tmp_path):
    """get_model, publish_model and update_model give the JAX package's
    results and hand htrmopo the same arguments."""
    from kraken_tpu import repo as jax_repo
    from kraken_tpu_torch import repo
    card = {'summary': 's', 'keywords': ['a']}

    def run(module):
        fake_htrmopo.calls.clear()
        got = (module.get_model('10.5281/zenodo.2', path=str(tmp_path)),
               module.publish_model(card, MODEL, 'tok', private=True),
               module.update_model('10.5281/zenodo.1', card, MODEL, 'tok'))
        return got, list(fake_htrmopo.calls)
    assert run(repo) == run(jax_repo)


@needs_jax
@pytest.mark.parametrize('args', [
    ['show', '10.5281/zenodo.2'],
    ['show', '-V', 'v0', '10.5281/zenodo.2'],
    ['show', '--metadata-version', 'v1', '10.5281/zenodo.1'],
    ['show', '10.5281/zenodo.3'],
    ['show', '10.5281/zenodo.4'],
    ['show', '10.5281/zenodo.5'],
    ['show', '10.5281/zenodo.0'],
    ['list'], ['list', '--all'], ['list', '--recognition'], ['list', '--segmentation'],
    ['list', '--reading-order'], ['list', '-l', 'eng'], ['list', '-l', 'eng', '-l', 'ara'],
    ['list', '-s', 'Arab'], ['list', '--script', 'Hani'], ['list', '-k', 'htr'],
    ['list', '--recognition', '--language', 'eng', '--keyword', 'kraken_pytorch'],
    ['get', '10.5281/zenodo.2'],
    ['get', '10.5281/zenodo.5'],
], ids=' '.join)
def test_cli_equals_jax(args, fake_htrmopo):
    """The rendered text, exit code and htrmopo calls of ``kraken show``,
    ``list`` and ``get``, character for character."""
    fake_htrmopo.calls.clear()
    ours = outcome(port_kraken(args))
    our_calls = list(fake_htrmopo.calls)
    fake_htrmopo.calls.clear()
    assert ours == outcome(jax_kraken(args))
    assert our_calls == fake_htrmopo.calls
    if args[-1] not in ('10.5281/zenodo.4', '10.5281/zenodo.0'):
        assert ours[0] == 0 and ours[1].strip()


@needs_jax
@pytest.mark.parametrize('desc', [V1_DESC, V0_DESC], ids=['v1', 'v0'])
def test_rendered_description_equals_jax(desc, monkeypatch):
    from kraken_tpu.kraken import _render_remote_description as jax_render
    from kraken_tpu_torch.kraken import _render_remote_description
    ours = render(_render_remote_description, desc, monkeypatch)
    assert ours == render(jax_render, desc, monkeypatch)


@needs_jax
def test_v0_alphabet_names_the_space(monkeypatch):
    """A v0 alphabet with a space: the port's table is the JAX renderer's
    given the upstream rule that a space is not printable and is named
    SPACE; the JAX package itself lists the space as a blank glyph."""
    import kraken_tpu.lib.util as jax_util
    from kraken_tpu.kraken import _render_remote_description as jax_render
    from kraken_tpu_torch.kraken import _render_remote_description
    ours = render(_render_remote_description, V0_SPACE_DESC, monkeypatch)
    as_jax = render(jax_render, V0_SPACE_DESC, monkeypatch)
    is_printable, make_printable = jax_util.is_printable, jax_util.make_printable
    monkeypatch.setattr(jax_util, 'is_printable', lambda c: c != ' ' and is_printable(c))
    monkeypatch.setattr(jax_util, 'make_printable',
                        lambda c: 'SPACE' if c == ' ' else make_printable(c))
    assert ours == render(jax_render, V0_SPACE_DESC, monkeypatch)
    assert ours != as_jax
    assert 'U+0009, SPACE, COMBINING ACUTE ACCENT' in ours
    assert '. a b' in ours and '  . a b' in as_jax


@needs_jax
def test_ketos_publish_equals_jax(fake_htrmopo, tmp_path):
    """A new record with a card and a ``--doi`` update: the same messages
    and the same upload calls, card included."""
    card_path = tmp_path / 'card.json'
    card_path.write_text(json.dumps({'summary': 'test model', 'license': 'Apache-2.0',
                                     'keywords': ['htr']}))
    runs = [['publish', '-a', 'tok123', '-i', card_path, MODEL],
            ['publish', '-a', 'tok456', '-d', '10.5281/zenodo.2', '--private', MODEL],
            ['publish', '-a', 'tok789', '--public', '-i', card_path, '-d', 'x', MODEL]]
    for args in runs:
        fake_htrmopo.calls.clear()
        ours = outcome(port_ketos(args))
        our_calls = list(fake_htrmopo.calls)
        fake_htrmopo.calls.clear()
        assert ours == outcome(jax_ketos(args))
        assert our_calls == fake_htrmopo.calls and len(our_calls) == 1
        assert ours[0] == 0


# ------------------------------------------------------- without htrmopo
CLIENT_CALLS = {
    'get_description': lambda repo: repo.get_description('10.5281/zenodo.2'),
    'get_listing': lambda repo: repo.get_listing(),
    'get_listing_versions': lambda repo: repo.get_listing_versions(),
    'get_model': lambda repo: repo.get_model('10.5281/zenodo.2'),
    'publish_model': lambda repo: repo.publish_model({}, MODEL, 'tok'),
    'update_model': lambda repo: repo.update_model('x', {}, MODEL, 'tok'),
}


@pytest.mark.parametrize('name', CLIENT_CALLS)
def test_client_without_htrmopo_raises(name, no_htrmopo):
    from kraken_tpu_torch import repo
    from kraken_tpu_torch.exceptions import KrakenRepoException
    with pytest.raises(KrakenRepoException) as info:
        CLIENT_CALLS[name](repo)
    assert str(info.value) == NO_HTRMOPO
    assert isinstance(info.value.__cause__, ImportError)


@needs_jax
@pytest.mark.parametrize('name', CLIENT_CALLS)
def test_client_without_htrmopo_raises_as_jax(name, no_htrmopo):
    from kraken_tpu import repo as jax_repo
    from kraken_tpu.exceptions import KrakenRepoException as JaxRepoException
    with pytest.raises(JaxRepoException) as info:
        CLIENT_CALLS[name](jax_repo)
    assert str(info.value) == NO_HTRMOPO


COMMANDS_WITHOUT_HTRMOPO = [
    ('kraken', ['list']), ('kraken', ['list', '--segmentation', '-l', 'eng']),
    ('kraken', ['get', '10.5281/zenodo.2']), ('kraken', ['show', '10.5281/zenodo.2']),
    ('kraken', ['show', '-V', 'v0', '10.5281/zenodo.2']),
    ('ketos', ['publish', '-a', 'tok', MODEL]),
    ('ketos', ['publish', '-a', 'tok', '-d', '10.5281/zenodo.2', MODEL]),
]


@pytest.mark.parametrize('tool, args', COMMANDS_WITHOUT_HTRMOPO,
                         ids=lambda v: ' '.join(map(str, v)) if isinstance(v, list) else v)
def test_commands_without_htrmopo_exit_1(tool, args, no_htrmopo):
    result = (port_kraken if tool == 'kraken' else port_ketos)(args)
    assert outcome(result) == (1, NO_HTRMOPO + '\n', None)


@needs_jax
@pytest.mark.parametrize('tool, args', COMMANDS_WITHOUT_HTRMOPO,
                         ids=lambda v: ' '.join(map(str, v)) if isinstance(v, list) else v)
def test_commands_without_htrmopo_equal_jax(tool, args, no_htrmopo):
    ours = (port_kraken if tool == 'kraken' else port_ketos)(args)
    theirs = (jax_kraken if tool == 'kraken' else jax_ketos)(args)
    assert outcome(ours) == outcome(theirs)


# ------------------------------------------------------------- iso_names
def fake_registry(monkeypatch):
    """A fake ``htrmopo.util`` that names some codes its own way and fails
    on others, which the callers then take from their tables."""
    util = types.ModuleType('htrmopo.util')

    def lookup(kind):
        def name(code):
            if code.startswith(('Q', 'q', 'L')):
                raise KeyError(code)
            return f'{kind} registry name of {code}'
        return name
    util.iso15924_to_name = lookup('script')
    util.iso639_3_to_name = lookup('language')
    pkg = types.ModuleType('htrmopo')
    pkg.util = util
    monkeypatch.setitem(sys.modules, 'htrmopo', pkg)
    monkeypatch.setitem(sys.modules, 'htrmopo.util', util)


UNKNOWN_CODES = ['', None, 'Qxyz', 'qaa', 'zzz-unknown', 'xx', 'LATN', 'Zzzz']


def test_iso_names_fall_back_to_the_code(no_htrmopo):
    from kraken_tpu_torch.lib.iso_names import iso639_3_to_name, iso15924_to_name
    assert iso15924_to_name('Latn') == 'Latin' and iso639_3_to_name('eng') == 'English'
    assert iso15924_to_name('Qxyz') == 'Qxyz' and iso639_3_to_name('qaa') == 'qaa'
    assert iso15924_to_name(None) == '' == iso639_3_to_name('')


def test_iso_names_prefer_the_registry(monkeypatch):
    fake_registry(monkeypatch)
    from kraken_tpu_torch.lib.iso_names import iso639_3_to_name, iso15924_to_name
    assert iso15924_to_name('Arab') == 'script registry name of Arab'
    assert iso639_3_to_name('eng') == 'language registry name of eng'
    assert iso15924_to_name('Latn') == 'Latin'      # the registry failed: the table
    assert iso15924_to_name('Qxyz') == 'Qxyz'       # and then the code


@needs_jax
@pytest.mark.parametrize('registry', [False, True], ids=['table', 'fake-registry'])
def test_iso_names_equal_jax(registry, monkeypatch):
    if registry:
        fake_registry(monkeypatch)
    else:
        monkeypatch.setitem(sys.modules, 'htrmopo', None)
    from kraken_tpu.lib import iso_names as jax_names
    from kraken_tpu_torch.lib import iso_names
    assert iso_names._ISO15924 == jax_names._ISO15924
    assert iso_names._ISO639_3 == jax_names._ISO639_3
    for fn in ('iso15924_to_name', 'iso639_3_to_name'):
        for code in [*jax_names._ISO15924, *jax_names._ISO639_3, *UNKNOWN_CODES]:
            assert getattr(iso_names, fn)(code) == getattr(jax_names, fn)(code), (fn, code)
