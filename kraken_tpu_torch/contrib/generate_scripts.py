#!/usr/bin/env python
"""
Regenerates merged Unicode script ranges as JSON, for per-script error
attribution in test reports (reference: kraken/contrib/generate_scripts.py),
the counterpart of the JAX package's contrib script:

    python -m kraken_tpu_torch.contrib.generate_scripts -o scripts.json

The reference fetches Scripts.txt over HTTP; this derives the UCD Script
property offline from the `regex` module's bundled Unicode tables; pass
--scripts-txt to parse a downloaded Scripts.txt instead. The checked-in
table ``kraken_tpu_torch/dataset/_scripts_ranges.json`` is the output of
running this tool with no options.
"""
import json
import re
import sys

import click

_RANGE_RE = re.compile(
    r'^(?P<start>[0-9A-F]{4,6})(\.\.(?P<end>[0-9A-F]{4,6}))?\s*;\s*(?P<name>\w+)')


def _merge(entries):
    """Coalesces adjacent (start, end, name) runs sharing a script name."""
    merged = []
    for start, end, name in entries:
        if merged and merged[-1][2] == name and start <= (merged[-1][1] or merged[-1][0]) + 1:
            merged[-1] = (merged[-1][0], end if end != start else merged[-1][1] or start, name)
        else:
            merged.append((start, end if end != start else None, name))
    return merged


def _from_scripts_txt(fp):
    entries = []
    for line in fp:
        m = _RANGE_RE.match(line)
        if m:
            start = int(m.group('start'), 16)
            end = int(m.group('end'), 16) if m.group('end') else start
            entries.append((start, end, m.group('name')))
    entries.sort()
    return entries


def _script_display_name(alias: str) -> str:
    """Maps a regex-module script alias (e.g. ``CANADIANABORIGINAL``) to a
    display name matching UCD long-name conventions where they differ only
    in case/joining (``Arabic``, ``Latin``, ``Common``...)."""
    return _MULTIWORD_ALIASES.get(alias, alias.title())


# regex-module aliases are long UCD names with separators stripped; restore
# word breaks for the multi-word scripts so display names stay readable.
_MULTIWORD_ALIASES = {
    'ANATOLIANHIEROGLYPHS': 'Anatolian Hieroglyphs',
    'BASSAVAH': 'Bassa Vah',
    'CANADIANABORIGINAL': 'Canadian Aboriginal',
    'CAUCASIANALBANIAN': 'Caucasian Albanian',
    'EGYPTIANHIEROGLYPHS': 'Egyptian Hieroglyphs',
    'GUNJALAGONDI': 'Gunjala Gondi',
    'HANIFIROHINGYA': 'Hanifi Rohingya',
    'IMPERIALARAMAIC': 'Imperial Aramaic',
    'INSCRIPTIONALPAHLAVI': 'Inscriptional Pahlavi',
    'INSCRIPTIONALPARTHIAN': 'Inscriptional Parthian',
    'KAYAHLI': 'Kayah Li',
    'KIRATRAI': 'Kirat Rai',
    'LINEARA': 'Linear A',
    'LINEARB': 'Linear B',
    'MASARAMGONDI': 'Masaram Gondi',
    'MEETEIMAYEK': 'Meetei Mayek',
    'MENDEKIKAKUI': 'Mende Kikakui',
    'NAGMUNDARI': 'Nag Mundari',
    'NEWTAILUE': 'New Tai Lue',
    'NYIAKENGPUACHUEHMONG': 'Nyiakeng Puachue Hmong',
    'OLCHIKI': 'Ol Chiki',
    'OLONAL': 'Ol Onal',
    'OLDHUNGARIAN': 'Old Hungarian',
    'OLDITALIC': 'Old Italic',
    'OLDNORTHARABIAN': 'Old North Arabian',
    'OLDPERMIC': 'Old Permic',
    'OLDPERSIAN': 'Old Persian',
    'OLDSOGDIAN': 'Old Sogdian',
    'OLDSOUTHARABIAN': 'Old South Arabian',
    'OLDTURKIC': 'Old Turkic',
    'OLDUYGHUR': 'Old Uyghur',
    'PAHAWHHMONG': 'Pahawh Hmong',
    'PAUCINHAU': 'Pau Cin Hau',
    'PHAGSPA': 'Phags-pa',
    'PSALTERPAHLAVI': 'Psalter Pahlavi',
    'SORASOMPENG': 'Sora Sompeng',
    'SYLOTINAGRI': 'Syloti Nagri',
    'TAILE': 'Tai Le',
    'TAITHAM': 'Tai Tham',
    'TAIVIET': 'Tai Viet',
    'TAIYO': 'Tai Yo',
    'TANGSA': 'Tangsa',
    'TULUTIGALARI': 'Tulu-Tigalari',
    'WARANGCITI': 'Warang Citi',
    'ZANABAZARSQUARE': 'Zanabazar Square',
}


def _from_regex_module():
    """
    Derives the exact UCD Script property from the `regex` module's bundled
    Unicode tables: walk the code space once, testing each code point against
    the compiled ``\\p{Script=...}`` class of the current run (switching runs
    triggers one sweep over all script values).
    """
    import regex
    import regex._regex as _regex

    values = _regex.get_properties()['SCRIPT']
    # the value table alternates long alias / four-letter code; keep longs
    aliases = [v for v in values[1]] if isinstance(values, tuple) and len(values) > 1 else list(values)
    # robust extraction: test-compile every candidate, drop 4-letter codes
    # that alias a long name we already kept
    pats = {}
    for alias in aliases:
        if not isinstance(alias, str):
            continue
        try:
            pats[alias] = regex.compile(rf'\p{{Script={alias}}}')
        except regex.error:
            continue
    # drop short codes duplicating a long alias (identical char classes)
    entries = []
    run_start = None
    run_script = None
    current_pat = None
    for cp in range(sys.maxunicode + 1):
        ch = chr(cp)
        if current_pat is not None and current_pat.match(ch):
            continue
        script = None
        for alias, pat in pats.items():
            if pat.match(ch):
                script = alias
                break
        if run_script is not None:
            entries.append((run_start, cp - 1, _script_display_name(run_script)))
        run_start, run_script, current_pat = cp, script, pats.get(script)
    if run_script is not None:
        entries.append((run_start, sys.maxunicode, _script_display_name(run_script)))
    # unassigned planes stay out of the table; lookup misses default to Unknown
    return [(s, e, n) for s, e, n in entries if n and n != 'Unknown']


@click.command()
@click.option('--scripts-txt', type=click.File('r'), default=None,
              help='Parse an already-downloaded UCD Scripts.txt instead of '
                   'the regex module Unicode tables.')
@click.option('-o', '--output', type=click.File('w'), default='scripts.json')
def cli(scripts_txt, output):
    entries = _from_scripts_txt(scripts_txt) if scripts_txt else _from_regex_module()
    json.dump(_merge(entries), output)
    click.echo(f'{len(entries)} ranges written', err=True)


if __name__ == '__main__':
    cli()
