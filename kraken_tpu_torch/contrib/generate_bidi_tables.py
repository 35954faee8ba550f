#!/usr/bin/env python
"""
Regenerates the UCD bidi pair tables checked in as the port's own
``kraken_tpu_torch/lib/_bidi_tables.json``: the Bidi_Mirroring_Glyph map
(UAX #9 rule L4) and the Bidi_Paired_Bracket map (BD14-BD16).

Reference parity: the reference ships these as generated Python
(kraken/lib/bidi/_data.py, built by an HTTP fetch of the UCD). This tool
works offline: the host ``unicodedata`` module exposes the Bidi_Mirrored
*binary* property but not the mirroring-glyph *mapping*, so the map is
rebuilt from two sources:

1. name transposition — swapping directional terms (LEFT/RIGHT,
   LESS-THAN/GREATER-THAN, PRECEDES/SUCCEEDS, ...) in the character name
   and looking the transposed name back up recovers ~63% of the pairs
   (270 of 428 in UCD 17.0);
2. a supplement of the remaining pairs whose names do not transpose
   (e.g. U+0F3A GUG RTAGS GYON / U+0F3B GYAS — "left/right" in Tibetan,
   ELEMENT OF / CONTAINS AS MEMBER, asymmetric best-fit glyphs like
   DIVISION SLASH / REVERSE SOLIDUS OPERATOR). These are Unicode
   Character Database property facts (BidiMirroring.txt /
   BidiBrackets.txt, UCD 17.0.0); pass ``--mirroring-txt`` /
   ``--brackets-txt`` pointing at downloaded copies to re-derive them
   from first principles on a UCD update.

The counterpart of the JAX package's contrib script; runs no model:

    python -m kraken_tpu_torch.contrib.generate_bidi_tables
"""
import json
import pathlib
import re
import sys

import click

OUT = pathlib.Path(__file__).parent.parent / 'lib' / '_bidi_tables.json'

_PAIR_RE = re.compile(
    r'^(?P<a>[0-9A-F]{4,6})\s*;\s*(?P<b>[0-9A-F]{4,6})\s*[;#]\s*(?P<rest>.*)')


def _parse_mirroring_txt(fp):
    pairs = {}
    for line in fp:
        m = _PAIR_RE.match(line.strip())
        if m:
            pairs[int(m.group('a'), 16)] = int(m.group('b'), 16)
    return pairs


def _parse_brackets_txt(fp):
    out = []
    for line in fp:
        m = _PAIR_RE.match(line.strip())
        if m:
            typ = m.group('rest').strip().split()[0]
            out.append((int(m.group('a'), 16), int(m.group('b'), 16),
                        'o' if typ == 'o' else 'c'))
    return out


@click.command()
@click.option('--mirroring-txt', type=click.File('r'), default=None,
              help='UCD BidiMirroring.txt to parse instead of the '
                   'checked-in supplement')
@click.option('--brackets-txt', type=click.File('r'), default=None,
              help='UCD BidiBrackets.txt to parse instead of the '
                   'checked-in bracket list')
@click.option('--ucd-version', default=None,
              help='UCD version string recorded in the output')
def main(mirroring_txt, brackets_txt, ucd_version):
    from kraken_tpu_torch.lib.bidi import _derive_name_mirrors
    prev = json.loads(OUT.read_text()) if OUT.exists() else {
        'mirror_supplement': [], 'brackets': [], 'ucd_version': 'unknown'}
    derived = _derive_name_mirrors()
    if mirroring_txt is not None:
        full = _parse_mirroring_txt(mirroring_txt)
        supplement = sorted((k, v) for k, v in full.items()
                            if derived.get(k) != v)
    else:
        supplement = [tuple(p) for p in prev['mirror_supplement']]
    if brackets_txt is not None:
        brackets = sorted(_parse_brackets_txt(brackets_txt))
    else:
        brackets = [tuple(b) for b in prev['brackets']]
    out = {'ucd_version': ucd_version or prev['ucd_version'],
           'mirror_supplement': sorted(supplement),
           'brackets': sorted(brackets)}
    OUT.write_text(json.dumps(out, indent=0, sort_keys=True))
    click.echo(f'{OUT}: {len(derived)} name-derived mirrors + '
               f'{len(supplement)} supplement pairs, '
               f'{len(brackets)} brackets (UCD {out["ucd_version"]})')


cli = main

if __name__ == '__main__':
    sys.path.insert(0, str(pathlib.Path(__file__).parents[2]))
    main()
