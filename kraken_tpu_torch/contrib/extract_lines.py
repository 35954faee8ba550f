#!/usr/bin/env python
"""
Extracts (dewarped) line images and their transcriptions from ALTO/PageXML
files (reference: kraken/contrib/extract_lines.py), the counterpart of the
JAX package's contrib script. Runs no model:

    python -m kraken_tpu_torch.contrib.extract_lines -f xml -o lines/ page.xml

Each line becomes ``<n>.png`` and ``<n>.gt.txt`` in the output directory.
The port has no binary (Arrow) dataset reader yet, so ``-f binary`` is not
offered.
"""
import click


@click.command()
@click.option('-f', '--format-type', type=click.Choice(['xml', 'alto', 'page']), default='xml')
@click.option('-o', '--output', type=click.Path(), default='.')
@click.option('--legacy-polygons', is_flag=True, default=False)
@click.argument('files', nargs=-1, type=click.Path(exists=True))
def cli(format_type, output, legacy_polygons, files):
    import pathlib
    from kraken_tpu_torch.lib.geometry import extract_polygons
    from kraken_tpu_torch.lib.util import open_image
    from kraken_tpu_torch.xml import XMLPage

    out_dir = pathlib.Path(output)
    out_dir.mkdir(parents=True, exist_ok=True)
    idx = 0
    for fname in files:
        doc = XMLPage(fname, filetype=format_type)
        seg = doc.to_container()
        im = open_image(doc.imagename)
        for line_im, line in extract_polygons(im, seg, legacy=legacy_polygons):
            line_im.save(out_dir / f'{idx}.png')
            (out_dir / f'{idx}.gt.txt').write_text(line.text or '', encoding='utf-8')
            idx += 1
    click.echo(f'Extracted {idx} lines to {out_dir}')


if __name__ == '__main__':
    cli()
