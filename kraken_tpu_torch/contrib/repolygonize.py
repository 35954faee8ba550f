#!/usr/bin/env python
"""
Recomputes the bounding polygons of all lines in ALTO/PageXML files with
the port's polygonizer (reference: kraken/contrib/repolygonize.py), the
counterpart of the JAX package's contrib script. Runs no model:

    python -m kraken_tpu_torch.contrib.repolygonize -f xml page.xml

writes ``page.repoly.xml`` beside each input (ALTO, or PageXML for
``-f page``).
"""
import click


@click.command()
@click.option('-f', '--format-type', type=click.Choice(['xml', 'alto', 'page']), default='xml')
@click.option('--topline/--baseline', default=False)
@click.option('--suffix', default='.repoly.xml')
@click.argument('files', nargs=-1, type=click.Path(exists=True))
def cli(format_type, topline, suffix, files):
    import dataclasses
    import os
    from kraken_tpu_torch import serialization
    from kraken_tpu_torch.lib.polygonization import calculate_polygonal_environment
    from kraken_tpu_torch.lib.util import open_image
    from kraken_tpu_torch.xml import XMLPage

    for fname in files:
        doc = XMLPage(fname, filetype=format_type)
        seg = doc.to_container()
        im = open_image(doc.imagename).convert('L')
        baselines = [line.baseline for line in seg.lines]
        polygons = calculate_polygonal_environment(im, baselines, topline=topline)
        new_lines = [dataclasses.replace(line, boundary=pol)
                     for line, pol in zip(seg.lines, polygons) if pol is not None]
        new_seg = dataclasses.replace(seg, lines=new_lines)
        out = os.path.splitext(str(fname))[0] + suffix
        with open(out, 'w', encoding='utf-8') as fp:
            fp.write(serialization.serialize(new_seg, image_size=im.size,
                                             template='alto' if format_type != 'page' else 'page'))
        click.echo(f'Wrote {out}')


if __name__ == '__main__':
    cli()
