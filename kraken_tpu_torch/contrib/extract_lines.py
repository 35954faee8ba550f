#!/usr/bin/env python
"""
Extracts (dewarped) line images and their transcriptions from ALTO/PageXML
files or binary (Arrow) datasets (reference:
kraken/contrib/extract_lines.py), the counterpart of the JAX package's
contrib script. Runs no model:

    python -m kraken_tpu_torch.contrib.extract_lines -f xml -o lines/ page.xml
    python -m kraken_tpu_torch.contrib.extract_lines -f binary -o lines/ dataset.arrow

Each line becomes ``<n>.png`` and ``<n>.gt.txt`` in the output directory.
XML input needs ``lxml``; binary input reads every row of each file, as
written, through :class:`~kraken_tpu_torch.dataset.recognition.ArrowIPCRecognitionDataset`
(needs ``pyarrow``).
"""
import click


@click.command()
@click.option('-f', '--format-type', type=click.Choice(['xml', 'alto', 'page', 'binary']),
              default='xml')
@click.option('-o', '--output', type=click.Path(), default='.')
@click.option('--legacy-polygons', is_flag=True, default=False)
@click.argument('files', nargs=-1, type=click.Path(exists=True))
def cli(format_type, output, legacy_polygons, files):
    import io
    import pathlib
    from PIL import Image

    out_dir = pathlib.Path(output)
    out_dir.mkdir(parents=True, exist_ok=True)
    idx = 0
    if format_type == 'binary':
        from kraken_tpu_torch.dataset.recognition import ArrowIPCRecognitionDataset
        # every row as written: no text transform, no empty line skipped
        ds = ArrowIPCRecognitionDataset(whitespace_normalization=False, reorder=False,
                                        skip_empty_lines=False)
        for fname in files:
            ds.add(fname)
        for sample in ds.arrow_table.column('lines').to_pylist():
            Image.open(io.BytesIO(sample['im'])).save(out_dir / f'{idx}.png')
            (out_dir / f'{idx}.gt.txt').write_text(sample['text'], encoding='utf-8')
            idx += 1
    else:
        from kraken_tpu_torch.lib.geometry import extract_polygons
        from kraken_tpu_torch.lib.util import open_image
        from kraken_tpu_torch.xml import XMLPage
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
