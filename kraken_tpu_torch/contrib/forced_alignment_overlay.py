#!/usr/bin/env python
"""
Draws forced-alignment character cuts over page images
(reference: kraken/contrib/forced_alignment_overlay.py), the counterpart of
the JAX package's contrib script. Runs on the card unless ``--device cpu``:

    python -m kraken_tpu_torch.contrib.forced_alignment_overlay -m model page.xml
"""
import click


@click.command()
@click.option('-m', '--model', type=click.Path(exists=True), required=True)
@click.option('-f', '--format-type', type=click.Choice(['xml', 'alto', 'page']),
              default='xml')
@click.option('--suffix', default='.align.png')
@click.option('-d', '--device', default='cuda', show_default=True,
              help="Torch device to run on ('cuda', 'cuda:N' or 'cpu').")
@click.argument('files', nargs=-1, type=click.Path(exists=True))
def cli(model, format_type, suffix, device, files):
    from PIL import Image, ImageDraw
    from kraken_tpu_torch.configs import RecognitionInferenceConfig
    from kraken_tpu_torch.inference.recognition import resolve_device
    from kraken_tpu_torch.tasks import ForcedAlignmentTaskModel
    from kraken_tpu_torch.xml import XMLPage

    try:
        resolve_device(device)
    except RuntimeError as e:
        raise click.UsageError(str(e))
    task = ForcedAlignmentTaskModel.load_model(model)
    for fname in files:
        doc = XMLPage(fname, filetype=format_type)
        seg = doc.to_container()
        im = Image.open(doc.imagename).convert('RGB')
        aligned = task.predict(im, seg, RecognitionInferenceConfig(device=device))
        draw = ImageDraw.Draw(im, 'RGBA')
        for record in aligned.lines:
            for cut in record.cuts:
                draw.polygon([tuple(p) for p in cut], outline=(255, 0, 0, 255))
        out = fname + suffix
        im.save(out)
        click.echo(f'Wrote {out}')


if __name__ == '__main__':
    cli()
