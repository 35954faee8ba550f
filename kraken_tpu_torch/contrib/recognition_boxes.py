#!/usr/bin/env python
"""
Draws per-character recognition boxes over a page image
(reference: kraken/contrib/recognition_boxes.py), the counterpart of the
JAX package's contrib script: the legacy box segmenter, then recognition.
Runs on the card unless ``--device cpu``:

    python -m kraken_tpu_torch.contrib.recognition_boxes -m model.mlmodel page.png
"""
import click


@click.command()
@click.option('-m', '--model', type=click.Path(exists=True), required=True)
@click.option('--suffix', default='.boxes.png')
@click.option('-d', '--device', default='cuda', show_default=True,
              help="Torch device to run on ('cuda', 'cuda:N' or 'cpu').")
@click.argument('files', nargs=-1, type=click.Path(exists=True))
def cli(model, suffix, device, files):
    from PIL import Image, ImageDraw
    from kraken_tpu_torch.configs import RecognitionInferenceConfig
    from kraken_tpu_torch.inference.recognition import resolve_device
    from kraken_tpu_torch.pageseg import segment
    from kraken_tpu_torch.tasks import RecognitionTaskModel

    try:
        resolve_device(device)
    except RuntimeError as e:
        raise click.UsageError(str(e))
    task = RecognitionTaskModel.load_model(model)
    for fname in files:
        im = Image.open(fname)
        seg = segment(im.convert('L'))
        records = task.predict(im, seg, RecognitionInferenceConfig(device=device))
        canvas = im.convert('RGB')
        draw = ImageDraw.Draw(canvas, 'RGBA')
        for record in records:
            for cut, conf in zip(record.cuts, record.confidences):
                color = (int(255 * (1 - conf)), int(255 * conf), 0, 160)
                draw.polygon([tuple(p) for p in cut], outline=color)
        out = fname + suffix
        canvas.save(out)
        click.echo(f'Wrote {out}')


if __name__ == '__main__':
    cli()
