#!/usr/bin/env python
"""
Draws a segmentation (regions, line boundaries and baselines) over page
images (reference: kraken/contrib/segmentation_overlay.py), the
counterpart of the JAX package's contrib script. From ALTO/PageXML it runs
no model; from an image it runs the segmentation model (the packaged one
unless ``-i``), on the card unless ``--device cpu``:

    python -m kraken_tpu_torch.contrib.segmentation_overlay page.jpg
    python -m kraken_tpu_torch.contrib.segmentation_overlay -f xml page.xml
"""
import click


@click.command()
@click.option('-i', '--model', type=click.Path(exists=True), default=None,
              help='Segmentation model; heuristic/XML input when omitted.')
@click.option('-f', '--format-type', type=click.Choice(['xml', 'alto', 'page', 'image']),
              default='image')
@click.option('--suffix', default='.overlay.png')
@click.option('-d', '--device', default='cuda', show_default=True,
              help="Torch device the model runs on ('cuda', 'cuda:N' or 'cpu').")
@click.argument('files', nargs=-1, type=click.Path(exists=True))
def cli(model, format_type, suffix, device, files):
    from PIL import Image, ImageDraw
    from kraken_tpu_torch.configs import SegmentationInferenceConfig
    from kraken_tpu_torch.inference.recognition import resolve_device

    task = None
    if format_type == 'image':
        try:
            resolve_device(device)
        except RuntimeError as e:
            raise click.UsageError(str(e))
        from kraken_tpu_torch.tasks import SegmentationTaskModel
        task = SegmentationTaskModel.load_model(model)
    for fname in files:
        if task is None:
            from kraken_tpu_torch.xml import XMLPage
            doc = XMLPage(fname, filetype=format_type)
            seg = doc.to_container()
            im = Image.open(doc.imagename).convert('RGB')
        else:
            im = Image.open(fname).convert('RGB')
            seg = task.predict(im, SegmentationInferenceConfig(device=device))
        draw = ImageDraw.Draw(im, 'RGBA')
        for regs in (seg.regions or {}).values():
            for reg in regs:
                draw.polygon([tuple(p) for p in reg.boundary], outline=(0, 0, 255, 255), width=2)
        for line in seg.lines:
            if getattr(line, 'boundary', None):
                draw.polygon([tuple(p) for p in line.boundary],
                             fill=(0, 255, 0, 64), outline=(0, 128, 0, 255))
            if getattr(line, 'baseline', None):
                draw.line([tuple(p) for p in line.baseline], fill=(255, 0, 0, 255), width=3)
        out = fname + suffix
        im.save(out)
        click.echo(f'Wrote {out}')


if __name__ == '__main__':
    cli()
