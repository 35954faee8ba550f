"""
kraken_tpu_torch.inference.segmentation
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

BLLA neural page segmentation inference, the counterpart of the JAX
package's ``inference/segmentation.py``:

  host: resize the page to the network height (byte-exact native Lanczos)
        → tensor → width-padded page batch
  device: U-Net forward (the padding-aware GroupNorm in its CUDA kernel)
        → bilinear upsample + sigmoid (the head kernel) → Sato ridge filter
        and threshold of the baseline channels (the ridge kernel)
  host: baseline/region vectorization → seam-carve polygonization → region
        association → reading order

The configuration picks what crosses the link, as in the JAX package:
the page goes up as floats or, with ``input_transfer='uint8'``, as bytes
divided by 255 on the device; ``heatmap_precision`` brings back the
float32 heatmaps and the uint8 ridge masks ('float32'), the heatmaps
quantized to bytes by ``ops/segmask.quantize_u8`` and the ridge masks
('uint8'), or only the masks the host reads, bit-packed by
``ops/segmask.pack_masks`` after the 20×20 max filter of the separator maps
(``ops/segmask.maxpool20``) ('packbits'); 'auto' picks one of the last two
from a one-off upload probe. ``device_vectorize`` carves every seam of a
page in one launch of ``ops/seam.py``'s kernel. With ``fused_ridge=False``
the forward runs no ridge and sends back the heatmaps ('packbits' takes
'uint8'); vectorization filters the baseline maps on the host
(``lib/vectorization.sato_ridge``) or, with ``device_vectorize``, in the
ridge kernel's response mode (``ops/ridge.sato_ridge_device``, one launch
a baseline class a page), and thresholds them at 0.17 as the JAX package
does. ``devices=N`` shards the page batch over N devices in one process:
the batch is padded to a multiple of N with blank pages and each
contiguous shard runs the forward on its own device with its replica of
the network, each shard by the one-device route (a shard of blank pages
alone is not forwarded).
"""
import logging
import threading
import uuid
from functools import partial
from typing import TYPE_CHECKING, Any, Optional

import numpy as np
import torch

from kraken_tpu_torch.containers import BaselineLine, Region, Segmentation
from kraken_tpu_torch.dataset import ImageInputTransforms
from kraken_tpu_torch.lib import telemetry
from kraken_tpu_torch.lib.geometry import (line_midpoint, points_in_polygon,
                                           scale_polygonal_lines, scale_regions)
from kraken_tpu_torch.lib.polygonization import gradient_feature_map, polygonize_page
from kraken_tpu_torch.lib.util import is_bitonal
from kraken_tpu_torch.lib.vectorization import vectorize_lines, vectorize_regions
from kraken_tpu_torch.ops.ridge import sato_ridge_device, sato_ridge_threshold, upload_bank
from kraken_tpu_torch.ops.seghead import seg_head
from kraken_tpu_torch.ops.segmask import maxpool20, pack_masks, probe_link_mbps, quantize_u8

if TYPE_CHECKING:
    from PIL import Image
    from kraken_tpu_torch.vgsl import VGSLModel

logger = logging.getLogger(__name__)

__all__ = ['prepare_segmentation', 'segmentation_pred',
           'segmentation_pred_batch', 'vec_regions', 'vec_lines']


# the pipeline's prefetch threads prepare the model for every page: one
# thread at a time moves the network (two first calls that both copied it
# to the card while one of them ran its forward left some biases wrong on
# the card), and the link probe of heatmap_precision='auto' runs once for
# a model's route key
_PREPARE_LOCK = threading.Lock()


def prepare_segmentation(model: 'VGSLModel', config) -> None:
    """
    Configures a segmentation model for inference: resolves the device
    (raising when a CUDA device is asked for and there is none), casts the
    parameters to the precision's type and moves them there (and, with
    ``devices > 1``, keeps a replica on each shard's device), picks the
    baseline channels the ridge filter runs on in the forward (none with
    ``fused_ridge=False``) and, on a CUDA device, uploads the ridge kernel's
    bank (once per device: the task model prepares its models for every
    page, from several threads in the page pipeline, one at a time). Then
    the transfer route, as the JAX package picks it: 'auto'
    probes the upload rate once for each (device, input_transfer,
    heatmap_precision, fused_ridge, devices) and takes 'packbits' below
    500 Mbit/s, else 'uint8'; 'packbits' falls back to 'uint8' where the
    forward filters no baseline channel or the class mapping lacks a
    separator.
    """
    from kraken_tpu_torch.inference.recognition import _PRECISION_DTYPES, resolve_device
    from kraken_tpu_torch.parallel.mesh import inference_devices, replicas
    device = resolve_device(config.device)
    dtype = _PRECISION_DTYPES.get(config.precision, torch.float32)
    shards = inference_devices(config.devices, device)
    cls_map = model.user_metadata.get('class_mapping') or {}
    fused = bool(config.fused_ridge)
    key = (str(device), config.input_transfer, config.heatmap_precision, fused, len(shards))
    with _PREPARE_LOCK:
        model.net.to(device=device, dtype=dtype)
        model.net.eval()
        model._inf_config = config
        model._device = device
        model._m_dtype = dtype
        model._seg_shards = shards if len(shards) > 1 else None
        model._seg_replicas = replicas(model.net, shards) if len(shards) > 1 else None
        model._seg_fused_channels = tuple(sorted(cls_map.get('baselines', {}).values())) \
            if fused else ()
        model._seg_ridge_threshold = float(config.ridge_threshold)
        if model._seg_fused_channels:
            for dev in set(shards):
                if dev.type == 'cuda':
                    upload_bank(dev)
        model._seg_dequant = config.input_transfer == 'uint8'
        if getattr(model, '_seg_route_key', None) != key:
            hm_prec = config.heatmap_precision
            if hm_prec == 'auto':
                # a slow link: every byte counts, so the packed masks; local
                # PCIe: the quantized heatmaps
                hm_prec = 'packbits' if probe_link_mbps(device) < 500 else 'uint8'
            aux = cls_map.get('aux', {})
            if hm_prec == 'packbits' and (not model._seg_fused_channels
                                          or '_start_separator' not in aux
                                          or '_end_separator' not in aux):
                hm_prec = 'uint8'  # the packed masks need the ridge and both separators
            model._seg_transfer = hm_prec
            model._seg_route_key = key
        model._seg_packed_regions = tuple(sorted(cls_map.get('regions', {}).values()))
        if model._seg_transfer == 'packbits':
            model._seg_separators = (cls_map['aux']['_start_separator'],
                                     cls_map['aux']['_end_separator'])


def _seg_forward(model: 'VGSLModel', x: torch.Tensor, out_h: int, out_w: int,
                 seq_lens: Optional[torch.Tensor] = None, net=None):
    """
    The device half, on the device of `x` with `net` (the model's network
    by default, or a shard's replica): (a byte page divided by 255) →
    network → upsample + sigmoid → ridge + threshold of the baseline
    channels (the ridge reads the full-precision sigmoid; none with
    ``fused_ridge=False``), then what the route sends back. Returns
    (float32 heatmaps or, for 'uint8', their bytes; uint8 ridge masks or
    None), or for 'packbits' (the packed masks, None).
    """
    from kraken_tpu_torch.inference.recognition import _precise_fp32
    from kraken_tpu_torch.ops.extract import dequantize
    with torch.inference_mode(), _precise_fp32(model._m_dtype):
        if model._seg_dequant:
            x = dequantize(x, model._m_dtype)
        logits, _ = (net or model.net)(x, seq_lens)
        probs = seg_head(logits.contiguous(), out_h, out_w)
        bins = None
        if model._seg_fused_channels:
            bins = sato_ridge_threshold(probs, model._seg_fused_channels,
                                        model._seg_ridge_threshold)
        if model._seg_transfer == 'packbits':
            # the host reads the two max-filtered separator maps only
            # through the signs of their difference against ±0.2: send the
            # two decision masks, computed from the full-precision sigmoid
            n, _, h, w = probs.shape
            seps = probs[:, list(model._seg_separators)].reshape(n * 2, h, w)
            filt = maxpool20(seps).reshape(n, 2, h, w)
            return pack_masks(probs, model._seg_packed_regions, filt, bins), None
        if model._seg_transfer == 'uint8':
            probs = quantize_u8(probs)
    return probs, bins


def vec_regions(heatmap: np.ndarray, cls_map: dict, scale, **kwargs) -> dict[str, list[Region]]:
    """Vectorizes all region classes of the heatmap stack into Regions."""
    regions = {}
    for region_type, idx in cls_map['regions'].items():
        logger.debug(f'Extracting region polygons for class {region_type}')
        polygons = vectorize_regions(heatmap[idx])
        regions[region_type] = [Region(id=f'_{uuid.uuid4()}', boundary=x,
                                       tags={'type': [{'type': region_type}]})
                                for x in scale_regions(polygons, scale)]
    return regions


def vec_lines(heatmap: np.ndarray,
              cls_map: dict[str, dict[str, int]],
              scale,
              bin_maps: dict[int, np.ndarray],
              text_direction: str = 'horizontal-lr',
              regions: list = None,
              scal_im: np.ndarray = None,
              suppl_obj: list = None,
              topline: bool = False,
              raise_on_error: bool = False,
              device_vectorize: bool = False,
              sep_filters: Optional[tuple] = None,
              device='cuda',
              **kwargs) -> list[dict[str, Any]]:
    """
    Vectorizes and polygonizes all baseline classes of the heatmap stack.

    Args:
        bin_maps: thresholded ridge maps per baseline channel, from the
            ridge kernel of the forward; a channel without one (every
            channel with ``fused_ridge=False``) is filtered here and
            thresholded at ``vectorize_lines``' 0.17.
        device_vectorize: carve the page's seams in one launch of the seam
            kernel on `device` (``ops/seam.py``; ``'cpu'`` runs its plain
            version) instead of the host DP: the same polygons; and filter
            the channels without a ridge map in the ridge kernel's response
            mode on `device` (``ops/ridge.sato_ridge_device``) instead of
            the host filter.
        sep_filters: the (start, end) separator maps after the 20x20 max
            filter, or the 0/1 masks of their difference's signs that the
            'packbits' route sends (both give the same orientation
            decisions); computed on the host from the heatmaps otherwise.

    Returns:
        list of dicts with tags/baseline/boundary per line.
    """
    ridge_fn = partial(sato_ridge_device, device=device) if device_vectorize else None
    st_sep = cls_map['aux']['_start_separator']
    end_sep = cls_map['aux']['_end_separator']
    if sep_filters is None:
        from kraken_tpu_torch.lib.fastfilters import maximum_filter
        sep_filters = (maximum_filter(heatmap[st_sep], size=20),
                       maximum_filter(heatmap[end_sep], size=20))
    baselines = []
    for bl_type, idx in cls_map['baselines'].items():
        logger.debug(f'Extracting baselines for class {bl_type}')
        # no threshold passed: the un-fused route thresholds at 0.17
        # whatever ridge_threshold says, as the JAX package does
        baselines.extend((bl_type, bl) for bl in
                         vectorize_lines(heatmap[(st_sep, end_sep, idx), :, :],
                                         text_direction=text_direction[:-3],
                                         ridge_fn=ridge_fn,
                                         sep_filters=sep_filters,
                                         bin_map=bin_maps.get(idx)))
    im_feats = gradient_feature_map(scal_im)
    regions = regions or []
    # batched midpoint-in-region tests: one vectorized crossing test per
    # region over all baselines instead of lines x regions separate calls
    mids = np.array([line_midpoint(bl) for _, bl in baselines]) \
        if baselines else np.zeros((0, 2))
    in_reg = np.stack([points_in_polygon(mids, reg) for reg in regions]) \
        if regions and len(baselines) else np.zeros((0, len(baselines)), bool)
    jobs = []
    for idx, (bl_type, bl) in enumerate(baselines):
        other = [b for _, b in baselines[:idx] + baselines[idx + 1:]]
        other.extend(reg for reg_i, reg in enumerate(regions) if in_reg[reg_i, idx])
        jobs.append((bl, other))
    pols = polygonize_page(jobs, im_feats, topline=topline, raise_on_error=raise_on_error,
                           seam_carver='device' if device_vectorize else 'host', device=device)
    lines = [(bl_type, bl, pol)
             for (bl_type, bl), pol in zip(baselines, pols) if pol is not None]
    scaled = scale_polygonal_lines([x[1:] for x in lines], scale)
    return [{'tags': {'type': [{'type': bl_type}]}, 'baseline': bl, 'boundary': pl}
            for (bl_type, _, _), (bl, pl) in zip(lines, scaled)]


def _page_resize(img: 'Image.Image', scale: tuple[int, int]) -> 'Image.Image':
    """
    Resizes a full page to the network input size ((height, width), a 0 dim
    inferred proportionally) with the same Lanczos filter the training
    transform uses: trained segmentation nets are sensitive to the
    resampling spectrum of their inputs. The byte-exact native Lanczos is
    used where the native library loaded; PIL's ``reducing_gap=3.0``
    approximation only where it did not.
    """
    from PIL import Image as PILImage
    w, h = img.size
    oh, ow = scale
    if oh == 0:
        oh = max(1, int(h * ow / w))
    elif ow == 0:
        ow = max(1, int(w * oh / h))
    if img.mode in ('L', 'RGB'):
        from kraken_tpu_torch import native
        out = native.resize_lanczos_native(np.asarray(img), oh, ow)
        if out is not None:
            return PILImage.fromarray(out, img.mode)
    return img.resize((ow, oh), PILImage.Resampling.LANCZOS, reducing_gap=3.0)


def _compute_segmentation_maps(model: 'VGSLModel', ims: list) -> list[dict[str, Any]]:
    """
    Runs the network over one or more pages and returns per-page upsampled
    sigmoid heatmaps, ridge masks and metadata. Several pages go through
    ONE forward: page tensors (same network height) are width-padded to a
    common bucket and stacked on the batch dim, with their valid widths
    reaching the padding-aware GroupNorm layers as sequence lengths.
    """
    from kraken_tpu_torch.inference.recognition import width_bucket
    config = model._inf_config
    batch, channels, height, width = model.input
    padding = config.input_padding
    if isinstance(padding, int):
        padding = (padding,) * 4
    elif len(padding) == 2:
        padding = (padding[0], padding[0], padding[1], padding[1])

    transfer_u8 = config.input_transfer == 'uint8'
    transforms = ImageInputTransforms(batch, height, width, channels, padding, valid_norm=False,
                                      dtype=np.uint8 if transfer_u8 else np.float32)
    pages = []
    for im in ims:
        # scaled grayscale image (pre-tensor stage of the transform pipeline)
        scal = im.convert(transforms.mode if transforms.mode != '1' else 'L')
        if transforms.scale != (0, 0):
            scal = _page_resize(scal, transforms.scale)
        scal_im = np.array(scal.convert('L'))
        # `scal` already is the mode-converted + resized page, so only the
        # pad/tensor tail of the transform pipeline remains
        tensor_im = transforms.tail(scal)
        pages.append({'im': im, 'scal_im': scal_im, 'tensor': tensor_im,
                      'padded_h': scal_im.shape[0] + padding[2] + padding[3],
                      'padded_w': scal_im.shape[1] + padding[0] + padding[1]})

    heights = {p['tensor'].shape[1] for p in pages}
    if len(heights) > 1:
        # variable-height spec: no common batch shape — run per page
        return [r for p in pages
                for r in _compute_segmentation_maps(model, [p['im']])]

    max_w = max(p['tensor'].shape[2] for p in pages)
    if config.width_bucketing or len(pages) > 1:
        max_w = width_bucket(max_w)
    shards = model._seg_shards
    # the shards split the batch evenly: blank pages pad it
    n_rows = -(-len(pages) // len(shards)) * len(shards) if shards else len(pages)
    stack = np.zeros((n_rows, pages[0]['tensor'].shape[0],
                      pages[0]['tensor'].shape[1], max_w),
                     np.uint8 if transfer_u8 else np.float32)
    for i, p in enumerate(pages):
        stack[i, :, :, :p['tensor'].shape[2]] = p['tensor']
    max_padded_h = max(p['padded_h'] for p in pages)
    widths = [p['tensor'].shape[2] for p in pages] + [max_w] * (n_rows - len(pages))
    lens = np.asarray(widths, np.int32) if any(w != max_w for w in widths) else None

    def forward(rows: slice, device, net=None):
        x = torch.from_numpy(stack[rows]).to(device=device)
        if not transfer_u8:
            x = x.to(model._m_dtype)
        telemetry.record_up(x.nbytes)
        seq_lens = None if lens is None else torch.from_numpy(lens[rows]).to(device)
        return _seg_forward(model, x, max_padded_h, max_w, seq_lens, net)

    if shards:
        # shards of blank pages alone are never read: not forwarded
        from kraken_tpu_torch.parallel.mesh import shard_rows
        outs = [forward(rows, dev, model._seg_replicas[dev])
                for dev, rows in zip(shards, shard_rows(n_rows, len(shards)))
                if rows.start < len(pages)]
        heat_all = torch.cat([out[0].cpu() for out in outs])
        ridges_all = None if outs[0][1] is None else torch.cat([out[1].cpu() for out in outs])
    else:
        heat_all, ridges_all = forward(slice(None), model._device)
    cls_map = model.user_metadata['class_mapping']
    bounding_regions = model.user_metadata.get('bounding_regions', None)

    def crop(m: np.ndarray, p: dict) -> np.ndarray:
        """A page's maps out of the bucket, without the input padding."""
        m = m[:, :p['padded_h'], :p['padded_w']]
        return m[:, padding[2]:m.shape[1] - padding[3] or None,
                 padding[0]:m.shape[2] - padding[1] or None]

    if model._seg_transfer == 'packbits':
        packed_all = heat_all.cpu().numpy()  # (n, K, h, ceil(w / 8)) uint8
        telemetry.record_down(packed_all.nbytes)
        n_classes = 1 + max(c for grp in cls_map.values() for c in grp.values())
        n_reg = len(model._seg_packed_regions)
        results = []
        for i, p in enumerate(pages):
            m = crop(np.unpackbits(packed_all[i], axis=-1), p)
            # a boolean stand-in for the heatmap stack: the region channels
            # carry their masks (vec_regions' > 0.5 keeps them as they are);
            # the baseline and separator channels are read through bin_maps
            # and sep_filters instead and stay empty
            heat = np.zeros((n_classes,) + m.shape[1:], bool)
            for j, c in enumerate(model._seg_packed_regions):
                heat[c] = m[j]
            sep_filters = (m[n_reg].astype(np.float32), m[n_reg + 1].astype(np.float32))
            bin_maps = {c: m[n_reg + 2 + j].astype(bool)
                        for j, c in enumerate(model._seg_fused_channels)}
            results.append({'heatmap': heat,
                            'cls_map': cls_map,
                            'bounding_regions': bounding_regions,
                            'scale': np.divide(p['im'].size, heat.shape[:0:-1]),
                            'scal_im': p['scal_im'],
                            'bin_maps': bin_maps,
                            'sep_filters': sep_filters})
        return results

    heat_all = heat_all.cpu().numpy()
    ridges_all = ridges_all.cpu().numpy() if ridges_all is not None else None
    telemetry.record_down(heat_all.nbytes + (ridges_all.nbytes if ridges_all is not None else 0))

    results = []
    for i, p in enumerate(pages):
        bin_maps = {}
        if ridges_all is not None:
            ridges = crop(ridges_all[i], p)
            bin_maps = {c: ridges[j].astype(bool)
                        for j, c in enumerate(model._seg_fused_channels)}
        heat = heat_all[i][:, :p['padded_h'], :p['padded_w']]
        if heat.dtype == np.uint8:
            heat = heat.astype(np.float32) / 255.0
        heat = crop(heat, p)
        scale = np.divide(p['im'].size, heat.shape[:0:-1])
        results.append({'heatmap': heat,
                        'cls_map': cls_map,
                        'bounding_regions': bounding_regions,
                        'scale': scale,
                        'scal_im': p['scal_im'],
                        'bin_maps': bin_maps})
    return results


def segmentation_pred_batch(model: 'VGSLModel', ims: list) -> list[Segmentation]:
    """
    Segments several pages with ONE forward (width-bucketed page batch;
    `_compute_segmentation_maps`), then vectorizes each page on the host.
    Heatmaps can differ from single-page prediction at the last bilinear
    half-pixel (the shared width bucket changes the upsample grid).
    """
    retss = _compute_segmentation_maps(model, ims)
    return [_vectorize_page(model, im, rets) for im, rets in zip(ims, retss)]


def segmentation_pred(model: 'VGSLModel', im: 'Image.Image') -> Segmentation:
    """
    Runs full-page baseline segmentation: heatmaps → regions → lines →
    region association → reading order.
    """
    if model.input[1] == 1 and model.one_channel_mode == '1' and not is_bitonal(im):
        logger.warning(f'Binary-input model applied to a non-bitonal image (mode {im.mode}); '
                       'expect severely degraded segmentation quality')
    rets = _compute_segmentation_maps(model, [im])[0]
    return _vectorize_page(model, im, rets)


def _vectorize_page(model: 'VGSLModel', im: 'Image.Image', rets: dict) -> Segmentation:
    """Host half of page segmentation: regions → lines → association → RO."""
    config = model._inf_config
    regions = vec_regions(**rets)

    line_regs = []
    suppl_obj = []
    for cls, regs in regions.items():
        line_regs.extend(regs)
        if rets['bounding_regions'] is not None and cls in rets['bounding_regions']:
            suppl_obj.extend(regs)
    # back to network scale for polygonization
    suppl_obj = scale_regions([x.boundary for x in suppl_obj], tuple(1 / rets['scale']))
    line_regs = scale_regions([x.boundary for x in line_regs], tuple(1 / rets['scale']))

    lines = vec_lines(**rets,
                      regions=line_regs,
                      text_direction=config.text_direction,
                      suppl_obj=suppl_obj,
                      topline=bool(model.user_metadata.get('topline', False)),
                      raise_on_error=config.raise_on_error,
                      device_vectorize=config.device_vectorize,
                      device=model._device)

    script_detection = len(rets['cls_map']['baselines']) > 1

    blls = []
    flat_regions = [reg for regs in regions.values() for reg in regs]
    line_mids = np.array([line_midpoint(line['baseline']) for line in lines]) \
        if lines else np.zeros((0, 2))
    reg_hits = np.stack([points_in_polygon(line_mids, reg.boundary)
                         for reg in flat_regions]) \
        if flat_regions and lines else np.zeros((0, len(lines)), bool)
    for line_i, line in enumerate(lines):
        containing = [reg.id for reg_i, reg in enumerate(flat_regions)
                      if reg_hits[reg_i, line_i]]
        blls.append(BaselineLine(id=f'_{uuid.uuid4()}',
                                 baseline=line['baseline'],
                                 boundary=line['boundary'],
                                 tags=line['tags'],
                                 regions=containing))
    if blls:
        ro = config.baseline_ro_fn(lines=blls, regions=flat_regions,
                                   text_direction=config.text_direction[-2:])
        blls = [blls[idx] for idx in ro]

    return Segmentation(text_direction=config.text_direction,
                        imagename=getattr(im, 'filename', None),
                        type='baselines',
                        lines=blls,
                        regions=regions,
                        script_detection=script_detection,
                        line_orders=[])
