"""Image functions (reference: ``daft_tpu/functions/image.py``, after
``src/daft-image/src/{image_buffer.rs:109-174,series.rs:72-156}``).

Decode, encode and ``to_mode`` ride on Pillow where it imports (host);
without it they raise, as in the reference. ``resize`` sends a batch of
at least :data:`_RESIZE_BATCH_MIN` images of one shape and dtype to the
device as one torch program (:func:`_resize_program`, the port of the
reference's ``_get_resize_jit``: two contractions with weight matrices,
as ``jax.image.resize`` computes it) when the cost model
(``costmodel.image_resize_wins``) prices it cheaper than per-image Pillow;
a smaller or ragged batch, or a declined one, runs per image on the host.
Each of those declines is logged with the cost model's decisions
(``image_resize`` kind); a batch the device resized counts in the device
tier's ``image_resize`` counter. ``crop`` slices the arrays.
"""

from __future__ import annotations

import io
from typing import List

import numpy as np

from ..datatype import DataType, ImageFormat, ImageMode
from ..schema import Field
from ..series import Series

try:
    from PIL import Image as _PILImage
    _HAS_PIL = True
except ImportError:
    _HAS_PIL = False


_MODE_TO_PIL = {"L": "L", "LA": "LA", "RGB": "RGB", "RGBA": "RGBA"}


def _decode_one(buf, mode):
    img = _PILImage.open(io.BytesIO(buf))
    if mode is not None:
        img = img.convert(_MODE_TO_PIL[mode.name])
    return np.asarray(img)


_RESIZE_BATCH_MIN = 8  # below this, per-image PIL beats a device round-trip


def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """The ``[out, in]`` f32 weights of a bilinear resize along one axis,
    antialiased when it shrinks: ``jax.image.resize``'s
    ``compute_weight_mat`` with the triangle kernel (half-pixel centres,
    the kernel widened by the shrink factor, each output's weights
    normalized to sum to 1), computed in f64 as the reference computes them
    (64-bit mode on) and cast to f32."""
    inv = in_size / out_size
    kernel_scale = max(inv, 1.0)
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) * inv - 0.5
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float64)[:, None]) \
        / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0).T.astype(np.float32)


def _resize_program(x, h: int, w: int, lo, hi, out_dtype):
    """``[N, H, W, C]`` images (any dtype) → ``[N, h, w, C]`` of
    ``out_dtype``: the reference's program (``jax.image.resize(...,
    "bilinear")``: one weight matrix per resized axis, contracted with the
    f32 images in f32), clipped to the integer dtype's range and cast back
    on the device, so the download is the output dtype's bytes and not
    f32's. An axis whose size does not change is left as it is."""
    import torch
    _, H, W, _ = x.shape
    y = x.to(torch.float32)
    if h != H:
        wh = torch.from_numpy(_resize_weights(H, h)).to(x.device)
        y = torch.einsum("oh,nhwc->nowc", wh, y)
    if w != W:
        ww = torch.from_numpy(_resize_weights(W, w)).to(x.device)
        y = torch.einsum("ow,nhwc->nhoc", ww, y)
    if lo is not None:
        y = y.clamp_(lo, hi)
    return y.to(out_dtype)


def _device_batch_resize(imgs, w: int, h: int):
    """A uniform-shape image batch → one resize program on the device (one
    upload, one download) instead of N PIL calls. None when the batch is
    ragged or small, the device tier is off, or the cost model declines:
    the per-image host path runs."""
    import torch
    from ..device import backend, costmodel, runtime
    device = backend.resolve_device()
    if device is None:
        return None
    real = [im for im in imgs if im is not None]
    if len(real) < _RESIZE_BATCH_MIN:
        costmodel.log_decline("image_resize", "batch_min", images=len(real))
        return None
    arrs = [np.asarray(im) for im in real]
    shape = arrs[0].shape
    dtype = arrs[0].dtype
    if any(a.shape != shape or a.dtype != dtype for a in arrs) \
            or len(shape) not in (2, 3):
        costmodel.log_decline("image_resize", "ragged", images=len(real))
        return None
    stack = np.stack(arrs)
    if len(shape) == 2:
        stack = stack[..., None]
    ch = stack.shape[-1]
    if not costmodel.image_resize_wins(
            stack.nbytes, len(real) * h * w * ch * stack.dtype.itemsize):
        return None
    if dtype.kind in "ui":
        info = np.iinfo(dtype)
        lo, hi = float(info.min), float(info.max)
    else:
        lo = hi = None  # float images: no clamp, as PIL and numpy
    from ..analysis import retrace_sanitizer
    # declared signature (dispatch_registry: image.resize): the batch
    # shape and the resize spec
    with retrace_sanitizer.dispatch_scope(
            "image.resize", (stack.shape, str(dtype), h, w, lo, hi)):
        x = torch.from_numpy(stack).to(device)
        out = _resize_program(x, h, w, lo, hi, x.dtype)
        res = out.cpu().numpy()
    runtime.count("image_resize")
    if len(shape) == 2:
        res = res[..., 0]
    it = iter(res)
    return [None if im is None else next(it) for im in imgs]


def eval_image_fn(fn: str, e, kids: List[Series], out_field: Field) -> Series:
    s = kids[0]
    name = s.name()
    if fn == "decode":
        if not _HAS_PIL:
            raise RuntimeError("image.decode requires Pillow")
        on_error, mode = e.params
        m = ImageMode.from_mode_string(mode) if isinstance(mode, str) else mode
        out = []
        for buf in s.to_pylist():
            if buf is None:
                out.append(None)
                continue
            try:
                out.append(_decode_one(buf, m))
            except Exception:  # any undecodable payload: on_error decides
                if on_error == "raise":
                    raise
                out.append(None)
        return Series.from_pyobjects(out, name)
    if fn == "encode":
        if not _HAS_PIL:
            raise RuntimeError("image.encode requires Pillow")
        image_format = e.params[0]
        f = ImageFormat.from_format_string(image_format) \
            if isinstance(image_format, str) else image_format
        out = []
        for img in s.to_pylist():
            if img is None:
                out.append(None)
                continue
            arr = np.asarray(img)
            bio = io.BytesIO()
            _PILImage.fromarray(arr).save(bio, format=f.value)
            out.append(bio.getvalue())
        return Series.from_pylist(out, name, dtype=DataType.binary())
    if fn == "resize":
        w, h = e.params
        imgs = s.to_pylist()
        batched = _device_batch_resize(imgs, w, h)
        if batched is not None:
            return Series.from_pyobjects(batched, name)
        out = []
        for img in imgs:
            if img is None:
                out.append(None)
                continue
            arr = np.asarray(img)
            if _HAS_PIL:
                out.append(np.asarray(_PILImage.fromarray(arr).resize((w, h))))
            else:
                ys = (np.linspace(0, arr.shape[0] - 1, h)).astype(int)
                xs = (np.linspace(0, arr.shape[1] - 1, w)).astype(int)
                out.append(arr[ys][:, xs])
        return Series.from_pyobjects(out, name)
    if fn == "crop":
        bbox = kids[1].to_pylist()
        if len(bbox) == 1:
            bbox = bbox * len(s)
        out = []
        for img, bb in zip(s.to_pylist(), bbox):
            if img is None or bb is None:
                out.append(None)
                continue
            x, y, w, h = bb
            out.append(np.asarray(img)[y:y + h, x:x + w])
        return Series.from_pyobjects(out, name)
    if fn == "to_mode":
        mode = ImageMode.from_mode_string(e.params[0])
        if not _HAS_PIL:
            raise RuntimeError("image.to_mode requires Pillow")
        out = []
        for img in s.to_pylist():
            if img is None:
                out.append(None)
                continue
            out.append(np.asarray(
                _PILImage.fromarray(np.asarray(img)).convert(_MODE_TO_PIL[mode.name])))
        return Series.from_pyobjects(out, name)
    raise NotImplementedError(f"image.{fn}")
