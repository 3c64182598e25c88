"""PDF/image primitives for the serving pipeline.

Mirrors the reference surface (karanta/data/process_pdf_utils.py):
  - get_pdf_media_box_width_height: pdfinfo when present, else our own reader
    (reference :6-47 shells out to pdfinfo unconditionally).
  - render_pdf_to_base64png: pdftoppm at a dpi chosen so the longest box side
    hits target_longest_image_dim, 120 s timeout (reference :50-75). Poppler
    is optional here; without it, PDF rasterization raises a clear error
    (image inputs never need it).
  - get_png_dimensions_from_base64 / get_image_dimensions: direct header
    peeks for PNG IHDR and JPEG SOFn (reference :78-134).
"""

from __future__ import annotations

import base64
import io
import math
import shutil
import struct
import subprocess
from functools import lru_cache
from typing import Optional

import numpy as np

from karanta_tpu_torch.pdf.minipdf import PdfDocument

RENDER_TIMEOUT_S = 120


class PopplerMissingError(RuntimeError):
    pass


@lru_cache(maxsize=1)
def has_poppler() -> bool:
    return shutil.which("pdftoppm") is not None


@lru_cache(maxsize=1)
def has_pdfinfo() -> bool:
    return shutil.which("pdfinfo") is not None


def get_pdf_media_box_width_height(local_pdf_path: str,
                                   page_num: int) -> tuple[float, float]:
    """Media box (width, height) in points for 1-based page_num."""
    if has_pdfinfo():
        cmd = ["pdfinfo", "-f", str(page_num), "-l", str(page_num),
               "-box", local_pdf_path]
        out = subprocess.run(cmd, capture_output=True, timeout=60)
        if out.returncode == 0:
            for line in out.stdout.decode("utf-8", "ignore").splitlines():
                if "MediaBox" in line:
                    parts = line.split(":", 1)[1].split()
                    x0, y0, x1, y1 = (float(v) for v in parts[:4])
                    return abs(x1 - x0), abs(y1 - y0)
    doc = PdfDocument.open(local_pdf_path)
    x0, y0, x1, y1 = doc.media_box(page_num - 1)
    return abs(x1 - x0), abs(y1 - y0)


def render_pdf_to_base64png(local_pdf_path: str, page_num: int,
                            target_longest_image_dim: int = 2048) -> str:
    """Rasterize one page to base64 PNG at the target longest dimension.

    Uses pdftoppm when available (full fidelity). Without poppler, falls back
    to the native renderer, which handles the dominant scanned-document case
    (a page that is one embedded raster image — extracted and resized
    directly, no rasterizer needed) and draws positioned text for born-digital
    pages (approximate, flagged in logs).
    """
    if has_poppler():
        width, height = get_pdf_media_box_width_height(local_pdf_path, page_num)
        longest = max(width, height) or 1.0
        dpi = int(target_longest_image_dim * 72 / longest)
        cmd = ["pdftoppm", "-png", "-f", str(page_num), "-l", str(page_num),
               "-r", str(dpi), local_pdf_path]
        out = subprocess.run(cmd, capture_output=True, timeout=RENDER_TIMEOUT_S)
        if out.returncode != 0 or not out.stdout:
            raise RuntimeError(
                f"pdftoppm failed for {local_pdf_path} p{page_num}: "
                f"{out.stderr.decode('utf-8', 'ignore')[:500]}")
        return base64.b64encode(out.stdout).decode("utf-8")
    return _render_native(local_pdf_path, page_num, target_longest_image_dim)


def _render_native(local_pdf_path: str, page_num: int,
                   target_longest_image_dim: int) -> str:
    """Poppler-free rendering: embedded-image extraction or text drawing.

    A blank page, and an image-only page whose image is Flate RGB or gray,
    CCITT or JBIG2, render without PIL: the image is decoded to numpy,
    reduced by ``thumbnail`` (PIL's rule, reproduced here) and encoded by
    ``ops/png.py``. The JPEG passthrough needs no decode. A DCT or JPX image
    and visible text go through PIL, as in the JAX package.
    """
    from karanta_tpu_torch.ops.png import encode_png_rgb
    from karanta_tpu_torch.pdf.minipdf import Name, PdfDocument
    from karanta_tpu_torch.pdf.textextract import extract_page_report

    doc = PdfDocument.open(local_pdf_path)
    page = doc.pages[page_num - 1]
    x0, y0, x1, y1 = doc.media_box(page_num - 1)
    page_w, page_h = abs(x1 - x0) or 612.0, abs(y1 - y0) or 792.0
    scale = target_longest_image_dim / max(page_w, page_h)
    out_w, out_h = max(1, round(page_w * scale)), max(1, round(page_h * scale))

    report = extract_page_report(doc, page_num - 1)

    # Invisible text (Tr 3) is an OCR layer under a scan — never drawn;
    # visible text on top of a dominant image must still be drawn
    # (poppler paints both; the old image-only shortcut dropped it).
    visible_texts = [el for el in report.text_elements if el.render_mode != 3]

    # scanned-page path: one embedded image covering most of the page and
    # no VISIBLE text — extracted and resized directly, no rasterizer.
    resources = doc.resolve(page.get(Name("Resources"))) or {}
    xobjects = doc.resolve(resources.get(Name("XObject"))) or {}
    dominant = None
    if len(report.image_elements) == 1:
        im_el = report.image_elements[0]
        coverage = ((im_el.x1 - im_el.x0) * (im_el.y1 - im_el.y0)) / (page_w * page_h)
        if coverage > 0.5:
            if not visible_texts:
                # scanned-page fast path: the embedded JPEG already is the
                # page at (about) the requested resolution — ship its bytes
                # untouched instead of decode -> resize -> PNG-encode
                # (downstream consumers sniff JPEG vs PNG from the bytes)
                raw_jpeg = _dominant_jpeg_passthrough(
                    doc, xobjects, target_longest_image_dim)
                if raw_jpeg is not None:
                    return base64.b64encode(raw_jpeg).decode("utf-8")
            dominant = _decode_embedded_image(doc, xobjects)
    if dominant is not None and not visible_texts:
        if isinstance(dominant, np.ndarray):
            px = thumbnail(dominant, target_longest_image_dim)
            if px.ndim == 2:
                px = np.repeat(px[..., None], 3, axis=-1)
            png = encode_png_rgb(px)
        else:  # a PIL image (DCT/JPX): PIL's own thumbnail, draft included
            Image = _pil_image("resizing a DCT or JPX page image")
            dominant.thumbnail(
                (target_longest_image_dim, target_longest_image_dim),
                Image.Resampling.BICUBIC)
            # scanned page may not fill the media box exactly; good enough
            buf = io.BytesIO()
            dominant.convert("RGB").save(buf, format="PNG")
            png = buf.getvalue()
        return base64.b64encode(png).decode("utf-8")
    if dominant is None and not visible_texts:
        # nothing to draw: a white page (the preflight probe's case)
        white = np.full((out_h, out_w, 3), 255, np.uint8)
        return base64.b64encode(encode_png_rgb(white)).decode("utf-8")

    # born-digital fallback: paste the dominant image (if any) into its
    # bbox, then draw positioned visible text (approximate glyphs)
    Image = _pil_image("drawing a page's visible text")
    from PIL import ImageDraw

    img = Image.new("RGB", (out_w, out_h), (255, 255, 255))
    if dominant is not None:
        if isinstance(dominant, np.ndarray):
            dominant = Image.fromarray(dominant)
        im_el = report.image_elements[0]
        bx = max(0, round((im_el.x0 - x0) * scale))
        by = max(0, round(out_h - (im_el.y1 - y0) * scale))
        bw = max(1, round((im_el.x1 - im_el.x0) * scale))
        bh = max(1, round((im_el.y1 - im_el.y0) * scale))
        img.paste(dominant.convert("RGB").resize(
            (bw, bh), Image.Resampling.BICUBIC), (bx, by))
    draw = ImageDraw.Draw(img)
    for el in visible_texts:
        px = (el.x - x0) * scale
        py = out_h - (el.y - y0) * scale
        draw.text((px, py - 10), el.text, fill=(0, 0, 0))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("utf-8")


def _pil_image(purpose: str):
    """PIL.Image, or an ImportError that names Pillow: the port renders
    without it only what ``_render_native`` lists."""
    try:
        from PIL import Image
    except ImportError as exc:
        raise ImportError(
            f"{purpose} needs Pillow (PIL), which is not installed") from exc
    return Image


# ----------------------------------------------------------------------
# PIL's thumbnail(size, BICUBIC, reducing_gap=2.0) on uint8 numpy arrays:
# the same output size, the same integer reduce() first where the scale
# allows it, then the same separable bicubic pass in 22-bit fixed point
# (Pillow's Reduce.c and Resample.c), so pages match PIL's pixel for pixel.
# ----------------------------------------------------------------------

_PRECISION_BITS = 32 - 8 - 2


def thumbnail_size(width: int, height: int,
                   target: int) -> Optional[tuple[int, int]]:
    """(w, h) that ``thumbnail((target, target))`` gives, or None when the
    image already fits."""
    x = y = int(math.floor(target))
    if x >= width and y >= height:
        return None

    def round_aspect(number, key):
        return max(min(math.floor(number), math.ceil(number), key=key), 1)

    aspect = width / height
    if x / y >= aspect:
        x = round_aspect(y * aspect, key=lambda n: abs(aspect - n / y))
    else:
        y = round_aspect(
            x / aspect, key=lambda n: 0 if n == 0 else abs(aspect - x / n))
    return x, y


def thumbnail(px: np.ndarray, target: int) -> np.ndarray:
    """(H, W) or (H, W, C) uint8 -> the pixels of PIL's
    ``thumbnail((target, target), BICUBIC)`` of the same image."""
    h, w = px.shape[:2]
    size = thumbnail_size(w, h, target)
    if size is None or size == (w, h):
        return px
    fw, fh = size
    box = (0.0, 0.0, float(w), float(h))
    fx = int(w / fw / 2.0) or 1
    fy = int(h / fh / 2.0) or 1
    if fx > 1 or fy > 1:
        px = _reduce(px, fx, fy)
        box = (0.0, 0.0, w / fx, h / fy)
    return _resample(px, fw, fh, box)


def _reduce(px: np.ndarray, fx: int, fy: int) -> np.ndarray:
    """PIL's ``reduce((fx, fy))``: each block's rounded mean, partial
    blocks at the right and bottom edges averaged over their own pixels."""
    h, w = px.shape[:2]
    oh, ow = -(-h // fy), -(-w // fx)
    padded = np.zeros((oh * fy, ow * fx) + px.shape[2:], np.int64)
    padded[:h, :w] = px
    sums = padded.reshape((oh, fy, ow, fx) + px.shape[2:]).sum(axis=(1, 3))
    rows = np.full(oh, fy, np.int64)
    cols = np.full(ow, fx, np.int64)
    rows[-1] = h - (oh - 1) * fy
    cols[-1] = w - (ow - 1) * fx
    n = rows[:, None] * cols[None, :]
    # multiplier = (uint32)(2^32 / (256 n)), a float32 quotient (Reduce.c)
    mult = (np.float32(2.0 ** 32) / (256 * n).astype(np.float32)).astype(
        np.int64)
    if px.ndim == 3:
        n, mult = n[..., None], mult[..., None]
    return (((sums + n // 2) * mult) >> 24).astype(np.uint8)


def _bicubic(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    near = ((-0.5 + 2.0) * x - (-0.5 + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * -0.5
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _coeffs(in_size: int, in0: float, in1: float, out_size: int):
    """Resample.c precompute_coeffs + normalize_coeffs_8bpc: per output
    index its input indices and its fixed-point weights, (out, ksize)
    each (taps past the image's edge weigh 0)."""
    in0, in1 = np.float32(in0), np.float32(in1)  # the C box is float
    scale = float(in1 - in0) / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = float(in0) + (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    taps = np.arange(ksize)
    w = _bicubic(((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5)
                 * (1.0 / filterscale))
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for j in range(ksize):  # in tap order, as the C loop sums
        ww = ww + w[:, j]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None],
                 w)
    scaled = w * (1 << _PRECISION_BITS)
    fixed = np.where(w < 0, (-0.5 + scaled), (0.5 + scaled)).astype(np.int32)
    return np.minimum(xmin[:, None] + taps[None, :], in_size - 1), fixed


def _resample_axis(px: np.ndarray, axis: int, out_size: int, in0: float,
                   in1: float) -> np.ndarray:
    idx, k = _coeffs(px.shape[axis], in0, in1, out_size)
    # int32 as in C: 255 times the positive weights stays below 2^31
    src = np.moveaxis(px, axis, 0).astype(np.int32)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int32)
    extra = (1,) * (src.ndim - 1)
    for j in range(k.shape[1]):
        acc += src[idx[:, j]] * k[:, j].reshape((-1,) + extra)
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def _resample(px: np.ndarray, out_w: int, out_h: int, box) -> np.ndarray:
    """PIL's BICUBIC ``resize((out_w, out_h), box=box)`` on 8-bit channels:
    the horizontal pass, rounded to uint8, then the vertical pass."""
    px = _resample_axis(px, 1, out_w, box[0], box[2])
    return _resample_axis(px, 0, out_h, box[1], box[3])


def _dominant_jpeg_passthrough(doc, xobjects, target_longest_image_dim):
    """Raw JPEG bytes of the page's single image XObject, when shipping them
    unmodified is pixel-faithful to rasterizing at the target dim: plain
    DCTDecode (no SMask/Mask/Decode remapping, no extra filters) and the
    native longest side within 4% of the target (a pdftoppm render would
    reproduce the same pixels modulo resampling). Returns None otherwise."""
    from karanta_tpu_torch.pdf.minipdf import Name, Stream

    streams = [xo for xo in ((doc.resolve(ref)) for ref in
                             (xobjects or {}).values())
               if isinstance(xo, Stream)
               and doc.resolve(xo.dict.get(Name("Subtype"))) == Name("Image")]
    if len(streams) != 1:
        return None
    xo = streams[0]
    filt = doc.resolve(xo.dict.get(Name("Filter")))
    filters = [doc.resolve(f)
               for f in (filt if isinstance(filt, list) else [filt])]
    if filters != [Name("DCTDecode")]:
        return None
    for key in ("SMask", "Mask", "Decode"):
        if xo.dict.get(Name(key)) is not None:
            return None
    cs = doc.resolve(xo.dict.get(Name("ColorSpace")))
    if cs not in (Name("DeviceRGB"), Name("DeviceGray"), None):
        return None  # CMYK/ICC/indexed JPEGs need a real decode
    width = int(doc.resolve(xo.dict.get(Name("Width"), 0)) or 0)
    height = int(doc.resolve(xo.dict.get(Name("Height"), 0)) or 0)
    longest = max(width, height)
    if not longest:
        return None
    if abs(longest - target_longest_image_dim) / target_longest_image_dim \
            > 0.04:
        return None
    if not xo.raw.startswith(b"\xff\xd8"):
        return None
    return xo.raw


def _decode_embedded_image(doc, xobjects):
    """Decode the first decodable image XObject: Flate RGB or gray, CCITT
    and JBIG2 to a uint8 numpy array ((H, W, 3) or (H, W)); DCT and JPX to a
    PIL image, which needs Pillow (an ImportError naming it, never another
    image, where it is missing)."""
    import zlib

    from karanta_tpu_torch.pdf.minipdf import Name, Stream

    for _, ref in (xobjects or {}).items():
        xo = doc.resolve(ref)
        if not isinstance(xo, Stream):
            continue
        if doc.resolve(xo.dict.get(Name("Subtype"))) != Name("Image"):
            continue
        width = int(doc.resolve(xo.dict.get(Name("Width"), 0)))
        height = int(doc.resolve(xo.dict.get(Name("Height"), 0)))
        filt = doc.resolve(xo.dict.get(Name("Filter")))
        filters = filt if isinstance(filt, list) else [filt]
        filters = [doc.resolve(f) for f in filters]
        if Name("DCTDecode") in filters or Name("JPXDecode") in filters:
            # JPEG / JPEG2000 (archive.org's dominant scan codecs): PIL
            # decodes them (via openjpeg for JPX), as in the JAX package
            Image = _pil_image("decoding a DCT or JPX page image")
            try:
                return Image.open(io.BytesIO(xo.raw))
            except Exception:
                continue
        try:
            if Name("JBIG2Decode") in filters:
                # bitonal archive scans post-2005 (poppler-parity: the
                # reference's codec set, process_pdf_utils.py:56-74). The
                # stream carries embedded-organization segments; shared
                # symbol dictionaries arrive via /JBIG2Globals.
                from karanta_tpu_torch.pdf.jbig2 import decode_embedded

                parms_arr = doc.resolve(xo.dict.get(Name("DecodeParms")))
                if not isinstance(parms_arr, list):
                    parms_arr = [parms_arr]
                parms_arr = [doc.resolve(p) for p in parms_arr]
                ji = filters.index(Name("JBIG2Decode"))
                parms = (parms_arr[ji]
                         if ji < len(parms_arr)
                         and isinstance(parms_arr[ji], dict) else {})
                gref = parms.get(Name("JBIG2Globals"))
                gstream = doc.resolve(gref) if gref is not None else None
                globals_data = b""
                if isinstance(gstream, Stream):
                    globals_data = gstream.data(doc)
                data = xo.raw
                if filters and filters[0] == Name("FlateDecode"):
                    data = zlib.decompress(data)
                bitmap = decode_embedded(data, globals_data,
                                         width=width or None,
                                         height=height or None)
                # 1 = black -> gray 0 (same convention as CCITT below)
                return np.where(bitmap > 0, 0, 255).astype(np.uint8)
            if Name("CCITTFaxDecode") in filters:
                # bitonal fax scans — the dominant archive.org codec
                # (poppler decodes these natively; reference
                # process_pdf_utils.py:56-74). K < 0 = Group 4 only.
                from karanta_tpu_torch.pdf.ccitt import decode_g4

                # /DecodeParms aligns positionally with the /Filter array —
                # read the entry at CCITTFaxDecode's index, not the first
                # dict (a leading Flate stage may carry its own /Predictor
                # parms, which would otherwise be misread as K/Columns)
                parms_arr = doc.resolve(xo.dict.get(Name("DecodeParms")))
                if not isinstance(parms_arr, list):
                    parms_arr = [parms_arr]
                parms_arr = [doc.resolve(p) for p in parms_arr]
                ci = filters.index(Name("CCITTFaxDecode"))
                parms = (parms_arr[ci]
                         if ci < len(parms_arr)
                         and isinstance(parms_arr[ci], dict) else {})
                k = int(doc.resolve(parms.get(Name("K"), 0)) or 0)
                cols = int(doc.resolve(parms.get(Name("Columns"), 1728))
                           or 1728)
                data = xo.raw
                if filters and filters[0] == Name("FlateDecode"):
                    data = zlib.decompress(data)
                    fparms = (parms_arr[0] if parms_arr
                              and isinstance(parms_arr[0], dict) else None)
                    if fparms and Name("Predictor") in fparms:
                        from karanta_tpu_torch.pdf.minipdf import _apply_predictor

                        data = _apply_predictor(data, doc, fparms)
                if k < 0:
                    bitmap = decode_g4(data, columns=cols,
                                       rows=height or None)
                else:
                    from karanta_tpu_torch.pdf.ccitt import decode_g3

                    bitmap = decode_g3(data, columns=cols,
                                       rows=height or None, two_d=k > 0)
                # 1 = black ink -> gray 0 (/BlackIs1 describes the decoded
                # STREAM's bit convention, which we never materialize)
                return np.where(bitmap > 0, 0, 255).astype(np.uint8)
            if Name("FlateDecode") in filters or filt is None:
                raw = zlib.decompress(xo.raw) if filters else xo.raw
                cs = doc.resolve(xo.dict.get(Name("ColorSpace")))
                if cs == Name("DeviceRGB") and len(raw) >= width * height * 3:
                    return np.frombuffer(raw, np.uint8, width * height * 3
                                         ).reshape(height, width, 3)
                if cs == Name("DeviceGray") and len(raw) >= width * height:
                    return np.frombuffer(raw, np.uint8, width * height
                                         ).reshape(height, width)
        except Exception:
            continue
    return None


def get_png_dimensions_from_base64(b64: str) -> tuple[int, int]:
    """(width, height) from a base64 PNG without full decode."""
    header = base64.b64decode(b64[:64].encode("ascii") + b"==")
    if header[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    width, height = struct.unpack(">II", header[16:24])
    return width, height


def get_image_dimensions(data: bytes) -> tuple[int, int]:
    """(width, height) for PNG or JPEG bytes via header peek."""
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        w, h = struct.unpack(">II", data[16:24])
        return w, h
    if data[:2] == b"\xff\xd8":  # JPEG: scan for SOFn marker
        i = 2
        while i + 9 < len(data):
            if data[i] != 0xFF:
                i += 1
                continue
            marker = data[i + 1]
            if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
                h, w = struct.unpack(">HH", data[i + 5:i + 9])
                return w, h
            length = struct.unpack(">H", data[i + 2:i + 4])[0]
            i += 2 + length
        raise ValueError("no JPEG SOF marker found")
    raise ValueError("unsupported image format")


def is_png(path_or_bytes) -> bool:
    data = _head(path_or_bytes, 8)
    return data == b"\x89PNG\r\n\x1a\n"


def is_jpeg(path_or_bytes) -> bool:
    return _head(path_or_bytes, 2) == b"\xff\xd8"


def is_pdf(path_or_bytes) -> bool:
    return _head(path_or_bytes, 5).startswith(b"%PDF")


def _head(path_or_bytes, n: int) -> bytes:
    if isinstance(path_or_bytes, bytes):
        return path_or_bytes[:n]
    with open(path_or_bytes, "rb") as f:
        return f.read(n)


def convert_image_to_pdf_bytes(image_bytes: bytes,
                               text_layer: Optional[str] = None) -> bytes:
    """Wrap a PNG/JPEG into a single-page PDF (native img2pdf replacement;
    reference uses the img2pdf package — karanta/bench/convert.py:51-53).

    JPEG embeds losslessly via DCTDecode; other formats embed via Flate RGB.

    text_layer, when given, draws the string as (invisible: render mode 3)
    Helvetica text behind the image — the synthetic-corpus equivalent of a
    scanned page that has been OCRed once already, so anchor extraction
    (pdf/anchor.py) sees it exactly as the reference's pipeline sees a
    born-digital page's text layer (karanta/prompts/anchor.py).
    """
    import zlib

    width, height = get_image_dimensions(image_bytes)

    if is_jpeg(image_bytes):
        filt, payload, colorspace = "DCTDecode", image_bytes, "DeviceRGB"
        bpc = 8
    else:
        payload = zlib.compress(_decode_rgb(image_bytes).tobytes())
        filt, colorspace, bpc = "FlateDecode", "DeviceRGB", 8

    font_res = " /Font << /F0 6 0 R >>" if text_layer is not None else ""
    objects = []
    objects.append(b"<< /Type /Catalog /Pages 2 0 R >>")
    objects.append(b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>")
    objects.append(
        f"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 {width} {height}] "
        f"/Resources << /XObject << /Im0 4 0 R >>{font_res} >> "
        f"/Contents 5 0 R >>".encode())
    img_dict = (
        f"<< /Type /XObject /Subtype /Image /Width {width} /Height {height} "
        f"/ColorSpace /{colorspace} /BitsPerComponent {bpc} "
        f"/Filter /{filt} /Length {len(payload)} >>").encode()
    objects.append(img_dict + b"\nstream\n" + payload + b"\nendstream")
    content = f"q {width} 0 0 {height} 0 0 cm /Im0 Do Q".encode()
    if text_layer is not None:
        lines = text_layer.splitlines() or [""]
        parts = [b"BT 3 Tr /F0 10 Tf"]
        y = height - 12
        for line in lines:
            esc = (line.encode("latin-1", "replace")
                   .replace(b"\\", rb"\\").replace(b"(", rb"\(")
                   .replace(b")", rb"\)"))
            parts.append(b"1 0 0 1 4 " + str(max(y, 0)).encode()
                         + b" Tm (" + esc + b") Tj")
            y -= 12
        parts.append(b"ET")
        content += b" " + b" ".join(parts)
    objects.append(
        f"<< /Length {len(content)} >>".encode() + b"\nstream\n"
        + content + b"\nendstream")
    if text_layer is not None:
        objects.append(
            b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>")

    out = io.BytesIO()
    out.write(b"%PDF-1.4\n")
    offsets = [0]
    for i, body in enumerate(objects, start=1):
        offsets.append(out.tell())
        out.write(f"{i} 0 obj\n".encode() + body + b"\nendobj\n")
    xref_pos = out.tell()
    out.write(f"xref\n0 {len(objects) + 1}\n".encode())
    out.write(b"0000000000 65535 f \n")
    for off in offsets[1:]:
        out.write(f"{off:010d} 00000 n \n".encode())
    out.write(
        f"trailer\n<< /Size {len(objects) + 1} /Root 1 0 R >>\n"
        f"startxref\n{xref_pos}\n%%EOF\n".encode())
    return out.getvalue()


def _decode_rgb(image_bytes: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of a PNG the port's codec reads (8-bit gray, RGB,
    with or without alpha, which is dropped as PIL's convert("RGB") drops
    it); any other image through PIL."""
    from karanta_tpu_torch.ops.png import decode_png_rgb

    try:
        return decode_png_rgb(image_bytes)
    except ValueError:
        Image = _pil_image("decoding a non-PNG or palette/16-bit PNG image")
        return np.asarray(Image.open(io.BytesIO(image_bytes)).convert("RGB"))
