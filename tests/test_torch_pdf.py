"""The port's PDF stack (``karanta_tpu_torch.pdf``) against the JAX package's.

The same PDFs (``tests/pdf_helpers.make_pdf``, encrypted variants, scanned
pages written by the JAX package's ``convert_image_to_pdf_bytes`` and
``data/synthetic.py``, CCITT and JBIG2 pages) go through both packages:
page counts, ``extract_page_report``, anchor text and media boxes are equal.

The port renders a blank page and an image-only Flate, CCITT or JBIG2 page
without PIL (numpy, its own ``thumbnail`` and ``ops/png.py``); the JAX
package renders them with PIL (Pillow 12.1.0 on the host these tests were
written on). The decoded pixels are equal, resized pages included, with and
without PIL's integer reduce step. The PNG bytes differ (PIL picks filters
per row, the port writes filter 0 on every row), so pixels are compared.
"""

import base64
import dataclasses
import io
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from karanta_tpu.data.synthetic import page_to_pdf_bytes as j_page_to_pdf
from karanta_tpu.pdf import anchor as j_anchor
from karanta_tpu.pdf import minipdf as j_minipdf
from karanta_tpu.pdf import primitives as j_prim
from karanta_tpu.pdf import textextract as j_text
from karanta_tpu.prompts.templates import base64_to_grayscale as j_gray
from karanta_tpu_torch.data.synthetic import (page_to_pdf_bytes,
                                              pages_to_pdf_bytes)
from karanta_tpu_torch.ops.png import decode_png
from karanta_tpu_torch.pdf import anchor, minipdf, primitives, textextract
from karanta_tpu_torch.pipeline.runner import rotate_png_base64
from karanta_tpu_torch.prompts.templates import base64_to_grayscale
from tests.pdf_helpers import encrypt_pdf, make_pdf
from tests.test_ccitt import _ccitt_pdf
from tests.test_jbig2 import _jbig2_pdf

TEXT_PAGES = [
    [(72, 720, "Hello port world"), (72, 700, "Second line of text")],
    [(100, 650, "Page two content, with (parens) and \\ slash")],
]


def _pixels(b64: str) -> np.ndarray:
    """Decoded pixels of a base64 PNG or JPEG, through PIL, as RGB or L."""
    with Image.open(io.BytesIO(base64.b64decode(b64))) as img:
        return np.asarray(img)


def _page(seed: int, h: int, w: int, gray: bool = False) -> np.ndarray:
    rng = np.random.default_rng(seed)
    shape = (h, w) if gray else (h, w, 3)
    px = rng.integers(0, 256, shape, dtype=np.uint8)
    px[h // 4:h // 2] = 255 - px[h // 4:h // 2] // 4  # some structure
    return px


def _png(px: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, format="PNG")
    return buf.getvalue()


def _jpeg(px: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def _gray_flate_pdf(px: np.ndarray) -> bytes:
    """A page whose only content is a Flate DeviceGray image."""
    h, w = px.shape
    payload = zlib.compress(px.tobytes())
    content = b"q 612 0 0 792 0 0 cm /Im1 Do Q"
    pdf = (b"%PDF-1.4\n"
           b"1 0 obj\n<< /Type /Catalog /Pages 2 0 R >>\nendobj\n"
           b"2 0 obj\n<< /Type /Pages /Kids [3 0 R] /Count 1 >>\nendobj\n"
           b"3 0 obj\n<< /Type /Page /Parent 2 0 R /MediaBox [0 0 612 792] "
           b"/Resources << /XObject << /Im1 5 0 R >> >> /Contents 4 0 R >>\n"
           b"endobj\n"
           b"4 0 obj\n<< /Length " + str(len(content)).encode()
           + b" >>\nstream\n" + content + b"\nendstream\nendobj\n"
           b"5 0 obj\n<< /Type /XObject /Subtype /Image /Width "
           + str(w).encode() + b" /Height " + str(h).encode()
           + b" /ColorSpace /DeviceGray /BitsPerComponent 8 /Filter "
           b"/FlateDecode /Length " + str(len(payload)).encode()
           + b" >>\nstream\n" + payload + b"\nendstream\nendobj\n")
    return pdf + b"trailer\n<< /Size 6 /Root 1 0 R >>\n%%EOF\n"


# name -> (PDF bytes, render target): scanned pages of every PIL-free kind,
# at targets that leave them as they are, resize them without a reduce
# step (scale < 4) and with one (a 2x and a 3x reduce), plus PIL cases
SCANS = {
    "flate_rgb_fits": (lambda: primitives.convert_image_to_pdf_bytes(
        _png(_page(1, 120, 90))), 128),
    "flate_rgb_resize": (lambda: primitives.convert_image_to_pdf_bytes(
        _png(_page(2, 300, 231))), 224),
    "flate_rgb_reduce2x": (lambda: primitives.convert_image_to_pdf_bytes(
        _png(_page(3, 1100, 850))), 256),
    "flate_rgb_reduce3x_text_layer": (
        lambda: primitives.convert_image_to_pdf_bytes(
            _png(_page(4, 900, 700)), text_layer="an OCR layer\nline two"),
        128),
    "flate_gray_resize": (lambda: _gray_flate_pdf(
        _page(5, 400, 310, gray=True)), 160),
    "ccitt_resize": (lambda: _ccitt_pdf(
        np.random.default_rng(6).random((420, 330)) > 0.8), 200),
    "jbig2_reduce2x": (lambda: _jbig2_pdf(
        np.tril(np.ones((256, 198)), -30) > 0), 60),
    "jpeg_passthrough": (lambda: j_page_to_pdf(_page(7, 256, 198)), 256),
    "jpeg_decoded_pil": (lambda: j_page_to_pdf(_page(8, 300, 232)), 128),
    "visible_text_pil": (lambda: make_pdf(TEXT_PAGES), 200),
    "blank": (lambda: make_pdf([[]]), 64),
}


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    root = tmp_path_factory.mktemp("scans")
    out = {}
    for name, (make, target) in SCANS.items():
        path = root / f"{name}.pdf"
        path.write_bytes(make())
        out[name] = (str(path), target)
    return out


@pytest.mark.parametrize("name", sorted(SCANS))
def test_render_matches_jax(scans, name):
    path, target = scans[name]
    got = primitives.render_pdf_to_base64png(path, 1, target)
    want = j_prim.render_pdf_to_base64png(path, 1, target)
    if name == "jpeg_passthrough":
        assert got == want and base64.b64decode(got)[:2] == b"\xff\xd8"
        return
    got_px, want_px = _pixels(got), _pixels(want)
    assert got_px.shape == want_px.shape
    assert np.array_equal(got_px, want_px)


def _render(scans, name):
    path, target = scans[name]
    return primitives.render_pdf_to_base64png(path, 1, target)


def test_render_without_pil(scans, monkeypatch):
    """With PIL unimportable, the PIL-free pages render to the same pixels,
    and a page that needs PIL raises an ImportError that names it."""
    want = {name: _pixels(_render(scans, name))
            for name in ("blank", "flate_rgb_reduce2x", "ccitt_resize",
                         "flate_gray_resize")}
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    for name, px in want.items():
        got = _render(scans, name)
        assert np.array_equal(decode_png(base64.b64decode(got)), px), name
    # the passthrough needs no decode either
    _render(scans, "jpeg_passthrough")
    for name in ("jpeg_decoded_pil", "visible_text_pil"):
        with pytest.raises(ImportError, match="Pillow"):
            _render(scans, name)


@pytest.mark.parametrize("w,h,target", [
    (300, 200, 224), (1100, 900, 256), (994, 1288, 300), (640, 47, 100),
    (501, 1003, 97), (2000, 1500, 333), (1289, 10, 1288), (50, 900, 64)])
def test_thumbnail_matches_pil(w, h, target):
    """PIL's thumbnail rule on random pixels, RGB and gray: scales below 2
    (bicubic only), 4-6 (a 2x reduce first) and above (3x-14x reduces)."""
    for gray in (False, True):
        px = _page(w + h, h, w, gray=gray)
        img = Image.fromarray(px)
        img.thumbnail((target, target), Image.Resampling.BICUBIC)
        assert np.array_equal(primitives.thumbnail(px, target),
                              np.asarray(img))


@pytest.mark.parametrize("fx,fy", [(2, 2), (3, 3), (2, 3), (5, 1), (6, 4)])
def test_reduce_matches_pil(fx, fy):
    px = _page(fx * 10 + fy, 37, 41, gray=True)
    want = np.asarray(Image.fromarray(px).reduce((fx, fy)))
    assert np.array_equal(primitives._reduce(px, fx, fy), want)


@pytest.mark.parametrize("name", ["flate_rgb_resize", "ccitt_resize",
                                  "jpeg_passthrough"])
def test_grayscale_and_rotations_match_jax(scans, name):
    """base64_to_grayscale (PIL's L rule), then the runner's rotations
    (np.rot90 against PIL's ROTATE_90/180/270), pixel for pixel."""
    b64 = _render(scans, name)
    gray, j_gray_b64 = base64_to_grayscale(b64), j_gray(b64)
    assert np.array_equal(_pixels(gray), _pixels(j_gray_b64))
    assert Image.open(io.BytesIO(base64.b64decode(gray))).mode == "L"
    for rotation, transpose in ((90, Image.Transpose.ROTATE_90),
                                (180, Image.Transpose.ROTATE_180),
                                (270, Image.Transpose.ROTATE_270)):
        want = np.asarray(Image.open(io.BytesIO(
            base64.b64decode(j_gray_b64))).transpose(transpose))
        assert np.array_equal(_pixels(rotate_png_base64(gray, rotation)),
                              want)


def test_rgb_grayscale_formula():
    """Every (R, G, B) corner and a random spread through both packages."""
    rng = np.random.default_rng(0)
    px = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    px[0, :8] = [[r, g, b] for r in (0, 255) for g in (0, 255)
                 for b in (0, 255)]
    b64 = base64.b64encode(_png(px)).decode()
    assert np.array_equal(_pixels(base64_to_grayscale(b64)),
                          _pixels(j_gray(b64)))


def _documents(tmp_path):
    """PDFs from the repo's test writer and the JAX package's writers."""
    docs = {
        "text": make_pdf(TEXT_PAGES),
        "text_compressed_image": make_pdf(TEXT_PAGES, compress=True,
                                          with_image=True),
        "invisible_layer": make_pdf(TEXT_PAGES, text_render_mode=3),
        "rc4": encrypt_pdf(make_pdf(TEXT_PAGES, compress=True),
                           method="rc4-128"),
        "aes256": encrypt_pdf(make_pdf(TEXT_PAGES, compress=True,
                                       with_image=True), method="aes-256"),
        "synthetic_jpeg": j_page_to_pdf(
            _page(9, 200, 150), text_layer="scan layer\nsecond line"),
        "synthetic_flate": page_to_pdf_bytes(
            _page(10, 200, 150), text_layer="port scan layer"),
        "synthetic_two_pages": pages_to_pdf_bytes([_page(14, 90, 70),
                                                   _page(15, 70, 90)]),
        "image_png": j_prim.convert_image_to_pdf_bytes(_png(_page(11, 64,
                                                                   80))),
    }
    paths = {}
    for name, data in docs.items():
        path = tmp_path / f"{name}.pdf"
        path.write_bytes(data)
        paths[name] = str(path)
    return paths


def test_reader_anchor_and_report_match_jax(tmp_path):
    for name, path in _documents(tmp_path).items():
        doc, jdoc = (minipdf.PdfDocument.open(path),
                     j_minipdf.PdfDocument.open(path))
        n = doc.num_pages()
        assert n == jdoc.num_pages() and n >= 1, name
        for i in range(n):
            assert doc.media_box(i) == jdoc.media_box(i)
            assert dataclasses.asdict(textextract.extract_page_report(
                doc, i)) == dataclasses.asdict(
                j_text.extract_page_report(jdoc, i)), (name, i)
            assert textextract.extract_plain_text(doc, i) == \
                j_text.extract_plain_text(jdoc, i)
            for mode in ("pdfreport", "pdftotext"):
                assert anchor.get_anchor_text(path, i + 1, mode) == \
                    j_anchor.get_anchor_text(path, i + 1, mode), (name, mode)
            assert primitives.get_pdf_media_box_width_height(path, i + 1) \
                == j_prim.get_pdf_media_box_width_height(path, i + 1)


def test_image_to_pdf_matches_jax():
    """PNG input (gray, RGB, RGBA) embeds the same Flate pixels; JPEG input
    embeds its own bytes, in both packages, byte for byte."""
    px = _page(12, 40, 30)
    rgba = np.concatenate([px, np.full((40, 30, 1), 7, np.uint8)], axis=-1)
    for data in (_png(px), _png(px[..., 0]), _png(rgba), _jpeg(px)):
        for layer in (None, "hidden text"):
            assert primitives.convert_image_to_pdf_bytes(data, layer) == \
                j_prim.convert_image_to_pdf_bytes(data, layer)


def test_synthetic_pages_are_flate_rgb(tmp_path):
    """The port's synthetic pages embed their pixels losslessly (Flate RGB,
    where the JAX package embeds a JPEG), so each page renders to itself,
    in the port and in the JAX package, one page or several a PDF."""
    px = _page(13, 160, 124)
    pages = [_page(16, 120, 93), _page(17, 93, 120)]
    for data, want in ((page_to_pdf_bytes(px, text_layer="layer"), [px]),
                       (pages_to_pdf_bytes(pages), pages)):
        path = tmp_path / "p.pdf"
        path.write_bytes(data)
        assert b"/FlateDecode" in data
        assert j_minipdf.PdfDocument.open(str(path)).num_pages() == len(want)
        for i, page in enumerate(want):
            b64 = primitives.render_pdf_to_base64png(str(path), i + 1, 160)
            assert np.array_equal(decode_png(base64.b64decode(b64)), page)
            assert np.array_equal(_pixels(j_prim.render_pdf_to_base64png(
                str(path), i + 1, 160)), page)
