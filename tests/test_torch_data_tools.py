"""The port's copies of the data-preparation tools (karanta_tpu_torch.data:
convert_pdf_2_image, split_pdf, sampler, corpus_stats) against the JAX
package's on the same inputs: the same page PNG pixels and file names, the
same split files byte for byte, the same sampled triples and CSVs, and the
same corpus statistics and resumable state (the cases of
tests/test_data_tools.py and tests/test_tooling.py that cover them)."""

import io
import json

import numpy as np
import pytest

from karanta_tpu.data import convert_pdf_2_image as jconv
from karanta_tpu.data import corpus_stats as jstats
from karanta_tpu.data import sampler as jsamp
from karanta_tpu.data import split_pdf as jsplit
from karanta_tpu_torch.data import convert_pdf_2_image as tconv
from karanta_tpu_torch.data import corpus_stats as tstats
from karanta_tpu_torch.data import sampler as tsamp
from karanta_tpu_torch.data import split_pdf as tsplit
from tests.pdf_helpers import make_pdf


def _scanned_pdf_bytes(h=60, w=48, seed=0):
    from PIL import Image

    from karanta_tpu_torch.pdf.primitives import convert_image_to_pdf_bytes

    img = Image.fromarray(np.random.default_rng(seed).integers(
        150, 255, (h, w, 3), dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="JPEG")
    return convert_image_to_pdf_bytes(buf.getvalue())


def _pixels(path):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


@pytest.fixture(scope="module")
def pdf_dir(tmp_path_factory):
    """Two scanned one-page PDFs, one in a sub-folder, and a born-digital
    two-page PDF with text."""
    root = tmp_path_factory.mktemp("pdfs")
    (root / "sub").mkdir()
    (root / "a.pdf").write_bytes(_scanned_pdf_bytes(seed=0))
    (root / "sub" / "b.pdf").write_bytes(_scanned_pdf_bytes(90, 70, seed=1))
    (root / "two.pdf").write_bytes(make_pdf(
        [[(72, 700, "first page text")], [(72, 700, "second page text")]]))
    return root


def test_pdfs_to_images_match_jax(pdf_dir, tmp_path):
    n_t = tconv.convert_pdfs_to_images(str(pdf_dir), str(tmp_path / "t"),
                                       target_dim=64, workers=1)
    n_j = jconv.convert_pdfs_to_images(str(pdf_dir), str(tmp_path / "j"),
                                       target_dim=64, workers=1)
    assert n_t == n_j == 4
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == ["a_pg_1.png", "b_pg_1.png", "two_pg_1.png",
                     "two_pg_2.png"]
    for name in names:
        np.testing.assert_array_equal(_pixels(tmp_path / "t" / name),
                                      _pixels(tmp_path / "j" / name))
    # a second run finds every page written and renders nothing again
    assert tconv.convert_pdfs_to_images(str(pdf_dir), str(tmp_path / "t"),
                                        target_dim=64, workers=1) == 4


def test_images_to_pdfs_match_jax(tmp_path):
    from PIL import Image

    src = tmp_path / "imgs"
    src.mkdir()
    rng = np.random.default_rng(3)
    for i, ext in enumerate(("png", "jpg")):
        Image.fromarray(rng.integers(0, 255, (40, 30, 3), dtype=np.uint8)
                        ).save(src / f"p{i}.{ext}")
    assert tconv.convert_images_to_pdfs(str(src), str(tmp_path / "t")) == 2
    assert jconv.convert_images_to_pdfs(str(src), str(tmp_path / "j")) == 2
    for name in ("p0.pdf", "p1.pdf"):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()


@pytest.mark.parametrize("reverse", [False, True])
def test_convert_cli_matches_jax(pdf_dir, tmp_path, capsys, reverse):
    src = str(pdf_dir)
    if reverse:
        jconv.convert_pdfs_to_images(src, str(tmp_path / "pages"),
                                     target_dim=48, workers=1)
        src = str(tmp_path / "pages")
    outs = []
    for mod, tag in ((tconv, "t"), (jconv, "j")):
        argv = ["--input_dir", src, "--output_dir", str(tmp_path / tag),
                "--target_dim", "48", "--workers", "1"]
        mod.main(argv + (["--reverse"] if reverse else []))
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] == "converted 4\n"
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == \
        sorted(p.name for p in (tmp_path / "j").iterdir())


def test_split_pdfs_match_jax(pdf_dir, tmp_path, capsys):
    from karanta_tpu_torch.pdf.minipdf import PdfDocument
    from karanta_tpu_torch.pdf.textextract import extract_plain_text

    tsplit.main(["--input_dir", str(pdf_dir), "--output_dir",
                 str(tmp_path / "t"), "--workers", "1"])
    n_j = jsplit.split_pdfs(str(pdf_dir), str(tmp_path / "j"), workers=1)
    assert capsys.readouterr().out == f"split {n_j}\n" and n_j == 4
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir())
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name
    doc = PdfDocument.open(str(tmp_path / "t" / "two_page_2.pdf"))
    assert doc.num_pages() == 1
    assert "second page text" in extract_plain_text(doc, 0)


@pytest.mark.parametrize("n_items,n_samples,seed", [
    (100, 10, 0), (7, 7, 1), (7, 9, 2), (50, 0, 3), (1000, 37, 4)])
def test_systematic_sample_matches_jax(n_items, n_samples, seed):
    got = tsamp.systematic_sample(n_items, n_samples,
                                  np.random.default_rng(seed))
    want = jsamp.systematic_sample(n_items, n_samples,
                                   np.random.default_rng(seed))
    assert got == want


@pytest.mark.parametrize("mode", ["proportional", "balanced"])
@pytest.mark.parametrize("total,min_per", [(40, 0), (40, 5), (3, 2), (0, 1)])
def test_allocate_samples_matches_jax(mode, total, min_per):
    sizes = {"a": 100, "b": 300, "c": 2}
    assert tsamp.allocate_samples(sizes, total, mode, min_per) == \
        jsamp.allocate_samples(sizes, total, mode, min_per)


def test_allocate_samples_rejects_unknown_modes():
    for mod in (tsamp, jsamp):
        with pytest.raises(ValueError, match="mode"):
            mod.allocate_samples({"a": 1}, 1, "random")


def _catalog():
    return ([{"folder": "big", "document": f"d{i}", "pages": 50}
             for i in range(4)]
            + [{"folder": "small", "document": "s0", "pages": 2},
               {"folder": "mid", "document": "m0", "pages": 17}])


@pytest.mark.parametrize("total,coverage,seed", [(20, 2, 0), (5, 1, 7),
                                                 (300, 1, 3)])
def test_two_phase_sample_matches_jax(total, coverage, seed):
    got = tsamp.two_phase_sample(_catalog(), total, coverage, seed)
    assert got == jsamp.two_phase_sample(_catalog(), total, coverage, seed)
    assert {s["folder"] for s in got} == {"big", "small", "mid"}


def test_sampler_cli_matches_jax(tmp_path, capsys):
    import csv

    catalog = tmp_path / "catalog.csv"
    with open(catalog, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["folder", "document",
                                               "pages"])
        writer.writeheader()
        writer.writerows(_catalog())
    assert tsamp.read_catalog_csv(str(catalog)) == \
        jsamp.read_catalog_csv(str(catalog))
    outs = []
    for mod, tag in ((tsamp, "t"), (jsamp, "j")):
        mod.main(["--catalog", str(catalog), "--output",
                  str(tmp_path / f"{tag}.csv"), "--total", "25",
                  "--coverage", "2", "--seed", "5"])
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and json.loads(outs[0])["sampled"] > 0
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


@pytest.fixture
def corpus(tmp_path):
    root = tmp_path / "corpus"
    (root / "folderA").mkdir(parents=True)
    (root / "folderB").mkdir(parents=True)
    (root / "folderA" / "x.pdf").write_bytes(_scanned_pdf_bytes(seed=1))
    (root / "folderB" / "y.pdf").write_bytes(make_pdf(
        [[(72, 700, "one")], [(72, 700, "two")], [(72, 700, "three")]]))
    (root / "folderB" / "bad.pdf").write_bytes(b"not a pdf at all")
    (root / "top.pdf").write_bytes(_scanned_pdf_bytes(seed=2))
    return root


def test_corpus_stats_match_jax(corpus, tmp_path):
    """The same statistics and state from both packages, and a resume that
    re-scans nothing."""
    runs = {}
    for mod, tag in ((tstats, "t"), (jstats, "j")):
        state = tmp_path / f"{tag}.json"
        analyzer = mod.CorpusAnalyzer(mod.LocalPdfBackend(str(corpus)),
                                      str(state), max_workers=2)
        runs[tag] = (analyzer.run(), json.loads(state.read_text()))
    assert runs["t"] == runs["j"]
    stats = runs["t"][0]
    assert (stats["total"]["documents"], stats["total"]["pages"]) == (4, 5)
    assert stats["folders"]["folderB"]["pages"] == 3

    resumed = tstats.CorpusAnalyzer(tstats.LocalPdfBackend(str(corpus)),
                                    str(tmp_path / "t.json"))
    before = dict(resumed.state["processed"])
    assert resumed.run() == stats
    assert resumed.state["processed"] == before
    assert list(tstats.LocalPdfBackend(str(corpus)).list_blobs()) == \
        list(jstats.LocalPdfBackend(str(corpus)).list_blobs())
    assert tstats.blob_key("a/b.pdf", 12.5) == jstats.blob_key("a/b.pdf", 12.5)


def test_corpus_stats_cli_matches_jax(corpus, tmp_path, capsys):
    outs = []
    for mod, tag in ((tstats, "t"), (jstats, "j")):
        mod.main(["--root", str(corpus), "--state",
                  str(tmp_path / f"{tag}.json"), "--workers", "2"])
        outs.append(json.loads(capsys.readouterr().out))
    # the same statistics; the folders' order follows the worker threads
    assert outs[0] == outs[1]
    assert outs[0]["total"]["documents"] == 4
