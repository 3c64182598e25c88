"""The port's network-only modules (``utils/model_download.py``,
``data/hub.py``, ``data/internet_archive_downloader.py``) against the JAX
package's copies, offline: the twins of tests/test_utils.py's
``download_model`` and language cases, with every optional SDK either
hidden (the gate raises ImportError) or replaced by a fake module that
records its calls, so nothing reaches the network.
"""

import sys
import types

import pytest

from karanta_tpu.data import hub as jhub
from karanta_tpu.data import internet_archive_downloader as jia
from karanta_tpu.utils import model_download as jmd
from karanta_tpu_torch.data import hub as thub
from karanta_tpu_torch.data import internet_archive_downloader as tia
from karanta_tpu_torch.utils import model_download as tmd

BOTH = {"jax": (jmd, jhub, jia), "torch": (tmd, thub, tia)}


def test_local_dir_passthrough(tmp_path):
    for md, _, _ in BOTH.values():
        assert md.download_model(str(tmp_path)) == str(tmp_path)


@pytest.mark.parametrize("uri,module", [
    ("s3://no-such-bucket/model", "boto3"),
    ("gs://no-such-bucket/model", "google.cloud"),
    ("some-org/some-model", "huggingface_hub")])
def test_missing_sdk_raises_import_error(monkeypatch, tmp_path, uri, module):
    """Without its SDK each backend raises ImportError naming it (one
    attempt, no retry sleep), in both packages."""
    monkeypatch.setitem(sys.modules, module, None)
    messages = []
    for md, _, _ in BOTH.values():
        monkeypatch.setattr(md, "CACHE_ROOT", str(tmp_path))
        with pytest.raises(ImportError) as info:
            md.download_model(uri, retries=1)
        messages.append(str(info.value))
    assert messages[0] == messages[1]


def _fake_gcs(monkeypatch, calls):
    """A fake google.cloud.storage whose bucket holds two blobs."""
    class Blob:
        def __init__(self, name):
            self.name, self.size = name, 3

        def download_to_filename(self, path):
            calls.append(("download", self.name))
            with open(path, "wb") as f:
                f.write(b"abc")

    class Client:
        def list_blobs(self, bucket, prefix):
            calls.append(("list", bucket, prefix))
            return [Blob(f"{prefix}/config.json"),
                    Blob(f"{prefix}/w/model.safetensors")]

    google = types.ModuleType("google")
    cloud = types.ModuleType("google.cloud")
    storage = types.ModuleType("google.cloud.storage")
    storage.Client = Client
    cloud.storage = storage
    google.cloud = cloud
    for name, mod in (("google", google), ("google.cloud", cloud),
                      ("google.cloud.storage", storage)):
        monkeypatch.setitem(sys.modules, name, mod)


def test_gcs_download_layout_equals_jax(monkeypatch, tmp_path):
    """gs:// through a fake storage client: the same listing, the same files
    under the same cache directory name, and a second call downloads
    nothing (sizes match)."""
    out = {}
    for name, (md, _, _) in BOTH.items():
        calls = []
        _fake_gcs(monkeypatch, calls)
        root = tmp_path / name
        monkeypatch.setattr(md, "CACHE_ROOT", str(root))
        dest = md.download_model("gs://bucket/models/m1", retries=1)
        again = md.download_model("gs://bucket/models/m1", retries=1)
        assert again == dest
        files = sorted(p.relative_to(root).as_posix()
                       for p in root.rglob("*") if p.is_file())
        out[name] = (calls, files)
    assert out["torch"] == out["jax"]
    calls, files = out["torch"]
    assert [c[0] for c in calls] == ["list", "download", "download", "list"]
    assert len(files) == 2 and files[1].endswith("w/model.safetensors")


def test_hub_snapshot_arguments_equal_jax(monkeypatch, tmp_path):
    """A hub id goes to huggingface_hub.snapshot_download with the same
    arguments (its cache under CACHE_ROOT/hf)."""
    out = {}
    for name, (md, _, _) in BOTH.items():
        calls = []
        hub = types.ModuleType("huggingface_hub")
        hub.snapshot_download = lambda repo, **kw: (
            calls.append((repo, kw)) or "/snap/" + repo)
        monkeypatch.setitem(sys.modules, "huggingface_hub", hub)
        monkeypatch.setattr(md, "CACHE_ROOT", str(tmp_path))
        assert md.download_model("org/model", retries=1) == "/snap/org/model"
        out[name] = calls
    assert out["torch"] == out["jax"] == [
        ("org/model", {"revision": None,
                       "cache_dir": str(tmp_path / "hf")})]


def test_hub_upload_calls_equal_jax(monkeypatch, tmp_path):
    """upload_folder_to_hub and push_model_to_hub through a fake HfApi: the
    same calls and URLs; without huggingface_hub the gate raises."""
    out = {}
    for name, (_, hub, _) in BOTH.items():
        calls = []

        class Api:
            def create_repo(self, *a, **kw):
                calls.append(("create", a, kw))

            def upload_folder(self, **kw):
                calls.append(("upload", kw))

        fake = types.ModuleType("huggingface_hub")
        fake.HfApi = Api
        monkeypatch.setitem(sys.modules, "huggingface_hub", fake)
        urls = (hub.upload_folder_to_hub(str(tmp_path), "org/data"),
                hub.push_model_to_hub(str(tmp_path), "org/model"))
        out[name] = (urls, calls)
        monkeypatch.setitem(sys.modules, "huggingface_hub", None)
        with pytest.raises(ImportError):
            hub.upload_folder_to_hub(str(tmp_path), "org/data")
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == ("https://huggingface.co/datasets/org/data",
                               "https://huggingface.co/models/org/model")


def test_languages_registry_equals_jax():
    assert [(m.name, m.value) for m in thub.Languages] == \
        [(m.name, m.value) for m in jhub.Languages]
    assert thub.Languages.YORUBA.value == "yoruba"
    assert tia.LANGUAGE_MAP == jia.LANGUAGE_MAP


def test_internet_archive_gated_and_query_equals_jax(monkeypatch, tmp_path):
    """Without `internetarchive` the downloader raises ImportError; with a
    fake one, the same search query and the original PDF preferred."""
    monkeypatch.setitem(sys.modules, "internetarchive", None)
    for _, _, ia in BOTH.values():
        with pytest.raises(ImportError, match="internetarchive"):
            ia.search_identifiers("yoruba")
    out = {}
    for name, (_, _, ia) in BOTH.items():
        calls = []

        class Item:
            files = [{"name": "a_derived.pdf", "source": "derivative"},
                     {"name": "a.pdf", "source": "original"},
                     {"name": "a.txt"}]

            def download(self, **kw):
                calls.append(("download", kw))

        fake = types.ModuleType("internetarchive")
        fake.search_items = lambda q: (calls.append(("search", q)) or
                                       [{"identifier": f"id{i}"}
                                        for i in range(5)])
        fake.get_item = lambda ident: calls.append(("item", ident)) or Item()
        monkeypatch.setitem(sys.modules, "internetarchive", fake)
        ids = ia.search_identifiers("yoruba", max_items=3)
        path = ia.download_one(("id0", str(tmp_path)))
        out[name] = (ids, path, calls)
    assert out["torch"] == out["jax"]
    ids, path, calls = out["torch"]
    assert ids == ["id0", "id1", "id2"]
    assert path.endswith("id0/a.pdf")
    assert 'language:"yoruba" OR language:"yor"' in calls[0][1]
