"""PDF standard security handler: transparent empty-password decryption.

Real-world archives (the reference's data source is archive.org —
reference scripts/internet_archive_downloader.py) contain many PDFs that
are "encrypted" with an empty user password — DRM-flavored files that
pypdf and poppler open transparently (reference karanta/prompts/anchor.py:69
`PdfReader`, karanta/data/process_pdf_utils.py:56-74 poppler). This module
gives minipdf the same tolerance:

  - RC4 40..128-bit (R=2/3, V=1/2) and crypt-filter RC4/AES-128 (R=4, V=4)
  - AES-256 (R=5 legacy Adobe + R=6 ISO 32000-2, V=5)
  - empty USER password only: files that require a real password to view
    are reported as unsupported and degrade to an empty anchor upstream.

RC4 and the key-derivation hashes are pure Python (hashlib); AES rides the
`cryptography` package when present and reports unsupported otherwise —
never an import error at module load.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Optional

try:  # gated: AES paths report unsupported when the package is absent
    from cryptography.hazmat.primitives.ciphers import (
        Cipher, algorithms, modes,
    )
    _HAVE_AES = True
except Exception:  # pragma: no cover - environment without cryptography
    _HAVE_AES = False


class UnsupportedEncryption(Exception):
    """Encryption we cannot transparently remove (wrong password, exotic
    handler, missing AES backend). Callers degrade to image-only/empty
    anchors — the exception never escapes the PDF public surface."""


# Algorithm 2 password padding (PDF 32000-1:2008, 7.6.3.3)
_PAD = bytes([
    0x28, 0xBF, 0x4E, 0x5E, 0x4E, 0x75, 0x8A, 0x41,
    0x64, 0x00, 0x4E, 0x56, 0xFF, 0xFA, 0x01, 0x08,
    0x2E, 0x2E, 0x00, 0xB6, 0xD0, 0x68, 0x3E, 0x80,
    0x2F, 0x0C, 0xA9, 0xFE, 0x64, 0x53, 0x69, 0x7A,
])


def rc4(key: bytes, data: bytes) -> bytes:
    """Plain RC4 (symmetric). Pure Python: encrypted docs are the cold path
    and streams are small; correctness over speed."""
    s = list(range(256))
    j = 0
    klen = len(key)
    for i in range(256):
        j = (j + s[i] + key[i % klen]) & 0xFF
        s[i], s[j] = s[j], s[i]
    out = bytearray(len(data))
    i = j = 0
    for n, c in enumerate(data):
        i = (i + 1) & 0xFF
        j = (j + s[i]) & 0xFF
        s[i], s[j] = s[j], s[i]
        out[n] = c ^ s[(s[i] + s[j]) & 0xFF]
    return bytes(out)


def _aes_cbc_decrypt(key: bytes, iv: bytes, data: bytes) -> bytes:
    if not _HAVE_AES:
        raise UnsupportedEncryption("AES backend unavailable")
    if len(data) % 16:
        data = data[: len(data) - len(data) % 16]
    if not data:
        return b""
    dec = Cipher(algorithms.AES(key), modes.CBC(iv)).decryptor()
    return dec.update(data) + dec.finalize()


def _aes_cbc_encrypt_nopad(key: bytes, iv: bytes, data: bytes) -> bytes:
    if not _HAVE_AES:
        raise UnsupportedEncryption("AES backend unavailable")
    enc = Cipher(algorithms.AES(key), modes.CBC(iv)).encryptor()
    return enc.update(data) + enc.finalize()


def _strip_pkcs5(data: bytes) -> bytes:
    if not data:
        return data
    pad = data[-1]
    if 1 <= pad <= 16 and len(data) >= pad:
        return data[:-pad]
    return data  # tolerate sloppy padding in the wild


def _hash_r6(password: bytes, salt: bytes, udata: bytes) -> bytes:
    """ISO 32000-2 Algorithm 2.B iterated hash (R=6)."""
    k = hashlib.sha256(password + salt + udata).digest()
    rounds = 0
    while True:
        k1 = (password + k + udata) * 64
        e = _aes_cbc_encrypt_nopad(k[:16], k[16:32], k1)
        # first 16 bytes of E as a big-endian integer mod 3 == byte-sum mod 3
        mod = sum(e[:16]) % 3
        k = (hashlib.sha256, hashlib.sha384, hashlib.sha512)[mod](e).digest()
        rounds += 1
        # spec: stop once at least 64 rounds ran AND e[-1] <= rounds - 32
        if rounds >= 64 and e[-1] <= rounds - 32:
            return k[:32]


class StandardSecurityHandler:
    """Decrypts strings/streams given the (num, gen) of their containing
    indirect object. Construction verifies the EMPTY user password and
    derives the file key; raises UnsupportedEncryption otherwise."""

    def __init__(self, encrypt_dict: dict, id0: bytes, resolve):
        def g(name, default=None):
            return resolve(encrypt_dict.get(name, default))

        from karanta_tpu_torch.pdf.minipdf import Name  # local: avoid cycle

        if g(Name("Filter")) != Name("Standard"):
            raise UnsupportedEncryption("non-standard security handler")
        self.v = int(g(Name("V"), 0) or 0)
        self.r = int(g(Name("R"), 2) or 2)
        length_bits = int(g(Name("Length"), 40) or 40)
        o = g(Name("O")) or b""
        u = g(Name("U")) or b""
        p = int(g(Name("P"), -1) or -1)
        self.stm_cfm = self.str_cfm = "V2"  # RC4 default pre-V4
        cf_length_bits = None
        if self.v in (4, 5):
            cf = g(Name("CF")) or {}
            stmf = g(Name("StmF"), Name("Identity"))
            strf = g(Name("StrF"), Name("Identity"))
            # a named-but-missing crypt filter means a broken/exotic file;
            # fall back to the version's canonical method (V4: RC4, V5:
            # AESV3) rather than Identity, which would pass ciphertext
            # through as if plaintext
            default_cfm = "AESV3" if self.v == 5 else "V2"

            cf_lengths: dict = {}

            def cfm_of(fname):
                if fname == Name("Identity"):
                    return "Identity"
                spec = resolve(cf.get(fname)) if isinstance(cf, dict) else None
                if not isinstance(spec, dict):
                    return default_cfm
                ln = resolve(spec.get(Name("Length")))
                if isinstance(ln, (int, float)):
                    # the CF /Length is in BYTES (<= 32); some writers put
                    # bits there anyway — normalize
                    ln = int(ln)
                    cf_lengths[fname] = ln if ln > 40 else ln * 8
                m = resolve(spec.get(Name("CFM")))
                return str(m) if m is not None else default_cfm

            self.stm_cfm = cfm_of(stmf)
            self.str_cfm = cfm_of(strf)
            # one file key serves both filters; when their /Length entries
            # disagree prefer the STREAM filter's (streams carry the page
            # content this handler exists to decrypt)
            cf_length_bits = cf_lengths.get(stmf, cf_lengths.get(strf))

        if self.v == 5:
            ue = g(Name("UE"))
            self.ue = bytes(ue) if isinstance(ue, bytes) else b""
            self._init_v5(bytes(o), bytes(u))
            return
        if self.v not in (1, 2, 4) or self.r not in (2, 3, 4):
            raise UnsupportedEncryption(f"V={self.v} R={self.r}")
        if self.v == 4 and cf_length_bits and length_bits <= 40:
            # V4 files may carry the key length only inside the crypt
            # filter dict (top-level /Length is optional past V2/V3)
            length_bits = cf_length_bits
        n = 5 if self.r == 2 else max(5, min(16, length_bits // 8))
        # Algorithm 2: file key from the (empty) user password
        h = hashlib.md5()
        h.update(_PAD)
        h.update(bytes(o)[:32])
        h.update(struct.pack("<i", p))
        h.update(bytes(id0))
        if self.r >= 4 and g(Name("EncryptMetadata"), True) is False:
            h.update(b"\xff\xff\xff\xff")
        key = h.digest()
        if self.r >= 3:
            for _ in range(50):
                key = hashlib.md5(key[:n]).digest()
        self.key = key[:n]
        # Algorithm 6: verify the empty user password against /U
        if self.r == 2:
            expect = rc4(self.key, _PAD)
            ok = expect == bytes(u)[:32]
        else:
            digest = hashlib.md5(_PAD + bytes(id0)).digest()
            ciph = rc4(self.key, digest)
            for i in range(1, 20):
                step = bytes(b ^ i for b in self.key)
                ciph = rc4(step, ciph)
            ok = ciph[:16] == bytes(u)[:16]
        if not ok:
            raise UnsupportedEncryption("user password required")

    def _init_v5(self, o: bytes, u: bytes):
        """AES-256 (R=5 legacy / R=6 ISO). Empty user password."""
        if self.r not in (5, 6):
            raise UnsupportedEncryption(f"V=5 R={self.r}")
        if len(u) < 48:
            raise UnsupportedEncryption("short /U entry")
        vsalt, ksalt = u[32:40], u[40:48]
        if self.r == 5:
            ok = hashlib.sha256(b"" + vsalt).digest() == u[:32]
            inter = hashlib.sha256(b"" + ksalt).digest()
        else:
            ok = _hash_r6(b"", vsalt, b"") == u[:32]
            inter = _hash_r6(b"", ksalt, b"")
        if not ok:
            raise UnsupportedEncryption("user password required")
        ue = self.ue
        if len(ue) < 32:
            raise UnsupportedEncryption("missing /UE entry")
        self.key = _aes_cbc_decrypt(inter, b"\x00" * 16, ue[:32])

    # -- per-object keys ---------------------------------------------------

    def _object_key(self, num: int, gen: int, aes: bool) -> bytes:
        if self.v == 5:
            return self.key  # AES-256 uses the file key directly
        h = hashlib.md5()
        h.update(self.key)
        h.update(struct.pack("<i", num)[:3])
        h.update(struct.pack("<i", gen)[:2])
        if aes:
            h.update(b"sAlT")
        return h.digest()[: min(len(self.key) + 5, 16)]

    def _apply(self, cfm: str, data: bytes, num: int, gen: int) -> bytes:
        if cfm == "Identity" or not data:
            return data
        if cfm in ("AESV2", "AESV3"):
            key = self._object_key(num, gen, aes=True)
            if len(data) < 16:
                return b""
            return _strip_pkcs5(_aes_cbc_decrypt(key, data[:16], data[16:]))
        # RC4 ("V2" crypt filter or pre-V4 default)
        return rc4(self._object_key(num, gen, aes=False), data)

    def decrypt_string(self, data: bytes, num: int, gen: int) -> bytes:
        return self._apply(self.str_cfm, data, num, gen)

    def decrypt_stream(self, data: bytes, num: int, gen: int) -> bytes:
        return self._apply(self.stm_cfm, data, num, gen)


def make_security_handler(encrypt_dict: dict, id0: bytes, resolve):
    """Build a handler for the trailer's /Encrypt dict; raises
    UnsupportedEncryption when transparent decryption is impossible."""
    return StandardSecurityHandler(encrypt_dict, id0, resolve)
