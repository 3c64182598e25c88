"""CCITT Group 4 (ITU-T T.6) fax decoding for embedded PDF images.

Bitonal scans in real archives (the reference's data source is archive.org
— reference scripts/internet_archive_downloader.py) are predominantly
/CCITTFaxDecode images; poppler decodes them natively
(reference karanta/data/process_pdf_utils.py:56-74). This pure-Python
decoder covers the dominant case — K < 0 (pure 2D / Group 4), the PDF
default for scanned bitonal pages — so the poppler-free renderer can
rasterize them. K >= 0 (Group 3) streams degrade as before (undecodable
image -> positioned-text / blank render).

Output convention: 1 = black, matching CCITT itself. The PDF-level
/BlackIs1 (default false: 0-bits are black in the DECODED stream) applies
to the *stream bytes*, not these run-lengths; callers map to pixels via
`to_pil` which takes the flag.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# ITU-T T.4 modified-Huffman run-length codes: code-string -> run length.
_WHITE_CODES = {
    "00110101": 0, "000111": 1, "0111": 2, "1000": 3, "1011": 4, "1100": 5,
    "1110": 6, "1111": 7, "10011": 8, "10100": 9, "00111": 10, "01000": 11,
    "001000": 12, "000011": 13, "110100": 14, "110101": 15, "101010": 16,
    "101011": 17, "0100111": 18, "0001100": 19, "0001000": 20,
    "0010111": 21, "0000011": 22, "0000100": 23, "0101000": 24,
    "0101011": 25, "0010011": 26, "0100100": 27, "0011000": 28,
    "00000010": 29, "00000011": 30, "00011010": 31, "00011011": 32,
    "00010010": 33, "00010011": 34, "00010100": 35, "00010101": 36,
    "00010110": 37, "00010111": 38, "00101000": 39, "00101001": 40,
    "00101010": 41, "00101011": 42, "00101100": 43, "00101101": 44,
    "00000100": 45, "00000101": 46, "00001010": 47, "00001011": 48,
    "01010010": 49, "01010011": 50, "01010100": 51, "01010101": 52,
    "00100100": 53, "00100101": 54, "01011000": 55, "01011001": 56,
    "01011010": 57, "01011011": 58, "01001010": 59, "01001011": 60,
    "00110010": 61, "00110011": 62, "00110100": 63,
    # makeup codes
    "11011": 64, "10010": 128, "010111": 192, "0110111": 256,
    "00110110": 320, "00110111": 384, "01100100": 448, "01100101": 512,
    "01101000": 576, "01100111": 640, "011001100": 704, "011001101": 768,
    "011010010": 832, "011010011": 896, "011010100": 960, "011010101": 1024,
    "011010110": 1088, "011010111": 1152, "011011000": 1216,
    "011011001": 1280, "011011010": 1344, "011011011": 1408,
    "010011000": 1472, "010011001": 1536, "010011010": 1600, "011000": 1664,
    "010011011": 1728,
}

_BLACK_CODES = {
    "0000110111": 0, "010": 1, "11": 2, "10": 3, "011": 4, "0011": 5,
    "0010": 6, "00011": 7, "000101": 8, "000100": 9, "0000100": 10,
    "0000101": 11, "0000111": 12, "00000100": 13, "00000111": 14,
    "000011000": 15, "0000010111": 16, "0000011000": 17, "0000001000": 18,
    "00001100111": 19, "00001101000": 20, "00001101100": 21,
    "00000110111": 22, "00000101000": 23, "00000010111": 24,
    "00000011000": 25, "000011001010": 26, "000011001011": 27,
    "000011001100": 28, "000011001101": 29, "000001101000": 30,
    "000001101001": 31, "000001101010": 32, "000001101011": 33,
    "000011010010": 34, "000011010011": 35, "000011010100": 36,
    "000011010101": 37, "000011010110": 38, "000011010111": 39,
    "000001101100": 40, "000001101101": 41, "000011011010": 42,
    "000011011011": 43, "000001010100": 44, "000001010101": 45,
    "000001010110": 46, "000001010111": 47, "000001100100": 48,
    "000001100101": 49, "000001010010": 50, "000001010011": 51,
    "000000100100": 52, "000000110111": 53, "000000111000": 54,
    "000000100111": 55, "000000101000": 56, "000001011000": 57,
    "000001011001": 58, "000000101011": 59, "000000101100": 60,
    "000001011010": 61, "000001100110": 62, "000001100111": 63,
    # makeup codes
    "0000001111": 64, "000011001000": 128, "000011001001": 192,
    "000001011011": 256, "000000110011": 320, "000000110100": 384,
    "000000110101": 448, "0000001101100": 512, "0000001101101": 576,
    "0000001001010": 640, "0000001001011": 704, "0000001001100": 768,
    "0000001001101": 832, "0000001110010": 896, "0000001110011": 960,
    "0000001110100": 1024, "0000001110101": 1088, "0000001110110": 1152,
    "0000001110111": 1216, "0000001010010": 1280, "0000001010011": 1344,
    "0000001010100": 1408, "0000001010101": 1472, "0000001011010": 1536,
    "0000001011011": 1600, "0000001100100": 1664, "0000001100101": 1728,
}

# extended makeup codes, shared by both colors
_EXT_CODES = {
    "00000001000": 1792, "00000001100": 1856, "00000001101": 1920,
    "000000010010": 1984, "000000010011": 2048, "000000010100": 2112,
    "000000010101": 2176, "000000010110": 2240, "000000010111": 2304,
    "000000011100": 2368, "000000011101": 2432, "000000011110": 2496,
    "000000011111": 2560,
}

_WHITE_ALL = {**_WHITE_CODES, **_EXT_CODES}
_BLACK_ALL = {**_BLACK_CODES, **_EXT_CODES}
_MAX_CODE_LEN = 14

# 2D mode codes (T.6): prefix -> (mode, vertical offset)
_MODES = {
    "1": ("V", 0), "011": ("V", 1), "010": ("V", -1), "001": ("H", 0),
    "0001": ("P", 0), "000011": ("V", 2), "000010": ("V", -2),
    "0000011": ("V", 3), "0000010": ("V", -3),
}
_EOL = "000000000001"


class CCITTError(Exception):
    pass


class _Bits:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position

    def read_bit(self) -> Optional[int]:
        byte = self.pos >> 3
        if byte >= len(self.data):
            return None
        bit = (self.data[byte] >> (7 - (self.pos & 7))) & 1
        self.pos += 1
        return bit

    def exhausted(self) -> bool:
        return (self.pos >> 3) >= len(self.data)


def _read_mode(bits: _Bits):
    """Next 2D mode code, or None at clean end-of-data / EOFB (tolerating
    fill bits: >= 11 zeros followed by 1 is an EOL; zeros to end-of-data is
    a clean stop)."""
    code = ""
    zeros = 0
    for _ in range(64):
        b = bits.read_bit()
        if b is None:
            return None
        if b == 0:
            zeros += 1
        elif zeros >= 11:
            return None  # (fill-padded) EOL -> EOFB/RTC region, stop
        code += str(b)
        if code in _MODES:
            return _MODES[code]
        if len(code) >= 8 and "1" in code:
            break
    raise CCITTError(f"bad 2D mode code {code!r}")


def _read_run(bits: _Bits, black: bool) -> int:
    """One full run length: makeup codes accumulate until a terminator."""
    table = _BLACK_ALL if black else _WHITE_ALL
    total = 0
    while True:
        code = ""
        while len(code) <= _MAX_CODE_LEN:
            b = bits.read_bit()
            if b is None:
                raise CCITTError("truncated run code")
            code += str(b)
            if code in table:
                break
        else:
            raise CCITTError(f"bad {'black' if black else 'white'} "
                             f"run code {code!r}")
        run = table[code]
        total += run
        if run < 64:  # terminating code
            return total


def _line_ref(line: np.ndarray, columns: int) -> list:
    """Changing-element positions of a decoded line (for 2D reference)."""
    return (np.flatnonzero(np.diff(
        np.concatenate(([0], line)))).tolist() + [columns, columns])


def decode_g4(data: bytes, columns: int,
              rows: Optional[int] = None) -> np.ndarray:
    """Decode a pure-2D (K < 0) CCITT stream -> (rows, columns) uint8 array
    with 1 = black. Stops at EOFB, the requested row count, or clean end of
    data; malformed codes raise CCITTError."""
    if columns <= 0:
        raise CCITTError("columns must be positive")
    bits = _Bits(data)
    ref = [columns, columns]  # imaginary all-white reference line
    lines: list[np.ndarray] = []
    while rows is None or len(lines) < rows:
        line = _decode_2d_line(bits, columns, ref)
        if line is None:
            break  # clean end of data / EOFB
        lines.append(line)
        ref = _line_ref(line, columns)
        if bits.exhausted():
            break
    if rows is not None and lines:
        pad = np.zeros((columns,), np.uint8)
        while len(lines) < rows:
            lines.append(pad)
    return np.stack(lines) if lines else np.zeros((0, columns), np.uint8)


def _skip_eol(bits: _Bits) -> bool:
    """Consume an optional EOL (11 zero-tolerant '000000000001'); returns
    False at end of data."""
    save = bits.pos
    zeros = 0
    while True:
        b = bits.read_bit()
        if b is None:
            return False
        if b == 0:
            zeros += 1
            continue
        if zeros >= 11:
            return True  # consumed an EOL
        bits.pos = save
        return True


def _decode_1d_line(bits: _Bits, columns: int) -> Optional[np.ndarray]:
    """One MH-coded line (alternating white/black runs, starts white)."""
    line = np.zeros((columns,), np.uint8)
    pos = 0
    color = 0
    while pos < columns:
        try:
            run = _read_run(bits, black=bool(color))
        except CCITTError:
            if pos == 0:
                return None  # clean end of data between lines
            raise
        end = min(pos + run, columns)
        if color:
            line[pos:end] = 1
        pos = end
        color ^= 1
    return line


def decode_g3(data: bytes, columns: int, rows: Optional[int] = None,
              two_d: bool = False) -> np.ndarray:
    """Group 3 decode: K = 0 (pure 1D MH) or K > 0 (`two_d`: each line is
    prefixed, after its EOL, by one bit — 1 = 1D, 0 = 2D-coded against the
    previous line). Lines are EOL-separated (EOLs optional in PDF K=0
    streams)."""
    if columns <= 0:
        raise CCITTError("columns must be positive")
    bits = _Bits(data)
    lines: list[np.ndarray] = []
    prev: Optional[np.ndarray] = None
    while rows is None or len(lines) < rows:
        if not _skip_eol(bits) or bits.exhausted():
            break
        if two_d:
            tag = bits.read_bit()
            if tag is None:
                break
            if tag == 0 and prev is not None:
                # 2D line against the previous row: the shared G4 machinery
                line = _decode_2d_line(bits, columns,
                                       _line_ref(prev, columns))
                if line is None:
                    break
                lines.append(line)
                prev = line
                continue
        line = _decode_1d_line(bits, columns)
        if line is None:
            break
        lines.append(line)
        prev = line
    if rows is not None and lines:
        pad = np.zeros((columns,), np.uint8)
        while len(lines) < rows:
            lines.append(pad)
    return np.stack(lines) if lines else np.zeros((0, columns), np.uint8)


def _decode_2d_line(bits: _Bits, columns: int,
                    ref: list) -> Optional[np.ndarray]:
    """One 2D-coded line against reference-line transitions (shared by
    decode_g4 and G3 K>0). Returns None on a clean stop BETWEEN lines
    (end of data / EOFB); raises CCITTError when data runs out mid-line."""
    cur: list[int] = []
    a0 = -1
    color = 0
    started = False
    while a0 < columns:
        mode = _read_mode(bits)
        if mode is None:
            if started:
                raise CCITTError("truncated mid-line")
            return None
        started = True
        kind, dv = mode
        i = 0
        while i < len(ref) and ref[i] <= a0:
            i += 1
        if (i & 1) != color:
            i += 1
        b1 = ref[i] if i < len(ref) else columns
        b2 = ref[i + 1] if i + 1 < len(ref) else columns
        if kind == "P":
            a0 = b2
        elif kind == "H":
            start = a0 if a0 > 0 else 0
            r1 = _read_run(bits, black=bool(color))
            r2 = _read_run(bits, black=not bool(color))
            a1 = min(start + r1, columns)
            cur.extend((a1, min(a1 + r2, columns)))
            a0 = cur[-1]
        else:
            a1 = max(0, min(b1 + dv, columns))
            cur.append(a1)
            a0 = a1
            color ^= 1
    line = np.zeros((columns,), np.uint8)
    for j in range(0, len(cur) - 1, 2):
        if cur[j + 1] > cur[j]:
            line[cur[j]:min(cur[j + 1], columns)] = 1
    if len(cur) & 1 and cur[-1] < columns:
        line[cur[-1]:] = 1
    return line


def to_pil(bitmap: np.ndarray, black_is_1: bool = False):
    """(rows, cols) 1=black bitmap -> PIL 'L' image (0 = black ink).

    black_is_1 is the PDF /BlackIs1 flag semantics applied at the PIXEL
    level for consumers that treat the decoded stream as imagedata."""
    from PIL import Image

    del black_is_1  # run-length output is color-explicit; flag kept for API
    return Image.fromarray(np.where(bitmap > 0, 0, 255).astype(np.uint8),
                           mode="L")
