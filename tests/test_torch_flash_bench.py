"""The measuring tools of the window kernel (#1), the flash kernel (#2),
the int8 decode kernel (#3) and the verify body's kernels (#4, #7, #6) on
the CPU: the instrumented copies that bench/flash_trace.py builds, and the
work bench/flash_ab.py divides by. The tools themselves run on the card."""

import numpy as np
import pytest

from karanta_tpu_torch.bench import flash_ab, flash_trace
from karanta_tpu_torch.kernels.build import CSRC


def test_flash_trace_instruments_the_kernel():
    """Every phase's reading lands once in the tree's flash_attention.cu:
    nine in the key-tile loop, one before it and one after the stores; the
    two C entries are exported."""
    out = flash_trace.instrument((CSRC / "flash_attention.cu").read_text())
    for k in range(len(flash_trace.PHASES)):
        assert out.count(f"FT_STAMP({k});") == 1, k
    assert "karanta_ftrace_reset" in out and "karanta_ftrace_read" in out


def test_flash_trace_refuses_a_source_without_its_anchors():
    src = (CSRC / "flash_attention.cu").read_text()
    with pytest.raises(ValueError, match="flash_trace"):
        flash_trace.instrument(src.replace("wgmma_wait<1>();", "wgmma_wait<0>();"))


@pytest.mark.parametrize("causal,q_offset", [(False, 0), (True, 0),
                                             (True, 37)])
def test_flash_work_counts_the_live_pairs(causal, q_offset):
    """Bytes and flops of flash_ab.flash_work against a count of the
    (query, key) pairs a mask of leading live keys and the diagonal leave."""
    sq, sk, h, kvh, d = 50, 90, 6, 2, 16
    lives = [90, 33, 1]
    n_bytes, flops = flash_ab.flash_work(sq, sk, h, kvh, d, lives, causal,
                                         q_offset)
    pairs = 0
    for live in lives:
        rows = q_offset + np.arange(sq)[:, None]
        cols = np.arange(sk)[None, :]
        ok = np.broadcast_to(cols < live, (sq, sk))
        if causal:
            ok = ok & (cols <= rows)
        pairs += int(ok.sum())
    assert flops == 4.0 * d * h * pairs
    assert n_bytes == len(lives) * ((2 * sq * h * d + 2 * sk * kvh * d) * 2
                                    + sk * 4)


def test_flash_trace_instruments_the_int8_decode_kernel():
    """Every phase's reading of #3's trace lands once in the tree's
    decode_append_quant.cu and its walker's pieces (quant_tma.cuh), the
    producer's and the consumer's sums are stored, and the two C entries
    are exported."""
    out = flash_trace.instrument_decode(
        (CSRC / "decode_append_quant.cu").read_text())
    for k in range(len(flash_trace.DECODE_PHASES)):
        assert out.count(f"FT_STAMP({k});") == 1, k
    assert out.count("karanta_ftrace[ft_slot") == 2
    assert "karanta_ftrace_reset" in out and "karanta_ftrace_read" in out


def test_flash_trace_refuses_a_decode_source_without_its_anchors():
    src = (CSRC / "decode_append_quant.cu").read_text()
    header = (CSRC / "quant_tma.cuh").read_text()
    with pytest.raises(ValueError, match="flash_trace"):
        flash_trace.instrument_decode(
            src, header.replace("mbar_wait(&seg_full[p], (seg >> 1) & 1);",
                                ""))
    with pytest.raises(ValueError, match="flash_trace"):
        flash_trace.instrument_decode(
            src.replace("  if (static_cast<int>(blockIdx.x) >= n_items) "
                        "return;\n", ""), header)


@pytest.mark.parametrize("kvh,lens", [(4, [0, 700, 1919, 1390]),
                                      (2, [5, 0, 1, 33]), (1, [1650] * 3)])
def test_decode_work_counts_the_live_rows(kvh, lens):
    """Bytes of flash_ab.decode_work (what #3's bound divides by) against a
    count over every slot, kv head and live row: its int8 K and V bytes and
    two bf16 scales; per slot and kv head the new K/V rows and scales read
    and written; q read and the output written."""
    d, g = 16, 7
    b, h = len(lens), kvh * g
    n = 0
    for live in lens:
        for _ in range(kvh):
            n += sum(2 * d + 2 * 2 for _ in range(live))  # cache rows + scales
            n += 2 * (2 * d + 2 * 2)                      # new rows in + out
    n += b * h * d * 2 * 2                                # q in, attn out
    assert flash_ab.decode_work(b, kvh, h, d, lens) == n


def test_flash_trace_instruments_the_verify_kernels():
    """Every phase's reading of the verify trace lands once in the tree's
    verify_tma.cuh (the one body of #4, #7 and #6, which their sources
    include),
    the producer's and the consumers' sums are stored, and the two C entries
    are appended to the source."""
    out = flash_trace.instrument_verify(
        (CSRC / flash_trace.VERIFY_HEADER).read_text())
    for k in range(len(flash_trace.VERIFY_PHASES)):
        assert out.count(f"FT_STAMP({k});") == 1, k
    assert out.count("karanta_ftrace[ft_slot") == 2
    for source in flash_ab.VERIFY_SOURCES.values():
        text = (CSRC / f"{source}.cu").read_text()
        assert f'#include "{flash_trace.VERIFY_HEADER}"' in text


def test_flash_trace_refuses_a_verify_source_without_its_anchors():
    src = (CSRC / flash_trace.VERIFY_HEADER).read_text()
    with pytest.raises(ValueError, match="flash_trace"):
        flash_trace.instrument_verify(
            src.replace("// P is whole", "// P is complete"))


def _q4_rows_holding(n: int) -> int:
    """Packed int4 rows (32 a 64-token window) that hold a token below n,
    counted row by row: row 32 w + r holds tokens 64 w + r and 64 w + 32 + r."""
    return sum(1 for row in range(n) if 64 * (row // 32) + row % 32 < n)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("kvh,tq,lens", [(4, 4, [0, 1700, 2100, 4091]),
                                         (2, 2, [5, 0, 1, 33, 64, 95]),
                                         (1, 4, [1650] * 3)])
def test_verify_work_counts_the_live_rows(bits, kvh, tq, lens):
    """Bytes of flash_ab.verify_work (what #4's and #7's bound divides by)
    against a count over every slot, kv head and stored row: its K and V
    bytes (int8 rows one token each; packed int4 rows holding a live
    token), two bf16 scales per live token; per slot and kv head the T fresh
    rows and scales read and written; q read and the output written."""
    d, g = 16, 7
    b, h = len(lens), kvh * g
    n = 0
    for live in lens:
        rows = live if bits == 8 else _q4_rows_holding(live)
        for _ in range(kvh):
            n += rows * 2 * d + live * 2 * 2          # cache rows + scales
            n += tq * 2 * (2 * d + 2 * 2)             # fresh rows in + out
    n += b * tq * h * d * 2 * 2                       # q in, attn out
    assert flash_ab.verify_work(b, kvh, h, d, tq, lens, bits) == n


@pytest.mark.parametrize("kernel", ["3", "6"])
def test_verify_runs_smoke_shapes_take_the_verify_kernels_only(kernel):
    """--smoke-shapes sweeps the shapes of the kernels on the verify body
    from flash_ab (#4, #7 and, at T = 1, #6): #3's sweep refuses it before
    it looks for a card; #6's takes it and stops only for want of one."""
    from karanta_tpu_torch.bench import verify_runs
    with pytest.raises(SystemExit) as err:
        verify_runs.main(["--kernel", kernel, "--smoke-shapes"])
    if kernel == "3":
        assert err.value.code == 2
    else:
        assert "no CUDA device" in str(err.value.code)


def test_q4_decode_shapes_are_the_smokes():
    """flash_ab's #6 shapes are chip_smoke.py's: B = 4 over 2,048 tokens at
    its lengths, B = 8 over 4,096 with its ragged lengths (seed 17), one
    rank's B and kv heads over 2,048 tokens at its lengths; every length
    below M; and the bound's bytes at T = 1 are the smoke's count."""
    import chip_smoke

    shapes = flash_ab.q4_decode_shapes()
    assert shapes["b4"] == (4, 4, 1, 2048, [0, 700, 1919, 1390])
    rng = np.random.default_rng(17)
    lens8 = [0, 4095] + sorted(int(x) for x in rng.integers(1, 4095, 6))
    assert shapes["b8"] == (8, 4, 1, 4096, lens8)
    rank = [0, 700, 1390, 2048 - chip_smoke.PER_RANK_T - 1]
    for tp in chip_smoke.PER_RANK_TP:
        assert shapes[f"tp{tp}"] == (chip_smoke.PER_RANK_B, 4 // tp, 1, 2048,
                                     rank)
    for b, kvh, tq, m, lens in shapes.values():
        assert tq == 1 and len(lens) == b and max(lens) <= m - 1
        assert flash_ab.verify_work(b, kvh, 7 * kvh, 128, 1, lens, 4) == (
            chip_smoke._q4_bytes(lens, kvh, 128, 7 * kvh, b, 1))


def test_flash_trace_instruments_the_window_kernel():
    """Every phase's reading of #1's trace lands once in the tree's
    window_attention.cu, the producer's and the consumers' sums are stored,
    and the two C entries are exported."""
    out = flash_trace.instrument_window(
        (CSRC / "window_attention.cu").read_text())
    for k in range(len(flash_trace.WINDOW_PHASES)):
        assert out.count(f"FT_STAMP({k});") == 1, k
    assert out.count("karanta_ftrace[ft_slot") == 2
    assert "karanta_ftrace_reset" in out and "karanta_ftrace_read" in out


def test_flash_trace_refuses_a_window_source_without_its_anchors():
    src = (CSRC / "window_attention.cu").read_text()
    with pytest.raises(ValueError, match="flash_trace"):
        flash_trace.instrument_window(
            src.replace("mbar_wait(&full[st], w.phase);", ""))


@pytest.mark.parametrize("rope", [False, True])
def test_window_work_counts_the_live_pairs(rope):
    """Bytes and flops of flash_ab.window_work (what #1's bound divides by)
    against a count over every (query, key) pair of a scattered mask with a
    dead window: a pair counts where the key is live and in the query's
    window; q, k, v and out move once, cos/sin once with rope, the mask."""
    b, s, h, d, w = 2, 192, 3, 16, 64
    rng = np.random.default_rng(5)
    mask = (rng.random((b, s)) > 0.3).astype(np.float32)
    mask[1, 64:128] = 0.0
    n_bytes, flops = flash_ab.window_work(b, s, h, d, w, mask, rope)
    pairs = 0
    for bb in range(b):
        for i in range(s):
            for j in range(s):
                pairs += int(i // w == j // w and mask[bb, j] > 0)
    assert flops == 4.0 * d * h * pairs
    assert n_bytes == (4 * b * s * h * d * 2 + (2 * b * s * d * 4 if rope
                                                else 0) + b * s * 4)
    # every key live, no mask read
    n_bytes, flops = flash_ab.window_work(b, s, h, d, w, None, rope)
    assert flops == 4.0 * d * h * b * s * w
    assert n_bytes == 4 * b * s * h * d * 2 + (2 * b * s * d * 4 if rope
                                               else 0)
