"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and skip without one. They import neither
JAX nor the JAX package, so the GPU machine (which has no JAX) runs them
with the JAX-pinning conftest switched off:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: 2e-5 in float32 (summation order only); in bf16, per element
2^-7 |want| + 2^-9 max|want| (kernel and plain version each round the
float32 result to bf16 once, so they may differ by one ulp, at most 2^-7 of
the element); int8 caches bit-equal.
"""

import numpy as np
import pytest
import torch

from karanta_tpu_torch.ops import attention as A
from karanta_tpu_torch.ops import decode_attention as DA
from karanta_tpu_torch.ops.rotary import vision_rope_cos_sin

pytestmark = pytest.mark.gpu

DTYPES = [torch.float32, torch.bfloat16]

FLASH_CASES = [
    # (b, sq, sk, h, kvh, d, causal, mask, q_offset); mask None, "tail" (the
    # last batch row's final fifth), "scattered" (the vision page's pattern:
    # isolated holes, a whole dead run and a dead tail) or "all" (the last
    # batch row has no live key, so its rows average V uniformly)
    (1, 128, 128, 2, 2, 64, False, None, 0),
    (1, 128, 128, 2, 2, 64, True, None, 0),
    (2, 200, 200, 4, 2, 32, True, "tail", 0),
    (1, 96, 160, 4, 1, 16, True, "tail", 64),
    (2, 130, 130, 6, 2, 80, False, "tail", 0),
    (1, 300, 300, 7, 1, 128, True, "tail", 0),
    # prefix continuation: queries over the suffix, keys prefix + suffix,
    # q_offset = prefix length, the suffix's padded tail masked
    (1, 256, 640, 7, 1, 128, True, "tail", 384),
    # vision full layer: D = 80, the page's scattered mask, several tiles
    (1, 640, 640, 4, 4, 80, False, "scattered", 0),
    # decoder: D = 128, G = 7, causal, Sq not a multiple of 128, Sk < a tile
    (1, 300, 40, 7, 1, 128, True, "tail", 0),
    # prefix continuation with q_offset and Sk off the 64-key tile
    (1, 200, 517, 7, 1, 128, True, "tail", 317),
    # a batch row whose every key is masked
    (2, 150, 100, 4, 2, 64, False, "all", 0),
] + [
    # each head dim over many tiles (the cp.async ring wraps), GQA, causal
    # at a q_offset, scattered mask
    (1, 257, 400, 4, 2, d, True, "scattered", 143)
    for d in A.FLASH_HEAD_DIMS]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are compiled and run "
                    "only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, shape, dev, dtype):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def _assert_close(got, want, dtype):
    got, want = got.float().cpu(), want.float().cpu()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=2e-5)
        return
    limit = 2.0 ** -7 * want.abs() + 2.0 ** -9 * want.abs().max()
    excess = (got - want).abs() - limit
    assert torch.isfinite(got).all() and (excess <= 0).all(), (
        f"max excess over the bf16 limit {float(excess.max()):.3e}")


def _flash_mask(gen, kind, b, sk, dev):
    if kind is None:
        return None
    mask = torch.ones(b, sk, device=dev)
    if kind == "tail":
        mask[-1, sk - sk // 5:] = 0.0
    elif kind == "scattered":
        mask = (torch.rand((b, sk), generator=gen, device=dev) > 0.25).float()
        mask[:, sk // 3:sk // 3 + 64] = 0.0
        mask[:, sk - sk // 7:] = 0.0
    else:  # "all"
        mask[-1] = 0.0
    return mask


def _flash_inputs(gen, case, dev, dtype):
    b, sq, sk, h, kvh, d, causal, kind, q_offset = case
    q = _randn(gen, (b, sq, h, d), dev, dtype)
    k = _randn(gen, (b, sk, kvh, d), dev, dtype)
    v = _randn(gen, (b, sk, kvh, d), dev, dtype)
    return q, k, v, _flash_mask(gen, kind, b, sk, dev)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_matches_plain(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(5)
    for case in FLASH_CASES:
        q, k, v, mask = _flash_inputs(gen, case, cuda, dtype)
        causal, q_offset = case[6], case[8]
        got = A.flash_attention(q, k, v, mask, causal=causal,
                                q_offset=q_offset)
        want = A.flash_attention_plain(q, k, v, mask, causal=causal,
                                       q_offset=q_offset)
        torch.cuda.synchronize()
        _assert_close(got, want, dtype)


def test_flash_kernel_is_deterministic(cuda):
    """Two calls give the same bits: no atomics, a fixed reduction order."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    for case in (FLASH_CASES[7], FLASH_CASES[9]):
        q, k, v, mask = _flash_inputs(gen, case, cuda, torch.bfloat16)
        first, second = (A.flash_attention(q, k, v, mask, causal=case[6],
                                           q_offset=case[8])
                         for _ in range(2))
        torch.cuda.synchronize()
        assert torch.equal(first, second)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rope", [False, True])
def test_window_kernel_matches_plain(cuda, dtype, rope):
    gen = torch.Generator(device=cuda).manual_seed(6)
    b, s, h, d, w = 1, 512, 4, 80, 64
    q, k, v = (_randn(gen, (b, s, h, d), cuda, dtype) for _ in range(3))
    mask = (torch.rand((b, s), generator=gen, device=cuda) > 0.1).float()
    mask[0, 128:192] = 0.0  # a window with no live key: outputs unspecified
    cos = sin = None
    if rope:
        pos = torch.randint(0, 40, (s, 2), generator=gen, device=cuda)
        cos, sin = vision_rope_cos_sin(pos, d)
        cos, sin = cos[None].contiguous(), sin[None].contiguous()
    got = A.window_attention_kernel_call(q, k, v, w, mask, cos=cos, sin=sin)
    want = A.window_attention_plain(q, k, v, w, mask, cos=cos, sin=sin)
    torch.cuda.synchronize()
    rows = (mask.reshape(b, s // w, w).amax(-1) > 0).repeat_interleave(w, 1)
    _assert_close(got[rows], want[rows], dtype)


WINDOW_CASES = [
    # (b, s, h, d, w, rope): the vision width with a head count that does
    # not fill the kernel's head group, the narrowest and the widest window
    # (several 64-key score chunks), and head dims 16 and 64
    (1, 320, 3, 80, 64, True),
    (2, 256, 5, 80, 16, True),
    (1, 512, 2, 80, 256, True),
    (1, 256, 5, 16, 32, True),
    (2, 384, 4, 64, 128, False),
    (1, 512, 3, 16, 256, False),
    (1, 256, 16, 64, 64, True),
]


def _window_inputs(gen, case, dev, dtype):
    """q, k, v, a scattered mask whose second window has no live key, and
    the vision rope's cos/sin (or None)."""
    b, s, h, d, w, rope = case
    q, k, v = (_randn(gen, (b, s, h, d), dev, dtype) for _ in range(3))
    mask = (torch.rand((b, s), generator=gen, device=dev) > 0.25).float()
    mask[:, w:2 * w] = 0.0
    cos = sin = None
    if rope:
        pos = torch.randint(0, 40, (s, 2), generator=gen, device=dev)
        cos, sin = vision_rope_cos_sin(pos, d)
        cos = cos[None].expand(b, -1, -1).contiguous()
        sin = sin[None].expand(b, -1, -1).contiguous()
    return q, k, v, mask, cos, sin


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", WINDOW_CASES)
def test_window_kernel_shapes_match_plain(cuda, dtype, case):
    gen = torch.Generator(device=cuda).manual_seed(8)
    q, k, v, mask, cos, sin = _window_inputs(gen, case, cuda, dtype)
    b, s, w = case[0], case[1], case[4]
    got = A.window_attention_kernel_call(q, k, v, w, mask, cos=cos, sin=sin)
    want = A.window_attention_plain(q, k, v, w, mask, cos=cos, sin=sin)
    torch.cuda.synchronize()
    rows = (mask.reshape(b, s // w, w).amax(-1) > 0).repeat_interleave(w, 1)
    _assert_close(got[rows], want[rows], dtype)


def test_window_kernel_is_deterministic(cuda):
    """Two calls give the same bits (the 7B vision heads, rope, mask)."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    q, k, v, mask, cos, sin = _window_inputs(
        gen, (1, 512, 16, 80, 64, True), cuda, torch.bfloat16)
    first, second = (A.window_attention_kernel_call(q, k, v, 64, mask,
                                                    cos=cos, sin=sin)
                     for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_matches_plain(cuda, dtype):
    from karanta_tpu_torch.models.qwen25_vl.decoder import quantize_kv_rows

    gen = torch.Generator(device=cuda).manual_seed(11)
    n_layers, b, m, h, kvh, d = 2, 4, 256, 8, 2, 64

    def rows(shape):
        return torch.randn(shape, generator=gen, device=cuda)

    kq, ks = quantize_kv_rows(rows((n_layers, b, kvh, m, d)))
    vq, vs = quantize_kv_rows(rows((n_layers, b, kvh, m, d)))
    nkq, nks = quantize_kv_rows(rows((b, kvh, d)))
    nvq, nvs = quantize_kv_rows(rows((b, kvh, d)))
    q = rows((b, 1, h, d)).to(dtype)
    new = (nkq, nvq, nks.to(dtype), nvs.to(dtype))
    lens = torch.tensor([0, 5, 200, 255], dtype=torch.int32, device=cuda)
    a = [kq.clone(), vq.clone(), ks.to(dtype), vs.to(dtype)]
    c = [x.clone() for x in a]
    got = DA.paged_decode_append_quant(q, *new, *a, 1, lens)
    want = DA.paged_decode_append_quant_plain(q, *new, *c, 1, lens)
    torch.cuda.synchronize()
    _assert_close(got, want, dtype)
    for x, y in zip(a, c):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [
    # (layers, b, m, h, kvh, d, tq, lens): tiny config heads, then the 7B
    # verify pass (G = 7, T = 4) with cache_len 0 and M - T - 1
    (2, 4, 256, 4, 2, 16, 3, [0, 5, 200, 252]),
    (2, 4, 256, 4, 2, 16, 5, [31, 32, 63, 127]),
    (2, 4, 384, 28, 4, 128, 4, [0, 1, 200, 379]),
])
def test_multi_quant_kernel_matches_plain(cuda, dtype, shape):
    from karanta_tpu_torch.models.qwen25_vl.decoder import quantize_kv_rows

    n_layers, b, m, h, kvh, d, tq, lens = shape
    gen = torch.Generator(device=cuda).manual_seed(13)

    def rows(shape):
        return torch.randn(shape, generator=gen, device=cuda)

    kq, ks = quantize_kv_rows(rows((n_layers, b, kvh, m, d)))
    vq, vs = quantize_kv_rows(rows((n_layers, b, kvh, m, d)))
    nkq, nks = quantize_kv_rows(rows((b, tq, kvh, d)))
    nvq, nvs = quantize_kv_rows(rows((b, tq, kvh, d)))
    q = rows((b, tq, h, d)).to(dtype)
    new = (nkq, nvq, nks.to(dtype), nvs.to(dtype))
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    a = [kq.clone(), vq.clone(), ks.to(dtype), vs.to(dtype)]
    c = [x.clone() for x in a]
    got = DA.paged_decode_append_multi_quant(q, *new, *a, 1, lens)
    want = DA.paged_decode_append_multi_quant_plain(q, *new, *c, 1, lens)
    torch.cuda.synchronize()
    _assert_close(got, want, dtype)
    for x, y in zip(a, c):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [
    # (layers, b, m, h, kvh, d, lens)
    (2, 4, 256, 8, 2, 64, [0, 5, 200, 255]),
    (2, 3, 200, 4, 2, 16, [0, 77, 199]),
    (2, 6, 512, 28, 4, 128, [0, 1, 130, 300, 511, 64]),
])
def test_append_kernel_matches_plain(cuda, dtype, shape):
    n_layers, b, m, h, kvh, d, lens = shape
    gen = torch.Generator(device=cuda).manual_seed(17)
    k = _randn(gen, (n_layers, b, kvh, m, d), cuda, dtype)
    v = _randn(gen, (n_layers, b, kvh, m, d), cuda, dtype)
    nk = _randn(gen, (b, kvh, d), cuda, dtype)
    nv = _randn(gen, (b, kvh, d), cuda, dtype)
    q = _randn(gen, (b, 1, h, d), cuda, dtype)
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    a = [k.clone(), v.clone()]
    c = [k.clone(), v.clone()]
    got = DA.paged_decode_append(q, nk, nv, *a, 1, lens)
    want = DA.paged_decode_append_plain(q, nk, nv, *c, 1, lens)
    torch.cuda.synchronize()
    _assert_close(got, want, dtype)
    for x, y in zip(a, c):
        assert torch.equal(x, y)


def _q4_inputs(gen, dev, dtype, n_layers, b, kvh, m, d, lead):
    """Random int4 caches in the packed layout (random bytes: both nibbles
    in [-8, 7]), scales in [0.01, 0.1), and new rows quantized to int4."""
    from karanta_tpu_torch.models.qwen25_vl.decoder import quantize_kv_rows_q4

    def packed():
        return torch.randint(-128, 128, (n_layers, b, kvh, m // 2, d),
                             generator=gen, device=dev, dtype=torch.int8)

    def scales():
        return (torch.rand((n_layers, b, 2 * kvh, m // 2), generator=gen,
                           device=dev) * 0.09 + 0.01).to(dtype)

    nkq, nks = quantize_kv_rows_q4(torch.randn(lead + (kvh, d),
                                               generator=gen, device=dev))
    nvq, nvs = quantize_kv_rows_q4(torch.randn(lead + (kvh, d),
                                               generator=gen, device=dev))
    return ([packed(), packed(), scales(), scales()],
            (nkq, nvq, nks.to(dtype), nvs.to(dtype)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [
    # (layers, b, m, h, kvh, d, lens): the window and row-tile boundaries,
    # the JAX test's shape, the 7B heads
    (2, 8, 128, 4, 2, 16, [0, 1, 31, 32, 33, 63, 64, 127]),
    (2, 4, 256, 8, 2, 64, [0, 5, 200, 255]),
    (2, 4, 512, 28, 4, 128, [0, 95, 300, 511]),
])
def test_q4_kernel_matches_plain(cuda, dtype, shape):
    n_layers, b, m, h, kvh, d, lens = shape
    gen = torch.Generator(device=cuda).manual_seed(19)
    a, new = _q4_inputs(gen, cuda, dtype, n_layers, b, kvh, m, d, (b,))
    c = [x.clone() for x in a]
    q = _randn(gen, (b, 1, h, d), cuda, dtype)
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    got = DA.paged_decode_append_q4(q, *new, *a, 1, lens)
    want = DA.paged_decode_append_q4_plain(q, *new, *c, 1, lens)
    torch.cuda.synchronize()
    _assert_close(got, want, dtype)
    for x, y in zip(a, c):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [
    # (layers, b, m, h, kvh, d, tq, lens): the JAX test's window-crossing
    # spans (tiny heads), then the 7B verify pass at cache_len 0 and M - T - 1
    (2, 4, 256, 4, 2, 16, 5, [31, 32, 63, 127]),
    (2, 4, 256, 4, 2, 16, 4, [60, 62, 95, 126]),
    (2, 4, 256, 4, 2, 16, 3, [0, 5, 200, 248]),
    (2, 4, 512, 28, 4, 128, 4, [0, 61, 300, 507]),
])
def test_multi_q4_kernel_matches_plain(cuda, dtype, shape):
    n_layers, b, m, h, kvh, d, tq, lens = shape
    gen = torch.Generator(device=cuda).manual_seed(23)
    a, new = _q4_inputs(gen, cuda, dtype, n_layers, b, kvh, m, d, (b, tq))
    c = [x.clone() for x in a]
    q = _randn(gen, (b, tq, h, d), cuda, dtype)
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    got = DA.paged_decode_append_multi_q4(q, *new, *a, 1, lens)
    want = DA.paged_decode_append_multi_q4_plain(q, *new, *c, 1, lens)
    torch.cuda.synchronize()
    _assert_close(got, want, dtype)
    for x, y in zip(a, c):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [
    # (layers, b, m, h, kvh, d, lens)
    (3, 4, 512, 8, 2, 64, [5, 200, 511, 0]),
    (3, 4, 256, 4, 2, 16, [63, 64, 65, 255]),
    (3, 6, 512, 28, 4, 128, [0, 1, 130, 300, 511, 64]),
])
def test_read_only_kernels_match_plain(cuda, dtype, shape):
    """Kernels #8 (per-slot cache) and #9 (layer 2 of the stacked cache)
    against their plain version; neither writes the caches."""
    n_layers, b, m, h, kvh, d, lens = shape
    gen = torch.Generator(device=cuda).manual_seed(29)
    k = _randn(gen, (n_layers, b, kvh, m, d), cuda, dtype)
    v = _randn(gen, (n_layers, b, kvh, m, d), cuda, dtype)
    q = _randn(gen, (b, 1, h, d), cuda, dtype)
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    k0, v0 = k.clone(), v.clone()
    want = DA.paged_decode_attention_stacked_plain(q, k, v, 2, lens)
    got = DA.paged_decode_attention_stacked(q, k, v, 2, lens)
    per_slot = DA.paged_decode_attention(q, k[2].contiguous(),
                                         v[2].contiguous(), lens)
    torch.cuda.synchronize()
    _assert_close(got, want, dtype)
    _assert_close(per_slot, want, dtype)
    assert torch.equal(k, k0) and torch.equal(v, v0)


def _read_only_case(gen, dev, dtype, n_layers, b, kvh, g, m, d, lens):
    k = _randn(gen, (n_layers, b, kvh, m, d), dev, dtype)
    v = _randn(gen, (n_layers, b, kvh, m, d), dev, dtype)
    q = _randn(gen, (b, 1, kvh * g, d), dev, dtype)
    return q, k, v, torch.tensor(lens, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("g", [7, 8, 4, 2])
def test_read_only_kernels_split_boundaries(cuda, dtype, g):
    """D = 128 at layer 1 of 3, cache_len on each side of the bf16
    instance's run of R rows (R - 1 fills one run exactly, R starts a
    second with one row), 0 and M - 1."""
    r = DA.paged_decode_attention_info(128, g)["split_rows"]
    m = 4 * r
    lens = [r - 1, r, r + 1, 0, m - 1, r - 2, 2 * r, 3 * r + 5]
    gen = torch.Generator(device=cuda).manual_seed(31 + g)
    q, k, v, lens = _read_only_case(gen, cuda, dtype, 3, len(lens), 2, g, m,
                                    128, lens)
    k0, v0 = k.clone(), v.clone()
    want = DA.paged_decode_attention_stacked_plain(q, k, v, 1, lens)
    got = DA.paged_decode_attention_stacked(q, k, v, 1, lens)
    per_slot = DA.paged_decode_attention(q, k[1].contiguous(),
                                         v[1].contiguous(), lens)
    torch.cuda.synchronize()
    _assert_close(got, want, dtype)
    _assert_close(per_slot, want, dtype)
    assert torch.equal(k, k0) and torch.equal(v, v0)


def test_read_only_kernels_are_deterministic(cuda):
    """Two calls of #8 and of #9 give the same bits: the runs' partials
    merge in a fixed order, and each call leaves its counters at 0."""
    gen = torch.Generator(device=cuda).manual_seed(37)
    lens = torch.randint(0, 2048, (16,), generator=gen,
                         device=cuda).tolist()
    q, k, v, lens = _read_only_case(gen, cuda, torch.bfloat16, 2, 16, 4, 7,
                                    2048, 128, lens)
    k1, v1 = k[1].contiguous(), v[1].contiguous()
    for call in (lambda: DA.paged_decode_attention_stacked(q, k, v, 1, lens),
                 lambda: DA.paged_decode_attention(q, k1, v1, lens)):
        first, second = call(), call()
        torch.cuda.synchronize()
        assert torch.equal(first, second)


def _multi_quant_case(gen, dev, dtype, n_layers, b, kvh, g, tq, m, d, lens):
    """int8 caches, T new int8 rows per slot, q and lengths for kernel #4."""
    from karanta_tpu_torch.models.qwen25_vl.decoder import quantize_kv_rows

    def rows(shape):
        return torch.randn(shape, generator=gen, device=dev)

    kq, ks = quantize_kv_rows(rows((n_layers, b, kvh, m, d)))
    vq, vs = quantize_kv_rows(rows((n_layers, b, kvh, m, d)))
    nkq, nks = quantize_kv_rows(rows((b, tq, kvh, d)))
    nvq, nvs = quantize_kv_rows(rows((b, tq, kvh, d)))
    q = rows((b, tq, kvh * g, d)).to(dtype)
    return (q, (nkq, nvq, nks.to(dtype), nvs.to(dtype)),
            [kq, vq, ks.to(dtype), vs.to(dtype)],
            torch.tensor(lens, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("g,tq", [(7, 4), (8, 4), (7, 2), (2, 5)])
def test_multi_quant_kernel_split_boundaries(cuda, dtype, g, tq):
    """Kernel #4, D = 128 at layer 1 of 3, B = 7, M = 4096: cache_len on
    each side of the bf16 instance's run of R rows at this shape (R - 1
    fills one run short of a row, R fills it exactly, R + 1 starts a
    second), 2R, 3R + 5, 0 (run 0 only appends) and M - T - 1; all four
    caches bit-equal."""
    m, b = 4096, 7
    r = DA.paged_decode_append_multi_quant_info(128, g * tq, b, 2, m)["run_rows"]
    lens = [r - 1, r, r + 1, 2 * r, 3 * r + 5, 0, m - tq - 1]
    gen = torch.Generator(device=cuda).manual_seed(41 + g + tq)
    q, new, caches, lens = _multi_quant_case(gen, cuda, dtype, 3, b, 2, g, tq,
                                             m, 128, lens)
    a = [x.clone() for x in caches]
    got = DA.paged_decode_append_multi_quant(q, *new, *a, 1, lens)
    want = DA.paged_decode_append_multi_quant_plain(q, *new, *caches, 1, lens)
    torch.cuda.synchronize()
    _assert_close(got, want, dtype)
    for x, y in zip(a, caches):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("g", [7, 8, 4, 2])
def test_append_kernel_split_boundaries(cuda, dtype, g):
    """Kernel #5, D = 128 at layer 1 of 3: cache_len on each side of the
    bf16 instance's run of R rows, 2R, 0 (the output is the new V row) and
    M - 1; caches bit-equal."""
    r = DA.paged_decode_append_info(128, g)["split_rows"]
    m = 4 * r
    lens = [r - 1, r, r + 1, 2 * r, 0, m - 1]
    gen = torch.Generator(device=cuda).manual_seed(47 + g)
    b, kvh, d = len(lens), 2, 128
    k = _randn(gen, (3, b, kvh, m, d), cuda, dtype)
    v = _randn(gen, (3, b, kvh, m, d), cuda, dtype)
    nk = _randn(gen, (b, kvh, d), cuda, dtype)
    nv = _randn(gen, (b, kvh, d), cuda, dtype)
    q = _randn(gen, (b, 1, kvh * g, d), cuda, dtype)
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    a = [k.clone(), v.clone()]
    got = DA.paged_decode_append(q, nk, nv, *a, 1, lens)
    want = DA.paged_decode_append_plain(q, nk, nv, k, v, 1, lens)
    torch.cuda.synchronize()
    _assert_close(got, want, dtype)
    assert torch.equal(a[0], k) and torch.equal(a[1], v)


def test_multi_quant_kernel_is_deterministic(cuda):
    """Two calls of #4's bf16 instance give the same bits (and the same
    caches: the second call rewrites the same rows): the runs' partials
    merge in a fixed order."""
    gen = torch.Generator(device=cuda).manual_seed(53)
    lens = torch.randint(0, 2048 - 5, (8,), generator=gen,
                         device=cuda).tolist()
    q, new, caches, lens = _multi_quant_case(gen, cuda, torch.bfloat16, 2, 8,
                                             4, 7, 4, 2048, 128, lens)
    first = DA.paged_decode_append_multi_quant(q, *new, *caches, 1, lens)
    after_first = [x.clone() for x in caches]
    second = DA.paged_decode_append_multi_quant(q, *new, *caches, 1, lens)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    for x, y in zip(after_first, caches):
        assert torch.equal(x, y)


def test_append_kernel_is_deterministic(cuda):
    """Two calls of #5's bf16 instance give the same bits and caches."""
    gen = torch.Generator(device=cuda).manual_seed(59)
    lens = torch.randint(0, 4095, (16,), generator=gen, device=cuda)
    lens = lens.to(torch.int32)
    q, k, v, _ = _read_only_case(gen, cuda, torch.bfloat16, 2, 16, 4, 7,
                                 4096, 128, [0] * 16)
    nk = _randn(gen, (16, 4, 128), cuda, torch.bfloat16)
    nv = _randn(gen, (16, 4, 128), cuda, torch.bfloat16)
    first = DA.paged_decode_append(q, nk, nv, k, v, 1, lens)
    k1, v1 = k.clone(), v.clone()
    second = DA.paged_decode_append(q, nk, nv, k, v, 1, lens)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(k, k1) and torch.equal(v, v1)


def test_split_kernels_leave_counters_zero(cuda):
    """Kernels #4, #5 and #9 one after another on one stream share the merge
    counters; each call leaves them at 0, and each output still meets its
    plain version."""
    gen = torch.Generator(device=cuda).manual_seed(61)
    m, tq = 4096, 4
    lens_l = [m - tq - 1, 3000, 1500, 0]
    q4, new4, c4, lens = _multi_quant_case(gen, cuda, torch.bfloat16, 2, 4, 4,
                                           7, tq, m, 128, lens_l)
    want4 = DA.paged_decode_append_multi_quant_plain(
        q4, *new4, *[x.clone() for x in c4], 1, lens)
    q, k, v, _ = _read_only_case(gen, cuda, torch.bfloat16, 2, 4, 4, 7, m,
                                 128, lens_l)
    nk = _randn(gen, (4, 4, 128), cuda, torch.bfloat16)
    nv = _randn(gen, (4, 4, 128), cuda, torch.bfloat16)
    want5 = DA.paged_decode_append_plain(q, nk, nv, k.clone(), v.clone(), 1,
                                         lens)
    got4 = DA.paged_decode_append_multi_quant(q4, *new4, *c4, 1, lens)
    got5 = DA.paged_decode_append(q, nk, nv, k, v, 1, lens)
    got9 = DA.paged_decode_attention_stacked(q, k, v, 1, lens)
    want9 = DA.paged_decode_attention_stacked_plain(q, k, v, 1, lens)
    torch.cuda.synchronize()
    counters = DA._SPLIT_COUNTERS[
        (q.device, torch.cuda.current_stream(q.device).cuda_stream)]
    assert int(counters.abs().sum()) == 0
    _assert_close(got4, want4, torch.bfloat16)
    _assert_close(got5, want5, torch.bfloat16)
    _assert_close(got9, want9, torch.bfloat16)


def _quant_case(gen, dev, dtype, n_layers, b, kvh, g, m, d, lens):
    """int8 caches, one new int8 row per slot, q and lengths for kernel
    #3."""
    from karanta_tpu_torch.models.qwen25_vl.decoder import quantize_kv_rows

    def rows(shape):
        return torch.randn(shape, generator=gen, device=dev)

    kq, ks = quantize_kv_rows(rows((n_layers, b, kvh, m, d)))
    vq, vs = quantize_kv_rows(rows((n_layers, b, kvh, m, d)))
    nkq, nks = quantize_kv_rows(rows((b, kvh, d)))
    nvq, nvs = quantize_kv_rows(rows((b, kvh, d)))
    q = rows((b, 1, kvh * g, d)).to(dtype)
    return (q, (nkq, nvq, nks.to(dtype), nvs.to(dtype)),
            [kq, vq, ks.to(dtype), vs.to(dtype)],
            torch.tensor(lens, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("g", [7, 8, 4, 2])
def test_quant_kernel_split_boundaries(cuda, dtype, g):
    """Kernel #3, D = 128 at layer 1 of 3, B = 7, M = 4096: cache_len on
    each side of the bf16 instance's run of R rows at this shape (R - 1,
    R, R + 1), 2R, 3R + 5, 0 (run 0 only appends) and M - 1; all four
    caches bit-equal."""
    m, b = 4096, 7
    r = DA.paged_decode_append_quant_info(128, g, b, 2, m)["run_rows"]
    lens = [r - 1, r, r + 1, 2 * r, 3 * r + 5, 0, m - 1]
    gen = torch.Generator(device=cuda).manual_seed(67 + g)
    q, new, caches, lens = _quant_case(gen, cuda, dtype, 3, b, 2, g, m, 128,
                                       lens)
    a = [x.clone() for x in caches]
    got = DA.paged_decode_append_quant(q, *new, *a, 1, lens)
    want = DA.paged_decode_append_quant_plain(q, *new, *caches, 1, lens)
    torch.cuda.synchronize()
    _assert_close(got, want, dtype)
    for x, y in zip(a, caches):
        assert torch.equal(x, y)


def test_quant_kernel_is_deterministic(cuda):
    """Two calls of #3's bf16 instance give the same bits and caches (the
    second call rewrites the same row)."""
    gen = torch.Generator(device=cuda).manual_seed(71)
    lens = torch.randint(0, 1919, (16,), generator=gen, device=cuda).tolist()
    q, new, caches, lens = _quant_case(gen, cuda, torch.bfloat16, 2, 16, 4, 7,
                                       1920, 128, lens)
    first = DA.paged_decode_append_quant(q, *new, *caches, 1, lens)
    after_first = [x.clone() for x in caches]
    second = DA.paged_decode_append_quant(q, *new, *caches, 1, lens)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    for x, y in zip(after_first, caches):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("g,tq", [(7, 4), (8, 4), (7, 2), (2, 5)])
def test_multi_q4_kernel_split_boundaries(cuda, dtype, g, tq):
    """Kernel #7, D = 128 at layer 1 of 3, M = 4096 tokens: cache_len on
    each side of the bf16 instance's run of R tokens at this shape (R - 1,
    R, R + 1), 2R, 3R + 5, 0 (run 0 only merges) and M - T - 1, then spans
    that cross the 32-row tile (R + 30) and the 64-token window (R + 62);
    all four caches bit-equal."""
    m, b = 4096, 9
    r = DA.paged_decode_append_multi_q4_info(128, g * tq, b, 2, m)[
        "run_tokens"]
    lens = [r - 1, r, r + 1, 2 * r, 3 * r + 5, 0, m - tq - 1, r + 30, r + 62]
    gen = torch.Generator(device=cuda).manual_seed(73 + g + tq)
    a, new = _q4_inputs(gen, cuda, dtype, 3, b, 2, m, 128, (b, tq))
    c = [x.clone() for x in a]
    q = _randn(gen, (b, tq, 2 * g, 128), cuda, dtype)
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    got = DA.paged_decode_append_multi_q4(q, *new, *a, 1, lens)
    want = DA.paged_decode_append_multi_q4_plain(q, *new, *c, 1, lens)
    torch.cuda.synchronize()
    _assert_close(got, want, dtype)
    for x, y in zip(a, c):
        assert torch.equal(x, y)


def test_multi_q4_kernel_is_deterministic(cuda):
    """Two calls of #7's bf16 instance give the same bits and caches (the
    second call merges the same nibbles again)."""
    gen = torch.Generator(device=cuda).manual_seed(79)
    lens = torch.randint(0, 4096 - 5, (8,), generator=gen,
                         device=cuda).to(torch.int32)
    a, new = _q4_inputs(gen, cuda, torch.bfloat16, 2, 8, 4, 4096, 128, (8, 4))
    q = _randn(gen, (8, 4, 28, 128), cuda, torch.bfloat16)
    first = DA.paged_decode_append_multi_q4(q, *new, *a, 1, lens)
    after_first = [x.clone() for x in a]
    second = DA.paged_decode_append_multi_q4(q, *new, *a, 1, lens)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    for x, y in zip(after_first, a):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("g", [7, 8, 4, 2])
def test_q4_kernel_split_boundaries(cuda, dtype, g):
    """Kernel #6, D = 128 at layer 1 of 3, M = 4096 tokens: cache_len on
    each side of the bf16 instance's run of R tokens at this shape (R - 1,
    R, R + 1), 2R, 3R + 5, 0 (run 0 only merges) and M - 1, then lengths
    whose window is half live (R + 30, R + 33) or nearly whole (R + 62);
    all four caches bit-equal."""
    m, b = 4096, 10
    r = DA.paged_decode_append_q4_info(128, g, b, 2, m)["run_tokens"]
    lens = [r - 1, r, r + 1, 2 * r, 3 * r + 5, 0, m - 1, r + 30, r + 33,
            r + 62]
    gen = torch.Generator(device=cuda).manual_seed(89 + g)
    a, new = _q4_inputs(gen, cuda, dtype, 3, b, 2, m, 128, (b,))
    c = [x.clone() for x in a]
    q = _randn(gen, (b, 1, 2 * g, 128), cuda, dtype)
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    got = DA.paged_decode_append_q4(q, *new, *a, 1, lens)
    want = DA.paged_decode_append_q4_plain(q, *new, *c, 1, lens)
    torch.cuda.synchronize()
    _assert_close(got, want, dtype)
    for x, y in zip(a, c):
        assert torch.equal(x, y)


def test_q4_kernel_is_deterministic(cuda):
    """Two calls of #6's bf16 instance give the same bits and caches (the
    second call merges the same nibbles again)."""
    gen = torch.Generator(device=cuda).manual_seed(97)
    lens = torch.randint(0, 4095, (8,), generator=gen,
                         device=cuda).to(torch.int32)
    a, new = _q4_inputs(gen, cuda, torch.bfloat16, 2, 8, 4, 4096, 128, (8,))
    q = _randn(gen, (8, 1, 28, 128), cuda, torch.bfloat16)
    first = DA.paged_decode_append_q4(q, *new, *a, 1, lens)
    after_first = [x.clone() for x in a]
    second = DA.paged_decode_append_q4(q, *new, *a, 1, lens)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    for x, y in zip(after_first, a):
        assert torch.equal(x, y)


def test_int_split_kernels_leave_counters_zero(cuda):
    """Kernels #3, #7, #4 and #6 one after another on one stream share the
    merge counters with #5, #8 and #9; each call leaves them at 0, and each
    output still meets its plain version."""
    gen = torch.Generator(device=cuda).manual_seed(83)
    m, tq = 4096, 4
    lens_l = [m - tq - 1, 3000, 1500, 0]
    q3, new3, c3, lens = _quant_case(gen, cuda, torch.bfloat16, 2, 4, 4, 7, m,
                                     128, lens_l)
    want3 = DA.paged_decode_append_quant_plain(
        q3, *new3, *[x.clone() for x in c3], 1, lens)
    a7, new7 = _q4_inputs(gen, cuda, torch.bfloat16, 2, 4, 4, m, 128, (4, tq))
    q7 = _randn(gen, (4, tq, 28, 128), cuda, torch.bfloat16)
    want7 = DA.paged_decode_append_multi_q4_plain(
        q7, *new7, *[x.clone() for x in a7], 1, lens)
    q4, new4, c4, _ = _multi_quant_case(gen, cuda, torch.bfloat16, 2, 4, 4,
                                        7, tq, m, 128, lens_l)
    want4 = DA.paged_decode_append_multi_quant_plain(
        q4, *new4, *[x.clone() for x in c4], 1, lens)
    a6, new6 = _q4_inputs(gen, cuda, torch.bfloat16, 2, 4, 4, m, 128, (4,))
    q6 = _randn(gen, (4, 1, 28, 128), cuda, torch.bfloat16)
    want6 = DA.paged_decode_append_q4_plain(
        q6, *new6, *[x.clone() for x in a6], 1, lens)
    got3 = DA.paged_decode_append_quant(q3, *new3, *c3, 1, lens)
    got7 = DA.paged_decode_append_multi_q4(q7, *new7, *a7, 1, lens)
    got4 = DA.paged_decode_append_multi_quant(q4, *new4, *c4, 1, lens)
    got6 = DA.paged_decode_append_q4(q6, *new6, *a6, 1, lens)
    torch.cuda.synchronize()
    counters = DA._SPLIT_COUNTERS[
        (q3.device, torch.cuda.current_stream(q3.device).cuda_stream)]
    assert int(counters.abs().sum()) == 0
    _assert_close(got3, want3, torch.bfloat16)
    _assert_close(got7, want7, torch.bfloat16)
    _assert_close(got4, want4, torch.bfloat16)
    _assert_close(got6, want6, torch.bfloat16)


# ---------------------------------------------------------------------------
# kernels #10 and #11: the decode weight streams (ops/decode_stream.py)
# ---------------------------------------------------------------------------

def _stream_params(gen, dev, n_layers, h, qd, kvd, ff):
    """Random int8 layers in the port's layout, packed for the streams."""
    from karanta_tpu_torch.ops.decode_stream import pack_stream_params
    from karanta_tpu_torch.ops.quantization import quantize_weight

    def randn(shape, s):
        return torch.randn(shape, generator=gen, device=dev) * s

    def q(shape):
        return quantize_weight(randn((n_layers,) + shape, shape[0] ** -0.5))

    layers = {"ln1": (1 + 0.1 * randn((n_layers, h), 1)).bfloat16(),
              "ln2": (1 + 0.1 * randn((n_layers, h), 1)).bfloat16(),
              "attn": {"wq": q((h, qd)), "wk": q((h, kvd)), "wv": q((h, kvd)),
                       "wo": q((qd, h)),
                       "bq": randn((n_layers, qd), 0.02).bfloat16(),
                       "bk": randn((n_layers, kvd), 0.02).bfloat16(),
                       "bv": randn((n_layers, kvd), 0.02).bfloat16()},
              "mlp": {"gate": q((h, ff)), "up": q((h, ff)),
                      "down": q((ff, h))}}
    return pack_stream_params(layers)


def _normwise(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


@pytest.mark.parametrize("shape", [
    # (layers, b, h, kvd, ff): a ragged qkv width (416 = 3.25 units of
    # 128 columns), the instances of 1, 4, 10 and 16 n-tiles (8 batch rows
    # each), then each n-tile edge: B = 1, 8 (one whole tile) and 9 (one
    # row into the second)
    (2, 3, 256, 80, 512),
    (2, 20, 512, 128, 768),
    (2, 80, 256, 64, 512),
    (2, 128, 256, 64, 512),
    (2, 1, 256, 64, 512),
    (2, 8, 512, 128, 768),
    (2, 9, 256, 80, 512),
])
def test_dense_stream_kernel_matches_plain(cuda, shape):
    from karanta_tpu_torch import kernels
    from karanta_tpu_torch.ops import decode_stream as DS

    n_layers, b, h, kvd, ff = shape
    gen = torch.Generator(device=cuda).manual_seed(31)
    sp = _stream_params(gen, cuda, n_layers, h, h, kvd, ff)
    x = _randn(gen, (b, h), cuda, torch.bfloat16)
    attn = _randn(gen, (n_layers, b, h), cuda, torch.bfloat16)
    before = kernels.LAUNCHES["dense_stream"]
    got_x, got_q = DS.dense_stream(x, attn, sp)
    again_x, again_q = DS.dense_stream(x, attn, sp)
    want_x, want_q = DS.dense_stream_plain(x, attn, sp)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["dense_stream"] == before + 2
    _assert_close(got_q[0], want_q[0], torch.bfloat16)
    assert _normwise(got_q, want_q) < 2e-2
    assert _normwise(got_x, want_x) < 2e-2
    assert torch.equal(got_x, again_x) and torch.equal(got_q, again_q)


@pytest.mark.parametrize("shape", [
    # (layers, b, h, kvh, g, d, ff, m, lens): the JAX test's tiny config,
    # the 7B heads (G = 7, D = 128) on one kv head, each (D, G) at the row
    # tiles of 1, 4, 10 and 16 rows a thread; lens outside [0, M) are
    # clamped into it, as in the plain version
    (2, 4, 256, 2, 2, 64, 512, 128, [0, 5, 33, 100]),
    (2, 4, 256, 2, 2, 64, 512, 128, [128, 200, -3, 5]),
    (2, 20, 256, 2, 2, 64, 512, 128, None),
    (2, 80, 256, 2, 2, 64, 512, 128, None),
    (2, 128, 256, 2, 2, 64, 512, 128, None),
    (2, 5, 256, 1, 7, 128, 512, 256, [0, 1, 127, 128, 255]),
    (2, 20, 256, 1, 7, 128, 512, 128, None),
    (2, 80, 256, 1, 7, 128, 512, 128, None),
    (2, 128, 256, 1, 7, 128, 512, 128, None),
    # the n-tile edges: B = 1, 8 and 9
    (2, 1, 256, 1, 7, 128, 512, 256, [255]),
    (2, 8, 256, 2, 2, 64, 512, 128, None),
    (2, 9, 256, 1, 7, 128, 512, 256, None),
])
def test_megakernel_matches_plain(cuda, shape):
    from karanta_tpu_torch import kernels
    from karanta_tpu_torch.ops import decode_stream as DS
    from karanta_tpu_torch.ops.rotary import mrope_cos_sin

    n_layers, b, h, kvh, g, d, ff, m, lens = shape
    gen = torch.Generator(device=cuda).manual_seed(37)
    if lens is None:
        lens = torch.randint(0, m, (b,), generator=gen, device=cuda).tolist()
    qd, kvd = kvh * g * d, kvh * d
    sp = _stream_params(gen, cuda, n_layers, h, qd, kvd, ff)
    x = _randn(gen, (b, h), cuda, torch.bfloat16)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=cuda)
    sec = (d // 8, 3 * d // 16, 3 * d // 16)
    cos, sin = mrope_cos_sin(lens_t[None].expand(3, b), d, sec, 1e6)
    shape5 = (n_layers, b, kvh, m, d)
    caches = [torch.randint(-127, 128, shape5, generator=gen, device=cuda,
                            dtype=torch.int8) for _ in range(2)]
    caches += [(torch.rand(shape5[:-1], generator=gen, device=cuda) * 0.02
                + 0.002).bfloat16() for _ in range(2)]
    runs = [[c.clone() for c in caches] for _ in range(3)]
    before = kernels.LAUNCHES["decode_megakernel"]
    got_x = DS.decode_megakernel(x, cos, sin, sp, *runs[0], lens_t, qd=qd,
                                 kvd=kvd)[0]
    again_x = DS.decode_megakernel(x, cos, sin, sp, *runs[1], lens_t, qd=qd,
                                   kvd=kvd)[0]
    want_x = DS.decode_megakernel_plain(x, cos, sin, sp, *runs[2], lens_t,
                                        qd, kvd, d ** -0.5)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["decode_megakernel"] == before + 2
    assert _normwise(got_x, want_x) < 2e-2
    assert torch.equal(got_x, again_x)
    assert all(torch.equal(p, q) for p, q in zip(runs[0], runs[1]))
    rows = (torch.arange(m, device=cuda)[None, :]
            == lens_t.clamp(0, m - 1)[:, None])                     # (B, M)
    for got, want, inp in zip(runs[0], runs[2], caches):
        keep = ~rows[None, :, None, :]
        if got.dim() == 5:
            keep = keep[..., None]
        assert torch.equal(torch.where(keep, got, 0), torch.where(keep, inp, 0))
    # layer 0's new rows come from the same input in both: within one step
    for got, want in zip(runs[0][:2], runs[2][:2]):
        new = rows[None, :, None, :, None].expand_as(got[:1])
        assert int((got[:1][new].int() - want[:1][new].int()).abs().max()) <= 1
    # every layer's new rows of the full-depth launch, dequantized: normwise
    new = rows[None, :, None, :].expand(runs[0][2].shape)
    for i in (0, 1):
        got, want = ((r[i].float() * r[i + 2].float()[..., None])[new]
                     for r in (runs[0], runs[2]))
        assert _normwise(got, want) < 2e-2
    # every layer's from matched inputs (the kernel's own output of the layer
    # before, chip_smoke.stream_layer_witness): within one step, and the
    # chained one-layer launches give the full-depth launch's x and every
    # cache entry, so each layer's writes of the full-depth launch are held
    # to those same steps
    kern = [c.clone() for c in caches]
    plain = [c.clone() for c in caches]
    h_in = x
    for layer in range(n_layers):
        sp_l = {k: v[layer:layer + 1] for k, v in sp.items()}
        got = [c[layer:layer + 1] for c in kern]
        want = [c[layer:layer + 1] for c in plain]
        out = DS.decode_megakernel(h_in, cos, sin, sp_l, *got, lens_t, qd=qd,
                                   kvd=kvd)[0]
        DS.decode_megakernel_plain(h_in, cos, sin, sp_l, *want, lens_t, qd,
                                   kvd, d ** -0.5)
        for g_, w_ in zip(got[:2], want[:2]):
            new = rows[None, :, None, :, None].expand_as(g_)
            assert int((g_[new].int() - w_[new].int()).abs().max()) <= 1
        h_in = out
    torch.cuda.synchronize()
    assert torch.equal(h_in, got_x)
    assert all(torch.equal(p, q) for p, q in zip(kern, runs[0]))
