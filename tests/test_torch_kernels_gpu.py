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
    # isolated holes, a whole dead run and a dead tail), "tiles" (see
    # _flash_mask) or "all" (the last batch row has no live key, so its rows
    # average V uniformly)
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
    elif kind == "tiles":  # scattered, two whole 128-key tiles dead, and
        # the last batch row without a live key
        mask = (torch.rand((b, sk), generator=gen, device=dev) > 0.25).float()
        mask[:, 128:256] = 0.0
        mask[:, 384:512] = 0.0
        mask[-1] = 0.0
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


# kernel #2's float32 instance at the document classifiers' shapes: the
# SegFormer's four stages at mit-b0 and 512 px (each stage's queries over
# its 256 sequence-reduced keys), the ViT's ragged 197-row sequence (class
# token + 14 x 14 patches) at d = 64, and the tiny SegFormer's 8-dim heads
# (an instance the float32 kernel alone has)
CLASSIFIER_F32_CASES = [
    # (b, sq, sk, h, d)
    (2, 16384, 256, 1, 32), (2, 4096, 256, 2, 32), (2, 1024, 256, 5, 32),
    (2, 256, 256, 8, 32), (4, 197, 197, 6, 64), (2, 256, 16, 1, 8),
    (2, 64, 64, 2, 8)]


@pytest.mark.parametrize("case", CLASSIFIER_F32_CASES)
def test_flash_f32_at_classifier_shapes(cuda, case):
    b, sq, sk, h, d = case
    gen = torch.Generator(device=cuda).manual_seed(13)
    q = _randn(gen, (b, sq, h, d), cuda, torch.float32)
    k = _randn(gen, (b, sk, h, d), cuda, torch.float32)
    v = _randn(gen, (b, sk, h, d), cuda, torch.float32)
    got = A.flash_attention(q, k, v)
    again = A.flash_attention(q, k, v)
    want = A.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    _assert_close(got, want, torch.float32)
    assert torch.equal(got, again)


# the float32 instance's 3xTF32 products under stress, beside the cases
# above: every head dim it has (8 included), GQA, causal at a q_offset over
# a scattered mask, and a batch row with no live key (without causal
# masking: under it the kernel skips the key tiles above the diagonal, which
# such a row would otherwise average). Inputs as drawn; with q x 8 (a
# sharply peaked softmax); with every element of q, k and v scaled by
# 2^U(-8, 1), nine binades, where one TF32 pass misses 2e-5 by 7x or more
# (the rounding model in tests/test_torch_attention.py); and with q and k
# so and v over sixteen binades, 2^U(-8, 8), held to 2e-5 x max|want|.
# Sixteen binades in q and k too would put scores in the thousands, where
# the softmax turns each score's float32 rounding into output error: any
# two float32-accurate evaluations then differ by more than 2e-5 (the
# rounding model puts 3xTF32 1.9e-5 x max|out| from plain float32 at the
# ViT's shape), and outputs in the hundreds have an ulp above an absolute
# 2e-5. A power-of-two scale leaves each hi/lo split as it was, so v's
# sixteen binades take the lo parts through every exponent they meet.
F32_SPLIT_INPUTS = ("normal", "peaked", "binades", "wide_v")


def _f32_split_cases(d):
    # (b, sq, sk, h, kvh, d, causal, mask, q_offset)
    return [(2, 150, 300, 4, 2, d, True, "scattered", 143),
            (2, 130, 100, 4, 1, d, False, "all", 0)]


def _binades(gen, x, hi):
    return x * 2.0 ** ((hi + 8.0) * torch.rand(
        x.shape, generator=gen, device=x.device) - 8.0)


@pytest.mark.parametrize("inputs", F32_SPLIT_INPUTS)
@pytest.mark.parametrize("d", A.FLASH_F32_HEAD_DIMS)
def test_flash_f32_split_stress(cuda, d, inputs):
    gen = torch.Generator(device=cuda).manual_seed(17 + d)
    for case in _f32_split_cases(d):
        q, k, v, mask = _flash_inputs(gen, case, cuda, torch.float32)
        if inputs == "peaked":
            q = q * 8.0
        elif inputs in ("binades", "wide_v"):
            q, k = _binades(gen, q, 1.0), _binades(gen, k, 1.0)
            v = _binades(gen, v, 8.0 if inputs == "wide_v" else 1.0)
        causal, q_offset = case[6], case[8]
        first, second = (A.flash_attention(q, k, v, mask, causal=causal,
                                           q_offset=q_offset)
                         for _ in range(2))
        want = A.flash_attention_plain(q, k, v, mask, causal=causal,
                                       q_offset=q_offset)
        torch.cuda.synchronize()
        if inputs == "wide_v":
            np.testing.assert_allclose(
                first.cpu(), want.cpu(),
                atol=2e-5 * float(want.abs().max()))
        else:
            _assert_close(first, want, torch.float32)
        assert torch.equal(first, second)


def test_flash_f32_resources(cuda):
    """The float32 instance fits at every head dim and spills nothing at
    D <= 64 (the classifiers' 8, 32 and 64 among them)."""
    for d in A.FLASH_F32_HEAD_DIMS:
        info = A.flash_attention_info(d, torch.float32)
        assert info["blocks_per_sm"] >= 1, (d, info)
        if d <= 64:
            assert info["spill_bytes"] == 0, (d, info)


def test_flash_has_no_bf16_head_dim_8(cuda):
    q = torch.zeros((1, 16, 1, 8), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head dim 8"):
        A.flash_attention(q, q, q)


# kernel #2's bf16 instance at its edges. It takes 128-row query blocks
# and 128-key TMA boxes, so lengths of 1, 63, 65 and 129 end inside a box
# (TMA zero-fills past the tensor, and the kernel masks keys past Sk
# itself); every head dim (operand planes 16 columns wide); GQA 7/1 and
# 14/2; causal at a q_offset with Sk > Sq; a mask with whole key tiles
# dead and a batch row without a live key (not causal: see the float32
# stress cases above).
BF16_EDGE_CASES = [
    # (b, sq, sk, h, kvh, d, causal, mask, q_offset)
    (1, 1, 1, 2, 1, 64, False, None, 0),
    (2, 1, 1, 2, 2, 64, True, "tail", 0),
    (2, 63, 65, 7, 1, 128, False, "tail", 0),
    (2, 65, 63, 14, 2, 128, True, None, 0),
    (1, 129, 129, 14, 2, 80, True, "tail", 0),
    (1, 1, 129, 7, 1, 128, True, None, 128),
    (1, 129, 1, 4, 4, 16, False, None, 0),
    (2, 63, 129, 4, 2, 32, True, "tail", 66),
    (1, 65, 1000, 7, 1, 64, True, "scattered", 935),
    (2, 129, 600, 4, 2, 80, False, "tiles", 0),
    (2, 300, 700, 14, 2, 128, False, "tiles", 0),
] + [
    # each head dim with Sq and Sk off the tiles, GQA 7/1, causal at a
    # q_offset over a scattered mask
    (2, 129, 321, 7, 1, d, True, "scattered", 192) for d in A.FLASH_HEAD_DIMS
]


@pytest.mark.parametrize("case", BF16_EDGE_CASES)
def test_flash_bf16_edges(cuda, case):
    gen = torch.Generator(device=cuda).manual_seed(29)
    q, k, v, mask = _flash_inputs(gen, case, cuda, torch.bfloat16)
    causal, q_offset = case[6], case[8]
    got = A.flash_attention(q, k, v, mask, causal=causal, q_offset=q_offset)
    again = A.flash_attention(q, k, v, mask, causal=causal, q_offset=q_offset)
    want = A.flash_attention_plain(q, k, v, mask, causal=causal,
                                   q_offset=q_offset)
    torch.cuda.synchronize()
    _assert_close(got, want, torch.bfloat16)
    assert torch.equal(got, again)


def test_flash_bf16_at_unaligned_storage_offsets(cuda):
    """The tensor maps take any 16-byte aligned base: q, k, v and the mask
    16 bytes past a 128-byte boundary, as views into larger buffers, give
    the bits of the same values at the allocator's alignment."""
    gen = torch.Generator(device=cuda).manual_seed(31)
    b, sq, sk, h, kvh, d = 2, 200, 300, 4, 2, 80

    def at_offset(shape, dtype, pad):
        n = int(np.prod(shape))
        buf = _randn(gen, (n + pad,), cuda, dtype)
        x = buf[pad:].view(shape)
        assert x.data_ptr() % 128 == 16
        return x

    q = at_offset((b, sq, h, d), torch.bfloat16, 8)
    k = at_offset((b, sk, kvh, d), torch.bfloat16, 8)
    v = at_offset((b, sk, kvh, d), torch.bfloat16, 8)
    mask = at_offset((b, sk), torch.float32, 4)
    mask.copy_((mask > -0.7).float())
    for causal, q_offset in ((False, 0), (True, 100)):
        got = A.flash_attention(q, k, v, mask, causal=causal,
                                q_offset=q_offset)
        want = A.flash_attention_plain(q, k, v, mask, causal=causal,
                                       q_offset=q_offset)
        aligned = A.flash_attention(q.clone(), k.clone(), v.clone(),
                                    mask.clone(), causal=causal,
                                    q_offset=q_offset)
        torch.cuda.synchronize()
        _assert_close(got, want, torch.bfloat16)
        assert torch.equal(got, aligned)


def test_flash_bf16_pages_in_one_call_equal_single_pages(cuda):
    """Four pages in one call give the bits of four calls of one page: no
    tile, split or order depends on the batch. The vision full layers'
    shape cut to 640 rows, each page its own scattered mask, and the
    decoder's causal prefill with ragged kv lengths."""
    gen = torch.Generator(device=cuda).manual_seed(37)
    for n, s, h, kvh, d, causal in ((4, 640, 4, 4, 80, False),
                                    (4, 300, 7, 1, 128, True)):
        q = _randn(gen, (n, s, h, d), cuda, torch.bfloat16)
        k = _randn(gen, (n, s, kvh, d), cuda, torch.bfloat16)
        v = _randn(gen, (n, s, kvh, d), cuda, torch.bfloat16)
        if causal:
            mask = torch.zeros((n, s), device=cuda)
            for i, live in enumerate((s - 10, 170, s, 1)):
                mask[i, :live] = 1.0
        else:
            mask = (torch.rand((n, s), generator=gen, device=cuda)
                    > torch.tensor([0.1, 0.3, 0.0, 0.8], device=cuda)[:, None]
                    ).float()
        whole = A.flash_attention(q, k, v, mask, causal=causal)
        torch.cuda.synchronize()
        _assert_close(whole, A.flash_attention_plain(q, k, v, mask,
                                                     causal=causal),
                      torch.bfloat16)
        for i in range(n):
            one = A.flash_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                    mask[i:i + 1], causal=causal)
            assert torch.equal(whole[i:i + 1], one), i


def test_flash_bf16_resources(cuda):
    """The bf16 instance: one block an SM (three warpgroups, 384 threads),
    no spills at any head dim, the producer's registers handed to the two
    consumer warpgroups."""
    for d in A.FLASH_HEAD_DIMS:
        info = A.flash_attention_info(d)
        assert info["blocks_per_sm"] == 1, (d, info)
        assert info["spill_bytes"] == 0, (d, info)
        assert info["producer_registers"] < info["registers"] \
            < info["consumer_registers"], (d, info)


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


# batched prefill (K = 4 pages): the vision full layers take the image axis
# as the attention batch, each page with its own valid keys; the decoder
# prefill runs causal at batch K with ragged prompt lengths; the window
# layers run over the K pages' token-axis concatenation
BATCHED_VISION_LIVE = (4800, 3600, 5120, 900)   # valid vision tokens a page
BATCHED_PREFILL_LIVE = (1390, 700, 1408, 1)     # prompt rows a page


def _page_vision_layout():
    from karanta_tpu_torch.models.qwen25_vl.config import get_config
    from karanta_tpu_torch.models.qwen25_vl.layout import build_vision_layout
    from karanta_tpu_torch.ops.image_prep import plan_image

    return build_vision_layout(plan_image(1288, 994),
                               get_config("qwen2.5-vl-7b").vision)


def test_flash_kernel_at_batched_prefill_shapes(cuda):
    """#2 at (4, 5120, 16, 80), four pages with different scattered valid
    counts, and at (4, 1408, 28/4, 128) causal with kv lengths 1390, 700,
    1408 and 1, bf16, against the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(21)
    b, s, h, d = 4, 5120, 16, 80
    q, k, v = (_randn(gen, (b, s, h, d), cuda, torch.bfloat16)
               for _ in range(3))
    mask = torch.zeros((b, s), device=cuda)
    for i, live in enumerate(BATCHED_VISION_LIVE):
        mask[i, torch.randperm(s, generator=torch.Generator().manual_seed(i))
             [:live].to(cuda)] = 1.0
    got = A.flash_attention(q, k, v, mask)
    want = A.flash_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    _assert_close(got, want, torch.bfloat16)
    del q, k, v, got, want
    b, s, h, kvh, d = 4, 1408, 28, 4, 128
    q = _randn(gen, (b, s, h, d), cuda, torch.bfloat16)
    k, v = (_randn(gen, (b, s, kvh, d), cuda, torch.bfloat16)
            for _ in range(2))
    mask = torch.zeros((b, s), device=cuda)
    for i, live in enumerate(BATCHED_PREFILL_LIVE):
        mask[i, :live] = 1.0
    got = A.flash_attention(q, k, v, mask, causal=True)
    want = A.flash_attention_plain(q, k, v, mask, causal=True)
    torch.cuda.synchronize()
    _assert_close(got, want, torch.bfloat16)


def test_window_kernel_over_concatenated_pages(cuda):
    """#1 at (1, 4 x 5120, 16, 80): four 1288x994 pages' window-ordered
    tokens concatenated, each with the page's valid mask and rope; rows
    whose window has a live key against the plain version."""
    layout = _page_vision_layout()
    n, h, d, w = 4, 16, 80, 64
    s = n * len(layout.valid)
    gen = torch.Generator(device=cuda).manual_seed(22)
    q, k, v = (_randn(gen, (1, s, h, d), cuda, torch.bfloat16)
               for _ in range(3))
    mask = torch.from_numpy(np.concatenate([layout.valid] * n)).to(cuda)
    pos = torch.from_numpy(np.concatenate([layout.pos_hw] * n)).to(cuda)
    cos, sin = vision_rope_cos_sin(pos, d)
    cos = cos.to(torch.bfloat16).float()[None].contiguous()
    sin = sin.to(torch.bfloat16).float()[None].contiguous()
    mask = mask[None].float().contiguous()
    got = A.window_attention_kernel_call(q, k, v, w, mask, cos=cos, sin=sin)
    want = A.window_attention_plain(q, k, v, w, mask, cos=cos, sin=sin)
    torch.cuda.synchronize()
    rows = (mask.reshape(1, s // w, w).amax(-1) > 0).repeat_interleave(w, 1)
    _assert_close(got[rows], want[rows], torch.bfloat16)


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


def _window_pages(gen, dev, n):
    """n 1288x994 pages' window-ordered tokens concatenated, (1, n x 5120,
    16, 80) bf16, each page with its valid mask and rope."""
    layout = _page_vision_layout()
    s = n * len(layout.valid)
    q, k, v = (_randn(gen, (1, s, 16, 80), dev, torch.bfloat16)
               for _ in range(3))
    mask = torch.from_numpy(np.concatenate([layout.valid] * n)).to(dev)
    pos = torch.from_numpy(np.concatenate([layout.pos_hw] * n)).to(dev)
    cos, sin = vision_rope_cos_sin(pos, 80)
    cos = cos.to(torch.bfloat16).float()[None].contiguous()
    sin = sin.to(torch.bfloat16).float()[None].contiguous()
    return q, k, v, mask[None].float().contiguous(), cos, sin


@pytest.mark.parametrize("n", [1, 2, 4])
def test_window_kernel_page_of_a_concatenation_is_the_page_alone(cuda, n):
    """#1 over n concatenated pages: each page's rows are bit-equal to the
    page called alone (the persistent grid deals items by the call's size,
    and an item's output depends on its own inputs only)."""
    gen = torch.Generator(device=cuda).manual_seed(40 + n)
    q, k, v, mask, cos, sin = _window_pages(gen, cuda, n)
    whole = A.window_attention_kernel_call(q, k, v, 64, mask, cos=cos,
                                           sin=sin)
    page = q.shape[1] // n
    for i in range(n):
        sl = slice(i * page, (i + 1) * page)
        one = A.window_attention_kernel_call(
            q[:, sl].contiguous(), k[:, sl].contiguous(),
            v[:, sl].contiguous(), 64, mask[:, sl].contiguous(),
            cos=cos[:, sl].contiguous(), sin=sin[:, sl].contiguous())
        torch.cuda.synchronize()
        assert torch.equal(whole[:, sl], one), i


WINDOW_EDGE_CASES = [
    # (b, s, h, d, w, rope): grids with fewer items than SMs (one item; six)
    (1, 64, 1, 80, 64, True),
    (1, 128, 3, 16, 64, False),
    # items that do not divide evenly among the blocks (315 and 70)
    (3, 1344, 5, 80, 64, True),
    (2, 320, 7, 64, 64, False),
    # windows that do not tile 64 rows: 48 (16 rows of each tile left out),
    # 80 and 112 (a window's second query tile partly past the window)
    (1, 480, 3, 80, 48, True),
    (2, 240, 2, 64, 48, False),
    (1, 400, 5, 80, 80, True),
    (2, 448, 5, 64, 112, True),
    (1, 336, 3, 16, 112, False),
    # the ring's wrap: many more items a block than stages (2,048 items over
    # four stages; 512 items over the two stages of W = 256)
    (4, 4096, 8, 80, 64, True),
    (2, 4096, 4, 80, 256, True),
]


@pytest.mark.parametrize("case", WINDOW_EDGE_CASES)
def test_window_kernel_edges_match_plain(cuda, case):
    """#1's bf16 instance at the edges of its persistent walk against the
    plain version, rows whose window has a live key."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    q, k, v, mask, cos, sin = _window_inputs(gen, case, cuda, torch.bfloat16)
    b, s, w = case[0], case[1], case[4]
    got = A.window_attention_kernel_call(q, k, v, w, mask, cos=cos, sin=sin)
    want = A.window_attention_plain(q, k, v, w, mask, cos=cos, sin=sin)
    torch.cuda.synchronize()
    rows = (mask.reshape(b, s // w, w).amax(-1) > 0).repeat_interleave(w, 1)
    _assert_close(got[rows], want[rows], torch.bfloat16)


_WINDOW_INFO_FIRST = """
import torch
from karanta_tpu_torch.ops import attention as A
from karanta_tpu_torch.ops.rotary import vision_rope_cos_sin
before = {d: A.window_attention_info(d, 64) for d in A.WINDOW_HEAD_DIMS}
gen = torch.Generator(device="cuda").manual_seed(3)
q, k, v = (torch.randn((1, 512, 16, 80), generator=gen, device="cuda")
           .bfloat16() for _ in range(3))
mask = (torch.rand((1, 512), generator=gen, device="cuda") > 0.2).float()
pos = torch.randint(0, 40, (512, 2), generator=gen, device="cuda")
cos, sin = vision_rope_cos_sin(pos, 80)
cos, sin = cos[None].contiguous(), sin[None].contiguous()
got = A.window_attention_kernel_call(q, k, v, 64, mask, cos=cos, sin=sin)
want = A.window_attention_plain(q, k, v, 64, mask, cos=cos, sin=sin)
torch.cuda.synchronize()
limit = 2.0 ** -7 * want.float().abs() + 2.0 ** -9 * want.float().abs().max()
assert ((got.float() - want.float()).abs() <= limit).all()
after = {d: A.window_attention_info(d, 64) for d in A.WINDOW_HEAD_DIMS}
assert before == after, (before, after)
print("ok")
"""


def test_window_kernel_info_before_and_after_a_launch(cuda):
    """window_attention_info in a fresh process before any launch, then a
    launch within the bf16 limit, then the same info; at W = 64 with rope:
    one block an SM of a producer and two consumer warpgroups, no spills,
    cos/sin staged, at least two stages, the producer's registers handed
    to the consumers."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _WINDOW_INFO_FIRST],
                          cwd=root, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr[-3000:]
    for d in A.WINDOW_HEAD_DIMS:
        info = A.window_attention_info(d, 64)
        assert info["blocks_per_sm"] == 1, (d, info)
        assert info["spill_bytes"] == 0, (d, info)
        assert info["consumer_warpgroups"] == 2, (d, info)
        assert info["heads_per_item"] == 1, (d, info)
        assert info["cos_sin_staged"] == 1, (d, info)
        assert info["stages"] >= 2, (d, info)
        assert info["producer_registers"] < info["registers"] \
            < info["consumer_registers"], (d, info)
    for w in (16, 48, 112, 256):
        info = A.window_attention_info(80, w)
        assert info["spill_bytes"] == 0 and info["stages"] >= 2, (w, info)


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


# every (D, G) pair the int8 decode kernel is built for (decode_rows.cuh)
QUANT_ROW_PAIRS = [(128, 7), (128, 8), (128, 4), (128, 2), (64, 4), (64, 2),
                   (32, 2), (16, 2)]


def _quant_check(q, new, caches, lens):
    a = [x.clone() for x in caches]
    got = DA.paged_decode_append_quant(q, *new, *a, 1, lens)
    want = DA.paged_decode_append_quant_plain(q, *new, *caches, 1, lens)
    torch.cuda.synchronize()
    _assert_close(got, want, q.dtype)
    for x, y in zip(a, caches):
        assert torch.equal(x, y)


@pytest.mark.parametrize("d,g", QUANT_ROW_PAIRS)
def test_quant_kernel_chunk_and_ring_edges(cuda, d, g):
    """Kernel #3's bf16 instance at every (D, G) pair, B = 8 at layer 1 of
    2: cache_len at -1, 0 and +1 of one chunk's rows and of a whole ring's
    rows, 0 and M - 1 (M = 640, a multiple of 8: the scales come by bulk
    copy); all four caches bit-equal."""
    info = DA.paged_decode_append_quant_info(d, g)
    chunk = info["chunk_rows"]
    ring = chunk * info["stages"]
    lens = [chunk - 1, chunk, chunk + 1, ring - 1, ring, ring + 1, 0, 639]
    gen = torch.Generator(device=cuda).manual_seed(90 + d + g)
    _quant_check(*_quant_case(gen, cuda, torch.bfloat16, 2, 8, 2, g, 640, d,
                              lens))


@pytest.mark.parametrize("d,g", [(128, 7), (16, 2)])
@pytest.mark.parametrize("m", [300, 1923])
def test_quant_kernel_unaligned_scales(cuda, d, g, m):
    """M not a multiple of 8: a slab's scales start off a 16-byte boundary
    (the producer's lanes load them); lengths at chunk edges, 0 and M - 1;
    all four caches bit-equal."""
    chunk = DA.paged_decode_append_quant_info(d, g)["chunk_rows"]
    lens = [0, chunk - 1, chunk, chunk + 1, 2 * chunk + 5, m - 1]
    gen = torch.Generator(device=cuda).manual_seed(m + d)
    _quant_check(*_quant_case(gen, cuda, torch.bfloat16, 2, 6, 3, g, m, d,
                              lens))


def test_quant_kernel_decode_ab_point(cuda):
    """The decode A/B point: B = 80 slots of the 7B heads (KVH 4, G 7, D
    128) each filled to 1,650 of 1,920 rows; all four caches bit-equal."""
    gen = torch.Generator(device=cuda).manual_seed(93)
    _quant_check(*_quant_case(gen, cuda, torch.bfloat16, 2, 80, 4, 7, 1920,
                              128, [1650] * 80))


def test_quant_kernel_after_an_info_call(cuda):
    """Kernel #3's bf16 instance launches at a batch it has launched at
    before after its info entry ran for another shape (the info must not
    shrink the shared memory the launch needs), at B = 4 and 80."""
    gen = torch.Generator(device=cuda).manual_seed(97)
    for b in (4, 80, 4):
        q, new, caches, lens = _quant_case(gen, cuda, torch.bfloat16, 2, b, 2,
                                           7, 640, 128, [300] * b)
        _quant_check(q, new, caches, lens)
        DA.paged_decode_append_quant_info(128, 7, b + 1, 2, 640 + b)
        _quant_check(q, new, caches, lens)


@pytest.mark.parametrize("b", [4, 80])
def test_quant_kernel_slot_bits_ignore_the_batch(cuda, b):
    """A slot's output bits do not depend on the other slots' lengths at
    the same B: its runs, and so its partials and their merge, follow from
    its own length and the run rule. B = 4 (a block a run) and B = 80 (the
    grid walks more runs than it has blocks), 7B heads over 1,920 rows."""
    gen = torch.Generator(device=cuda).manual_seed(99 + b)
    lens_l = [1650, 700, 1919, 1] * (b // 4)
    q, new, caches, lens = _quant_case(gen, cuda, torch.bfloat16, 2, b, 4, 7,
                                       1920, 128, lens_l)
    got = DA.paged_decode_append_quant(q, *new, *[x.clone() for x in caches],
                                       1, lens)
    others = lens.clone()
    others[4:] = torch.randint(0, 1920, (b - 4,), generator=gen, device=cuda)
    others[1] = 5
    again = DA.paged_decode_append_quant(q, *new,
                                         *[x.clone() for x in caches], 1,
                                         others)
    torch.cuda.synchronize()
    keep = [0, 2, 3]
    assert torch.equal(got[keep].view(torch.int16),
                       again[keep].view(torch.int16))


@pytest.mark.parametrize("d,g", [(128, 7), (64, 4), (16, 2)])
def test_quant_kernel_reads_nothing_past_the_slot(cuda, d, g):
    """Rows and scales past each slot's cache_len hold garbage (random
    bytes; NaN, inf and huge scales): the kernel's output equals the plain
    version's over the same caches with those rows zeroed, and every row
    past cache_len but the new one is left as it was."""
    b, kvh, m = 6, 2, 520
    chunk = DA.paged_decode_append_quant_info(d, g)["chunk_rows"]
    lens_l = [0, 1, chunk - 1, chunk + 3, 3 * chunk, m - 1]
    gen = torch.Generator(device=cuda).manual_seed(95 + d)
    q, new, caches, lens = _quant_case(gen, cuda, torch.bfloat16, 2, b, kvh,
                                       g, m, d, lens_l)
    dead = (torch.arange(m, device=cuda)[None, :]
            >= lens.long()[:, None])[:, None, :]            # (B, 1, M)
    garbage = [x.clone() for x in caches]
    for x in garbage[:2]:
        noise = torch.randint(-128, 128, x.shape, generator=gen,
                              device=cuda).to(torch.int8)
        x[1] = torch.where(dead[..., None], noise[1], x[1])
    specials = torch.tensor([float("nan"), float("inf"), -float("inf"),
                             3e38, 0.0], device=cuda).bfloat16()
    for x in garbage[2:]:
        pick = torch.randint(0, 5, x.shape, generator=gen, device=cuda)
        x[1] = torch.where(dead, specials[pick[1]], x[1])
    zeroed = [x.clone() for x in caches]
    for x in zeroed[:2]:
        x[1] = torch.where(dead[..., None], torch.zeros_like(x[1]), x[1])
    for x in zeroed[2:]:
        x[1] = torch.where(dead, torch.zeros_like(x[1]), x[1])
    before = [x.clone() for x in garbage]
    got = DA.paged_decode_append_quant(q, *new, *garbage, 1, lens)
    want = DA.paged_decode_append_quant_plain(q, *new, *zeroed, 1, lens)
    torch.cuda.synchronize()
    _assert_close(got, want, torch.bfloat16)
    past = dead & (torch.arange(m, device=cuda)[None, :]
                   != lens.long()[:, None])[:, None, :]
    for x, y in zip(garbage[:2], before[:2]):
        assert torch.equal(x[1][past.expand(-1, kvh, -1)],
                           y[1][past.expand(-1, kvh, -1)])
        assert torch.equal(x[0], y[0])
    for x, y in zip(garbage[2:], before[2:]):
        assert torch.equal(x[1][past.expand(-1, kvh, -1)].view(torch.int16),
                           y[1][past.expand(-1, kvh, -1)].view(torch.int16))
        assert torch.equal(x[0].view(torch.int16), y[0].view(torch.int16))
    # the live rows and the new row: as the plain version wrote them
    for x, y in zip(garbage, zeroed):
        live = ~past.expand(-1, kvh, -1)
        assert torch.equal(x[1][live].float(), y[1][live].float())


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


# kernels #4 and #7's bf16 instances, and #6's (one Hopper body,
# verify_tma.cuh; #6 at T = 1)

def _verify_case(gen, dev, kernel, n_layers, b, kvh, g, tq, m, d, lens):
    """q, fresh rows, caches and lengths of #4 (int8, m rows), #7 (int4, m
    tokens) or #6 (int4, m tokens, one fresh token: tq is 1) in bf16."""
    if kernel == 4:
        return _multi_quant_case(gen, dev, torch.bfloat16, n_layers, b, kvh,
                                 g, tq, m, d, lens)
    caches, new = _q4_inputs(gen, dev, torch.bfloat16, n_layers, b, kvh, m, d,
                             (b,) if kernel == 6 else (b, tq))
    q = _randn(gen, (b, tq, kvh * g, d), dev, torch.bfloat16)
    return q, new, caches, torch.tensor(lens, dtype=torch.int32, device=dev)


def _verify_fns(kernel):
    if kernel == 4:
        return (DA.paged_decode_append_multi_quant,
                DA.paged_decode_append_multi_quant_plain)
    if kernel == 6:
        return DA.paged_decode_append_q4, DA.paged_decode_append_q4_plain
    return DA.paged_decode_append_multi_q4, DA.paged_decode_append_multi_q4_plain


def _verify_check(kernel, q, new, caches, lens):
    fn, plain = _verify_fns(kernel)
    a = [x.clone() for x in caches]
    got = fn(q, *new, *a, 1, lens)
    want = plain(q, *new, *caches, 1, lens)
    torch.cuda.synchronize()
    _assert_close(got, want, q.dtype)
    for x, y in zip(a, caches):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kernel", [4, 7, 6])
@pytest.mark.parametrize("b", [4, 80])
def test_verify_kernels_slot_bits_ignore_the_batch(cuda, kernel, b):
    """A slot's output bits from #4, #7 and #6 do not depend on the other
    slots' lengths at the same B: its runs, partials and their merge follow
    from its own length and the run rule. B = 4 (a block a run) and B = 80
    (the grid walks more runs than it has blocks); 7B heads, T = 4 (#6: 1),
    over 1,920 rows (#4) or 4,096 tokens (#7, #6)."""
    m = 1920 if kernel == 4 else 4096
    tq = 1 if kernel == 6 else 4
    gen = torch.Generator(device=cuda).manual_seed(101 + b + kernel)
    lens_l = [m - 300, 700, m - 5, 1] * (b // 4)
    q, new, caches, lens = _verify_case(gen, cuda, kernel, 2, b, 4, 7, tq, m,
                                        128, lens_l)
    fn, _ = _verify_fns(kernel)
    got = fn(q, *new, *[x.clone() for x in caches], 1, lens)
    others = lens.clone()
    others[4:] = torch.randint(0, m - 5, (b - 4,), generator=gen,
                               device=cuda)
    others[1] = 5
    again = fn(q, *new, *[x.clone() for x in caches], 1, others)
    torch.cuda.synchronize()
    keep = [0, 2, 3]
    assert torch.equal(got[keep].view(torch.int16),
                       again[keep].view(torch.int16))


@pytest.mark.parametrize("kernel", [4, 7, 6])
def test_verify_kernels_read_nothing_past_the_slot(cuda, kernel):
    """Tokens past each slot's cache_len hold garbage (random bytes or
    nibbles; NaN, inf and huge scales): the output of #4, #7 or #6 is
    finite and equals the plain version's over the same caches with those
    tokens zeroed, and the caches after the call equal the plain version's
    written over the garbage (only the T fresh tokens change; #6: T = 1)."""
    from karanta_tpu_torch.ops.decode_attention import (pack_q4_rows,
                                                        pack_q4_scales,
                                                        unpack_q4_rows,
                                                        unpack_q4_scales)

    b, kvh, g, d = 6, 2, 7, 128
    tq = 1 if kernel == 6 else 4
    m = 640
    lens_l = [0, 1, 127, 131, 300, m - tq - 1]
    gen = torch.Generator(device=cuda).manual_seed(103 + kernel)
    q, new, caches, lens = _verify_case(gen, cuda, kernel, 2, b, kvh, g, tq,
                                        m, d, lens_l)
    dead = (torch.arange(m, device=cuda)[None, :]
            >= lens.long()[:, None])[:, None, :]              # (B, 1, M)
    specials = torch.tensor([float("nan"), float("inf"), -float("inf"),
                             3e38, 0.0], device=cuda).bfloat16()
    garbage, zeroed = [x.clone() for x in caches], [x.clone() for x in caches]
    for i in range(2):
        if kernel == 4:
            rows = garbage[i][1]
        else:
            rows = unpack_q4_rows(garbage[i][1])              # (B, KVH, M, D)
        noise = torch.randint(-128 if kernel == 4 else -8,
                              128 if kernel == 4 else 8, rows.shape,
                              generator=gen, device=cuda).to(torch.int8)
        bad = torch.where(dead[..., None], noise, rows)
        zero = torch.where(dead[..., None], torch.zeros_like(rows), rows)
        garbage[i][1] = bad if kernel == 4 else pack_q4_rows(bad)
        zeroed[i][1] = zero if kernel == 4 else pack_q4_rows(zero)
    for i in range(2, 4):
        sc = garbage[i][1] if kernel == 4 else unpack_q4_scales(garbage[i][1])
        pick = torch.randint(0, 5, sc.shape, generator=gen, device=cuda)
        bad = torch.where(dead, specials[pick], sc)
        zero = torch.where(dead, torch.zeros_like(sc), sc)
        garbage[i][1] = bad if kernel == 4 else pack_q4_scales(bad)
        zeroed[i][1] = zero if kernel == 4 else pack_q4_scales(zero)
    fn, plain = _verify_fns(kernel)
    want_caches = [x.clone() for x in garbage]
    plain(q, *new, *want_caches, 1, lens)
    got = fn(q, *new, *garbage, 1, lens)
    want = plain(q, *new, *zeroed, 1, lens)
    torch.cuda.synchronize()
    _assert_close(got, want, torch.bfloat16)
    for x, y in zip(garbage, want_caches):
        assert torch.equal(x.view(torch.int8) if x.dtype == torch.int8
                           else x.view(torch.int16),
                           y.view(torch.int8) if y.dtype == torch.int8
                           else y.view(torch.int16))


@pytest.mark.parametrize("m", [300, 1923])
def test_multi_quant_kernel_unaligned_scales(cuda, m):
    """#4 with M not a multiple of 8: a slab's scales start off a 16-byte
    boundary (the producer's lanes load them); lengths at the 128-row
    chunk's edges, 0 and M - T - 1; all four caches bit-equal."""
    tq = 4
    lens = [0, 127, 128, 129, 2 * 128 + 5, m - tq - 1]
    gen = torch.Generator(device=cuda).manual_seed(107 + m)
    _verify_check(4, *_verify_case(gen, cuda, 4, 2, len(lens), 3, 7, tq, m,
                                   128, lens))


@pytest.mark.parametrize("pm,lens", [
    (300, [0, 31, 33, 255, 256, 257, 290, 583]),
    (1932, [0, 255, 256, 257, 1000, 2049, 3000, 3847])])
def test_multi_q4_kernel_unaligned_scale_planes(cuda, pm, lens):
    """#7's C entry over a bucket of PM packed rows not a multiple of 8 (the
    wrapper takes multiples of 32): each slab's scale planes start off a
    16-byte boundary and the producer's lanes load them. Lengths at the
    64-token window's and the 256-token chunk's edges, the fresh tokens
    inside the mapped rows; held against the plain version over the caches
    padded to a whole window (the padding never read), caches bit-equal."""
    from karanta_tpu_torch import kernels

    b, kvh, g, tq, d = len(lens), 3, 7, 4, 128
    gen = torch.Generator(device=cuda).manual_seed(109 + pm)
    caches, new = _q4_inputs(gen, cuda, torch.bfloat16, 2, b, kvh, 2 * pm, d,
                             (b, tq))
    q = _randn(gen, (b, tq, kvh * g, d), cuda, torch.bfloat16)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=cuda)
    padded = []
    for x in caches:
        y = torch.zeros(x.shape[:3] + (-(-pm // 32) * 32,) + x.shape[4:],
                        dtype=x.dtype, device=cuda)
        y[:, :, :, :pm] = x
        padded.append(y)
    want = DA.paged_decode_append_multi_q4_plain(q, *new, *padded, 1, lens_t)
    fn = DA._multi_q4_fns()[0]
    info = DA.paged_decode_append_multi_q4_info(d, g * tq)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    run = DA.multi_q4_run_tokens(b, kvh, 2 * pm, info["blocks_per_sm"] * n_sm,
                                 info["max_runs"])
    partials, counters = DA._split_workspace(q, b * kvh, -(-2 * pm // run),
                                             DA.MULTI_PARTIAL_ROWS)
    got = torch.empty_like(q)
    kernels.raise_on_error("#7", fn(
        *[kernels.ptr(x) for x in (q, *new, *caches, lens_t, got, partials,
                                   counters)],
        b, tq, kvh, g, pm, d, 1, run, d ** -0.5,
        kernels.DTYPE_CODES[torch.bfloat16], kernels.stream_ptr(cuda)))
    torch.cuda.synchronize()
    _assert_close(got, want, torch.bfloat16)
    for x, y in zip(caches, padded):
        assert torch.equal(x, y[:, :, :, :pm])


@pytest.mark.parametrize("kernel", [4, 7])
@pytest.mark.parametrize("d,nq", [(128, 28), (128, 14), (128, 32), (16, 12)])
def test_verify_kernels_info(cuda, kernel, d, nq):
    """The info entries of #4's and #7's Hopper body: chunks of 128 keys
    (128 int8 rows, 64 packed int4 rows), a ring of at least two stages, one
    consumer warpgroup, no spills, at least one block an SM, at most 32 runs
    a slot; the run of a shape is a whole number of chunks."""
    info = (DA.paged_decode_append_multi_quant_info if kernel == 4
            else DA.paged_decode_append_multi_q4_info)(d, nq, 8, 4, 4096)
    tokens_a_row = 1 if kernel == 4 else 2
    assert info["chunk_rows"] * tokens_a_row == 128 and info["stages"] >= 2
    assert info["consumer_warps"] == 4
    assert info["spill_bytes"] == 0 and info["blocks_per_sm"] >= 1
    assert info["max_runs"] == 32
    run = info["run_rows"] if kernel == 4 else info["run_tokens"]
    assert run % (info["chunk_rows"] * tokens_a_row) == 0


@pytest.mark.parametrize("pm,lens", [
    (300, [0, 31, 33, 127, 128, 129, 290, 583, 587]),
    (1932, [0, 255, 256, 257, 1000, 2049, 3000, 3847, 3851])])
def test_q4_kernel_unaligned_scale_planes(cuda, pm, lens):
    """#6's C entry over a bucket of PM packed rows not a multiple of 8 (the
    wrapper takes multiples of 32): each slab's scale planes start off a
    16-byte boundary and the producer's lanes load them. Lengths at the
    64-token window's and the 128-token chunk's edges, 0, and the last
    token whose packed row lies inside the PM rows (the low nibble of row
    PM - 1: a bucket that ends inside a window has no row for the window's
    later tokens); held against the plain version over the caches padded
    to a whole window (the padding never read), caches bit-equal."""
    from karanta_tpu_torch import kernels

    b, kvh, g, d = len(lens), 3, 7, 128
    gen = torch.Generator(device=cuda).manual_seed(113 + pm)
    caches, new = _q4_inputs(gen, cuda, torch.bfloat16, 2, b, kvh, 2 * pm, d,
                             (b,))
    q = _randn(gen, (b, 1, kvh * g, d), cuda, torch.bfloat16)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=cuda)
    padded = []
    for x in caches:
        y = torch.zeros(x.shape[:3] + (-(-pm // 32) * 32,) + x.shape[4:],
                        dtype=x.dtype, device=cuda)
        y[:, :, :, :pm] = x
        padded.append(y)
    want = DA.paged_decode_append_q4_plain(q, *new, *padded, 1, lens_t)
    fn = DA._q4_fns()[0]
    info = DA.paged_decode_append_q4_info(d, g)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    run = DA.q4_run_tokens(b, kvh, 2 * pm, info["blocks_per_sm"] * n_sm,
                           info["max_runs"])
    partials, counters = DA._split_workspace(q, b * kvh, -(-2 * pm // run),
                                             DA.MULTI_PARTIAL_ROWS)
    got = torch.empty_like(q)
    kernels.raise_on_error("#6", fn(
        *[kernels.ptr(x) for x in (q, *new, *caches, lens_t, got, partials,
                                   counters)],
        b, kvh, g, pm, d, 1, run, d ** -0.5,
        kernels.DTYPE_CODES[torch.bfloat16], kernels.stream_ptr(cuda)))
    torch.cuda.synchronize()
    _assert_close(got, want, torch.bfloat16)
    for x, y in zip(caches, padded):
        assert torch.equal(x, y[:, :, :, :pm])


# every (D, G) pair the int4 decode kernel is built for (decode_append_q4.cu)
Q4_PAIRS = [(128, 7), (128, 8), (128, 4), (128, 2), (64, 4), (64, 2),
            (32, 2), (16, 2)]


@pytest.mark.parametrize("d,g", Q4_PAIRS)
def test_q4_kernel_chunk_and_ring_edges(cuda, d, g):
    """#6's bf16 instance at every (D, G) pair, B = 12 at layer 1 of 2 over
    640 tokens: cache_len at -1, 0 and +1 of the 64-token window, of one
    chunk's 128 tokens and of a whole ring's tokens, 0 and M - 1; all four
    caches bit-equal."""
    info = DA.paged_decode_append_q4_info(d, g)
    chunk = 2 * info["chunk_rows"]
    ring = chunk * info["stages"]
    m = 640 if ring + 1 < 640 else ring + 128
    lens = [63, 64, 65, chunk - 1, chunk, chunk + 1, ring - 1, ring,
            ring + 1, 0, m - 1, chunk + 33]
    gen = torch.Generator(device=cuda).manual_seed(115 + d + g)
    _verify_check(6, *_verify_case(gen, cuda, 6, 2, len(lens), 2, g, 1, m, d,
                                   lens))


@pytest.mark.parametrize("d,g", Q4_PAIRS)
def test_q4_kernel_info(cuda, d, g):
    """The info entry of #6's Hopper body at every pair: chunks of 64
    packed rows (128 tokens), a ring of at least two stages, one consumer
    warpgroup, no spills, at least one block an SM, at most 32 runs a slot;
    the run of a shape is a whole number of chunks."""
    info = DA.paged_decode_append_q4_info(d, g, 8, 4, 4096)
    assert info["chunk_rows"] * 2 == 128 and info["stages"] >= 2
    assert info["consumer_warps"] == 4
    assert info["spill_bytes"] == 0 and info["blocks_per_sm"] >= 1
    assert info["max_runs"] == 32
    assert info["run_tokens"] % 128 == 0


def test_q4_kernel_after_an_info_call(cuda):
    """#6's bf16 instance launches at a batch it has launched at before
    after its info entry ran for another shape (the info must not shrink
    the shared memory the launch needs), at B = 4 and 80."""
    gen = torch.Generator(device=cuda).manual_seed(117)
    for b in (4, 80, 4):
        case = _verify_case(gen, cuda, 6, 2, b, 2, 7, 1, 640, 128, [300] * b)
        _verify_check(6, *case)
        DA.paged_decode_append_q4_info(128, 7, b + 1, 2, 640 + 64 * b)
        _verify_check(6, *case)


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
    # batches inside the 80- and 128-row instances
    (2, 33, 256, 64, 512),
    (2, 64, 512, 128, 768),
    (2, 100, 256, 64, 512),
    # more (unit, k tile) pairs a block than ring stages, at 8 and 80 rows
    (2, 4, 2048, 256, 8192),
    (1, 80, 2048, 256, 8192),
    # fewer pairs than blocks: one 128-column qkv unit and k tile
    (2, 3, 256, 64, 256),
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
    # batches inside the 80- and 128-row instances
    (2, 33, 256, 1, 7, 128, 512, 128, None),
    (2, 64, 256, 2, 2, 64, 512, 128, None),
    (2, 100, 256, 1, 7, 128, 512, 128, None),
    # more (unit, k tile) pairs a block than ring stages, at 4 and 80 rows
    (1, 4, 2048, 2, 7, 128, 8192, 256, [0, 100, 255, 17]),
    (1, 80, 2048, 1, 7, 128, 8192, 128, None),
    # fewer pairs than blocks: hidden 128, one kv head of two 64-wide heads
    (2, 3, 128, 1, 2, 64, 256, 128, [0, 1, 127]),
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


@pytest.mark.parametrize("b", [4, 80])
def test_streams_slot_bits_ignore_the_batch(cuda, b):
    """A slot's outputs depend on its own inputs alone: slot 0's x (and, for
    the megakernel, its new cache rows; for dense_stream its qkv rows) stay
    bit-equal when the other slots' inputs and cache lengths change."""
    from karanta_tpu_torch.ops import decode_stream as DS
    from karanta_tpu_torch.ops.rotary import mrope_cos_sin

    n_layers, h, kvh, g, d, ff, m = 2, 256, 1, 7, 128, 512, 256
    gen = torch.Generator(device=cuda).manual_seed(41)
    qd, kvd = kvh * g * d, kvh * d
    sp = _stream_params(gen, cuda, n_layers, h, qd, kvd, ff)
    sp_dense = _stream_params(gen, cuda, n_layers, h, h, kvd, ff)
    shape5 = (n_layers, b, kvh, m, d)
    caches = [torch.randint(-127, 128, shape5, generator=gen, device=cuda,
                            dtype=torch.int8) for _ in range(2)]
    caches += [(torch.rand(shape5[:-1], generator=gen, device=cuda) * 0.02
                + 0.002).bfloat16() for _ in range(2)]
    outs = []
    for trial in range(2):
        x = _randn(gen, (b, h), cuda, torch.bfloat16)
        attn = _randn(gen, (n_layers, b, h), cuda, torch.bfloat16)
        lens = torch.randint(0, m, (b,), generator=gen, device=cuda)
        x[0] = outs[0]["x0"] if trial else x[0]
        attn[:, 0] = outs[0]["attn0"] if trial else attn[:, 0]
        lens[0] = 201
        lens_t = lens.int()
        cos, sin = mrope_cos_sin(lens_t[None].expand(3, b), d,
                                 (d // 8, 3 * d // 16, 3 * d // 16), 1e6)
        run = [c.clone() for c in caches]
        got_x = DS.decode_megakernel(x, cos, sin, sp, *run, lens_t, qd=qd,
                                     kvd=kvd)[0]
        dense_x, dense_q = DS.dense_stream(x, attn, sp_dense)
        torch.cuda.synchronize()
        outs.append({"x0": x[0].clone(), "attn0": attn[:, 0].clone(),
                     "x": got_x[0], "rows": [c[:, 0, :, 201] for c in run],
                     "dense_x": dense_x[0], "dense_q": dense_q[:, 0]})
    first, second = outs
    assert torch.equal(first["x"], second["x"])
    assert all(torch.equal(p, q) for p, q in zip(first["rows"], second["rows"]))
    assert torch.equal(first["dense_x"], second["dense_x"])
    assert torch.equal(first["dense_q"], second["dense_q"])


# The training path's shapes at Qwen2.5-VL-3B: the decoder's 16 query heads
# over 2 kv heads (a group of 8), d = 128, causal, a (B, S) pad mask, at the
# 3,072-token rows the trainer's collator gives a synthetic page; the
# vision window layers through the window kernel's no-rope instance,
# (1, T, 16, 80), window 64. Forward through the autograd functions against
# the plain versions at the bf16 limit; dq, dk, dv (the kernel's forward,
# the plain blockwise backward) against float32 autograd through the dense
# plain versions from the same inputs, normwise within 1e-2 in bf16 (the
# gradients round once to bf16; the kernel's output enters the backward's
# rowsum) and 1e-5 in float32.
TRAIN_FLASH_CASES = [(1, 3072, 3072, 16, 2, 128, True, "tail", 0),
                     (1, 2560, 2560, 16, 2, 128, True, "tail", 0),
                     (2, 700, 700, 16, 2, 128, True, "tail", 0)]


def _grad_errors(fn, ref, inputs, dout):
    """Normwise errors of fn's gradients against ref's in float32."""
    xs = [x.detach().requires_grad_(True) for x in inputs]
    got = torch.autograd.grad(fn(*xs), xs, dout)
    fs = [x.detach().float().requires_grad_(True) for x in inputs]
    want = torch.autograd.grad(ref(*fs), fs, dout.float())
    return [float((g.float() - w).norm() / w.norm())
            for g, w in zip(got, want)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", TRAIN_FLASH_CASES)
def test_flash_autograd_at_the_3b_decoder_shape(cuda, dtype, case):
    from karanta_tpu_torch import kernels

    gen = torch.Generator(device=cuda).manual_seed(11)
    q, k, v, mask = _flash_inputs(gen, case, cuda, dtype)
    kernels.reset_launches()
    got = A.attention(q, k, v, kv_mask=mask, causal=True)
    assert kernels.LAUNCHES["flash_attention"] == 1
    _assert_close(got, A.flash_attention_plain(q, k, v, mask, causal=True),
                  dtype)
    dout = _randn(gen, q.shape, cuda, dtype)
    errs = _grad_errors(
        lambda q, k, v: A.attention(q, k, v, kv_mask=mask, causal=True),
        lambda q, k, v: A.mha_reference(q, k, v, kv_mask=mask, causal=True),
        (q, k, v), dout)
    assert kernels.LAUNCHES["flash_attention"] == 2  # the backward is plain
    assert max(errs) < (1e-2 if dtype == torch.bfloat16 else 1e-5), errs


@pytest.mark.parametrize("q_offset", [0, 1536])
@pytest.mark.parametrize("heads", [(16, 2), (8, 1)])
def test_flash_at_the_sequence_parallel_rank_shape(cuda, heads, q_offset):
    """#2 as a sequence-parallel rank of the 3B decoder runs it (seq = 2;
    8/1 heads with model = 2 as well): 1,536 queries at q_offset 0 or 1,536
    over the 3,072 keys gathered from both ranks, 2,950 of them live. The
    forward at the bf16 limit, two calls bit-equal, and the autograd
    function's dq/dk/dv within 1e-2 of float32 autograd."""
    h, kvh = heads
    gen = torch.Generator(device=cuda).manual_seed(16)
    q = _randn(gen, (1, 1536, h, 128), cuda, torch.bfloat16)
    k = _randn(gen, (1, 3072, kvh, 128), cuda, torch.bfloat16)
    v = _randn(gen, (1, 3072, kvh, 128), cuda, torch.bfloat16)
    mask = torch.zeros((1, 3072), device=cuda)
    mask[:, :2950] = 1.0
    first, second = (A.flash_attention(q, k, v, mask, causal=True,
                                       q_offset=q_offset) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    _assert_close(first, A.flash_attention_plain(
        q, k, v, mask, causal=True, q_offset=q_offset), torch.bfloat16)
    errs = _grad_errors(
        lambda q, k, v: A.attention(q, k, v, kv_mask=mask, causal=True,
                                    q_offset=q_offset),
        lambda q, k, v: A.mha_reference(q, k, v, kv_mask=mask, causal=True,
                                        q_offset=q_offset),
        (q, k, v), _randn(gen, q.shape, cuda, torch.bfloat16))
    assert max(errs) < 1e-2, errs


@pytest.mark.parametrize("dtype", DTYPES)
def test_window_autograd_at_the_3b_vision_shape(cuda, dtype):
    from karanta_tpu_torch import kernels

    gen = torch.Generator(device=cuda).manual_seed(12)
    b, s, h, d, w = 1, 2048, 16, 80, 64
    q, k, v = (_randn(gen, (b, s, h, d), cuda, dtype) for _ in range(3))
    mask = (torch.rand((b, s), generator=gen, device=cuda) > 0.2).float()
    mask[:, ::w] = 1.0  # every window keeps a live key
    kernels.reset_launches()
    got = A.window_attention(q, k, v, w, kv_mask=mask)
    assert kernels.LAUNCHES["window_attention"] == 1
    _assert_close(got, A.window_attention_plain(q, k, v, w, mask), dtype)
    dout = _randn(gen, q.shape, cuda, dtype)
    errs = _grad_errors(
        lambda q, k, v: A.window_attention(q, k, v, w, kv_mask=mask),
        lambda q, k, v: A._window_reference(q, k, v, w, mask, None),
        (q, k, v), dout)
    assert max(errs) < (1e-2 if dtype == torch.bfloat16 else 1e-5), errs
    first, second = (A.window_attention(q, k, v, w, kv_mask=mask)
                     for _ in range(2))
    assert torch.equal(first, second)


# one rank's shapes of tensor-parallel serving of the 7B config: vision heads
# 16 / tp, decoder q heads 28 / tp over kv heads 4 / tp (the GQA group stays
# 7); bf16, as served
PER_RANK_KERNELS = ["window", "flash_vision", "flash_prefill", "quant",
                    "multi_quant", "append", "q4", "multi_q4", "stacked"]


@pytest.mark.parametrize("kernel", PER_RANK_KERNELS)
@pytest.mark.parametrize("tp", [2, 4])
def test_kernels_at_per_rank_shapes(cuda, tp, kernel):
    from karanta_tpu_torch.models.qwen25_vl.decoder import quantize_kv_rows

    dtype = torch.bfloat16
    gen = torch.Generator(device=cuda).manual_seed(37 + tp)
    h, kvh, vh, d = 28 // tp, 4 // tp, 16 // tp, 128
    b, tq, m = 4, 4, 512
    lens = torch.tensor([0, 61, 300, m - tq - 1], dtype=torch.int32,
                        device=cuda)
    writes = []
    if kernel == "window":
        q, k, v, mask, cos, sin = _window_inputs(
            gen, (1, 512, vh, 80, 64, True), cuda, dtype)
        got = A.window_attention_kernel_call(q, k, v, 64, mask, cos=cos,
                                             sin=sin)
        want = A.window_attention_plain(q, k, v, 64, mask, cos=cos, sin=sin)
        rows = (mask.reshape(1, 8, 64).amax(-1) > 0).repeat_interleave(64, 1)
        got, want = got[rows], want[rows]
    elif kernel.startswith("flash"):
        case = ((1, 640, 640, vh, vh, 80, False, "scattered", 0)
                if kernel == "flash_vision"
                else (1, 300, 300, h, kvh, d, True, "tail", 0))
        q, k, v, mask = _flash_inputs(gen, case, cuda, dtype)
        got = A.flash_attention(q, k, v, mask, causal=case[6])
        want = A.flash_attention_plain(q, k, v, mask, causal=case[6])
    elif kernel in ("quant", "multi_quant"):
        lead = (b,) if kernel == "quant" else (b, tq)

        def rows(shape):
            return torch.randn(shape, generator=gen, device=cuda)

        kq, ks = quantize_kv_rows(rows((2, b, kvh, m, d)))
        vq, vs = quantize_kv_rows(rows((2, b, kvh, m, d)))
        nkq, nks = quantize_kv_rows(rows(lead + (kvh, d)))
        nvq, nvs = quantize_kv_rows(rows(lead + (kvh, d)))
        q = rows((b, 1 if kernel == "quant" else tq, h, d)).to(dtype)
        new = (nkq, nvq, nks.to(dtype), nvs.to(dtype))
        a = [kq, vq, ks.to(dtype), vs.to(dtype)]
        c = [x.clone() for x in a]
        fn, plain = ((DA.paged_decode_append_quant,
                      DA.paged_decode_append_quant_plain)
                     if kernel == "quant" else
                     (DA.paged_decode_append_multi_quant,
                      DA.paged_decode_append_multi_quant_plain))
        got = fn(q, *new, *a, 1, lens)
        want = plain(q, *new, *c, 1, lens)
        writes = list(zip(a, c))
    elif kernel == "append":
        kc = _randn(gen, (2, b, kvh, m, d), cuda, dtype)
        vc = _randn(gen, (2, b, kvh, m, d), cuda, dtype)
        nk, nv = (_randn(gen, (b, kvh, d), cuda, dtype) for _ in range(2))
        q = _randn(gen, (b, 1, h, d), cuda, dtype)
        a, c = [kc, vc], [kc.clone(), vc.clone()]
        got = DA.paged_decode_append(q, nk, nv, *a, 1, lens)
        want = DA.paged_decode_append_plain(q, nk, nv, *c, 1, lens)
        writes = list(zip(a, c))
    elif kernel in ("q4", "multi_q4"):
        lead = (b,) if kernel == "q4" else (b, tq)
        a, new = _q4_inputs(gen, cuda, dtype, 2, b, kvh, m, d, lead)
        c = [x.clone() for x in a]
        q = _randn(gen, (b, 1 if kernel == "q4" else tq, h, d), cuda, dtype)
        fn, plain = ((DA.paged_decode_append_q4,
                      DA.paged_decode_append_q4_plain)
                     if kernel == "q4" else
                     (DA.paged_decode_append_multi_q4,
                      DA.paged_decode_append_multi_q4_plain))
        got = fn(q, *new, *a, 1, lens)
        want = plain(q, *new, *c, 1, lens)
        writes = list(zip(a, c))
    else:
        q, k, v, _ = _read_only_case(gen, cuda, dtype, 2, b, kvh, h // kvh,
                                     m, d, [0, 61, 300, m - 1])
        got = DA.paged_decode_attention_stacked(q, k, v, 1, lens)
        want = DA.paged_decode_attention_stacked_plain(q, k, v, 1, lens)
    torch.cuda.synchronize()
    _assert_close(got, want, dtype)
    for x, y in writes:
        assert torch.equal(x, y)


@pytest.mark.parametrize("b", [4, 80])
def test_streams_silu_saturates(cuda, b):
    """Gate pre-activations below -88.7, where exp(-g) overflows to inf, and
    in (-88.7, -87.3), where 1 + exp(-g) passes 2^126: h = bf16(silu(g) * u)
    stays finite (a signed zero or a tiny value, as in the plain version),
    so x does, and both entries stay within their plain versions' limits."""
    from karanta_tpu_torch.ops import decode_stream as DS
    from karanta_tpu_torch.ops.rotary import mrope_cos_sin

    n_layers, h, kvh, g, d, ff, m = 2, 256, 1, 7, 128, 512, 256
    gen = torch.Generator(device=cuda).manual_seed(43)
    qd, kvd = kvh * g * d, kvh * d
    sp = _stream_params(gen, cuda, n_layers, h, qd, kvd, ff)
    sp_dense = _stream_params(gen, cuda, n_layers, h, h, kvd, ff)
    for p in (sp, sp_dense):
        p["gs"] = p["gs"] * 100.0  # g spread over about +-300
    x = _randn(gen, (b, h), cuda, torch.bfloat16)
    attn = _randn(gen, (n_layers, b, h), cuda, torch.bfloat16)
    # both regimes are reached (dense_stream's layer 0, from the plain pieces)
    _, xn = DS._o_residual(x, attn[0], sp_dense, 0, 1e-6)
    gate = DS._linear(xn, sp_dense["wg_t"][0].transpose(0, 1),
                      sp_dense["gs"][0])
    assert bool((gate < -88.8).any())
    assert bool(((gate > -88.7) & (gate < -87.4)).any())
    got_x, got_q = DS.dense_stream(x, attn, sp_dense)
    want_x, want_q = DS.dense_stream_plain(x, attn, sp_dense)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got_x.float()).all())
    assert _normwise(got_x, want_x) < 2e-2
    assert _normwise(got_q, want_q) < 2e-2

    lens_t = torch.randint(0, m, (b,), generator=gen, device=cuda).int()
    cos, sin = mrope_cos_sin(lens_t[None].expand(3, b), d,
                             (d // 8, 3 * d // 16, 3 * d // 16), 1e6)
    shape5 = (n_layers, b, kvh, m, d)
    caches = [torch.randint(-127, 128, shape5, generator=gen, device=cuda,
                            dtype=torch.int8) for _ in range(2)]
    caches += [(torch.rand(shape5[:-1], generator=gen, device=cuda) * 0.02
                + 0.002).bfloat16() for _ in range(2)]
    runs = [[c.clone() for c in caches] for _ in range(2)]
    got_x = DS.decode_megakernel(x, cos, sin, sp, *runs[0], lens_t, qd=qd,
                                 kvd=kvd)[0]
    want_x = DS.decode_megakernel_plain(x, cos, sin, sp, *runs[1], lens_t,
                                        qd, kvd, d ** -0.5)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got_x.float()).all())
    assert _normwise(got_x, want_x) < 2e-2
