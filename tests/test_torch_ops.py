"""The port's small ops against the JAX package: image prep, rotary,
rms_norm, layout planning, int8 quantization, and the stdlib PNG codec.
Inputs are made from seeds with numpy; the int8 paths must be exact."""

import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karanta_tpu.models.qwen25_vl import layout as jlayout
from karanta_tpu.models.qwen25_vl.config import qwen25_vl_7b as j_7b
from karanta_tpu.ops import image_prep as jip
from karanta_tpu.ops import quantization as jq
from karanta_tpu.ops import rotary as jrot
from karanta_tpu.ops.norms import rms_norm as j_rms_norm
from karanta_tpu_torch.models.qwen25_vl import layout as tlayout
from karanta_tpu_torch.models.qwen25_vl.config import qwen25_vl_7b
from karanta_tpu_torch.ops import image_prep as tip
from karanta_tpu_torch.ops import quantization as tq
from karanta_tpu_torch.ops import rotary as trot
from karanta_tpu_torch.ops.norms import rms_norm
from karanta_tpu_torch.ops.png import decode_png_rgb, encode_png_rgb


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


class TestImagePrep:
    @pytest.mark.parametrize("h,w", [(1288, 994), (640, 480), (2048, 1536),
                                     (200, 1000), (20, 30)])
    def test_plan_matches_jax(self, h, w):
        assert tip.smart_resize(h, w) == jip.smart_resize(h, w)
        assert (dataclasses.astuple(tip.plan_image(h, w))
                == dataclasses.astuple(jip.plan_image(h, w)))
        assert tip.src_px_bucket(h) == jip.src_px_bucket(h)

    def test_plan_rejects_what_jax_rejects(self):
        for h, w in ((100, 3000), (10, 2500)):
            with pytest.raises(ValueError):
                jip.plan_image(h, w)
            with pytest.raises(ValueError):
                tip.plan_image(h, w)

    def test_patchify_matches_jax(self):
        rng = np.random.default_rng(2)
        img = rng.integers(0, 255, size=(112, 140, 3), dtype=np.uint8)
        kw = dict(grid_h=8, grid_w=10, pad_grid_h=8, pad_grid_w=16)
        want = np.asarray(jip.patchify(jnp.asarray(img),
                                       out_dtype=jnp.float32, **kw))
        got = tip.patchify(_t(img), out_dtype=torch.float32, **kw).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)

    @pytest.mark.parametrize("h,w", [(56, 84), (333, 517), (1288, 994)])
    def test_resize_patchify_matches_jax_pil_path(self, h, w):
        """Device resize (two f32 resampling matmuls) vs the JAX package's
        PIL-bicubic host path + patchify: within one uint8 step, exact at
        scale 1."""
        rng = np.random.default_rng(h * 1000 + w)
        img = rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)
        arr, plan = jip.preprocess_host(img)
        kw = dict(grid_h=plan.grid_h, grid_w=plan.grid_w,
                  pad_grid_h=plan.pad_grid_h, pad_grid_w=plan.pad_grid_w)
        ref = np.asarray(jip.patchify(jnp.asarray(arr), out_dtype=jnp.float32,
                                      **kw))
        sbh, sbw = tip.src_px_bucket(h), tip.src_px_bucket(w)
        src = np.zeros((sbh, sbw, 3), np.uint8)
        src[:h, :w] = img
        got = tip.resize_patchify(_t(src), h, w, out_dtype=torch.float32,
                                  **kw).numpy()
        # one u8 step in CLIP-normalized units is 1/255/std ~ 0.0145
        assert np.abs(got - ref).max() <= 0.016
        if (h, w) == (56, 84):
            np.testing.assert_allclose(got, ref, atol=1e-6)

    def test_preprocess_host_matches_jax(self):
        rng = np.random.default_rng(3)
        img = rng.integers(0, 255, size=(130, 260, 3), dtype=np.uint8)
        arr_j, plan_j = jip.preprocess_host(img)
        arr_t, plan_t = tip.preprocess_host(img)
        np.testing.assert_array_equal(arr_t, arr_j)
        assert dataclasses.astuple(plan_t) == dataclasses.astuple(plan_j)


class TestPng:
    def test_roundtrip(self):
        rng = np.random.default_rng(0)
        img = rng.integers(0, 255, size=(37, 53, 3), dtype=np.uint8)
        np.testing.assert_array_equal(decode_png_rgb(encode_png_rgb(img)), img)

    @pytest.mark.parametrize("mode", ["RGB", "L", "RGBA", "LA"])
    def test_decodes_pil_pngs(self, mode):
        """PIL picks its own row filters (Sub/Up/Average/Paeth mixes)."""
        from PIL import Image

        rng = np.random.default_rng(1)
        img = rng.integers(0, 255, size=(41, 67, 3), dtype=np.uint8)
        img[:, :20] = 200  # flat areas steer the filter choice
        pil = Image.fromarray(img).convert(mode)
        buf = io.BytesIO()
        pil.save(buf, format="PNG")
        want = np.asarray(pil.convert("RGB"))
        np.testing.assert_array_equal(decode_png_rgb(buf.getvalue()), want)

    def test_rejects_non_png(self):
        with pytest.raises(ValueError):
            decode_png_rgb(b"GIF89a....")


def _rope_float32_tol(pos, inv):
    """Per-element bound on |cos_a - cos_b| (and sin) between two float32
    rope tables whose inverse frequencies may differ by one ulp.

    Both packages compute inv = 1 / theta**(2i/d) and angle = pos * inv in
    float32, but their vectorised ``pow`` may round inv to neighbouring
    floats (torch's pow moves with ``ATEN_CPU_CAPABILITY``). The angles
    then differ by at most pos * ulp(inv) + ulp(angle) (one ulp of inv
    scaled by the position, plus half an ulp of rounding on each side), and
    cos/sin are 1-Lipschitz, each with at most one ulp of its own error near
    1. At positions below 500 that is at most 9e-5; at angles below 1 it
    stays under 4e-7."""
    pos = np.asarray(pos, np.float32)
    inv = np.asarray(inv, np.float32)
    angle = np.abs(pos * inv)
    return (np.abs(pos) * np.spacing(inv) + np.spacing(angle)
            + 2 * np.spacing(np.float32(1.0)))


def _mrope_angle_args(pos, head_dim, section, theta):
    """(positions, inv) per element of the (seq, head_dim) M-RoPE table."""
    half = head_dim // 2
    inv = (np.float32(1.0) / (np.float32(theta) ** (
        np.arange(half, dtype=np.float32) * np.float32(2.0 / head_dim)))
    ).astype(np.float32)
    band = np.concatenate([np.full((w,), i) for i, w in enumerate(section)])
    p = pos[band, :].T.astype(np.float32)                  # (seq, half)
    return np.concatenate([p, p], -1), np.concatenate([inv, inv])


class TestRotaryNorms:
    def test_mrope_matches_jax(self):
        """Port against the JAX package at a tolerance derived from float32
        rounding (``_rope_float32_tol``): angles reach 500 rad here, where
        one float32 ulp of the angle is 3.05e-5, so a flat 2e-6 held only
        while both packages' ``pow`` and ``cos``/``sin`` agreed bit for bit
        on the host. Positions 0-3 keep the flat 2e-6 as well."""
        rng = np.random.default_rng(4)
        pos = rng.integers(0, 500, size=(3, 37)).astype(np.int32)
        pos[:, :4] = np.arange(4)
        cj, sj = jrot.mrope_cos_sin(jnp.asarray(pos), 128, (16, 24, 24))
        ct, st = trot.mrope_cos_sin(_t(pos), 128, (16, 24, 24))
        p, inv = _mrope_angle_args(pos, 128, (16, 24, 24), 1e6)
        tol = _rope_float32_tol(p, inv)
        assert tol.max() < 1e-4
        for got, want in ((ct.numpy(), np.asarray(cj)),
                          (st.numpy(), np.asarray(sj))):
            err = np.abs(got - want)
            assert (err <= tol).all(), float((err / tol).max())
            np.testing.assert_allclose(got[:4], want[:4], atol=2e-6)

    def test_vision_rope_and_apply_match_jax(self):
        """Tables at the float32 bound of ``_rope_float32_tol`` (angles
        reach 79 rad, where one ulp is 7.6e-6); ``apply_rope`` at 2e-5 on
        the same tables, so that its check does not hang on theirs."""
        rng = np.random.default_rng(5)
        pos = rng.integers(0, 80, size=(50, 2)).astype(np.int32)
        cj, sj = jrot.vision_rope_cos_sin(jnp.asarray(pos), 80)
        ct, st = trot.vision_rope_cos_sin(_t(pos), 80)
        inv = (np.float32(1.0) / (np.float32(1e4) ** (
            np.arange(20, dtype=np.float32) * np.float32(2.0 / 40)))
        ).astype(np.float32)
        p = np.repeat(pos.astype(np.float32), 20, axis=1)   # [h | w] bands
        tol = _rope_float32_tol(np.tile(p, 2), np.tile(inv, 4))
        for got, want in ((ct.numpy(), np.asarray(cj)),
                          (st.numpy(), np.asarray(sj))):
            err = np.abs(got - want)
            assert (err <= tol).all(), float((err / tol).max())
        q = rng.normal(size=(1, 50, 3, 80)).astype(np.float32)
        k = rng.normal(size=(1, 50, 3, 80)).astype(np.float32)
        qj, kj = jrot.apply_rope(jnp.asarray(q), jnp.asarray(k), cj[None],
                                 sj[None])
        qt, kt = trot.apply_rope(_t(q), _t(k), _t(cj)[None], _t(sj)[None])
        np.testing.assert_allclose(qt.numpy(), np.asarray(qj), atol=2e-5)
        np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=2e-5)

    def test_rope_matches_jax(self):
        pos = np.arange(9, dtype=np.int32)
        cj, _ = jrot.rope_cos_sin(jnp.asarray(pos), 64)
        ct, _ = trot.rope_cos_sin(_t(pos), 64)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=2e-6)

    def test_rms_norm_matches_jax(self):
        rng = np.random.default_rng(6)
        x = rng.normal(size=(4, 96)).astype(np.float32)
        w = rng.normal(size=(96,)).astype(np.float32)
        want = np.asarray(j_rms_norm(jnp.asarray(x), jnp.asarray(w)))
        np.testing.assert_allclose(rms_norm(_t(x), _t(w)).numpy(), want,
                                   atol=1e-6)


class TestLayout:
    @pytest.mark.parametrize("hw", [(1288, 994), (333, 517), (56, 84)])
    def test_vision_layout_and_positions_match_jax(self, hw):
        plan = tip.plan_image(*hw)
        got = tlayout.build_vision_layout(plan, qwen25_vl_7b().vision)
        want = jlayout.build_vision_layout(jip.plan_image(*hw), j_7b().vision)
        for field in ("perm", "valid", "pos_hw", "extract"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field))
        assert got.n_windows == want.n_windows
        ids = np.asarray([1, 2] + [9] * got.num_merged + [3, 4], np.int32)
        np.testing.assert_array_equal(
            tlayout.mrope_positions(ids, [plan.grid_thw], 9),
            jlayout.mrope_positions(ids, [plan.grid_thw], 9))


class TestQuantization:
    def test_quantize_weight_exact(self):
        rng = np.random.default_rng(7)
        w = rng.normal(size=(2, 48, 40)).astype(np.float32)
        qj = jq.quantize_weight(jnp.asarray(w))
        qt = tq.quantize_weight(_t(w))
        np.testing.assert_array_equal(qt[tq.QUANT_KEY].numpy(),
                                      np.asarray(qj[jq.QUANT_KEY]))
        np.testing.assert_array_equal(qt["scale"].numpy(),
                                      np.asarray(qj["scale"]))

    def test_matmuls_match_jax(self):
        rng = np.random.default_rng(8)
        w = rng.normal(size=(64, 40)).astype(np.float32)
        x = rng.normal(size=(3, 5, 64)).astype(np.float32)
        qj = jq.quantize_weight(jnp.asarray(w))
        qt = tq.quantize_weight(_t(w))
        np.testing.assert_allclose(
            tq.matmul(_t(x), qt).numpy(),
            np.asarray(jq.matmul(jnp.asarray(x), qj)), atol=1e-5)
        np.testing.assert_allclose(
            tq.matmul_w8a8(_t(x), qt).numpy(),
            np.asarray(jq.matmul_w8a8(jnp.asarray(x), qj)), atol=1e-5)
        # 1-D activations (the LM head on one hidden vector)
        np.testing.assert_allclose(
            tq.matmul_w8a8(_t(x[0, 0]), qt).numpy(),
            np.asarray(jq.matmul_w8a8(jnp.asarray(x[0, 0]), qj)), atol=1e-5)

    def test_int8_product_is_exact(self):
        rng = np.random.default_rng(9)
        a = rng.integers(-127, 128, size=(5, 64)).astype(np.int8)
        b = rng.integers(-127, 128, size=(64, 24)).astype(np.int8)
        got = tq.int8_mm(_t(a), _t(b)).numpy()
        np.testing.assert_array_equal(got, a.astype(np.int64) @ b)

    def test_quantize_decoder_params_matches_jax(self):
        rng = np.random.default_rng(10)
        L, h, ff, v = 2, 16, 24, 40
        tree = {"embed": rng.normal(size=(v, h)),
                "layers": {"ln1": np.ones((L, h)),
                           "attn": {n: rng.normal(size=(L, h, h))
                                    for n in ("wq", "wk", "wv", "wo")},
                           "mlp": {"gate": rng.normal(size=(L, h, ff)),
                                   "up": rng.normal(size=(L, h, ff)),
                                   "down": rng.normal(size=(L, ff, h))}}}
        tree = {k: v if not isinstance(v, np.ndarray) else v.astype(np.float32)
                for k, v in tree.items()}
        jt = jq.quantize_decoder_params(
            {"embed": jnp.asarray(tree["embed"], jnp.float32),
             "layers": {"ln1": jnp.ones((L, h)),
                        "attn": {n: jnp.asarray(a, jnp.float32)
                                 for n, a in tree["layers"]["attn"].items()},
                        "mlp": {n: jnp.asarray(a, jnp.float32)
                                for n, a in tree["layers"]["mlp"].items()}}})
        tt = tq.quantize_decoder_params(
            {"embed": _t(tree["embed"]).float(),
             "layers": {"ln1": torch.ones(L, h),
                        "attn": {n: _t(a).float()
                                 for n, a in tree["layers"]["attn"].items()},
                        "mlp": {n: _t(a).float()
                                for n, a in tree["layers"]["mlp"].items()}}})
        np.testing.assert_array_equal(
            tt["logits_head"][tq.QUANT_KEY].numpy(),
            np.asarray(jt["logits_head"][jq.QUANT_KEY]))
        np.testing.assert_array_equal(
            tt["layers"]["mlp"]["down"][tq.QUANT_KEY].numpy(),
            np.asarray(jt["layers"]["mlp"]["down"][jq.QUANT_KEY]))
