"""The port's decode weight streams (``ops/decode_stream.py``) against the
JAX package's ``dense_stream`` and ``decode_megakernel`` (run with
``interpret=True`` on the CPU), with the limits of
``tests/test_decode_stream.py``. Inputs come from numpy seeds; the packed
weights reach the port through ``convert.stream_params_from_jax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karanta_tpu.models.qwen25_vl.config import TextConfig as JTextConfig
from karanta_tpu.ops import decode_stream as jds
from karanta_tpu.ops.quantization import quantize_decoder_params as j_qdp
from karanta_tpu.ops.quantization import quantize_weight as j_quantize
from karanta_tpu_torch.models.qwen25_vl import decoder as dec
from karanta_tpu_torch.models.qwen25_vl.config import TextConfig
from karanta_tpu_torch.models.qwen25_vl.convert import stream_params_from_jax
from karanta_tpu_torch.ops import decode_stream as ds
from karanta_tpu_torch.ops.norms import rms_norm
from karanta_tpu_torch.ops.quantization import QUANT_KEY, out_major
from karanta_tpu_torch.ops.rotary import mrope_cos_sin

L, B, H, QD, KVD, FF = 3, 8, 512, 512, 128, 512  # test_decode_stream.py:13


def _bf16(a):
    return jnp.asarray(np.asarray(a, np.float32), jnp.bfloat16)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_layers(jlayers, dtype=torch.bfloat16):
    """JAX layers (numpy leaves) -> the port's: int8 leaves out-major,
    float32 scales, the rest in dtype."""
    if isinstance(jlayers, dict) and QUANT_KEY in jlayers:
        return {QUANT_KEY: out_major(torch.from_numpy(
                    np.asarray(jlayers[QUANT_KEY]).copy())),
                "scale": torch.from_numpy(
                    np.array(jlayers["scale"], np.float32))}
    if isinstance(jlayers, dict):
        return {k: _port_layers(v, dtype) for k, v in jlayers.items()}
    return torch.from_numpy(np.array(jlayers, np.float32)).to(dtype)


def _dense_layers(seed=0):
    """The JAX test's layer shapes, weights from a numpy seed."""
    rng = np.random.default_rng(seed)

    def dense(shape, scale=0.05):
        return _bf16(rng.normal(size=shape) * scale)

    return {
        "ln1": _bf16(1.0 + 0.1 * rng.normal(size=(L, H))),
        "ln2": _bf16(1.0 + 0.1 * rng.normal(size=(L, H))),
        "attn": {"wq": j_quantize(dense((L, H, QD))),
                 "wk": j_quantize(dense((L, H, KVD))),
                 "wv": j_quantize(dense((L, H, KVD))),
                 "wo": j_quantize(dense((L, QD, H))),
                 "bq": dense((L, QD), 0.01), "bk": dense((L, KVD), 0.01),
                 "bv": dense((L, KVD), 0.01)},
        "mlp": {"gate": j_quantize(dense((L, H, FF))),
                "up": j_quantize(dense((L, H, FF))),
                "down": j_quantize(dense((L, FF, H)))},
    }


@pytest.fixture(scope="module")
def dense_case():
    jlayers = _dense_layers()
    jsp = jds.pack_stream_params(jlayers)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, H)) * 0.5
    attn_out = rng.normal(size=(L, B, H)) * 0.5
    return jlayers, jsp, x, attn_out


def _as_np(a) -> np.ndarray:
    """A torch or numpy array as numpy: int8 stays int8, the rest float32."""
    if isinstance(a, torch.Tensor):
        return a.numpy() if a.dtype == torch.int8 else a.float().numpy()
    return np.asarray(a) if a.dtype == np.int8 else np.asarray(a, np.float32)


def test_pack_stream_params_matches_jax(dense_case):
    jlayers, jsp, _, _ = dense_case
    sp = ds.pack_stream_params(_port_layers(_np(jlayers)))
    assert sorted(sp) == sorted(jsp)
    for key, want in _np(jsp).items():
        got = sp[key]
        assert tuple(got.shape) == want.shape, key
        np.testing.assert_array_equal(_as_np(got), _as_np(want), err_msg=key)
    # the layout the kernels read: each output column's K bytes contiguous
    for key in ("wqkv", "wo", "wd"):
        assert sp[key].transpose(-1, -2).is_contiguous(), key
    for key in ("wg_t", "wu_t"):
        assert sp[key].is_contiguous(), key


def test_stream_bridge_matches_pack(dense_case):
    """The weight bridge gives pack_stream_params' values and layout."""
    jlayers, jsp, _, _ = dense_case
    bridged = stream_params_from_jax(_np(jsp), "cpu")
    packed = ds.pack_stream_params(_port_layers(_np(jlayers)))
    for key, got in bridged.items():
        assert got.dtype == packed[key].dtype, key
        assert got.stride() == packed[key].stride(), key
        assert torch.equal(got, packed[key]), key


def _dense_port(jsp, x, attn_out, fn):
    sp = stream_params_from_jax(_np(jsp), "cpu")
    gx, gq = fn(torch.from_numpy(x.astype(np.float32)).bfloat16(),
                torch.from_numpy(attn_out.astype(np.float32)).bfloat16(), sp)
    return gx.float().numpy(), gq.float().numpy()


@pytest.mark.parametrize("oracle", ["kernel", "reference"])
def test_dense_stream_matches_jax(dense_case, oracle):
    """The port's dense_stream (its plain version on the CPU) against the JAX
    kernel in interpret mode and against the JAX reference, within the JAX
    test's limits (max errors seen: see CHANGES.md)."""
    _, jsp, x, attn_out = dense_case
    if oracle == "kernel":
        want_x, want_q = jds.dense_stream(_bf16(x), _bf16(attn_out), jsp,
                                          interpret=True)
    else:
        want_x, want_q = jds.dense_stream_reference(_bf16(x), _bf16(attn_out),
                                                    jsp)
    got_x, got_q = _dense_port(jsp, x, attn_out, ds.dense_stream)
    want_x = np.asarray(want_x, np.float32)
    want_q = np.asarray(want_q, np.float32)
    print(f"dense_stream vs JAX {oracle}: qkv max err "
          f"{np.abs(got_q - want_q).max():.3e}, x max err "
          f"{np.abs(got_x - want_x).max():.3e}")
    np.testing.assert_allclose(got_q, want_q, rtol=0.05, atol=0.03)
    np.testing.assert_allclose(got_x, want_x, rtol=0.05, atol=0.05)


def test_dense_stream_reference_matches_jax(dense_case):
    """The port's copy of the oracle against the JAX one (same rounding
    points: only float32 summation order differs)."""
    _, jsp, x, attn_out = dense_case
    want_x, want_q = jds.dense_stream_reference(_bf16(x), _bf16(attn_out), jsp)
    got_x, got_q = _dense_port(jsp, x, attn_out, ds.dense_stream_reference)
    np.testing.assert_allclose(got_q, np.asarray(want_q, np.float32),
                               rtol=0.02, atol=0.01)
    np.testing.assert_allclose(got_x, np.asarray(want_x, np.float32),
                               rtol=0.02, atol=0.02)


@pytest.mark.parametrize("h,ff", [(384, 512), (512, 384)])
def test_dense_stream_refuses_what_jax_refuses(h, ff):
    """h and ff must be multiples of 256 in both packages."""
    n = 2
    sp = {"wqkv": torch.zeros((n, h, h + 256), dtype=torch.int8),
          "wd": torch.zeros((n, ff, h), dtype=torch.int8)}
    with pytest.raises(ValueError, match="multiples"):
        ds.dense_stream(torch.zeros((4, h)), torch.zeros((n, 4, h)), sp)
    jsp = {k: jnp.asarray(v.numpy()) for k, v in sp.items()}
    with pytest.raises(AssertionError):
        jds.dense_stream(jnp.zeros((4, h), jnp.bfloat16),
                         jnp.zeros((n, 4, h), jnp.bfloat16), jsp,
                         interpret=True)


# ---------------------------------------------------------------------------
# the megakernel on TestMegakernel's tiny config
# ---------------------------------------------------------------------------

MK = dict(vocab_size=256, hidden_size=256, num_layers=2, num_heads=4,
          num_kv_heads=2, head_dim=64, intermediate_size=512,
          tie_word_embeddings=True, mrope_section=(8, 12, 12))
MB, MM, LENS = 4, 128, [0, 5, 33, 100]


@pytest.fixture(scope="module")
def mega_case():
    """JAX int8 decoder params from a numpy seed, a random int8 cache, the
    step's embeddings and rope tables; the JAX megakernel's outputs."""
    jcfg = JTextConfig(**MK)
    rng = np.random.default_rng(2)
    h, nl, hd = jcfg.hidden_size, jcfg.num_layers, jcfg.head_dim
    qd, kvd, ff = jcfg.num_heads * hd, jcfg.num_kv_heads * hd, \
        jcfg.intermediate_size

    def stack(shape):
        return _bf16(rng.normal(size=(nl,) + shape) / np.sqrt(shape[0]))

    layers = {"ln1": _bf16(1.0 + 0.1 * rng.normal(size=(nl, h))),
              "ln2": _bf16(1.0 + 0.1 * rng.normal(size=(nl, h))),
              "attn": {"wq": stack((h, qd)), "wk": stack((h, kvd)),
                       "wv": stack((h, kvd)), "wo": stack((qd, h)),
                       "bq": _bf16(rng.normal(size=(nl, qd)) * 0.02),
                       "bk": _bf16(rng.normal(size=(nl, kvd)) * 0.02),
                       "bv": _bf16(rng.normal(size=(nl, kvd)) * 0.02)},
              "mlp": {"gate": stack((h, ff)), "up": stack((h, ff)),
                      "down": stack((ff, h))}}
    qparams = j_qdp({"layers": layers,
                     "embed": _bf16(rng.normal(size=(256, h)) * 0.02),
                     "final_norm": _bf16(1.0 + 0.1 * rng.normal(size=(h,)))})
    shape = (nl, MB, jcfg.num_kv_heads, MM, hd)
    caches = (rng.integers(-127, 128, size=shape, dtype=np.int8),
              rng.integers(-127, 128, size=shape, dtype=np.int8),
              np.asarray(_bf16(rng.uniform(0.002, 0.02, size=shape[:-1]))),
              np.asarray(_bf16(rng.uniform(0.002, 0.02, size=shape[:-1]))))
    x = np.asarray(_bf16(rng.normal(size=(MB, h)) * 0.5))
    positions = torch.tensor(LENS, dtype=torch.int32)[None].expand(3, MB)
    cos, sin = (t.numpy() for t in mrope_cos_sin(
        positions, hd, jcfg.mrope_section, jcfg.rope_theta))
    jsp = jds.pack_stream_params(qparams["layers"])
    out = jds.decode_megakernel(
        jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin), jsp,
        *(jnp.asarray(c) for c in caches), jnp.asarray(LENS, jnp.int32),
        qd=qd, kvd=kvd, eps=jcfg.rms_norm_eps, interpret=True)
    return dict(qparams=_np(qparams), jsp=_np(jsp), caches=caches, x=x,
                cos=cos, sin=sin, positions=positions, qd=qd, kvd=kvd,
                jout=[np.asarray(o) for o in out])


def _port_mega(case):
    caches = [torch.from_numpy(np.asarray(c, np.float32)).bfloat16()
              if c.dtype != np.int8 else torch.from_numpy(c.copy())
              for c in case["caches"]]
    sp = stream_params_from_jax(case["jsp"], "cpu")
    x, *out = ds.decode_megakernel(
        torch.from_numpy(case["x"].astype(np.float32)).bfloat16(),
        torch.from_numpy(case["cos"]), torch.from_numpy(case["sin"]), sp,
        *caches, torch.tensor(LENS, dtype=torch.int32), qd=case["qd"],
        kvd=case["kvd"])
    assert all(o is c for o, c in zip(out, caches))  # updated in place
    return x, out


def _check_caches(got, want, inputs):
    """Every entry but each slot's new row equals the input (and `want`);
    the new rows, dequantized, agree within 0.05."""
    worst = 0.0
    for part in (0, 1):
        q, s = (_as_np(got[part]), _as_np(got[part + 2]))
        wq, wsc = (_as_np(want[part]), _as_np(want[part + 2]))
        iq, isc = inputs[part], np.asarray(inputs[part + 2], np.float32)
        for b, n in enumerate(LENS):
            keep = np.arange(MM) != n
            for arr, ref in ((q, iq), (q, wq), (s, isc), (s, wsc)):
                np.testing.assert_array_equal(arr[:, b, :, keep],
                                              np.asarray(ref, arr.dtype)[
                                                  :, b, :, keep])
            new = q[:, b, :, n].astype(np.float32) * s[:, b, :, n, None]
            ref = wq[:, b, :, n].astype(np.float32) * wsc[:, b, :, n, None]
            worst = max(worst, float(np.abs(new - ref).max()))
            np.testing.assert_allclose(new, ref, atol=0.05)
    return worst


def test_megakernel_matches_jax(mega_case):
    x, out = _port_mega(mega_case)
    jx, *jcaches = mega_case["jout"]
    worst = _check_caches(out, jcaches, mega_case["caches"])
    err = float(np.abs(x.float().numpy() - np.asarray(jx, np.float32)).max())
    print(f"megakernel vs JAX: x max err {err:.3e}, new rows max err "
          f"{worst:.3e}")
    np.testing.assert_allclose(x.float().numpy(), np.asarray(jx, np.float32),
                               rtol=0.06, atol=0.06)


def test_megakernel_matches_decode_step(mega_case):
    """As the JAX test: the megakernel against the port's own decode_step
    (split path) over the same int8 cache, after the final norm."""
    cfg = TextConfig(**MK)
    x, out = _port_mega(mega_case)
    params = _port_layers(mega_case["qparams"])
    cache = dec.QuantKVCache(*(
        torch.from_numpy(c.copy()) if c.dtype == np.int8
        else torch.from_numpy(np.asarray(c, np.float32)).bfloat16()
        for c in mega_case["caches"]))
    embeds = torch.from_numpy(mega_case["x"].astype(np.float32)).bfloat16()
    ref, _ = dec.decode_step(params, cfg, embeds[:, None],
                             mega_case["positions"], cache,
                             torch.tensor(LENS, dtype=torch.int32))
    _check_caches(out, [cache.k, cache.v, cache.ks, cache.vs],
                  mega_case["caches"])
    got = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    np.testing.assert_allclose(got.float().numpy(),
                               ref[:, 0].float().numpy(), rtol=0.06,
                               atol=0.06)


def test_megakernel_refuses_what_jax_refuses(mega_case):
    """A bucket that is no multiple of 32 is refused in both packages; a
    cache_len outside [0, M) is clamped into it, as the kernel does."""
    cfg = TextConfig(**MK)
    sp = stream_params_from_jax(mega_case["jsp"], "cpu")
    kw = dict(qd=mega_case["qd"], kvd=mega_case["kvd"])

    def caches(m):
        shape = (cfg.num_layers, MB, cfg.num_kv_heads, m, cfg.head_dim)
        return (torch.zeros(shape, dtype=torch.int8),
                torch.zeros(shape, dtype=torch.int8),
                torch.ones(shape[:-1]), torch.ones(shape[:-1]))

    x = torch.zeros((MB, cfg.hidden_size))
    cs = torch.zeros((MB, cfg.head_dim))
    lens = torch.zeros(MB, dtype=torch.int32)
    with pytest.raises(ValueError, match="bucket"):
        ds.decode_megakernel(x, cs, cs, sp, *caches(144), lens, **kw)
    with pytest.raises(ValueError, match="bucket"):
        jds.decode_megakernel(
            jnp.asarray(x.numpy()), jnp.asarray(cs.numpy()),
            jnp.asarray(cs.numpy()), mega_case["jsp"],
            *(jnp.asarray(c.numpy()) for c in caches(144)),
            jnp.asarray(lens.numpy()), interpret=True, **kw)

    def run(lens):
        got = [torch.from_numpy(c.copy()) if c.dtype == np.int8
               else torch.from_numpy(np.asarray(c, np.float32)).bfloat16()
               for c in mega_case["caches"]]
        x_out, *_ = ds.decode_megakernel(
            torch.from_numpy(mega_case["x"].astype(np.float32)).bfloat16(),
            torch.from_numpy(mega_case["cos"]),
            torch.from_numpy(mega_case["sin"]), sp, *got,
            torch.tensor(lens, dtype=torch.int32), **kw)
        return x_out, got

    x_bad, bad = run([MM, MM + 70, -3, 5])
    x_in, inside = run([MM - 1, MM - 1, 0, 5])
    assert torch.equal(x_bad, x_in)
    assert all(torch.equal(p, q) for p, q in zip(bad, inside))


def test_stream_trace_instruments_the_kernel():
    """bench/stream_trace.py finds its three anchors in the tree's
    decode_stream.cu (the stamps in grid_sync, at the kernel's start and
    after its final row phase) and exports its two C entries."""
    from karanta_tpu_torch.bench import stream_trace
    from karanta_tpu_torch.kernels.build import CSRC

    out = stream_trace.instrument((CSRC / "decode_stream.cu").read_text())
    assert out.count("trace_stamp();") == 4  # 2 in grid_sync, start, end
    assert "karanta_trace_reset" in out and "karanta_trace_read" in out


def test_stream_trace_analysis():
    """The per-phase sums from synthetic stamps: two blocks, one layer of
    the megakernel's seven barriers, phase j taking j + 1 us on block 0 and
    j + 2 us on block 1, each barrier releasing 1 us after the last
    arrival."""
    from karanta_tpu_torch.bench import stream_trace

    stamps = [[0], [0]]
    t = 0
    for j in range(7):
        arrive = [t + (j + 1) * 1000, t + (j + 2) * 1000]
        leave = max(arrive) + 1000
        for b in range(2):
            stamps[b] += [arrive[b], leave]
        t = leave
    for b in range(2):
        stamps[b].append(t + 500)
    res = stream_trace.analyse(stamps, 1)
    names = stream_trace.PHASES[7]
    assert [round(res["phase_ms"][k] * 1e3, 6) for k in names] == [
        j + 2.0 for j in range(7)]
    assert round(res["barrier_release_ms"] * 1e3, 6) == 7.0
    assert round(res["mean_block_busy_ms"]["attention"] * 1e3, 6) == 3.5
    assert round(res["total_ms"] * 1e3, 6) == round(t * 1e-3 + 0.5, 6)
