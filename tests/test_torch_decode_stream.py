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


@pytest.mark.parametrize("b", [1, 9])
@pytest.mark.parametrize("oracle", ["kernel", "reference"])
def test_dense_stream_matches_jax_at_batch_edges(dense_case, b, oracle):
    """As test_dense_stream_matches_jax at the CUDA body's n-tile edges: one
    batch row, and one row into a second tile of 8 (the instances hold 8,
    32, 80 and 128 rows)."""
    _, jsp, _, _ = dense_case
    rng = np.random.default_rng(10 + b)
    x = rng.normal(size=(b, H)) * 0.5
    attn_out = rng.normal(size=(L, b, H)) * 0.5
    fn = jds.dense_stream_reference if oracle == "reference" else (
        lambda *args: jds.dense_stream(*args, interpret=True))
    want_x, want_q = fn(_bf16(x), _bf16(attn_out), jsp)
    got_x, got_q = _dense_port(jsp, x, attn_out, ds.dense_stream)
    np.testing.assert_allclose(got_q, np.asarray(want_q, np.float32),
                               rtol=0.05, atol=0.03)
    np.testing.assert_allclose(got_x, np.asarray(want_x, np.float32),
                               rtol=0.05, atol=0.05)


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
    return _mega_case(MB, LENS, 2)


def _mega_case(mb: int, lens: list, seed: int) -> dict:
    """mega_case at mb slots of lengths lens, from numpy seed `seed`."""
    jcfg = JTextConfig(**MK)
    rng = np.random.default_rng(seed)
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
    shape = (nl, mb, jcfg.num_kv_heads, MM, hd)
    caches = (rng.integers(-127, 128, size=shape, dtype=np.int8),
              rng.integers(-127, 128, size=shape, dtype=np.int8),
              np.asarray(_bf16(rng.uniform(0.002, 0.02, size=shape[:-1]))),
              np.asarray(_bf16(rng.uniform(0.002, 0.02, size=shape[:-1]))))
    x = np.asarray(_bf16(rng.normal(size=(mb, h)) * 0.5))
    positions = torch.tensor(lens, dtype=torch.int32)[None].expand(3, mb)
    cos, sin = (t.numpy() for t in mrope_cos_sin(
        positions, hd, jcfg.mrope_section, jcfg.rope_theta))
    jsp = jds.pack_stream_params(qparams["layers"])
    out = jds.decode_megakernel(
        jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin), jsp,
        *(jnp.asarray(c) for c in caches), jnp.asarray(lens, jnp.int32),
        qd=qd, kvd=kvd, eps=jcfg.rms_norm_eps, interpret=True,
        spp=2 if mb % 2 == 0 else 1)  # the JAX kernel's slots a step
    return dict(qparams=_np(qparams), jsp=_np(jsp), caches=caches, x=x,
                cos=cos, sin=sin, positions=positions, qd=qd, kvd=kvd,
                lens=lens, jout=[np.asarray(o) for o in out])


def _port_mega(case):
    caches = [torch.from_numpy(np.asarray(c, np.float32)).bfloat16()
              if c.dtype != np.int8 else torch.from_numpy(c.copy())
              for c in case["caches"]]
    sp = stream_params_from_jax(case["jsp"], "cpu")
    x, *out = ds.decode_megakernel(
        torch.from_numpy(case["x"].astype(np.float32)).bfloat16(),
        torch.from_numpy(case["cos"]), torch.from_numpy(case["sin"]), sp,
        *caches, torch.tensor(case["lens"], dtype=torch.int32), qd=case["qd"],
        kvd=case["kvd"])
    assert all(o is c for o, c in zip(out, caches))  # updated in place
    return x, out


def _check_caches(got, want, inputs, lens=LENS):
    """Every entry but each slot's new row equals the input (and `want`);
    the new rows, dequantized, agree within 0.05."""
    worst = 0.0
    for part in (0, 1):
        q, s = (_as_np(got[part]), _as_np(got[part + 2]))
        wq, wsc = (_as_np(want[part]), _as_np(want[part + 2]))
        iq, isc = inputs[part], np.asarray(inputs[part + 2], np.float32)
        for b, n in enumerate(lens):
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


@pytest.mark.parametrize("mb,lens", [(1, [MM - 1]),
                                     (9, [0, 5, 33, 100, MM - 1, 64, 1, 126,
                                          17])])
def test_megakernel_matches_jax_at_batch_edges(mb, lens):
    """As test_megakernel_matches_jax at the CUDA body's n-tile edges (one
    slot, and one slot into a second tile of 8), a slot at M - 1."""
    case = _mega_case(mb, lens, 20 + mb)
    x, out = _port_mega(case)
    jx, *jcaches = case["jout"]
    _check_caches(out, jcaches, case["caches"], lens)
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
    """bench/stream_trace.py finds its anchors in the tree's decode_stream.cu
    (the stamps in grid_sync, at the kernel's start and end, the two ring
    waits it times) and exports its two C entries."""
    from karanta_tpu_torch.bench import stream_trace
    from karanta_tpu_torch.kernels.build import CSRC

    src = (CSRC / "decode_stream.cu").read_text()
    out = stream_trace.instrument(src)
    assert out.count("trace_stamp();") == 4  # 2 in grid_sync, start, end
    for name, slot, _ in stream_trace._WAITS:
        assert f"karanta_trace_wait[2 * blockIdx.x + {slot}]" in out, name
        assert src.count(f"{name}(&") >= 1, name  # the products call it
    assert "karanta_trace_reset" in out and "karanta_trace_read" in out


def _synthetic_stamps(n_phases: int):
    """Two blocks, one layer: interval j ("start", the prologue, then the
    layer's phases) takes j + 1 us on block 0 and j + 2 us on block 1, each
    barrier releasing 1 us after the last arrival; the last interval ends
    the call."""
    stamps = [[0], [0]]
    t = 0
    for j in range(n_phases + 2):
        arrive = [t + (j + 1) * 1000, t + (j + 2) * 1000]
        if j == n_phases + 1:
            for b in range(2):
                stamps[b].append(arrive[b])
            return stamps, arrive[1]
        leave = max(arrive) + 1000
        for b in range(2):
            stamps[b] += [arrive[b], leave]
        t = leave


def test_stream_trace_analysis():
    """The per-phase sums from synthetic stamps of the megakernel's barriers
    (one before layer 0, then its eight phases a layer but the last), and
    the ring waits' means and shares of the product phases."""
    _check_analysis("decode_megakernel")


def test_stream_trace_analysis_dense():
    """As test_stream_trace_analysis for dense_stream's five phases."""
    _check_analysis("dense_stream")


def _check_analysis(name: str) -> None:
    from karanta_tpu_torch.bench import stream_trace

    names = stream_trace.PHASES[name]
    stamps, end = _synthetic_stamps(len(names))
    waits = [(1000, 2000), (3000, 4000)]
    res = stream_trace.analyse(stamps, 1, name, waits)
    assert res["barriers"] == len(names) + 1
    assert [round(res["phase_ms"][k] * 1e3, 6)
            for k in ("start", "prologue") + names] == [
        j + 2.0 for j in range(len(names) + 2)]
    assert round(res["barrier_release_ms"] * 1e3, 6) == len(names) + 1
    for j, k in enumerate(names, start=2):
        assert round(res["mean_block_busy_ms"][k] * 1e3, 6) == j + 1.5
    assert round(res["total_ms"] * 1e3, 6) == round(end * 1e-3, 6)
    products = sum(j + 1.5 for j, k in enumerate(names, start=2)
                   if "products" in k) * 1e-3
    assert res["producer_wait_free_ms"] == pytest.approx(2e-3)
    assert res["consumer_wait_landed_ms"] == pytest.approx(3e-3)
    assert res["producer_wait_free_share"] == pytest.approx(2e-3 / products)
    with pytest.raises(ValueError, match="barriers"):
        stream_trace.analyse(stamps, 2, name)


def test_stream_work_counts_the_7b():
    """The bytes both the smoke and the bench tool hold the streams to: the
    7B decoder's 6.53 GB of int8 weights (with scales, norms, biases and the
    activations), and for the megakernel the live K/V rows with their scales
    plus the new rows."""
    from karanta_tpu_torch.bench.stream_trace import stream_work
    from karanta_tpu_torch.models.qwen25_vl.config import get_config

    cfg = get_config("qwen2.5-vl-7b")
    t = cfg.text
    h, ff, d, kvh = t.hidden_size, t.intermediate_size, t.head_dim, \
        t.num_kv_heads
    qd, qkv = t.num_heads * d, t.num_heads * d + 2 * kvh * d
    weights = t.num_layers * (h * qkv + qd * h + 3 * h * ff)
    assert round(weights / 1e9, 2) == 6.53
    dense, dense_flops = stream_work(cfg, 4, [0, 1, 2, 3], mega=False)
    mega, mega_flops = stream_work(cfg, 4, [0, 1, 2, 3], mega=True)
    assert weights < dense < weights * 1.01
    assert dense_flops == 2.0 * 4 * weights
    lens = [0, 33, 1390, 1919]
    mega, _ = stream_work(cfg, 4, lens, mega=True)
    base, _ = stream_work(cfg, 4, [0] * 4, mega=True)
    row = t.num_layers * kvh * (d + 2) * 2  # a K and a V row and scales
    assert mega - base == row * sum(lens)
    assert base - dense == (2 * 4 * d * 4 + 4 * 4 + row * 4
                            - t.num_layers * 4 * (h + qkv) * 2)
