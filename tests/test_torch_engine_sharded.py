"""The port's sharded serving engine (``Engine(..., mesh=...)``) on the CPU:
the cases of ``tests/test_engine_sharded.py``, tiny config, float32.

Greedy tokens of the port's engine at model=2 and at data=2 x model=2
(spawned gloo ranks on the CPU) equal the JAX engine's on a (data=2, fsdp=1,
model=2) mesh of the 8-device virtual CPU mesh and the port's one-device
engine, over the int8, int4 and float caches with n-gram speculation; the
ranks' cache shards have their kv heads and slots; the ranks of a model
group sample the same tokens at temperature 1; fsdp > 1 and kv heads that
do not split over "model" are refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karanta_tpu.inference.engine import Engine as JEngine
from karanta_tpu.inference.engine import EngineConfig as JEngineConfig
from karanta_tpu.inference.engine import GenRequest as JGenRequest
from karanta_tpu.inference.tokenizer import ByteTokenizer as JByteTokenizer
from karanta_tpu.models.qwen25_vl.config import tiny_config as j_tiny_config
from karanta_tpu.models.qwen25_vl.model import init_params as j_init_params
from karanta_tpu.parallel.mesh import MeshConfig as JMeshConfig
from karanta_tpu.parallel.mesh import create_mesh as j_create_mesh
from karanta_tpu_torch.inference.engine import Engine, EngineConfig, GenRequest
from karanta_tpu_torch.inference.tokenizer import ByteTokenizer
from karanta_tpu_torch.models.qwen25_vl.config import tiny_config
from karanta_tpu_torch.models.qwen25_vl.convert import from_jax_params
from karanta_tpu_torch.parallel.launch import run_ranks
from karanta_tpu_torch.parallel.mesh import AXIS_NAMES, Mesh
from tests.torch_ranks import RANK_TIMEOUT_S, engine_rank

KW = dict(max_batch_size=4, max_seq_len=128, decode_chunk=4,
          prefill_buckets=(64, 128), image_token_buckets=(16, 64))
ENGINES = {
    "int8": dict(KW, quantize="int8", kv_quantize="int8", act_quant="int8",
                 speculative_ngram=3),
    "int4": dict(KW, kv_quantize="int4", speculative_ngram=3),
    "float": dict(KW, speculative_ngram=3),
    "float_per_step": dict(KW),
}
JAX_CHECKED = ("int8", "int4", "float")
REQUESTS = ["alpha beta", "gamma", "abcabcabcabcabc", "The quick brown fox."]
MAX_TOKENS = 10


class _NoStopJ(JByteTokenizer):
    def __init__(self):
        super().__init__()
        self.eos_token_id = -1


class _NoStop(ByteTokenizer):
    def __init__(self):
        super().__init__()
        self.eos_token_id = -1


@pytest.fixture(scope="module")
def weights():
    jtok = _NoStopJ()
    jcfg = j_tiny_config(vocab_size=jtok.vocab_size)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    return jtok, jcfg, jparams, jax.tree.map(np.asarray, jparams)


@pytest.fixture(scope="module")
def single(weights):
    """The port's one-device engine: tokens per configuration."""
    _, _, _, np_params = weights
    tok = _NoStop()
    cfg = tiny_config(vocab_size=tok.vocab_size)
    params = from_jax_params(np_params, cfg, device="cpu",
                             dtype=torch.float32)
    out = {}
    for name, kw in ENGINES.items():
        engine = Engine(params, cfg, tok,
                        EngineConfig(dtype=torch.float32, **kw), device="cpu")
        out[name] = [r.token_ids for r in engine.generate([
            GenRequest(messages=[{"role": "user", "content": t}],
                       max_tokens=MAX_TOKENS, temperature=0.0,
                       request_id=str(i)) for i, t in enumerate(REQUESTS)])]
    return out


@pytest.fixture(scope="module")
def sharded(weights, tmp_path_factory):
    """Each rank's results at model=2 (2 ranks) and data=2 x model=2 (4)."""
    _, _, _, np_params = weights
    out = {}
    for data, model in ((1, 2), (2, 2)):
        spec = dict(params=np_params, data=data, model=model,
                    engines=ENGINES, requests=REQUESTS, max_tokens=MAX_TOKENS,
                    sampled=dict(KW) if data == 2 else None)
        url = f"file://{tmp_path_factory.mktemp('rdzv')}/store"
        out[(data, model)] = run_ranks(engine_rank, data * model, (spec,),
                                       init_url=url,
                                       timeout_s=4 * RANK_TIMEOUT_S)
    return out


@pytest.mark.parametrize("name", JAX_CHECKED)
def test_jax_mesh_engine_matches_port(weights, single, name):
    """The JAX engine on a (data=2, fsdp=1, model=2) mesh gives the port's
    one-device greedy tokens."""
    jtok, jcfg, jparams, _ = weights
    mesh = j_create_mesh(JMeshConfig(data=2, fsdp=1, model=2),
                         devices=jax.devices()[:4])
    engine = JEngine(jparams, jcfg, jtok,
                     JEngineConfig(dtype=jnp.float32, **ENGINES[name]),
                     mesh=mesh)
    got = [r.token_ids for r in engine.generate([
        JGenRequest(messages=[{"role": "user", "content": t}],
                    max_tokens=MAX_TOKENS, temperature=0.0,
                    request_id=str(i)) for i, t in enumerate(REQUESTS)])]
    assert got == single[name]


@pytest.mark.parametrize("name", list(ENGINES))
@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)], ids=["tp2", "dp2xtp2"])
def test_sharded_tokens_match_one_device(single, sharded, mesh, name):
    """Every rank of the sharded engine returns the one-device engine's
    greedy tokens (so also the JAX mesh engine's)."""
    for rank_out in sharded[mesh]:
        assert rank_out["tokens"][name] == single[name]
        assert all(len(t) == MAX_TOKENS for t in rank_out["tokens"][name])


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)], ids=["tp2", "dp2xtp2"])
def test_shard_shapes(sharded, mesh):
    """Rank coordinates follow the (data, model) layout; each rank's cache
    holds its kv heads (the tiny config's 2 over model=2) and its data
    group's slots (4 over data)."""
    data, model = mesh
    text = tiny_config(vocab_size=_NoStop().vocab_size).text
    n, d = text.num_layers, text.head_dim
    kvh = text.num_kv_heads // model
    for rank, out in enumerate(sharded[mesh]):
        assert out["coords"]["data"] == rank // model
        assert out["coords"]["model"] == rank % model
        slots = 4 // data
        assert out["cache"]["float"]["k"] == (n, slots, kvh, 128, d)
        assert out["cache"]["int8"]["ks"] == (n, slots, kvh, 128)
        assert out["cache"]["int4"]["k"] == (n, slots, kvh, 64, d)
        assert out["cache"]["int4"]["ks"] == (n, slots, 2 * kvh, 64)


def test_sampling_agrees_within_model_group(sharded):
    """At temperature 1 both ranks of each model group sample the same
    tokens at every step (their generators and logits agree), and every
    rank returns the same completions."""
    outs = sharded[(2, 2)]
    assert all(o["sampled"] == outs[0]["sampled"] for o in outs)
    steps = len(outs[0]["sampled_local"])
    assert steps > 0
    for group in ((0, 1), (2, 3)):
        a, b = (outs[r]["sampled_local"] for r in group)
        assert len(a) == len(b) == steps
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def _mesh_of(data=1, fsdp=1, model=1) -> Mesh:
    dims = dict(zip(AXIS_NAMES, (data, 1, fsdp, 1, model)))
    return Mesh(rank=0, dims=dims, coords={a: 0 for a in AXIS_NAMES},
                groups={a: None for a in AXIS_NAMES}, world_group=None,
                cpu_group=None, backend=None, device=torch.device("cpu"))


def test_unsupported_meshes_refused(weights):
    """fsdp > 1 is training's: NotImplementedError naming ROADMAP.md. kv heads
    (2 at the tiny config) over model=4, and slots over a data axis that
    does not divide them: ValueError."""
    _, _, _, np_params = weights
    tok = _NoStop()
    cfg = tiny_config(vocab_size=tok.vocab_size)
    params = from_jax_params(np_params, cfg, device="cpu",
                             dtype=torch.float32)
    ecfg = EngineConfig(dtype=torch.float32, **KW)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Engine(params, cfg, tok, ecfg, mesh=_mesh_of(data=2, fsdp=2, model=2))
    with pytest.raises(ValueError, match="num_kv_heads = 2.*'model'"):
        Engine(params, cfg, tok, ecfg, mesh=_mesh_of(model=4))
    with pytest.raises(ValueError, match="max_batch_size 4.*'data'"):
        Engine(params, cfg, tok, ecfg, mesh=_mesh_of(data=3))
