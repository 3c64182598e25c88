"""Rank functions of the sharded-serving tests of the PyTorch port.

Each runs in a spawned process (``karanta_tpu_torch.parallel.launch.
run_ranks``), joins a gloo group on the CPU through the test's ``file://``
rendezvous and returns numpy arrays and lists. The module imports no JAX:
the spawned ranks import it by name.
"""

from __future__ import annotations

import numpy as np
import torch

from karanta_tpu_torch.parallel.mesh import (MeshConfig, create_mesh,
                                             initialize_distributed)

RANK_TIMEOUT_S = 60.0


def join(rank: int, world: int, url: str, data: int, model: int):
    torch.set_num_threads(1)
    initialize_distributed(url, world, rank, backend="gloo", device="cpu",
                           timeout_s=RANK_TIMEOUT_S)
    return create_mesh(MeshConfig(data=data, fsdp=1, model=model),
                       device="cpu")


def products_rank(rank: int, world: int, url: str, x: np.ndarray,
                  w: np.ndarray) -> dict:
    """The row-parallel products of ops/quantization.py on this rank's half
    of the input dim, and the collective helpers."""
    from karanta_tpu_torch.ops.quantization import (matmul, matmul_auto,
                                                    matmul_w8a8,
                                                    quantize_weight)
    from karanta_tpu_torch.parallel.sharding import (all_gather_last,
                                                     all_reduce_max,
                                                     broadcast_objects,
                                                     gather_objects,
                                                     shard_leaf,
                                                     shard_quantized)

    mesh = join(rank, world, url, 1, world)
    group = mesh.group("model")
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    axes = ("mlp", "embed")  # row-parallel: the input dim over "model"
    x_loc = shard_leaf(xt, (None,) * (xt.dim() - 1) + ("mlp",), mesh)
    wq = shard_quantized(quantize_weight(wt), axes, mesh)
    w_loc = shard_leaf(wt, axes, mesh)
    gathered = all_gather_last(torch.arange(3) + 10 * rank, group)
    return {
        "w8a8": matmul_w8a8(x_loc, wq, group).numpy(),
        "weight_only": matmul(x_loc, wq, group).numpy(),
        "plain": matmul(x_loc, w_loc, group).numpy(),
        "auto_plain": matmul_auto(x_loc, w_loc, group).numpy(),
        "gathered": gathered.numpy(),
        "max": all_reduce_max(torch.tensor([float(rank), -rank]),
                              group).numpy(),
        "objects": broadcast_objects([rank, {"r": rank}], 1,
                                     mesh.cpu_group),
        "gathered_objects": gather_objects(rank, 0, mesh.cpu_group),
        "coords": mesh.coords,
    }


def engine_rank(rank: int, world: int, url: str, spec: dict) -> dict:
    """Build the sharded engine of each configuration in spec["engines"]
    over the JAX-initialised tiny weights (numpy), run spec["requests"]
    through generate and return the tokens, this rank's cache shapes and
    its mesh coordinates. spec["sampled"] also runs sampled requests and
    returns each step's locally sampled tokens before they are gathered."""
    from karanta_tpu_torch.inference.engine import (Engine, EngineConfig,
                                                    GenRequest)
    from karanta_tpu_torch.inference.tokenizer import ByteTokenizer
    from karanta_tpu_torch.models.qwen25_vl.config import tiny_config
    from karanta_tpu_torch.models.qwen25_vl.convert import from_jax_params

    mesh = join(rank, world, url, spec["data"], spec["model"])
    tok = ByteTokenizer()
    tok.eos_token_id = -1  # every request runs to its token budget
    cfg = tiny_config(vocab_size=tok.vocab_size)
    params = from_jax_params(spec["params"], cfg, device="cpu",
                             dtype=torch.float32)
    out = {"coords": mesh.coords, "tokens": {}, "cache": {}}

    def requests(temperature):
        return [GenRequest(messages=[{"role": "user", "content": text}],
                           max_tokens=spec["max_tokens"],
                           temperature=temperature, request_id=str(i))
                for i, text in enumerate(spec["requests"])]

    for name, kw in spec["engines"].items():
        engine = Engine(params, cfg, tok,
                        EngineConfig(dtype=torch.float32, **kw), mesh=mesh)
        out["tokens"][name] = [r.token_ids
                               for r in engine.generate(requests(0.0))]
        out["cache"][name] = {k: tuple(getattr(engine.cache, k).shape)
                              for k in ("k", "v", "ks", "vs")
                              if hasattr(engine.cache, k)}
    if spec.get("sampled"):
        engine = Engine(params, cfg, tok, EngineConfig(
            dtype=torch.float32, **spec["sampled"]), mesh=mesh)
        local = []
        gather = engine._gather_slots

        def record(x, check=True):
            if check:
                local.append(x.numpy().copy())
            return gather(x, check)

        engine._gather_slots = record
        out["sampled"] = [r.token_ids
                          for r in engine.generate(requests(1.0))]
        out["sampled_local"] = local
    return out


def card_engine_rank(rank: int, world: int, url: str, spec: dict) -> dict:
    """The tiny engine at model=world on the card (ranks share it over
    gloo), seeded weights: greedy tokens and the decode steps' logits of
    this rank's slots."""
    from karanta_tpu_torch.inference.engine import Engine, EngineConfig
    from karanta_tpu_torch.inference.tokenizer import ByteTokenizer
    from karanta_tpu_torch.models.qwen25_vl.config import tiny_config
    from karanta_tpu_torch.models.qwen25_vl.model import init_params
    from karanta_tpu_torch.utils.tree import tree_map

    initialize_distributed(url, world, rank, backend="gloo", device="cuda",
                           timeout_s=RANK_TIMEOUT_S)
    mesh = create_mesh(MeshConfig(data=1, fsdp=1, model=world))
    tok = ByteTokenizer()
    cfg = tiny_config(vocab_size=tok.vocab_size)
    params = tree_map(lambda x, _: x.to(mesh.device),
                      init_params(cfg, 0, torch.float32, device="cpu"))
    engine = Engine(params, cfg, tok, EngineConfig(**spec["engine"]),
                    mesh=mesh)
    return card_engine_trace(engine, spec["requests"])


def card_engine_trace(engine, requests: list) -> dict:
    """Each request prefilled into its slot, then decode steps with their
    logits; then generate over the requests."""
    from karanta_tpu_torch.inference.engine import GenRequest

    reqs = [GenRequest(messages=[{"role": "user", "content": text}],
                       max_tokens=12, request_id=str(i))
            for i, text in enumerate(requests)]
    for slot, req in enumerate(reqs):
        prepared = engine.prepare(req)
        engine.agree(prepared)
        engine.prefill_insert(slot, prepared)
    steps: list = []
    engine.decode_chunk(4, logits_out=steps)
    for slot in range(len(reqs)):
        engine.free_slot(slot)
    return {"logits": torch.stack(steps).float().cpu(),
            "tokens": [r.token_ids for r in engine.generate(reqs)]}
