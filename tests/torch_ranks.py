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


# ---------------------------------------------------------------------------
# parallel training: each job takes (mesh, spec); ``jobs_rank`` joins the
# group once and runs a list of them
# ---------------------------------------------------------------------------


def join_mesh(rank: int, world: int, url: str, dims: dict,
              device: str = "cpu"):
    """Join the gloo group and lay the ranks out as `dims` (MeshConfig's
    fields: data, fsdp, model, seq, pipe)."""
    torch.set_num_threads(1)
    initialize_distributed(url, world, rank, backend="gloo", device=device,
                           timeout_s=RANK_TIMEOUT_S)
    return create_mesh(MeshConfig(**{"data": 1, **dims}), device=device)


def jobs_rank(rank: int, world: int, url: str, dims: dict,
              jobs: list) -> list:
    """Run each (job name, spec) of `jobs` on one mesh; their results in
    order."""
    mesh = join_mesh(rank, world, url, dims)
    return [globals()[name](mesh, spec) for name, spec in jobs]


def _tensors(batch: dict, device="cpu") -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items() if v is not None}


# the JAX package's rules for cutting global attention inputs into a rank's
# block (its shard_map specs), to give the port's ranks the JAX blocks


def attention_layout(mesh, b: int, h: int, kvh: int,
                     batch_axis: str = "data",
                     heads_axis: str = "model") -> tuple[bool, bool]:
    """(batch split over `batch_axis`, heads split over `heads_axis`) for
    global attention inputs of batch b and h / kvh heads: the JAX package's
    fallbacks (heads only when both counts divide the axis, the batch only
    when it divides)."""
    m, d = mesh.size(heads_axis), mesh.size(batch_axis)
    return (d > 1 and b % d == 0), (m > 1 and h % m == 0 and kvh % m == 0)


def shard_attention_inputs(mesh, q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, kv_mask=None,
                           seq_axis: str = "seq", batch_axis: str = "data",
                           heads_axis: str = "model") -> tuple:
    """This rank's block of global (B, S, H|KVH, D) attention inputs and
    (B, S) mask, cut by ``attention_layout`` and ``seq_chunk``. Returns
    (q, k, v, kv_mask, index) with index the (rows, positions, q heads)
    slices of the global output this rank computes."""
    from karanta_tpu_torch.parallel.context import seq_chunk

    b, s, h, _ = q.shape
    kvh = k.shape[2]
    bsplit, hsplit = attention_layout(mesh, b, h, kvh, batch_axis,
                                      heads_axis)
    off, chunk = seq_chunk(mesh, s, seq_axis)
    rows = slice(None)
    if bsplit:
        per = b // mesh.size(batch_axis)
        rows = slice(mesh.index(batch_axis) * per,
                     (mesh.index(batch_axis) + 1) * per)
    pos = slice(off, off + chunk)
    qh = kh = slice(None)
    if hsplit:
        m, i = mesh.size(heads_axis), mesh.index(heads_axis)
        qh = slice(i * h // m, (i + 1) * h // m)
        kh = slice(i * kvh // m, (i + 1) * kvh // m)
    mask = None if kv_mask is None else kv_mask[rows, pos]
    return (q[rows, pos, qh], k[rows, pos, kh], v[rows, pos, kh], mask,
            (rows, pos, qh))


def context_job(mesh, spec: dict) -> dict:
    """The port's context-parallel attention on this rank's block of
    global q, k, v (and mask): its output block, the gradients of
    sum(out ** 2) over the ranks with respect to its q, k, v blocks, and
    the global slices they belong to (rows, positions, q heads, kv
    heads)."""
    from karanta_tpu_torch.parallel.context import \
        make_context_parallel_attention

    t = _tensors(spec)
    q, k, v, mask, (rows, pos, qh) = shard_attention_inputs(
        mesh, t["q"], t["k"], t["v"], t.get("mask"))
    g = t["q"].shape[2] // t["k"].shape[2]
    kh = slice(None) if qh.start is None else slice(qh.start // g,
                                                    qh.stop // g)
    q, k, v = (x.clone().requires_grad_(True) for x in (q, k, v))
    out = make_context_parallel_attention(mesh)(q, k, v, kv_mask=mask,
                                                causal=True)
    (out ** 2).sum().backward()
    return {"out": out.detach().numpy(), "dq": q.grad.numpy(),
            "dk": k.grad.numpy(), "dv": v.grad.numpy(),
            "index": (rows, pos, qh, kh)}


def _data_rows(mesh, b: int) -> slice:
    """This rank's rows of a b-row batch over "data" (all of them when b
    does not divide the axis), as the trainer feeds them."""
    nd = mesh.size("data")
    if nd > 1 and b % nd == 0:
        per = b // nd
        return slice(mesh.index("data") * per,
                     (mesh.index("data") + 1) * per)
    return slice(None)


def pipeline_job(mesh, spec: dict) -> dict:
    """The toy layer stack of the JAX pipeline tests under the port's
    pipeline_apply, on this rank's rows: the outputs for each n_micro of
    spec["n_micro"], and with spec["grad"] (an n_micro) the gradients of
    sum(out ** 2) over the ranks' rows, whole layers and this rank's x."""
    from karanta_tpu_torch.parallel.pipeline import pipeline_apply

    t = _tensors(spec["inputs"])
    layers = {"w": t["w"], "b": t["b"]}
    rows = _data_rows(mesh, t["x"].shape[0])
    x, extras = t["x"][rows], {"scale": t["scale"][rows]}

    def layer_fn(a, lyr, ext):
        return torch.tanh(a @ lyr["w"] + lyr["b"]) * ext["scale"]

    out: dict = {"rows": rows, "outs": {}}
    for n_micro in spec["n_micro"]:
        out["outs"][n_micro] = pipeline_apply(mesh, layer_fn, layers, x,
                                              extras, n_micro).numpy()
    if spec.get("grad"):
        live = {k: v.clone().requires_grad_(True) for k, v in layers.items()}
        xl = x.clone().requires_grad_(True)
        y = pipeline_apply(mesh, layer_fn, live, xl, extras, spec["grad"])
        (y ** 2).sum().backward()
        out["grads"] = {"w": live["w"].grad.numpy(),
                        "b": live["b"].grad.numpy(), "x": xl.grad.numpy()}
    return out


def _train_cfg(name: str):
    import dataclasses

    from karanta_tpu_torch.inference.tokenizer import ByteTokenizer
    from karanta_tpu_torch.models.qwen25_vl.config import tiny_config

    cfg = tiny_config(vocab_size=ByteTokenizer().vocab_size)
    if name == "tiny4":
        cfg = dataclasses.replace(cfg, text=dataclasses.replace(
            cfg.text, num_layers=4))
    elif name == "wide":
        cfg = wide_config(cfg)
    return cfg


def wide_config(cfg):
    """The tiny config widened so that no NF4 target's slice at fsdp = 2 or
    model = 2 cuts a 64-row block: hidden 128, 8 heads, MLP 256 (the
    JAX and the port's configs alike)."""
    import dataclasses

    vision = dataclasses.replace(cfg.vision, out_hidden_size=128)
    text = dataclasses.replace(cfg.text, hidden_size=128, num_heads=8,
                               intermediate_size=256)
    return dataclasses.replace(cfg, vision=vision, text=text)


def _float_tree(tree):
    if isinstance(tree, dict):
        return {k: _float_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def decoder_pipeline_job(mesh, spec: dict) -> dict:
    """The port's pipeline_prefill_forward on the 4-layer tiny decoder
    (float32, JAX-initialised weights) over this rank's rows: the hidden
    states, and the whole gradients of mean(out ** 2) (over all rows) with
    respect to the decoder's parameters."""
    from karanta_tpu_torch.models.qwen25_vl import decoder as dec
    from karanta_tpu_torch.parallel.sharding import all_reduce_sum
    from karanta_tpu_torch.utils.tree import flatten_tree, unflatten_tree

    cfg = _train_cfg("tiny4")
    params = _float_tree(spec["params"])
    t = _tensors(spec["inputs"])
    rows = _data_rows(mesh, t["embeds"].shape[0])
    embeds, positions = t["embeds"][rows], t["positions"][:, rows]
    out = dec.pipeline_prefill_forward(params, cfg.text, embeds, positions,
                                       mesh, n_micro=2)
    live = {k: v.clone().requires_grad_(True)
            for k, v in flatten_tree(params).items()}
    y = dec.pipeline_prefill_forward(unflatten_tree(live), cfg.text, embeds,
                                     positions, mesh, n_micro=2)
    ((y ** 2).sum() / t["embeds"].numel()).backward()
    grads = {}
    for k, v in live.items():
        g = torch.zeros_like(v) if v.grad is None else v.grad  # the embed
        grads[k] = all_reduce_sum(g, mesh.group("data")).numpy()
    return {"rows": rows, "out": out.detach().numpy(), "grads": grads}


def train_job(mesh, spec: dict) -> dict:
    """One training step of the tiny model on this rank's share of the
    global batch, for each case of spec["cases"]. A case: optimizer
    ("adamw" | "muon"), grad_accum, lr, sp (context parallel), pp_micro
    (pipeline parallel; 0 = off), lora (rank; 0 = full training), qlora
    (an NF4 base under the factors), merge (also the merged targets after
    the step, whole), grads (also differentiate the first microbatch). spec["factors"], when given, are the LoRA factors (numpy,
    the trainable tree's layout). Returns per case the loss,
    tokens and grad norm of the step, the trained leaves after the step
    (whole) and, with grads, the loss and the gradients of the first
    microbatch (whole, summed over the ranks)."""
    from karanta_tpu_torch.models.qwen25_vl.convert import from_jax_params
    from karanta_tpu_torch.parallel.sharding import Placement
    from karanta_tpu_torch.training import lora as tl
    from karanta_tpu_torch.training.optimizer import make_optimizer
    from karanta_tpu_torch.training.train_step import (create_train_state,
                                                       make_train_step,
                                                       train_param_axes,
                                                       value_and_grad)
    from karanta_tpu_torch.utils.tree import flatten_tree

    dev = mesh.device
    cfg = _train_cfg(spec["cfg"])
    batch = _tensors(spec["batch"])
    results = []
    for case in spec["cases"]:
        params = from_jax_params(spec["params"], cfg, dev, torch.float32)
        optimizer = make_optimizer(case["optimizer"], case["lr"])
        pp = case.get("pp_micro", 0)
        accum = case["grad_accum"]
        meshes = dict(sp_mesh=mesh if case.get("sp") else None,
                      pp_mesh=mesh if pp else None, pp_micro=max(pp, 1),
                      mesh=mesh)
        first = {k: (v[:, :v.shape[1] // accum] if k == "positions"
                     else v[:v.shape[0] // accum]) for k, v in batch.items()}
        if case.get("lora"):
            template = tl.init_lora_params(
                params, case["lora"],
                torch.Generator(device=dev).manual_seed(5), alpha=16.0)
            for group in ("attn", "mlp"):
                for name, f in template[group].items():
                    if "factors" in spec:  # given (the JAX test's)
                        for k in ("a", "b"):
                            f[k] = torch.from_numpy(np.array(
                                spec["factors"][group][name][k])).to(dev)
                    else:  # non-zero b, so that every factor has a gradient
                        f["b"] += 0.01
            trainable = tl.trainable_lora(template)
            qlora = bool(case.get("qlora"))
            base = tl.quantize_base_nf4(params) if qlora else params
            base = tl.lora_base_placement(cfg, mesh, qlora).shard(base)
            step = tl.make_lora_train_step(
                cfg, optimizer, grad_accum=accum, sp_mesh=meshes["sp_mesh"],
                mesh=mesh, remat=case.get("remat", False))
            loss0, grads = None, {}
            if case.get("grads"):
                loss0, _, grads = step.grad_once(trainable, base, template,
                                                 first)
                step.reduce(grads)
            state = create_train_state(trainable, optimizer)
            state, metrics = step(state, base, template, batch)
            whole = None
            if case.get("merge"):
                # the merged targets as eval_params builds them (this
                # rank's slices of train_param_axes), gathered whole
                logical = Placement(train_param_axes(cfg), mesh)
                merged = flatten_tree(tl.merge_lora(
                    base, tl.with_factors(template, state.params),
                    logical)["text"]["layers"])
                merged = {f"text/layers/{k}": logical.whole(
                    f"text/layers/{k}", v).float().cpu().numpy()
                    for k, v in merged.items()
                    if k.split("/")[-1] in tl.ATTN_TARGETS + tl.MLP_TARGETS}
        else:
            step = make_train_step(cfg, optimizer, grad_accum=accum,
                                   remat=case.get("remat", False), **meshes)
            whole = step.plan.placement
            params = whole.shard(params)
            loss0, grads = None, {}
            if case.get("grads"):
                loss0, _, grads = value_and_grad(step.loss_fn, params, first)
                step.plan.reduce_grads(grads)
            state = create_train_state(params, optimizer)
            state, metrics = step(state, batch)

        def full(path, x):
            x = x if whole is None else whole.whole(path, x)
            return x.detach().cpu().numpy()

        results.append({
            "loss": float(metrics["loss"]),
            "tokens": int(metrics["tokens"]),
            "grad_norm": float(metrics["grad_norm"]),
            "loss0": None if loss0 is None else float(loss0),
            "grads": {k: full(k, g) for k, g in grads.items()},
            "params": {k: full(k, v)
                       for k, v in flatten_tree(state.params).items()},
            **({"merged": merged} if case.get("merge") else {}),
        })
    return {"coords": mesh.coords, "cases": results}
