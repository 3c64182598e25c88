"""OpenAI-compatible inference server with continuous batching (port of
``karanta_tpu/inference/server.py``).

The HTTP surface the pipeline and bulk layers poll:
  GET  /health                     -> 200
  GET  /v1/models                  -> model list
  POST /v1/chat/completions        -> chat completion, or SSE with "stream"
  GET  /metrics                    -> queue depths, slot count, speculation
                                      counters and per-op host times ("prof")

One background engine task owns the card. New requests are admitted into
free decode slots between decode chunks (continuous batching); prefills
interleave with decode at chunk boundaries. Every engine call runs in a
worker thread, one at a time, awaited by the engine loop, so all work on the
engine's state is serialized; only request preparation (image decode and
staging) runs beside it in threads. All of it uses the card's default
stream. HTTP handling stays async.

    python -m karanta_tpu_torch.inference.server --preset qwen2.5-vl-7b
    python -m karanta_tpu_torch.inference.server --preset tiny --device cpu

Multi-rank serving (``--tensor-parallel-size``/``--data-parallel-size``):
the serving process is rank 0 of a (data, model) mesh and spawns the other
ranks, each a process that builds its shard of the weights and replays rank
0's engine calls (``worker_loop``). Rank 0 runs HTTP and the engine loop;
before each engine call that reaches the card it broadcasts the call over a
gloo group (``_Leader``), so every rank runs the engine in lockstep.
Ranks use ``cuda:(rank % cards)``; on one card they share it and talk over
gloo, with a card per rank over NCCL (``parallel/mesh.py``).
"""

from __future__ import annotations

import argparse
import asyncio
import atexit
import base64
import dataclasses
import json
import logging
import os
import threading
import time
import uuid
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Optional

import torch

from karanta_tpu_torch.device import resolve_device
from karanta_tpu_torch.inference.chat import RAW_IMAGE_SENTINEL
from karanta_tpu_torch.inference.engine import (ContextLengthError, Engine,
                                                EngineConfig, GenRequest,
                                                GuidedRegexBusy,
                                                chunk_logprob)

logger = logging.getLogger("karanta_tpu_torch.server")


def extract_data_images(body: bytes) -> tuple[bytes, list[bytes]]:
    """Pull base64 data-URL payloads out of a raw request body before JSON
    parsing, replacing each with a short sentinel reference.

    A 1288 px page is a ~1.7 MB base64 string that json.loads would scan and
    copy and the chat layer would decode again. The base64 alphabet holds no
    JSON escapes, so the payload is sliced off the wire bytes and decoded
    once; anything surprising (an escape inside the payload, malformed
    base64) is left in place for the slow path."""
    images: list[bytes] = []
    out = bytearray()
    view = memoryview(body)
    copied = 0   # bytes [0, copied) already appended to `out`
    search = 0   # where to look for the next data URL
    while True:
        i = body.find(b"data:image/", search)
        if i < 0:
            break
        j = body.find(b";base64,", i, i + 40)
        if j < 0:
            search = i + 11
            continue
        start = j + 8
        k = body.find(b'"', start)
        if k < 0:
            break
        search = k
        payload = view[start:k]
        if b"\\" in payload:  # escaped char inside: not plain base64
            continue
        try:
            raw = base64.b64decode(payload)
        except Exception:
            continue
        out += view[copied:start]
        out += f"{RAW_IMAGE_SENTINEL}{len(images)}".encode()
        images.append(raw)
        copied = k
    if not images:
        return body, images
    out += view[copied:]
    return bytes(out), images


@dataclass
class _Active:
    prepared: object
    future: asyncio.Future
    collected: list[int] = field(default_factory=list)
    start: float = field(default_factory=time.time)
    stream: Optional[asyncio.Queue] = None   # token-delta queue when streaming
    emitted_text: str = ""
    lp: Optional[list] = None                # per-token logprobs, if asked


class InferenceServer:
    def __init__(self, engine: Engine, model_name: str = "karanta-ocr"):
        self.engine = engine
        self.model_name = model_name
        self.queue: asyncio.Queue = asyncio.Queue()
        self.active: dict[int, _Active] = {}
        # requests pulled off the queue with host prep already running in a
        # thread: (request, future, stream_q, prepare-task). Bounded so the
        # staged page buffers cannot flood device memory.
        self._staged: list[tuple] = []
        b = engine.ecfg.max_batch_size
        self._prep_ahead = max(8, b)
        self._server: Optional[asyncio.AbstractServer] = None
        self._engine_task: Optional[asyncio.Task] = None
        self.port: Optional[int] = None
        self.requests_served = 0
        self.completion_tokens_served = 0
        # per-op host seconds of the serving path, under /metrics "prof"
        self._prof: defaultdict = defaultdict(float)

    # ------------------------------------------------------------------
    # engine loop
    # ------------------------------------------------------------------

    async def _engine_loop(self):
        # `inflight` is the collector of a decode chunk launched before the
        # previous chunk's tokens were read. Admission waits while a chunk
        # is inflight: a prefill insert must not race a chunk still writing
        # the cache.
        inflight = None
        while True:
            admitted = False
            if inflight is None:
                admitted = await self._admit()
            else:
                # keep the next wave's host prep running under the inflight
                # chunk even though slot admission must wait for it
                self._top_up_staging()
            if self.active:
                if self.engine._spec_ok():
                    if inflight is not None:
                        # the slot mix changed under the inflight chunk:
                        # drain it before switching to speculation
                        toks = await asyncio.to_thread(inflight)
                        inflight = None
                        self._distribute_lists({
                            slot: [int(t) for t in toks[:, slot]]
                            for slot in self.active})
                        continue
                    toks, counts = await asyncio.to_thread(
                        self.engine.decode_chunk_spec)
                    self._distribute_lists(self.engine.spec_emissions(
                        toks, counts,
                        {slot: st.prepared.max_tokens - len(st.collected)
                         for slot, st in self.active.items()}))
                else:
                    steps = self.engine.ecfg.decode_chunk
                    collect = (inflight if inflight is not None else
                               await asyncio.to_thread(
                                   self.engine.decode_chunk_async))
                    inflight = None
                    # launch the NEXT chunk before reading this one when no
                    # slot can finish inside it, every slot is occupied
                    # (admission could not insert anyway) and the cache has
                    # headroom: the read-back then hides behind the card
                    min_remaining = min(
                        (st.prepared.max_tokens - len(st.collected)
                         for st in self.active.values()), default=0)
                    if (min_remaining > steps
                            and not any(self.engine.slot_free)
                            and self.engine.decode_headroom(steps)):
                        inflight = await asyncio.to_thread(
                            self.engine.decode_chunk_async)
                    t0 = time.perf_counter()
                    toks = await asyncio.to_thread(collect)
                    t1 = time.perf_counter()
                    self._distribute_lists({
                        slot: [int(t) for t in toks[:, slot]]
                        for slot in self.active})
                    self._prof["decode_collect_s"] += t1 - t0
                    self._prof["distribute_s"] += time.perf_counter() - t1
            else:
                if inflight is not None:
                    # every slot finished under the inflight chunk: drain and
                    # discard before admitting again
                    await asyncio.to_thread(inflight)
                    inflight = None
                elif not admitted:
                    await asyncio.sleep(0.002)

    def _top_up_staging(self):
        """Pull queued requests into the staging window and start their host
        prep (image decode, layout planning, device staging) in threads now,
        so the next wave's prep overlaps the current wave's decode."""
        while len(self._staged) < self._prep_ahead and not self.queue.empty():
            # staged pages already on the card show in its free memory;
            # count only the preps still running on top
            pending = sum(1 for *_r, p in self._staged if not p.done())
            if not self.engine.staging_headroom(pending):
                break
            request, future, stream_q = self.queue.get_nowait()
            if future.cancelled():
                continue
            prep = asyncio.ensure_future(
                asyncio.to_thread(self.engine.prepare, request))
            self._staged.append((request, future, stream_q, prep))

    async def _admit(self) -> bool:
        self._top_up_staging()
        # take up to one staged request per free slot, holding back guided
        # requests whose regex does not fit the arena beside the live ones
        # (they stay staged until those drain; the constraint is never
        # dropped)
        batch: list[tuple] = []
        held: list[tuple] = []
        free = sum(self.engine.slot_free)
        for item in self._staged:
            request = item[0]
            if (len(batch) < free
                    and not (request.guided_regex
                             and not self.engine.guided_available(
                                 request.guided_regex))):
                batch.append(item)
            else:
                held.append(item)
        self._staged = held
        if not batch:
            return False

        prepared_list = await asyncio.gather(
            *[prep for _, _, _, prep in batch], return_exceptions=True)

        # launch every page's prefill + insert without syncing between
        # pages, then read the first tokens back in one wave
        wave: list[tuple] = []
        for (request, future, stream_q, prep), prepared in zip(batch,
                                                               prepared_list):
            if isinstance(prepared, BaseException):
                logger.error("failed to prepare request: %r", prepared)
                if not future.done():
                    future.set_exception(prepared)
                continue
            prepared.max_tokens = min(
                prepared.max_tokens,
                max(1, self.engine.ecfg.max_seq_len - len(prepared.ids) - 1))
            try:
                slot = self.engine.slot_free.index(True)
                t0 = time.perf_counter()
                first = await asyncio.to_thread(
                    self.engine.prefill_insert, slot, prepared)
                self._prof["prefill_dispatch_s"] += time.perf_counter() - t0
                wave.append((slot, prepared, future, stream_q, first))
            except GuidedRegexBusy:
                # the arena filled between the availability check and the
                # bind: hold the request (its prep is done) until the
                # conflicting automaton drains
                self._staged.append((request, future, stream_q, prep))
            except Exception as exc:
                logger.exception("failed to admit request")
                if not future.done():
                    future.set_exception(exc)

        admitted = False
        for slot, prepared, future, stream_q, first in wave:
            state = _Active(prepared=prepared, future=future, stream=stream_q)
            if prepared.logprobs:
                state.lp = [self.engine._first_logprob.pop(
                    prepared.request_id, None)]
            first_host = int(first)  # one wave of syncs, not one per page
            state.collected.append(first_host)
            if (first_host == self.engine.tok.eos_token_id
                    or prepared.max_tokens <= 1):
                reason = ("stop" if first_host == self.engine.tok.eos_token_id
                          else "length")
                self._finish(slot, state, reason)
            else:
                self.active[slot] = state
            admitted = True
        return admitted

    def _distribute_lists(self, emitted: dict):
        lp_data = self.engine._last_logprobs
        for slot in list(self.active):
            state = self.active[slot]
            reason = None
            for j, token in enumerate(emitted[slot]):
                state.collected.append(token)
                if state.lp is not None and lp_data is not None:
                    state.lp.append(chunk_logprob(
                        lp_data, j, slot, state.prepared.top_logprobs))
                if token == self.engine.tok.eos_token_id:
                    reason = "stop"
                    break
                if len(state.collected) >= state.prepared.max_tokens:
                    reason = "length"
                    break
            if state.stream is not None:
                self._emit_delta(state)
            if reason:
                self._finish(slot, state, reason)
                del self.active[slot]

    def _emit_delta(self, state: _Active):
        out_ids = [t for t in state.collected
                   if t != self.engine.tok.eos_token_id]
        text = self.engine.tok.decode(out_ids)
        delta = text[len(state.emitted_text):]
        if delta:
            state.emitted_text = text
            state.stream.put_nowait(delta)

    def _finish(self, slot: int, state: _Active, reason: str):
        self.engine.free_slot(slot)
        self.requests_served += 1
        self.completion_tokens_served += len(state.collected)
        if state.stream is not None:
            self._emit_delta(state)
            state.stream.put_nowait({"finish_reason": reason})
        if state.future.done():
            return
        out_ids = [t for t in state.collected
                   if t != self.engine.tok.eos_token_id]
        t0 = time.perf_counter()
        text = self.engine.tok.decode(out_ids)
        self._prof["detokenize_s"] += time.perf_counter() - t0
        result = {
            "text": text,
            "finish_reason": reason,
            "prompt_tokens": int(len(state.prepared.ids)),
            "completion_tokens": len(state.collected),
        }
        if state.lp is not None:
            lps = [x for t, x in zip(state.collected, state.lp)
                   if t != self.engine.tok.eos_token_id][: len(out_ids)]
            result["logprobs"] = self._format_logprobs(out_ids, lps)
        state.future.set_result(result)

    def _format_logprobs(self, token_ids, lps) -> dict:
        """The OpenAI chat logprobs block: one entry per completion token."""
        content = []
        for tid, entry in zip(token_ids, lps):
            tok_str = self.engine.tok.decode([tid])
            if entry is None:
                content.append({"token": tok_str, "logprob": None,
                                "top_logprobs": []})
                continue
            chosen, top = entry
            content.append({
                "token": tok_str,
                "logprob": chosen,
                "top_logprobs": [
                    {"token": self.engine.tok.decode([int(i)]),
                     "logprob": float(v)} for i, v in top],
            })
        return {"content": content}

    # ------------------------------------------------------------------
    # HTTP
    # ------------------------------------------------------------------

    async def start(self, host: str = "0.0.0.0", port: int = 30024) -> int:
        self._engine_task = asyncio.create_task(self._engine_loop())
        self._server = await asyncio.start_server(self._handle, host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("karanta-tpu-torch inference server on :%d (model=%s)",
                    self.port, self.model_name)
        return self.port

    async def stop(self):
        if self._engine_task:
            self._engine_task.cancel()
            try:
                await self._engine_task
            except (asyncio.CancelledError, Exception):
                pass
        if self._server:
            self._server.close()
            await self._server.wait_closed()
        if isinstance(self.engine, _Leader):
            await asyncio.to_thread(self.engine.shutdown)

    async def serve_forever(self):
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter):
        try:
            request_line = await reader.readline()
            if not request_line:
                return
            try:
                method, path, _ = request_line.decode().split(" ", 2)
            except ValueError:
                await self._respond(writer, 400, {"error": "bad request line"})
                return
            content_length = 0
            t0 = time.perf_counter()
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                name, _, value = line.decode("latin-1").partition(":")
                if name.strip().lower() == "content-length":
                    content_length = int(value.strip())
            t1 = time.perf_counter()
            body = (await reader.readexactly(content_length)
                    if content_length else b"")
            self._prof["header_read_s"] += t1 - t0
            self._prof["body_read_s"] += time.perf_counter() - t1

            if method == "GET" and path in ("/health", "/health/"):
                await self._respond(writer, 200, {"status": "ok"})
            elif method == "GET" and path.rstrip("/").endswith("/models"):
                await self._respond(writer, 200, {
                    "object": "list",
                    "data": [{"id": self.model_name, "object": "model",
                              "owned_by": "karanta-tpu"}],
                })
            elif method == "GET" and path == "/metrics":
                payload = {
                    "running": len(self.active),
                    "waiting": self.queue.qsize() + len(self._staged),
                    "slots": self.engine.ecfg.max_batch_size,
                    "requests_served": self.requests_served,
                }
                if getattr(self.engine, "spec_passes", 0):
                    # speculative acceptance: tokens emitted per verify pass
                    payload["spec_passes"] = self.engine.spec_passes
                    payload["spec_tokens"] = self.engine.spec_tokens
                    payload["spec_tokens_per_pass"] = round(
                        self.engine.spec_tokens
                        / max(1, self.engine.spec_passes), 3)
                if self._prof:
                    payload["prof"] = {k: round(v, 4)
                                       for k, v in self._prof.items()}
                await self._respond(writer, 200, payload)
            elif (method == "POST"
                  and path.rstrip("/").endswith("/chat/completions")):
                await self._chat_completions(writer, body)
            else:
                await self._respond(writer, 404, {"error": f"no route {path}"})
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        except Exception:
            logger.exception("request handling failed")
            try:
                await self._respond(writer, 500, {"error": "internal error"})
            except Exception:
                pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:
                pass

    async def _chat_completions(self, writer, body: bytes):
        try:
            t0 = time.perf_counter()
            body, raw_images = extract_data_images(body)
            t1 = time.perf_counter()
            payload = json.loads(body)
            messages = payload["messages"]
            self._prof["extract_images_s"] += t1 - t0
            self._prof["json_parse_s"] += time.perf_counter() - t1
            self._prof["requests"] += 1
        except (json.JSONDecodeError, KeyError) as exc:
            await self._respond(writer, 400, {"error": f"bad request: {exc}"})
            return

        request = GenRequest(
            raw_images=raw_images or None,
            messages=messages,
            max_tokens=int(payload.get("max_tokens", 4000)),
            temperature=float(payload.get("temperature", 0.0)),
            top_p=float(payload.get("top_p", 1.0)),
            request_id=f"chatcmpl-{uuid.uuid4().hex[:16]}",
            guided_regex=payload.get("guided_regex"),
            logprobs=bool(payload.get("logprobs", False)),
            top_logprobs=int(payload.get("top_logprobs", 0) or 0),
            speculative=(None if payload.get("speculative") is None
                         else bool(payload["speculative"])),
            forced_output=(payload.get("forced_output")
                           if self.engine.ecfg.teacher_force else None),
        )
        future: asyncio.Future = asyncio.get_running_loop().create_future()

        if payload.get("stream"):
            stream_q: asyncio.Queue = asyncio.Queue()
            await self.queue.put((request, future, stream_q))
            await self._stream_response(writer, request, payload, stream_q,
                                        future)
            return

        await self.queue.put((request, future, None))
        try:
            result = await future
        except Exception as exc:
            status = 400 if isinstance(exc, ContextLengthError) else 500
            await self._respond(writer, status, {"error": str(exc)})
            return

        await self._respond(writer, 200, {
            "id": request.request_id,
            "object": "chat.completion",
            "created": int(time.time()),
            "model": payload.get("model", self.model_name),
            "choices": [{
                "index": 0,
                "message": {"role": "assistant", "content": result["text"]},
                "finish_reason": result["finish_reason"],
                **({"logprobs": result["logprobs"]}
                   if "logprobs" in result else {}),
            }],
            "usage": {
                "prompt_tokens": result["prompt_tokens"],
                "completion_tokens": result["completion_tokens"],
                "total_tokens": result["prompt_tokens"]
                + result["completion_tokens"],
            },
        })

    async def _stream_response(self, writer, request, payload,
                               stream_q: asyncio.Queue,
                               future: asyncio.Future):
        """OpenAI-style SSE: chat.completion.chunk deltas then [DONE]."""
        writer.write(
            b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n"
            b"Cache-Control: no-cache\r\nConnection: close\r\n"
            b"Transfer-Encoding: chunked\r\n\r\n")
        await writer.drain()

        def chunk_payload(delta: dict, finish: Optional[str]) -> bytes:
            body = json.dumps({
                "id": request.request_id,
                "object": "chat.completion.chunk",
                "created": int(time.time()),
                "model": payload.get("model", self.model_name),
                "choices": [{"index": 0, "delta": delta,
                             "finish_reason": finish}],
            }).encode()
            event = b"data: " + body + b"\n\n"
            return f"{len(event):x}\r\n".encode() + event + b"\r\n"

        def done_chunks() -> bytes:
            done = b"data: [DONE]\n\n"
            return (f"{len(done):x}\r\n".encode() + done + b"\r\n"
                    + b"0\r\n\r\n")

        writer.write(chunk_payload({"role": "assistant"}, None))
        await writer.drain()
        while True:
            getter = asyncio.ensure_future(stream_q.get())
            await asyncio.wait({getter, future},
                               return_when=asyncio.FIRST_COMPLETED)
            if not getter.done():
                # the request failed before it streamed a token (prepare or
                # admission raised): end the stream with an error event
                getter.cancel()
                event = json.dumps({"error": str(future.exception())})
                body = b"data: " + event.encode() + b"\n\n"
                writer.write(f"{len(body):x}\r\n".encode() + body + b"\r\n"
                             + done_chunks())
                await writer.drain()
                return
            item = getter.result()
            if isinstance(item, dict):  # finish marker
                writer.write(chunk_payload({}, item["finish_reason"])
                             + done_chunks())
                await writer.drain()
                return
            writer.write(chunk_payload({"content": item}, None))
            await writer.drain()

    @staticmethod
    async def _respond(writer, status: int, payload: dict):
        body = json.dumps(payload).encode()
        writer.write(
            f"HTTP/1.1 {status} {'OK' if status == 200 else 'ERR'}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n"
            .encode() + body)
        await writer.drain()


# ----------------------------------------------------------------------
# CLI
# ----------------------------------------------------------------------


def build_engine_from_args(args) -> tuple[Engine, str]:
    """The engine the CLI serves, bf16 on the card and float32 on the CPU:
    an HF checkpoint (``--model-path``: its safetensors and its tokenizer,
    the architecture from ``--preset`` or the path's name), or random
    weights by preset (tiny and small with the byte tokenizer, full presets
    through ``model.init_params``). Every optional flag is read with the JAX
    server's default, so a caller's narrower namespace (``single_page``,
    the bench runner) builds the same engine; a missing ``device`` means
    the card."""
    tp = getattr(args, "tensor_parallel_size", 1) or 1
    dp = getattr(args, "data_parallel_size", 1) or 1
    if tp * dp > 1:
        return _sharded_engine(args, tp, dp)
    return _rank_engine(args)


def _engine_config(args, dtype) -> EngineConfig:
    return EngineConfig(
        max_batch_size=args.max_batch_size,
        max_seq_len=args.max_model_len,
        decode_chunk=args.decode_chunk,
        dtype=dtype,
        quantize=getattr(args, "quantize", None),
        kv_quantize=getattr(args, "kv_quantize", None),
        act_quant=getattr(args, "act_quant", None),
        vision_quant=getattr(args, "vision_quant", None),
        # product defaults (matching the server CLI): prefix caching and the
        # n-gram drafter ship on
        prefix_cache=getattr(args, "prefix_cache", True),
        prefix_min_tokens=getattr(args, "prefix_min_tokens", 256),
        speculative_ngram=getattr(args, "speculative_ngram", 3),
        teacher_force=getattr(args, "teacher_force", False),
    )


def _rank_engine(args, mesh=None) -> tuple[Engine, str]:
    """One rank's engine: the whole model on one card (`mesh` None), or this
    rank's shard of it, built leaf by leaf (``model.serving_leaf_fn``: each
    leaf read or drawn, quantized whole, sliced, the whole dropped)."""
    from karanta_tpu_torch.inference.tokenizer import ByteTokenizer
    from karanta_tpu_torch.models.qwen25_vl.config import (get_config,
                                                           small_config,
                                                           tiny_config)
    from karanta_tpu_torch.models.qwen25_vl.model import (add_tied_logits_head,
                                                          init_params,
                                                          init_params_sharded,
                                                          serving_leaf_fn)

    device = (mesh.device if mesh is not None
              else resolve_device(getattr(args, "device", None)))
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    ecfg = _engine_config(args, dtype)
    # a mesh's leaves are quantized as they are sliced: the engine then
    # takes them as they are
    sharded_ecfg = dataclasses.replace(ecfg, quantize=None, vision_quant=None)
    if getattr(args, "native_checkpoint", None):
        return _native_checkpoint_engine(args, ecfg, dtype, device, mesh)
    if getattr(args, "model_path", None):
        from karanta_tpu_torch.inference.tokenizer import HFTokenizer
        from karanta_tpu_torch.models.qwen25_vl.loading import \
            load_hf_checkpoint

        cfg = get_config(getattr(args, "preset", None) or args.model_path)
        name = args.model_path
        if mesh is not None:
            params = load_hf_checkpoint(
                args.model_path, cfg, dtype, device=device,
                leaf_fn=serving_leaf_fn(cfg, mesh, dtype, ecfg.quantize,
                                        ecfg.vision_quant))
            add_tied_logits_head(params, cfg, mesh, ecfg.quantize)
            return Engine(params, cfg, HFTokenizer(args.model_path),
                          sharded_ecfg, mesh=mesh), name
        # quantize on transfer, matrix by matrix: the card never holds the
        # whole bf16 decoder beside its int8 copy
        params = load_hf_checkpoint(args.model_path, cfg, dtype,
                                    quantize=ecfg.quantize, device=device)
        if ecfg.quantize:
            ecfg = dataclasses.replace(ecfg, quantize=None)
        tok = HFTokenizer(args.model_path)
        return Engine(params, cfg, tok, ecfg, device=device), name
    tok = ByteTokenizer()
    preset = getattr(args, "preset", None) or "tiny"
    if preset in ("tiny", "small"):
        factory = tiny_config if preset == "tiny" else small_config
        cfg = factory(vocab_size=tok.vocab_size)
    else:
        cfg = get_config(preset)
    name = f"random-{cfg.name}"
    logger.warning("serving RANDOM weights (%s): test mode only", name)
    if mesh is not None:
        params = init_params_sharded(cfg, mesh, 0, dtype, ecfg.quantize,
                                     ecfg.vision_quant)
        return Engine(params, cfg, tok, sharded_ecfg, mesh=mesh), name
    params = init_params(cfg, 0, dtype, device=device)
    return Engine(params, cfg, tok, ecfg, device=device), name


def _native_checkpoint_engine(args, ecfg: EngineConfig, dtype, device,
                              mesh=None) -> tuple[Engine, str]:
    """Serve a checkpoint written by the port's trainer (a ``step_N`` dir,
    or a run dir whose newest completed step is taken), as the JAX server
    serves its own: the parameters in the serving dtype, the byte tokenizer
    for the hermetic presets and ``--tokenizer-path`` required otherwise.
    On a mesh each tensor is sharded as it is read."""
    from karanta_tpu_torch.inference.tokenizer import (ByteTokenizer,
                                                       HFTokenizer)
    from karanta_tpu_torch.models.qwen25_vl.config import (get_config,
                                                           small_config,
                                                           tiny_config)
    from karanta_tpu_torch.training.checkpoint import (get_last_checkpoint,
                                                       restore_params)
    from karanta_tpu_torch.utils.tree import tree_map

    preset = getattr(args, "preset", None) or "tiny"
    hermetic = preset in ("tiny", "small")
    tokenizer_path = getattr(args, "tokenizer_path", None)
    if tokenizer_path:
        tok = HFTokenizer(tokenizer_path)
    elif not hermetic:
        # the byte tokenizer's 272-id vocab fits only the hermetic presets
        raise SystemExit(
            f"--native-checkpoint with preset {preset!r} needs "
            "--tokenizer-path (an HF tokenizer dir); the hermetic byte "
            "tokenizer only fits the 'tiny'/'small' presets")
    else:
        tok = ByteTokenizer()
    if hermetic:
        factory = tiny_config if preset == "tiny" else small_config
        cfg = factory(vocab_size=tok.vocab_size)
    else:
        cfg = get_config(preset)
    last = get_last_checkpoint(args.native_checkpoint) or \
        args.native_checkpoint
    name = f"native-{os.path.basename(os.path.normpath(last))}"
    if mesh is not None:
        from karanta_tpu_torch.models.qwen25_vl.model import (
            add_tied_logits_head, serving_leaf_fn)

        params, meta = restore_params(last, device=device, leaf_fn=(
            serving_leaf_fn(cfg, mesh, dtype, ecfg.quantize,
                            ecfg.vision_quant)))
        add_tied_logits_head(params, cfg, mesh, ecfg.quantize)
        logger.info("serving native checkpoint %s (step %s)", last,
                    meta.get("step"))
        return Engine(params, cfg, tok, dataclasses.replace(
            ecfg, quantize=None, vision_quant=None), mesh=mesh), name
    raw, meta = restore_params(last, device=device)
    params = tree_map(lambda a, _: a.to(dtype) if a.is_floating_point()
                      else a, raw)
    logger.info("serving native checkpoint %s (step %s)", last,
                meta.get("step"))
    return Engine(params, cfg, tok, ecfg, device=device), name


# ----------------------------------------------------------------------
# multi-rank serving
# ----------------------------------------------------------------------


def _peak_rss_mb() -> Optional[float]:
    """This process's peak resident memory: VmHWM, which starts anew at
    exec, or None where /proc does not report it (getrusage's maxrss would
    keep the parent's peak across a spawn)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return None


def rank_stats(engine: Engine, reset: bool = False) -> dict:
    """This rank's kernel launches, collective calls and host seconds, peak
    host RSS, card memory (peak since the last reset, and held) and cache
    shape (kv heads, slots); `reset` zeroes the counters and the card's
    peak after reading them."""
    from karanta_tpu_torch import kernels
    from karanta_tpu_torch.parallel import sharding

    dev = engine.device
    cuda = dev.type == "cuda"
    stats = {
        "rank": engine.mesh.rank if engine.mesh is not None else 0,
        "launches": {k: v for k, v in kernels.LAUNCHES.items() if v},
        "collective_calls": sharding.STATS["calls"],
        "collective_s": sharding.STATS["seconds"],
        "peak_rss_mb": _peak_rss_mb(),
        "card_peak_mb": (torch.cuda.max_memory_allocated(dev) / 2 ** 20
                         if cuda else None),
        "card_held_mb": (torch.cuda.memory_allocated(dev) / 2 ** 20
                         if cuda else None),
        "kv_heads": int(engine.cache.k.shape[2]),
        "cache_slots": int(engine.cache.k.shape[1]),
    }
    if reset:
        kernels.reset_launches()
        sharding.reset_stats()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
    return stats


class _Leader:
    """Rank 0's engine on a mesh. Each engine call that reaches the card is
    first broadcast over the world's gloo group, so that the other ranks
    (``worker_loop``) replay it on their engines in the same order; every
    other attribute is the engine's. A lock keeps one call at a time."""

    def __init__(self, engine: Engine, workers: list, timeout_s: float):
        self.engine = engine
        self._workers = workers
        self._timeout_s = timeout_s
        self._lock = threading.Lock()
        self._stopped = False
        atexit.register(self.shutdown)

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def _send(self, *op) -> None:
        from karanta_tpu_torch.parallel.sharding import broadcast_objects

        broadcast_objects([op], 0, self.engine.mesh.cpu_group)

    def prefill_insert(self, slot: int, prepared):
        with self._lock:
            request, prepared.request = prepared.request, None
            self._send("prefill", slot, request, prepared.prefix_len,
                       prepared.max_tokens)
            return self.engine.prefill_insert(slot, prepared)

    def decode_chunk_async(self, steps=None, logits_out=None):
        with self._lock:
            self._send("decode", steps)
            return self.engine.decode_chunk_async(steps, logits_out)

    def decode_chunk_spec(self, steps=None, logits_out=None):
        with self._lock:
            self._send("spec", steps)
            return self.engine.decode_chunk_spec(steps, logits_out)

    def free_slot(self, slot: int) -> None:
        with self._lock:
            self._send("free", slot)
            self.engine.free_slot(slot)

    def generate(self, requests: list):
        with self._lock:
            self._send("generate", requests)
            return self.engine.generate(requests)

    def rank_stats(self, reset: bool = False) -> list:
        """Every rank's ``rank_stats``, in rank order."""
        from karanta_tpu_torch.parallel.sharding import gather_objects

        with self._lock:
            self._send("stats", reset)
            return gather_objects(rank_stats(self.engine, reset), 0,
                                  self.engine.mesh.cpu_group)

    def shutdown(self) -> None:
        """Stop the other ranks and leave the group (idempotent)."""
        import torch.distributed as dist

        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            try:
                if all(p.is_alive() for p in self._workers):
                    self._send("stop")
            finally:
                for p in self._workers:
                    p.join(timeout=min(60.0, self._timeout_s))
                    if p.is_alive():
                        p.kill()
                        p.join(timeout=10)
                if dist.is_initialized():
                    dist.destroy_process_group()


def worker_loop(engine: Engine) -> None:
    """A worker rank: replay rank 0's engine calls (``_Leader``) until it
    stops. A call that rank 0's server refuses alike (a guided regex that
    does not fit the arena) is refused here too and the loop goes on; any
    other fault ends the rank, which fails rank 0's next collective."""
    from karanta_tpu_torch.parallel.sharding import (broadcast_objects,
                                                     gather_objects)

    group = engine.mesh.cpu_group
    while True:
        op, *a = broadcast_objects([None], 0, group)[0]
        if op == "stop":
            return
        if op == "prefill":
            slot, request, prefix_len, max_tokens = a
            prepared = engine.prepare(request)
            prepared.prefix_len = prefix_len
            prepared.max_tokens = max_tokens
            try:
                engine.prefill_insert(slot, prepared)
            except (GuidedRegexBusy, ValueError) as exc:
                logger.info("rank %d: prefill refused as on rank 0: %r",
                            engine.mesh.rank, exc)
        elif op == "decode":
            engine.decode_chunk_async(a[0])()
        elif op == "spec":
            engine.decode_chunk_spec(a[0])
        elif op == "free":
            engine.free_slot(a[0])
        elif op == "generate":
            engine.generate(a[0])
        elif op == "stats":
            gather_objects(rank_stats(engine, a[0]), 0, group)
        else:
            raise RuntimeError(f"unknown engine call {op!r} from rank 0")


def _rank_timeout(args) -> float:
    """Seconds a rank waits for its peers: the namespace's ``rank_timeout``
    where a caller sets one (the tests), else the mesh's default."""
    from karanta_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT_S

    return float(getattr(args, "rank_timeout", None) or DEFAULT_TIMEOUT_S)


def _rank_mesh(args, tp: int, dp: int):
    from karanta_tpu_torch.parallel.mesh import MeshConfig, create_mesh

    device = getattr(args, "device", None)
    return create_mesh(MeshConfig(data=dp, fsdp=1, model=tp),
                       device="cpu" if device == "cpu" else None)


def _exit_with_parent() -> None:
    """End this worker rank when rank 0's process is gone (a rank 0 that was
    killed cannot send its stop): a daemon thread polls the parent pid."""
    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(1)

    threading.Thread(target=watch, daemon=True).start()


def _worker_main(rank: int, world: int, init_url: str, args, tp: int,
                 dp: int) -> None:
    from karanta_tpu_torch.parallel.mesh import initialize_distributed

    _exit_with_parent()
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    from karanta_tpu_torch.parallel.launch import in_turns

    device = "cpu" if getattr(args, "device", None) == "cpu" else None
    initialize_distributed(init_url, world, rank, device=device,
                           timeout_s=_rank_timeout(args))
    mesh = _rank_mesh(args, tp, dp)
    engine, _ = in_turns(mesh, lambda: _rank_engine(args, mesh))
    worker_loop(engine)


def _sharded_engine(args, tp: int, dp: int) -> tuple["_Leader", str]:
    """Rank 0 of a (data=dp, model=tp) mesh: spawn ranks 1.. (each builds
    its shard and runs worker_loop), join the group while watching them,
    build this rank's shard. Returns the leader that the server drives."""
    from karanta_tpu_torch.parallel.launch import (free_port, in_turns,
                                                   join_group, spawn_workers)

    world = tp * dp
    device = "cpu" if getattr(args, "device", None) == "cpu" else None
    if device is None:
        resolve_device(None)  # raises without a card
    timeout_s = _rank_timeout(args)
    url = f"tcp://127.0.0.1:{free_port()}"
    workers = spawn_workers(_worker_main, world, url, (args, tp, dp))
    try:
        backend = join_group(url, world, workers, device=device,
                             timeout_s=timeout_s)
        mesh = _rank_mesh(args, tp, dp)
        # one rank at a time on a shared card: each holds one whole leaf
        # while it cuts its shard
        engine, name = in_turns(mesh, lambda: _rank_engine(args, mesh))
    except BaseException:
        for p in workers:
            p.kill()
        raise
    logger.info("serving on %d ranks (data=%d x model=%d) over %s, rank 0 "
                "on %s", world, dp, tp, backend, mesh.device)
    return _Leader(engine, workers, timeout_s), name


def make_arg_parser() -> argparse.ArgumentParser:
    """The server CLI, with the JAX server's flags and product defaults
    (prefix caching and n-gram speculation on), plus --device."""
    parser = argparse.ArgumentParser(
        prog="python -m karanta_tpu_torch.inference.server")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=30024)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) or "
                             "cpu, which runs the kernels' plain versions")
    parser.add_argument("--model-path", default=None,
                        help="local HF checkpoint dir: *.safetensors and "
                             "the tokenizer's files")
    parser.add_argument("--native-checkpoint", dest="native_checkpoint",
                        default=None,
                        help="a checkpoint dir written by the port's trainer "
                             "(training/checkpoint.py): a step_N dir or a run "
                             "dir, whose newest completed step is served")
    parser.add_argument("--tokenizer-path", dest="tokenizer_path",
                        default=None,
                        help="HF tokenizer dir for --native-checkpoint runs")
    parser.add_argument("--preset", default=None,
                        help="architecture preset (qwen2.5-vl-3b/7b/tiny)")
    parser.add_argument("--max-batch-size", type=int, default=32)
    parser.add_argument("--max-model-len", type=int, default=4096)
    parser.add_argument("--decode-chunk", type=int, default=64)
    parser.add_argument("--tensor-parallel-size", type=int, default=1,
                        help="ranks that split each layer (heads, MLP "
                             "columns, vocabulary): Megatron-style tensor "
                             "parallelism, one process a rank")
    parser.add_argument("--data-parallel-size", type=int, default=1,
                        help="groups of ranks that split the decode slots")
    parser.add_argument("--quantize", default=None, choices=["int8"])
    parser.add_argument("--kv-quantize", dest="kv_quantize", default=None,
                        choices=["int8", "int4"],
                        help="quantized KV cache (per-row scales): int8 "
                             "halves decode HBM traffic and doubles slot "
                             "capacity; int4 (nibble-packed) halves it "
                             "again — opt-in capacity mode")
    parser.add_argument("--act-quant", dest="act_quant", default=None,
                        choices=["int8"],
                        help="W8A8 prefill, logits head and verify pass; "
                             "requires --quantize int8")
    parser.add_argument("--vision-quant", dest="vision_quant", default=None,
                        choices=["int8"],
                        help="W8A8 vision tower: int8 per-channel weights, "
                             "dynamic int8 activations")
    parser.add_argument("--speculative-ngram", dest="speculative_ngram",
                        type=int, default=3,
                        help="draft N tokens per verify pass by n-gram "
                             "lookup over each slot's own history; exact for "
                             "greedy requests. Default on; 0 disables")
    parser.add_argument("--prefix-cache", dest="prefix_cache",
                        action=argparse.BooleanOptionalAction, default=True,
                        help="reuse cached KV rows of a shared prompt head "
                             "(default on; --no-prefix-cache disables)")
    parser.add_argument("--prefix-min-tokens", dest="prefix_min_tokens",
                        type=int, default=256,
                        help="LCP gate below which prefix reuse does not "
                             "fire")
    parser.add_argument("--teacher-force", dest="teacher_force",
                        action="store_true",
                        help="bench-only forced-output hook: each request's "
                             "forced_output replaces the tokens it emits "
                             "(requires KARANTA_BENCH=1)")
    return parser


def main(argv: Optional[list[str]] = None):
    parser = make_arg_parser()
    args = parser.parse_args(argv)
    if args.teacher_force and os.environ.get("KARANTA_BENCH") != "1":
        parser.error("--teacher-force is a bench-only hook: set "
                     "KARANTA_BENCH=1 to acknowledge this server must not be "
                     "reachable by untrusted clients")
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    engine, name = build_engine_from_args(args)
    server = InferenceServer(engine, model_name=name)

    async def run():
        await server.start(args.host, args.port)
        await server.serve_forever()

    try:
        asyncio.run(run())
    finally:
        if isinstance(engine, _Leader):
            engine.shutdown()


if __name__ == "__main__":
    main()
