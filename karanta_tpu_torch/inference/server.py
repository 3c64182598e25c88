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
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import json
import logging
import os
import time
import uuid
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Optional

import torch

from karanta_tpu_torch.device import resolve_device
from karanta_tpu_torch.inference.chat import RAW_IMAGE_SENTINEL
from karanta_tpu_torch.inference.engine import (ContextLengthError, Engine,
                                                EngineConfig, GenRequest)

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
        # take up to one staged request per free slot
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
            except Exception as exc:
                logger.exception("failed to admit request")
                if not future.done():
                    future.set_exception(exc)

        admitted = False
        for slot, prepared, future, stream_q, first in wave:
            state = _Active(prepared=prepared, future=future, stream=stream_q)
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
        for slot in list(self.active):
            state = self.active[slot]
            reason = None
            for token in emitted[slot]:
                state.collected.append(token)
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
        state.future.set_result({
            "text": text,
            "finish_reason": reason,
            "prompt_tokens": int(len(state.prepared.ids)),
            "completion_tokens": len(state.collected),
        })

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
    """The engine the CLI serves: random weights by preset (tiny and small
    with the byte tokenizer, full presets through ``model.init_params``),
    bf16 on the card and float32 on the CPU."""
    from karanta_tpu_torch.inference.tokenizer import ByteTokenizer
    from karanta_tpu_torch.models.qwen25_vl.config import (get_config,
                                                           small_config,
                                                           tiny_config)
    from karanta_tpu_torch.models.qwen25_vl.model import init_params

    if args.model_path or args.native_checkpoint:
        raise NotImplementedError(
            "--model-path and --native-checkpoint are not ported yet "
            "(ROADMAP.md, modules: weight loading)")
    if args.tensor_parallel_size > 1 or args.data_parallel_size > 1:
        raise NotImplementedError(
            "tensor and data parallel serving are not ported yet "
            "(ROADMAP.md, modules: multi-card serving)")
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    ecfg = EngineConfig(
        max_batch_size=args.max_batch_size,
        max_seq_len=args.max_model_len,
        decode_chunk=args.decode_chunk,
        dtype=dtype,
        quantize=args.quantize,
        kv_quantize=args.kv_quantize,
        act_quant=args.act_quant,
        vision_quant=args.vision_quant,
        # product defaults (matching the server CLI): prefix caching and the
        # n-gram drafter ship on
        prefix_cache=args.prefix_cache,
        prefix_min_tokens=args.prefix_min_tokens,
        speculative_ngram=args.speculative_ngram,
        teacher_force=args.teacher_force,
    )
    tok = ByteTokenizer()
    preset = args.preset or "tiny"
    if preset in ("tiny", "small"):
        factory = tiny_config if preset == "tiny" else small_config
        cfg = factory(vocab_size=tok.vocab_size)
    else:
        cfg = get_config(preset)
    params = init_params(cfg, 0, dtype, device=device)
    name = f"random-{cfg.name}"
    logger.warning("serving RANDOM weights (%s): test mode only", name)
    return Engine(params, cfg, tok, ecfg, device=device), name


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
                        help="local HF checkpoint dir (not ported yet)")
    parser.add_argument("--native-checkpoint", dest="native_checkpoint",
                        default=None,
                        help="native-trainer checkpoint (not ported yet)")
    parser.add_argument("--tokenizer-path", dest="tokenizer_path",
                        default=None,
                        help="HF tokenizer dir for --native-checkpoint runs "
                             "(not ported yet)")
    parser.add_argument("--preset", default=None,
                        help="architecture preset (qwen2.5-vl-3b/7b/tiny)")
    parser.add_argument("--max-batch-size", type=int, default=32)
    parser.add_argument("--max-model-len", type=int, default=4096)
    parser.add_argument("--decode-chunk", type=int, default=64)
    parser.add_argument("--tensor-parallel-size", type=int, default=1)
    parser.add_argument("--data-parallel-size", type=int, default=1)
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
                        help="W8A8 vision tower (not ported yet)")
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
                        help="bench-only forced-output hook (not ported yet; "
                             "requires KARANTA_BENCH=1)")
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

    asyncio.run(run())


if __name__ == "__main__":
    main()
