"""Minimal asyncio HTTP client: one socket per request, no pools.

The reference hand-rolls its POST for a reason we preserve: connection-pool
locks in httpx/aiohttp deadlock at the 100M-request scale this pipeline runs
at (karanta/pipeline.py:174-272 and its comment). A fresh connection per
request has no shared state to contend on; the OS handles TIME_WAIT fine.
"""

from __future__ import annotations

import asyncio
import json
from typing import Optional
from urllib.parse import urlparse


async def apost(url: str, json_data: dict,
                api_key: Optional[str] = None,
                timeout: float = 300.0,
                extra_headers: Optional[dict] = None) -> tuple[int, bytes]:
    """POST json; returns (status_code, body_bytes). Raises ConnectionError
    on transport failures (the retry ladder treats those as backoff-able).
    `extra_headers` lets provider clients send non-Bearer auth schemes
    (Azure `api-key:`, Anthropic `x-api-key:` + `anthropic-version:`)."""
    parsed = urlparse(url)
    host = parsed.hostname or "localhost"
    port = parsed.port or (443 if parsed.scheme == "https" else 80)
    path = parsed.path or "/"
    if parsed.query:
        path += "?" + parsed.query

    # bytes pass through untouched: callers on hot paths (benches, the
    # pipeline's per-page POST) pre-serialize once instead of re-encoding a
    # multi-hundred-KB body dict per attempt
    payload = (json_data if isinstance(json_data, (bytes, bytearray))
               else json.dumps(json_data).encode("utf-8"))
    headers = [
        f"POST {path} HTTP/1.1",
        f"Host: {host}",
        "Content-Type: application/json",
        f"Content-Length: {len(payload)}",
        "Connection: close",
    ]
    if api_key:
        headers.append(f"Authorization: Bearer {api_key}")
    for name, value in (extra_headers or {}).items():
        headers.append(f"{name}: {value}")
    request = ("\r\n".join(headers) + "\r\n\r\n").encode("ascii") + payload

    writer = None
    try:
        if parsed.scheme == "https":
            import ssl

            ctx = ssl.create_default_context()
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(host, port, ssl=ctx), timeout=30)
        else:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(host, port), timeout=30)
        writer.write(request)
        await writer.drain()

        status_line = await asyncio.wait_for(reader.readline(), timeout=timeout)
        if not status_line:
            raise ConnectionError("empty response")
        parts = status_line.decode("ascii", "replace").split(" ", 2)
        status = int(parts[1])

        content_length = None
        chunked = False
        while True:
            line = await asyncio.wait_for(reader.readline(), timeout=timeout)
            if line in (b"\r\n", b"\n", b""):
                break
            name, _, value = line.decode("ascii", "replace").partition(":")
            lname = name.strip().lower()
            if lname == "content-length":
                content_length = int(value.strip())
            elif lname == "transfer-encoding" and "chunked" in value.lower():
                chunked = True

        if chunked:
            body = bytearray()
            while True:
                size_line = await asyncio.wait_for(reader.readline(),
                                                   timeout=timeout)
                size = int(size_line.strip() or b"0", 16)
                if size == 0:
                    await reader.readline()
                    break
                body += await asyncio.wait_for(reader.readexactly(size),
                                               timeout=timeout)
                await reader.readline()
            return status, bytes(body)
        if content_length is not None:
            body = await asyncio.wait_for(reader.readexactly(content_length),
                                          timeout=timeout)
            return status, body
        body = await asyncio.wait_for(reader.read(), timeout=timeout)
        return status, body
    except (OSError, asyncio.IncompleteReadError, ValueError,
            asyncio.TimeoutError) as exc:
        raise ConnectionError(f"apost to {url} failed: {exc}") from exc
    finally:
        if writer is not None:
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:
                pass


async def aget(url: str, timeout: float = 30.0) -> tuple[int, bytes]:
    """GET helper for health/readiness polling."""
    parsed = urlparse(url)
    host = parsed.hostname or "localhost"
    port = parsed.port or (443 if parsed.scheme == "https" else 80)
    path = parsed.path or "/"
    request = (f"GET {path} HTTP/1.1\r\nHost: {host}\r\n"
               "Connection: close\r\n\r\n").encode("ascii")
    writer = None
    try:
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, port), timeout=timeout)
        writer.write(request)
        await writer.drain()
        data = await asyncio.wait_for(reader.read(), timeout=timeout)
        status_line, _, rest = data.partition(b"\r\n")
        status = int(status_line.split(b" ")[1])
        _, _, body = rest.partition(b"\r\n\r\n")
        return status, body
    except (OSError, ValueError, asyncio.TimeoutError, IndexError) as exc:
        raise ConnectionError(f"aget {url} failed: {exc}") from exc
    finally:
        if writer is not None:
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:
                pass
