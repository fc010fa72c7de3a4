"""OpenAI-compatible HTTP frontend for the batched engine.

Port of ``nano_tpu/serve/openai_http.py``: the continuous-batching core of
the WebSocket server (``serve/wss.py`` ``WSServer.acquire_stream`` — slot
pool, replicas, bursts, speculative decode) behind the de-facto standard
REST surface:

    python -m nano_tpu_torch.serve.openai_http --model m.bin --port 8000
    curl localhost:8000/v1/chat/completions -d '{
        "model": "m.bin",
        "messages": [{"role": "user", "content": "hi"}]}'

Endpoints: GET /v1/models, POST /v1/completions, POST
/v1/chat/completions (SSE streaming with "stream": true), GET /stats.
Supported request fields: messages/prompt, max_tokens (or
max_completion_tokens), temperature, top_p, stop (string or list),
stream, and the non-standard repetition_penalty.  n != 1 is rejected.

Each endpoint is a method that needs no HTTP library (``models``,
``completions``, ``chat``, ``stats``): it answers a ``Reply`` — a status
and a JSON body, or, for a stream, an async iterator of the SSE payload
dicts.  The ``aiohttp`` handlers (``app``) are thin wrappers over them,
and ``aiohttp`` is imported only there.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import time
import uuid
from dataclasses import dataclass
from typing import Any, AsyncIterator, List, Optional

from nano_tpu_torch.serve.wss import WSServer, warm

logger = logging.getLogger("nano_tpu_torch.openai")


class _StopScanner:
    """Stop-sequence detection across token boundaries for streamed
    text: holds back max(len(stop))-1 chars so a stop string split over
    two tokens is still caught before any of it is emitted."""

    def __init__(self, stops: List[str]):
        self.stops = [s for s in stops if s]
        self.hold = max((len(s) for s in self.stops), default=0) - 1
        self.buf = ""
        self.hit = False

    def feed(self, piece: str) -> str:
        if self.hit:
            return ""
        self.buf += piece
        for s in self.stops:
            i = self.buf.find(s)
            if i >= 0:
                out = self.buf[:i]
                self.buf = ""
                self.hit = True
                return out
        if self.hold <= 0 or len(self.buf) <= self.hold:
            out, self.buf = (self.buf, "") if self.hold <= 0 else ("", self.buf)
            return out
        out = self.buf[:-self.hold]
        self.buf = self.buf[-self.hold:]
        return out

    def flush(self) -> str:
        out, self.buf = self.buf, ""
        return out


def _parse_params(req: dict, sampler) -> dict:
    """Request fields -> engine params; server sampler supplies the
    repetition-penalty default (like the WSS server's CLI defaults)."""
    mt = req.get("max_tokens", req.get("max_completion_tokens", 256))
    stop = req.get("stop") or []
    if isinstance(stop, str):
        stop = [stop]
    return dict(
        max_new_tokens=max(1, int(mt)),
        temperature=float(req.get("temperature", 1.0)),
        top_p=float(req.get("top_p", 1.0)),
        repetition_penalty=float(req.get("repetition_penalty",
                                         sampler.repetition_penalty)),
        stop=[str(s) for s in stop][:8],
    )


@dataclass
class Reply:
    """An endpoint's answer: `status` and a JSON `body`, or (a stream)
    `events`, the SSE payload dicts, after which the transport writes
    ``data: [DONE]``.  Closing `events` early (the client went away)
    releases the stream's slot."""
    status: int = 200
    body: Optional[dict] = None
    events: Optional[AsyncIterator[dict]] = None


def _error(status: int, message: str) -> Reply:
    return Reply(status, {"error": {"message": message,
                                    "type": "invalid_request_error"}})


class OpenAIServer:
    """Thin REST adapter over a WSServer engine pool (composition: only
    acquire_stream/release_stream/ctx/model_name/stats are used)."""

    def __init__(self, pool: WSServer):
        self.pool = pool

    # ---------------- endpoints, transport-free ----------------
    def stats(self) -> Reply:
        return Reply(200, self.pool.stats())

    def models(self) -> Reply:
        names = list(dict.fromkeys(
            getattr(self.pool, "engine_names", None)
            or [self.pool.model_name]))
        return Reply(200, {"object": "list", "data": [
            {"id": n, "object": "model",
             "created": int(time.time()), "owned_by": "nano_tpu"}
            for n in names]})

    async def chat(self, req: Any) -> Reply:
        if not isinstance(req, dict):
            return _error(400, "body must be JSON")
        if int(req.get("n", 1)) != 1:
            return _error(400, "only n=1 is supported")
        messages = req.get("messages")
        if not isinstance(messages, list) or not messages:
            return _error(400, "messages must be a non-empty list")
        loop = asyncio.get_running_loop()
        ids = await loop.run_in_executor(
            None, self.pool.ctx.build_chat_ids, messages)
        return await self._respond(req, ids, chat=True)

    async def completions(self, req: Any) -> Reply:
        if not isinstance(req, dict):
            return _error(400, "body must be JSON")
        if int(req.get("n", 1)) != 1:
            return _error(400, "only n=1 is supported")
        prompt = req.get("prompt", "")
        if isinstance(prompt, list):
            if len(prompt) != 1:
                return _error(400, "only a single prompt is supported")
            prompt = prompt[0]
        if not isinstance(prompt, str):
            return _error(400, "prompt must be a string")
        loop = asyncio.get_running_loop()
        # raw continuation: no instruct/chat template (OpenAI semantics)
        ids = await loop.run_in_executor(
            None, self.pool.ctx.build_prompt_ids, prompt, False)
        return await self._respond(req, ids, chat=False)

    # ---------------- shared generation ----------------
    async def _respond(self, req: dict, ids: List[int], chat: bool
                       ) -> Reply:
        params = _parse_params(req, self.pool.ctx.sampler)
        # route by "model" when it names a served LoRA variant
        # (wss --lora name=path); any other value falls through to the
        # base model — OpenAI clients often send arbitrary model ids
        want = req.get("model")
        params["model"] = want if want in getattr(
            self.pool, "engine_names", []) else None
        rid = ("chatcmpl-" if chat else "cmpl-") + uuid.uuid4().hex[:24]
        meta = {"id": rid, "created": int(time.time()),
                "model": req.get("model") or self.pool.model_name,
                "object": ("chat.completion" if chat else "text_completion")}
        if req.get("stream"):
            return Reply(200, events=self._stream(params, ids, chat, meta))
        return Reply(200, await self._oneshot(params, ids, chat, meta))

    async def _collect(self, first: Optional[int], q: asyncio.Queue,
                       max_new_tokens: int):
        """Token-id async generator; mirrors the WS consumer's contract:
        the stepper's None terminator is guaranteed only when the stream
        was visible to it (max_new_tokens > 1)."""
        if first is None:
            return
        yield int(first)
        if max_new_tokens > 1:
            while True:
                tok = await q.get()
                if tok is None:
                    return
                yield int(tok)

    async def _oneshot(self, params, ids, chat, meta) -> dict:
        pool = self.pool
        engine, slot, first, q = await pool.acquire_stream(
            ids, params["max_new_tokens"], params["temperature"],
            params["top_p"], params["repetition_penalty"],
            model=params.get("model"))
        # incremental stop-sequence scan, same as the SSE path: the
        # stream is abandoned (and its slot freed) at the match, so
        # usage.completion_tokens counts only tokens actually generated
        # for the client
        scan = _StopScanner(params["stop"])
        sdec = pool.ctx.stream_decoder()
        text, n_toks = "", 0
        try:
            async for tok in self._collect(first, q,
                                           params["max_new_tokens"]):
                n_toks += 1
                text += scan.feed(sdec.feed(tok))
                if scan.hit:
                    break
            reason = ("stop" if scan.hit else
                      engine.slots[slot].finished_reason or "stop")
        finally:
            await pool.release_stream(engine, slot)
        if not scan.hit:
            text += scan.feed(sdec.flush()) + scan.flush()
            if scan.hit:     # stop completed inside the held-back tail
                reason = "stop"
        usage = {"prompt_tokens": len(ids), "completion_tokens": n_toks,
                 "total_tokens": len(ids) + n_toks}
        choice = ({"index": 0, "finish_reason": reason,
                   "message": {"role": "assistant", "content": text}}
                  if chat else
                  {"index": 0, "finish_reason": reason, "text": text})
        return {**meta, "choices": [choice], "usage": usage}

    async def _stream(self, params, ids, chat, meta
                      ) -> AsyncIterator[dict]:
        """The SSE payloads of one streamed completion: (chat) the role
        handshake, a chunk a decoded piece, the held-back tail, the
        finish chunk.  The slot is released once the tokens end, or when
        the consumer closes the iterator."""
        pool = self.pool
        meta = {**meta, "object": ("chat.completion.chunk" if chat
                                   else "text_completion")}

        def chunk(delta_text: Optional[str], reason: Optional[str]):
            if chat:
                delta = {} if delta_text is None else {"content": delta_text}
                return {**meta, "choices": [{"index": 0, "delta": delta,
                                             "finish_reason": reason}]}
            return {**meta, "choices": [{"index": 0,
                                         "text": delta_text or "",
                                         "finish_reason": reason}]}

        engine, slot, first, q = await pool.acquire_stream(
            ids, params["max_new_tokens"], params["temperature"],
            params["top_p"], params["repetition_penalty"],
            model=params.get("model"))
        scan = _StopScanner(params["stop"])
        sdec = pool.ctx.stream_decoder()   # UTF-8-safe per-token decode
        try:
            if chat:
                yield {**meta, "choices": [
                    {"index": 0, "delta": {"role": "assistant"},
                     "finish_reason": None}]}
            async for tok in self._collect(first, q,
                                           params["max_new_tokens"]):
                if scan.hit:
                    break
                piece = scan.feed(sdec.feed(tok))
                if piece:
                    yield chunk(piece, None)
            reason = ("stop" if scan.hit else
                      engine.slots[slot].finished_reason or "stop")
        finally:
            await pool.release_stream(engine, slot)
        tail = "" if scan.hit else scan.feed(sdec.flush()) + scan.flush()
        if scan.hit:     # stop completed inside the held-back tail
            reason = "stop"
        if tail:
            yield chunk(tail, None)
        yield chunk(None, reason)

    # ---------------- aiohttp wiring ----------------
    def app(self):
        from aiohttp import web
        app = web.Application()
        app.router.add_get("/v1/models", self.handle_models)
        app.router.add_post("/v1/chat/completions", self.handle_chat)
        app.router.add_post("/v1/completions", self.handle_completions)
        app.router.add_get("/stats", self.handle_stats)
        return app

    async def handle_stats(self, request):
        return await self._send(request, self.stats())

    async def handle_models(self, request):
        return await self._send(request, self.models())

    async def handle_chat(self, request):
        return await self._send(request, await self.chat(
            await self._json(request)))

    async def handle_completions(self, request):
        return await self._send(request, await self.completions(
            await self._json(request)))

    @staticmethod
    async def _json(request):
        """The request's JSON body, or None where it is not JSON."""
        try:
            return await request.json()
        except Exception:
            return None

    @staticmethod
    async def _send(request, reply: Reply):
        from aiohttp import web
        if reply.events is None:
            return web.json_response(reply.body, status=reply.status)
        resp = web.StreamResponse(status=reply.status, headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            "Connection": "keep-alive"})
        await resp.prepare(request)
        events = reply.events
        try:
            async for payload in events:
                await resp.write(b"data: " + json.dumps(
                    payload, ensure_ascii=False).encode() + b"\n\n")
            await resp.write(b"data: [DONE]\n\n")
        except Exception:          # client went away: stop generating
            pass
        finally:
            await events.aclose()
        try:
            await resp.write_eof()
        except Exception:
            pass
        return resp


async def serve_http(ctx, host: str = "0.0.0.0", port: int = 8000,
                     n_slots: int = 8, burst: int = 1, replicas: int = 1,
                     warmup: bool = False, model_name: str = "default",
                     adapters=None):
    from aiohttp import web
    pool = WSServer(ctx, n_slots=n_slots, template=True, burst=burst,
                    replicas=replicas, model_name=model_name,
                    adapters=adapters)
    if warmup:
        warm(pool)
    runner = web.AppRunner(OpenAIServer(pool).app())
    await runner.setup()
    site = web.TCPSite(runner, host, port)
    await site.start()
    logger.info("OpenAI API on http://%s:%d/v1 (%d replicas x %d slots)",
                host, port, replicas, n_slots)
    await asyncio.Future()


def main():
    from nano_tpu_torch.serve.cli import add_engine_args, build_ctx
    ap = argparse.ArgumentParser(
        description="OpenAI-compatible HTTP server for .bin models")
    add_engine_args(ap, port=8000)
    args = ap.parse_args()

    logging.basicConfig(level=logging.INFO)
    ctx, adapters = build_ctx(args)
    asyncio.run(serve_http(ctx, args.host, args.port, args.slots,
                           burst=args.burst, replicas=args.replicas,
                           warmup=args.warmup,
                           model_name=os.path.basename(args.model),
                           adapters=adapters))


if __name__ == "__main__":
    main()
