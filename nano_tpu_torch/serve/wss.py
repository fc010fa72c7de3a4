"""WebSocket streaming inference server with continuous batching.

Port of ``nano_tpu/serve/wss.py``, which replaces the reference's
libwebsockets single-stream server (reference: infer/main_wss.c): one
asyncio process serves many concurrent chats, all sharing one batched
decode step on the card (``serve/batching.py``: CUDA graphs replayed a
burst at a time).  Every call into the engine (``add``, ``step_burst``,
``release``) runs in the default thread pool, never on the event loop's
thread; the engine runs its device work on the context's stream under the
context's lock.

Protocols (auto-detected per message):
  * reference "chat" protocol: a text message of `NNNNN` (5-digit length)
    + prompt (reference: infer/main_wss.c:41-52); tokens stream back as
    plain text frames, then an empty frame terminates the reply.
  * JSON: {"prompt": ..., "max_new_tokens": 256, "temperature": 1.0,
    "top_p": 0.8, "repetition_penalty": 1.1, "template": true};
    responses are {"token": id, "text": ...} frames then
    {"done": true, "reason": ...}.

Run: python -m nano_tpu_torch.serve.wss --model m.bin --port 8080
     [--device cpu]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import time
from collections import deque
from typing import Optional

from nano_tpu_torch.serve.batching import BatchedEngine

logger = logging.getLogger("nano_tpu_torch.serve")


def _replica_devices(ctx, replicas: int) -> list:
    """The devices of `replicas` replicas of `ctx`: one card each for a
    context on the card (refused beyond the cards there are), the CPU for
    each replica of a context on the CPU."""
    import torch
    if ctx.device.type != "cuda":
        return [ctx.device] * replicas
    n = torch.cuda.device_count()
    if n < replicas:
        raise ValueError(f"replicas={replicas} but only {n} devices")
    return [torch.device("cuda", i) for i in range(replicas)]


def warm(server) -> None:
    """Capture every decode graph and run every prefill bucket of each
    replica before the server takes a connection (``BatchedEngine.warmup``).
    A burst of any length replays the same one-step graphs, so this covers
    every --burst."""
    for i, be in enumerate(server.engines):
        t0 = time.time()
        k = be.warmup()
        logger.info("replica %d: warmed %d graphs and prefill buckets in "
                    "%.1fs", i, k, time.time() - t0)


class WSServer:
    """One asyncio process, one or more engine REPLICAS.

    replicas > 1 is data-parallel serving: the model is copied to that
    many devices (LLMContext.replicate_to: cuda:0 .. cuda:N-1 for a
    context on the card, refusing more replicas than cards; the CPU again
    for a context on the CPU) and each replica runs its own
    continuous-batching engine and stepper task, so decode steps execute
    concurrently across cards.  Joins go to the least-loaded replica with
    a free slot.
    """

    def __init__(self, ctx, n_slots: int = 8, template: bool = True,
                 burst: int = 1, replicas: int = 1,
                 model_name: str = "default",
                 adapters: Optional[dict] = None):
        self.ctx = ctx
        self.model_name = model_name   # the base variant's name
        if replicas > 1:
            ctxs = [ctx] + [ctx.replicate_to(d)
                            for d in _replica_devices(ctx, replicas)[1:]]
        else:
            ctxs = [ctx]
        # batched multi-adapter serving: named LoRA variants decode in
        # the SAME dispatch as the base model — the registry is stacked
        # inside each engine and gathered per slot (serve/batching.py);
        # requests route by "model"/switch_model.  Beyond-parity (the
        # reference swaps one adapter per process, infer/main_wasm.c).
        if adapters and model_name in adapters:
            raise ValueError(f"adapter name collides with the base "
                             f"model name: {model_name!r}")
        self.engine_names = [model_name] + list(adapters or {})
        self.engines = [BatchedEngine(c, n_slots=n_slots,
                                      adapters=adapters) for c in ctxs]
        self.engine = self.engines[0]      # single-replica compat alias
        self.template = template
        # multi-step scheduling: decode `burst` tokens per dispatched
        # program (amortizes fixed dispatch cost; tokens stream in small
        # groups instead of one-by-one)
        self.burst = max(1, burst)
        self._wakes = [asyncio.Event() for _ in self.engines]
        self._slot_freed = asyncio.Event()   # waiter queue for joins
        self._steppers = [None] * len(self.engines)
        # serving metrics (stats() — SURVEY §5.5 observability)
        self._t_start = time.time()
        self._tok_total = 0
        self._req_total = 0
        self._tok_window: deque = deque()    # (t, n) bursts, 60 s window

    # ------------------------------------------------------------
    async def _step_loop(self, ei: int):
        """One background task per replica advancing its streams."""
        loop = asyncio.get_running_loop()
        engine = self.engines[ei]
        wake = self._wakes[ei]
        while True:
            if engine.n_active == 0:
                wake.clear()
                await wake.wait()
            # the device call blocks — run it off the event loop
            try:
                out = await loop.run_in_executor(
                    None, engine.step_burst, self.burst)
            except asyncio.CancelledError:
                raise
            except Exception:
                # a transient device/tunnel error must not kill the
                # stepper silently (clients would hang on q.get()
                # forever): terminate every active stream cleanly and
                # keep stepping
                logger.exception("step_burst failed; ending active streams")
                with engine.lock:
                    for slot, st in enumerate(engine.slots):
                        if st.active:
                            st.active = False
                            st.finished_reason = "error"
                            if st.sink is not None:
                                st.sink.put_nowait(None)
                continue
            n_burst = 0
            for slot, toks in out.items():
                # deliver to the sink captured with the tokens under the
                # engine lock — never a lookup keyed by slot (stale
                # deliveries must not reach a NEWER stream's queue, and a
                # queue registered after add() would miss early bursts)
                q = out.sinks.get(slot)
                if q is None:
                    continue
                for tok in toks:
                    q.put_nowait(tok)
                n_burst += len(toks)
                # end-of-stream comes from the flags captured under the
                # engine lock, never from live slot state (a new stream
                # could have re-claimed the slot since)
                if out.ended.get(slot):
                    q.put_nowait(None)   # stream ended: terminator
            if n_burst:
                self._tok_total += n_burst
                now = time.time()
                self._tok_window.append((now, n_burst))
                # prune here, not just in stats(): a server whose
                # operator never polls must not grow the window forever
                cutoff = now - 60.0
                while self._tok_window and self._tok_window[0][0] < cutoff:
                    self._tok_window.popleft()

    def _ensure_stepper(self):
        for ei in range(len(self.engines)):
            if self._steppers[ei] is None or self._steppers[ei].done():
                self._steppers[ei] = asyncio.create_task(
                    self._step_loop(ei))

    def _pick_engine(self, model: Optional[str] = None):
        """Least-loaded replica with a free slot, or None.  Every
        replica serves every variant (per-slot adapters), so `model`
        does not constrain the choice."""
        del model
        best, best_load = None, None
        for ei, e in enumerate(self.engines):
            if e.free_slot() is None:
                continue
            load = e.n_active
            if best is None or load < best_load:
                best, best_load = ei, load
        return best

    # ------------------------------------------------------------
    async def acquire_stream(self, ids, max_new_tokens: int,
                             temperature: float, top_p: float,
                             repetition_penalty: float,
                             model: Optional[str] = None):
        """Join the least-loaded replica (waiting for a free slot if
        none) and return (engine, slot, first_token, token_queue).  The
        queue is registered inside add() under the engine lock, so no
        burst can slip between slot activation and queue attachment; it
        yields ints then a None terminator.  Callers MUST pair with
        release_stream().  Transport-agnostic: used by the WebSocket
        handler below and the OpenAI HTTP frontend (serve/openai_http)."""
        if model is not None and model not in self.engine_names:
            raise ValueError(f"unknown model: {model!r}")
        adapter = None if model in (None, self.model_name) else model
        self._ensure_stepper()
        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()
        while True:
            ei = self._pick_engine(model)
            if ei is not None:
                engine = self.engines[ei]
                res = await loop.run_in_executor(
                    None, lambda e=engine: e.add(
                        ids, int(max_new_tokens), float(temperature),
                        float(top_p), float(repetition_penalty), sink=q,
                        adapter=adapter))
                if res is not None:
                    self._wakes[ei].set()
                    self._req_total += 1
                    slot, first = res
                    if first is not None:    # prefill's token counts too
                        self._tok_total += 1
                        self._tok_window.append((time.time(), 1))
                    return engine, slot, first, q
            self._slot_freed.clear()
            if self._pick_engine(model) is not None:
                continue       # a release slipped in before the clear
            await self._slot_freed.wait()

    async def release_stream(self, engine, slot: int) -> None:
        """release() takes the engine lock, which step_burst holds
        across a whole burst (and any graph capture) — run it off the
        event loop like add()."""
        await asyncio.get_running_loop().run_in_executor(
            None, engine.release, slot)
        self._slot_freed.set()   # wake any parked joiners

    # ------------------------------------------------------------
    def stats(self) -> dict:
        """Live serving metrics (SURVEY §5.5): answered over both
        frontends — WS {"stats": true} and HTTP GET /stats."""
        now = time.time()
        cutoff = now - 60.0
        while self._tok_window and self._tok_window[0][0] < cutoff:
            self._tok_window.popleft()
        span = min(60.0, max(now - self._t_start, 1e-9))
        return {
            "model": self.model_name,
            "models": list(dict.fromkeys(self.engine_names)),
            "uptime_s": round(now - self._t_start, 1),
            "replicas": len(self.engines),
            "burst": self.burst,
            "slots_total": sum(len(e.slots) for e in self.engines),
            "slots_active": sum(e.n_active for e in self.engines),
            "requests_total": self._req_total,
            "tokens_total": self._tok_total,
            "tok_s_60s": round(sum(n for _, n in self._tok_window) / span,
                               1),
        }

    # ------------------------------------------------------------
    @staticmethod
    def _is_stop(message) -> bool:
        """Mid-stream interrupt (reference Mio gateway supports the same,
        infer/web/server.py:258-266): {"stop": true} or "STOP"."""
        if isinstance(message, bytes):
            message = message.decode("utf-8", errors="replace")
        if message.strip() == "STOP":
            return True
        try:
            return bool(json.loads(message).get("stop"))
        except Exception:
            return False

    async def handle(self, websocket):
        """One connection; one request at a time per connection."""
        pending = []
        conn = {"model": None}     # per-connection default variant
        while True:
            if pending:
                message = pending.pop(0)
            else:
                try:
                    message = await websocket.recv()
                except Exception:
                    break
            if self._is_stop(message):
                continue           # stray stop outside a generation
            try:
                pending.extend(await self._serve_request(websocket, message,
                                                         conn)
                               or [])
            except Exception as e:  # pragma: no cover - network edge
                logger.exception("request failed")
                try:
                    await websocket.send(json.dumps({"error": str(e)}))
                except Exception:
                    break

    async def _serve_request(self, websocket, message: str,
                             conn: Optional[dict] = None):
        conn = conn if conn is not None else {"model": None}
        self._ensure_stepper()
        json_mode = False
        s = self.ctx.sampler   # server-level defaults, like the reference's
        # CLI-configured sampler (infer/main_wss.c:125-168)
        params = dict(max_new_tokens=256, temperature=s.temperature,
                      top_p=s.top_p,
                      repetition_penalty=s.repetition_penalty,
                      template=self.template)
        if isinstance(message, bytes):
            message = message.decode("utf-8", errors="replace")
        if message.lstrip().startswith("{"):
            req = json.loads(message)
            # registry verbs, protocol-uniform with the gateway's
            # hot-swap (serve/gateway.py SwitchableGateway) so the same
            # browser UI can probe either server; the registry = the
            # base model plus any LoRA variants (--lora name=path), and
            # switch_model sets THIS connection's default variant
            cur = conn["model"] or self.model_name
            if req.get("stats"):
                await websocket.send(json.dumps(self.stats()))
                return []
            if req.get("list_models") or req.get("get_current_model"):
                await websocket.send(json.dumps(
                    {"models": list(dict.fromkeys(self.engine_names)),
                     "current": cur}))
                return []
            if "switch_model" in req:
                name = req["switch_model"]
                ok = name in self.engine_names
                if ok:
                    conn["model"] = name
                resp = {"ok": ok, "current": name if ok else cur,
                        "switched": ok and name != cur}
                if not ok:
                    resp["error"] = f"unknown model: {name!r}"
                await websocket.send(json.dumps(resp))
                return []
            if req.get("model") and req["model"] not in self.engine_names:
                await websocket.send(json.dumps(
                    {"error": f"unknown model: {req['model']!r}"}))
                return []
            prompt = req.get("prompt", "")
            for k in ("max_new_tokens", "temperature", "top_p",
                      "repetition_penalty", "template"):
                if k in req:
                    params[k] = req[k]
            if req.get("model"):
                conn["model"] = req["model"]   # sticky, like switch_model
            json_mode = True
        else:
            # reference protocol: 5-digit length prefix, '|', prompt
            # (nano_ws_client.html:28 builds `${len}|${prompt}`;
            # infer/main_wss.c:50 reads chars from w_input[i+6]).
            # Tolerate a separator-less variant from older probes.
            n = int(message[:5])
            start = 6 if message[5:6] == "|" else 5
            prompt = message[start:start + n]

        # BPE-encoding a long prompt is pure Python — off the loop, or
        # every other stream's sends stall behind it
        loop0 = asyncio.get_running_loop()
        ids = await loop0.run_in_executor(
            None, self.ctx.build_prompt_ids, prompt,
            bool(params["template"]))

        # wait for a free slot on the least-loaded replica (continuous
        # batching: joins mid-flight); waiters park on an event that
        # release() sets — no polling
        engine, slot, first, q = await self.acquire_stream(
            ids, int(params["max_new_tokens"]),
            float(params["temperature"]), float(params["top_p"]),
            float(params["repetition_penalty"]), model=conn["model"])

        closed = False

        async def send_safe(payload: str) -> bool:
            """A client disconnecting mid-stream is normal, not an error."""
            nonlocal closed
            if closed:
                return False
            try:
                await websocket.send(payload)
                return True
            except Exception:
                closed = True
                return False

        # incremental decode: multi-byte UTF-8 split across tokens is
        # held until complete (engine.StreamDecoder)
        sdec = self.ctx.stream_decoder()

        async def send_tok(tok: int):
            text = sdec.feed(tok)
            if json_mode:
                await send_safe(json.dumps(
                    {"token": int(tok), "text": text}, ensure_ascii=False))
            elif text:
                # raw protocol: an EMPTY frame is the end-of-reply
                # terminator (below) — a buffering StreamDecoder step
                # must not emit one mid-stream
                await send_safe(text)

        interrupted = False
        pending_msg = []
        recv_task = asyncio.create_task(websocket.recv())
        try:
            if first is not None:
                await send_tok(first)
                # Loop until the stepper's None TERMINATOR — never on
                # live slot state: _consume flips `active` inside the
                # executor thread BEFORE the step loop enqueues that
                # burst's tokens, so an active check here silently drops
                # the stream's tail (observed as short replies under
                # concurrency).  The terminator is guaranteed whenever
                # the stream was ever visible to the stepper; the one
                # case it never is — add() ended the stream immediately
                # because max_new_tokens <= 1 — is excluded here.
                if int(params["max_new_tokens"]) > 1:
                    while not interrupted and not closed:
                        get_task = asyncio.create_task(q.get())
                        done, _ = await asyncio.wait(
                            {get_task, recv_task},
                            return_when=asyncio.FIRST_COMPLETED)
                        if recv_task in done:
                            try:
                                msg = recv_task.result()
                            except Exception:
                                msg, interrupted = None, True
                            if msg is not None:
                                if self._is_stop(msg):
                                    interrupted = True
                                else:  # pipelined next requests: queue ALL
                                    pending_msg.append(msg)
                                    recv_task = asyncio.create_task(
                                        websocket.recv())
                        if get_task in done:
                            tok = get_task.result()
                            if tok is None:
                                break
                            await send_tok(tok)
                        else:
                            get_task.cancel()
            tail = sdec.flush()
            if tail:           # stream ended mid-character: emit U+FFFD
                await send_safe(json.dumps({"text": tail},
                                           ensure_ascii=False)
                                if json_mode else tail)
            reason = ("interrupted" if interrupted else
                      engine.slots[slot].finished_reason or "stop")
            if json_mode:
                await send_safe(json.dumps({"done": True,
                                            "reason": reason}))
            else:
                await send_safe("")   # reference: empty frame ends reply
        finally:
            if not recv_task.done():
                recv_task.cancel()
                try:
                    await recv_task     # two concurrent recv() calls are
                except BaseException:   # forbidden: await the cancellation
                    pass                # (CancelledError is NOT Exception)
            else:
                # completed after the loop: keep the message (it may be a
                # pipelined request; stray stops are filtered by handle())
                try:
                    pending_msg.append(recv_task.result())
                except Exception:
                    pass
            await self.release_stream(engine, slot)
        return pending_msg


async def serve(ctx, host: str = "0.0.0.0", port: int = 8080,
                n_slots: int = 8, template: bool = True, burst: int = 1,
                replicas: int = 1, warmup: bool = False,
                model_name: str = "default",
                adapters: Optional[dict] = None):
    import websockets
    server = WSServer(ctx, n_slots=n_slots, template=template, burst=burst,
                      replicas=replicas, model_name=model_name,
                      adapters=adapters)
    if warmup:
        warm(server)
    async with websockets.serve(server.handle, host, port, max_size=2 ** 22):
        logger.info("listening on ws://%s:%d (%d replicas x %d slots)",
                    host, port, replicas, n_slots)
        await asyncio.Future()


def main():
    from nano_tpu_torch.serve.cli import add_engine_args, build_ctx
    ap = argparse.ArgumentParser(description="nano_tpu_torch WebSocket "
                                             "server")
    add_engine_args(ap, port=8080)
    ap.add_argument("--no_template", action="store_true")
    args = ap.parse_args()

    logging.basicConfig(level=logging.INFO)
    ctx, adapters = build_ctx(args)
    asyncio.run(serve(ctx, args.host, args.port, args.slots,
                      template=not args.no_template, burst=args.burst,
                      replicas=args.replicas, warmup=args.warmup,
                      model_name=os.path.basename(args.model),
                      adapters=adapters))


if __name__ == "__main__":
    main()
