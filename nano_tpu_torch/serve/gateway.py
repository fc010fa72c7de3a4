"""Model gateway: serve a GGUF model on this package's engine, a
transformers causal-LM, or llama.cpp, over the same WebSocket protocol as
the batched server.

Port of ``nano_tpu/serve/gateway.py``, the counterpart of the reference's
"Mio" gateway (reference: infer/web/server.py — a flask-socketio bridge to
llama.cpp/HF models with streaming and model hot-swap): the browser UI
(web/index.html) can point at either this gateway or the WebSocket server.

    python -m nano_tpu_torch.serve.gateway --model model.gguf  # the engine
    python -m nano_tpu_torch.serve.gateway --model /path/to/hf_model
    python -m nano_tpu_torch.serve.gateway --model a=/m1 --model b=/m2.gguf
                                     # named registry w/ runtime hot-swap

The backend is picked by file extension (`.gguf` -> this package's engine
for Qwen2/Qwen3 files, llama.cpp for the rest; anything else ->
transformers) or forced with --backend.  Both run on the card unless
``--device`` says otherwise.  The llama.cpp path needs llama-cpp-python
(reference: infer/web/server.py:211-256 uses the same library) and the
transformers path the transformers package; without them the gateway
refuses with a clear error instead of importing lazily mid-request.

Streaming runs on a worker thread; one generation at a time per model
(neither HF generate nor llama.cpp is batched-reentrant), queued
requests wait.
"""

from __future__ import annotations

import argparse
import asyncio
import gc
import json
import logging
import os
import struct
import threading
from typing import Optional

logger = logging.getLogger("nano_tpu_torch.gateway")


def _legacy_prompt(message: str) -> str:
    """Reference length-prefix framing: 'NNNNN|prompt'
    (nano_ws_client.html:28; main_wss.c:50 reads from index 6).
    Tolerates the separator-less variant from older probes."""
    n = int(message[:5])
    start = 6 if message[5:6] == "|" else 5
    return message[start:start + n]


def _is_stop(message) -> bool:
    """Mid-stream interrupt (reference Mio: infer/web/server.py:258-266):
    {"stop": true} or "STOP".  Same contract as wss.WSServer._is_stop."""
    if isinstance(message, bytes):
        message = message.decode("utf-8", errors="replace")
    if message.strip() == "STOP":
        return True
    try:
        return bool(json.loads(message).get("stop"))
    except Exception:
        return False


class _Gateway:
    """Shared WebSocket protocol; subclasses provide _generate_stream
    returning (iterator-of-text-pieces, error-list)."""

    MAX_NEW_TOKENS = 65536     # cap unvalidated client requests

    async def handle(self, websocket):
        pending: list = []         # pipelined frames read mid-stream
        while True:
            if pending:
                message = pending.pop(0)
            else:
                try:
                    message = await websocket.recv()
                except Exception:
                    break
            if _is_stop(message):
                continue           # stray stop outside a generation
            try:
                pending.extend(
                    await self._serve(websocket, message) or [])
            except Exception as e:   # pragma: no cover - network edge
                logger.exception("gateway request failed")
                try:
                    await websocket.send(json.dumps({"error": str(e)}))
                except Exception:
                    break

    async def _serve(self, websocket, message):
        """One generation (or control reply).  Watches the socket while
        streaming so a mid-stream {"stop": true} interrupts the backend
        (the UI's Stop button; reference Mio supports the same) instead
        of queueing up as a bogus empty-prompt generation.  Returns
        pipelined non-stop frames for handle() to process next."""
        if isinstance(message, bytes):         # binary frames carry
            message = message.decode(          # the same protocols
                "utf-8", errors="replace")
        req = json.loads(message) if message.lstrip().startswith("{") \
            else {"prompt": _legacy_prompt(message)}
        if isinstance(req, dict):
            ctrl = await self._control(req)
            if ctrl is not None:
                await websocket.send(json.dumps(ctrl, ensure_ascii=False))
                return []
        pending: list = []
        async with self.lock:
            streamer, err, stop = self._generate_stream(
                req.get("prompt", ""), bool(req.get("template", True)),
                min(int(req.get("max_new_tokens", 256)),
                    self.MAX_NEW_TOKENS),
                float(req.get("temperature", 1.0)),
                float(req.get("top_p", 0.8)),
                float(req.get("repetition_penalty", 1.05)))
            loop = asyncio.get_running_loop()
            it = iter(streamer)
            ended = False
            interrupted = False
            client_gone = False
            recv_task = asyncio.create_task(websocket.recv())
            try:
                while True:
                    piece_task = asyncio.ensure_future(
                        loop.run_in_executor(None, lambda: next(it, None)))
                    while not piece_task.done():
                        waiters = {piece_task}
                        if not interrupted and not recv_task.done():
                            waiters.add(recv_task)
                        done, _ = await asyncio.wait(
                            waiters, return_when=asyncio.FIRST_COMPLETED)
                        if recv_task in done and not interrupted:
                            try:
                                msg = recv_task.result()
                            except Exception:
                                msg = None
                                interrupted = client_gone = True
                            if msg is not None:
                                if _is_stop(msg):
                                    interrupted = True
                                else:  # pipelined request: queue it
                                    pending.append(msg)
                                    recv_task = asyncio.create_task(
                                        websocket.recv())
                            if interrupted:
                                stop()   # backend ends; drain below
                    piece = piece_task.result()
                    if piece is None:
                        ended = True
                        break
                    if piece and not interrupted:
                        await websocket.send(json.dumps(
                            {"text": piece}, ensure_ascii=False))
                if err:
                    raise err[0]
                if not client_gone:
                    await websocket.send(json.dumps(
                        {"done": True,
                         "reason": "interrupted" if interrupted
                         else "stop"}))
            finally:
                if not recv_task.done():
                    recv_task.cancel()
                    try:
                        await recv_task     # two concurrent recv() calls
                    except BaseException:   # are forbidden: await the
                        pass                # cancel (not an Exception)
                else:
                    try:
                        m = recv_task.result()
                        if m is not None:
                            pending.append(m)   # stray stops filtered
                    except Exception:           # by handle()
                        pass
                if not ended:
                    # an exception escaped mid-stream: the generation
                    # must not keep running after the lock frees (the
                    # next request would generate concurrently) —
                    # signal stop and drain until the backend ends
                    stop()
                    await loop.run_in_executor(
                        None, lambda: all(False for _ in it))
        return pending

    async def _control(self, req: dict):
        """Non-generation requests (model registry queries etc.).
        Return a response dict to short-circuit, or None to treat the
        message as a generation request."""
        return None


class HFGateway(_Gateway):
    """A transformers causal-LM on `device` (the card unless given)."""

    def __init__(self, model_path: str, device: Optional[str] = None,
                 dtype: str = "float32"):
        import torch
        from nano_tpu_torch import resolve_device
        from transformers import AutoModelForCausalLM, AutoTokenizer
        device = resolve_device(device)
        self.torch = torch
        self.tokenizer = AutoTokenizer.from_pretrained(model_path)
        self.model = AutoModelForCausalLM.from_pretrained(
            model_path, torch_dtype=getattr(torch, dtype))
        self.model.eval().to(device)
        self.device = device
        self.lock = asyncio.Lock()      # one generation at a time

    def _generate_stream(self, prompt: str, template: bool,
                         max_new_tokens: int, temperature: float,
                         top_p: float, repetition_penalty: float):
        from transformers import TextIteratorStreamer
        tok = self.tokenizer
        if template and tok.chat_template:
            text = tok.apply_chat_template(
                [{"role": "user", "content": prompt}], tokenize=False,
                add_generation_prompt=True)
        else:
            text = prompt
        inputs = tok(text, return_tensors="pt").to(self.device)
        inputs = {k: v for k, v in inputs.items()
                  if k in ("input_ids", "attention_mask")}
        # timeout so a crashed generate thread cannot deadlock the stream
        streamer = TextIteratorStreamer(tok, skip_prompt=True,
                                        skip_special_tokens=True,
                                        timeout=300.0)
        pad_id = tok.eos_token_id
        if pad_id is None:
            pad_id = int(inputs["input_ids"][0, -1])
        kwargs = dict(**inputs, streamer=streamer,
                      max_new_tokens=max_new_tokens,
                      repetition_penalty=repetition_penalty,
                      pad_token_id=pad_id)
        if temperature and temperature > 0:
            kwargs.update(do_sample=True, temperature=temperature,
                          top_p=top_p)
        else:
            kwargs.update(do_sample=False)
        err: list = []
        stop_event = threading.Event()
        try:
            from transformers import StoppingCriteria, StoppingCriteriaList

            class _ClientGone(StoppingCriteria):
                def __call__(self, input_ids, scores, **kw):
                    return stop_event.is_set()

            kwargs["stopping_criteria"] = StoppingCriteriaList(
                [_ClientGone()])
        except ImportError:            # stubbed transformers in tests
            pass

        def run():
            try:
                self.model.generate(**kwargs)
            except Exception as e:     # surface through the streamer
                err.append(e)
                streamer.end()
        thread = threading.Thread(target=run, daemon=True)
        thread.start()
        return streamer, err, stop_event.set


class NativeGGUFGateway(_Gateway):
    """GGUF served on this package's engine: ``LLMContext.from_gguf``
    imports the checkpoint (dense Qwen2/Qwen3, the ggml blocks kept in the
    quantized layouts, bf16 activations) onto `device` (the card unless
    given) and requests stream through ``Session`` — no llama.cpp needed.
    Non-Qwen GGUFs raise at load; make_gateway falls back to the
    llama-cpp-python backend for those.

    One context serves every request: its sampler is set for each one
    while the gateway's lock is held (one generation at a time), so the
    context keeps one decoder — one n_ctx-row cache — and its graphs,
    keyed per sampler, are captured once and replayed by later requests.
    A copy of the context for each request (the JAX gateway's
    ``dataclasses.replace``) would make a new decoder, cache and graph
    captures every time."""

    def __init__(self, model_path: str, n_ctx: int = 4096,
                 device: Optional[str] = None):
        from nano_tpu_torch.infer import engine as neng
        from nano_tpu_torch.ops import sampling as nsmp
        self._neng, self._nsmp = neng, nsmp
        self.ctx = neng.LLMContext.from_gguf(model_path, max_seq_len=n_ctx,
                                             device=device)
        self.lock = asyncio.Lock()

    def _generate_stream(self, prompt: str, template: bool,
                         max_new_tokens: int, temperature: float,
                         top_p: float, repetition_penalty: float):
        ctx = self.ctx
        ctx.sampler = self._nsmp.SamplerConfig(
            temperature=max(temperature, 0.0), top_p=top_p,
            repetition_penalty=repetition_penalty)
        stop_event = threading.Event()
        err: list = []

        def pieces():
            try:
                sess = self._neng.Session(ctx, prompt,
                                          max_new_tokens=max_new_tokens,
                                          template=template)
                dec = ctx.stream_decoder()
                while not stop_event.is_set():
                    t = sess.step()
                    if t is None:
                        break
                    piece = dec.feed(t)
                    if piece:
                        yield piece
                tail = dec.flush()
                if tail:
                    yield tail
            except Exception as e:          # surfaced by the handler
                err.append(e)

        gen = pieces()
        return gen, err, stop_event.set


class GGUFGateway(_Gateway):
    """llama.cpp backend: stream a local GGUF model (reference: the Mio
    server's llama-cpp-python path, infer/web/server.py:211-256).
    make_gateway prefers NativeGGUFGateway for Qwen-arch files; this
    backend covers the rest when llama-cpp-python is installed."""

    def __init__(self, model_path: str, n_ctx: int = 4096,
                 n_threads: int = 0, n_gpu_layers: int = 0):
        try:
            from llama_cpp import Llama
        except ImportError as e:
            raise RuntimeError(
                "GGUF backend needs llama-cpp-python (pip install "
                "llama-cpp-python); use an HF model path for the "
                "transformers backend") from e
        self.llama = Llama(model_path=model_path, n_ctx=n_ctx,
                           n_threads=n_threads or None,
                           n_gpu_layers=n_gpu_layers, verbose=False)
        self.lock = asyncio.Lock()

    def _generate_stream(self, prompt: str, template: bool,
                         max_new_tokens: int, temperature: float,
                         top_p: float, repetition_penalty: float):
        kwargs = dict(max_tokens=max_new_tokens,
                      temperature=max(temperature, 0.0), top_p=top_p,
                      repeat_penalty=repetition_penalty, stream=True)

        def pieces():
            if template:
                # GGUF metadata carries the chat template; llama.cpp
                # applies it (create_chat_completion)
                for chunk in self.llama.create_chat_completion(
                        [{"role": "user", "content": prompt}], **kwargs):
                    delta = chunk["choices"][0].get("delta", {})
                    if "content" in delta and delta["content"]:
                        yield delta["content"]
            else:
                for chunk in self.llama.create_completion(prompt, **kwargs):
                    text = chunk["choices"][0].get("text", "")
                    if text:
                        yield text

        gen = pieces()
        # llama.cpp's streaming generator is lazily driven — closing it
        # is the whole stop story (no background thread)
        return gen, [], gen.close


class SwitchableGateway(_Gateway):
    """Named-model registry with runtime hot-swap over the same socket.

    Reference parity: the Mio server's `get_current_llm_key`/`change_llm`
    events (reference: infer/web/server.py:224-256) — switching is
    refused while a generation is in flight, and the old backend is
    disposed BEFORE the new one loads (so a host that can hold one big
    model can still swap between two).  Protocol additions:

        {"list_models": true}        -> {"models": [...], "current": name}
        {"switch_model": "name"}     -> {"ok": bool, "current": name,
                                         "switched": bool [, "error"]}
    """

    def __init__(self, models: dict, current: str | None = None, **default_kw):
        if not models:
            raise ValueError("empty model registry")
        self.models = {name: (spec if isinstance(spec, dict)
                              else {"model_path": spec})
                       for name, spec in models.items()}
        self.default_kw = dict(default_kw)
        self.lock = asyncio.Lock()
        self.backend = None
        self.current = None
        self._load(current or next(iter(self.models)))

    def _load(self, name: str) -> None:
        spec = {**self.default_kw, **self.models[name]}
        path = spec.pop("model_path")
        # dispose first (reference: server.py `load_model` del + llm_gc)
        # so peak memory is one model, not two
        self.backend = None
        self.current = None
        gc.collect()
        self.backend = make_gateway(path, **spec)
        self.current = name

    def _generate_stream(self, *args, **kw):
        if self.backend is None:
            raise RuntimeError("no model loaded (the last switch_model "
                               "failed); switch_model to a valid entry")
        return self.backend._generate_stream(*args, **kw)

    async def _control(self, req: dict):
        if req.get("list_models") or req.get("get_current_model"):
            return {"models": sorted(self.models), "current": self.current}
        if "switch_model" in req:
            name = req["switch_model"]
            if name not in self.models:
                return {"ok": False, "current": self.current,
                        "error": f"unknown model: {name!r}"}
            if name == self.current:
                return {"ok": True, "current": name, "switched": False}
            if self.lock.locked():
                # mirror the reference's refusal while generating
                # (server.py:233-235) instead of queueing a swap
                return {"ok": False, "current": self.current,
                        "error": "busy: a generation is in progress"}
            async with self.lock:
                loop = asyncio.get_running_loop()
                try:
                    await loop.run_in_executor(None, self._load, name)
                except Exception as e:
                    logger.exception("switch_model %r failed", name)
                    return {"ok": False, "current": self.current,
                            "error": str(e)}
            logger.info("switched model to %r", name)
            return {"ok": True, "current": name, "switched": True}
        return None


def parse_model_registry(entries):
    """CLI `--model` values -> ordered {name: {"model_path": path}}.
    `name=path` sets the name explicitly; a bare path is named by its
    basename (the whole string if the basename is empty)."""
    reg = {}
    for e in entries:
        if "=" in e:
            name, path = e.split("=", 1)
        else:
            path = e
            name = os.path.basename(e.rstrip("/")) or e
        if not name or not path:
            raise ValueError(f"bad --model entry: {e!r}")
        if name in reg:
            raise ValueError(f"duplicate model name: {name!r}")
        reg[name] = {"model_path": path}
    return reg


def make_gateway(model_path: str, backend: str = "auto", **kw):
    """Pick the backend: explicit --backend wins, else .gguf extension.
    GGUF prefers the native engine (Qwen archs import directly,
    io/gguf.py) and falls back to llama-cpp-python for other archs."""
    if backend == "auto":
        backend = "gguf" if model_path.endswith(".gguf") else "hf"
    if backend == "gguf":
        try:
            return NativeGGUFGateway(model_path,
                                     n_ctx=kw.get("n_ctx", 4096),
                                     device=kw.get("device"))
        except (ValueError, OSError, KeyError, struct.error) as e:
            # ValueError: non-qwen arch / bad container; struct.error:
            # truncated metadata; KeyError: missing tensors — all mean
            # "not natively importable", so fall back rather than crash
            logger.info("native GGUF import declined (%s); trying "
                        "llama-cpp-python", e)
        return GGUFGateway(model_path,
                           n_ctx=kw.get("n_ctx", 4096),
                           n_threads=kw.get("n_threads", 0),
                           n_gpu_layers=kw.get("n_gpu_layers", 0))
    if backend == "gguf-native":
        return NativeGGUFGateway(model_path, n_ctx=kw.get("n_ctx", 4096),
                                 device=kw.get("device"))
    if backend == "gguf-llama":
        return GGUFGateway(model_path,
                           n_ctx=kw.get("n_ctx", 4096),
                           n_threads=kw.get("n_threads", 0),
                           n_gpu_layers=kw.get("n_gpu_layers", 0))
    if backend == "hf":
        return HFGateway(model_path, device=kw.get("device"),
                         dtype=kw.get("dtype", "float32"))
    raise ValueError(f"unknown gateway backend: {backend!r}")


async def serve(model_path, host: str, port: int, **kw):
    """model_path: a single path/name, or a list of CLI --model entries
    (more than one -> a SwitchableGateway registry)."""
    import websockets
    if isinstance(model_path, (list, tuple)):
        if len(model_path) > 1:
            gw = SwitchableGateway(parse_model_registry(model_path), **kw)
        else:
            model_path = model_path[0].split("=", 1)[-1]
    if not isinstance(model_path, (list, tuple)):
        gw = make_gateway(model_path, **kw)
    async with websockets.serve(gw.handle, host, port, max_size=2 ** 22):
        logger.info("%s gateway on ws://%s:%d (%s)",
                    type(gw).__name__, host, port, model_path)
        await asyncio.Future()


def main():
    ap = argparse.ArgumentParser(description="Model WebSocket gateway "
                                             "(GGUF on the engine, "
                                             "transformers or llama.cpp)")
    ap.add_argument("--model", required=True, action="append",
                    help="HF model path/name or .gguf file; repeat "
                         "(optionally as name=path) for a hot-swappable "
                         "registry")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "hf", "gguf", "gguf-native",
                             "gguf-llama"])
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8081)
    ap.add_argument("--device", default=None,
                    help="the engine's and the hf backend's torch device "
                         "(default: cuda)")
    ap.add_argument("--dtype", default="float32", help="hf backend")
    ap.add_argument("--n_ctx", type=int, default=4096, help="gguf backend")
    ap.add_argument("--n_threads", type=int, default=0, help="gguf backend")
    ap.add_argument("--n_gpu_layers", type=int, default=0,
                    help="gguf backend")
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO)
    asyncio.run(serve(args.model, args.host, args.port,
                      backend=args.backend, device=args.device,
                      dtype=args.dtype, n_ctx=args.n_ctx,
                      n_threads=args.n_threads,
                      n_gpu_layers=args.n_gpu_layers))


if __name__ == "__main__":
    main()
