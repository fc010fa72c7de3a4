"""WebSocket voice bridge — offline browser ASR/TTS against local DSP.

Port of ``nano_tpu/serve/voice_ws.py`` over this package's ``serve/asr.py``;
nothing here runs on the card.  The reference runs voice fully in-browser via WASM model blobs
(reference: infer/web/whisper_worker.js:1-224, piper_worker.js:1-208);
this image can ship neither WASM builds nor model weights, so the
offline path is SELF-HOSTED instead: the browser streams microphone PCM
to this server over a WebSocket and the same pluggable recognizers that
power the FIFO appliance loop (serve/asr.py — sherpa / HF / the
self-contained morse DSP decoder) run server-side.  Voice output
mirrors it: a TTS request returns a WAV rendered locally
(text_to_morse_pcm today; any ``synthesize(text) -> Audio`` callable
plugs in).  web/asr.js + web/tts.js carry matching
``serverBackend(url)`` factories, so the chat UI's voice buttons work
with zero vendor/cloud dependency.

Protocol (one connection, interleaved requests):
  {"type": "start", "rate": 16000}   begin a capture
  <binary frames>                    s16le mono PCM chunks
  {"type": "stop"}                   -> {"type": "asr", "text": ...}
  {"type": "tts", "text": "..."}     -> {"type": "tts_wav"} + one binary
                                        frame holding a complete WAV

Run: python -m nano_tpu_torch.serve.voice_ws --port 8790 --backend morse
"""

from __future__ import annotations

import argparse
import asyncio
import io
import json
import logging
import wave
from typing import Callable, Optional

import numpy as np

from nano_tpu_torch.serve.asr import (Audio, make_morse_recognizer,
                                make_sherpa_recognizer,
                                make_transformers_recognizer,
                                pcm16_to_float, text_to_morse_pcm)

logger = logging.getLogger("nano_tpu_torch.voice_ws")


def audio_to_wav_bytes(audio: Audio) -> bytes:
    """float32 mono PCM -> PCM16 WAV container bytes."""
    pcm, rate = audio
    clipped = np.clip(pcm, -1.0, 1.0)
    raw = (clipped * 32767.0).astype("<i2").tobytes()
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(raw)
    return buf.getvalue()


def make_morse_synthesizer(rate: int = 16000,
                           unit_ms: float = 60.0) -> Callable[[str], Audio]:
    def synthesize(text: str) -> Audio:
        return text_to_morse_pcm(text, rate=rate, unit_ms=unit_ms), rate
    return synthesize


class VoiceWSServer:
    """One handler instance serves many connections; capture state is
    per-connection (a browser holds one socket for the whole session)."""

    def __init__(self, recognizer: Callable[[Audio], str],
                 synthesizer: Optional[Callable[[str], Audio]] = None):
        self.recognizer = recognizer
        self.synthesizer = synthesizer or make_morse_synthesizer()

    MAX_CAPTURE_BYTES = 64 * 1024 * 1024   # ~35 min of 16 kHz s16le —
    # a network-facing server must bound the capture buffer (a client
    # whose stop message never arrives would otherwise OOM the process)

    async def handle(self, websocket):
        chunks: list = []
        captured = 0
        capturing = False
        rate = 16000
        loop = asyncio.get_running_loop()
        async for message in websocket:
            if isinstance(message, (bytes, bytearray)):
                if capturing:
                    captured += len(message)
                    if captured > self.MAX_CAPTURE_BYTES:
                        capturing = False
                        chunks = []
                        captured = 0
                        await websocket.send(json.dumps(
                            {"type": "error",
                             "error": "capture too long"}))
                        continue
                    chunks.append(bytes(message))
                continue
            try:
                req = json.loads(message)
                typ = req.get("type")
                if typ == "start":
                    capturing = True
                    chunks = []
                    captured = 0
                    rate = int(req.get("rate", 16000))
                elif typ == "stop":
                    capturing = False
                    pcm = pcm16_to_float(b"".join(chunks))
                    chunks = []
                    # recognizers can be heavy (HF) — keep the loop live
                    text = await loop.run_in_executor(
                        None, self.recognizer, (pcm, rate))
                    await websocket.send(json.dumps(
                        {"type": "asr", "text": text}, ensure_ascii=False))
                elif typ == "tts":
                    wav = await loop.run_in_executor(
                        None, lambda: audio_to_wav_bytes(
                            self.synthesizer(req.get("text", ""))))
                    await websocket.send(json.dumps({"type": "tts_wav",
                                                     "bytes": len(wav)}))
                    await websocket.send(wav)
                else:
                    await websocket.send(json.dumps(
                        {"type": "error", "error": f"unknown type {typ!r}"}))
            except Exception as e:   # keep the connection alive on errors
                logger.exception("voice request failed")
                try:
                    await websocket.send(json.dumps(
                        {"type": "error", "error": str(e)}))
                except Exception:
                    break


async def serve(host: str, port: int, backend: str, model_dir: str):
    import websockets
    if backend == "sherpa":
        rec = make_sherpa_recognizer(model_dir)
    elif backend == "hf":
        rec = make_transformers_recognizer(model_dir or "openai/whisper-tiny")
    else:
        rec = make_morse_recognizer()
    server = VoiceWSServer(rec)
    async with websockets.serve(server.handle, host, port,
                                max_size=2 ** 24):
        logger.info("voice bridge on ws://%s:%d (%s)", host, port, backend)
        await asyncio.Future()


def main():  # pragma: no cover - interactive server
    ap = argparse.ArgumentParser(description="WebSocket voice bridge")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8790)
    ap.add_argument("--backend", default="morse",
                    choices=["morse", "sherpa", "hf"])
    ap.add_argument("--model-dir", default="")
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO)
    asyncio.run(serve(args.host, args.port, args.backend, args.model_dir))


if __name__ == "__main__":
    main()
