"""Offline ASR server — the voice-input side of the appliance stack.

Port of ``nano_tpu/serve/asr.py``, a copy: nothing here runs on the card.
Counterpart of the reference's ASR feed (reference:
infer/asr/asr_server.py:1-124 — sherpa-onnx streaming paraformer +
punctuation — and the FIFO glue infer/asr.c:10-100): a push-to-talk
byte arrives on ``/tmp/ptt_fifo`` (1 = start listening, 0 = stop) and
recognized text is written to ``/tmp/asr_fifo`` for whatever frontend
is listening (the reference Pod; our WSS server can inject it as a
prompt).

Audio enters through a pluggable CAPTURE (PCM bytes from a fifo or TCP
socket, accumulated while PTT is held — ``FifoPcmCapture`` /
``SocketPcmCapture``) and text exits through a pluggable RECOGNIZER:

  * ``make_sherpa_recognizer`` — sherpa-onnx streaming (the reference's
    choice); full implementation, import-gated (not in this image);
  * ``make_transformers_recognizer`` — any HF ASR checkpoint (whisper,
    wav2vec2) through the local transformers install; gated on cached
    weights (this image has none and no egress);
  * ``make_morse_recognizer`` — a SELF-CONTAINED DSP decoder for morse
    audio (envelope detection, adaptive unit estimation, ITU code
    table).  No model files, fully testable offline — and in the
    amateur-radio spirit of the reference.  tests/test_torch_voice.py
    drives real synthesized PCM through the whole FIFO pipeline with it.
  * any custom callable ``recognize(audio) -> str`` with
    ``audio = (np.float32 pcm, sample_rate)``.

Run: python -m nano_tpu_torch.serve.asr --backend morse --audio-fifo /tmp/pcm
"""

from __future__ import annotations

import argparse
import errno
import os
import socket
import threading
import time
from typing import Callable, Optional, Tuple

import numpy as np

PTT_FIFO = "/tmp/ptt_fifo"
ASR_FIFO = "/tmp/asr_fifo"

Audio = Tuple[np.ndarray, int]          # (float32 mono pcm, sample rate)


# =====================================================================
# audio capture — accumulate PCM while PTT is held
# =====================================================================

def pcm16_to_float(data: bytes) -> np.ndarray:
    return np.frombuffer(data, "<i2").astype(np.float32) / 32768.0


def read_wav(path_or_bytes) -> Audio:
    """Minimal WAV reader (PCM16/PCM-float mono or stereo)."""
    import io
    import wave
    if not isinstance(path_or_bytes, bytes):
        with open(path_or_bytes, "rb") as fh:   # wave.open would not
            path_or_bytes = fh.read()           # close a caller's file
    f = io.BytesIO(path_or_bytes)
    with wave.open(f, "rb") as w:
        rate = w.getframerate()
        n = w.getnframes()
        raw = w.readframes(n)
        width = w.getsampwidth()
        ch = w.getnchannels()
    if width == 2:
        pcm = pcm16_to_float(raw)
    elif width == 4:
        pcm = np.frombuffer(raw, "<f4").astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    if ch > 1:
        pcm = pcm.reshape(-1, ch).mean(axis=1)
    return pcm, rate


class PcmCapture:
    """Base: start() begins accumulating PCM16 bytes, stop() returns the
    captured Audio.  Subclasses feed ``self._feed(bytes)``."""

    def __init__(self, rate: int = 16000):
        self.rate = rate
        self._chunks = []
        self._active = False
        self._lock = threading.Lock()

    def _feed(self, data: bytes) -> None:
        with self._lock:
            if self._active and data:
                self._chunks.append(data)

    def start(self) -> None:
        with self._lock:
            self._chunks = []
            self._active = True

    def stop(self) -> Audio:
        with self._lock:
            self._active = False
            raw = b"".join(self._chunks)
            self._chunks = []
        return pcm16_to_float(raw), self.rate


class FifoPcmCapture(PcmCapture):
    """Raw s16le PCM streamed into a fifo (e.g. from arecord/sox:
    ``arecord -f S16_LE -r 16000 -c 1 > /tmp/pcm_fifo``)."""

    def __init__(self, fifo_path: str, rate: int = 16000):
        super().__init__(rate)
        self.fifo_path = fifo_path
        try:
            os.mkfifo(fifo_path, 0o666)
        except OSError as e:
            if e.errno != errno.EEXIST:
                raise
        self._stop_evt = threading.Event()
        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._thread.start()

    def _pump(self) -> None:
        fd = os.open(self.fifo_path, os.O_RDWR)   # survives writer churn
        try:
            while not self._stop_evt.is_set():
                try:
                    data = os.read(fd, 65536)
                except OSError:
                    break
                if self._stop_evt.is_set():
                    break                  # close()'s wake byte is not
                if data:                   # audio — feeding it would
                    self._feed(data)       # leave an odd-length buffer
                else:
                    time.sleep(0.005)
        finally:
            os.close(fd)

    def close(self) -> None:
        self._stop_evt.set()
        try:
            fd = os.open(self.fifo_path, os.O_WRONLY | os.O_NONBLOCK)
            os.write(fd, b"\x00")
            os.close(fd)
        except OSError:
            pass
        self._thread.join(timeout=2)


class SocketPcmCapture(PcmCapture):
    """Raw s16le PCM over TCP (one client at a time) — lets a phone or a
    remote mic feed the recognizer."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8790,
                 rate: int = 16000):
        super().__init__(rate)
        self._srv = socket.create_server((host, port))
        self._srv.settimeout(0.5)
        self._stop_evt = threading.Event()
        self._thread = threading.Thread(target=self._accept, daemon=True)
        self._thread.start()
        self.port = self._srv.getsockname()[1]

    def _accept(self) -> None:
        while not self._stop_evt.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            with conn:
                conn.settimeout(0.5)
                while not self._stop_evt.is_set():
                    try:
                        data = conn.recv(65536)
                    except socket.timeout:
                        continue
                    except OSError:
                        break
                    if not data:
                        break
                    self._feed(data)

    def close(self) -> None:
        self._stop_evt.set()
        self._srv.close()
        self._thread.join(timeout=2)


# =====================================================================
# recognizer backends
# =====================================================================

def make_sherpa_recognizer(model_dir: str) -> Callable[[Audio], str]:
    """sherpa-onnx streaming recognizer over captured audio, configured
    like the reference server (asr_server.py:35-54: streaming paraformer
    encoder/decoder pair + tokens file).  Import-gated: the package is
    not in this image."""
    import sherpa_onnx  # noqa: F401  (gated)

    rec = sherpa_onnx.OnlineRecognizer.from_paraformer(
        tokens=os.path.join(model_dir, "tokens.txt"),
        encoder=os.path.join(model_dir, "encoder.onnx"),
        decoder=os.path.join(model_dir, "decoder.onnx"),
        enable_endpoint_detection=False,
    )

    def recognize(audio: Audio) -> str:
        pcm, rate = audio
        stream = rec.create_stream()
        stream.accept_waveform(rate, pcm)
        # flush with trailing silence so the last frames decode
        stream.accept_waveform(rate, np.zeros(int(rate * 0.5), np.float32))
        stream.input_finished()
        while rec.is_ready(stream):
            rec.decode_stream(stream)
        return rec.get_result(stream).strip()

    return recognize


def make_transformers_recognizer(model_id: str = "openai/whisper-tiny"
                                 ) -> Callable[[Audio], str]:
    """Local HF ASR checkpoint through transformers (CPU).  Gated on the
    weights being present in the local cache — this image ships the
    library but no checkpoints and has no egress."""
    from transformers import pipeline
    asr = pipeline("automatic-speech-recognition", model=model_id,
                   local_files_only=True)

    def recognize(audio: Audio) -> str:
        pcm, rate = audio
        out = asr({"raw": pcm, "sampling_rate": rate})
        return (out.get("text") or "").strip()

    return recognize


# ----------------------------- morse ---------------------------------

_MORSE = {
    ".-": "A", "-...": "B", "-.-.": "C", "-..": "D", ".": "E",
    "..-.": "F", "--.": "G", "....": "H", "..": "I", ".---": "J",
    "-.-": "K", ".-..": "L", "--": "M", "-.": "N", "---": "O",
    ".--.": "P", "--.-": "Q", ".-.": "R", "...": "S", "-": "T",
    "..-": "U", "...-": "V", ".--": "W", "-..-": "X", "-.--": "Y",
    "--..": "Z",
    "-----": "0", ".----": "1", "..---": "2", "...--": "3", "....-": "4",
    ".....": "5", "-....": "6", "--...": "7", "---..": "8", "----.": "9",
    ".-.-.-": ".", "--..--": ",", "..--..": "?", "-..-.": "/",
    "-...-": "=", ".-.-.": "+", "-....-": "-", ".--.-.": "@",
}

MORSE_TABLE = {v: k for k, v in _MORSE.items()}


def text_to_morse_pcm(text: str, rate: int = 8000, unit_ms: float = 60.0,
                      freq: float = 600.0, noise: float = 0.0,
                      seed: int = 0) -> np.ndarray:
    """Synthesize morse audio for `text` — the test signal generator
    (dot = 1 unit on, dash = 3; intra-char gap 1, inter-char 3, word 7)."""
    unit = int(rate * unit_ms / 1000.0)
    t = np.arange(unit, dtype=np.float32) / rate
    tone = np.sin(2 * np.pi * freq * t).astype(np.float32)
    off = np.zeros(unit, np.float32)
    parts = [off]
    for word in text.upper().split():
        for ci, ch in enumerate(word):
            code = MORSE_TABLE.get(ch)
            if code is None:
                continue
            if ci:
                parts.append(np.tile(off, 3))          # inter-char gap
            for si, sym in enumerate(code):
                if si:
                    parts.append(off)                  # intra-char gap
                parts.append(np.tile(tone, 1 if sym == "." else 3))
        parts.append(np.tile(off, 7))                  # word gap
    pcm = np.concatenate(parts)
    if noise > 0:
        pcm = pcm + np.random.RandomState(seed).randn(len(pcm)).astype(
            np.float32) * noise
    return np.clip(pcm, -1.0, 1.0)


def decode_morse_audio(pcm: np.ndarray, rate: int) -> str:
    """Decode on/off-keyed morse audio to text.

    DSP chain: 5 ms RMS envelope -> adaptive threshold (midpoint of the
    loud/quiet clusters) -> mark/space run lengths -> unit length from
    the shortest-mark cluster -> dot/dash + gap classification -> ITU
    table lookup.  Robust to moderate noise and unknown speed (WPM is
    estimated from the signal itself).
    """
    if len(pcm) < rate // 100:
        return ""
    frame = max(1, int(rate * 0.005))
    n = len(pcm) // frame
    env = np.sqrt(np.mean(
        pcm[:n * frame].astype(np.float32).reshape(n, frame) ** 2, axis=1))
    if n < 4 or env.max() <= 0:
        return ""
    # adaptive threshold: midpoint between quiet and loud cluster means
    lo, hi = np.percentile(env, [10, 90])
    thr = (lo + hi) / 2.0
    if hi < 1e-4 or hi < lo * 2 + 1e-9:
        return ""                        # no keying detected
    on = env > thr

    # run-length encode
    runs = []                            # (is_on, length_frames)
    cur, length = bool(on[0]), 0
    for v in on:
        if bool(v) == cur:
            length += 1
        else:
            runs.append((cur, length))
            cur, length = bool(v), 1
    runs.append((cur, length))
    if runs and not runs[0][0]:
        runs = runs[1:]                  # leading silence
    if runs and runs and not runs[-1][0]:
        runs = runs[:-1]                 # trailing silence
    marks = [l for v, l in runs if v]
    if not marks:
        return ""
    # unit length: marks are 1u (dots) or 3u (dashes).  When both are
    # present the distribution is bimodal — split at the midpoint and
    # average the short cluster.  When unimodal (e.g. "OK" is 5 dashes,
    # 1 dot won't split), fall back to the gaps: the shortest gaps are
    # intra-character, exactly 1u.
    m_min, m_max = min(marks), max(marks)
    if m_max >= 2.0 * m_min:
        mid = (m_min + m_max) / 2.0
        unit = float(np.mean([m for m in marks if m < mid]))
    else:
        gaps = [l for v, l in runs if not v]
        g_min = min(gaps) if gaps else m_min
        # marks ~ 1u if comparable to the shortest gap, else they are
        # dashes (3u)
        unit = float(m_min if m_min < 2.0 * g_min else m_min / 3.0)
    if unit <= 0:
        return ""

    out = []
    sym = ""
    for is_on, length in runs:
        u = length / unit
        if is_on:
            sym += "." if u < 2.0 else "-"
        else:
            if u >= 5.0:                 # word gap (7 units nominal)
                out.append(_MORSE.get(sym, "") if sym else "")
                out.append(" ")
                sym = ""
            elif u >= 2.0:               # char gap (3 units nominal)
                out.append(_MORSE.get(sym, "") if sym else "")
                sym = ""
    if sym:
        out.append(_MORSE.get(sym, ""))
    return "".join(out).strip()


def make_morse_recognizer() -> Callable[[Audio], str]:
    """Self-contained audio-to-text backend: decodes on/off-keyed morse.
    No model files needed; works on real captured PCM."""

    def recognize(audio: Audio) -> str:
        pcm, rate = audio
        return decode_morse_audio(pcm, rate)

    return recognize


# =====================================================================
# FIFO server (reference protocol)
# =====================================================================

class AsrFifoServer:
    """PTT-gated recognizer loop speaking the reference FIFO protocol.

    One byte on the PTT fifo starts (1) or stops (0) a capture; on stop,
    the captured audio runs through ``recognizer`` and the text is
    written UTF-8 to the ASR fifo (reference: infer/asr.c
    set_ptt_status / get_asr_result).  Without a ``capture``, the
    recognizer is called with no arguments (legacy/test mode).
    """

    def __init__(self, recognizer: Callable,
                 ptt_fifo: str = PTT_FIFO, asr_fifo: str = ASR_FIFO,
                 on_text: Optional[Callable[[str], None]] = None,
                 capture: Optional[PcmCapture] = None):
        self.recognizer = recognizer
        self.ptt_fifo = ptt_fifo
        self.asr_fifo = asr_fifo
        self.on_text = on_text
        self.capture = capture
        self.listening = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @staticmethod
    def _mkfifo(path: str) -> None:
        try:
            os.mkfifo(path, 0o666)
        except OSError as e:
            if e.errno != errno.EEXIST:
                raise

    def _emit(self, text: str) -> None:
        if self.on_text:
            self.on_text(text)
        # non-blocking write, dropped if no reader (like the C glue,
        # infer/asr.c:34-47)
        try:
            fd = os.open(self.asr_fifo, os.O_WRONLY | os.O_NONBLOCK)
        except OSError:
            return
        try:
            os.write(fd, text.encode("utf-8"))
        except OSError:
            pass
        finally:
            os.close(fd)

    def _recognize(self) -> str:
        if self.capture is not None:
            audio = self.capture.stop()
            return self.recognizer(audio)
        return self.recognizer()

    def _loop(self) -> None:
        self._mkfifo(self.ptt_fifo)
        self._mkfifo(self.asr_fifo)
        # blocking read open; O_RDWR so the fd survives writer churn
        fd = os.open(self.ptt_fifo, os.O_RDWR)
        try:
            while not self._stop.is_set():
                try:
                    data = os.read(fd, 1)
                except OSError:
                    break
                if not data:
                    time.sleep(0.01)
                    continue
                if self._stop.is_set():    # stop() wrote a wake byte
                    break
                if data[0] != 0:
                    # any nonzero byte = PTT pressed (the reference Pod
                    # writes 66, ui_app.c set_ptt_status; asr_client.py
                    # treats >0 as pressed — previously only ==1 worked)
                    self.listening = True
                    if self.capture is not None:
                        self.capture.start()
                elif self.listening:       # 0 = released
                    self.listening = False
                    try:
                        text = self._recognize()
                    except Exception as e:  # recognizer failure is not fatal
                        text = ""
                        if self.on_text:
                            self.on_text(f"[asr error: {e}]")
                    if text:
                        self._emit(text)
        finally:
            os.close(fd)

    def start(self) -> "AsrFifoServer":
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        # unblock the fifo read (value irrelevant: the loop checks the
        # stop flag before interpreting the byte)
        try:
            fd = os.open(self.ptt_fifo, os.O_WRONLY | os.O_NONBLOCK)
            os.write(fd, b"\x00")
            os.close(fd)
        except OSError:
            pass
        if self._thread:
            self._thread.join(timeout=5)


def main() -> None:  # pragma: no cover - interactive server
    ap = argparse.ArgumentParser(description="Nano ASR FIFO server")
    ap.add_argument("--backend", default="morse",
                    choices=["sherpa", "morse", "hf"],
                    help="recognizer: sherpa-onnx, DSP morse decoder, or "
                         "a local HF checkpoint")
    ap.add_argument("--model-dir", default="",
                    help="sherpa model dir / HF model id")
    ap.add_argument("--ptt-fifo", default=PTT_FIFO)
    ap.add_argument("--asr-fifo", default=ASR_FIFO)
    ap.add_argument("--audio-fifo", default="/tmp/pcm_fifo",
                    help="s16le PCM input fifo (arecord/sox writes here)")
    ap.add_argument("--audio-port", type=int, default=0,
                    help="TCP port for PCM input instead of the fifo")
    ap.add_argument("--rate", type=int, default=16000)
    args = ap.parse_args()

    if args.backend == "sherpa":
        rec = make_sherpa_recognizer(args.model_dir)
    elif args.backend == "hf":
        rec = make_transformers_recognizer(args.model_dir
                                           or "openai/whisper-tiny")
    else:
        rec = make_morse_recognizer()
    cap = (SocketPcmCapture(port=args.audio_port, rate=args.rate)
           if args.audio_port else
           FifoPcmCapture(args.audio_fifo, rate=args.rate))
    srv = AsrFifoServer(rec, args.ptt_fifo, args.asr_fifo,
                        capture=cap).start()
    print(f"ASR server [{args.backend}]: ptt={args.ptt_fifo} "
          f"asr={args.asr_fifo}")
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        srv.stop()
        if hasattr(cap, "close"):
            cap.close()


if __name__ == "__main__":
    main()
