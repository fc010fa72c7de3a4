"""The ASR server and the voice bridge of the port
(``nano_tpu_torch.serve.asr`` / ``voice_ws``) against the JAX package's
copies: ``text_to_morse_pcm`` arrays, ``decode_morse_audio`` text,
``read_wav`` and the TTS WAV bytes equal; the FIFO server round trip with
real PCM bytes through the capture fifo; the socket capture; the bridge's
protocol frame by frame against the JAX bridge's through in-process
connections, and once over a real WebSocket."""

import asyncio
import json
import os
import socket
import threading
import time

import numpy as np
import pytest

from nano_tpu.serve import asr as jasr
from nano_tpu.serve import voice_ws as jvoice
from nano_tpu_torch.serve import asr as tasr
from nano_tpu_torch.serve import voice_ws as tvoice
from tests.test_torch_serve import CLOSE, Conn

TEXTS = ("HELLO WORLD", "CQ CQ DE NANO TPU", "73 2M QRP", "SOS?")


@pytest.mark.parametrize("kw", [{}, {"noise": 0.1, "seed": 3},
                                {"unit_ms": 30.0, "rate": 16000},
                                {"unit_ms": 120.0, "freq": 800.0}])
def test_morse_pcm_and_decode_equal_jax(kw):
    for text in TEXTS:
        pcm = tasr.text_to_morse_pcm(text, **kw)
        np.testing.assert_array_equal(pcm, jasr.text_to_morse_pcm(text, **kw))
        rate = kw.get("rate", 8000)
        got = tasr.decode_morse_audio(pcm, rate)
        assert got == jasr.decode_morse_audio(pcm, rate)
        assert got == text
    silence = np.zeros(8000, np.float32)
    assert tasr.decode_morse_audio(silence, 8000) == ""


def test_tts_wav_bytes_and_read_wav_equal_jax():
    for text in TEXTS:
        audio = tvoice.make_morse_synthesizer()(text)
        wav = tvoice.audio_to_wav_bytes(audio)
        assert wav == jvoice.audio_to_wav_bytes(
            jvoice.make_morse_synthesizer()(text))
        pcm, rate = tasr.read_wav(wav)
        jpcm, jrate = jasr.read_wav(wav)
        np.testing.assert_array_equal(pcm, jpcm)
        assert rate == jrate == 16000
        assert tasr.decode_morse_audio(pcm, rate) == text
    raw = (np.arange(-300, 300, dtype=np.int16) * 100).tobytes()
    np.testing.assert_array_equal(tasr.pcm16_to_float(raw),
                                  jasr.pcm16_to_float(raw))


def _wait_for(paths):
    for _ in range(500):
        if all(os.path.exists(p) for p in paths):
            return
        time.sleep(0.01)
    raise TimeoutError(paths)


def test_fifo_server_round_trip(tmp_path):
    """Real s16le PCM streamed into the capture fifo while PTT is held,
    morse-decoded on release, the text written to the ASR fifo."""
    ptt = str(tmp_path / "ptt_fifo")
    out = str(tmp_path / "asr_fifo")
    pcm_fifo = str(tmp_path / "pcm_fifo")
    cap = tasr.FifoPcmCapture(pcm_fifo, rate=8000)
    texts = []
    srv = tasr.AsrFifoServer(tasr.make_morse_recognizer(), ptt_fifo=ptt,
                             asr_fifo=out, on_text=texts.append,
                             capture=cap).start()
    try:
        _wait_for([ptt, out])
        got = []

        def reader():
            fd = os.open(out, os.O_RDONLY)
            got.append(os.read(fd, 65536).decode("utf-8"))
            os.close(fd)
        t = threading.Thread(target=reader, daemon=True)
        t.start()
        time.sleep(0.05)
        pcm = tasr.text_to_morse_pcm("HELLO TPU", rate=8000, noise=0.05)
        pcm16 = (np.clip(pcm, -1, 1) * 32767).astype("<i2").tobytes()
        fd = os.open(ptt, os.O_WRONLY)
        os.write(fd, b"\x42")                 # any nonzero byte: PTT down
        time.sleep(0.05)
        wfd = os.open(pcm_fifo, os.O_WRONLY)
        for i in range(0, len(pcm16), 4096):
            os.write(wfd, pcm16[i:i + 4096])
        os.close(wfd)
        time.sleep(0.2)
        os.write(fd, b"\x00")                 # release -> recognize
        os.close(fd)
        t.join(timeout=10)
        assert texts == ["HELLO TPU"] and got == ["HELLO TPU"]
    finally:
        srv.stop()
        cap.close()


def test_fifo_server_recognizer_error_is_not_fatal(tmp_path):
    ptt = str(tmp_path / "ptt_fifo")
    calls, texts = [], []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            raise ValueError("boom")
        return "again"
    srv = tasr.AsrFifoServer(flaky, ptt_fifo=ptt,
                             asr_fifo=str(tmp_path / "asr_fifo"),
                             on_text=texts.append).start()
    try:
        _wait_for([ptt])
        fd = os.open(ptt, os.O_WRONLY)
        for b in (b"\x01", b"\x00", b"\x01", b"\x00"):
            os.write(fd, b)
            time.sleep(0.05)
        os.close(fd)
        for _ in range(200):
            if len(texts) == 2:
                break
            time.sleep(0.01)
        assert texts == ["[asr error: boom]", "again"]
    finally:
        srv.stop()


def test_socket_capture(tmp_path):
    cap = tasr.SocketPcmCapture(port=0, rate=8000)
    try:
        with socket.create_connection(("127.0.0.1", cap.port)) as c:
            time.sleep(0.05)
            c.sendall(b"\x00\x00" * 100)      # before start: dropped
            time.sleep(0.1)
            cap.start()
            pcm = tasr.text_to_morse_pcm("OK", rate=8000)
            c.sendall((np.clip(pcm, -1, 1) * 32767).astype("<i2").tobytes())
            time.sleep(0.3)
            audio, rate = cap.stop()
        assert rate == 8000 and tasr.decode_morse_audio(audio, rate) == "OK"
    finally:
        cap.close()


def _bridge_script():
    pcm = tasr.text_to_morse_pcm("CQ TPU", rate=8000, noise=0.05)
    pcm16 = (np.clip(pcm, -1, 1) * 32767).astype("<i2").tobytes()
    msgs = [json.dumps({"type": "start", "rate": 8000})]
    msgs += [pcm16[i:i + 4096] for i in range(0, len(pcm16), 4096)]
    msgs += [json.dumps({"type": "stop"}), pcm16[:4096],
             json.dumps({"type": "start", "rate": 8000}),
             json.dumps({"type": "stop"}),
             json.dumps({"type": "tts", "text": "73 DE NANO"}),
             json.dumps({"type": "bogus"}), "not json"]
    return msgs, 6       # replies: asr, asr, tts header + wav, 2 errors


class _Iterable(Conn):
    """A Conn the bridge iterates (``async for message in websocket``)."""

    def __aiter__(self):
        return self

    async def __anext__(self):
        try:
            return await self.recv()
        except ConnectionError:
            raise StopAsyncIteration


def test_voice_bridge_frames_equal_jax():
    msgs, n = _bridge_script()
    frames = []
    for mod, asr in ((jvoice, jasr), (tvoice, tasr)):
        async def go():
            conn = _Iterable()
            task = asyncio.create_task(
                mod.VoiceWSServer(asr.make_morse_recognizer()).handle(conn))
            for m in msgs:
                conn.inbox.put_nowait(m)
            await conn.wait_for(lambda f: len(f) >= n)
            conn.inbox.put_nowait(CLOSE)
            await asyncio.wait_for(task, 30)
            return conn.frames
        frames.append(asyncio.run(go()))
    assert frames[1] == frames[0]
    got = frames[1]
    assert json.loads(got[0]) == {"type": "asr", "text": "CQ TPU"}
    assert json.loads(got[1]) == {"type": "asr", "text": ""}
    assert json.loads(got[2]) == {"type": "tts_wav", "bytes": len(got[3])}
    audio, rate = tasr.read_wav(got[3])
    assert tasr.decode_morse_audio(audio, rate) == "73 DE NANO"
    assert [json.loads(f)["type"] for f in got[4:]] == ["error", "error"]


def test_voice_bridge_over_a_websocket():
    websockets = pytest.importorskip("websockets")
    srv = tvoice.VoiceWSServer(tasr.make_morse_recognizer())

    async def run():
        async with websockets.serve(srv.handle, "127.0.0.1", 0,
                                    max_size=2 ** 24) as s:
            port = list(s.sockets)[0].getsockname()[1]
            async with websockets.connect(f"ws://127.0.0.1:{port}",
                                          max_size=2 ** 24) as c:
                msgs, _ = _bridge_script()
                for m in msgs[:msgs.index(json.dumps({"type": "stop"})) + 1]:
                    await c.send(m)
                asr_reply = json.loads(await asyncio.wait_for(c.recv(), 30))
                await c.send(json.dumps({"type": "tts", "text": "OK"}))
                hdr = json.loads(await asyncio.wait_for(c.recv(), 30))
                wav = await asyncio.wait_for(c.recv(), 30)
                return asr_reply, hdr, wav

    asr_reply, hdr, wav = asyncio.run(run())
    assert asr_reply == {"type": "asr", "text": "CQ TPU"}
    assert hdr == {"type": "tts_wav", "bytes": len(wav)}
    audio, rate = tasr.read_wav(bytes(wav))
    assert tasr.decode_morse_audio(audio, rate) == "OK"
