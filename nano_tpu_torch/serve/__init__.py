"""Serving, the port of ``nano_tpu/serve``: continuous batching
(``batching.BatchedEngine``) and the frontends over it — the WebSocket
server (``wss``), the OpenAI-compatible HTTP server (``openai_http``), the
model gateway (``gateway``: GGUF on this package's engine, transformers,
llama.cpp), the voice bridge (``voice_ws``) and the ASR FIFO server
(``asr``); ``cli`` holds the engine flags the servers share."""
