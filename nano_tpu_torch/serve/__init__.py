"""Serving: continuous batching (``serve.batching.BatchedEngine``), the
port of ``nano_tpu/serve/batching.py``.  The frontends (WebSocket, OpenAI
HTTP, gateway) are not ported yet."""
