"""``python -m nano_tpu_torch.infer`` (the port's counterpart of the root
infer.py) on the CPU: the one-shot text of tests/js/fixtures/tiny_q80.bin
equals the port's ``generate_sync`` and the root infer.py's; ``-o``
prints one top-6 line a decode step in both observing modes; ``--trace``
writes a Chrome trace; the loader chooses by extension (a GGUF file);
without ``--device cpu`` and without a card it exits non-zero with a clear
message."""

import json
import os
import subprocess
import sys

import pytest
import torch

from nano_tpu_torch import observe as tobs
from nano_tpu_torch.infer import __main__ as tinfer
from nano_tpu_torch.infer import engine as teng
from nano_tpu_torch.ops import sampling as tsamp
from tests.conftest import REPO_ROOT

Q80 = os.path.join(REPO_ROOT, "tests", "js", "fixtures", "tiny_q80.bin")
ARGS = ["-m", Q80, "-q", "hello", "-n", "8", "-t", "0", "-r", "1.0"]


def _expected_text(n=8):
    ctx = teng.LLMContext.from_bin(Q80, device="cpu",
                                   sampler=tsamp.SamplerConfig(
                                       temperature=0.0,
                                       repetition_penalty=1.0))
    parts = []
    teng.generate_sync(ctx, "hello", max_new_tokens=n,
                       on_decoding=lambda s, t, text: parts.append(text))
    return "".join(parts)


def test_one_shot_equals_generate_sync_and_the_root_cli(capsys, monkeypatch):
    assert tinfer.main(ARGS + ["--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    want = _expected_text()
    assert out == want + "\n" and want
    assert "loaded" in err and "on cpu" in err
    import infer as jinfer                  # the root infer.py (JAX)
    monkeypatch.setattr(sys, "argv", ["infer.py"] + ARGS)
    jinfer.main()
    jout, _ = capsys.readouterr()
    assert jout == out


@pytest.mark.parametrize("summary", [False, True])
def test_observe_prints_a_top6_line_a_step(capsys, monkeypatch, summary):
    monkeypatch.setattr(tobs, "_FORCE_FALLBACK", summary)
    assert tinfer.main(ARGS + ["--device", "cpu", "-o"]) == 0
    out, err = capsys.readouterr()
    lines = [ln for ln in err.splitlines() if "top6:" in ln]
    assert len(lines) == 7                  # 8 tokens: 7 decode steps
    assert all(ln.startswith("[layers ") and ln.count(":") >= 7
               for ln in lines)
    assert out == _expected_text() + "\n"


def test_trace_writes_a_chrome_trace(tmp_path, capsys):
    d = str(tmp_path / "tr")
    assert tinfer.main(ARGS + ["--device", "cpu", "--trace", d, "-p"]) == 0
    _, err = capsys.readouterr()
    assert f"[trace written to {d}]" in err and "tok/s" in err
    with open(os.path.join(d, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "infer" in names


def test_loader_chooses_by_extension(tmp_path, capsys):
    from tests.test_torch_gateway import _write_gguf
    path = _write_gguf(str(tmp_path / "m.gguf"), "q8_0")
    assert tinfer.main(["-m", path, "-q", "ab", "-n", "4", "-t", "0",
                        "--device", "cpu"]) == 0
    _, err = capsys.readouterr()
    assert "loaded" in err and "vocab=256" in err


def test_without_a_card_it_refuses(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tinfer.main(ARGS) == 2
    out, err = capsys.readouterr()
    assert out == "" and "CUDA" in err and "device='cpu'" in err


def test_python_dash_m_entry_point():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-m", "nano_tpu_torch.infer"] + ARGS
                       + ["--device", "cpu"], cwd=REPO_ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout == _expected_text() + "\n"
    if not torch.cuda.is_available():
        r = subprocess.run([sys.executable, "-m", "nano_tpu_torch.infer"]
                           + ARGS, cwd=REPO_ROOT, env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0 and "CUDA" in r.stderr
