"""Web demo server (reference `app.py` + `app/`; the port's counterpart of
the JAX package's `apps/server.py`).

    python -m tts_arabic_torch.apps.server --port 8000
    python -m tts_arabic_torch.apps.server --device cpu --no-warmup

Endpoints (reference app.py:16-43, plus streaming):
- GET  /            : demo page (textarea, rate/denoise sliders)
- POST /api/tts     : JSON {"buckw": str, "rate": float, "denoise": float}
                      -> synthesizes with every model in the registry,
                      writes static/wave{i}.wav, returns their URLs
- POST /api/tts/stream : the same JSON (+ "format": "s16le" | "mulaw") ->
                      chunked raw PCM from the first registry model, one
                      HTTP chunk per vocoded window (X-Audio-Format,
                      X-Sample-Rate and X-Model headers). A Tacotron2 model
                      streams at its own speed: a "rate" other than 1 is a
                      400 (its `stream()` has no speed)
- GET  /static/...  : generated audio

The registry (`app_models.yaml`) lists the models to serve: name, type
(fastpitch or tacotron2, each with HiFi-GAN), optional checkpoint (a
reference `.pth`, or a `states.ckpt` of `apps.train_fastpitch`),
vocoder_sd / vocoder_config, quantize (int8: the static-calibrated int8
path, calibrated at load) and, for the port, compute_dtype (bfloat16 or
float32, default float32). The models run on the CUDA card unless
`--device cpu` is given.
Before it serves, the server runs `TTSManager.warmup()`: each pipeline's
own `warmup()` (FastPitch: its bucket grid and the one-row encode and
decoder graphs; Tacotron2: the decode-block graphs at batch 1 and text
buckets 16 and 32), which builds the kernels and meets the serving shapes
once. Built on stdlib http.server; the Arabic <-> Buckwalter mapping of
the page runs in the browser, from the same tables as the Python
frontend.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import itertools
import json
import pathlib
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..audio import peak_normalize, save_wav
from ..infer.pipeline import MEL_BUCKETS
from ..runtime.config import parse_yaml
from ..text.buckwalter import _ARABIC, _BUCKWALTER

_STATIC = pathlib.Path(__file__).parent / "static"
_TYPES = ("fastpitch", "tacotron2")
_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16}
WARMUP_TEXT = "m a r H a b a n b i k u m"

_INDEX = """<!doctype html><html><head><meta charset="utf-8">
<title>Arabic TTS (PyTorch/CUDA)</title><style>
body {{ font-family: system-ui; max-width: 760px; margin: 2em auto; }}
textarea {{ width: 100%; height: 5em; font-size: 1.2em; direction: rtl; }}
.row {{ margin: 0.6em 0; }} audio {{ width: 100%; }}
.model {{ color: #666; font-size: 0.9em; }}
</style></head><body>
<h1>Arabic TTS <small>(PyTorch/CUDA)</small></h1>
<textarea id="text">{default_text}</textarea>
<div class="row">rate <input id="rate" type="range" min="0.5" max="2" step="0.05" value="1">
denoise <input id="denoise" type="range" min="0" max="0.02" step="0.001" value="0.005">
<button id="go">synthesize</button> <span id="status"></span></div>
<div id="out"></div>
<script>
const AR = {arabic_json}; const BW = {buckw_json};
const a2b = {{}}; const b2a = {{}};
for (let i = 0; i < AR.length; i++) {{ a2b[AR[i]] = BW[i]; b2a[BW[i]] = AR[i]; }}
function arabicToBuckw(s) {{ return [...s].map(c => a2b[c] ?? c).join(''); }}
document.getElementById('go').onclick = async () => {{
  const status = document.getElementById('status');
  status.textContent = 'synthesizing...';
  const body = {{ buckw: arabicToBuckw(document.getElementById('text').value),
                 rate: +document.getElementById('rate').value,
                 denoise: +document.getElementById('denoise').value }};
  const r = await fetch('/api/tts', {{method: 'POST',
      headers: {{'Content-Type': 'application/json'}},
      body: JSON.stringify(body)}});
  const data = await r.json();
  const out = document.getElementById('out'); out.innerHTML = '';
  for (const w of data.waves) {{
    out.insertAdjacentHTML('beforeend',
      `<div class="row"><span class="model">${{w.model}}</span>` +
      `<audio controls autoplay src="${{w.url}}?t=${{Date.now()}}"></audio></div>`);
  }}
  status.textContent = '';
}};
</script></body></html>"""


class BadRequest(ValueError):
    """A request the models cannot serve as asked: answered with a 400."""


class TTSManager:
    """Loads every registered model and synthesizes with each per request
    (reference `TTSManager`, utils/app_utils.py:59-84). All models stay
    resident on the device.

    Every synthesis, the warm-up's included, runs on one worker thread of
    the manager: cuDNN keeps its execution plans per thread, so on a fresh
    request thread of the ThreadingHTTPServer each convolution would be
    planned again, request after request."""

    def __init__(self, registry=None, device=None):
        self.models = []
        registry = registry or [{"name": "fastpitch", "type": "fastpitch"}]
        for item in registry:
            self.models.append((item["name"], self._load(item, device)))
        self._worker = concurrent.futures.ThreadPoolExecutor(max_workers=1)

    def _on_worker(self, fn, *args):
        return self._worker.submit(fn, *args).result()

    @staticmethod
    def _load(item, device):
        kind = item.get("type", "fastpitch")
        if kind not in _TYPES:
            raise ValueError(f"model type {kind!r}: one of {_TYPES}")
        dtype = item.get("compute_dtype")
        if dtype not in _DTYPES:
            raise ValueError(f"compute_dtype {dtype!r}: bfloat16 or float32")
        kwargs = dict(arabic_in=False, compute_dtype=_DTYPES[dtype],
                      quantize=item.get("quantize"), device=device)
        if item.get("checkpoint"):
            kwargs["model_sd_path"] = item["checkpoint"]
        if item.get("vocoder_sd"):
            kwargs["vocoder_sd"] = item["vocoder_sd"]
            kwargs["vocoder_config"] = item.get("vocoder_config")
        from ..infer import FastPitch2Wave, Tacotron2Wave
        return (FastPitch2Wave if kind == "fastpitch"
                else Tacotron2Wave)(**kwargs)

    def warmup(self) -> float:
        """Meet the serving shapes once before the first request, so none
        pays the kernel build, a cuDNN algorithm search or a CUDA graph
        capture: each pipeline's own `warmup()` (FastPitch: its bucket grid
        and its one-row encode and decoder graphs; Tacotron2: its
        decode-block graphs and one fused call per text bucket), then one
        request through /api/tts's path and one through the stream's.
        Returns the wall seconds spent."""
        t0 = time.perf_counter()
        self._on_worker(self._warmup)
        return time.perf_counter() - t0

    def _warmup(self):
        from ..infer import FastPitch2Wave
        for _, model in self.models:
            if isinstance(model, FastPitch2Wave):
                model.warmup(batch_sizes=(1,), text_buckets=(16,),
                             mel_buckets=MEL_BUCKETS)
            else:       # Tacotron2Wave: its decode-block graphs
                model.warmup(batch_sizes=(1,), text_buckets=(16, 32))
        self._tts(WARMUP_TEXT)
        for _ in self._stream(self.models[0][1], WARMUP_TEXT):
            pass

    def tts(self, buckw: str, rate: float = 1.0, denoise: float = 0.005):
        return self._on_worker(self._tts, buckw, rate, denoise)

    def _tts(self, buckw, rate=1.0, denoise=0.005):
        _STATIC.mkdir(parents=True, exist_ok=True)
        outputs = []
        for i, (name, model) in enumerate(self.models):
            wave = model.tts(buckw, speed=rate, denoise=denoise)
            wave = peak_normalize(np.asarray(wave), 0.99)
            fname = f"wave{i}.wav"
            save_wav(_STATIC / fname, wave, model.sample_rate)
            outputs.append({"model": name, "url": f"/static/{fname}"})
        return outputs

    def stream(self, buckw: str, rate: float = 1.0, denoise: float = 0.005,
               fmt: str = "s16le"):
        """Chunked synthesis with the FIRST registry model: yields PCM byte
        chunks as each window is vocoded (pipeline `.stream()`). fmt:
        "s16le" (native int16) or "mulaw" (uint8 G.711-style codes).
        Returns (name, sample_rate, generator)."""
        from ..infer import Tacotron2Wave
        if fmt not in ("s16le", "mulaw"):
            raise ValueError(f"unknown stream format {fmt!r}")
        name, model = self.models[0]
        if isinstance(model, Tacotron2Wave) and rate != 1.0:
            raise BadRequest(
                f"rate {rate}: the stream's first model, {name!r}, is a "
                "tacotron2 model, whose stream() has no speed; send rate "
                "1.0, or /api/tts for another rate")
        gen = self._stream(model, buckw, rate, denoise, fmt)
        chunks = iter(lambda: self._on_worker(next, gen, None), None)
        return name, model.sample_rate, chunks

    @staticmethod
    def _stream(model, buckw, rate=1.0, denoise=0.005, fmt="s16le"):
        from ..infer import Tacotron2Wave
        kw = dict(denoise=denoise,
                  out_int16="mulaw" if fmt == "mulaw" else True)
        if not isinstance(model, Tacotron2Wave):
            kw["speed"] = rate
        for chunk in model.stream(buckw, **kw):
            yield np.asarray(chunk).tobytes()


def make_handler(manager: TTSManager):
    lock = threading.Lock()
    index_html = _INDEX.format(
        default_text="مَرحَباً بِكُم",
        arabic_json=json.dumps(list(_ARABIC), ensure_ascii=False),
        buckw_json=json.dumps(list(_BUCKWALTER)),
    ).encode()

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # required for chunked streaming

        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/" or self.path.startswith("/index"):
                return self._send(200, index_html, "text/html; charset=utf-8")
            if self.path.startswith("/static/"):
                name = pathlib.Path(self.path.split("?")[0]).name
                f = _STATIC / name
                if f.exists():
                    return self._send(200, f.read_bytes(), "audio/wav")
            return self._send(404, b'{"error": "not found"}')

        def do_POST(self):
            if self.path == "/api/tts/stream":
                return self._stream_post()
            if self.path != "/api/tts":
                return self._send(404, b'{"error": "not found"}')
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                with lock:
                    waves = manager.tts(req.get("buckw", ""),
                                        float(req.get("rate", 1.0)),
                                        float(req.get("denoise", 0.005)))
                body = json.dumps({"waves": waves}).encode()
                return self._send(200, body)
            except BadRequest as e:
                return self._send(400, json.dumps(
                    {"error": str(e)}).encode())
            except Exception as e:  # surface errors to the client
                return self._send(500, json.dumps(
                    {"error": str(e)}).encode())

        def _stream_post(self):
            """POST /api/tts/stream: chunked raw int16 PCM (audio/L16),
            one HTTP chunk per vocoded window — first audio after one
            chunk's latency instead of the full synthesis. The first chunk
            is computed BEFORE headers go out so synthesis errors still
            surface as a 500."""
            headers_sent = False
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                fmt = req.get("format", "s16le")
                with lock:
                    name, sr, gen = manager.stream(
                        req.get("buckw", ""), float(req.get("rate", 1.0)),
                        float(req.get("denoise", 0.005)), fmt)
                    first = next(gen, b"")
                    self.send_response(200)
                    # raw NATIVE-endian s16 frames (audio/L16 would imply
                    # big-endian per RFC 2586); format spelled out in
                    # headers for generic clients
                    self.send_header("Content-Type",
                                     "application/octet-stream")
                    self.send_header("X-Audio-Format", fmt)
                    self.send_header("X-Sample-Rate", str(sr))
                    self.send_header("X-Model", name)
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    headers_sent = True
                    for chunk in itertools.chain([first], gen):
                        if chunk:
                            self.wfile.write(
                                f"{len(chunk):X}\r\n".encode()
                                + chunk + b"\r\n")
                            self.wfile.flush()
                    self.wfile.write(b"0\r\n\r\n")
            except BadRequest as e:
                return self._send(400, json.dumps(
                    {"error": str(e)}).encode())
            except Exception as e:
                if headers_sent:
                    # mid-stream failure: a second response would corrupt
                    # the chunked protocol — drop the connection so the
                    # client sees a truncated stream, not silent success
                    self.close_connection = True
                    return
                return self._send(500, json.dumps(
                    {"error": str(e)}).encode())

        def log_message(self, fmt, *args):
            pass

    return Handler


def load_registry(path):
    """The model registry (a YAML list of flat mappings), read by the
    port's own YAML reader; None when the file does not exist."""
    p = pathlib.Path(path)
    if not p.exists():
        return None
    return parse_yaml(p.read_text(encoding="utf-8"))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--models", default="app_models.yaml",
                        help="YAML registry of models to serve")
    parser.add_argument("--no-warmup", action="store_true",
                        help="skip the warm-up (the first request then "
                             "pays the kernel build)")
    parser.add_argument("--device", default=None,
                        help="torch device; default the CUDA card")
    args = parser.parse_args(argv)

    manager = TTSManager(load_registry(args.models), device=args.device)
    if not args.no_warmup:
        print("warming up (kernel build, serving shapes)...")
        dt = manager.warmup()
        print(f"warmup finished in {dt:.1f}s")
    server = ThreadingHTTPServer((args.host, args.port),
                                 make_handler(manager))
    print(f"serving on http://{args.host}:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
