"""Browser playback output: chunked WAV-over-HTTP streaming (copy of
``phonic_tpu/outputs/web.py``; standard library only).

Behavioural spec: reference src/output/web.rs — an emscripten/WebAudio
backend that pulls rendered samples into a ScriptProcessorNode.  A render
server has no wasm build to embed in, so this device inverts
the transport: the render pump PUSHES blocks into a bounded queue that a
tiny stdlib HTTP server streams to any browser as one endless 32-bit-float
WAV (`<audio src=...>` plays it natively; no client code needed).  The
served page also exposes play/pause, mirroring the reference's
suspend/resume-on-gesture behavior (web.rs:52-115) — autoplay policies make
the first gesture start the stream, exactly like WebAudio's resume.

Like the reference device, `write` blocks when the consumer stalls
(bounded queue = the ScriptProcessorNode's pull pacing), `pause`/`resume`
gate emission, and `sample_position` counts frames actually handed to a
client.
"""

from __future__ import annotations

import queue
import socket
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .base import OutputDevice

_PAGE = """<!doctype html>
<html><head><title>phonic_tpu_torch web output</title></head><body>
<h3>phonic_tpu_torch — live render stream</h3>
<audio controls autoplay src="/stream.wav"></audio>
<p>{rate} Hz, {channels} ch, float32 WAV stream</p>
<p><a href="/webaudio">WebAudio (AudioWorklet) client</a></p>
</body></html>"""

# True WebAudio client (reference: src/output/web.rs:52-115 pulls rendered
# samples into a ScriptProcessorNode and suspends/resumes on user gesture).
# The inversion keeps the DSP server-side; the browser runs an
# AudioWorkletProcessor fed from a fetch-stream of raw float32 frames, with
# ~2 s of client-side buffering as the pull pacing (reading pauses when
# ahead, which backs up the bounded server queue and paces the render pump
# exactly like the reference's pull callback).
_WEBAUDIO_PAGE = """<!doctype html>
<html><head><title>phonic_tpu_torch webaudio</title></head><body>
<h3>phonic_tpu_torch — WebAudio client</h3>
<button id="btn">start</button> <span id="st">suspended</span>
<script>
const RATE = {rate}, CH = {channels};
const WORKLET = `
class PhonicFeeder extends AudioWorkletProcessor {{
  constructor() {{
    super();
    this.chunks = [];       // Float32Array interleaved chunks
    this.off = 0;
    this.port.onmessage = (e) => this.chunks.push(e.data);
  }}
  process(inputs, outputs) {{
    const out = outputs[0];
    const n = out[0].length, ch = out.length;
    for (let i = 0; i < n; i++) {{
      if (!this.chunks.length) {{
        for (let c = 0; c < ch; c++) out[c][i] = 0;   // underrun: silence
        continue;
      }}
      const cur = this.chunks[0];
      for (let c = 0; c < ch; c++) out[c][i] = cur[this.off + c] || 0;
      this.off += ch;
      if (this.off >= cur.length) {{ this.chunks.shift(); this.off = 0; }}
    }}
    return true;
  }}
}}
registerProcessor('phonic-feeder', PhonicFeeder);
`;
let ctx = null, sentFrames = 0;
async function start() {{
  if (ctx) {{  // toggle suspend/resume on gesture (web.rs:52-115)
    if (ctx.state === 'running') {{ await ctx.suspend(); }}
    else {{ await ctx.resume(); }}
    document.getElementById('st').textContent = ctx.state;
    return;
  }}
  ctx = new AudioContext({{sampleRate: RATE}});
  const url = URL.createObjectURL(
      new Blob([WORKLET], {{type: 'application/javascript'}}));
  await ctx.audioWorklet.addModule(url);
  const node = new AudioWorkletNode(ctx, 'phonic-feeder',
      {{outputChannelCount: [CH], numberOfInputs: 0}});
  node.connect(ctx.destination);
  document.getElementById('st').textContent = ctx.state;
  const resp = await fetch('/stream.f32');
  const reader = resp.body.getReader();
  let carry = new Uint8Array(0);
  while (true) {{
    // pull pacing: stay <= ~2 s ahead of the playhead; while we wait, the
    // server's bounded queue fills and the render pump blocks
    while (sentFrames - ctx.currentTime * RATE > 2 * RATE) {{
      await new Promise(r => setTimeout(r, 100));
    }}
    const {{value, done}} = await reader.read();
    if (done) break;
    let buf = new Uint8Array(carry.length + value.length);
    buf.set(carry); buf.set(value, carry.length);
    const usable = buf.length - (buf.length % (4 * CH));
    if (usable) {{
      const f = new Float32Array(buf.buffer.slice(0, usable));
      node.port.postMessage(f, [f.buffer]);
      sentFrames += f.length / CH;
    }}
    carry = buf.slice(usable);
  }}
}}
document.getElementById('btn').addEventListener('click', start);
</script></body></html>"""


def _wav_stream_header(rate: int, channels: int) -> bytes:
    """A WAV header with a (near-)unbounded data size: browsers treat the
    oversize declaration as 'stream until the connection closes'."""
    data_len = 0x7FFF0000
    hdr = b"RIFF" + struct.pack("<I", 36 + data_len) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 3, channels, rate,
                                 rate * channels * 4, channels * 4, 32)
    hdr += b"data" + struct.pack("<I", data_len)
    return hdr


class WebOutput(OutputDevice):
    """Streams the render to http://<host>:<port>/ (page + /stream.wav)."""

    def __init__(self, sample_rate: int = 44100, channels: int = 2,
                 host: str = "127.0.0.1", port: int = 0,
                 queue_blocks: int = 8):
        self._rate = int(sample_rate)
        self._channels = int(channels)
        self._queue: "queue.Queue[bytes]" = queue.Queue(maxsize=queue_blocks)
        self._position = 0
        self._paused = threading.Event()
        self._closed = threading.Event()
        self._clients = 0
        self._lock = threading.Lock()
        out = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    body = _PAGE.format(rate=out._rate,
                                        channels=out._channels).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if self.path == "/webaudio":
                    body = _WEBAUDIO_PAGE.format(
                        rate=out._rate, channels=out._channels).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if self.path not in ("/stream.wav", "/stream.f32"):
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                if self.path == "/stream.wav":
                    self.send_header("Content-Type", "audio/wav")
                    self.send_header("Cache-Control", "no-store")
                    self.end_headers()
                    self.wfile.write(
                        _wav_stream_header(out._rate, out._channels))
                else:  # raw interleaved float32 frames for the worklet
                    self.send_header("Content-Type",
                                     "application/octet-stream")
                    self.send_header("Cache-Control", "no-store")
                    self.end_headers()
                with out._lock:
                    out._clients += 1
                try:
                    while not out._closed.is_set():
                        try:
                            chunk = out._queue.get(timeout=0.5)
                        except queue.Empty:
                            continue
                        self.wfile.write(chunk)
                        with out._lock:
                            out._position += len(chunk) // (4 * out._channels)
                except (BrokenPipeError, ConnectionResetError):
                    pass
                finally:
                    with out._lock:
                        out._clients -= 1

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="phonic_web_output")
        self._thread.start()

    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}/"

    @property
    def sample_rate(self) -> int:
        return self._rate

    @property
    def channel_count(self) -> int:
        return self._channels

    @property
    def sample_position(self) -> int:
        with self._lock:
            return self._position

    @property
    def client_count(self) -> int:
        with self._lock:
            return self._clients

    def write(self, block) -> None:
        if self._closed.is_set():
            return
        block = np.asarray(self._apply_volume(block), np.float32)
        inter = np.ascontiguousarray(block.T).tobytes()  # interleave
        while self._paused.is_set() and not self._closed.is_set():
            self._paused.wait(0.1)
        # bounded queue: blocks the pump when clients stall (or, with no
        # client yet, keeps only the freshest blocks so playback starts at
        # "now", like a live stream)
        while True:
            try:
                self._queue.put(inter, timeout=0.5)
                return
            except queue.Full:
                if self._closed.is_set():
                    return
                with self._lock:
                    idle = self._clients == 0
                if idle:  # drop the oldest to stay live
                    try:
                        self._queue.get_nowait()
                    except queue.Empty:
                        pass

    def pause(self) -> None:
        self._paused.set()

    def resume(self) -> None:
        self._paused.clear()

    def is_running(self) -> bool:
        # self._paused here is a threading.Event, not the base-class flag
        return not self._paused.is_set()

    def close(self) -> None:
        self._closed.set()
        self._server.shutdown()
        self._thread.join(timeout=5.0)
        self._server.server_close()
