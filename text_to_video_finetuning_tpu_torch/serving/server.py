"""HTTP serving with dynamic batching over a warm pipeline (port of
text_to_video_finetuning_tpu/serving/server.py).

- `BatchingWorker`: one consumer thread that takes pending requests from a
  queue, coalesces up to `max_batch` of them that share a batch key
  (`request_batch_key`: geometry, steps, guidance, negative prompt, ...)
  within a `batch_window_ms` gather window, runs the injected
  `run_batch(requests)` and settles each request.  It is model-free, so its
  semantics are tested with a fake `run_batch`.
- `T2VServer`: loads the pipeline once, wires the worker to
  `pipelines.inference.generate` and fronts it with a stdlib
  ThreadingHTTPServer: POST /generate, GET /healthz, GET /stats.

Where the JAX server differs, and why:
- No warm-signature bookkeeping (`request_compile_key`, `note_warm`,
  `trim_to_warm`): it modelled XLA's one compiled program per (geometry,
  steps, batch) signature.  Eager PyTorch compiles nothing per shape, so
  every batch size is as ready as any other.
- One stage (gather, run, settle), not the JAX worker's dispatch/finisher
  pipeline: `generate` enqueues the whole denoise loop before it returns,
  so the card's idle time is inside the loop, in the gaps where the host
  enqueues (a batch of one kept an H100 85 % busy, chip_smoke.py phase
  19), and a dispatch-ahead stage, enqueued by the same host thread,
  cannot fill them.  Between batches the worker only copies the video to
  the host; handler threads write the mp4.
- On shutdown every request left in the queue or the backlog is settled at
  once with a "server shutting down" error, and later submissions are
  refused, so no waiter is stranded (the JAX worker returned on its stop
  sentinel with them unsettled).
- All model work (generation, the LaMa post-process, warm-up) runs on the
  worker thread; HTTP handler threads only parse, wait, write the mp4 and
  answer.

On a mesh (`mesh`, one process per rank under torchrun) rank 0 runs the
HTTP front end and the worker; before each batch, warm-ups included, it
broadcasts the batch's requests (`broadcast_batch`), and every other
rank runs the same batch body in its follower loop (`follow_batches`):
the JAX server is one process driving every chip.  A batch that fails on
any rank ends the server on every rank with a non-zero exit: the others
would wait in a collective for it (`T2VServer.failed`).  On shutdown rank
0 broadcasts a stop, and every rank leaves the group.

Determinism: a request's `seed` is reproduced exactly when it runs alone.
A coalesced batch samples from its first request's seed (each row still
gets its own noise), with a `torch.Generator` on the pipeline's device;
`no_batch: true` asks for exact reproduction.  Each response reports
`coalesced` and `seed_used`.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
import queue
import threading
import time
import traceback
import uuid
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch


@dataclass
class GenerationRequest:
    """One sampling request.  Defaults are the inference CLI's
    (cli.py::build_inference_parser)."""
    prompt: str
    negative_prompt: Optional[str] = None
    width: int = 256
    height: int = 256
    num_frames: int = 16
    window_size: Optional[int] = None
    num_steps: int = 25
    guidance_scale: float = 25.0
    vae_batch_size: int = 8
    seed: Optional[int] = None
    fps: int = 12
    loop: bool = False
    no_batch: bool = False      # opt out of coalescing (exact seed repro)
    init_video_base64: Optional[str] = None   # img2img: base64 mp4
    init_weight: float = 0.5
    remove_watermark: bool = False             # LaMa inpaint post-process

    def resolved_window(self) -> int:
        return self.window_size or self.num_frames

    def runs_alone(self) -> bool:
        """An init-video request carries its own pixels, so it never shares
        a batch; nor does an explicit no_batch."""
        return self.no_batch or self.init_video_base64 is not None


def request_batch_key(req: GenerationRequest):
    """What must be equal for two requests to share one `generate` call:
    the latent shape and window, the step count, the batch-wide guidance
    and negative prompt, the rotation schedule and the decode chunking."""
    return (req.width, req.height, req.num_frames, req.resolved_window(),
            req.num_steps, float(req.guidance_scale),
            req.negative_prompt or "", req.loop, req.vae_batch_size,
            req.runs_alone())


@dataclass
class _Pending:
    request: GenerationRequest
    done: threading.Event = field(default_factory=threading.Event)
    frames: Optional[np.ndarray] = None     # (F, H, W, C) uint8
    error: Optional[str] = None
    # set when the batch runs: how many requests shared it, and the seed it
    # sampled from (the first request's)
    coalesced: int = 1
    head_seed: Optional[int] = None


@dataclass
class _Call:
    """A function to run on the worker thread between batches."""
    fn: Callable[[], Any]
    done: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: Optional[BaseException] = None


class ServerOverloaded(Exception):
    """The server is full (max_queue), draining or shutting down (HTTP
    503)."""


SHUTTING_DOWN = "server shutting down"
_STOP = object()


class BatchingWorker:
    """Single-consumer dynamic batcher.

    `run_batch(requests) -> list` receives 1..max_batch requests with equal
    batch keys and returns one result per request, in order.  Requests whose
    key differs from the batch being gathered wait in a backlog for the
    next cycle (FIFO across cycles).

    `max_queue` bounds the requests accepted and not yet settled (queued,
    gathering or running); `submit` past it raises ServerOverloaded, which
    the HTTP front end answers with 503.  None = unbounded."""

    def __init__(self, run_batch: Callable[[List[GenerationRequest]], list],
                 max_batch: int = 4, batch_window_ms: float = 50.0,
                 max_queue: Optional[int] = None):
        self.run_batch = run_batch
        self.max_batch = max(1, int(max_batch))
        self.batch_window_s = max(0.0, batch_window_ms) / 1e3
        self.max_queue = int(max_queue) if max_queue else None
        self._queue: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._backlog: list = []        # key-mismatched items, FIFO (lock)
        self._inflight = 0              # accepted, not yet settled (lock)
        self._draining = False          # see begin_drain() (lock)
        self._stopped = False           # see shutdown() (lock)
        self.stats = {"requests": 0, "batches": 0, "errors": 0,
                      "rejected": 0, "max_batch_seen": 0,
                      "generate_seconds": 0.0}
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="t2v-batching-worker")
        self._thread.start()

    def submit(self, request: GenerationRequest) -> _Pending:
        with self._lock:
            if self._stopped or self._draining:
                # checked under the lock shutdown() and begin_drain() take,
                # so no request joins the queue behind the stop
                self.stats["rejected"] += 1
                raise ServerOverloaded(
                    f"{SHUTTING_DOWN}; retry another replica"
                    if self._stopped else
                    "server is draining for shutdown; retry another replica")
            if (self.max_queue is not None
                    and self._inflight >= self.max_queue):
                self.stats["rejected"] += 1
                raise ServerOverloaded(
                    f"{self._inflight} requests in flight (max_queue="
                    f"{self.max_queue}); retry later or raise --max-queue")
            self._inflight += 1
            pending = _Pending(request=request)
            self._queue.put(pending)
        return pending

    def call(self, fn: Callable[[], Any]) -> Any:
        """Run `fn()` on the worker thread, between batches, and return its
        result (or raise its exception).  Not counted in the stats."""
        job = _Call(fn)
        with self._lock:
            if self._stopped:
                raise RuntimeError(SHUTTING_DOWN)
            self._queue.put(job)
        job.done.wait()
        if job.error is not None:
            raise job.error
        return job.result

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self.stats, queue_depth=self._inflight)

    def begin_drain(self):
        """Stop accepting new submissions (see submit())."""
        with self._lock:
            self._draining = True

    def shutdown(self, timeout: Optional[float] = 10.0):
        """Refuse new work, settle every request still queued or in the
        backlog with a "server shutting down" error at once, then stop the
        thread after the batch it may be running (waiting for it at most
        `timeout` seconds; None: until it ends)."""
        with self._lock:
            self._stopped = True
            left = self._take_all()
            self._queue.put(_STOP)
        self._abandon(left)
        self._thread.join(timeout=timeout)

    # -- internals ---------------------------------------------------------

    def _take_all(self) -> list:
        """Everything in the backlog and the queue (the caller holds the
        lock)."""
        left, self._backlog = self._backlog, []
        while True:
            try:
                left.append(self._queue.get_nowait())
            except queue.Empty:
                return left

    def _take(self, timeout: Optional[float]):
        """Backlog first (FIFO fairness), then the queue; None on timeout."""
        with self._lock:
            if self._backlog:
                return self._backlog.pop(0)
        try:
            return self._queue.get(timeout=timeout)
        except queue.Empty:
            return None

    def _has_work(self) -> bool:
        with self._lock:
            return bool(self._backlog) or not self._queue.empty()

    def _gather(self, first: _Pending) -> List[_Pending]:
        batch = [first]
        key = request_batch_key(first.request)
        if first.request.runs_alone() or self.max_batch == 1:
            return batch
        deadline = time.monotonic() + self.batch_window_s
        skipped = []
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0 and not self._has_work():
                break
            item = self._take(max(0.0, remaining))
            if item is None:
                break
            if item is _STOP:
                self._queue.put(_STOP)      # the loop sees it next cycle
                break
            if (isinstance(item, _Pending)
                    and not item.request.runs_alone()
                    and request_batch_key(item.request) == key):
                batch.append(item)
            else:
                skipped.append(item)
        with self._lock:
            self._backlog = skipped + self._backlog
        return batch

    def _is_stopped(self) -> bool:
        with self._lock:
            return self._stopped

    def _loop(self):
        while True:
            item = self._take(None)
            if item is _STOP:
                break
            if self._is_stopped():
                self._abandon([item])
                continue
            if isinstance(item, _Call):
                self._run_call(item)
                continue
            batch = self._gather(item)
            if self._is_stopped():
                self._abandon(batch)
                continue
            self._run(batch)
        with self._lock:
            left = self._take_all()
        self._abandon(left)

    @staticmethod
    def _run_call(job: _Call):
        try:
            job.result = job.fn()
        except Exception as exc:  # noqa: BLE001 -- re-raised by call()
            job.error = exc
        job.done.set()

    def _run(self, batch: List[_Pending]):
        for pending in batch:
            pending.coalesced = len(batch)
            pending.head_seed = batch[0].request.seed
        t0 = time.monotonic()
        error = None
        try:
            results = self.run_batch([p.request for p in batch])
            if len(results) != len(batch):
                raise RuntimeError(
                    f"run_batch returned {len(results)} results for "
                    f"{len(batch)} requests")
            for pending, frames in zip(batch, results):
                pending.frames = frames
        except Exception as exc:  # noqa: BLE001 -- reported per request
            traceback.print_exc()
            error = f"{type(exc).__name__}: {exc}"
        with self._lock:
            self.stats["requests"] += len(batch)
            self.stats["batches"] += 1
            self.stats["max_batch_seen"] = max(self.stats["max_batch_seen"],
                                               len(batch))
            self.stats["generate_seconds"] += time.monotonic() - t0
            if error:
                self.stats["errors"] += len(batch)
            self._inflight -= len(batch)
        for pending in batch:
            pending.error = error
            pending.done.set()

    def _abandon(self, items: list):
        """Settle queued requests and calls that will not run."""
        pendings = [p for p in items if isinstance(p, _Pending)]
        with self._lock:
            self.stats["errors"] += len(pendings)
            self._inflight -= len(pendings)
        for item in items:
            if isinstance(item, _Call):
                item.error = RuntimeError(SHUTTING_DOWN)
            elif isinstance(item, _Pending):
                item.error = SHUTTING_DOWN
            else:
                continue
            item.done.set()


def _to_host(video) -> np.ndarray:
    if isinstance(video, torch.Tensor):
        return video.detach().float().cpu().numpy()
    return np.asarray(video, np.float32)


def postprocess(video, remove_watermark: bool,
                device="cuda") -> np.ndarray:
    """(C, F, H, W) in [-1, 1] -> (F, H, W, C) uint8, through the LaMa
    watermark inpaint on `device` when asked (the inference CLI's
    post-process)."""
    video = _to_host(video)
    if remove_watermark:
        from ..models.lama import inpaint_watermark
        frames = (np.transpose(video, (1, 0, 2, 3)) + 1.0) / 2.0
        frames = inpaint_watermark(frames, device=device)
        frames = np.clip(np.transpose(frames, (0, 2, 3, 1)), 0, 1) * 255
        return frames.astype(np.uint8)
    frames = np.transpose(np.clip(video, -1, 1), (1, 2, 3, 0))
    return ((frames + 1.0) * 127.5).astype(np.uint8)


def run_requests(pipe, requests: List[GenerationRequest], device,
                 generate=None) -> List[np.ndarray]:
    """One `generate` for a batch of requests with equal batch keys, then
    each request's post-process: uint8 frames on the host.  The batch body
    of the server's worker and of a mesh's follower ranks."""
    if generate is None:
        from ..pipelines.inference import generate
    head = requests[0]
    prompts = [r.prompt for r in requests]
    negative = ([head.negative_prompt] * len(requests)
                if head.negative_prompt else None)
    seed = head.seed if head.seed is not None else 0
    init_video, init_weight = None, 0.0
    if head.init_video_base64:                           # runs_alone(): B=1
        import tempfile
        from ..pipelines.inference import load_init_video
        with tempfile.NamedTemporaryFile(suffix=".mp4") as f:
            f.write(base64.b64decode(head.init_video_base64))
            f.flush()
            init_video = load_init_video(f.name, head.height, head.width,
                                         head.num_frames)
        init_weight = head.init_weight
    videos = generate(
        pipe, prompts, negative_prompt=negative, width=head.width,
        height=head.height, num_frames=head.num_frames,
        window_size=head.resolved_window(),
        vae_batch_size=head.vae_batch_size, num_steps=head.num_steps,
        guidance_scale=head.guidance_scale, init_video=init_video,
        init_weight=init_weight, loop=head.loop, seed=seed)
    return [postprocess(video, r.remove_watermark, device)
            for video, r in zip(videos, requests)]


def broadcast_batch(requests: Optional[List[GenerationRequest]]):
    """Rank 0's side of serving on a mesh: a batch's requests go to the
    other ranks (`broadcast_object_list` over the world) before rank 0 runs
    it; None ends their `follow_batches` loops."""
    import torch.distributed as dist
    dist.broadcast_object_list(
        [None if requests is None
         else [dataclasses.asdict(r) for r in requests]], src=0)


def follow_batches(pipe, device, generate=None) -> int:
    """A mesh's rank other than 0: run each batch rank 0 broadcasts with
    `run_requests` until its stop; returns the batches run.  A failed
    batch raises (the process exits non-zero)."""
    import torch.distributed as dist
    batches = 0
    while True:
        message = [None]
        dist.broadcast_object_list(message, src=0)
        if message[0] is None:
            return batches
        run_requests(pipe, [GenerationRequest(**r) for r in message[0]],
                     device, generate)
        batches += 1


class T2VServer:
    """Resident pipeline + batching worker + HTTP front end; on a mesh,
    rank 0's part."""

    def __init__(self, model: str, host: str = "127.0.0.1", port: int = 8000,
                 output_dir: str = "./serve_output", max_batch: int = 4,
                 batch_window_ms: float = 50.0,
                 use_fused_attention: bool = True, lora_path: str = "",
                 lora_rank: int = 64, lora_scale: float = 1.0,
                 request_timeout_s: float = 3600.0, pipe=None,
                 max_queue: Optional[int] = None, device="cuda", mesh=None):
        from ..pipelines.inference import generate, initialize_pipeline
        self.model = model
        self.output_dir = output_dir
        self.request_timeout_s = request_timeout_s
        os.makedirs(output_dir, exist_ok=True)
        self.pipe = pipe if pipe is not None else initialize_pipeline(
            model, use_fused_attention, lora_path, lora_rank,
            lora_scale=lora_scale, device=device, mesh=mesh)
        self.device = getattr(self.pipe, "device", device)
        self._generate = generate
        self.mesh = mesh
        # a batch that failed on a mesh: the server stops, and serve_main
        # exits non-zero
        self.failed: Optional[BaseException] = None
        self.worker = BatchingWorker(
            self._run_batch if mesh is None else self._run_on_mesh,
            max_batch=max_batch, batch_window_ms=batch_window_ms,
            max_queue=max_queue)
        self.started_at = time.time()
        self.httpd = ThreadingHTTPServer((host, port), self._make_handler())
        self.host, self.port = self.httpd.server_address[:2]
        self._serving = threading.Event()   # see shutdown()
        self._draining = threading.Event()  # see drain_and_shutdown()
        # /generate handlers between accept and response written: the
        # worker's queue_depth reaches 0 while handlers still write the
        # mp4, so the drain waits on this count too
        self._active_lock = threading.Lock()
        self._active_requests = 0

    # -- generation (on the worker thread) -----------------------------------

    def _run_batch(self, requests: List[GenerationRequest]
                   ) -> List[np.ndarray]:
        """One `generate` for the batch, then each request's post-process:
        uint8 frames on the host (`run_requests`)."""
        return run_requests(self.pipe, requests, self.device, self._generate)

    def _run_on_mesh(self, requests: List[GenerationRequest]
                     ) -> List[np.ndarray]:
        """The batch on every rank: broadcast, then run.  A failure ends
        the server: the batch's requests are answered with it, the HTTP
        front end stops and `failed` is set."""
        try:
            broadcast_batch(requests)
            return self._run_batch(requests)
        except BaseException as exc:
            traceback.print_exc()
            print("a batch failed on the mesh: the server stops (the other "
                  "ranks cannot go on without this one)")
            self.failed = exc
            threading.Thread(target=self.shutdown, daemon=True,
                             name="t2v-mesh-failure").start()
            raise
    def warmup(self, request: Optional[GenerationRequest] = None,
               batch_sizes: Sequence[int] = (1,)) -> GenerationRequest:
        """Run `request` (default: the GenerationRequest defaults, a
        full-cost 256x256x16 sample of 25 steps) once at each batch size,
        ascending, deduplicated and clamped to max_batch, on the worker
        thread and outside the stats, before traffic: the first K1 launch
        builds every kernel with nvcc (ops/kernel_build.py) and cuDNN picks
        its algorithms at each new shape on first use."""
        req = request or GenerationRequest(prompt="warmup")
        for b in sorted({min(max(1, int(b)), self.worker.max_batch)
                         for b in batch_sizes}):
            self.worker.call(lambda b=b: self.worker.run_batch([req] * b))
        return req

    # -- HTTP ------------------------------------------------------------------

    def serve_forever(self):
        print(f"t2v-serve-torch listening on http://{self.host}:{self.port}"
              f" (model={self.model})")
        self._serving.set()
        self.httpd.serve_forever()

    def shutdown(self):
        # httpd.shutdown() waits for a running serve_forever loop and
        # blocks forever if none started: signal it only when it is live
        if self._serving.is_set():
            self.httpd.shutdown()
        self.httpd.server_close()
        # on a mesh the worker's batch must end before rank 0 broadcasts
        # the stop (`stop_followers`)
        self.worker.shutdown(timeout=None if self.mesh is not None else 10.0)

    def stop_followers(self):
        """On a mesh, after `shutdown`: end the other ranks' loops."""
        if self.mesh is not None and self.failed is None:
            broadcast_batch(None)

    def drain_and_shutdown(self, timeout_s: float = 600.0):
        """Graceful stop: new /generate requests get 503, every accepted
        request finishes (until `timeout_s`), then the server shuts down.
        t2v-serve-torch wires this to SIGTERM."""
        self._draining.set()
        self.worker.begin_drain()
        deadline = time.monotonic() + max(0.0, timeout_s)
        while time.monotonic() < deadline:
            with self._active_lock:
                active = self._active_requests
            if self.worker.snapshot()["queue_depth"] == 0 and active == 0:
                break
            time.sleep(0.05)
        self.shutdown()

    def request_drain(self, timeout_s: float = 600.0):
        """Signal-handler-safe: run drain_and_shutdown on its own thread."""
        threading.Thread(target=self.drain_and_shutdown,
                         args=(timeout_s,), daemon=True,
                         name="t2v-drain").start()

    def _handle_generate(self, body: dict) -> dict:
        if self._draining.is_set():
            raise ServerOverloaded(
                "server is draining for shutdown; retry another replica")
        known = set(GenerationRequest.__dataclass_fields__)
        unknown = set(body) - known - {"return_video"}
        if unknown:
            raise ValueError(f"unknown fields: {sorted(unknown)}")
        if "prompt" not in body or not str(body["prompt"]).strip():
            raise ValueError("'prompt' is required")
        return_video = bool(body.pop("return_video", False))
        # JSON clients send numbers loosely: width=256.0 becomes 256
        for f, typ in (("width", int), ("height", int), ("num_frames", int),
                       ("window_size", int), ("num_steps", int),
                       ("vae_batch_size", int), ("seed", int), ("fps", int),
                       ("guidance_scale", float), ("init_weight", float)):
            if body.get(f) is not None:
                body[f] = typ(body[f])
        req = GenerationRequest(**body)
        if req.num_frames % req.resolved_window() != 0:
            raise ValueError("window_size must divide num_frames")
        pending = self.worker.submit(req)
        if not pending.done.wait(timeout=self.request_timeout_s):
            raise TimeoutError("generation timed out")
        if pending.error == SHUTTING_DOWN:
            raise ServerOverloaded(f"{SHUTTING_DOWN}; retry another replica")
        if pending.error:
            raise RuntimeError(pending.error)

        frames = pending.frames
        path = os.path.join(self.output_dir, f"{uuid.uuid4().hex[:12]}.mp4")
        from ..data.video import export_to_video
        export_to_video(frames, path, req.fps)
        seed_used = pending.head_seed if pending.head_seed is not None else 0
        resp = {"path": os.path.abspath(path),
                "num_frames": int(frames.shape[0]),
                "height": int(frames.shape[1]),
                "width": int(frames.shape[2]),
                "coalesced": int(pending.coalesced),
                "seed_used": int(seed_used)}
        if return_video:
            with open(path, "rb") as f:
                resp["video_base64"] = base64.b64encode(f.read()).decode()
        return resp

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet by default
                pass

            def _send_json(self, code: int, payload: dict):
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/healthz":
                    draining = server._draining.is_set()
                    self._send_json(503 if draining else 200, {
                        "status": "draining" if draining else "ok",
                        "model": server.model,
                        "uptime_s": round(time.time() - server.started_at,
                                          1)})
                elif self.path == "/stats":
                    self._send_json(200, server.worker.snapshot())
                else:
                    self._send_json(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/generate":
                    self._send_json(404, {"error": "not found"})
                    return
                # the whole handler span, response write included, counts
                # for the drain
                with server._active_lock:
                    server._active_requests += 1
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    body = json.loads(self.rfile.read(length) or b"{}")
                    if not isinstance(body, dict):
                        raise ValueError("body must be a JSON object")
                    self._send_json(200, server._handle_generate(body))
                except ServerOverloaded as exc:
                    self._send_json(503, {"error": str(exc)})
                except (ValueError, TypeError) as exc:
                    self._send_json(400, {"error": str(exc)})
                except TimeoutError as exc:
                    self._send_json(504, {"error": str(exc)})
                except Exception as exc:  # noqa: BLE001 -- answered as 500
                    traceback.print_exc()
                    self._send_json(500, {"error": str(exc)})
                finally:
                    with server._active_lock:
                        server._active_requests -= 1

        return Handler
