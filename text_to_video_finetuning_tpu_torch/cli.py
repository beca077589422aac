"""Command-line entries of the PyTorch port (port of
text_to_video_finetuning_tpu/cli.py):

    t2v-train-torch --config configs/v2/train_config.yaml [--device cpu]
    torchrun --nproc_per_node 2 -m text_to_video_finetuning_tpu_torch.cli \
        --config <yaml with mesh_dp / mesh_fsdp>
    t2v-inference-torch -m <pipeline dir> -p "a prompt" [-lP <lora>] ...
    t2v-serve-torch -m <pipeline dir> [--port 8000] [--max-batch 4] ...
    t2v-merge-lora-torch a.pt b.pt -o merged.pt -m <pipeline dir>
    t2v-bake-lora-torch -m <pipeline dir> -lP <lora> -o <new dir>
    python -m text_to_video_finetuning_tpu_torch.cli --config <yaml>

The flags are the JAX package's, with these differences: `-d/--device`
(inference; bake; train and serve as `--device`) names a torch device and
defaults to the card; training, and inference and serving with `--mesh`,
run one process per rank under torchrun, each rank on
`cuda:{LOCAL_RANK}` of the base device `--device cuda` (`--backend` nccl
or gloo; `--device cuda:0 --backend gloo` puts every rank on one card);
a `--mesh` that needs more ranks than the launch has raises the JAX
ValueError before any load, one process being a world of one;
`t2v-serve-torch` has no
`--no-trim-to-warm` (the port's server keeps no warm-signature table).

    torchrun --nproc_per_node 2 --no-python t2v-inference-torch \
        -m <pipeline dir> -p "a prompt" --mesh sp=2
Training's YAML keys are `training/engine.py::main`'s kwargs; reading the
YAML needs `yaml`, otherwise call `engine.main(**config_dict)`.
"""

from __future__ import annotations

import argparse
import datetime
import os
import platform
import re
from pathlib import Path
from typing import Optional, Sequence
from uuid import uuid4

# how long a server's follower ranks wait in a collective for rank 0's
# next batch: as long as the server may idle
SERVE_TIMEOUT = datetime.timedelta(days=365)


def start_mesh(spec: str, device: str = "cuda",
               backend: Optional[str] = None,
               timeout: Optional[datetime.timedelta] = None):
    """`--mesh`: (mesh or None, rank, device).  With a spec, the process
    group of a torchrun launch starts as training's does
    (`init_distributed`, its collectives waiting `timeout`); a spec the
    world cannot hold raises the JAX `mesh_from_string`'s ValueError,
    before any model loads, with the group left again.  A world of one
    runs without a mesh."""
    if not (spec or "").strip():
        return None, 0, device
    import torch.distributed as dist

    from .parallel import (init_distributed, make_mesh, mesh_from_string,
                           mesh_shape)
    rank, world, dev = init_distributed(device, backend, timeout)
    try:
        config = mesh_from_string(spec, world)
        mesh_shape(config, world)
        if world > 1:
            return make_mesh(config, dev.type), rank, dev
    except BaseException:
        if dist.is_initialized():
            dist.destroy_process_group()
        raise
    if dist.is_initialized():           # a torchrun launch of one rank
        dist.destroy_process_group()
    return None, 0, dev


def leave_mesh(mesh):
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()


def _backend_flag(parser: argparse.ArgumentParser):
    parser.add_argument("--backend", type=str, default=None,
                        choices=("nccl", "gloo"),
                        help="process-group backend under torchrun "
                             "(default: nccl on the card, gloo on the CPU)")


def train_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Finetune a ModelScope text-to-video model with the "
                    "PyTorch port")
    parser.add_argument("--config", type=str, required=True,
                        help="a training YAML (configs/v2/*.yaml)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (default: cuda; "
                             "under torchrun each rank takes "
                             "cuda:LOCAL_RANK, and cuda:N puts every rank "
                             "on card N)")
    _backend_flag(parser)
    return parser


def train_main(argv: Optional[Sequence[str]] = None, record=None) -> str:
    """`t2v-train-torch`; `record`, an `engine.RunRecord`, is filled in by
    the run."""
    args = train_parser().parse_args(argv)
    from .config import load_train_config
    from .training.engine import main
    return main(config=load_train_config(args.config), device=args.device,
                backend=args.backend, record=record)


# -- inference -------------------------------------------------------------------

def build_inference_parser() -> argparse.ArgumentParser:
    """Flag for flag with the JAX `build_inference_parser` (the reference's
    inference.py:336-435, with --lora_scale), `-d/--device` a torch device
    (default cuda)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-m", "--model", type=str, required=True,
                        help="Path to model checkpoint directory")
    parser.add_argument("-p", "--prompt", type=str, required=True)
    parser.add_argument("-n", "--negative-prompt", type=str, default=None)
    parser.add_argument("-o", "--output-dir", type=str, default="./output")
    parser.add_argument("-B", "--batch-size", type=int, default=1)
    parser.add_argument("-W", "--width", type=int, default=256)
    parser.add_argument("-H", "--height", type=int, default=256)
    parser.add_argument("-T", "--num-frames", type=int, default=16)
    parser.add_argument("-WS", "--window-size", type=int, default=None)
    parser.add_argument("-VB", "--vae-batch-size", type=int, default=8)
    parser.add_argument("-s", "--num-steps", type=int, default=25)
    parser.add_argument("-g", "--guidance-scale", type=float, default=25)
    parser.add_argument("-i", "--init-video", type=str, default=None)
    parser.add_argument("-iw", "--init-weight", type=float, default=0.5)
    parser.add_argument("-f", "--fps", type=int, default=12)
    parser.add_argument("-d", "--device", type=str, default="cuda",
                        help="torch device (default: cuda)")
    parser.add_argument("-x", "--xformers", action="store_true",
                        help="(parity flag) use the flash-attention kernel "
                             "(the `auto` backend)")
    parser.add_argument("-S", "--sdp", action="store_true",
                        help="(parity flag) use the flash-attention kernel "
                             "(the `auto` backend)")
    parser.add_argument("-lP", "--lora_path", type=str, default="")
    parser.add_argument("-lR", "--lora_rank", type=int, default=64)
    parser.add_argument("-lS", "--lora_scale", type=float, default=1.0,
                        help="runtime LoRA strength (tune_lora_scale parity:"
                             " 0 = base model, 1 = trained strength)")
    parser.add_argument("-rw", "--remove-watermark", action="store_true")
    parser.add_argument("-l", "--loop", action="store_true")
    parser.add_argument("-r", "--seed", type=int, default=None)
    parser.add_argument("--mesh", type=str, default="",
                        help="multi-device sampling mesh under torchrun, "
                             "e.g. 'dp=2,sp=4' (CFG pair over dp, frames "
                             "over sp, the UNet over tp/fsdp)")
    _backend_flag(parser)
    return parser


def inference_main(argv: Optional[Sequence[str]] = None) -> list:
    """`t2v-inference-torch`: one request, one mp4 per video under
    --output-dir; returns the paths written (on a mesh, rank 0 writes and
    returns them, the other ranks return [])."""
    args = build_inference_parser().parse_args(argv)
    mesh, rank, device = start_mesh(args.mesh, args.device, args.backend)
    try:
        return _inference(args, mesh, rank, device)
    finally:
        leave_mesh(mesh)


def _inference(args, mesh, rank, device) -> list:
    from .data.video import export_to_video
    from .pipelines.inference import inference, load_init_video
    from .serving.server import postprocess

    out_name = f"{args.output_dir}/"
    if args.init_video is not None:
        out_name += f"[({Path(args.init_video).stem}) x {args.init_weight}] "
    prompt = (re.sub(r'[<>:"/\\|?*\x00-\x1F]', "_", args.prompt)
              if platform.system() == "Windows" else args.prompt)
    out_name += f"{prompt}"

    prompts = [prompt] * args.batch_size
    negative = ([args.negative_prompt] * args.batch_size
                if args.negative_prompt is not None else None)
    init_video = None
    if args.init_video is not None:
        init_video = load_init_video(args.init_video, args.height,
                                     args.width, args.num_frames)

    videos = inference(
        model=args.model, prompt=prompts, negative_prompt=negative,
        width=args.width, height=args.height, num_frames=args.num_frames,
        window_size=args.window_size or args.num_frames,
        vae_batch_size=args.vae_batch_size, num_steps=args.num_steps,
        guidance_scale=args.guidance_scale, init_video=init_video,
        init_weight=args.init_weight,
        use_fused_attention=args.xformers or args.sdp,
        lora_path=args.lora_path, lora_rank=args.lora_rank,
        lora_scale=args.lora_scale, loop=args.loop, seed=args.seed,
        device=device, mesh=mesh)
    if rank != 0:
        return []

    os.makedirs(args.output_dir, exist_ok=True)
    paths = []
    for video in videos:                                # (C, F, H, W) [-1,1]
        if args.remove_watermark:
            print("Inpainting watermarks...")
        frames = postprocess(video, args.remove_watermark, device)
        path = f"{out_name} {str(uuid4())[:8]}.mp4"
        export_to_video(frames, path, args.fps)
        paths.append(path)
    return paths


# -- LoRA merge and bake ---------------------------------------------------------

def build_merge_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Merge LoRA files (weighted) into a single LoRA file")
    parser.add_argument("inputs", nargs="+",
                        help="LoRA files (.pt / .safetensors), same model "
                             "and target set")
    parser.add_argument("-o", "--output", type=str, required=True,
                        help="merged LoRA path (.pt or .safetensors)")
    parser.add_argument("-m", "--model", type=str, required=True,
                        help="pipeline directory (site enumeration needs "
                             "the model config)")
    parser.add_argument("-k", "--kind", choices=["unet", "text_encoder"],
                        default="unet")
    parser.add_argument("-v", "--version",
                        choices=["cloneofsimo", "stable_lora"],
                        default="cloneofsimo")
    parser.add_argument("-w", "--weights", type=float, nargs="+",
                        default=None,
                        help="per-input weights (default: all 1.0)")
    parser.add_argument("-r", "--rank", type=int, default=0,
                        help="SVD-compress the merged LoRA to this rank "
                             "(0 = keep the exact concatenated rank; "
                             "cloneofsimo only)")
    parser.add_argument("--targets", type=str, nargs="+", default=None,
                        help="target_replace_module set the inputs were "
                             "trained with (default: the full-model set)")
    return parser


def merge_lora_main(argv: Optional[Sequence[str]] = None) -> str:
    """`t2v-merge-lora-torch`: merge several LoRA files into one, exactly
    (rank concatenation, lora/merge.py), or SVD-compressed with --rank.  On
    the host: the sites come from the model built on the meta device."""
    parser = build_merge_parser()
    args = parser.parse_args(argv)
    if not args.output.endswith((".pt", ".safetensors")):
        parser.error("output must end in .pt or .safetensors")
    if args.rank and args.version != "cloneofsimo":
        parser.error("--rank SVD compression is cloneofsimo-only")
    import torch

    from .lora import formats
    from .lora.handler import LoraHandler
    from .lora.merge import merge_lora_trees, truncate_lora_rank
    from .models.clip_text import CLIPTextModel
    from .models.unet3d import UNet3DConditionModel
    from .utils import checkpoint as ckpt

    targets = args.targets or (["UNet3DConditionModel"]
                               if args.kind == "unet"
                               else ["CLIPEncoderLayer"])
    handler = LoraHandler(version=args.version, use_unet_lora=True,
                          use_text_lora=True, unet_replace_modules=targets,
                          text_encoder_replace_modules=targets)
    with torch.device("meta"):
        if args.kind == "unet":
            sites = handler.unet_sites(UNet3DConditionModel(
                ckpt.load_unet_config(os.path.join(args.model, "unet"))))
        else:
            sites = handler.text_encoder_sites(CLIPTextModel(
                ckpt.load_clip_config(os.path.join(args.model,
                                                   "text_encoder"))))

    trees = [handler.load_lora_file(p, sites, "cpu") for p in args.inputs]
    merged = merge_lora_trees(trees, args.weights)
    if args.rank:
        merged = truncate_lora_rank(merged, sites, args.rank)
    if args.output.endswith(".pt"):
        formats.save_lora_pt(merged, sites, args.output)
    elif args.version == "cloneofsimo":
        formats.save_safeloras({args.kind: (merged, sites, set(targets))},
                               args.output)
    else:
        ckpt.write_safetensors(formats.stable_lora_state_dict(merged, sites),
                               args.output)
    print(f"Merged {len(args.inputs)} LoRAs -> {args.output}")
    return args.output


def build_bake_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Bake LoRA weights into a pipeline directory")
    parser.add_argument("-m", "--model", type=str, required=True,
                        help="input pipeline directory")
    parser.add_argument("-lP", "--lora_path", type=str, required=True,
                        help="LoRA file or directory (`_unet` / "
                             "`_text_encoder` name match)")
    parser.add_argument("-lR", "--lora_rank", type=int, default=64)
    parser.add_argument("-lS", "--lora_scale", type=float, default=1.0)
    parser.add_argument("-o", "--output", type=str, required=True,
                        help="output pipeline directory")
    parser.add_argument("--fp16", action="store_true",
                        help="save merged weights in fp16")
    parser.add_argument("-d", "--device", type=str, default="cuda",
                        help="torch device the fold runs on (default: "
                             "cuda)")
    return parser


def bake_lora_main(argv: Optional[Sequence[str]] = None) -> str:
    """`t2v-bake-lora-torch`: fold LoRA file(s) and learned embeds into a
    pipeline's weights (fp32, `initialize_pipeline(half=False)`) and save
    it, with the grown tokenizer, as a standalone pipeline directory."""
    args = build_bake_parser().parse_args(argv)
    import torch

    from .pipelines.inference import initialize_pipeline
    from .utils import checkpoint as ckpt

    pipe = initialize_pipeline(args.model, use_fused_attention=False,
                               lora_path=args.lora_path,
                               lora_rank=args.lora_rank, half=False,
                               lora_scale=args.lora_scale,
                               device=args.device)
    os.makedirs(args.output, exist_ok=True)
    tok_dir = os.path.join(args.output, "tokenizer")
    pipe.tokenizer.save_pretrained(tok_dir)
    ckpt.save_pipeline(args.output, unet=pipe.unet, vae=pipe.vae,
                       text_encoder=pipe.text_encoder,
                       scheduler_config=pipe.scheduler_config,
                       tokenizer_dir=tok_dir,
                       dtype=torch.float16 if args.fp16 else None)
    print(f"Baked {args.lora_path} (scale {args.lora_scale}) into "
          f"{args.output}")
    return args.output


# -- serving -----------------------------------------------------------------------

def build_serve_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("-m", "--model", type=str, required=True,
                        help="Path to model checkpoint directory")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("-o", "--output-dir", type=str,
                        default="./serve_output")
    parser.add_argument("--max-batch", type=int, default=4,
                        help="coalesce up to N same-signature requests "
                             "into one batched generate")
    parser.add_argument("--batch-window-ms", type=float, default=50.0,
                        help="how long to hold a request open for "
                             "batch-mates before running it")
    parser.add_argument("--request-timeout-s", type=float, default=3600.0)
    parser.add_argument("--no-warmup", action="store_true",
                        help="skip the start-up samples")
    parser.add_argument("--warmup-batch-sizes", type=int, nargs="+",
                        default=[1],
                        help="batch sizes to sample once at start-up, "
                             "before traffic: the first builds the kernels "
                             "with nvcc, each lets cuDNN choose its "
                             "algorithms at that batch's shapes")
    parser.add_argument("--max-queue", type=int, default=0,
                        help="reject new requests with 503 once this many "
                             "are in flight (queued + running); 0 = "
                             "unbounded")
    parser.add_argument("--warmup-width", type=int, default=256)
    parser.add_argument("--warmup-height", type=int, default=256)
    parser.add_argument("--warmup-frames", type=int, default=16)
    parser.add_argument("--warmup-steps", type=int, default=25)
    parser.add_argument("-lP", "--lora_path", type=str, default="")
    parser.add_argument("-lR", "--lora_rank", type=int, default=64)
    parser.add_argument("-lS", "--lora_scale", type=float, default=1.0)
    parser.add_argument("--no-fused-attention", action="store_true")
    parser.add_argument("--mesh", type=str, default="",
                        help="multi-device sampling mesh under torchrun, "
                             "e.g. 'sp=4' or 'dp=2,sp=4' (see "
                             "t2v-inference-torch --mesh); rank 0 serves "
                             "HTTP")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default: cuda)")
    _backend_flag(parser)
    return parser


def serve_main(argv: Optional[Sequence[str]] = None):
    """`t2v-serve-torch`: a resident pipeline behind the batching HTTP
    server (serving/server.py).  SIGTERM drains: accepted requests finish,
    new ones get 503, then the process exits.  On a mesh rank 0 serves and
    the other ranks follow its batches (serving/server.py), ignoring
    SIGTERM until rank 0's stop; a batch that fails on any rank raises on
    every rank."""
    parser = build_serve_parser()
    args = parser.parse_args(argv)
    if args.max_queue < 0:
        # a negative bound would 503 every request
        parser.error(f"--max-queue must be >= 0, got {args.max_queue}")
    mesh, rank, device = start_mesh(args.mesh, args.device, args.backend,
                                    SERVE_TIMEOUT)
    try:
        if rank != 0:
            return _follow(args, mesh, device)
        return _serve(args, mesh, device)
    finally:
        leave_mesh(mesh)


def _follow(args, mesh, device) -> int:
    import signal

    from .pipelines.inference import initialize_pipeline
    from .serving.server import follow_batches
    signal.signal(signal.SIGTERM, lambda *_: print(
        "SIGTERM: this rank waits for rank 0's drain and stop"))
    pipe = initialize_pipeline(
        args.model, not args.no_fused_attention, args.lora_path,
        args.lora_rank, lora_scale=args.lora_scale, device=device,
        mesh=mesh)
    return follow_batches(pipe, device)


def _serve(args, mesh, device):
    import signal
    import threading
    import time

    from .serving.server import GenerationRequest, T2VServer
    server = T2VServer(
        model=args.model, host=args.host, port=args.port,
        output_dir=args.output_dir, max_batch=args.max_batch,
        batch_window_ms=args.batch_window_ms,
        use_fused_attention=not args.no_fused_attention,
        lora_path=args.lora_path, lora_rank=args.lora_rank,
        lora_scale=args.lora_scale,
        request_timeout_s=args.request_timeout_s,
        max_queue=args.max_queue or None, device=device, mesh=mesh)
    # installed before the warm-up, so a SIGTERM during it skips the
    # remaining sizes and never enters serve_forever
    drain_requested = threading.Event()

    def on_sigterm(*_):
        print("SIGTERM: draining (new requests get 503, in-flight "
              "finish)...")
        drain_requested.set()
        server.request_drain(args.request_timeout_s)

    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, on_sigterm)
    if not args.no_warmup:
        req = GenerationRequest(
            prompt="warmup", width=args.warmup_width,
            height=args.warmup_height, num_frames=args.warmup_frames,
            num_steps=args.warmup_steps)
        print("Warming up (the first sample builds the kernels and lets "
              "cuDNN choose its algorithms)...")
        for b in sorted({min(max(1, b), server.worker.max_batch)
                         for b in args.warmup_batch_sizes}):
            if drain_requested.is_set():
                break
            t0 = time.perf_counter()
            server.warmup(req, batch_sizes=[b])
            print(f"Warm at {req.width}x{req.height}x{req.num_frames}f "
                  f"{req.num_steps} steps, batch {b} "
                  f"({time.perf_counter() - t0:.1f}s).")
    try:
        if not drain_requested.is_set():
            server.serve_forever()
    except KeyboardInterrupt:
        pass
    except OSError:
        # the drain thread closes the listening socket; when that lands
        # before serve_forever enters its loop, the loop raises on the
        # closed socket: that is the drain's exit
        if not drain_requested.is_set() and server.failed is None:
            raise
    finally:
        server.shutdown()
    if server.failed is not None:
        raise RuntimeError("a batch failed on the mesh") from server.failed
    server.stop_followers()


if __name__ == "__main__":
    train_main()
