"""The PyTorch port's command lines (cli.py) against the JAX package's:

* every flag of the JAX inference, serve, merge and bake parsers is in the
  port's, with the same option strings, type, nargs, choices and default,
  except the listed differences (`-d/--device` defaults to "cuda"; the
  serve parser has no `--no-trim-to-warm` and, like bake, a `--device`);
* a `--mesh` that needs more ranks than one process has raises the JAX
  `mesh_from_string`'s ValueError, before any model is loaded;
* `-x` / `-S` select the `auto` attention backend, as in JAX;
* `inference_main --device cpu` on the tiny pipeline writes one mp4 of the
  requested frames;
* `serve_main --device cpu`, in its own process, warms each batch size
  before it listens, serves a request, and drains and exits 0 on SIGTERM.
"""

import argparse
import os

import numpy as np
import pytest
import torch

from text_to_video_finetuning_tpu import cli as jcli
from text_to_video_finetuning_tpu_torch import cli

torch.set_num_threads(2)

# (parser, dest): the port's deliberate differences
DEFAULT_DIFFERS = {("inference", "device"): ("tpu", "cuda")}
ONLY_JAX = {("serve", "no_trim_to_warm")}
ONLY_PORT = {("serve", "device"), ("bake", "device"),
             ("inference", "backend"), ("serve", "backend")}


class _Captured(Exception):
    def __init__(self, parser):
        self.parser = parser


def jax_parser(name, monkeypatch):
    """The argparse parser a JAX entry point builds, caught at
    parse_args."""
    if name == "inference":
        return jcli.build_inference_parser()

    def capture(self, *args, **kwargs):
        raise _Captured(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    main = {"serve": jcli.serve_main, "merge": jcli.merge_lora_main,
            "bake": jcli.bake_lora_main}[name]
    with pytest.raises(_Captured) as info:
        main([])
    monkeypatch.undo()
    return info.value.parser


PORT_PARSERS = {"inference": cli.build_inference_parser,
                "serve": cli.build_serve_parser,
                "merge": cli.build_merge_parser,
                "bake": cli.build_bake_parser}


def _actions(parser):
    return {a.dest: a for a in parser._actions
            if not isinstance(a, argparse._HelpAction)}


@pytest.mark.parametrize("name", sorted(PORT_PARSERS))
def test_parser_flags_match_jax(name, monkeypatch):
    theirs = _actions(jax_parser(name, monkeypatch))
    ours = _actions(PORT_PARSERS[name]())
    assert set(theirs) - set(ours) == {d for n, d in ONLY_JAX if n == name}
    assert set(ours) - set(theirs) == {d for n, d in ONLY_PORT if n == name}
    for dest in set(theirs) & set(ours):
        a, b = theirs[dest], ours[dest]
        assert a.option_strings == b.option_strings, dest
        for attr in ("type", "nargs", "choices", "required", "const"):
            assert getattr(a, attr) == getattr(b, attr), (dest, attr)
        if (name, dest) in DEFAULT_DIFFERS:
            assert (a.default, b.default) == DEFAULT_DIFFERS[(name, dest)]
        else:
            assert a.default == b.default, dest
    for n, dest in ONLY_PORT:
        if n == name:
            assert ours[dest].default == {"device": "cuda",
                                          "backend": None}[dest]


@pytest.mark.parametrize("main", ["inference", "serve"])
def test_mesh_raises_naming_queue1_item5(main):
    """One process is a world of one: `--mesh dp=2` raises the JAX
    `mesh_from_string`'s ValueError before any load (the model path does
    not exist) and leaves no process group behind."""
    argv = {"inference": ["-m", "/nonexistent", "-p", "x"],
            "serve": ["-m", "/nonexistent", "--no-warmup"]}[main]
    fn = cli.inference_main if main == "inference" else cli.serve_main
    with pytest.raises(ValueError, match="'dp=2' needs 2 devices, have 1"):
        fn(argv + ["--mesh", "dp=2", "--device", "cpu"])
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("flags,fused", [([], False), (["-x"], True),
                                         (["-S"], True)])
def test_xformers_and_sdp_select_the_auto_backend(flags, fused, tmp_path,
                                                  monkeypatch):
    from text_to_video_finetuning_tpu_torch.pipelines import inference
    seen = {}

    def fake_inference(**kwargs):
        seen.update(kwargs)
        return torch.zeros(1, 3, 2, 8, 8)

    monkeypatch.setattr(inference, "inference", fake_inference)
    paths = cli.inference_main(["-m", "x", "-p", "a cat", "-o",
                                str(tmp_path), "-T", "2"] + flags)
    assert seen["use_fused_attention"] is fused
    assert seen["device"] == "cuda"
    assert len(paths) == 1 and os.path.exists(paths[0])


def test_inference_main_on_the_cpu_writes_an_mp4(tiny_pipeline_dir,
                                                 tmp_path):
    from text_to_video_finetuning_tpu_torch.data.video import VideoReader
    out = str(tmp_path / "out")
    paths = cli.inference_main([
        "-m", tiny_pipeline_dir, "-p", "a red car", "-o", out, "-W", "32",
        "-H", "32", "-T", "4", "-WS", "2", "-s", "2", "-r", "11", "-B", "2",
        "-rw", "--device", "cpu"])
    assert len(paths) == 2
    for path in paths:
        assert os.path.dirname(path) == out and path.endswith(".mp4")
        frames = VideoReader(path)[:]
        assert frames.shape == (4, 8, 8, 3)      # the tiny VAE: 4x4 -> 8x8
        assert frames.dtype == np.uint8


def test_serve_main_warms_serves_and_drains_on_sigterm(tiny_pipeline_dir,
                                                       tmp_path):
    """`t2v-serve-torch --device cpu` in its own process: it warms each
    --warmup-batch-sizes entry before it listens, answers POST /generate
    with an mp4, and on SIGTERM drains and exits 0."""
    import json
    import signal
    import socket
    import subprocess
    import sys
    import time
    import urllib.request

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    argv = ["-m", tiny_pipeline_dir, "--port", str(port), "--device", "cpu",
            "-o", str(tmp_path / "out"), "--max-batch", "2",
            "--warmup-batch-sizes", "1", "2", "--warmup-width", "32",
            "--warmup-height", "32", "--warmup-frames", "4",
            "--warmup-steps", "2"]
    code = ("import torch; torch.set_num_threads(2); from "
            "text_to_video_finetuning_tpu_torch.cli import serve_main; "
            f"serve_main({argv!r})")
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=repo, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        for _ in range(600):
            try:
                with urllib.request.urlopen(f"{base}/healthz",
                                            timeout=5) as r:
                    if json.loads(r.read())["status"] == "ok":
                        break
            except OSError:
                assert proc.poll() is None, proc.communicate()[0]
                time.sleep(0.2)
        body = json.dumps({"prompt": "a cat", "width": 32, "height": 32,
                           "num_frames": 4, "num_steps": 2}).encode()
        with urllib.request.urlopen(urllib.request.Request(
                f"{base}/generate", data=body), timeout=300) as r:
            resp = json.loads(r.read())
        assert resp["num_frames"] == 4 and os.path.exists(resp["path"])
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert "Warm at 32x32x4f 2 steps, batch 1" in out
    assert "Warm at 32x32x4f 2 steps, batch 2" in out
    assert out.index("batch 2") < out.index("listening on")
    assert "SIGTERM: draining" in out
