"""Each fault a cell can have, planted underneath a CPU run of a tiny cell
(the run's look for a card skipped, the rest of it driven), turns
`correct` false under the cell's own limits; the same run unbroken is
correct.  The tiny training cell runs in fp32 here, where the program
and the reference agree to rounding."""

import torch

from t2v_bench import run, spec
from t2v_bench.tests import tiny

TRAIN = "train-ms17b-lora-256x16"
SERVE = "serve-ms17b-256x16-c4"


def _train_cell():
    cell = tiny.train_cell()
    cell["traffic"]["yaml"]["mixed_precision"] = None
    cell["limits"] = spec.limits(TRAIN)
    return cell


def _serve_cell():
    cell = tiny.serve_cell()
    cell["limits"] = spec.limits(SERVE)
    return cell


def _correct(cell):
    return run.run_cell("tiny", 2 ** 31 + 21, 0.5, False, "cpu",
                        cell)["correct"]


def test_training_unbroken_is_correct():
    assert _correct(_train_cell())


def test_training_step_that_leaves_its_state(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)
    assert not _correct(_train_cell())


def test_training_on_half_the_batch(monkeypatch):
    from text_to_video_finetuning_tpu_torch.training import train_step
    make = train_step.make_loss_fn

    def halved(cfg, pass_sel=None):
        loss_fn = make(cfg, pass_sel)

        def fn(trainable, batch, generator, *a, **k):
            half = batch["pixel_values"].shape[0] // 2
            return loss_fn(trainable, {key: v[:half] for key, v in
                                       batch.items()}, generator, *a, **k)
        return fn
    monkeypatch.setattr(train_step, "make_loss_fn", halved)
    assert not _correct(_train_cell())


def test_serving_unbroken_is_correct():
    assert _correct(_serve_cell())


def test_serving_answer_altered_where_produced(monkeypatch):
    from text_to_video_finetuning_tpu_torch.serving import server
    post = server.postprocess

    def altered(video, remove_watermark, device="cuda"):
        frames = post(video, remove_watermark, device)
        frames[1:2] = 255 - frames[1:2]          # one frame inverted
        return frames
    monkeypatch.setattr(server, "postprocess", altered)
    assert not _correct(_serve_cell())
