"""The port's `data/` against the JAX package's on the same inputs.

* `sensible_buckets` over a grid of sizes;
* normalize, through the g++ build of each package's `dataio.cpp` and
  through the numpy fallback;
* `.t2vc` items written by each package and read by the other (native and
  numpy writers and readers);
* every dataset type on the small synthetic mp4 (`pixel_values` to 1e-6,
  `prompt_ids` equal, text and dataset names), and the cached dataset over
  `.t2vc`, `.npz` and `.pt`;
* the DataLoader's batch order under shuffle, `pad_last`, shards and
  bucket batching, and `extend_datasets`.

The JAX side tokenizes with `transformers.CLIPTokenizer`, the port with its
own, both over the same minimal tokenizer directory.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

from text_to_video_finetuning_tpu import data as jdata
from text_to_video_finetuning_tpu.data import native as jnative
from text_to_video_finetuning_tpu_torch import data as pdata
from text_to_video_finetuning_tpu_torch.data import native as pnative
from text_to_video_finetuning_tpu_torch.utils.tokenizer import (
    CLIPTokenizer, write_minimal_clip_tokenizer)

PIXEL_ATOL = 1e-6


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    from transformers import CLIPTokenizer as HFTokenizer
    d = str(tmp_path_factory.mktemp("tok"))
    write_minimal_clip_tokenizer(d)
    return HFTokenizer.from_pretrained(d), CLIPTokenizer.from_pretrained(d)


@pytest.fixture(params=["native", "numpy"])
def backend(request, monkeypatch):
    """Both packages' native helpers, or both forced to numpy."""
    if request.param == "numpy":
        monkeypatch.setattr(jnative, "_load", lambda: None)
        monkeypatch.setattr(pnative, "_load", lambda: None)
    else:
        assert pnative.available() and jnative.available()
    return request.param


def test_sensible_buckets_match_over_a_grid():
    for mw, mh in ((256, 256), (384, 256), (512, 320)):
        for w in range(64, 1100, 97):
            for h in range(64, 1100, 89):
                assert pdata.sensible_buckets(mw, mh, w, h) == \
                    jdata.sensible_buckets(mw, mh, w, h), (mw, mh, w, h)


def test_normalize_matches(backend):
    rs = np.random.RandomState(0)
    hwc = rs.randint(0, 256, (3, 9, 7, 3)).astype(np.uint8)
    np.testing.assert_array_equal(pnative.normalize_u8_hwc_to_fchw(hwc),
                                  jnative.normalize_u8_hwc_to_fchw(hwc))
    np.testing.assert_array_equal(pnative.normalize_u8_to_pm1(hwc),
                                  jnative.normalize_u8_to_pm1(hwc))
    fchw = hwc.transpose(0, 3, 1, 2)
    for simple in (False, True):
        np.testing.assert_array_equal(
            pdata.normalize_input(fchw, use_simple_norm=simple),
            jdata.normalize_input(fchw, use_simple_norm=simple))


def test_t2vc_items_cross_read(tmp_path, backend):
    rs = np.random.RandomState(1)
    lat = rs.randn(4, 3, 5, 6).astype(np.float32)
    ids = rs.randint(0, 500, (1, 77)).astype(np.int32)
    for writer, reader, name in ((pnative, jnative, "p"),
                                 (jnative, pnative, "j")):
        path = str(tmp_path / f"{name}.t2vc")
        assert writer.cache_write_item(path, lat, ids, "a prompt é")
        item = reader.cache_read_item(path)
        np.testing.assert_array_equal(item["pixel_values"], lat)
        np.testing.assert_array_equal(item["prompt_ids"], ids.reshape(-1))
        assert item["text_prompt"] == "a prompt é"
        assert item["dataset"] == "cached"
    assert (tmp_path / "p.t2vc").read_bytes() == \
        (tmp_path / "j.t2vc").read_bytes()


def _same_item(ours, ref):
    assert ours["pixel_values"].dtype == ref["pixel_values"].dtype
    np.testing.assert_allclose(ours["pixel_values"], ref["pixel_values"],
                               atol=PIXEL_ATOL, rtol=0)
    np.testing.assert_array_equal(ours["prompt_ids"], ref["prompt_ids"])
    assert ours["prompt_ids"].dtype == ref["prompt_ids"].dtype
    assert ours["text_prompt"] == ref["text_prompt"]
    assert ours["dataset"] == ref["dataset"]


def _dataset_inputs(tmp_path, tiny_video):
    import cv2
    folder = tmp_path / "folder"
    folder.mkdir()
    os.symlink(tiny_video, folder / "clip.mp4")
    with open(folder / "clip.txt", "w") as f:
        f.write("a folder caption")
    images = tmp_path / "images"
    images.mkdir()
    rs = np.random.RandomState(2)
    for i in range(2):
        cv2.imwrite(str(images / f"im{i}.png"),
                    rs.randint(0, 256, (40, 56, 3)).astype(np.uint8))
    with open(images / "im1.txt", "w") as f:
        f.write("a caption for image one")
    jpath = tmp_path / "train.json"
    with open(jpath, "w") as f:
        json.dump({"data": [{"video_path": tiny_video, "data": [
            {"frame_index": 2, "prompt": "first"},
            {"frame_index": 5, "prompt": "second"}]}]}, f)
    return {
        "json": dict(json_path=str(jpath), n_sample_frames=3, width=32,
                     height=32),
        "single_video": dict(single_video_path=tiny_video,
                             single_video_prompt="one video",
                             n_sample_frames=4, width=32, height=32),
        "image": dict(image_dir=str(images), width=32, height=24,
                      single_img_prompt="", fallback_prompt="fallback"),
        "folder": dict(path=str(folder), n_sample_frames=4, fps=8,
                       width=32, height=32),
    }


@pytest.mark.parametrize("kind", ["json", "single_video", "image",
                                  "folder"])
@pytest.mark.parametrize("bucketing", [False, True])
def test_datasets_give_the_same_items(tmp_path, tiny_video, tokenizers,
                                      kind, bucketing):
    hf_tok, tok = tokenizers
    kwargs = dict(_dataset_inputs(tmp_path, tiny_video)[kind],
                  use_bucketing=bucketing)
    ref = jdata.get_train_dataset([kind], kwargs, hf_tok)
    ours = pdata.get_train_dataset([kind], kwargs, tok)
    assert len(ref) == len(ours) == 1
    ref, ours = ref[0], ours[0]
    assert type(ours).__name__ == type(ref).__name__
    assert len(ours) == len(ref) > 0
    for i in range(len(ref)):
        random.seed(i)           # folder: the frame offset is random
        r = ref[i]
        random.seed(i)
        _same_item(ours[i], r)


def test_cached_dataset_reads_every_format(tmp_path):
    rs = np.random.RandomState(3)
    items = [(rs.randn(4, 2, 3, 3).astype(np.float32),
              rs.randint(0, 99, (77,)).astype(np.int32), f"p{i}")
             for i in range(3)]
    lat, ids, prompt = items[0]
    jnative.cache_write_item(str(tmp_path / "a.t2vc"), lat, ids, prompt)
    lat, ids, prompt = items[1]
    np.savez(tmp_path / "b.npz", pixel_values=lat, prompt_ids=ids,
             text_prompt=np.asarray(prompt, dtype=object),
             dataset=np.asarray("cached", dtype=object))
    lat, ids, prompt = items[2]
    torch.save({"pixel_values": torch.from_numpy(lat),
                "prompt_ids": torch.from_numpy(ids), "text_prompt": prompt,
                "dataset": "cached"}, tmp_path / "c.pt")
    ref = jdata.CachedDataset(cache_dir=str(tmp_path))
    ours = pdata.CachedDataset(cache_dir=str(tmp_path))
    assert len(ours) == len(ref) == 3
    for i in range(3):
        _same_item(ours[i], ref[i])
        np.testing.assert_array_equal(ours[i]["pixel_values"], items[i][0])


class _Indexed:
    """Items carrying their index; `shapes` gives bucket shapes."""

    def __init__(self, n, shapes=((2, 2),)):
        self.n, self.shapes = n, shapes

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        shape = self.shapes[i % len(self.shapes)]
        return {"pixel_values": np.full(shape, i, np.float32),
                "prompt_ids": np.asarray([i], np.int32),
                "text_prompt": f"p{i}", "dataset": "d"}


def _order(loader_cls, epochs=2, **kwargs):
    loader = loader_cls(**kwargs)
    return [[b["prompt_ids"].reshape(-1).tolist() for b in loader]
            for _ in range(epochs)]


@pytest.mark.parametrize("kwargs", [
    dict(batch_size=3, shuffle=True, seed=5),
    dict(batch_size=3, shuffle=True, seed=5, pad_last=True),
    dict(batch_size=4, shuffle=False, pad_last=True, num_shards=2,
         shard_index=1),
    dict(batch_size=2, shuffle=True, seed=1, bucket_batching=True,
         shapes=((2, 2), (3, 2), (2, 3))),
    dict(batch_size=2, shuffle=True, seed=1, bucket_batching=True,
         pad_last=True, shapes=((2, 2), (3, 2))),
    dict(batch_size=2, shuffle=True, seed=3, num_workers=0),
], ids=["shuffle", "pad_last", "shards", "buckets", "buckets_pad",
        "no_workers"])
def test_loader_batch_order_matches(kwargs):
    kwargs = dict(kwargs)
    shapes = kwargs.pop("shapes", ((2, 2),))
    for n in (7, 8):
        ref = _order(jdata.DataLoader, dataset=_Indexed(n, shapes), **kwargs)
        ours = _order(pdata.DataLoader, dataset=_Indexed(n, shapes),
                      **kwargs)
        assert ours == ref
        assert len(pdata.DataLoader(_Indexed(n, shapes), **kwargs)) == \
            len(jdata.DataLoader(_Indexed(n, shapes), **kwargs))


def test_extend_datasets_matches():
    class Listed:
        def __init__(self, n):
            self.train_data = list(range(n))

        def __len__(self):
            return len(self.train_data)

    for extend in (False, True):
        ours, ref = [Listed(2), Listed(5)], [Listed(2), Listed(5)]
        pdata.extend_datasets(ours, ["train_data"], extend=extend)
        jdata.extend_datasets(ref, ["train_data"], extend=extend)
        assert [d.train_data for d in ours] == [d.train_data for d in ref]
    assert len(ours[0]) == 5
