"""The reader of K1's sm90 share (`serve.k1_sm90_pct`) on fake counters
of K1's launches by route, and its entry: both serving cells report it."""

import pytest

from t2v_bench import spec

SERVE_CELLS = ("serve-ms17b-256x16-c4", "serve-animatediff-512x16-c2")


def _set(monkeypatch, module, **counts):
    for name, n in counts.items():
        monkeypatch.setattr(module, name, n)


def test_reads_the_share_of_forward_launches_on_sm90(monkeypatch):
    from text_to_video_finetuning_tpu_torch.ops import flash_attention
    reader = spec.reader("serve.k1_sm90_pct")
    _set(monkeypatch, flash_attention, fwd_sm90_launch_count=500,
         fwd_wmma_launch_count=0)
    assert reader.read({}) == 100.0
    # K2 / K3 launches (training) are not K1's; a wmma K1 counts against
    _set(monkeypatch, flash_attention, fwd_sm90_launch_count=30,
         fwd_wmma_launch_count=10, dkv_wmma_launch_count=40,
         dq_wmma_launch_count=40)
    assert reader.read({}) == pytest.approx(75.0)


def test_reads_nothing_without_the_counter_or_a_launch(monkeypatch):
    from text_to_video_finetuning_tpu_torch.ops import flash_attention
    reader = spec.reader("serve.k1_sm90_pct")
    _set(monkeypatch, flash_attention, fwd_sm90_launch_count=0,
         fwd_wmma_launch_count=0, dkv_sm90_launch_count=3)
    assert reader.read({}) is None
    monkeypatch.delattr(flash_attention, "fwd_sm90_launch_count")
    assert reader.read({}) is None


@pytest.mark.parametrize("workload", SERVE_CELLS)
def test_both_serving_cells_report_it(workload):
    cell = spec.cell(workload)
    entry = next(m for m in cell["per_layer"]
                 if m["name"] == "serve.k1_sm90_pct")
    assert entry["moves"] == "serve_videos_per_min"
    assert entry["layer"] == "ops, attention"
