"""The model-FLOP counter (`workload`, the reference run on the meta
device) against forward hooks that count every conv, linear and
attention GEMM of the port's micro UNet run on the CPU."""

import pytest
import torch
from torch import nn

from t2v_bench import models, workload
from t2v_bench.tests.tiny import TINY_CONFIG


def _port_unet(config):
    from text_to_video_finetuning_tpu_torch.models.attention import (
        CrossAttention)
    from text_to_video_finetuning_tpu_torch.models.unet3d import (
        UNet3DConditionModel, UNet3DConfig)
    u = config["unet"]
    cfg = UNet3DConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in u.items()
                          if k in UNet3DConfig.__dataclass_fields__})
    model = UNet3DConditionModel(cfg)
    model.load_state_dict(models.make_weights(config, "unet", 5, "cpu",
                                              torch.float32))
    model.set_attention_backend("plain")
    return model, CrossAttention


def _hooked_flops(model, attention_cls, *inputs):
    total = [0]

    def dense(module, args, out):
        if isinstance(module, nn.Linear):
            total[0] += 2 * out.numel() * module.in_features
        else:
            k = 1
            for s in module.kernel_size:
                k *= s
            total[0] += 2 * out.numel() * module.in_channels * k

    def attn(module, args, out):
        x = args[0]
        ctx = args[1] if len(args) > 1 and args[1] is not None else x
        total[0] += 4 * x.shape[0] * x.shape[1] * ctx.shape[1] * \
            module.heads * module.dim_head

    handles = []
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d)):
            handles.append(m.register_forward_hook(dense))
        elif isinstance(m, attention_cls):
            handles.append(m.register_forward_hook(attn))
    with torch.no_grad():
        model(*inputs)
    for h in handles:
        h.remove()
    return total[0]


@pytest.mark.parametrize("batch, frames, size", [(1, 3, 64), (2, 1, 32)])
def test_counter_matches_hooks_on_the_port(batch, frames, size):
    model, attention_cls = _port_unet(TINY_CONFIG)
    x = torch.randn(batch, 4, frames, size // 8, size // 8)
    t = torch.tensor([10] * batch)
    ctx = torch.randn(batch, 77, TINY_CONFIG["unet"]["cross_attention_dim"])
    hooked = _hooked_flops(model, attention_cls, x, t, ctx)
    assert workload.unet_forward(TINY_CONFIG, batch, frames, size,
                                 size) == hooked


def test_training_step_counts_backward_without_recompute():
    train = {"lora_rank": 4,
             "unet_lora_modules": ["ResnetBlock2D", "Transformer2DModel",
                                   "TransformerTemporalModel",
                                   "CrossAttention"],
             "text_encoder_lora_modules": ["CLIPEncoderLayer"]}
    flops, norms, attn = workload.train_step(TINY_CONFIG, 2, 3, 64, 64,
                                             train)
    forward = (workload.unet_forward(TINY_CONFIG, 2, 3, 64, 64)
               + workload.unet_forward(TINY_CONFIG, 2, 1, 64, 64))
    # the input gradients roughly double the forward; the LoRA adds little
    assert 2.0 * forward < flops < 3.2 * forward
    assert norms and all(len(s) in (4, 5) for s, _ in norms)
    assert attn == []          # no attention reaches 1,024 tokens here
