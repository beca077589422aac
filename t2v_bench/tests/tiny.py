"""Tiny cells for CPU rehearsals: the real traffic files with the
geometry cut down, and a micro configuration of every module type, each
model naming its class as a published config does."""

from __future__ import annotations

import copy

from t2v_bench import spec

TINY_CONFIG = {
    "unet": {"_class_name": "UNet3DConditionModel", "sample_size": 8,
             "in_channels": 4, "out_channels": 4,
             "down_block_types": ["CrossAttnDownBlock3D", "DownBlock3D"],
             "up_block_types": ["UpBlock3D", "CrossAttnUpBlock3D"],
             "block_out_channels": [32, 32], "layers_per_block": 1,
             "downsample_padding": 1, "mid_block_scale_factor": 1,
             "norm_num_groups": 8, "norm_eps": 1e-5,
             "cross_attention_dim": 32, "attention_head_dim": 8},
    "text_encoder": {"architectures": ["CLIPTextModel"], "vocab_size": 256,
                     "hidden_size": 32, "intermediate_size": 64,
                     "num_hidden_layers": 2,
                     "num_attention_heads": 4, "max_position_embeddings": 77,
                     "hidden_act": "gelu", "layer_norm_eps": 1e-5},
    "vae": {"_class_name": "AutoencoderKL", "in_channels": 3,
            "out_channels": 3, "latent_channels": 4,
            "block_out_channels": [16, 16, 16, 16], "layers_per_block": 1,
            "norm_num_groups": 8, "sample_size": 32,
            "scaling_factor": 0.18215},
    "scheduler": {"num_train_timesteps": 1000, "beta_start": 0.00085,
                  "beta_end": 0.012, "beta_schedule": "scaled_linear",
                  "prediction_type": "epsilon", "steps_offset": 1},
}


def train_cell(traffic="lora-yaml-256x16-b8", batch=2, frames=3, size=32):
    t = copy.deepcopy(spec.traffic(traffic))
    t["overrides"].update(train_batch_size=batch, fused_groupnorm=False)
    t["overrides"]["train_data"].update(n_sample_frames=frames, width=size,
                                        height=size)
    t["items"] = 4 * batch
    return {"workload": {"name": "tiny-train", "chips": 1},
            "config": copy.deepcopy(TINY_CONFIG), "traffic": t,
            "limits": {}, "end_to_end": [], "per_layer": []}


def serve_cell(traffic="http-256x16-c4", frames=3, size=32, steps=3):
    t = copy.deepcopy(spec.traffic(traffic))
    t["request"].update(num_frames=frames, width=size, height=size,
                        num_steps=steps)
    t["check_requests"] = 2
    return {"workload": {"name": "tiny-serve", "chips": 1},
            "config": copy.deepcopy(TINY_CONFIG), "traffic": t,
            "limits": {}, "end_to_end": [], "per_layer": []}
