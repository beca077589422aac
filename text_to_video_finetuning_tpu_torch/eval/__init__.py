"""Generation-quality evaluation (port of text_to_video_finetuning_tpu/
eval/): the CLIP dual encoder and the CLIP score."""

from .clip_score import CLIPScorer, evaluate_directory, preprocess_frames
from .clip_vision import (CLIPDualEncoder, CLIPVisionConfig, CLIPVisionModel,
                          load_clip_model, tiny_clip_vision_config)

__all__ = [
    "CLIPScorer", "evaluate_directory", "preprocess_frames",
    "CLIPDualEncoder", "CLIPVisionConfig", "CLIPVisionModel",
    "load_clip_model", "tiny_clip_vision_config",
]
