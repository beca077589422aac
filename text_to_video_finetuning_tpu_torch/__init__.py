"""PyTorch + CUDA port of the text-to-video system, for NVIDIA Hopper.

A second package beside the JAX reference `text_to_video_finetuning_tpu`:
same module layout (ops/, models/, lora/, schedulers/, training/,
pipelines/, utils/), same public layouts, diffusers state-dict names.  It
imports torch and nothing of JAX or of the JAX package: where it needs a
module of that package that imports no JAX (the flax <-> torch name map,
the minimal tokenizer writer), it keeps its own copy.  Its entry points run
on the card unless the caller asks for the CPU.
"""
