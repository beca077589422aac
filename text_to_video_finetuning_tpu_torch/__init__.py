"""PyTorch + CUDA port of the text-to-video system, for NVIDIA Hopper.

A second package beside the JAX reference `text_to_video_finetuning_tpu`:
same module layout (ops/, models/, schedulers/, pipelines/, utils/), same
public layouts, diffusers state-dict names.  It imports torch and never jax;
the only modules it takes from the JAX package are the two that import
neither (`utils/torch_names.py`, `utils/simple_tokenizer.py`).
"""
