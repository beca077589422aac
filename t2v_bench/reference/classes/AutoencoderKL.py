"""diffusers' AutoencoderKL: the Stable Diffusion VAE
(`reference/vae.py`)."""

from t2v_bench.reference.vae import AutoencoderKL, VAEConfig


def build(published: dict) -> AutoencoderKL:
    return AutoencoderKL(VAEConfig.from_dict(published))
