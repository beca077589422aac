"""diffusers' UNet3DConditionModel: the ModelScope 3D UNet
(`reference/unet.py`)."""

from t2v_bench.reference.unet import UNet3DConditionModel, UNetConfig


def build(published: dict) -> UNet3DConditionModel:
    return UNet3DConditionModel(UNetConfig.from_dict(published))
