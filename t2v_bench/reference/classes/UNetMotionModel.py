"""diffusers' UNetMotionModel: AnimateDiff's motion UNet, SD 1.5's 2D UNet
with a motion adapter (`reference/unet_motion.py`)."""

from t2v_bench.reference.unet_motion import MotionUNetConfig, UNetMotionModel


def build(published: dict) -> UNetMotionModel:
    return UNetMotionModel(MotionUNetConfig.from_dict(published))
