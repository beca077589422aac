"""transformers' CLIPTextModel: the CLIP text encoder
(`reference/clip.py`)."""

from t2v_bench.reference.clip import CLIPConfig, CLIPTextModel


def build(published: dict) -> CLIPTextModel:
    return CLIPTextModel(CLIPConfig.from_dict(published))
