from .bucketing import sensible_buckets
from .datasets import (CachedDataset, ImageDataset, SingleVideoDataset,
                       VideoFolderDataset, VideoJsonDataset, clip_frames,
                       get_train_dataset, extend_datasets, ConcatDataset,
                       normalize_input, get_prompt_ids)
from .loader import DataLoader

__all__ = [
    "sensible_buckets", "CachedDataset", "ImageDataset",
    "SingleVideoDataset", "VideoFolderDataset", "VideoJsonDataset",
    "clip_frames", "get_train_dataset", "extend_datasets", "ConcatDataset",
    "normalize_input", "get_prompt_ids", "DataLoader",
]
