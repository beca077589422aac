"""Aspect-ratio frame bucketing (a copy of
text_to_video_finetuning_tpu/data/bucketing.py).

Behavioral spec: reference utils/bucketing.py -- scale the long side to the
target, snap the short side to the nearest bucket from multipliers
{64, 128, 192} offset from the target size, floor 192px.
"""

from __future__ import annotations


def min_res(size, min_size=192):
    return 192 if size < 192 else size


def up_down_bucket(m_size, in_size, direction):
    if direction == "down":
        return abs(int(m_size - in_size))
    if direction == "up":
        return abs(int(m_size + in_size))
    raise ValueError(direction)


def get_bucket_sizes(size, direction, min_size):
    multipliers = [64, 128, 192]
    for i, m in enumerate(multipliers):
        res = up_down_bucket(m, size, direction)
        multipliers[i] = min_res(res, min_size=min_size)
    return multipliers


def closest_bucket(m_size, size, direction, min_size):
    lst = get_bucket_sizes(m_size, direction, min_size)
    return lst[min(range(len(lst)), key=lambda i: abs(lst[i] - size))]


def resolve_bucket(i, h, w):
    return i / (h / w)


def sensible_buckets(m_width, m_height, w, h, min_size=192):
    """-> (width, height) resize target preserving aspect ratio."""
    if h > w:
        w = resolve_bucket(m_width, h, w)
        w = closest_bucket(m_width, w, "down", min_size=min_size)
        return w, m_height
    if h < w:
        h = resolve_bucket(m_height, w, h)
        h = closest_bucket(m_height, h, "down", min_size=min_size)
        return m_width, h
    return m_width, m_height
