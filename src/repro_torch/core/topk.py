"""Shared padding constant of the candidate tensors (`repro/core/topk.py`).

Only `SENTINEL` is ported so far; the Top-K neighbour extraction of the
fit belongs to the training slice.
"""
SENTINEL = 2 ** 31 - 1   # int32 max: pads every candidate/id tensor
