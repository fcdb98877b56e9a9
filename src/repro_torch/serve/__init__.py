"""Serving: bucketed LSH index → retrieval → candidate scoring → top-N."""
from repro_torch.serve.index import (LSHIndex, build_index, insert,
                                     padded_flat_ids, window_slices)
from repro_torch.serve.retrieve import seed_items, tail_hits
from repro_torch.serve.service import (RecsysService, ServeConfig, full_topn,
                                       popular_shortlist,
                                       recommend_walked_kernel)

__all__ = [
    "LSHIndex", "build_index", "insert", "padded_flat_ids", "window_slices",
    "seed_items", "tail_hits", "RecsysService", "ServeConfig", "full_topn",
    "popular_shortlist", "recommend_walked_kernel",
]
