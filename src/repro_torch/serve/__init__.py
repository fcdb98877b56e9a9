"""Serving: bucketed LSH index → retrieval → candidate scoring → top-N
(the JAX package's `repro.serve`, less the sharded tier)."""
from repro_torch.serve.index import (LSHIndex, build_index, insert,
                                     lookup_items, lookup_signatures,
                                     needs_rebuild, padded_flat_ids, rebuild,
                                     signatures_of, window_slices)
from repro_torch.serve.retrieve import (compact_pool, dedup_candidates,
                                        enumerate_windows,
                                        retrieve_for_items,
                                        retrieve_for_users, seed_items,
                                        tail_hits, walk_candidates,
                                        window_descriptors)
from repro_torch.serve.service import (RecsysService, ServeConfig, full_topn,
                                       popular_shortlist,
                                       recommend_candidates,
                                       recommend_walked,
                                       recommend_walked_kernel)

__all__ = [
    "LSHIndex", "build_index", "insert", "lookup_items", "lookup_signatures",
    "needs_rebuild", "padded_flat_ids", "rebuild", "signatures_of",
    "window_slices", "compact_pool", "dedup_candidates", "enumerate_windows",
    "retrieve_for_items", "retrieve_for_users", "seed_items", "tail_hits",
    "walk_candidates", "window_descriptors", "RecsysService", "ServeConfig",
    "full_topn", "popular_shortlist", "recommend_candidates",
    "recommend_walked", "recommend_walked_kernel",
]
