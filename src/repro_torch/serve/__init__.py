"""Serving: bucketed LSH index → retrieval → candidate scoring → top-N,
and the sharded serving tier (the JAX package's `repro.serve`)."""
from repro_torch.serve.index import (LSHIndex, ShardedLSHIndex, build_index,
                                     build_sharded_index, insert,
                                     lookup_items, lookup_signatures,
                                     needs_rebuild, padded_flat_ids, rebuild,
                                     shard_bounds, shard_local_view,
                                     signatures_of, window_slices)
from repro_torch.serve.retrieve import (compact_pool, dedup_candidates,
                                        enumerate_windows,
                                        retrieve_for_items,
                                        retrieve_for_users, seed_items,
                                        shard_seed_sigs, shard_walk_local,
                                        sig_window_descriptors, tail_hits,
                                        translate_local_ids, walk_candidates,
                                        window_descriptors)
from repro_torch.serve.service import (RecsysService, ServeConfig,
                                       ShardedIngestUnsupported, full_topn,
                                       merge_topn, popular_shortlist,
                                       recommend_candidates,
                                       recommend_sharded, recommend_walked,
                                       recommend_walked_kernel)

__all__ = [
    "LSHIndex", "ShardedLSHIndex", "build_index", "build_sharded_index",
    "insert", "lookup_items", "lookup_signatures", "needs_rebuild",
    "padded_flat_ids", "rebuild", "shard_bounds", "shard_local_view",
    "signatures_of", "window_slices", "compact_pool", "dedup_candidates",
    "enumerate_windows", "retrieve_for_items", "retrieve_for_users",
    "seed_items", "shard_seed_sigs", "shard_walk_local",
    "sig_window_descriptors", "tail_hits", "translate_local_ids",
    "walk_candidates", "window_descriptors", "RecsysService", "ServeConfig",
    "ShardedIngestUnsupported", "full_topn", "merge_topn",
    "popular_shortlist", "recommend_candidates", "recommend_sharded",
    "recommend_walked", "recommend_walked_kernel",
]
