from repro_torch.embeddings.hot_cache import (HotIDCache, cached_pooled_lookup,
                                              fetch_rows)
from repro_torch.embeddings.table import (EmbeddingTable, hash_ids,
                                          init_table, lookup, pooled_lookup,
                                          presence_counts)

__all__ = ["EmbeddingTable", "HotIDCache", "cached_pooled_lookup",
           "fetch_rows", "hash_ids", "init_table", "lookup", "pooled_lookup",
           "presence_counts"]
