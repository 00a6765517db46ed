"""Index kinds: the HNSW graph index and the flat (exact) index."""
