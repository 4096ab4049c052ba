"""Fixed-arity EmbeddingBag: a gather and a weighted reduce in one pass."""
