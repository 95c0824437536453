"""Host runtime: clock, key directory, micro-batching and the bucket store."""
