"""Limiter model families: the public API surface (exact token bucket and
its partitioned façade so far)."""
