"""Plan-store building blocks: match pipeline, eviction policies, protocol."""
