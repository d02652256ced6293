"""Serving: engine, sampler and the torch data-plane backend."""
