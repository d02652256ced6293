"""Tokenizer (deterministic hash tokenizer)."""
