"""Dense LM: norms, RoPE, attention and the layer stack."""
