"""The dense LLM model: configuration, layers, parameters, caches and
the forward pass."""
