"""The LLM model: configuration, layers, parameters, caches and
the forward pass."""
