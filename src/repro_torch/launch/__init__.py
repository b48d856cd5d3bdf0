"""Launch plumbing: device meshes over ``torch.distributed``, the LLM
serving steps and driver, and the training presets."""
