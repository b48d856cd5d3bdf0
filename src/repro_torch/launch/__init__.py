"""Launch plumbing: device meshes over ``torch.distributed``, and the LLM
scaffold's training and serving steps and drivers."""
