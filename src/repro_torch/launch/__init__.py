"""Launch plumbing: device meshes over ``torch.distributed``."""
