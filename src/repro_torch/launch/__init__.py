"""Launch helpers of the port: meshes over the ranks of a ``torch.distributed`` world."""
