"""Multi-device SD on torch.distributed: ranks, meshes, sharding, combines."""
