"""Multi-device SD on torch.distributed: ranks, meshes, sharding, combines.

``state_shardings`` (JAX ``NamedSharding``s) has no counterpart:
``state_pspecs`` gives the same layout."""

from sqlp_tpu_torch._exports import lazy_exports

__all__, __getattr__, __dir__ = lazy_exports(__name__, {
    "sqlp_tpu_torch.parallel.mesh": ("SCENARIO_AXIS", "make_mesh",
                                     "replicate", "shard_state",
                                     "state_pspecs"),
})
