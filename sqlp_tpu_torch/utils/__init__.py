"""Process configuration, checkpoints, JSONL metrics, profiling (see the
package docstring)."""

from sqlp_tpu_torch._exports import lazy_exports

__all__, __getattr__, __dir__ = lazy_exports(__name__, {
    "sqlp_tpu_torch.utils.metrics": ("MetricsLogger",),
    "sqlp_tpu_torch.utils.checkpoint": ("load_meta", "load_state",
                                        "save_state"),
    "sqlp_tpu_torch.utils.profiling": ("span", "spans", "trace"),
})
