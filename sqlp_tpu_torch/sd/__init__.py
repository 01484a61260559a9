"""The SD algorithm layer: state, dual pool, cuts, the step, the driver
and the certified lower bounds (see the package docstring)."""

from sqlp_tpu_torch._exports import lazy_exports

__all__, __getattr__, __dir__ = lazy_exports(__name__, {
    "sqlp_tpu_torch.sd.state": ("EpigraphSpec", "SDState",
                                "default_epigraph_spec", "init_state"),
    "sqlp_tpu_torch.sd.dual_pool": ("push_duals", "round_sig_bits"),
    "sqlp_tpu_torch.sd.cuts": ("Cut", "argmax_duals", "build_sasa_cut",
                               "evaluate_epigraph",
                               "evaluate_multi_epigraph"),
    "sqlp_tpu_torch.sd.algorithm": ("sd_step",),
    "sqlp_tpu_torch.sd.driver": ("SDSolver", "solve_instance"),
    "sqlp_tpu_torch.sd.lower_bound": ("certified_lower_bound",
                                      "cut_model_min", "saa_polish",
                                      "t_lower_bound"),
})
