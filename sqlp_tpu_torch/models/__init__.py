"""Problem model layer: SMPS I/O, stage templates, scenario model,
instances, the extensive form (see the package docstring)."""

from sqlp_tpu_torch._exports import lazy_exports

__all__, __getattr__, __dir__ = lazy_exports(__name__, {
    "sqlp_tpu_torch.models.smps_cor": ("CorData", "read_cor",
                                       "tokenize_cor"),
    "sqlp_tpu_torch.models.smps_tim": ("Position", "Period", "TimData",
                                       "read_tim"),
    "sqlp_tpu_torch.models.smps_sto": (
        "DiscreteDistribution", "NormalDistribution", "UniformDistribution",
        "StoData", "read_sto", "sample_scenario"),
    "sqlp_tpu_torch.models.stage": (
        "StageLP", "get_smps_stage_template", "instantiate",
        "extract_objective", "evaluate_first_stage_objective",
        "check_first_stage_feasible"),
    "sqlp_tpu_torch.models.instance": ("Instance", "load_instance",
                                       "compile_instance"),
    "sqlp_tpu_torch.models.scenario": ("ScenarioModel",
                                       "build_scenario_model",
                                       "sample_deltas"),
    "sqlp_tpu_torch.models.crash": ("crash_x0", "solve_extensive_form"),
})
