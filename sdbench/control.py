"""The control of the ``correct`` check: answers one precision below the
configuration's float32, in TF32 (the program keeps TF32 off), put in
the program's place. A check whose numbers the control passes cannot
tell float32 from TF32. Two controls, each printing the check's numbers
with its answers in place of the program's, beside their limits:

- ``reference_tf32`` (``mc_ub`` cells; no card needed): the reference
  computed in TF32: the instance data, the evaluation point and the
  deltas rounded to TF32, the right-hand sides formed from them and
  rounded to TF32, each LP then solved exactly, its (y, pi) certified by
  the KKT error on that rounded data. ``check_rows`` iid scenarios a
  seed, as the cell's panels draw them. Its rows are read twice: as rows
  a device solve certified, and as rows the host solved.
- ``program_tf32`` (any cell; on the card): a whole run of the cell, the
  program with its own TF32 switch on (``torch.backends.cuda.matmul.
  allow_tf32``: the plain ``torch.matmul`` products, which the EF's
  steps and the recourse ladder's KKT certificate use; the hand-written
  PDHG kernels do not read it).

    python3 sdbench/control.py --workload ssn.mc_ub --seeds 11 12 13
    python3 sdbench/control.py --workload ssn.ef_cert --mode program_tf32 \\
        --seeds 11 12 13 --seconds 30

prints one JSON line a seed. It is not part of a benchmark run.
"""

from __future__ import annotations

import json
import os
import sys


_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from sdbench import harness, reference, smps  # noqa: E402
from sdbench.entries import mc_ub  # noqa: E402
from sdbench.sampler import Sampler  # noqa: E402


def control_panel(lp, disc, D, x):
    """(H, v, Y, Pi, err) of the reference in TF32 for deltas D at x:
    right-hand sides, values, solutions, duals in the normalised
    objective's units, and their KKT error on the rounded data."""
    t = reference.tf32_round
    lp_c = smps.TwoStage(**{**lp.__dict__, "T": t(lp.T), "r": t(lp.r),
                            "W": t(lp.W), "q": t(lp.q)})
    H = t(reference.scenario_rhs(lp_c, disc, t(D), t(x)))
    v, Y, Pi = reference.recourse_values(lp_c, H, solutions=True)
    Pi = Pi / reference.objective_scale(lp_c)
    return H, v, Y, Pi, reference.kkt_errors(lp_c, H, Y, Pi)


def _table(checks) -> dict:
    return {c.name: {"value": c.value, "limit": c.limit, "fails": not c.ok}
            for c in checks}


def reference_tf32(cell: harness.Cell, seed: int) -> dict:
    import numpy as np
    import torch

    P = cell.params
    data = harness.instance_dir(cell.config)
    lp = smps.read_two_stage(data)
    disc = smps.read_discrete(data, lp)
    x = mc_ub._point(lp, P["x"])
    gen = torch.Generator()
    gen.manual_seed(seed)
    draw = getattr(Sampler(disc, "cpu"), P["sampling"])
    D = draw(gen, int(P["check_rows"])).numpy()
    H_ref = reference.scenario_rhs(lp, disc, D, x)
    v_ref = reference.recourse_values(lp, H_ref)
    H, v, Y, Pi, err = control_panel(lp, disc, D, x)
    lim = P["limits"]
    every = np.ones(len(v), bool)
    return {"as_certified": _table(mc_ub.checks(
                lp, H, v, H_ref, v_ref, every, Y, Pi, err, lim)),
            "as_host_solved": _table(mc_ub.checks(
                lp, H, v, H_ref, v_ref, ~every, Y[:0], Pi[:0], err[:0],
                lim))}


def program_tf32(cell: harness.Cell, seed: int, seconds: float) -> dict:
    import torch

    from sqlp_tpu_torch.utils import torchsetup

    def tf32_on():
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True

    # every entry point of the program calls configure_torch, which
    # turns TF32 off; its callers look it up by name
    for mod in list(sys.modules.values()):
        if getattr(mod, "configure_torch", None) is \
                torchsetup.configure_torch:
            mod.configure_torch = tf32_on
    tf32_on()
    res = harness.run_cell(cell, seed=seed, seconds=seconds, trace=False)
    return {k: dict(v, fails=v["value"] > v["limit"])
            for k, v in res["checks"].items()}


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(prog="sdbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", choices=("reference_tf32", "program_tf32"),
                   default="reference_tf32")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if args.mode == "program_tf32":
        import sqlp_tpu_torch.sd.driver  # noqa: F401  (its configure_torch)
        import sqlp_tpu_torch.utils.torchsetup  # noqa: F401
    for seed in args.seeds:
        got = program_tf32(cell, seed, args.seconds) \
            if args.mode == "program_tf32" else reference_tf32(cell, seed)
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "control": got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
