"""Instance: an SMPS two-stage problem compiled to dense tensors.

Port of record: ``sqlp_tpu/models/instance.py`` (``InstanceArrays`` :37-56,
``Instance`` :59-92, ``compile_instance`` :95-161, ``find_instance_dir``
:176, ``load_instance`` :186, ``load_proposal`` :207-237). The host
compile (bound folding included) is the same numpy code, so the arrays
are bitwise equal to the JAX package's; only the final placement differs:
``dtype`` and ``device`` are explicit arguments. ``device`` defaults to
the CUDA card and raises on a host without one
(``utils/torchsetup.py:resolve_device``).

    stage 1:  min c@x   s.t. A1 x {sense} b1,  lb1 <= x <= ub1
    stage 2:  min q@y   s.t. T x + W y {sense} r,  lb2 <= y <= ub2
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Optional

import numpy as np
import torch

from sqlp_tpu_torch.models.scenario import (SCENARIO_FIELDS, ScenarioModel,
                                            build_scenario_model,
                                            scenario_model_from_numpy)
from sqlp_tpu_torch.models.smps_cor import CorData, read_cor
from sqlp_tpu_torch.models.smps_sto import StoData, read_sto
from sqlp_tpu_torch.models.smps_tim import TimData, read_tim
from sqlp_tpu_torch.models.stage import (SENSE_G, SENSE_L, StageLP,
                                         get_smps_stage_template)
from sqlp_tpu_torch.utils.torchsetup import resolve_device

ARRAY_FIELDS = ("c", "A1", "b1", "senses1", "lb1", "ub1",
                "q", "W", "T", "r", "senses2", "lb2", "ub2")


@dataclasses.dataclass(frozen=True)
class InstanceArrays:
    """Dense blocks of the two-stage problem, on one device."""

    c: torch.Tensor        # [n1]
    A1: torch.Tensor       # [m1, n1]
    b1: torch.Tensor       # [m1]
    senses1: torch.Tensor  # [m1] int (+1 '>=', -1 '<=', 0 '==')
    lb1: torch.Tensor      # [n1]
    ub1: torch.Tensor      # [n1]
    q: torch.Tensor        # [n2]
    W: torch.Tensor        # [m2, n2]
    T: torch.Tensor        # [m2, n1]
    r: torch.Tensor        # [m2]
    senses2: torch.Tensor  # [m2] int
    lb2: torch.Tensor      # [n2]
    ub2: torch.Tensor      # [n2]


@dataclasses.dataclass(frozen=True)
class Instance:
    """A compiled two-stage SMPS instance (host metadata + tensors)."""

    name: str
    cor: CorData
    tim: TimData
    sto: StoData
    sp1: StageLP
    sp2: StageLP
    arrays: InstanceArrays
    scenario_model: ScenarioModel

    @property
    def n1(self) -> int:
        return self.sp1.n_cur

    @property
    def n2(self) -> int:
        return self.sp2.n_cur

    @property
    def m1(self) -> int:
        return self.sp1.n_rows

    @property
    def m2(self) -> int:
        # rows of the COMPILED system (bound-folding rows included)
        return int(self.arrays.W.shape[0])

    @property
    def n_rv(self) -> int:
        return self.scenario_model.n_rv

    @property
    def device(self) -> torch.device:
        return self.arrays.c.device


def arrays_from_numpy(fields, dtype: torch.dtype = torch.float32,
                      device="cuda") -> InstanceArrays:
    """InstanceArrays from a mapping of field name -> array-like (senses
    keep their integer type)."""
    device = resolve_device(device)
    out = {}
    for name in ARRAY_FIELDS:
        a = np.array(fields[name])
        if name.startswith("senses"):
            out[name] = torch.as_tensor(a, device=device)
        else:
            out[name] = torch.as_tensor(a, dtype=dtype, device=device)
    return InstanceArrays(**out)


def instance_from_numpy(src, dtype: Optional[torch.dtype] = None,
                        device="cuda") -> Instance:
    """The port's Instance from another compiled instance with the same
    attributes (the JAX package's ``Instance`` qualifies): its array
    fields are read with ``np.asarray`` and placed as tensors, the host
    metadata (parsed files, stage templates) is shared as is."""
    device = resolve_device(device)
    a = {f: np.asarray(getattr(src.arrays, f)) for f in ARRAY_FIELDS}
    if dtype is None:
        dtype = getattr(torch, str(a["c"].dtype))
    sm = src.scenario_model
    model = scenario_model_from_numpy(
        {f: np.asarray(getattr(sm, f)) for f in SCENARIO_FIELDS},
        has_cost=sm.has_cost, seed_valid=sm.seed_valid,
        cost_idx=sm.cost_idx, dtype=dtype, device=device)
    return Instance(name=src.name, cor=src.cor, tim=src.tim, sto=src.sto,
                    sp1=src.sp1, sp2=src.sp2,
                    arrays=arrays_from_numpy(a, dtype, device),
                    scenario_model=model)


def compile_instance(cor: CorData, tim: TimData, sto: StoData,
                     name: str = "", dtype: torch.dtype = torch.float32,
                     device="cuda", fold_bounds: bool = True) -> Instance:
    """Compile parsed SMPS data into dense tensors; finite stage-2 bounds
    are folded into explicit recourse rows (see the port of record)."""
    device = resolve_device(device)
    sp1 = get_smps_stage_template(cor, tim, 1)
    sp2 = get_smps_stage_template(cor, tim, 2)

    W2, T2, r2 = sp2.W, sp2.T, sp2.rhs
    senses2 = sp2.senses
    lb2, ub2 = sp2.lb.copy(), sp2.ub.copy()
    n2 = sp2.n_cur
    extra_rows = []            # (col j, rhs, sense)
    for j, vname in enumerate(sp2.cur_names):
        if np.isfinite(ub2[j]):
            if fold_bounds:
                extra_rows.append((j, ub2[j], SENSE_L))
                ub2[j] = np.inf
            else:
                warnings.warn(f"{vname} has non-trivial upper bound.")
        if lb2[j] != 0.0 and np.isfinite(lb2[j]):
            if fold_bounds:
                extra_rows.append((j, lb2[j], SENSE_G))
                lb2[j] = 0.0 if lb2[j] > 0.0 else -np.inf
            else:
                warnings.warn(f"{vname} has non-trivial lower bound.")
    if extra_rows:
        n_x = len(extra_rows)
        Wb = np.zeros((n_x, n2), W2.dtype)
        for i, (j, _, _) in enumerate(extra_rows):
            Wb[i, j] = 1.0
        W2 = np.concatenate([W2, Wb], axis=0)
        T2 = np.concatenate([T2, np.zeros((n_x, T2.shape[1]), T2.dtype)],
                            axis=0)
        r2 = np.concatenate([r2, np.array([b for (_, b, _) in extra_rows],
                                          r2.dtype)])
        senses2 = np.concatenate(
            [senses2, np.array([s for (_, _, s) in extra_rows],
                               senses2.dtype)])

    arrays = arrays_from_numpy(
        dict(c=sp1.c, A1=sp1.W, b1=sp1.rhs, senses1=sp1.senses, lb1=sp1.lb,
             ub1=sp1.ub, q=sp2.c, W=W2, T=T2, r=r2, senses2=senses2,
             lb2=lb2, ub2=ub2), dtype, device)
    model = build_scenario_model(sto, sp2, dtype=dtype, device=device,
                                 dual_system=(W2, r2, senses2))
    return Instance(name=name or cor.problem_name, cor=cor, tim=tim, sto=sto,
                    sp1=sp1, sp2=sp2, arrays=arrays, scenario_model=model)


# Search path for SMPS instance directories: the SQLP_TPU_SPINPUT
# environment variable, then the repository's instances/ directory.
_DEFAULT_SEARCH = (
    os.environ.get("SQLP_TPU_SPINPUT", ""),
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "instances"),
)


def find_instance_dir(name: str) -> Optional[str]:
    for root in _DEFAULT_SEARCH:
        if not root:
            continue
        path = os.path.join(root, name)
        if os.path.isfile(os.path.join(path, f"{name}.cor")):
            return path
    return None


def load_instance(name_or_dir: str, dtype: torch.dtype = torch.float32,
                  device="cuda", fold_bounds: bool = True) -> Instance:
    """Load an SMPS instance by name (searched) or by directory path."""
    device = resolve_device(device)
    if os.path.isdir(name_or_dir):
        path = name_or_dir
        name = os.path.basename(os.path.normpath(path))
    else:
        name = name_or_dir
        found = find_instance_dir(name)
        if found is None:
            raise FileNotFoundError(
                f"SMPS instance {name!r} not found under any of "
                f"{[p for p in _DEFAULT_SEARCH if p]}")
        path = found
    cor = read_cor(os.path.join(path, f"{name}.cor"))
    tim = read_tim(os.path.join(path, f"{name}.tim"))
    sto = read_sto(os.path.join(path, f"{name}.sto"))
    return compile_instance(cor, tim, sto, name=name, dtype=dtype,
                            device=device, fold_bounds=fold_bounds)


def load_proposal(inst: Instance, sto_path: str,
                  dtype: Optional[torch.dtype] = None) -> ScenarioModel:
    """Compile an alternate .sto file as an importance-sampling proposal
    over the instance's stage-2 template, on the instance's device.

    The proposal must cover the same random positions (row / column) as
    the instance's own model: the density ratio p_target / p_proposal is
    defined position by position. Raises ValueError otherwise. Used by
    ``SDSolver(proposal=...)`` and the CLI's ``--proposal-sto``.
    """
    sto = read_sto(sto_path)
    model = build_scenario_model(sto, inst.sp2,
                                 dtype=dtype or inst.arrays.r.dtype,
                                 device=inst.device)
    tgt = inst.scenario_model
    if model.n_rv != tgt.n_rv or not all(
            torch.equal(getattr(model, f).cpu(), getattr(tgt, f).cpu())
            for f in ("rv_row", "rv_is_rhs", "rv_col", "rv_is_cost",
                      "rv_ycol")):
        raise ValueError(
            f"proposal {sto_path} does not cover the same random "
            f"positions as instance {inst.name}'s sto file")
    return model
