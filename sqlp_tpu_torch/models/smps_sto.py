"""SMPS .sto (stochastic file) parser + host-side sampling.

Copy of ``sqlp_tpu/models/smps_sto.py`` (port of record); ``read_sto``
goes through the native parser of ``models/native.py`` by default.

Behavioral port of record: src/smps/smps_sto.jl in the reference
(distribution types :4-28, ``spStoType`` :33-36, ``read_sto`` :41-111,
``rand`` overloads :117-149).

Only the INDEP section with univariate DISCRETE / NORMAL / UNIFORM marginals
is supported, exactly as in the reference. A scenario is an ordered list of
``(Position, value)`` pairs, one per independent random position. Position
order is the order of first appearance in the sto file (Python dicts are
insertion-ordered; the reference's Julia Dict order was merely fixed-per-load
— our order is additionally deterministic across runs).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple, Union

import numpy as np

from sqlp_tpu_torch.models.smps_tim import Position

SUPPORTED_SECTIONS = ("STOCH", "INDEP", "ENDATA")


@dataclasses.dataclass
class DiscreteDistribution:
    """Scalar discrete marginal (smps_sto.jl:9-12)."""

    value: List[float]
    probability: List[float]


@dataclasses.dataclass(frozen=True)
class NormalDistribution:
    """Scalar normal marginal with mean/variance (smps_sto.jl:17-20)."""

    mean: float
    variance: float


@dataclasses.dataclass(frozen=True)
class UniformDistribution:
    """Scalar uniform marginal on [left, right] (smps_sto.jl:25-28)."""

    left: float
    right: float


IndepDistribution = Union[DiscreteDistribution, NormalDistribution,
                          UniformDistribution]

# A scenario: ordered (position, value) pairs (smps_sto.jl:135).
Scenario = List[Tuple[Position, float]]


@dataclasses.dataclass
class StoData:
    """Parsed sto file (smps_sto.jl:33-36)."""

    problem_name: str
    indep: Dict[Position, IndepDistribution]


def read_sto(sto_path: str) -> StoData:
    """Read a sto file (smps_sto.jl:41-111) with the native C++ parser
    (``models/native.py``, built at first use), or with the Python parser
    under ``SQLP_TPU_TORCH_NATIVE=0``. Both give identical StoData."""
    from sqlp_tpu_torch.models import native
    if native.enabled():
        return native.read_sto_native(sto_path)
    return read_sto_py(sto_path)


def read_sto_py(sto_path: str) -> StoData:
    with open(sto_path, "r") as f:
        lines = [l for l in f.read().splitlines() if l and l[0] != "*"]

    section = ""
    section_keywords: List[str] = []
    problem_name = ""
    indep: Dict[Position, IndepDistribution] = {}

    for line in lines:
        parts = line.split()
        if not parts:
            continue
        if line[0] in (" ", "\t"):
            if section != "INDEP":
                continue
            pos = Position(parts[0], parts[1])
            if len(section_keywords) > 1:
                raise ValueError(
                    f"Trailing/unsupported section keywords {section_keywords}")
            kind = section_keywords[0]
            if kind == "UNIFORM":
                indep[pos] = UniformDistribution(float(parts[2]), float(parts[3]))
            elif kind == "NORMAL":
                indep[pos] = NormalDistribution(float(parts[2]), float(parts[3]))
            elif kind == "DISCRETE":
                if pos not in indep:
                    indep[pos] = DiscreteDistribution([], [])
                d = indep[pos]
                assert isinstance(d, DiscreteDistribution)
                d.value.append(float(parts[2]))
                d.probability.append(float(parts[3]))
            else:
                raise ValueError(
                    f"Unknown or unsupported section keywords {section_keywords}")
        else:
            section = parts[0]
            if section not in SUPPORTED_SECTIONS:
                raise AssertionError(f"Unsupported sto section {section!r}")
            section_keywords = parts[1:]
            if section == "STOCH" and section_keywords:
                problem_name = section_keywords[0]

    return StoData(problem_name=problem_name, indep=indep)


def sample_marginal(rng: np.random.Generator, dist: IndepDistribution) -> float:
    """Draw one value from a marginal (smps_sto.jl:117-130)."""
    if isinstance(dist, DiscreteDistribution):
        p = np.asarray(dist.probability, dtype=np.float64)
        return float(rng.choice(np.asarray(dist.value), p=p / p.sum()))
    if isinstance(dist, NormalDistribution):
        return float(rng.normal(dist.mean, np.sqrt(dist.variance)))
    if isinstance(dist, UniformDistribution):
        return float(rng.uniform(dist.left, dist.right))
    raise TypeError(f"Unknown distribution {type(dist)}")


def sample_scenario(rng: np.random.Generator, sto: StoData) -> Scenario:
    """Draw a full scenario, one value per position (smps_sto.jl:140-149).

    Host-side sampler used by tests, the crash heuristic and the API-parity
    layer; the device sampler lives in sqlp_tpu_torch/models/scenario.py.
    """
    return [(pos, sample_marginal(rng, d)) for pos, d in sto.indep.items()]
