"""SMPS .cor (MPS core file) parser.

Copy of ``sqlp_tpu/models/smps_cor.py`` (port of record); ``read_cor``
goes through the native parser of ``models/native.py`` by default.

Behavioral port of record: src/smps/smps_cor.jl in the reference
(``_tokenize_cor`` :26-58, ``_parse_column_to_matrix`` :81-101,
``_parse_rhs`` :106-116, ``_parse_bounds`` :124-155, ``read_cor`` :160-194).
Same section set (NAME/ROWS/COLUMNS/RHS/BOUNDS/ENDATA), same defaults
(missing RHS entries are zero; missing lower bound is 0, missing upper bound
is +inf), same assertion that the first row is the objective ('N') row.

The template matrix is dense NumPy here (the reference uses a sparse CSC);
all shipped instances are small enough that dense is the right layout for a
TPU compile target.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

SUPPORTED_SECTIONS = ("NAME", "ROWS", "COLUMNS", "RHS", "BOUNDS", "ENDATA")
SUPPORTED_BOUND_TYPES = ("LO", "UP", "FX", "FR", "MI", "PL")


@dataclasses.dataclass
class CorData:
    """Parsed core file (reference ``spCorType``, smps_cor.jl:6-17)."""

    problem_name: str
    directions: List[str]          # one of 'N','G','L','E' per row
    row_names: List[str]
    col_names: List[str]
    template_matrix: np.ndarray    # [n_rows, n_cols], row 0 is the objective
    rhs: np.ndarray                # [n_rows]
    lower_bound: np.ndarray        # [n_cols]
    upper_bound: np.ndarray        # [n_cols]
    col_mapping: Dict[str, int]
    row_mapping: Dict[str, int]

    def __repr__(self) -> str:  # reference Base.show, smps_cor.jl:21
        return f"CorData {self.problem_name}"


def lookup_table(names: Sequence[str]) -> Dict[str, int]:
    """Name -> index map (reference ``lookup_table``, src/utils.jl:6-12)."""
    return {name: i for i, name in enumerate(names)}


def tokenize_cor(text: str) -> Dict[str, list]:
    """Split a cor file into per-section token lists (smps_cor.jl:26-58).

    Empty lines and '*' comment lines are dropped. A line is a section
    header iff its first character is not whitespace.
    """
    tokens: Dict[str, list] = {s: [] for s in SUPPORTED_SECTIONS}
    section = ""
    for line in text.splitlines():
        if not line or line[0] == "*":
            continue
        parts = line.split()
        if not parts:
            continue
        if line[0] not in (" ", "\t"):
            section = parts[0]
            if section not in SUPPORTED_SECTIONS:
                raise AssertionError(f"Unsupported cor section {section!r}")
            # NAME carries its value on the header line itself.
            if section == "NAME" and len(parts) > 1:
                tokens["NAME"].append(parts[1])
        else:
            tokens[section].append(parts)
    return tokens


def parse_row_tokens(tokens: list) -> tuple:
    """ROWS section -> (directions, row_names) (smps_cor.jl:63-67)."""
    directions = [t[0][0] for t in tokens]
    row_names = [t[1] for t in tokens]
    return directions, row_names


def parse_unique_columns(tokens: list) -> List[str]:
    """Column names in order of first appearance (smps_cor.jl:72-75)."""
    seen = {}
    for t in tokens:
        seen.setdefault(t[0], None)
    return list(seen.keys())


def parse_column_to_matrix(tokens: list, row_names: Sequence[str],
                           col_names: Sequence[str]) -> np.ndarray:
    """COLUMNS section -> dense template matrix (smps_cor.jl:81-101).

    Each data line is ``col row1 val1 [row2 val2]``; later entries overwrite
    earlier ones at the same position, as in the reference.
    """
    col_mapping = lookup_table(col_names)
    row_mapping = lookup_table(row_names)
    M = np.zeros((len(row_names), len(col_names)), dtype=np.float64)
    for t in tokens:
        j = col_mapping[t[0]]
        rest = t[1:]
        for k in range(0, len(rest) - 1, 2):
            i = row_mapping[rest[k]]
            M[i, j] = float(rest[k + 1])
    return M


def parse_rhs(tokens: list, row_names: Sequence[str]) -> np.ndarray:
    """RHS section -> dense vector, missing entries zero (smps_cor.jl:106-116)."""
    row_mapping = lookup_table(row_names)
    rhs = np.zeros(len(row_names), dtype=np.float64)
    for t in tokens:
        rest = t[1:]
        for k in range(0, len(rest) - 1, 2):
            rhs[row_mapping[rest[k]]] = float(rest[k + 1])
    return rhs


def parse_bounds(tokens: list, col_names: Sequence[str]) -> tuple:
    """BOUNDS section -> (lower, upper) (smps_cor.jl:124-155).

    Supported types: LO UP FX FR MI PL. Defaults: lb=0, ub=+inf.
    """
    col_mapping = lookup_table(col_names)
    lb = np.zeros(len(col_names), dtype=np.float64)
    ub = np.full(len(col_names), np.inf, dtype=np.float64)
    for t in tokens:
        btype = t[0]
        if btype not in SUPPORTED_BOUND_TYPES:
            raise AssertionError(
                f"Unsupported bound type {btype} for variable {t[2]}")
        j = col_mapping[t[2]]
        if btype == "LO":
            lb[j] = float(t[3])
        elif btype == "UP":
            ub[j] = float(t[3])
        elif btype == "FX":
            lb[j] = float(t[3])
            ub[j] = float(t[3])
        elif btype == "FR":
            lb[j] = -np.inf
            ub[j] = np.inf
        elif btype == "MI":
            lb[j] = -np.inf
        elif btype == "PL":
            ub[j] = np.inf
    return lb, ub


def read_cor(cor_path: str) -> CorData:
    """Read a cor file (smps_cor.jl:160-194) with the native C++ parser
    (``models/native.py``, built at first use), or with the Python parser
    under ``SQLP_TPU_TORCH_NATIVE=0``. Both give identical CorData."""
    from sqlp_tpu_torch.models import native
    if native.enabled():
        return native.read_cor_native(cor_path)
    return read_cor_py(cor_path)


def read_cor_py(cor_path: str) -> CorData:
    """Pure-Python cor parser (the behavioral port of record)."""
    with open(cor_path, "r") as f:
        tokens = tokenize_cor(f.read())
    problem_name = tokens["NAME"][0] if tokens["NAME"] else ""
    directions, row_names = parse_row_tokens(tokens["ROWS"])
    col_names = parse_unique_columns(tokens["COLUMNS"])
    template = parse_column_to_matrix(tokens["COLUMNS"], row_names, col_names)
    rhs = parse_rhs(tokens["RHS"], row_names)
    lb, ub = parse_bounds(tokens["BOUNDS"], col_names)
    if directions[0] != "N":
        raise AssertionError(
            f"First row of cor file is not objective. {directions}")
    return CorData(
        problem_name=problem_name,
        directions=directions,
        row_names=row_names,
        col_names=col_names,
        template_matrix=template,
        rhs=rhs,
        lower_bound=lb,
        upper_bound=ub,
        col_mapping=lookup_table(col_names),
        row_mapping=lookup_table(row_names),
    )
