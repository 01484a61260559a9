"""The least time the card could take for the work the program did, from
NVIDIA's published H100 SXM peaks (dense, at the 700 W power limit).

Frozen with the benchmark: a later change to the program's own copy of
this arithmetic does not move these numbers. The float64 peak is split:
the tile and stream kernels compute float64 on the tensor cores (FP64
``mma``, 67 TFLOP/s), every other float64 kernel on the CUDA cores
(34 TFLOP/s).

The least time of a piece of work is the larger of its operations over
the peak rate and its bytes over the HBM bandwidth, counting each operand
read once and each output written once.
"""

from __future__ import annotations

PEAK_FLOPS = {
    ("float32", "cuda_core"): 67e12,
    ("float64", "cuda_core"): 34e12,
    ("float64", "mma"): 67e12,
}
HBM_BYTES_PER_S = 3.35e12
ITEMSIZE = {"float32": 4, "float64": 8}
# the PDHG kernel variants that compute float64 on the tensor cores
MMA_VARIANTS = ("tile", "stream")


def least_s(flops: float, nbytes: float, dtype: str, unit: str) -> float:
    return max(flops / PEAK_FLOPS[dtype, unit], nbytes / HBM_BYTES_PER_S)


def pdhg_round(B: int, m: int, n: int, dtype: str, variant: str,
               steps: int = 80, halpern: bool = True) -> float:
    """Seconds one PDHG restart round of ``steps`` steps needs at least,
    for B rows of an [m, n] K: per row and step the two products K y and
    K' l (2 m n multiply-adds each); read once: K, q, lb, ub (n each),
    is_eq (m bytes), the right-hand sides, the step sizes and the
    iterates (Halpern: its anchors and step counters too); written once:
    the four [B, *] outputs."""
    it = ITEMSIZE[dtype]
    flops = 4.0 * m * n * B * steps
    per_row = (m + 2 + n + m) + ((1 + n + m) if halpern else 0)
    nbytes = it * (m * n + 3 * n + B * per_row) + m \
        + 2 * B * (m + n) * 2 * it
    unit = "mma" if dtype == "float64" and variant in MMA_VARIANTS \
        else "cuda_core"
    return least_s(flops, nbytes, dtype, unit)


def ef_step(R: int, S: int, m1: int, n1: int, m2: int, n2: int,
            dtype: str) -> float:
    """Seconds one step of the structured EF PDHG needs at least, for R
    extensive forms of S scenarios: the two structured products W Y' and
    U W (2 R S m2 n2 multiply-adds each; the first-stage blocks' T and A1
    products are left out, as they are a few hundredth of these); read
    once: the iterate (x, Y, u0, U), the right-hand sides, the
    per-scenario objective and bounds, W, T, A1 and the round's running
    sums; written once: the new iterate and the running sums."""
    it = ITEMSIZE[dtype]
    flops = 4.0 * R * S * m2 * n2
    it_el = R * (n1 + m1 + S * (n2 + m2))     # one iterate
    nbytes = it * (it_el                      # read the iterate
                   + R * S * m2               # right-hand sides
                   + 3 * S * n2               # objective, two bounds
                   + m2 * n2 + m2 * n1 + m1 * n1
                   + 2 * it_el                # running sums, read+write
                   + it_el)                   # the new iterate
    return least_s(flops, nbytes, dtype, "cuda_core")
