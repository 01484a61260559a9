"""The kernels' plan functions: which variant each wrapper launches for a
shape, from the shapes, the dtype and (for the Halpern round) the card's
cluster occupancy.

The expected variants are the ones the H100 measurements chose
(``chip_smoke.py --phases sweep``; PERF.md): the cluster Halpern round for
the small panels of an instance whose K does not fit L1, the row-block
round for large panels and small K, and the master on a cluster of 8
(one block for a master as small as lands').
"""

import pytest
import torch

from sqlp_tpu_torch.models.instance import load_instance
from sqlp_tpu_torch.ops.cuda import admm_kernel, pdhg_kernel

torch.set_num_threads(1)

_SHAPES = {}

# cudaOccupancyMaxActiveClusters of the cluster Halpern round on an NVIDIA
# H100 80GB HBM3 (132 SMs), the same at every (R, dtype) footprint the
# plan admits: one CTA per SM (chip_smoke.py --phases sweep prints it)
H100_CLUSTERS_PER_WAVE = {4: 30, 8: 15, 16: 7}


@pytest.fixture
def h100(monkeypatch):
    """The plan as it decides on the H100, on any host."""
    monkeypatch.setattr(pdhg_kernel, "_clusters_per_wave",
                        lambda C, R, m, n, itemsize:
                        H100_CLUSTERS_PER_WAVE[C])
    pdhg_kernel._plan.cache_clear()
    yield
    pdhg_kernel._plan.cache_clear()


def _shape(name):
    """(m2, n2) of the instance's compiled recourse system."""
    if name not in _SHAPES:
        W = load_instance(name, dtype=torch.float64, device="cpu").arrays.W
        _SHAPES[name] = tuple(W.shape)
    return _SHAPES[name]


ROWS1, ROWS2, ROWS4 = ("rows", 1), ("rows", 2), ("rows", 4)
# (instance, itemsize) -> the plan at B = 2, 16, 4096
_PDHG = {
    ("lands", 4): (ROWS1, ROWS1, ROWS4),
    ("lands", 8): (ROWS1, ROWS1, ROWS4),
    ("transship", 4): (ROWS1, ROWS1, ROWS4),
    ("transship", 8): (ROWS1, ROWS1, ROWS4),
    ("ssn", 4): (("cluster", 16, 1), ("cluster", 4, 1), ROWS4),
    ("ssn", 8): (("cluster", 16, 1), ("cluster", 8, 2), ROWS4),
    ("storm", 4): (("cluster", 16, 1), ("cluster", 16, 1), ROWS4),
    ("storm", 8): (ROWS1, ROWS1, ROWS2),
}


@pytest.mark.parametrize("B", [2, 16, 4096])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("name", ["lands", "transship", "ssn", "storm"])
def test_pdhg_plan(h100, name, itemsize, B):
    """The Halpern round's variant at the SD step's panel (B = 2), a short
    ladder tail (16) and the MC panel (4096). Small K stays on the
    row-block kernel; ssn's 2-row panel takes a cluster of 16 per row
    (measured faster than 8), B = 16 one wave of 4-CTA clusters in f32 and
    of 8-CTA clusters with 2 rows in f64; storm's f32 K fits only 16 CTAs
    and its f64 K (5.3 MB) no cluster at all. A cluster plan's slice fits
    a CTA's shared memory and its lane arrays the register budget."""
    m, n = _shape(name)
    plan = pdhg_kernel._plan(B, m, n, itemsize)
    assert plan == _PDHG[(name, itemsize)][(2, 16, 4096).index(B)]
    if plan[0] == "cluster":
        _, C, R = plan
        assert pdhg_kernel._cluster_fits(C, R, m, n, itemsize)
        assert pdhg_kernel._cluster_smem(C, R, m, n, itemsize, R) \
            <= 227 * 1024
        assert pdhg_kernel._waves(B, C, R, m, n, itemsize) \
            <= pdhg_kernel._CLUSTER_MAX_WAVES


def test_pdhg_plan_on_the_mc_ladder(h100):
    """ssn's MC ladder (4096, 1024, 256): the 256-row rung fits three waves
    of 4-CTA clusters in f32 and takes the cluster kernel (measured faster
    there); past three waves, and in f64 at 256, the row-block kernel."""
    m, n = _shape("ssn")
    assert pdhg_kernel._plan(256, m, n, 4) == ("cluster", 4, 4)
    assert pdhg_kernel._plan(1024, m, n, 4)[0] == "rows"
    assert pdhg_kernel._plan(256, m, n, 8)[0] == "rows"


@pytest.mark.parametrize("name", ["lands", "transship"])
def test_pdhg_plan_small_k_never_asks_the_card(name, monkeypatch):
    """A K under _CLUSTER_MIN_K_BYTES takes the row-block kernel without
    asking the card for its cluster occupancy, on any host."""
    def refuse(*args):
        raise AssertionError("the plan asked the card")
    monkeypatch.setattr(pdhg_kernel, "_clusters_per_wave", refuse)
    pdhg_kernel._plan.cache_clear()
    m, n = _shape(name)
    try:
        for B in (2, 16, 4096):
            assert pdhg_kernel._plan(B, m, n, 8)[0] == "rows"
    finally:
        pdhg_kernel._plan.cache_clear()


# (mA, nz) of the SD masters at K = 96 cuts: ssn, storm, and lands'
# small master
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("mA,nz,C", [(187, 90, 8), (403, 122, 8),
                                     (101, 5, 1)])
def test_admm_plan(mA, nz, C, itemsize):
    """B3's cluster size: 8 CTAs for the ssn and storm masters, one block
    for lands' small master (each measured fastest); each CTA's slices fit
    its shared memory, and no smaller cluster would hold storm's f64
    master in fewer than 4."""
    assert admm_kernel._plan(mA, nz, itemsize) == C
    assert admm_kernel._smem_bytes(C, mA, nz, itemsize) <= 227 * 1024
    if (mA, nz, itemsize) == (403, 122, 8):
        assert admm_kernel._smem_bytes(2, mA, nz, itemsize) > 227 * 1024


def test_admm_plan_refuses_a_master_too_large():
    """A master whose slices miss even a cluster of 8 raises at the plan,
    before any launch."""
    with pytest.raises(ValueError, match="does not fit"):
        admm_kernel._plan(4000, 600, 8)
