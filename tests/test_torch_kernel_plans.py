"""The kernels' plan functions: which variant each wrapper launches for a
shape, from the shapes, the dtype and (for the PDHG rounds) the card's
cluster occupancy.

The expected variants are the ones the H100 measurements chose
(``chip_smoke.py --phases sweep``; PERF.md): for either PDHG round the
cluster kernel for the small panels of an instance whose K does not fit
L1, the tile kernel for its large panels, the stream kernel for a K whose
slices fit no cluster (storm) in float64, the grid kernel for such a K's
float32 panels past the cluster kernel's, the small kernel for a K under
128 KB (K resident in one block's shared memory), the row-block kernel
for what no other variant takes, and the master on a cluster of 8 (one
block for a master as small as lands').
"""

import pytest
import torch

from sqlp_tpu_torch.models.instance import load_instance
from sqlp_tpu_torch.ops.cuda import admm_kernel, pdhg_kernel

torch.set_num_threads(1)

_SHAPES = {}
SMEM_MAX = 227 * 1024

# cudaOccupancyMaxActiveClusters of the cluster, tile and stream kernels
# on an NVIDIA H100 80GB HBM3 (132 SMs), the same at every footprint the
# plans admit: one CTA per SM (chip_smoke.py --phases sweep prints it)
H100_CLUSTERS_PER_WAVE = {3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15, 16: 7}


@pytest.fixture
def h100(monkeypatch):
    """The plans as they decide on the H100, on any host."""
    monkeypatch.setattr(pdhg_kernel, "_clusters_per_wave",
                        lambda C, *rest: H100_CLUSTERS_PER_WAVE[C])
    monkeypatch.setattr(pdhg_kernel, "_tile_clusters_per_wave",
                        lambda C, *rest: H100_CLUSTERS_PER_WAVE[C])
    monkeypatch.setattr(pdhg_kernel, "_stream_clusters_per_wave",
                        lambda C, *rest: H100_CLUSTERS_PER_WAVE[C])
    monkeypatch.setattr(pdhg_kernel, "_sm_count", lambda: 132)
    pdhg_kernel._plan.cache_clear()
    yield
    pdhg_kernel._plan.cache_clear()


def _shape(name):
    """(m2, n2) of the instance's compiled recourse system."""
    if name not in _SHAPES:
        W = load_instance(name, dtype=torch.float64, device="cpu").arrays.W
        _SHAPES[name] = tuple(W.shape)
    return _SHAPES[name]


INSTANCES = ["lands", "transship", "baa99-20", "ssn", "storm"]
# every shipped instance whose K is under 128 KB
SMALL_INSTANCES = ["lands", "transship", "baa99-20", "farmer", "newsvendor",
                   "newsprice", "saleslim"]
PANELS = (2, 16, 256, 4096)
ROWS1, ROWS2, ROWS4 = ("rows", 1), ("rows", 2), ("rows", 4)
F32 = "fma"     # the tile kernels' float32 arithmetic
# a K under 128 KB: the small kernel. While a panel gives each SM at most
# 2 rows, a group carries 1 row on n / 16 warps rounded up to a power of 2
# and at most 8 (lands 1, transship 8, baa99-20 8); at the MC panel (31
# rows an SM) 4 rows on a quarter of those warps
_SMALL_W = {"lands": 1, "transship": 8, "baa99-20": 8, "farmer": 1,
            "newsvendor": 1, "newsprice": 1, "saleslim": 1}


def _small_k(name):
    W = _SMALL_W[name]
    return (("small", W, 1), ("small", W, 1), ("small", W, 1),
            ("small", max(1, W // 4), 4))


# (instance, itemsize) -> the Halpern round's plan at B = 2, 16, 256, 4096
_PDHG = {
    **{(name, it): _small_k(name) for name in INSTANCES[:3]
       for it in (4, 8)},
    ("ssn", 4): (("cluster", 16, 1), ("cluster", 4, 1), ("tile", 4, F32),
                 ("tile", 4, F32)),
    ("ssn", 8): (("cluster", 16, 1), ("cluster", 8, 2), ("tile", 8, "mma"),
                 ("tile", 8, "mma")),
    ("storm", 4): (("cluster", 16, 1), ("cluster", 16, 1),
                   ("grid", 64, 1), ("grid", 128, 4)),
    ("storm", 8): (("stream", 16, 16),) * 4,
}


def _check_admitted(plan, B, m, n, itemsize, scheme):
    """A cluster, tile, stream or grid plan's footprint fits a CTA and its
    registers; a stream plan names a cluster size the kernel is launched
    with and tiles of 16 rows; a grid plan a float32 panel and a primal
    tile height the kernel has."""
    if plan[0] == "cluster":
        _, C, R = plan
        assert pdhg_kernel._cluster_fits(C, R, m, n, itemsize, scheme)
        assert pdhg_kernel._cluster_smem(C, R, m, n, itemsize, R, scheme) \
            <= SMEM_MAX
        assert pdhg_kernel._waves(B, C, R, m, n, itemsize, scheme) \
            <= max(pdhg_kernel._CLUSTER_MAX_WAVES,
                   pdhg_kernel._CLUSTER_MAX_WAVES_VS_STREAM)
    elif plan[0] == "tile":
        _, C, arith = plan
        assert arith == pdhg_kernel._TILE_ARITH[itemsize]
        assert pdhg_kernel._tile_smem(C, m, n, itemsize) <= SMEM_MAX
    elif plan[0] == "stream":
        _, C, TM = plan
        assert C in pdhg_kernel._STREAM_SIZES and TM == 16
        assert itemsize in pdhg_kernel._STREAM_ITEMSIZES
        assert 0 < pdhg_kernel._stream_smem(C, m, n, itemsize) <= SMEM_MAX
        assert pdhg_kernel._stream_fits(C, TM, m, n, itemsize)
    elif plan[0] == "small":
        _, W, R = plan
        assert itemsize in pdhg_kernel._SMALL_ITEMSIZES
        assert m * n * itemsize < pdhg_kernel._CLUSTER_MIN_K_BYTES
        assert pdhg_kernel._small_fits(W, R, 1, m, n, itemsize)
        G = pdhg_kernel._small_groups(B, W, R, m, n, itemsize)
        assert G * W <= pdhg_kernel._SMALL_MAX_WARPS
        assert pdhg_kernel._small_smem(R, G, m, n, itemsize) <= SMEM_MAX
    elif plan[0] == "grid":
        _, BM, P = plan
        assert itemsize == 4 and itemsize in pdhg_kernel._GRID_ITEMSIZES
        assert BM in pdhg_kernel._GRID_BM and P in pdhg_kernel._GRID_PARTS
        assert pdhg_kernel._grid_fits(BM, itemsize, P)
        assert 0 < pdhg_kernel._grid_smem(BM, itemsize) <= SMEM_MAX
    else:
        assert plan[0] == "rows" and plan[1] in (1, 2, 4)


@pytest.mark.parametrize("B", PANELS)
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("name", INSTANCES)
def test_pdhg_plan(h100, name, itemsize, B):
    """The Halpern round's variant at the SD step's panel (B = 2), a short
    ladder tail (16), a ladder rung (256) and the MC panel (4096). A K
    under 128 KB takes the small kernel; ssn's 2-row panel takes a cluster of 16
    per row (measured faster than 8), B = 16 one wave of 4-CTA clusters in
    f32 and of 8-CTA clusters with 2 rows in f64, and from B = 256 the tile
    kernel on 30 clusters of 4 (f32) or 15 of 8 (f64: K's f64 slices need
    8 CTAs); storm's f32 K fits only the cluster kernel at 16 CTAs and no
    tile shape, so past 12 waves of the cluster kernel its panels take the
    grid kernel (primal tiles of 64 rows at 256, of 128 at the MC panel;
    measured ahead of the stream kernel from 100 rows); its f64 K (5.3 MB)
    fits no cluster at all: every panel streams on clusters of 16."""
    m, n = _shape(name)
    plan = pdhg_kernel._plan(B, m, n, itemsize)
    assert plan == _PDHG[(name, itemsize)][PANELS.index(B)]
    _check_admitted(plan, B, m, n, itemsize, "halpern")


@pytest.mark.parametrize("B", PANELS)
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("name", INSTANCES)
def test_average_plan(h100, name, itemsize, B):
    """The average round's variant at the same panels (16 is the replicated
    SD step's panel at 8 replications). Its cluster, tile and stream
    kernels take what the Halpern round's take (the stream kernels' shared
    memory is the same under either scheme), but storm's f64 MC panel goes
    to the row-block kernel, which carries 4 rows a block under this
    scheme (3 vectors of each length a row, against the Halpern round's
    4) and measured faster there than the stream kernel."""
    m, n = _shape(name)
    plan = pdhg_kernel._plan(B, m, n, itemsize, "average")
    want = _PDHG[(name, itemsize)][PANELS.index(B)]
    if (name, itemsize, B) == ("storm", 8, 4096):
        want = ROWS4
    assert plan == want
    _check_admitted(plan, B, m, n, itemsize, "average")


def test_pdhg_plan_on_the_mc_ladder(h100):
    """ssn's MC ladder (4096, 1024, 768, 512, 256) takes the tile kernel on
    every rung, in f32 and f64; its tails split at what one wave of
    clusters of at most 2 rows holds: 60 rows in f32 (30 clusters of 4),
    30 in f64 (15 of 8). A single pass of tiles takes the largest cluster
    (more SMs per tile), several passes the smallest that fits (more tiles
    at once)."""
    m, n = _shape("ssn")
    for B in (4096, 1024, 768, 512, 256):
        assert pdhg_kernel._plan(B, m, n, 4) == ("tile", 4, F32)
        assert pdhg_kernel._plan(B, m, n, 8) == ("tile", 8, "mma")
    assert pdhg_kernel._plan(60, m, n, 4) == ("cluster", 4, 2)
    assert pdhg_kernel._plan(64, m, n, 4) == ("tile", 16, F32)
    assert pdhg_kernel._plan(30, m, n, 8) == ("cluster", 8, 2)
    assert pdhg_kernel._plan(32, m, n, 8) == ("tile", 16, "mma")


@pytest.mark.parametrize("name", ["lands", "transship"])
def test_pdhg_plan_small_k_never_asks_the_card(name, monkeypatch):
    """A K under _CLUSTER_MIN_K_BYTES takes the small kernel without
    asking the card for its cluster occupancy (only for its SM count), on
    any host."""
    def refuse(*args):
        raise AssertionError("the plan asked the card")
    monkeypatch.setattr(pdhg_kernel, "_clusters_per_wave", refuse)
    monkeypatch.setattr(pdhg_kernel, "_tile_clusters_per_wave", refuse)
    monkeypatch.setattr(pdhg_kernel, "_sm_count", lambda: 132)
    pdhg_kernel._plan.cache_clear()
    m, n = _shape(name)
    try:
        for scheme in ("halpern", "average"):
            for B in (2, 16, 4096):
                assert pdhg_kernel._plan(B, m, n, 8, scheme)[0] == "small"
    finally:
        pdhg_kernel._plan.cache_clear()


def _tile_smem_by_region(C, m, n, itemsize):
    """csrc/pdhg_tile.cuh:layout, region by region."""
    TM = 16
    nc = (n + C - 1) // C
    ncp = (nc + 7) // 8 * 8
    mp = (m + 7) // 8 * 8
    mc = (mp // 8 + C - 1) // C * 8
    # float32 keeps L and Yb row-major, each row 4 elements past its
    # padded width (a row stride of 4 mod 8: conflict-free 16-byte loads)
    pad = 4 if itemsize == 4 else 0
    # K's 8 x 8 blocks: float32 pads each to 72 elements and a column of
    # blocks to 16 mod 32 (the 16-byte words a quarter warp reads from
    # neighbouring units' blocks fall in distinct banks)
    nit = mp // 8
    sj = nit * 64 if itemsize == 8 else nit * 72 + (16 - nit * 72 % 32) % 32
    assert itemsize == 8 or sj % 32 == 16
    regions = {
        "Ks": ncp // 8 * sj, "Lf": TM * (mp + pad), "Rx": C * TM * mc,
        "Yb": TM * (ncp + pad),
        "Yc": TM * (ncp + 4), "Ya": TM * (ncp + 4), "La": TM * mc,
        "hs": TM * mc, "lbs": ncp, "ubs": ncp, "qs": ncp, "rows": 5 * TM}
    assert all(v % 4 == 0 for v in regions.values())   # 16-byte loads
    return sum(regions.values()) * itemsize


@pytest.mark.parametrize("arith", ["fma", "mma", "tf32x3", "dmma",
                                   "tf32x6"])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("name", INSTANCES)
def test_tile_smem_mirrors_the_kernel_layout(name, itemsize, arith):
    """_tile_smem is the sum of the kernel's shared-memory regions at
    every cluster size, and _tile_fits admits exactly the sizes under
    227 KB for the dtype's own arithmetic (FP32 FMAs in f32, FP64 matrix
    instructions in f64): ssn from 4 CTAs in f32, from 8 in f64, nothing
    for storm; and never another arithmetic, 3xTF32 and the other
    candidates measured on these tiles (dmma, tf32x6) included."""
    m, n = _shape(name)
    own = arith == pdhg_kernel._TILE_ARITH[itemsize]
    fits = set()
    for C in (1, 4, 8, 16):
        want = _tile_smem_by_region(C, m, n, itemsize)
        assert pdhg_kernel._tile_smem(C, m, n, itemsize) == want
        assert pdhg_kernel._tile_fits(C, m, n, itemsize, arith) \
            == (own and want <= SMEM_MAX)
        if want <= SMEM_MAX:
            fits.add(C)
    if name == "ssn":
        assert fits == ({4, 8, 16} if itemsize == 4 else {8, 16})
    if name == "storm":
        assert not fits


@pytest.mark.parametrize("R", [1, 2, 4, 8])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("name", ["ssn", "storm"])
def test_average_cluster_counts_its_own_footprint(name, itemsize, R):
    """The average scheme's cluster kernel keeps 2 [nc] and 3 [m] vectors
    per row where the Halpern one keeps 3 and 4 (no anchors, no separate
    candidate), the same K slice, scratch and exchange buffers, and the
    same lane arrays: (2 R + 1) MI values against 108 registers."""
    m, n = _shape(name)
    for C in pdhg_kernel._CLUSTER_SIZES:
        nc = -(-n // C)
        halpern = pdhg_kernel._cluster_smem(C, R, m, n, itemsize, R)
        average = pdhg_kernel._cluster_smem(C, R, m, n, itemsize, R,
                                            "average")
        assert halpern - average == R * (nc + m) * itemsize
        regs_ok = (2 * R + 1) * pdhg_kernel._cluster_mi(m) * itemsize // 4 \
            <= pdhg_kernel._CLUSTER_REGS
        for scheme, smem in (("halpern", halpern), ("average", average)):
            assert pdhg_kernel._cluster_fits(C, R, m, n, itemsize, scheme) \
                == (regs_ok and smem <= SMEM_MAX)


@pytest.mark.parametrize("scheme", ["halpern", "average"])
@pytest.mark.parametrize("plan", [("wgmma", 4, "mma"), ("tile", 4), ("rows",),
                                  "tile", None, ("cluster", 4, 1, 1)])
def test_launch_refuses_an_unknown_plan(scheme, plan):
    """A plan= override that names no variant raises before anything is
    built or launched, on any host."""
    K = torch.zeros((7, 12))
    with pytest.raises(ValueError, match="unknown plan"):
        pdhg_kernel._launch(scheme, plan, K, (), 8, 7, 12, 80)


def test_plan_refuses_an_unknown_scheme():
    with pytest.raises(ValueError, match="unknown scheme"):
        pdhg_kernel._plan(16, 175, 706, 4, "polyak")


@pytest.mark.parametrize("plan", [("tile", 1, "tf32x3"), ("tile", 1, "fma"),
                                  ("tile", 4, "mma"), ("tile", 4, "bf16x3"),
                                  ("tile", 4, 16), ("tile", 6, "tf32x6"),
                                  ("tile", 4, "dmma"), ("tile", 3, "fma"),
                                  ("tile", 4, "fma", 0),
                                  ("tile", 4, "fma", 17),
                                  ("tile", 4, "fma", 8.0),
                                  ("tile", 4, "fma", 16.0),
                                  ("tile", 1, "fma", 8)])
def test_launch_refuses_a_tile_plan_the_kernel_does_not_take(plan):
    """A forced tile plan whose footprint misses a CTA's shared memory,
    whose arithmetic the dtype does not have, or whose tile height is not
    1 to 16 rows, raises at the wrapper, before the card is asked."""
    K = torch.zeros((175, 706))
    with pytest.raises(ValueError, match="no tile kernel"):
        pdhg_kernel._launch("halpern", plan, K, (), 64, 175, 706, 80)


@pytest.mark.parametrize("tm", [1, 8, 15, 17])
def test_launch_refuses_a_float64_tile_shorter_than_16_rows(tm):
    """float64 tiles are the matrix instruction's 16 rows: a forced plan of
    another height raises at the wrapper, before the card is asked."""
    K = torch.zeros((175, 706), dtype=torch.float64)
    with pytest.raises(ValueError, match="no tile kernel"):
        pdhg_kernel._launch("average", ("tile", 8, "mma", tm), K, (), 64,
                            175, 706, 80)

def test_tile_shape_per_arithmetic(h100):
    """_tile_shape names the dtype's own arithmetic: ssn's MC panel on 30
    clusters of 4 under FP32 FMAs, on 15 of 8 under FP64 matrix
    instructions; nothing for storm in float32."""
    m, n = _shape("ssn")
    assert pdhg_kernel._tile_shape(4096, m, n, 4) == (4, F32)
    assert pdhg_kernel._tile_shape(4096, m, n, 4, "average") == (4, F32)
    assert pdhg_kernel._tile_shape(4096, m, n, 8, "average") == (8, "mma")
    assert pdhg_kernel._tile_shape(4096, *_shape("storm"), 4) is None


@pytest.mark.parametrize("B,passes", [(256, 1), (512, 2), (768, 2),
                                      (1024, 3), (4096, 9)])
def test_tile_passes_on_the_ladder(h100, B, passes):
    """ssn's f32 MC ladder on the H100's occupancy: each rung's cluster
    size gives the fewest passes any size that fits gives, and is the
    largest size that gives them. On 30 clusters of 4 the 256-row rung's
    16 tiles take one pass (on 64 SMs), 512 and 768 rows two, 1024 three
    and 4096 nine; 15 clusters of 8 would take two passes at 256 rows."""
    m, n = _shape("ssn")
    sizes = [C for C in pdhg_kernel._CLUSTER_SIZES
             if pdhg_kernel._tile_fits(C, m, n, 4, F32)]
    C = pdhg_kernel._tile_shape(B, m, n, 4)[0]
    assert pdhg_kernel._tile_passes(B, C, m, n, 4) == passes
    fewest = min(pdhg_kernel._tile_passes(B, c, m, n, 4) for c in sizes)
    assert passes == fewest
    assert C == max(c for c in sizes
                    if pdhg_kernel._tile_passes(B, c, m, n, 4) == fewest)
    assert C == 4


@pytest.mark.parametrize("scheme", ["halpern", "average"])
@pytest.mark.parametrize("B", [256, 512, 700, 768, 1024, 4096, 8000, 8192,
                               16000, 16384, 48000])
def test_tile_plan_keeps_the_cluster_size_per_dtype(h100, scheme, B):
    """The cluster size sets the column split and the order in which the
    owner sums the C shares, so it sets the bits: the redesigned tile kernel
    keeps the first design's footprint class, and the plan keeps its sizes, 4 CTAs in
    float32 and 8 in float64 at every panel of ssn's ladder and polish
    routes (every 16-row pass count unchanged), none for storm."""
    m, n = _shape("ssn")
    assert pdhg_kernel._tile_shape(B, m, n, 4, scheme) == (4, F32)
    assert pdhg_kernel._tile_shape(B, m, n, 8, scheme) == (8, "mma")
    assert pdhg_kernel._tile_shape(B, *_shape("storm"), 4, scheme) is None
    for itemsize, C in ((4, 4), (8, 8)):
        per_wave = H100_CLUSTERS_PER_WAVE[C]
        assert pdhg_kernel._tile_passes(B, C, m, n, itemsize, scheme) \
            == -(-(-(-B // 16)) // per_wave)


# ssn's float32 panels on 30 clusters of 4: (B, tile rows); the 16-row
# passes stay (256: 1, 512 and 768: 2, 1024: 3, 4096: 9, 8192: 18)
_SSN_TILE_ROWS = ((1, 1), (100, 4), (256, 9), (512, 9), (700, 12),
                  (768, 13), (1024, 12), (4096, 16), (8192, 16),
                  (16384, 16), (48000, 16))


@pytest.mark.parametrize("B,tm", _SSN_TILE_ROWS)
def test_tile_rows_spread_a_panel_over_the_card(h100, B, tm):
    """float32 tiles are as short as the 16-row passes allow: the tiles of
    tm rows cover the panel in the same passes on the clusters the card
    runs at once, and one row fewer would take another pass; float64 keeps
    16 rows."""
    m, n = _shape("ssn")
    for scheme in ("halpern", "average"):
        assert pdhg_kernel._tile_rows(B, 4, m, n, 4, scheme) == tm
        assert pdhg_kernel._tile_rows(B, 8, m, n, 8, scheme) == 16
    passes = pdhg_kernel._tile_passes(B, 4, m, n, 4)
    per_wave = H100_CLUSTERS_PER_WAVE[4]
    assert 1 <= tm <= 16
    assert -(-(-(-B // tm)) // per_wave) == passes
    if tm > 1:
        assert -(-(-(-B // (tm - 1))) // per_wave) > passes


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


@pytest.mark.parametrize("scheme", ["halpern", "average"])
def test_every_panel_gets_an_admitted_plan(h100, scheme):
    """Every instance of the table, both dtypes, the SD panels and the MC
    ladder's rungs (1 to 4096 rows) get a plan whose variant takes the
    shapes."""
    for name in INSTANCES:
        m, n = _shape(name)
        for itemsize in (4, 8):
            for B in (1, 2, 16, 64, 100, 256, 512, 768, 1024, 4096):
                plan = pdhg_kernel._plan(B, m, n, itemsize, scheme)
                _check_admitted(plan, B, m, n, itemsize, scheme)


def _stream_smem_by_region(C, m, n, itemsize):
    """csrc/pdhg_stream.cuh:layout, region by region, its stages and their
    mbarriers (32 bytes); a CTA's columns start 16 bytes apart."""
    TM = 16
    v = 16 // itemsize
    nc = -(-(-(-n // C)) // v) * v

    def up4(x):
        return -(-x // 4) * 4
    if itemsize == 4:
        mc = -(-m // C)
        regions = {"L": up4(m * TM), "Yt": up4(n * TM), "Y": up4(TM * nc),
                   "Ya": up4(TM * nc), "La": up4(mc * TM),
                   "hs": up4(mc * TM), "lbs": up4(nc), "ubs": up4(nc),
                   "qs": up4(nc), "rows": 3 * TM}
        stage = 4096
    else:
        ncp, mp = -(-nc // 8) * 8, -(-m // 8) * 8
        mc = (-(-m // C) + 1) // 2 * 2
        regions = {"Lf": TM * mp, "Rx": up4(C * TM * mc), "Yb": TM * ncp,
                   "Y": TM * (ncp + 4), "Ya": TM * (ncp + 4),
                   "La": up4(TM * mc), "hs": up4(TM * mc), "lbs": ncp,
                   "ubs": ncp, "qs": ncp, "rows": 3 * TM}
        stage = 32 * (ncp + 8 if ncp % 16 == 0 else ncp)
    assert all(r % 4 == 0 for r in regions.values())   # 16-byte loads
    base = sum(regions.values())
    stages = min(4, max(0, (SMEM_MAX - 32) // itemsize - base) // stage)
    return (base + stages * stage) * itemsize + 32, stages


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("name", INSTANCES)
def test_stream_smem_mirrors_the_kernel_layout(name, itemsize):
    """_stream_smem is the sum of the kernel's shared-memory regions and
    of as many K stages (at most 4) as 227 KB hold, and _stream_fits
    admits exactly the cluster sizes with at least 2 stages (in float32
    also at most 512 owned columns, in float64 at most 32 column tiles):
    storm from 3 CTAs in f32, only 16 in f64, where the tile's L and the
    exchange buffer leave room for two stages of 32 rows of K."""
    m, n = _shape(name)
    fits = set()
    for C in pdhg_kernel._STREAM_SIZES:
        want, stages = _stream_smem_by_region(C, m, n, itemsize)
        v = 16 // itemsize
        nc = -(-(-(-n // C)) // v) * v
        ok = stages >= 2 and (nc <= 512 if itemsize == 4
                              else -(-nc // 8) <= 32)
        assert pdhg_kernel._stream_smem(C, m, n, itemsize) \
            == (want if ok else 0)
        assert pdhg_kernel._stream_fits(C, 16, m, n, itemsize) == ok
        assert not pdhg_kernel._stream_fits(C, 32, m, n, itemsize)
        if ok:
            fits.add(C)
            assert want <= SMEM_MAX
    if name == "storm":
        assert fits == ({3, 4, 5, 6, 7, 8, 16} if itemsize == 4 else {16})


@pytest.mark.parametrize("plan", [("stream", 2, 16), ("stream", 16, 32),
                                  ("stream", 9, 16), ("stream", 8, 8)])
def test_launch_refuses_a_stream_plan_the_kernel_does_not_take(plan):
    """A forced stream plan whose footprint misses a CTA's shared memory,
    whose cluster size the kernel is not launched with or whose tile is
    not 16 rows raises at the wrapper, before the card is asked: 2 CTAs
    are no size of the kernel's (storm's f32 K there would leave 630
    columns to a CTA's 512 threads)."""
    K = torch.zeros((528, 1259))
    with pytest.raises(ValueError, match="no stream kernel"):
        pdhg_kernel._launch("halpern", plan, K, (), 64, 528, 1259, 80)


def test_stream_plan_keeps_float32_off_while_not_admitted(h100,
                                                          monkeypatch):
    """The stream kernel takes storm's f32 panels only while the grid
    kernel is not admitted for them (float32 out of _GRID_ITEMSIZES), and
    then only while float32 is in _STREAM_ITEMSIZES (its admission rule:
    the f32 stream round neither bit for bit the row-block round nor
    through the f32 gate); without it they go back to the row-block
    kernel past the cluster kernel's 3 waves, and f64 keeps the stream
    kernel."""
    m, n = _shape("storm")
    assert pdhg_kernel._plan(100, m, n, 4) == ("grid", 64, 1)
    monkeypatch.setattr(pdhg_kernel, "_GRID_ITEMSIZES", ())
    pdhg_kernel._plan.cache_clear()
    assert pdhg_kernel._plan(100, m, n, 4) == ("stream", 16, 16)
    monkeypatch.setattr(pdhg_kernel, "_STREAM_ITEMSIZES", (8,))
    pdhg_kernel._plan.cache_clear()
    assert pdhg_kernel._plan(100, m, n, 4) == ROWS1
    assert pdhg_kernel._plan(16, m, n, 4) == ("cluster", 16, 1)
    assert pdhg_kernel._plan(256, m, n, 8) == ("stream", 16, 16)
    pdhg_kernel._plan.cache_clear()


def test_stream_plan_on_storm_ladder(h100):
    """Storm's f32 panels: the cluster kernel while 12 waves of it hold
    the panel (84 rows), then the grid kernel, which the sweep put ahead
    of the stream kernel at 100 and 256 rows; the f64 Halpern round
    streams at every size, the f64 average round up to 256 rows."""
    m, n = _shape("storm")
    assert pdhg_kernel._plan(84, m, n, 4) == ("cluster", 16, 1)
    assert pdhg_kernel._plan(85, m, n, 4)[0] == "grid"
    assert pdhg_kernel._plan(256, m, n, 4)[0] == "grid"
    assert pdhg_kernel._plan(257, m, n, 4)[0] == "grid"
    assert pdhg_kernel._plan(256, m, n, 8, "average")[0] == "stream"
    assert pdhg_kernel._plan(257, m, n, 8, "average")[0] == "rows"
    for B in (1, 2, 257, 1024, 4096, 8192):
        assert pdhg_kernel._plan(B, m, n, 8) == ("stream", 16, 16)


# storm's float32 panels past the cluster kernel: (B, the grid kernel's
# primal tile rows, parts); 10 column tiles of 128, 132 SMs
_STORM_GRID = ((85, 64, 1), (100, 64, 1), (256, 64, 1), (257, 64, 1),
               (512, 64, 1), (513, 64, 2), (1000, 64, 2), (1024, 64, 2),
               (1025, 64, 3), (2048, 64, 4), (3328, 64, 4),
               (3456, 128, 4), (4096, 128, 4), (8192, 128, 4),
               (65536, 128, 4))


@pytest.mark.parametrize("scheme", ["halpern", "average"])
@pytest.mark.parametrize("B,BM,P", _STORM_GRID)
def test_grid_plan_on_storm_ladder(h100, scheme, B, BM, P):
    """Storm's float32 panels past the cluster kernel's 12 waves take the
    grid kernel under either scheme: primal tiles of 128 rows once they
    fill every SM twice (27 row tiles of 128 x 10 column tiles >= 264),
    else of 64; the panel in parts of at least 512 rows, at most 4; its
    footprint fits a CTA at every such shape; the float64 rounds keep the
    stream kernel (Halpern; average up to 256 rows) and the row-block
    kernel (average past 256 rows) there."""
    m, n = _shape("storm")
    plan = pdhg_kernel._plan(B, m, n, 4, scheme)
    assert plan == ("grid", BM, P)
    _check_admitted(plan, B, m, n, 4, scheme)
    assert pdhg_kernel._grid_smem(BM, 4) <= SMEM_MAX
    assert pdhg_kernel._plan(B, m, n, 8, scheme)[0] == \
        ("stream" if scheme == "halpern" or B <= 256 else "rows")


def test_grid_plan_keeps_float32_off_while_not_admitted(h100, monkeypatch):
    """With float32 out of _GRID_ITEMSIZES (its admission rule: the f32
    grid round bit for bit the row-block round), storm's f32 panels of
    85-256 rows go back to the stream kernel and its MC panels to the
    row-block kernel (2 rows a block at 1024, 4 at 4096); f64 keeps its
    plans."""
    m, n = _shape("storm")
    assert pdhg_kernel._plan(1024, m, n, 4) == ("grid", 64, 2)
    monkeypatch.setattr(pdhg_kernel, "_GRID_ITEMSIZES", ())
    pdhg_kernel._plan.cache_clear()
    for scheme in ("halpern", "average"):
        assert pdhg_kernel._plan(1024, m, n, 4, scheme) == ROWS2
        assert pdhg_kernel._plan(4096, m, n, 4, scheme) == ROWS4
        assert pdhg_kernel._plan(256, m, n, 4, scheme) == ("stream", 6, 16)
    assert pdhg_kernel._plan(4096, m, n, 8) == ("stream", 16, 16)
    pdhg_kernel._plan.cache_clear()


def _grid_smem_by_region(BM):
    """csrc/pdhg_grid.cuh: each phase's stages, 3 of them; the larger
    phase's footprint."""
    primal = {"L": BM * (16 + 4), "K": 16 * 128}     # a stage
    dual = {"Yb": 32 * 128, "K": 16 * 128}
    assert (16 + 4) % 4 == 0                       # 16-byte rows
    return 3 * 4 * max(sum(primal.values()), sum(dual.values()))


@pytest.mark.parametrize("BM", [32, 64, 96, 128, 256])
def test_grid_smem_mirrors_the_kernel_layout(BM):
    """_grid_smem is the larger phase's stages at the tile heights the
    kernel has (64 and 128 rows: the dual phase's 72 KB), 0 at any other
    height and for float64, which the grid kernel does not take; the
    kernel takes 1 to 4 parts."""
    want = _grid_smem_by_region(BM) if BM in (64, 128) else 0
    assert pdhg_kernel._grid_smem(BM, 4) == want
    for P in range(6):
        assert pdhg_kernel._grid_fits(BM, 4, P) \
            == (0 < want <= SMEM_MAX and 1 <= P <= 4)
    assert pdhg_kernel._grid_smem(BM, 8) == 0
    assert not pdhg_kernel._grid_fits(BM, 8)


@pytest.mark.parametrize("dtype,plan", [
    (torch.float64, ("grid", 128, 4)), (torch.float64, ("grid", 64, 1)),
    (torch.float32, ("grid", 96, 1)), (torch.float32, ("grid", 32, 2)),
    (torch.float32, ("grid", 256, 4)), (torch.float32, ("grid", 128.0, 4)),
    (torch.float32, ("grid", "128", 4)), (torch.float32, ("grid", 64, 0)),
    (torch.float32, ("grid", 64, 5)), (torch.float32, ("grid", 64, 2.0))])
def test_launch_refuses_a_grid_plan_the_kernel_does_not_take(dtype, plan):
    """A forced grid plan on a float64 operand, with a primal tile height
    the kernel does not have, or with a part count outside 1-4, raises at
    the wrapper, before the card is asked."""
    K = torch.zeros((528, 1259), dtype=dtype)
    with pytest.raises(ValueError, match="no grid kernel"):
        pdhg_kernel._launch("halpern", plan, K, (), 1024, 528, 1259, 80)


@pytest.mark.parametrize("plan", [("grid",), ("grid", 64),
                                  ("grid", 64, 1, 1), ("grids", 64, 1)])
def test_launch_refuses_a_grid_plan_of_another_length(plan):
    K = torch.zeros((528, 1259))
    with pytest.raises(ValueError, match="unknown plan"):
        pdhg_kernel._launch("average", plan, K, (), 1024, 528, 1259, 80)


@pytest.mark.parametrize("m,n", [(528, 1259), (7, 12), (32, 128)])
def test_grid_k_is_padded_and_residue_major(m, n):
    """The grid kernels' copies of K: Kp pads the rows to a multiple of 16
    and the columns to one of 128 with zeros; Kr holds, at position
    4 l + k of every block of 128 columns, Kp's column 32 k + l (a lane's
    j, j + 32, j + 64, j + 96 side by side). Both are kept while the same
    K comes back unmodified and made anew after an in-place change."""
    g = torch.Generator().manual_seed(0)
    K = torch.randn((m, n), generator=g)
    Kp, Kr = pdhg_kernel._grid_k(K)
    mK, ldk = -(-m // 16) * 16, -(-n // 128) * 128
    assert Kp.shape == Kr.shape == (mK, ldk)
    assert Kr.is_contiguous()
    assert torch.equal(Kp[:m, :n], K)
    assert not Kp[m:].any() and not Kp[:, n:].any()
    pos = torch.arange(ldk)
    col = pos // 128 * 128 + (pos % 4) * 32 + (pos % 128) // 4
    assert torch.equal(Kr, Kp[:, col])
    assert pdhg_kernel._grid_k(K)[1] is Kr
    K.mul_(2.0)
    Kp2, _ = pdhg_kernel._grid_k(K)
    assert Kp2 is not Kp and torch.equal(Kp2[:m, :n], K)


@pytest.mark.parametrize("scheme", ["halpern", "average"])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("name", SMALL_INSTANCES)
def test_small_plan_for_every_small_instance(h100, name, itemsize, scheme):
    """Every shipped instance whose K is under 128 KB takes the small
    kernel at the SD panel, the replications' panel, a ladder rung and the
    MC panel, in both dtypes and both schemes, at an admitted shape."""
    m, n = _shape(name)
    assert m * n * itemsize < pdhg_kernel._CLUSTER_MIN_K_BYTES
    for B, want in zip(PANELS, _small_k(name)):
        plan = pdhg_kernel._plan(B, m, n, itemsize, scheme)
        assert plan == want
        _check_admitted(plan, B, m, n, itemsize, scheme)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("name", SMALL_INSTANCES)
def test_small_footprint_fits_a_block(h100, name, itemsize):
    """The small kernel's block, at the group shape and the groups the plan
    gives every panel from 1 to 16,384 rows (per-row q assumed), holds K,
    the bounds and its rows' vectors within the 227 KB a block may use:
    baa99-20's K in float64 (80 KB) leaves room for 16 rows of float64
    vectors; a block has at most 16 warps."""
    m, n = _shape(name)
    for B in (1, 2, 3, 16, 100, 256, 1000, 1024, 4096, 16384):
        _, W, R = pdhg_kernel._plan(B, m, n, itemsize)
        G = pdhg_kernel._small_groups(B, W, R, m, n, itemsize)
        assert 1 <= G and G * W <= 16
        assert pdhg_kernel._small_smem(R, G, m, n, itemsize) <= SMEM_MAX
        assert pdhg_kernel._small_fits(W, R, G, m, n, itemsize)
    if (name, itemsize) == ("baa99-20", 8):
        assert m * n * itemsize == 80_000
        assert pdhg_kernel._small_smem(4, 4, m, n, itemsize) <= SMEM_MAX


def _small_smem_by_region(R, G, m, n, itemsize, q_rows):
    """csrc/pdhg_small.cuh's layout, region by region: K with its rows
    padded to a multiple of 4 (in the tiny layout, n <= 32 and m <= 8: 8
    rows at a stride of 32 elements and 16 bytes), lb, ub and a shared q, then per row Y, its
    anchor or sum, Yb and a per-row q, and L, its anchor or sum and ht,
    each padded to 4 elements (32 and 8 in the tiny layout); is_eq bytes
    last, padded to 4."""
    def up4(x):
        return -(-x // 4) * 4
    tiny = n <= 32 and m <= 8
    mp = 8 if tiny else up4(m)
    np_ = 32 if tiny else up4(n)
    K = mp * (32 + 16 // itemsize if tiny else n)
    bounds = 2 * np_
    q_shared = 0 if q_rows else np_
    per_row = 3 * np_ + (np_ if q_rows else 0) + 3 * mp
    return (K + bounds + q_shared + G * R * per_row) * itemsize + up4(m)


@pytest.mark.parametrize("q_rows", [0, 1])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("name", ["lands", "transship", "baa99-20",
                                  "farmer"])
def test_small_smem_mirrors_the_kernel_layout(name, itemsize, q_rows):
    m, n = _shape(name)
    for R in (1, 2, 4):
        for G in (1, 2, 4, 8, 16):
            assert pdhg_kernel._small_smem(R, G, m, n, itemsize, q_rows) \
                == _small_smem_by_region(R, G, m, n, itemsize, q_rows)


@pytest.mark.parametrize("name,B,W,R,G32,G64", [
    ("lands", 2, 1, 1, 1, 1), ("lands", 16, 1, 1, 1, 1),
    ("lands", 256, 1, 1, 2, 2), ("lands", 1000, 1, 2, 4, 4),
    ("lands", 4096, 1, 4, 8, 8), ("transship", 1024, 8, 4, 2, 2),
    ("transship", 4096, 2, 4, 8, 8), ("baa99-20", 2, 8, 1, 1, 1),
    ("baa99-20", 1000, 8, 4, 2, 2), ("baa99-20", 4096, 2, 4, 8, 4),
    ("baa99-20", 16384, 2, 4, 8, 4)])
def test_small_groups_fill_the_card(h100, name, B, W, R, G32, G64):
    """A block carries as many groups as its 16 warps and its shared memory
    allow while the panel still gives each of the 132 SMs a block: one
    group for the SD panels, more at the ladder's rungs, so K is copied
    once for many rows (baa99-20's float64 K leaves room for 4 groups of
    4 rows)."""
    m, n = _shape(name)
    for itemsize, G in ((4, G32), (8, G64)):
        assert pdhg_kernel._plan(B, m, n, itemsize) == ("small", W, R)
        assert pdhg_kernel._small_groups(B, W, R, m, n, itemsize) == G


@pytest.mark.parametrize("scheme", ["halpern", "average"])
@pytest.mark.parametrize("plan", [("small", 3, 1), ("small", 1, 3),
                                  ("small", 32, 1), ("small", 1, 8),
                                  ("small", 0, 1), ("small", 1.0, 1),
                                  ("small", 2, 2.0)])
def test_launch_refuses_a_small_plan_the_kernel_does_not_take(scheme, plan):
    """A forced small plan whose group width is not 1, 2, 4, 8 or 16 warps
    or whose rows a group are not 1, 2 or 4 raises at the wrapper, before
    anything is built or launched, on any host."""
    K = torch.zeros((40, 250))
    with pytest.raises(ValueError, match="no small kernel"):
        pdhg_kernel._launch(scheme, plan, K, (), 16, 40, 250, 80)


@pytest.mark.parametrize("plan", [("small", 1), ("small", 1, 1, 1),
                                  ("small",)])
def test_launch_refuses_a_small_plan_of_another_length(plan):
    K = torch.zeros((7, 12))
    with pytest.raises(ValueError, match="unknown plan"):
        pdhg_kernel._launch("halpern", plan, K, (), 8, 7, 12, 80)


@pytest.mark.parametrize("name,itemsize", [("ssn", 4), ("ssn", 8),
                                           ("storm", 4)])
def test_launch_refuses_a_small_plan_whose_group_misses_a_block(name,
                                                               itemsize):
    """ssn's and storm's K do not fit one block's shared memory: a forced
    small plan raises, and the plan never gives them one."""
    m, n = _shape(name)
    K = torch.zeros((m, n), dtype=torch.float32 if itemsize == 4
                    else torch.float64)
    assert pdhg_kernel._small_shape(16, m, n, itemsize) is None
    with pytest.raises(ValueError, match="no small kernel"):
        pdhg_kernel._launch("halpern", ("small", 1, 1), K, (), 16, m, n, 80)


def _cpu_round_args(B):
    g = torch.Generator().manual_seed(0)
    m, n = 7, 12
    K = torch.randn((m, n), generator=g, dtype=torch.float64)
    return (K, torch.rand(n, generator=g, dtype=torch.float64),
            torch.full((n,), -1.0, dtype=torch.float64),
            torch.full((n,), 1.0, dtype=torch.float64),
            torch.zeros(m, dtype=torch.bool),
            torch.randn((B, m), generator=g, dtype=torch.float64),
            torch.full((B,), 0.1, dtype=torch.float64),
            torch.full((B,), 0.1, dtype=torch.float64),
            torch.zeros((B, n), dtype=torch.float64),
            torch.zeros((B, m), dtype=torch.float64),
            torch.zeros(B, dtype=torch.float64),
            torch.zeros((B, n), dtype=torch.float64),
            torch.zeros((B, m), dtype=torch.float64))


@pytest.mark.parametrize("plan", [("small", 1, 1), ("small", 4, 4),
                                  ("rows", 1)])
@pytest.mark.parametrize("scheme", ["halpern", "average"])
def test_wrappers_raise_on_cpu_tensors_with_a_forced_plan(scheme, plan):
    """CPU tensors run the plain version, which takes no plan: a forced
    small (or any other) plan raises instead of falling back; without one
    the wrapper is the plain version."""
    args = _cpu_round_args(4)
    if scheme == "average":
        args = args[:10]
    kernel = getattr(pdhg_kernel, f"pdhg_{scheme}_round")
    with pytest.raises(ValueError, match="CPU tensors"):
        kernel(*args, 8, plan=plan)
    ref = getattr(pdhg_kernel, f"pdhg_{scheme}_round_ref")(*args, 8)
    assert all(torch.equal(a, b) for a, b in zip(kernel(*args, 8), ref))
