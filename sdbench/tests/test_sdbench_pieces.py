"""The benchmark's own pieces against hand counts at tiny sizes: the SMPS
reader, the sampler, the roofline arithmetic, TF32 rounding and the
plain references."""

import os

import numpy as np
import pytest
import torch

from sdbench import harness, reference, roofline, smps
from sdbench.sampler import Sampler
from sdbench.trace import Trace

DATA = os.path.join(harness.ROOT, "instances")


@pytest.mark.parametrize("name,sizes", [
    ("ssn", (89, 1, 175, 706, 86)), ("storm", (121, 185, 528, 1259, 117))])
def test_reader_sizes(name, sizes):
    lp = smps.read_two_stage(os.path.join(DATA, name))
    disc = smps.read_discrete(os.path.join(DATA, name), lp)
    n1, m1, m2, n2, rv = sizes
    assert lp.c.shape == (n1,) and lp.A1.shape == (m1, n1)
    assert lp.W.shape == (m2, n2) and lp.T.shape == (m2, n1)
    assert len(disc.rows) == rv == len(set(disc.rows))
    for p in disc.probs:
        assert abs(p.sum() - 1.0) < 1e-12


def _tiny():
    return smps.Discrete(rows=["a", "b"], row_index=np.array([0, 2]),
                         base=np.array([1.0, 0.0]),
                         values=[np.array([1.0, 2.0, 4.0]),
                                 np.array([5.0, 7.0])],
                         probs=[np.array([0.5, 0.25, 0.25]),
                                np.array([0.2, 0.8])])


def test_sampler_inverse_cdf_by_hand():
    s = Sampler(_tiny(), "cpu")
    u = torch.tensor([[0.0, 0.0], [0.49, 0.19], [0.5, 0.2], [0.74, 0.5],
                      [0.75, 0.99], [0.999, 0.2]], dtype=torch.float64)
    want = torch.tensor([[0.0, 5.0], [0.0, 5.0], [1.0, 7.0], [1.0, 7.0],
                         [3.0, 7.0], [3.0, 7.0]], dtype=torch.float64)
    assert torch.equal(s._pick(u), want)


def test_sampler_iid_frequencies_and_seed():
    s = Sampler(_tiny(), "cpu")
    g = torch.Generator()
    g.manual_seed(2**31 + 7)
    D = s.iid(g, 40000)
    freq = [(D[:, 0] == v).double().mean().item() for v in (0.0, 1.0, 3.0)]
    assert np.allclose(freq, [0.5, 0.25, 0.25], atol=0.01)
    g2 = torch.Generator()
    g2.manual_seed(2**31 + 7)
    assert torch.equal(D, s.iid(g2, 40000))


def test_sampler_lhs_strata():
    s = Sampler(_tiny(), "cpu")
    g = torch.Generator()
    g.manual_seed(3)
    D = s.lhs(g, 20)
    # 20 strata: exactly 10 / 5 / 5 of the first variable's outcomes, and
    # 4 / 16 of the second's
    assert [int((D[:, 0] == v).sum()) for v in (0.0, 1.0, 3.0)] == [10, 5, 5]
    assert [int((D[:, 1] == v).sum()) for v in (5.0, 7.0)] == [4, 16]


def test_roofline_by_hand():
    # PDHG: B=2 rows of a 3 x 4 K, 80 steps, float32 on the CUDA cores
    flops = 4.0 * 3 * 4 * 2 * 80
    nbytes = 4 * (12 + 12 + 2 * (3 + 2 + 4 + 3 + 1 + 4 + 3)) + 3 \
        + 2 * 2 * 7 * 2 * 4
    assert roofline.pdhg_round(2, 3, 4, "float32", "tile") == max(
        flops / 67e12, nbytes / 3.35e12)
    big = roofline.pdhg_round(4096, 175, 706, "float64", "rows")
    assert big == 4.0 * 175 * 706 * 4096 * 80 / 34e12
    assert roofline.pdhg_round(4096, 175, 706, "float64", "tile") \
        == 4.0 * 175 * 706 * 4096 * 80 / 67e12
    # EF: R=1, S=2, m1=1, n1=2, m2=3, n2=4
    it_el = 1 * (2 + 1 + 2 * (4 + 3))
    nb = 4 * (it_el + 6 + 24 + 12 + 6 + 2 + 2 * it_el + it_el)
    assert roofline.ef_step(1, 2, 1, 2, 3, 4, "float32") == max(
        4.0 * 2 * 3 * 4 / 67e12, nb / 3.35e12)
    # ssn at R = 16 x 3000 is bound by its operations: 0.354 ms a step
    assert abs(roofline.ef_step(16, 3000, 1, 89, 175, 706, "float32")
               - 4.0 * 16 * 3000 * 175 * 706 / 67e12) < 1e-12


def test_tf32_round_by_hand():
    x = np.array([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -12,
                  -3.0, 336.8])
    y = reference.tf32_round(x)
    assert y[0] == 1.0 and y[3] == -3.0
    assert y[1] == 1.0 + 2.0 ** -10          # a tie rounds away from zero
    assert y[2] == 1.0 + 2.0 ** -10
    assert abs(y[4] - 336.8) <= 336.8 * 2.0 ** -11


def test_recourse_reference_tiny_lp():
    # min y1 + 2 y2  s.t. y1 + y2 >= h, y1 <= 3 (as -y1 >= -3)
    lp = smps.TwoStage(name="t", c=np.zeros(1), A1=np.zeros((0, 1)),
                       b1=np.zeros(0), senses1=[], q=np.array([1.0, 2.0]),
                       W=np.array([[1.0, 1.0], [1.0, 0.0]]),
                       T=np.zeros((2, 1)), r=np.array([0.0, 3.0]),
                       senses2=["G", "L"], rows2=["d", "c"])
    H = np.array([[2.0, 3.0], [5.0, 3.0]])
    assert np.allclose(reference.recourse_values(lp, H), [2.0, 7.0])


def test_trace_union_and_gaps():
    tr = Trace(kernels=[("a", 0.0, 10.0), ("b", 5.0, 20.0),
                        ("a", 30.0, 40.0)],
               host_ops=[("aten::item", 19.0, 31.0)], window_s=50e-6)
    assert tr.union_s() == 30e-6
    assert tr.union_s(lambda n: n == "a") == 20e-6
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["a", 20e-6]
    assert bd["idle_gaps"] == [["aten::item", 10e-6]]


def test_kkt_errors_tiny_lp():
    # the LP above: at h = (2, 3) the optimum is y = (2, 0), pi = (1, 0)
    lp = smps.TwoStage(name="t", c=np.zeros(1), A1=np.zeros((0, 1)),
                       b1=np.zeros(0), senses1=[], q=np.array([1.0, 2.0]),
                       W=np.array([[1.0, 1.0], [1.0, 0.0]]),
                       T=np.zeros((2, 1)), r=np.array([0.0, 3.0]),
                       senses2=["G", "L"], rows2=["d", "c"])
    H = np.array([[2.0, 3.0]])
    v, Y, Pi = reference.recourse_values(lp, H, solutions=True)
    assert np.allclose(v, [2.0])
    assert np.allclose(Y, [[2.0, 0.0]]) and np.allclose(Pi, [[1.0, 0.0]])
    assert reference.objective_scale(lp) == 2.0
    Pi = Pi / 2.0
    assert reference.kkt_errors(lp, H, Y, Pi)[0] < 1e-12
    # a value that is not its y's objective reads as a gap:
    # |2.2 - 2| / 2 / (1 + 1.1 + 1)
    e = reference.kkt_errors(lp, H, Y, Pi, values=[2.2])[0]
    assert abs(e - 0.1 / 3.1) < 1e-12
    # y short of the demand row by 0.5: Ruiz leaves this matrix as it is
    dr, dc = reference.ruiz(lp)
    assert np.allclose(dr, 1.0) and np.allclose(dc, 1.0)
    e = reference.kkt_errors(lp, H, np.array([[1.5, 0.0]]), Pi)[0]
    assert abs(e - max(0.5 / (1.0 + np.hypot(2.0, 3.0)),
                       0.5 / 2 / (1.0 + 0.75 + 1.0))) < 1e-12


def test_ruiz_by_hand():
    lp = smps.TwoStage(name="t", c=np.zeros(1), A1=np.zeros((0, 1)),
                       b1=np.zeros(0), senses1=[], q=np.ones(2),
                       W=np.array([[4.0, 0.0], [0.0, 16.0]]),
                       T=np.zeros((2, 1)), r=np.zeros(2),
                       senses2=["G", "G"], rows2=["a", "b"])
    dr, dc = reference.ruiz(lp, iters=1)
    # rows divided by sqrt(4), sqrt(16); the columns are then 2 and 4
    assert np.allclose(dr, [0.5, 0.25])
    assert np.allclose(dc, [1 / np.sqrt(2.0), 0.5])


def test_split_metric_shares_its_reader():
    assert harness.quantity("lp_solves_per_s.host_paced",
                            {"lp_solves_per_s", "setup_s"}) \
        == "lp_solves_per_s"
    a = harness.load_metric("device.idle_share.panel.host_paced")
    b = harness.load_metric("device.idle_share.panel")
    assert a.__file__ == b.__file__
    with pytest.raises(ValueError):
        harness.load_metric("no_such_metric")
