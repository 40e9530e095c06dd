"""The work a call needs, against numbers worked out by hand for the three
cells, and the least times that follow from the frozen peaks."""

import pytest

from benchmark.harness import roofline, spec


def _work(name):
    cell = spec.load_cell(name)
    return cell, spec.call_module(cell).work(cell.config)


def test_fit_at_2p5m():
    cell, w = _work("logreg.fit.2p5m")
    # X 2.5e6 x 1000 fp32 read once, y read, beta (1001) written.
    assert w["bytes"] == 4 * 2_500_000 * 1000 + 4 * 2_500_000 + 4 * 1001
    # Ten Hessians' upper triangles, intercept column included:
    # 10 x 2.5e6 x 1001 x 1002.
    assert w["tc_flops"] == 2.507505e13
    # Ten times eta's and g's 4 x 2.5e6 x 1001.
    assert w["f32_flops"] == 1.001e11
    least, by = roofline.least_seconds(w, cell.chips)
    assert by == "operations"
    assert least == pytest.approx(2.507505e13 / 989e12)   # 25.354 ms


def test_gram_at_2p5m():
    cell, w = _work("gram.xtx.2p5m")
    assert w["bytes"] == 4 * 2_500_000 * 1000 + 4 * 1000 * 1000
    assert w["tc_flops"] == 2_500_000 * 1000 * 1001          # 2.5025e12
    assert w["f32_flops"] == 0.0
    least, by = roofline.least_seconds(w, cell.chips)
    assert by == "bytes"
    assert least == pytest.approx(10.004e9 / 3.35e12)        # 2.986 ms


def test_fit_at_10m_on_four_cards():
    cell, w = _work("logreg.fit.10m.mesh4")
    assert cell.chips == 4
    assert w["bytes"] == 4 * 10_000_000 * 1000 + 4 * 10_000_000 + 4 * 1001
    assert w["tc_flops"] == pytest.approx(1.003002e14)
    assert w["f32_flops"] == pytest.approx(4.004e11)
    least, by = roofline.least_seconds(w, cell.chips)
    # A card's quarter of the work: the one-card fit's least time.
    assert by == "operations"
    assert least == pytest.approx(2.507505e13 / 989e12)


def test_frozen_peaks_and_bound():
    assert (roofline.HBM_BYTES_PER_S, roofline.BF16_TC_FLOPS,
            roofline.F32_FLOPS) == (3.35e12, 989e12, 67e12)
    assert roofline.triangle_flops(3, 2) == 18.0
    # f32 units bound where they carry more than the tensor cores can.
    assert roofline.bound(0.0, 989e12, 134e12) == (2.0, "operations")
    assert roofline.bound(6.7e12, 0.0) == (2.0, "bytes")
    k3 = roofline.newton_stats_work(2_500_000, 1001, 2)
    assert k3["bytes"] == (2 * 2_500_000 * 1001 + 4 * 2_500_000 + 8 * 1001
                           + 4 * 1001 * 1001)
