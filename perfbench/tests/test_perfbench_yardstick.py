"""Each cell's bytes, flops and pair bound, exactly from its sizes."""

import math

import _paths  # noqa: F401
import pytest

from perfbench import loader, yardstick

GIB = 1 << 30

#: cell -> (batch, input bytes, output bytes, flops a pair)
CELLS = {
    "pow2-4096-c2c.exec": (16384, 1 << 29, 1 << 29,
                           2 * 5.0 * 16384 * 4096 * 12),
    "oddshape-19-c2c.exec": (3532045, 3532045 * 19 * 8, 3532045 * 19 * 8,
                             2 * 5.0 * 3532045 * 19 * math.log2(19)),
    "pow2-4096-r2c.exec": (32768, 1 << 29, 32768 * 2049 * 8,
                           2 * 2.5 * 32768 * 4096 * 12),
    "oddshape-19-r2c.exec": (7064090, 7064090 * 19 * 4, 7064090 * 10 * 8,
                             2 * 2.5 * 7064090 * 19 * math.log2(19)),
}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_work(name):
    batch, nin, nout, flops = CELLS[name]
    p = loader.cell(name).problem()
    assert p.batch == batch
    assert (p.input_bytes, p.output_bytes) == (nin, nout)
    assert yardstick.pair_bytes(p) == 2 * (nin + nout)
    assert yardstick.pair_flops(p) == pytest.approx(flops, rel=1e-15)
    # every cell is bound by its bytes
    assert yardstick.pair_bound_s(p) == 2 * (nin + nout) / 3.35e12


def test_pair_bounds_as_the_issue_gives_them():
    ms = {n: yardstick.pair_bound_s(loader.cell(n).problem()) * 1e3
          for n in CELLS}
    assert round(ms["pow2-4096-c2c.exec"], 3) == 0.641
    assert round(ms["oddshape-19-c2c.exec"], 3) == 0.641
    assert round(ms["pow2-4096-r2c.exec"], 3) == 0.641
    assert round(ms["oddshape-19-r2c.exec"], 3) == 0.658
    assert loader.cell("oddshape-19-r2c.exec").problem().output_bytes \
        / 2 ** 20 == pytest.approx(539, abs=0.5)


def test_launch_work():
    flops, nbytes = yardstick.launch_work(4096, 16384, "complex64")
    assert nbytes == 2 * GIB // 2 and flops == 5.0 * 16384 * 4096 * 12
    assert yardstick.launch_work(19, 10, "complex128")[1] == 2 * 19 * 10 * 16
    assert yardstick.bound_s(67e12, 0) == 1.0


def test_percentile():
    vals = [4.0, 1.0, 3.0, 2.0, 5.0]
    assert yardstick.percentile(vals, 50) == 3.0
    assert yardstick.percentile(vals, 95) == pytest.approx(4.8)
    assert yardstick.percentile([7.0], 95) == 7.0
    with pytest.raises(ValueError):
        yardstick.percentile([], 50)
