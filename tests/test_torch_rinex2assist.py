"""The port's rinex2assist (gnss_sdr_tpu_torch.utils.rinex2assist) against
the JAX package's, on the CPU: the same RINEX 3 navigation file (written by
either package's ``RinexNavWriter``: the two files are equal) parses to the
same ephemerides in both packages, bit for bit, and the assistance JSON the
two write is the same file. Files live under pytest's ``tmp_path``.
"""

import numpy as np
import pytest
import torch

from gnss_sdr_tpu.receiver.pvt import rinex as jrinex
from gnss_sdr_tpu.utils import rinex2assist as jr2a
from gnss_sdr_tpu_torch.receiver import control as tcontrol
from gnss_sdr_tpu_torch.receiver.pvt import rinex as trinex
from gnss_sdr_tpu_torch.utils import rinex2assist as tr2a
from test_lnav import sample_ephemeris
from torch_twin import assert_same, twin

torch.set_num_threads(1)   # one thread per xdist worker


def _ephemerides():
    a = sample_ephemeris()
    b = sample_ephemeris()
    b.prn, b.m0 = 11, -0.5
    c = sample_ephemeris()            # an older record of PRN 7
    c.toe = c.toc = a.toe - 7200.0
    return [(a, "G"), (b, "G"), (c, "G"), (sample_ephemeris(), "E")]


def _write(writer_mod, tag, path):
    w = writer_mod.RinexNavWriter(path)
    for eph, sys in _ephemerides():
        w.write_ephemeris(twin(eph, tag), sys)
    w.close()


def test_nav_files_parse_alike(tmp_path):
    jp, tp = tmp_path / "jax.rnx", tmp_path / "port.rnx"
    _write(jrinex, "jax", jp)
    _write(trinex, "port", tp)
    assert tp.read_text() == jp.read_text()
    want = jr2a.parse_rinex_nav(jp)
    got = tr2a.parse_rinex_nav(tp)
    assert_same(want, got, "parse_rinex_nav")
    assert set(got["G"]) == {7, 11} and set(got["E"]) == {7}
    d, eph = got["G"][7], sample_ephemeris()
    assert d.toe == eph.toe            # the newest record of PRN 7 wins
    p1, _ = eph.position_velocity(eph.toe + 1800.0)
    p2, _ = d.position_velocity(eph.toe + 1800.0)
    assert np.linalg.norm(p1 - p2) < 0.05


@pytest.mark.parametrize("system", ["G", "E"])
def test_rinex2assist_writes_the_same_file(tmp_path, system, capsys):
    nav = tmp_path / "nav.rnx"
    _write(trinex, "port", nav)
    jout, tout = tmp_path / "jax.json", tmp_path / "port.json"
    n = jr2a.rinex2assist(nav, jout, system)
    assert tr2a.main([str(nav), "-o", str(tout), "--system", system]) == 0
    assert f"wrote {n} ephemerides" in capsys.readouterr().out
    assert tout.read_text() == jout.read_text()
    ephs = tcontrol.load_assistance(tout).ephemerides
    assert len(ephs) == n == (2 if system == "G" else 1)
    # bare PRN keys load as GPS in both packages, whatever the system
    assert ("G", 7) in ephs
