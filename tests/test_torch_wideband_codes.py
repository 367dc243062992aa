"""The port's GPS L5 and Galileo E5a spreading codes
(gnss_sdr_tpu_torch.models.codes) against the JAX package's, bit for bit:
the L5I / L5Q codes of PRN 1-32, the E5a-I / E5a-Q primary codes of PRN
1-50 and the E5a-Q CS100 secondary codes of every PRN the ICD table holds
(1-47; both packages raise past it), the dispatch tables, and the sampled
tracking / acquisition replicas at the JAX e2e tests' rates (L5 at 11 MSps,
E5a at 12 MSps)."""

import numpy as np
import pytest

from gnss_sdr_tpu.models import codes as jcodes
from gnss_sdr_tpu_torch import constants
from gnss_sdr_tpu_torch.models import codes as tcodes

GENERATORS = [("gps_l5i_code", range(1, 33)), ("gps_l5q_code", range(1, 33)),
              ("galileo_e5ai_code", range(1, 51)),
              ("galileo_e5aq_code", range(1, 51)),
              ("galileo_e5aq_secondary_code", range(1, 48))]


@pytest.mark.parametrize("name,prns", GENERATORS, ids=[g[0] for g in GENERATORS])
def test_codes_equal_jax(name, prns):
    for prn in prns:
        a = getattr(jcodes, name)(prn)
        b = getattr(tcodes, name)(prn)
        assert b.dtype == a.dtype == np.float32
        np.testing.assert_array_equal(b, a, err_msg=f"{name} PRN {prn}")


def test_cs100_table_ends_at_prn_47_in_both():
    for mod in (jcodes, tcodes):
        with pytest.raises(IndexError):
            mod.galileo_e5aq_secondary_code(48)


@pytest.mark.parametrize("signal", ["L5", "5X"])
def test_dispatch_and_sampled_tables(signal):
    spec = constants.SIGNALS[signal]
    fs = 11.0e6 if signal == "L5" else 12.0e6
    spc = int(round(fs * spec.code_period_s))
    assert tcodes.has_pilot(signal) and jcodes.has_pilot(signal)
    for prn in (1, 7, 19, 32):
        for gen in ("code_chips", "pilot_code_chips", "pilot_secondary_chips"):
            a = getattr(jcodes, gen)(signal, prn)
            b = getattr(tcodes, gen)(signal, prn)
            if a is None:
                assert b is None
                continue
            np.testing.assert_array_equal(b, a, err_msg=f"{gen} {prn}")
        for chips in ("code_chips", "pilot_code_chips"):
            ja = jcodes.sample_code(getattr(jcodes, chips)(signal, prn), fs,
                                    spec.code_rate_cps, spc, chip_phase=0.37)
            tb = tcodes.sample_code(getattr(tcodes, chips)(signal, prn), fs,
                                    spec.code_rate_cps, spc, chip_phase=0.37)
            np.testing.assert_array_equal(tb, ja)
    # L5 carries no pilot secondary in either package's table (NH20 is not
    # generated); E5a's pilot carries CS100
    assert (tcodes.pilot_secondary_chips(signal, 3) is None) == (signal == "L5")


@pytest.mark.parametrize("signal,fs", [("L5", 11.0e6), ("5X", 12.0e6),
                                       ("1B", 4.0e6), ("1C", 2.0e6)])
def test_device_generator_matches_jax(signal, fs):
    """The port's generator (its signal sum in torch, on the CPU here, as
    without a ``device``) against the JAX package's numpy generator: two
    satellites with data symbols, the secondary overlay, the pilot, Doppler
    rate and jerk, over blocks of 7 ms. Chip, symbol and secondary indices
    are floors of the same float64 phases, so they agree exactly; the
    float32 sincos of the two libraries differ by an ulp (|dx| <= 1e-6 on
    amplitudes ~3 with the noise included; measured 2.4e-7)."""
    from gnss_sdr_tpu import constants as jconst
    from gnss_sdr_tpu.utils import generator as jgen
    from gnss_sdr_tpu_torch.utils import generator as tgen

    bits = np.sign(np.random.default_rng(0).standard_normal(50))

    def sats(mod):
        return [mod.SatParams(prn=p, cn0_dbhz=50.0 + i, doppler_hz=d,
                              doppler_rate_hz_s=0.7, doppler_jerk_hz_s2=0.01,
                              code_delay_s=cd, data_bits=bits,
                              carrier_phase_cycles=0.3)
                for i, (p, d, cd) in enumerate(((3, 1234.5, 2.1e-4),
                                                (7, -2222.0, 7.7e-4)))]
    kw = dict(seed=4, with_pilot=True, block_s=0.007)
    want = jgen.generate(jconst.SIGNALS[signal], sats(jgen), fs, 0.02, **kw)
    got = tgen.generate(constants.SIGNALS[signal], sats(tgen), fs, 0.02,
                        device="cpu", **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # no device is the CPU
    np.testing.assert_array_equal(
        tgen.generate(constants.SIGNALS[signal], sats(tgen), fs, 0.02, **kw),
        got)
