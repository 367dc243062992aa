"""GPS L5 and Galileo E5a tracking in the port against the JAX package, on
the CPU.

The eager loop (K2's plain version) open loop from the identical carry
against JAX ``track_chunk`` on one 100-step chunk of generated signal:
GPS L5I at 11 MSps (n_max 11,064) and Galileo E5a-I at 12 MSps (n_max
12,064), 10,230-entry tables at one entry per chip. Each signal runs on the
data component alone, with pilot tracking (L5Q / E5a-Q taps plus the data
prompt on ``[C, 2, 10230]`` tables), and with the secondary wipe the
receiver installs after symbol sync (``set_secondary`` with the data
component's NH10 / CS20 + ``set_extension`` over one secondary period; for
L5 under pilot tracking, as the JAX receiver runs it). The int32 fields
are equal at every step; float fields within rtol / atol 1e-4, and the
correlator sums (the prompt and every tap, unturned) as complex values,
|dz| <= 1e-4 |z| + 1e-4: tests/test_torch_galileo_tracking.py's
tolerances. Two carry fields depart from that file's rules:

* ``prev_prompt`` is a correlator sum (the last window's prompt). It is
  compared component by component, the rule of that file, where that
  holds (L5 with the pilot), and as a complex value, the rule that file
  applies to ``acc_corr``, in the other cases: component by component it
  misses by up to 87x on L5, 2.9x on E5a and 1.7x on E5a with the pilot,
  where its Q is near zero and carries the whole sum's rounding.
* The C/N0 moments ``cn0.ema_i2_minus_q2`` and ``cn0.ema_abs_i`` are held
  to the bounds the sums' rounding gives them (``moment_bounds`` of
  tests/test_torch_galileo_tracking.py, derived in
  tests/test_torch_tracking.py, with e = 1e-4: the prompts here meet the
  sums' bound unturned). Both are moments of the prompt, whose rounding is
  relative to |P|, not to I^2 - Q^2 or |I|: L5's channel 3 reads |I|
  1.05e-4 off relative to itself, past rtol / atol 1e-4 (1.05 of it).

Fed JAX's own correlator sums (``correlate=``), the port's loop keeps
JAX's bits in all six cases, ``prev_prompt`` and both moments included
(``test_fed_jax_sums_keep_jax_bits``): their difference is the sums'
summation order alone, which the port keeps as the kernels sum, so no order
of operations is left to write out and the two bounds stay.

The ``gpu`` test holds K2 to the eager loop on the card bit for bit at
these shapes.
"""

import numpy as np
import pytest
import torch

from gnss_sdr_tpu_torch.ops import correlator as tcorr
from gnss_sdr_tpu_torch.ops import tracking_kernel as tk
from gnss_sdr_tpu_torch.receiver import tracking as ttrk
from gnss_sdr_tpu_torch.utils import scenario

from test_torch_galileo_tracking import (FLOAT_FIELDS, INT_FIELDS,
                                         _complex_close, _jax_cfg,
                                         _jax_state,
                                         assert_fed_jax_sums_keep_bits,
                                         moment_bounds, run_fed_jax_sums)

torch.set_num_threads(1)   # one thread per xdist worker

CASES = {"l5": dict(signal="L5"),
         "l5_pilot": dict(signal="L5", pilot=True),
         "l5_pilot_nh10": dict(signal="L5", pilot=True, extended=True),
         "e5a": dict(signal="5X"),
         "e5a_cs20": dict(signal="5X", extended=True),
         "e5a_pilot": dict(signal="5X", pilot=True)}
# (n_max, secondary code length) per signal
SHAPES = {"L5": (11064, 10), "5X": (12064, 20)}
# the cases whose prev_prompt is held as a complex value (docstring)
PREV_PROMPT_COMPLEX = ("l5", "e5a", "e5a_cs20", "e5a_pilot")


@pytest.fixture(scope="module", params=sorted(CASES))
def open_loop(request):
    import jax.numpy as jnp
    from gnss_sdr_tpu.receiver import tracking as jtrk

    c = scenario.tracking_handoff_case("cpu", **CASES[request.param])
    cfg, sec = c["cfg"], c["sec"]
    jst, jout = jtrk.track_chunk(
        _jax_cfg(cfg), jnp.asarray(c["chunk"]), _jax_state(c["state"]),
        jnp.asarray(c["tables"]), None if sec is None else jnp.asarray(sec))
    tst, tout = ttrk.track_chunk(
        cfg, torch.from_numpy(c["chunk"]), c["state"],
        torch.from_numpy(c["tables"]),
        None if sec is None else torch.from_numpy(sec))
    return dict(name=request.param, cfg=cfg, jst=jst, jout=jout, tst=tst,
                tout=tout, case=c)


def test_open_loop_matches_jax(open_loop):
    cfg, jout, tout = open_loop["cfg"], open_loop["jout"], open_loop["tout"]
    signal = CASES[open_loop["name"]]["signal"]
    n_max, sec_len = SHAPES[signal]
    assert (cfg.n_steps, cfg.n_max, cfg.table_rate) == (102, n_max, 1)
    assert cfg.n_taps == (4 if cfg.track_pilot else 3)
    for f in INT_FIELDS:
        a = np.asarray(getattr(jout, f))
        b = getattr(tout, f).numpy()
        bad = np.argwhere(a != b)
        assert not len(bad), f"{f}: first (step, channel) differing {bad[:5]}"
    assert np.asarray(jout.valid)[:, :5].sum() >= 450
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(tout, f).numpy(),
                                   np.asarray(getattr(jout, f)),
                                   rtol=1e-4, atol=1e-4, err_msg=f)
    for f in ("prompt", "correlators"):
        _complex_close(np.asarray(getattr(jout, f)),
                       getattr(tout, f).numpy())
    np.testing.assert_array_equal(
        tout.prompt.numpy(),
        tout.correlators.numpy()[:, :, cfg.data_prompt_index])
    jst, tst = open_loop["jst"], ttrk.state_to_numpy(open_loop["tst"])
    complex_fields = ("acc_corr",) + (
        ("prev_prompt",) if open_loop["name"] in PREV_PROMPT_COMPLEX else ())
    for name in complex_fields:
        _complex_close(np.asarray(getattr(jst, name)), getattr(tst, name))
    for name in ttrk.TrackingState._fields:
        if name in complex_fields:
            continue
        a, b = getattr(jst, name), getattr(tst, name)
        for field, x, y in (zip(a._fields, a, b)
                            if name in ("dll", "pll", "cn0")
                            else [(name, a, b)]):
            x = np.asarray(x)
            if x.dtype.kind in "biu":
                np.testing.assert_array_equal(y, x, err_msg=name)
            elif field in ("ema_i2_minus_q2", "ema_abs_i"):
                bound = moment_bounds(jst.cn0.ema_i2_plus_q2, 1e-4)[field]
                assert (np.abs(y - x) <= bound).all(), \
                    (field, np.abs(y - x) / bound)
            else:
                np.testing.assert_allclose(y, x, rtol=1e-4, atol=1e-4,
                                           err_msg=name)
    if CASES[open_loop["name"]].get("extended"):
        assert tst.ext_n[[1, 3]].tolist() == [sec_len, sec_len]
        assert tst.sec_len[3] == sec_len and tst.sec_len[1] == 0


def test_fed_jax_sums_keep_jax_bits(open_loop):
    tst, tout = run_fed_jax_sums(open_loop)
    assert_fed_jax_sums_keep_bits(open_loop["jst"], open_loop["jout"], tst,
                                  tout)


@pytest.mark.parametrize("signal", ["L5", "5X"])
def test_k2_wrapper_at_the_wideband_shapes(signal):
    """Three 4096-sample tiles per epoch, the tables and the ring within the
    block's shared memory with and without the pilot component, and the
    parameter block at these shapes."""
    n_max, _ = SHAPES[signal]
    for pilot in (False, True):
        c = scenario.tracking_handoff_case("cpu", signal=signal, pilot=pilot)
        cfg = c["cfg"]
        n_comp = 2 if pilot else 1
        tk._check(cfg, chunk=torch.from_numpy(c["chunk"]),
                  carry=tk.pack_carry(c["state"]),
                  code_tables=torch.from_numpy(c["tables"]), sec_tables=None)
        p = tk.make_params(cfg, 6, len(c["chunk"]), 10230, 32)
        assert (p.n_steps, p.n_max, p.table_len, p.table_rate, p.n_comp) == \
            (102, n_max, 10230, 1, n_comp)
        assert p.tile == tk.TILE_MAX and -(-n_max // p.tile) == 3
        assert tk.shared_bytes(n_max, 10230, n_comp) == \
            2 * 4096 * 8 + n_comp * 10230 * 4 < tk.MAX_SMEM_BYTES


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernel_matches_eager_plain_wideband(case):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    dev = torch.device("cuda", 0)
    c = scenario.tracking_handoff_case(dev, **CASES[case])
    cfg, state = c["cfg"], c["state"]
    chunk = torch.from_numpy(c["chunk"]).to(dev)
    tables = torch.from_numpy(c["tables"]).to(dev)
    sec = None if c["sec"] is None else torch.from_numpy(c["sec"]).to(dev)
    before = tk.launches
    new, packed = ttrk.track_chunk_packed(cfg, chunk, state, tables, sec)
    assert tk.launches == before + 1
    ref_state, out = ttrk.track_chunk(
        cfg, chunk, state, tables, sec,
        correlate=tcorr.epoch_correlate_plain)
    ref = ttrk.pack_host_outputs(out, ref_state.loss_of_lock)
    torch.cuda.synchronize()
    assert torch.equal(packed.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(tk.pack_carry(new), tk.pack_carry(ref_state))


def test_e5a_signal_level_chain_matches_jax():
    """tests/test_tracking.py::test_galileo_e5a_signal_level_chain's 2.2 s
    at 12 MSps (one E5a satellite with F/NAV symbols and the CS20 overlay,
    generated in memory with seed 71) through both packages' receivers:
    the same tracked PRN, carrier frequencies within 10 Hz of each other
    and of the truth, and the same CS20 symbol phase."""
    from gnss_sdr_tpu.io.sources import ArraySignalSource as JSource
    from gnss_sdr_tpu.models.nav import galileo_fnav
    from gnss_sdr_tpu.receiver.receiver import Receiver as JReceiver
    from gnss_sdr_tpu.receiver.receiver import ReceiverConfig as JConfig
    from gnss_sdr_tpu.utils import generator as jgen
    from gnss_sdr_tpu_torch.io.sources import ArraySignalSource
    from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig
    from test_lnav import sample_ephemeris

    from gnss_sdr_tpu import constants as jconst
    spec = jconst.SIGNALS["5X"]
    fs = 12.0e6
    prn, fd_true, delay_s = 2, 420.0, 3.1e-4
    sym01 = galileo_fnav.encode_stream(sample_ephemeris(), 352800.0,
                                       n_pages=1)
    x = jgen.generate(
        spec, [jgen.SatParams(prn=prn, cn0_dbhz=50.0, doppler_hz=fd_true,
                              code_delay_s=delay_s,
                              data_bits=jgen.lnav_bits_to_symbols(sym01))],
        fs, 2.2, seed=71)
    kw = dict(signal="5X", fs=fs, n_channels=1, prns=(prn,), chunk_ms=100,
              acq_doppler_step_hz=125.0, pll_bw_hz=25.0, dll_bw_hz=2.0,
              pvt_apply_tropo=False, pvt_apply_iono=False)
    jrx = JReceiver(JConfig(**kw))
    jrx.run_source(JSource(x, fs))
    trx = Receiver(ReceiverConfig(**kw), device="cpu")
    trx.run_source(ArraySignalSource(x, fs))
    assert trx.tracked_prns() == jrx.tracked_prns() == [prn]
    tcf = float(ttrk.as_state(trx.groups[0].trk_state).carrier_freq[0])
    jcf = float(jrx.trk_state.carrier_freq[0])
    assert abs(tcf - jcf) < 10.0 and abs(tcf - fd_true) < 10.0
    ttlm = trx.groups[0].channels[0].telemetry
    jtlm = jrx.groups[0].channels[0].telemetry
    assert type(ttlm).__name__ == "GalileoE5aTelemetry"
    assert ttlm.bit_phase == jtlm.bit_phase is not None
