"""Per-channel telemetry decoding: bit sync, frame sync, nav-message decode.

Host-side (numpy) — the symbol rate is 50-1000 Hz per channel, so this is
control-plane work, exactly as in the reference where
``gps_l1_ca_telemetry_decoder_gs.cc`` runs at the symbol rate. Input is the
prompt-correlator stream produced by the tracking scan.

The decoder also establishes the TOW <-> epoch-index mapping that Observables
uses to compute transmit times:
    t_tx(epoch e, chips into epoch x) =
        tow_ref + ((e - e_ref) * code_len + x) / code_rate
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnss_sdr_tpu_torch.models.nav import gps_lnav
from gnss_sdr_tpu_torch.models.ephemeris import KeplerEphemeris


@dataclasses.dataclass
class TowReference:
    """Anchors a channel's epoch counter to GPS time of week."""

    tow_s: float          # transmit time of the first chip of epoch `epoch`
    epoch: int
    polarity: int         # +1/-1 data polarity


def _overlay_phase_sync(p: np.ndarray, e0: int, seq_pm: np.ndarray,
                        skip: int = 100, min_blocks: int = 8,
                        margin: float = 1.5) -> int | None:
    """Estimate the secondary-code (NH/CS overlay) phase of a 1 ms prompt
    stream, robustly:

    - the first ``skip`` prompts are excluded (the FLL pull-in transient
      flips prompt signs and can push the correlation onto an overlay
      autocorrelation sidelobe — observed as an exactly-8-epoch transmit
      time bias on a re-acquired E5a channel);
    - the winning phase must beat the runner-up by ``margin`` (clean-signal
      main-to-sidelobe ratio is 5:1 for NH10/NH20/CS20), else return None
      and let the caller retry when more prompts have accumulated.
    """
    n = len(seq_pm)
    if len(p) <= skip + (min_blocks + 1) * n:
        return None
    p = p[skip:]
    e0 = e0 + skip
    mags = np.full(n, -1.0)
    for phase in range(n):
        off = (phase - e0) % n
        n_b = (len(p) - off) // n
        if n_b < min_blocks:
            continue
        seg = p[off: off + n_b * n].reshape(n_b, n)
        mags[phase] = float(np.abs(seg @ seq_pm).sum() / n_b)
    order = np.argsort(-mags)
    if mags[order[0]] <= 0 or mags[order[1]] * margin > mags[order[0]]:
        return None
    return int(order[0])


class GpsL1CaTelemetry:
    """GPS L1 C/A LNAV telemetry decoder for one channel.

    Feed it (epoch_index, prompt) pairs from tracking; it performs
    - bit sync: histogram of prompt-sign flips mod 20 epochs
      (reference: gps_l1_ca_telemetry_decoder_gs symbol-sync histogram)
    - frame sync: preamble search with parity validation, both polarities
    - subframe decode into a LnavAssembler (ephemeris/iono/UTC)
    """

    EPOCHS_PER_BIT = 20
    CODE_PERIOD_S = 1e-3

    def __init__(self, prn: int, bit_sync_min_flips: int = 8):
        self.prn = prn
        self._epochs = np.zeros(0, np.int64)
        self._prompts = np.zeros(0, np.float64)
        self._hist = np.zeros(self.EPOCHS_PER_BIT, np.int64)
        self._last_hist_pos = 0
        self.bit_phase: int | None = None
        self.bit_sync_min_flips = bit_sync_min_flips
        self.tow_ref: TowReference | None = None
        self.assembler = gps_lnav.LnavAssembler(prn)
        self._decoded_upto_bit = 0
        self.subframe_count = 0

    # ------------------------------------------------------------------ feed
    def push(self, epoch_indices: np.ndarray, prompts_i: np.ndarray) -> None:
        """Append valid tracking epochs (gapless epoch counter expected)."""
        if len(epoch_indices) == 0:
            return
        self._epochs = np.concatenate([self._epochs, np.asarray(epoch_indices, np.int64)])
        self._prompts = np.concatenate([self._prompts, np.asarray(prompts_i, np.float64)])
        self._update_bit_sync()
        if self.bit_phase is not None:
            self._decode_bits()

    # ------------------------------------------------------------- bit sync
    def _update_bit_sync(self) -> None:
        if self.bit_phase is not None:
            return
        p = self._prompts
        e = self._epochs
        i0 = max(self._last_hist_pos, 1)
        for i in range(i0, len(p)):
            if np.sign(p[i]) != np.sign(p[i - 1]) and p[i] != 0 and p[i - 1] != 0:
                self._hist[int(e[i]) % self.EPOCHS_PER_BIT] += 1
        self._last_hist_pos = len(p)
        h = np.sort(self._hist)[::-1]
        if h[0] >= self.bit_sync_min_flips and h[0] >= 3 * h[1] + 1:
            self.bit_phase = int(np.argmax(self._hist))

    # ------------------------------------------------------------ bit stream
    def _bits(self) -> tuple[np.ndarray, np.ndarray]:
        """(soft_bits, bit_start_epochs): integrate prompts over bit periods.

        Bit k covers epochs [phase + k*20, phase + (k+1)*20).
        """
        ph = self.bit_phase
        e0 = int(self._epochs[0])
        # first full bit boundary at epoch >= e0 with epoch % 20 == ph
        start = e0 + (ph - e0) % self.EPOCHS_PER_BIT
        off = start - e0
        n_bits = (len(self._prompts) - off) // self.EPOCHS_PER_BIT
        if n_bits <= 0:
            return np.zeros(0), np.zeros(0, np.int64)
        seg = self._prompts[off: off + n_bits * self.EPOCHS_PER_BIT]
        soft = seg.reshape(n_bits, self.EPOCHS_PER_BIT).sum(axis=1)
        starts = start + np.arange(n_bits, dtype=np.int64) * self.EPOCHS_PER_BIT
        return soft, starts

    # ----------------------------------------------------------- frame sync
    def _decode_bits(self) -> None:
        soft, starts = self._bits()
        n = len(soft)
        if n < 308:
            return
        signs = np.where(soft >= 0, 1, -1).astype(np.int8)
        pre_pm = (1 - 2 * gps_lnav.PREAMBLE.astype(np.int8))

        if self.tow_ref is None:
            # search first parity-valid subframe with preamble
            for i in range(0, n - 308):
                c = int(np.dot(signs[i:i + 8], pre_pm))
                if abs(c) != 8:
                    continue
                pol = 1 if c == 8 else -1
                bits01 = ((1 - pol * signs[i:i + 300]) // 2).astype(np.uint8)
                sf = gps_lnav.decode_subframe(bits01)
                if sf is None:
                    continue
                self.tow_ref = TowReference(tow_s=sf.tow_s, epoch=int(starts[i]),
                                            polarity=pol)
                self.assembler.push(sf)
                self.subframe_count += 1
                self._decoded_upto_bit = i + 300
                break
            if self.tow_ref is None:
                return

        # decode every further complete subframe (300-bit aligned)
        pol = self.tow_ref.polarity
        self._decode_rest(pol)

    @property
    def half_cycle(self) -> float:
        """Carrier half-cycle correction in cycles: the Costas loop locks
        equally at 0 or 180 deg; an inverted LNAV preamble means the NCO
        phase is off by half a cycle (reference
        flag_PLL_180_deg_phase_locked — which the reference only uses to
        re-invert symbols; here the observables also repair the carrier
        phase so undifferenced ambiguities stay integer)."""
        if self.tow_ref is not None and self.tow_ref.polarity < 0:
            return 0.5
        return 0.0

    def _decode_rest(self, pol: int) -> None:
        soft, _ = self._bits()
        n = len(soft)
        signs = np.where(soft >= 0, 1, -1).astype(np.int8)
        while self._decoded_upto_bit + 300 <= n:
            i = self._decoded_upto_bit
            bits01 = ((1 - pol * signs[i:i + 300]) // 2).astype(np.uint8)
            sf = gps_lnav.decode_subframe(bits01)
            if sf is not None:
                self.assembler.push(sf)
                self.subframe_count += 1
            self._decoded_upto_bit = i + 300

    # ------------------------------------------------------------ queries
    @property
    def have_tow(self) -> bool:
        return self.tow_ref is not None

    def transmit_time(self, epoch: int, chips: float, code_len: int = 1023,
                      code_rate: float = 1.023e6) -> float | None:
        """Transmit time (s of week) of the sample at `chips` into epoch."""
        if self.tow_ref is None:
            return None
        de = epoch - self.tow_ref.epoch
        return self.tow_ref.tow_s + (de * code_len + chips) / code_rate

    def ephemeris(self) -> KeplerEphemeris | None:
        return self.assembler.ephemeris()


class GalileoE1BTelemetry:
    """Galileo E1-B I/NAV telemetry decoder for one channel.

    One tracking epoch (4 ms primary code) = one 250 sps symbol, so there is
    no bit-sync stage; page sync = the 10-symbol preamble + CRC validation
    (reference: galileo_telemetry_decoder_gs.cc:210-247 — deinterleave,
    Viterbi with inverted G2, CRC check).
    """

    PAGE_SYMBOLS = 500

    def __init__(self, prn: int):
        from gnss_sdr_tpu_torch.models.nav import galileo_inav
        self._gi = galileo_inav
        self.prn = prn
        self._epochs = np.zeros(0, np.int64)
        self._soft = np.zeros(0, np.float64)   # soft symbols, + == bit 1
        self.assembler = galileo_inav.InavAssembler(prn)
        self.page_phase: int | None = None     # epoch index mod 500 of page start
        self.polarity = 1.0
        self._decoded_upto = 0
        self.page_count = 0
        self.tow_ref: TowReference | None = None

    def push(self, epoch_indices: np.ndarray, prompts_i: np.ndarray) -> None:
        if len(epoch_indices) == 0:
            return
        self._epochs = np.concatenate([self._epochs, np.asarray(epoch_indices, np.int64)])
        # chip convention: bit b -> amplitude (1-2b); soft(+ == bit1) = -I
        self._soft = np.concatenate([self._soft, -np.asarray(prompts_i, np.float64)])
        self._decode()

    def _try_page_at(self, i: int):
        seg = self._soft[i: i + self.PAGE_SYMBOLS]
        if len(seg) < self.PAGE_SYMBOLS:
            return None
        return self._gi.decode_page(seg)

    def _decode(self) -> None:
        e0 = int(self._epochs[0])
        if self.page_phase is None:
            n = len(self._soft)
            for i in range(0, n - self.PAGE_SYMBOLS):
                res = self._try_page_at(i)
                if res is None:
                    continue
                self.page_phase = (e0 + i) % self.PAGE_SYMBOLS
                self._decoded_upto = i
                break
            if self.page_phase is None:
                return
        while self._decoded_upto + self.PAGE_SYMBOLS <= len(self._soft):
            i = self._decoded_upto
            res = self._try_page_at(i)
            if res is not None:
                wt, fields = res
                first_epoch = e0 + i
                self.assembler.push(self._gi.InavPage(wt, fields, first_epoch))
                self.page_count += 1
                if wt == 5 and "tow" in fields:
                    self.tow_ref = TowReference(tow_s=fields["tow"],
                                                epoch=first_epoch, polarity=1)
            self._decoded_upto = i + self.PAGE_SYMBOLS

    @property
    def have_tow(self) -> bool:
        return self.tow_ref is not None

    def transmit_time(self, epoch: int, chips: float, code_len: int = 4092,
                      code_rate: float = 1.023e6) -> float | None:
        if self.tow_ref is None:
            return None
        de = epoch - self.tow_ref.epoch
        return self.tow_ref.tow_s + (de * code_len + chips) / code_rate

    def ephemeris(self) -> KeplerEphemeris | None:
        return self.assembler.ephemeris()


class _History:
    """A channel's (epoch, prompt) history, appended in place: the buffers
    grow by doubling, so a push copies what it adds, not the whole
    history."""

    def __init__(self):
        self._e = np.zeros(0, np.int64)
        self._p = np.zeros(0, np.float64)
        self.n = 0

    def append(self, epoch_indices, prompts_i) -> None:
        need = self.n + len(epoch_indices)
        if need > len(self._e):
            cap = max(need, 2 * len(self._e), 1024)
            e, p = np.empty(cap, np.int64), np.empty(cap, np.float64)
            e[: self.n], p[: self.n] = self.epochs, self.prompts
            self._e, self._p = e, p
        self._e[self.n: need] = np.asarray(epoch_indices, np.int64)
        self._p[self.n: need] = np.asarray(prompts_i, np.float64)
        self.n = need

    @property
    def epochs(self) -> np.ndarray:
        return self._e[: self.n]

    @property
    def prompts(self) -> np.ndarray:
        return self._p[: self.n]


def _cnav_frame_search(fec, cnav, soft: np.ndarray, start: int, end: int,
                       block: int = 64) -> tuple[int, float] | None:
    """The first (offset, polarity) with start <= offset < end, +1 before
    -1 at each offset, at which 612 soft symbols Viterbi-decode to a CNAV
    message whose preamble and CRC check: the order in which the JAX
    decoders try them one at a time. Offsets are decoded ``block`` at a
    time (one batched Viterbi), which finds the same first one."""
    for b0 in range(start, end, block):
        offs = range(b0, min(b0 + block, end))
        win = np.stack([soft[o: o + 612] for o in offs])
        bits = fec.viterbi_decode(np.stack([win, -win], axis=1), 300)
        for i, off in enumerate(offs):
            for k, pol in enumerate((1.0, -1.0)):
                if cnav.decode_message(bits[i, k]) is not None:
                    return off, pol
    return None


class GpsL2CMTelemetry:
    """GPS L2C CNAV telemetry: 1 symbol per 20 ms CM code epoch (50 sps),
    continuous K=7 r=1/2 FEC, CRC-24Q framing.

    Reference analog: gps_l2c_telemetry_decoder_gs.cc + libswiftcnav.
    Frame sync: try both FEC phase hypotheses (symbol pairing) x polarity and
    scan Viterbi output for preamble + CRC. The search resumes at the first
    offset a push has not tried (the JAX package restarts it at 0 on every
    push; an offset tried saw the same symbols and failed, so both find the
    same anchor).
    """

    MSG_SYMBOLS = 600               # 300 bits * 2 symbols at r=1/2
    MSG_PERIOD_S = 12.0

    def __init__(self, prn: int):
        from gnss_sdr_tpu_torch.models.nav import fec, gps_cnav
        self._fec = fec
        self._cnav = gps_cnav
        self.prn = prn
        self._hist = _History()
        self.assembler = gps_cnav.CnavAssembler(prn)
        self.tow_ref: TowReference | None = None
        self._frame_anchor: tuple[int, float] | None = None  # (sym_off, pol)
        self._search_from = 0     # the first frame offset not yet tried
        self._decoded_upto = 0
        self.message_count = 0

    def push(self, epoch_indices, prompts_i) -> None:
        if len(epoch_indices) == 0:
            return
        self._hist.append(epoch_indices, prompts_i)
        self._decode()

    def _try_decode_at(self, soft: np.ndarray, off: int, pol: float):
        """Viterbi-decode 600 symbols -> 300 bits, validate preamble+CRC."""
        sym = pol * soft[off: off + self.MSG_SYMBOLS + 12]
        if len(sym) < self.MSG_SYMBOLS + 12:
            return None
        bits = self._fec.viterbi_decode(sym, 300)
        return self._cnav.decode_message(bits)

    def _decode(self) -> None:
        soft = -self._hist.prompts          # + == bit 1
        n = len(soft)
        if self._frame_anchor is None:
            end = min(n - (self.MSG_SYMBOLS + 12), 1300)
            self._frame_anchor = _cnav_frame_search(
                self._fec, self._cnav, soft, self._search_from, end)
            if self._frame_anchor is None:
                self._search_from = max(self._search_from, end)
                return
            self._decoded_upto = self._frame_anchor[0]
        _, pol = self._frame_anchor
        while self._decoded_upto + self.MSG_SYMBOLS + 12 <= n:
            off = self._decoded_upto
            res = self._try_decode_at(soft, off, pol)
            if res is not None:
                mtype, prn, tow, fields = res
                self.assembler.push(mtype, fields)
                self.message_count += 1
                # CNAV TOW is the time of the NEXT message start (12 s later
                # on L2C); this message started 12 s before that epoch tag.
                self.tow_ref = TowReference(
                    tow_s=tow - self.MSG_PERIOD_S,
                    epoch=int(self._hist.epochs[0]) + off, polarity=1)
            self._decoded_upto = off + self.MSG_SYMBOLS

    @property
    def half_cycle(self) -> float:
        """+0.5 when the FEC frame sync chose the inverted polarity, i.e.
        the Costas loop locked 180 deg off (see GpsL1CaTelemetry)."""
        if self._frame_anchor is not None and self._frame_anchor[1] < 0:
            return 0.5
        return 0.0

    @property
    def have_tow(self) -> bool:
        return self.tow_ref is not None

    def transmit_time(self, epoch: int, chips: float, code_len: int = 10230,
                      code_rate: float = 0.5115e6) -> float | None:
        if self.tow_ref is None:
            return None
        de = epoch - self.tow_ref.epoch
        return self.tow_ref.tow_s + (de * code_len + chips) / code_rate

    def ephemeris(self):
        return self.assembler.ephemeris()


class GpsL5ITelemetry:
    """GPS L5I CNAV telemetry: 1 ms primary-code epochs carry
    symbol * NH10[epoch phase]; the 10-bit Neuman-Hofman overlay gives 10 ms
    symbol sync, then 100 sps symbols feed the continuous K=7 r=1/2 FEC and
    CRC-24Q CNAV framing shared with L2C (models/nav/gps_cnav).

    Reference analog: gps_l5_telemetry_decoder_gs.cc:1-280 (NH sync + the
    libswiftcnav cnav_msg_decoder) — message period 6 s at 50 bps.
    """

    NH_EPOCHS = 10
    MSG_SYMBOLS = 600               # 300 bits * 2 symbols at r=1/2
    MSG_PERIOD_S = 6.0

    def __init__(self, prn: int):
        from gnss_sdr_tpu_torch import constants
        from gnss_sdr_tpu_torch.models.nav import fec, gps_cnav
        self._fec = fec
        self._cnav = gps_cnav
        nh = constants.GPS_L5_I.secondary_code
        self.NH10 = np.array([int(b) for b in nh], np.uint8)
        self.prn = prn
        self._hist = _History()
        self.assembler = gps_cnav.CnavAssembler(prn)
        self.bit_phase: int | None = None        # epoch phase of symbol start
        self.tow_ref: TowReference | None = None
        self._frame_anchor: tuple[int, float] | None = None  # (sym_off, pol)
        self._search_from = 0     # the first frame offset not yet tried
        self._decoded_upto = 0
        self.message_count = 0

    def push(self, epoch_indices, prompts_i) -> None:
        if len(epoch_indices) == 0:
            return
        self._hist.append(epoch_indices, prompts_i)
        self._decode()

    def _symbols(self):
        """NH10-wipe and integrate 1 ms prompts to 100 sps soft symbols
        (+amp == bit 1); returns (soft, start_epochs)."""
        nh_pm = 1.0 - 2.0 * self.NH10.astype(np.float64)
        p = self._hist.prompts
        e0 = int(self._hist.epochs[0])
        n_nh = self.NH_EPOCHS
        if self.bit_phase is None:
            self.bit_phase = _overlay_phase_sync(p, e0, nh_pm)
            if self.bit_phase is None:
                return None, None
        off = (self.bit_phase - e0) % n_nh
        n_b = (len(p) - off) // n_nh
        if n_b <= 0:
            return None, None
        seg = p[off: off + n_b * n_nh].reshape(n_b, n_nh)
        # chip bit b -> amplitude (1-2b): soft(+ == bit1) = -(I @ nh_pm)
        soft = -(seg @ nh_pm)
        starts = e0 + off + np.arange(n_b, dtype=np.int64) * n_nh
        return soft, starts

    def _try_decode_at(self, soft: np.ndarray, off: int, pol: float):
        sym = pol * soft[off: off + self.MSG_SYMBOLS + 12]
        if len(sym) < self.MSG_SYMBOLS + 12:
            return None
        bits = self._fec.viterbi_decode(sym, 300)
        return self._cnav.decode_message(bits)

    def _decode(self) -> None:
        soft, starts = self._symbols()
        if soft is None:
            return
        n = len(soft)
        if self._frame_anchor is None:
            # the frame search resumes where the last push left it: an
            # offset already tried saw the same soft symbols and failed
            end = min(n - (self.MSG_SYMBOLS + 12), 1300)
            self._frame_anchor = _cnav_frame_search(
                self._fec, self._cnav, soft, self._search_from, end)
            if self._frame_anchor is None:
                self._search_from = max(self._search_from, end)
                return
            self._decoded_upto = self._frame_anchor[0]
        _, pol = self._frame_anchor
        while self._decoded_upto + self.MSG_SYMBOLS + 12 <= n:
            off = self._decoded_upto
            res = self._try_decode_at(soft, off, pol)
            if res is not None:
                mtype, prn, tow, fields = res
                self.assembler.push(mtype, fields)
                self.message_count += 1
                # CNAV TOW tags the start of the NEXT message (6 s on L5)
                self.tow_ref = TowReference(
                    tow_s=tow - self.MSG_PERIOD_S,
                    epoch=int(starts[off]), polarity=1)
            self._decoded_upto = off + self.MSG_SYMBOLS

    @property
    def half_cycle(self) -> float:
        """+0.5 when the FEC frame sync chose the inverted polarity, i.e.
        the Costas loop locked 180 deg off (see GpsL1CaTelemetry)."""
        if self._frame_anchor is not None and self._frame_anchor[1] < 0:
            return 0.5
        return 0.0

    @property
    def have_tow(self) -> bool:
        return self.tow_ref is not None

    @property
    def sync_failed(self) -> bool:
        """Overlay sync watchdog: no NH phase after ~6 s of prompts means
        the channel is mistracking (e.g. the half-cycle-per-epoch carrier
        false lock) — signal the receiver to drop and reacquire."""
        return self.bit_phase is None and self._hist.n > 6000

    def transmit_time(self, epoch: int, chips: float, code_len: int = 10230,
                      code_rate: float = 10.23e6) -> float | None:
        if self.tow_ref is None:
            return None
        de = epoch - self.tow_ref.epoch
        return self.tow_ref.tow_s + (de * code_len + chips) / code_rate

    def ephemeris(self):
        return self.assembler.ephemeris()


class GalileoE5aTelemetry:
    """Galileo E5a-I F/NAV telemetry decoder for one channel.

    Reference analog: the E5a branch of galileo_telemetry_decoder_gs.cc.
    Each 1 ms primary-code epoch carries symbol * CS20[epoch phase]; the CS20
    secondary code (constants.GALILEO_E5A_I.secondary_code) gives 20 ms
    symbol sync, then pages (500 symbols / 10 s) are sync-word aligned,
    deinterleaved, Viterbi-decoded and CRC-checked in models/nav/galileo_fnav.
    """

    PAGE_SYMBOLS = 500

    def __init__(self, prn: int):
        from gnss_sdr_tpu_torch import constants
        from gnss_sdr_tpu_torch.models.nav import galileo_fnav
        self._gf = galileo_fnav
        self.prn = prn
        cs = constants.GALILEO_E5A_I.secondary_code
        self.CS20 = np.array([int(b) for b in cs], np.uint8)
        self._hist = _History()
        self.assembler = galileo_fnav.FnavAssembler(prn)
        self.bit_phase: int | None = None       # epoch phase of symbol start
        self.page_phase: int | None = None      # symbol index of page start
        self._search_from = 0     # the first page offset not yet tried
        self._decoded_upto = 0
        self.page_count = 0
        self.tow_ref: TowReference | None = None

    def push(self, epoch_indices, prompts_i) -> None:
        if len(epoch_indices) == 0:
            return
        self._hist.append(epoch_indices, prompts_i)
        self._decode()

    def _symbols(self):
        """CS20-wipe and integrate 1 ms prompts to 50 sps soft symbols
        (+amp == bit 1)."""
        cs_pm = 1.0 - 2.0 * self.CS20.astype(np.float64)
        p = self._hist.prompts
        e0 = int(self._hist.epochs[0])
        if self.bit_phase is None:
            self.bit_phase = _overlay_phase_sync(p, e0, cs_pm)
            if self.bit_phase is None:
                return None, None
        off = (self.bit_phase - e0) % 20
        n_b = (len(p) - off) // 20
        if n_b <= 0:
            return None, None
        seg = p[off: off + n_b * 20].reshape(n_b, 20)
        # chip bit b -> amplitude (1-2b): soft(+ == bit1) = -(I @ cs_pm)
        soft = -(seg @ cs_pm)
        starts = e0 + off + np.arange(n_b, dtype=np.int64) * 20
        return soft, starts

    def _decode(self) -> None:
        soft, starts = self._symbols()
        if soft is None:
            return
        n = len(soft)
        if self.page_phase is None:
            # the page search resumes where the last push left it: an
            # offset already tried saw the same soft symbols and failed
            end = n - self.PAGE_SYMBOLS
            for i in range(self._search_from, end):
                if self._gf.decode_page(soft[i: i + self.PAGE_SYMBOLS]):
                    self.page_phase = i % self.PAGE_SYMBOLS
                    self._decoded_upto = i
                    break
            if self.page_phase is None:
                self._search_from = max(self._search_from, end)
                return
        while self._decoded_upto + self.PAGE_SYMBOLS <= n:
            i = self._decoded_upto
            res = self._gf.decode_page(soft[i: i + self.PAGE_SYMBOLS])
            if res is not None:
                ptype, fields = res
                self.assembler.push(ptype, fields)
                self.page_count += 1
                if "tow" in fields:
                    self.tow_ref = TowReference(
                        tow_s=fields["tow"], epoch=int(starts[i]), polarity=1)
            self._decoded_upto = i + self.PAGE_SYMBOLS

    @property
    def have_tow(self) -> bool:
        return self.tow_ref is not None

    @property
    def sync_failed(self) -> bool:
        return self.bit_phase is None and self._hist.n > 6000

    def transmit_time(self, epoch: int, chips: float, code_len: int = 10230,
                      code_rate: float = 10.23e6) -> float | None:
        if self.tow_ref is None:
            return None
        de = epoch - self.tow_ref.epoch
        return self.tow_ref.tow_s + (de * code_len + chips) / code_rate

    def ephemeris(self) -> KeplerEphemeris | None:
        return self.assembler.ephemeris()


class GlonassL1CaTelemetry:
    """GLONASS L1 / L2 C/A GNAV telemetry: 1 ms epochs -> 100 sps half-bit
    stream, time-mark sync, meander stripping, Hamming-checked strings.

    Reference analog: glonass_l1_ca_telemetry_decoder_gs.cc.
    """

    SLOTS_PER_STRING = 200   # 170 half-bits + 30 time-mark chips, 10 ms each

    def __init__(self, prn: int):
        from gnss_sdr_tpu_torch.models.nav import glonass_gnav
        self._gn = glonass_gnav
        self.prn = prn
        self._hist = _History()
        self.assembler = glonass_gnav.GnavAssembler(prn)
        self._anchor: tuple[int, float] | None = None  # (slot0 epoch, polarity)
        self._decoded_upto = 0
        self.string_count = 0
        self.tow_ref: TowReference | None = None
        self.tk_ref: tuple[float, int] | None = None   # (tk_s, epoch at string start)

    def push(self, epoch_indices, prompts_i) -> None:
        if len(epoch_indices) == 0:
            return
        self._hist.append(epoch_indices, prompts_i)
        self._decode()

    def _slots(self, phase: int) -> np.ndarray:
        """Integrate 1 kHz prompts into 100 sps slots at a given ms phase."""
        p = self._hist.prompts
        e0 = int(self._hist.epochs[0])
        start = (phase - e0) % 10
        n_slots = (len(p) - start) // 10
        if n_slots <= 0:
            return np.zeros(0)
        return p[start: start + n_slots * 10].reshape(n_slots, 10).sum(axis=1)

    def _decode(self) -> None:
        gn = self._gn
        mark_pm = 1.0 - 2.0 * gn.TIME_MARK.astype(np.float64)
        prompts = self._hist.prompts
        e0 = int(self._hist.epochs[0])
        if self._anchor is None:
            # slot (10 ms) phase FIRST, by integration energy: a time-mark
            # pattern still sign-matches at a few-ms phase error, so taking
            # the first matching phase anchored transmit time up to 9 ms
            # off (integer-ms pseudorange biases); the correct phase
            # maximizes the mean |10 ms sum| sharply. The pull-in transient
            # is excluded like _overlay_phase_sync.
            if len(prompts) < 2400:
                return
            skip = 100
            energies = np.full(10, -1.0)
            for phase in range(10):
                start = (phase - (e0 + skip)) % 10 + skip
                n_slots = (len(prompts) - start) // 10
                if n_slots < 200:
                    continue
                seg = prompts[start: start + n_slots * 10]
                energies[phase] = float(np.mean(np.abs(
                    seg.reshape(n_slots, 10).sum(axis=1))))
            order = np.argsort(-energies)
            if (energies[order[0]] <= 0
                    or energies[order[1]] * 1.1 > energies[order[0]]):
                return                    # ambiguous: wait for more prompts
            phase = int(order[0])
            slots = self._slots(phase)
            s = np.sign(slots)
            for i in range(len(slots) - 30):
                c = float(np.dot(s[i: i + 30], mark_pm))
                if abs(c) >= 28:
                    pol = 1.0 if c > 0 else -1.0
                    # string data begins right after the time mark
                    start_ep = e0 + ((phase - e0) % 10) + (i + 30) * 10
                    self._anchor = (start_ep, pol)
                    self._phase = phase
                    self._decoded_upto = i + 30
                    break
            if self._anchor is None:
                return
        slots = self._slots(self._phase)
        start_ep, pol = self._anchor
        while self._decoded_upto + self.SLOTS_PER_STRING <= len(slots):
            i = self._decoded_upto
            seg = pol * slots[i: i + 170]
            soft_bits = seg[0::2] - seg[1::2]          # meander stripping
            bits = (soft_bits < 0).astype(np.uint8)    # +amp == bit 0 (chip conv)
            res = gn.decode_string(bits)
            if res is not None:
                sid, fields = res
                self.assembler.push(sid, fields)
                self.string_count += 1
                if sid == 1 and "tk_s" in fields:
                    string_start_ep = e0 + ((self._phase - e0) % 10) + i * 10
                    self.tk_ref = (fields["tk_s"], string_start_ep)
            self._decoded_upto = i + self.SLOTS_PER_STRING

    @property
    def have_tow(self) -> bool:
        return self.tk_ref is not None

    def transmit_time(self, epoch: int, chips: float, code_len: int = 511,
                      code_rate: float = 0.511e6) -> float | None:
        """GLONASS time of day (Moscow) — caller handles timescale offsets."""
        if self.tk_ref is None:
            return None
        tk, e0 = self.tk_ref
        return tk + ((epoch - e0) * code_len + chips) / code_rate

    def ephemeris(self):
        return self.assembler.ephemeris()


class BeidouB1ITelemetry:
    """BeiDou B1I D1 telemetry: NH20-modulated 50 bps, BCH-checked subframes.

    Reference analog: beidou_b1i_telemetry_decoder_gs.cc. Each 1 ms epoch
    prompt = data_bit * NH20[epoch % 20]; bit sync correlates against the NH
    sequence, then subframes are preamble-synced and BCH-validated. The
    preamble search resumes at the first bit a push has not tried (the JAX
    package restarts it at 0 on every push; once the NH phase is fixed a
    bit's soft value never changes, so both find the same anchor).
    """

    NH20 = np.array([0, 0, 0, 0, 0, 1, 0, 0, 1, 1, 0, 1, 0, 1, 0, 0, 1, 1, 1,
                     0], np.uint8)

    def __init__(self, prn: int):
        from gnss_sdr_tpu_torch.models.nav import beidou_d1
        self._d1 = beidou_d1
        self.prn = prn
        self._hist = _History()
        self.assembler = beidou_d1.D1Assembler(prn)
        self.bit_phase: int | None = None
        self._polarity = 1.0
        self.tow_ref: TowReference | None = None
        self._frame_anchor_bit: int | None = None
        self._search_from = 0     # the first bit the preamble search skips
        self._decoded_upto = 0
        self.subframe_count = 0

    def push(self, epoch_indices, prompts_i) -> None:
        if len(epoch_indices) == 0:
            return
        self._hist.append(epoch_indices, prompts_i)
        self._decode()

    def _bits(self):
        """NH-wipe and integrate to 50 bps soft bits."""
        nh_pm = 1.0 - 2.0 * self.NH20.astype(np.float64)
        p = self._hist.prompts
        e0 = int(self._hist.epochs[0])
        if self.bit_phase is None:
            self.bit_phase = _overlay_phase_sync(p, e0, nh_pm)
            if self.bit_phase is None:
                return None, None
        off = (self.bit_phase - e0) % 20
        n_b = (len(p) - off) // 20
        if n_b <= 0:
            return None, None
        seg = p[off: off + n_b * 20].reshape(n_b, 20)
        soft = seg @ nh_pm
        starts = e0 + off + np.arange(n_b, dtype=np.int64) * 20
        return soft, starts

    def _decode(self) -> None:
        soft, starts = self._bits()
        if soft is None:
            return
        n = len(soft)
        pre_pm = 1.0 - 2.0 * self._d1.PREAMBLE.astype(np.float64)
        if self._frame_anchor_bit is None:
            for i in range(self._search_from, n - 300):
                c = float(np.dot(np.sign(soft[i: i + 11]), pre_pm))
                if abs(c) != 11:
                    continue
                pol = 1.0 if c > 0 else -1.0
                bits = ((1 - pol * np.sign(soft[i: i + 300])) // 2
                        ).astype(np.uint8)
                if self._d1.decode_subframe(bits) is None:
                    continue
                self._frame_anchor_bit = i
                self._polarity = pol
                self._decoded_upto = i
                break
            if self._frame_anchor_bit is None:
                self._search_from = max(self._search_from, n - 300)
                return
        while self._decoded_upto + 300 <= n:
            i = self._decoded_upto
            bits = ((1 - self._polarity * np.sign(soft[i: i + 300])) // 2
                    ).astype(np.uint8)
            out = self._d1.decode_subframe(bits)
            if out is not None:
                fraid, sow, fields = out
                self.assembler.push(fraid, fields)
                self.subframe_count += 1
                self.tow_ref = TowReference(tow_s=sow, epoch=int(starts[i]),
                                            polarity=int(self._polarity))
            self._decoded_upto = i + 300

    @property
    def have_tow(self) -> bool:
        return self.tow_ref is not None

    @property
    def sync_failed(self) -> bool:
        return self.bit_phase is None and self._hist.n > 6000

    def transmit_time(self, epoch: int, chips: float, code_len: int = 2046,
                      code_rate: float = 2.046e6) -> float | None:
        """BDT seconds of week (BDT = GPS time - 14 s at the system level)."""
        if self.tow_ref is None:
            return None
        de = epoch - self.tow_ref.epoch
        return self.tow_ref.tow_s + (de * code_len + chips) / code_rate

    def ephemeris(self):
        return self.assembler.ephemeris()


class BeidouB1IGeoTelemetry:
    """BeiDou B1I / B3I D2 telemetry (GEO PRN 1-5): 500 bps, no NH overlay.

    Reference analog: the D2 branch of beidou_b1i_telemetry_decoder_gs.cc.
    One bit = 2 code epochs; subframe-1 pages (300 bits / 0.6 s) carry the
    ephemeris split over ten pages (models/nav/beidou_d2.py).
    """

    def __init__(self, prn: int):
        from gnss_sdr_tpu_torch.models.nav import beidou_d2
        self._d2 = beidou_d2
        self.prn = prn
        self.assembler = beidou_d2.D2Assembler(prn)
        self._hist = _History()
        self.bit_phase: int | None = None      # epoch phase of bit start
        self._polarity = 1.0
        self._anchor: int | None = None        # bit index of a page start
        self._decoded_upto = 0
        self.page_count = 0
        self.tow_ref: TowReference | None = None

    def push(self, epoch_indices, prompts_i) -> None:
        if len(epoch_indices) == 0:
            return
        self._hist.append(epoch_indices, prompts_i)
        self._decode()

    def _bits(self):
        p = self._hist.prompts
        e0 = int(self._hist.epochs[0])
        if self.bit_phase is None:
            if len(p) < 600:
                return None, None
            best, best_e = None, -1.0
            for ph in range(2):
                off = (ph - e0) % 2
                n_b = (len(p) - off) // 2
                seg = p[off: off + 2 * n_b].reshape(n_b, 2).sum(axis=1)
                e = float(np.mean(np.abs(seg)))
                if e > best_e:
                    best_e, best = e, ph
            self.bit_phase = best
        off = (self.bit_phase - e0) % 2
        n_b = (len(p) - off) // 2
        soft = p[off: off + 2 * n_b].reshape(n_b, 2).sum(axis=1)
        starts = e0 + off + np.arange(n_b, dtype=np.int64) * 2
        return soft, starts

    def _decode(self) -> None:
        soft, starts = self._bits()
        if soft is None:
            return
        n = len(soft)
        pre_pm = 1.0 - 2.0 * self._d2.d1.PREAMBLE.astype(np.float64)
        if self._anchor is None:
            for i in range(0, n - 300):
                c = float(np.dot(np.sign(soft[i: i + 11]), pre_pm))
                if abs(c) != 11:
                    continue
                pol = 1.0 if c > 0 else -1.0
                bits = ((1 - pol * np.sign(soft[i: i + 300])) // 2
                        ).astype(np.uint8)
                if self._d2.decode_page(bits) is None:
                    continue
                self._anchor = i
                self._polarity = pol
                self._decoded_upto = i
                break
            if self._anchor is None:
                return
        while self._decoded_upto + 300 <= n:
            i = self._decoded_upto
            bits = ((1 - self._polarity * np.sign(soft[i: i + 300])) // 2
                    ).astype(np.uint8)
            res = self._d2.decode_page(bits)
            if res is not None:
                pnum, sow, fields = res
                self.assembler.push(pnum, fields)
                self.page_count += 1
                # SOW marks page 1 of the 6 s cycle; this page started
                # 0.6*(pnum-1) later (integer SOW, sub-second page starts)
                self.tow_ref = TowReference(
                    tow_s=sow + 0.6 * (pnum - 1), epoch=int(starts[i]),
                    polarity=int(self._polarity))
            self._decoded_upto = i + 300

    @property
    def have_tow(self) -> bool:
        return self.tow_ref is not None

    def transmit_time(self, epoch: int, chips: float, code_len: int = 2046,
                      code_rate: float = 2.046e6) -> float | None:
        """BDT seconds of week."""
        if self.tow_ref is None:
            return None
        de = epoch - self.tow_ref.epoch
        return self.tow_ref.tow_s + (de * code_len + chips) / code_rate

    def ephemeris(self):
        return self.assembler.ephemeris()


def make_telemetry(signal: str, prn: int):
    """Telemetry decoder factory by signal code (reference:
    GNSSBlockFactory::GetTlmBlock). Every decoder of the JAX package is
    ported but SBAS L1 (PRN >= 120)."""
    if signal == "1C" and prn < 120:
        return GpsL1CaTelemetry(prn)
    if signal == "1B":
        return GalileoE1BTelemetry(prn)
    if signal == "2S":
        return GpsL2CMTelemetry(prn)
    if signal == "L5":
        return GpsL5ITelemetry(prn)
    if signal in ("1G", "2G"):
        return GlonassL1CaTelemetry(prn)
    if signal in ("B1", "B3"):
        if prn <= 5:                   # GEO satellites transmit D2 at 500 bps
            return BeidouB1IGeoTelemetry(prn)
        return BeidouB1ITelemetry(prn)
    if signal == "5X":
        return GalileoE5aTelemetry(prn)
    raise NotImplementedError(
        f"telemetry for signal {signal!r} PRN {prn} is not ported yet")
