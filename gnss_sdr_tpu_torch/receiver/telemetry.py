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


def make_telemetry(signal: str, prn: int):
    """Telemetry decoder factory by signal code (reference:
    GNSSBlockFactory::GetTlmBlock). GPS L1 C/A LNAV and Galileo E1-B I/NAV
    are ported so far."""
    if signal == "1C" and prn < 120:
        return GpsL1CaTelemetry(prn)
    if signal == "1B":
        return GalileoE1BTelemetry(prn)
    raise NotImplementedError(
        f"telemetry for signal {signal!r} PRN {prn} is not ported yet")
