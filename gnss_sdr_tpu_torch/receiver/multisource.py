"""Multi-source, multi-rate receiver: N signal sources -> one PVT.

Port of gnss_sdr_tpu/receiver/multisource.py, the analog of the
reference's multi-source flowgraph (``gnss_flowgraph.cc:126-737``
instantiating ``sources_count`` signal sources, each with its own
SignalConditioner chain at its own sample rate, fanned into one channel set
via per-channel ``RF_channel_ID``; ``conf/gnss-sdr_multisource_Hybrid_ishort
.conf``).

Design: each source drives a **branch**, a full per-source port
``Receiver`` (its own internal rate, conditioner, signal groups, tracking
kernel launches and carry) with branch-level PVT disabled, every branch on
the one device given to :class:`MultiSourceReceiver`. All branches share ONE
ephemeris store and one receiver-clock origin per time scale; their
per-epoch observables merge on the common 20 ms tick grid (the captures
start at the same instant, so tick k of any branch is the same receiver
time) and a single PVT runs over the union: dual-band processing (L1 at
2 MSps + L5 at 12 MSps from two separate captures) and dual-frequency PPP
on the receiver's own observables (``obs_sinks``). Branches are serviced in
receiver-time order so their observables arrive nearly synchronized.
"""

from __future__ import annotations

import dataclasses
import logging
import pathlib

import numpy as np

from gnss_sdr_tpu_torch.receiver.pvt import solver as pvt_solver
from gnss_sdr_tpu_torch.receiver.receiver import (Receiver, ReceiverConfig,
                                                  make_rate_conditioner,
                                                  resolve_device)

log = logging.getLogger("gnss_sdr_tpu_torch")


@dataclasses.dataclass
class SourceBranchConfig:
    """One source branch: its receiver config plus the source binding."""

    receiver: ReceiverConfig           # fs = this branch's internal rate
    source: object = None              # signal source (io.sources protocol)
    input_filter: object = None        # optional conditioner stage


class MultiSourceReceiver:
    """N per-source receivers sharing nav data, clock origin and PVT, every
    branch on ``device`` (``cuda:0`` unless given; ``"cpu"`` runs the plain
    versions)."""

    def __init__(self, branches: list[SourceBranchConfig],
                 pvt_template: ReceiverConfig | None = None, device=None):
        if not branches:
            raise ValueError("need at least one source branch")
        self.device = resolve_device(device)
        self.branch_cfgs = branches
        # each branch dumps into its own subdirectory (source0, source1,
        # ...) of the conf's one dump_dir, so no branch overwrites another
        self.receivers = [
            Receiver(dataclasses.replace(
                b.receiver, pvt_enabled=False,
                dump_dir=(str(pathlib.Path(b.receiver.dump_dir) / f"source{k}")
                          if b.receiver.dump_dir else None)),
                device=self.device)
            for k, b in enumerate(branches)]
        # ONE ephemeris store across branches (the reference's global maps
        # in the PVT block fed by every channel's telemetry)
        shared: dict = {}
        for r in self.receivers:
            r.ephemerides = shared
        self.ephemerides = shared
        self.fixes: list = []
        self.fix_sinks: list = []
        self.obs_sinks: list = []      # merged epochs: sink(t_s, obs_list)
        # PVT options come from the template (or the first branch)
        self.pvt_cfg = pvt_template or branches[0].receiver
        # tick index on the common obs grid -> [(branch, obs)]
        self._pending: dict[int, list] = {}
        for bi, r in enumerate(self.receivers):
            r.obs_sinks.append(
                lambda tick, obs, bi=bi, r=r:
                self._collect(bi, tick / r.cfg.fs, obs))

    # ------------------------------------------------------------ time base
    def _time_domain(self, r: Receiver) -> str:
        """Clock-origin compatibility class of a branch: GLONASS telemetry
        times are seconds of day while GPS / Galileo / BeiDou run on the GPS
        week, so origins are shared only within one scale (the solver's
        per-system clock states absorb the cross-scale offsets)."""
        systems = {g.spec.system for g in r.groups}
        return "R" if systems == {"R"} else "W"

    def _share_clock_origin(self) -> None:
        """Propagate the first anchored receiver-clock origin to every
        branch ON THE SAME TIME SCALE: all sources started at the same
        instant, so the receiver time of sample 0 is one number per scale,
        which lets two branches observing the same system feed one solver
        clock state."""
        origin_by_domain: dict[str, float] = {}
        for r in self.receivers:
            if r.observables.rx_clock_tow is not None:
                origin_by_domain.setdefault(self._time_domain(r),
                                            r.observables.rx_clock_tow)
        for r in self.receivers:
            origin = origin_by_domain.get(self._time_domain(r))
            if origin is not None and r.observables.rx_clock_tow is None:
                r.observables._rx_origin_tow = origin

    def branch_time_s(self, bi: int) -> float:
        r = self.receivers[bi]
        return r._sample_base / r.cfg.fs

    # ------------------------------------------------------------ obs merge
    def _collect(self, bi: int, t_s: float, obs: list) -> None:
        # key on the tick INDEX of the common observables grid: branch tick
        # times can differ by sub-ms rounding (interval_samples =
        # round(fs * interval)), so bucketing by index merges them robustly
        key = int(round(t_s * 1e3 / self.pvt_cfg.obs_interval_ms))
        self._pending.setdefault(key, []).append((bi, obs))

    def _flush(self, active: list[bool]) -> None:
        """Run the merged PVT for every tick that all still-active branches
        have advanced past (a branch that ended early no longer gates)."""
        tick_s = self.pvt_cfg.obs_interval_ms * 1e-3
        horizons = [self.branch_time_s(i) for i in range(len(self.receivers))
                    if active[i]]
        horizon = ((min(horizons) if horizons else np.inf) / tick_s)
        for key in sorted(self._pending):
            if key > horizon:
                break
            contribs = self._pending.pop(key)
            merged = [o for _, obs in contribs for o in obs]
            for sink in self.obs_sinks:
                sink(key * tick_s, merged)
            if (int(round(key * self.pvt_cfg.obs_interval_ms))
                    % max(int(self.pvt_cfg.pvt_output_rate_ms), 1)):
                continue
            inputs = []
            for bi, obs in contribs:
                inputs.extend(self.receivers[bi].pvt_inputs(obs))
            inputs = pvt_solver.combine_iono_free(inputs)
            iono = self.iono
            sbas_lt, sbas_iono = None, None
            for r in self.receivers:
                lt, grid = r.sbas_corrections()
                sbas_lt = sbas_lt or lt
                sbas_iono = sbas_iono or grid
            sol = pvt_solver.solve_pvt(
                inputs, self.ephemerides,
                iono=iono if self.pvt_cfg.pvt_apply_iono else None,
                apply_tropo=self.pvt_cfg.pvt_apply_tropo,
                sbas_lt=sbas_lt,
                sbas_iono=(sbas_iono if self.pvt_cfg.pvt_apply_iono
                           else None))
            if sol.valid:
                self.fixes.append(sol)
                for sink in self.fix_sinks:
                    sink(sol)

    # ------------------------------------------------------------------ run
    def run(self, max_seconds: float | None = None) -> None:
        """Drive every branch to exhaustion (or ``max_seconds`` of stream
        time), interleaving chunks in receiver-time order so the merged
        epochs stay synchronized."""
        conds = []
        for b, r in zip(self.branch_cfgs, self.receivers):
            cond, block_len = make_rate_conditioner(
                b.source.fs, r.cfg.fs, r.chunk_len, self.device)
            conds.append((b.source, cond, block_len, b.input_filter))
        active = [True] * len(self.receivers)
        while any(active):
            # service the branch furthest behind in receiver time
            bi = min((i for i in range(len(active)) if active[i]),
                     key=self.branch_time_s)
            if (max_seconds is not None
                    and self.branch_time_s(bi) >= max_seconds):
                break
            src, cond, block_len, filt = conds[bi]
            if not self.receivers[bi].step_source(
                    src, cond=cond, block_len=block_len, input_filter=filt):
                active[bi] = False
            self._share_clock_origin()
            self._flush(active)
        active = [False] * len(self.receivers)
        self._flush(active)

    def close(self) -> None:
        """Release every branch's external resources (TCP loop peers, dump
        files)."""
        for r in self.receivers:
            r.close()

    # -------------------------------------------------------------- queries
    def tracked_prns(self) -> dict[int, list[int]]:
        return {bi: r.tracked_prns() for bi, r in enumerate(self.receivers)}

    def latest_fix(self):
        return self.fixes[-1] if self.fixes else None

    @property
    def iono(self):
        return next((r.iono for r in self.receivers
                     if r.iono is not None), None)
