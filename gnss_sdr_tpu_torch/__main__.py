"""CLI entry point: ``python -m gnss_sdr_tpu_torch -c receiver.conf``.

Port of gnss_sdr_tpu/__main__.py (reference analog: ``src/main/main.cc``):
the same arguments and flow — INI configuration with CLI overrides, the
assistance file, the output products, the telecommand server, the keyboard
listener, the summary lines and exit code 42 on a ``reset`` telecommand.

The receiver runs on ``cuda:0`` unless ``--platform cpu`` is given; without
a card the CLI fails (no fallback to the CPU). The input filter (notch,
pulse blanking, frequency translation, beamformer) runs on the receiver's
device before the rate conditioner; SUPL A-GNSS assistance
(``GNSS-SDR.SUPL_*``) is fetched from the configured server before the
stream starts; the RTK rover (TCP or NTRIP base) and the PPP modes run on
the host beside the receiver. A multi-source conf (``Receiver.sources_count``
> 1 or a Multichannel_File_Signal_Source) runs one receiver branch per
source on the same device, merged into one PVT (``MultiSourceReceiver``).
Not ported yet, raising ``NotImplementedError``: ``--devices`` > 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gnss-sdr-tpu-torch",
        description="GNSS software-defined receiver (PyTorch / CUDA port)")
    p.add_argument("-c", "--config_file", required=True,
                   help="INI configuration (reference-compatible dialect)")
    p.add_argument("-s", "--signal_source", default=None,
                   help="override SignalSource.filename")
    p.add_argument("--doppler_max", type=float, default=None)
    p.add_argument("--doppler_step", type=float, default=None)
    p.add_argument("--dll_bw_hz", type=float, default=None)
    p.add_argument("--pll_bw_hz", type=float, default=None)
    p.add_argument("--max_chunks", type=int, default=None,
                   help="stop after N processing chunks")
    p.add_argument("--upload_bits", type=int, default=None,
                   choices=(4, 8, 32),
                   help="sample-upload word size (4 = packed nibble, "
                        "the fast streaming configuration)")
    p.add_argument("--dispatch_chunks", type=int, default=None,
                   help="fuse K chunks per tracking dispatch in steady "
                        "state (1 = off)")
    p.add_argument("--platform", default="cuda", choices=("cuda", "cpu"),
                   help="the receiver's device: cuda (cuda:0, the default; "
                        "fails without a card) or cpu")
    p.add_argument("--devices", type=int, default=None,
                   help="shard channels over N devices (only 1 is ported)")
    p.add_argument("--log_level", default="INFO")
    return p


def _start_keyboard_listener(rx) -> None:
    """'q' + Enter on an interactive stdin stops the receiver (reference
    ControlThread::keyboard_listener). Skipped when stdin is not a TTY
    (piped runs, tests, the restart harness)."""
    import threading

    try:
        if not sys.stdin.isatty():
            return
    except (ValueError, OSError):
        return
    from gnss_sdr_tpu_torch.receiver.control import CommandEvent

    def listen():
        for line in sys.stdin:
            if line.strip().lower() == "q":
                rx.control_queue.push(CommandEvent("stop"))
                return

    threading.Thread(target=listen, daemon=True).start()


def _launch_counts() -> str:
    from gnss_sdr_tpu_torch.ops import correlator, tracking_kernel

    return (f"tracking_kernel_launches={tracking_kernel.launches} "
            f"multicorrelator_launches={correlator.launches} "
            f"tracking_kernel_kf_launches={tracking_kernel.kf_launches}")


def _print_fix(f) -> None:
    print(f"last fix: lat={f.lat_rad*57.29577951308232:.6f} "
          f"lon={f.lon_rad*57.29577951308232:.6f} h={f.height_m:.1f} m "
          f"({f.n_sats} sats, pdop {f.pdop:.2f})")


def _run_multisource(multi, args, device) -> int:
    """The reference's multi-source flowgraph (Receiver.sources_count > 1):
    one receiver branch per source, merged observables and PVT (JAX package
    __main__.py:97-108), with a line per branch."""
    from gnss_sdr_tpu_torch.receiver.multisource import MultiSourceReceiver

    branches, base_cfg = multi
    if args.devices is not None:
        # more than one device raises in Receiver (n_mesh_devices)
        branches = [dataclasses.replace(b, receiver=dataclasses.replace(
            b.receiver, n_mesh_devices=args.devices)) for b in branches]
    rx = MultiSourceReceiver(branches, pvt_template=base_cfg, device=device)
    try:
        rx.run()
    finally:
        rx.close()
    n = len(rx.fixes)
    print(f"processed {len(branches)} sources, {n} PVT fixes")
    for bi, r in enumerate(rx.receivers):
        print(f"branch {bi}: signals={[g.signal for g in r.groups]} "
              f"fs={r.cfg.fs:.0f} samples={r._sample_base} tracked PRNs: "
              f"{sorted(r.tracked_prns())}; tracking_dispatches="
              f"{r.tracking_dispatches}")
    print(f"tracking_dispatches={sum(r.tracking_dispatches for r in rx.receivers)} "
          + _launch_counts())
    if n:
        _print_fix(rx.fixes[-1])
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=args.log_level,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    log = logging.getLogger("gnss_sdr_tpu_torch")
    from gnss_sdr_tpu_torch.config import ini
    from gnss_sdr_tpu_torch.receiver.receiver import Receiver, resolve_device

    try:
        device = resolve_device("cpu" if args.platform == "cpu" else None)
    except RuntimeError as e:
        raise SystemExit(f"gnss-sdr-tpu-torch: {e}") from None
    log.info("device: %s", device)

    conf = ini.FileConfiguration(args.config_file)
    if args.signal_source:
        conf.set_property("SignalSource.filename", args.signal_source)
    if args.doppler_max is not None:
        conf.set_property("Acquisition_1C.doppler_max", args.doppler_max)
    if args.doppler_step is not None:
        conf.set_property("Acquisition_1C.doppler_step", args.doppler_step)
    if args.dll_bw_hz is not None:
        conf.set_property("Tracking_1C.dll_bw_hz", args.dll_bw_hz)
    if args.pll_bw_hz is not None:
        conf.set_property("Tracking_1C.pll_bw_hz", args.pll_bw_hz)
    if args.dispatch_chunks:
        conf.set_property("GNSS-SDR.dispatch_chunks", args.dispatch_chunks)
    if args.upload_bits:
        conf.set_property("GNSS-SDR.upload_bits", args.upload_bits)

    multi = ini.multisource_from_ini(conf, device=device)
    if multi is not None:
        return _run_multisource(multi, args, device)
    rcfg = ini.receiver_config_from_ini(conf)
    if args.devices is not None:
        # more than one device raises in Receiver (n_mesh_devices)
        rcfg = dataclasses.replace(rcfg, n_mesh_devices=args.devices)
    source = ini.source_from_ini(conf)
    if abs(source.fs - rcfg.fs) > 1.0:
        log.info("conditioning %.0f sps -> %.0f sps", source.fs, rcfg.fs)
    input_filter = ini.input_filter_from_ini(conf, device=device)
    rx = Receiver(rcfg, device=device)
    # warm/hot-start state (ephemerides + almanac + last position/time),
    # reloaded at start and refreshed at exit
    assist = str(conf.property("GNSS-SDR.assistance_file", "")).strip()
    if assist:
        rx.restore(assist)
    # SUPL A-GNSS: ephemeris / almanac / iono / UTC / reference position
    # and time and acquisition hints from an SLP before streaming
    # (reference ControlThread::assist_GNSS; GNSS-SDR.SUPL_* keys)
    from gnss_sdr_tpu_torch.io.supl import fetch_supl_assistance
    supl_assist = fetch_supl_assistance(conf)
    if supl_assist is not None:
        rx.apply_assistance(supl_assist)
        log.info("SUPL: %d ephemerides, %d almanacs, %d acquisition hints "
                 "applied", len(supl_assist.ephemerides),
                 len(supl_assist.almanacs), len(supl_assist.acq))
    from gnss_sdr_tpu_torch.receiver.outputs import attach_outputs
    outputs = attach_outputs(rx, conf)
    # TCP telecommand interface (GNSS-SDR.telecommand_enabled / _tcp_port)
    telecmd = None
    if str(conf.property("GNSS-SDR.telecommand_enabled", "false")
           ).strip().lower() in ("true", "1"):
        from gnss_sdr_tpu_torch.receiver.control import TelecommandServer
        port = int(conf.property("GNSS-SDR.telecommand_tcp_port", 3333))
        telecmd = TelecommandServer(rx.control_queue, rx.status_text,
                                    port=port)
        log.info("telecommand server on tcp port %d", telecmd.port)
    _start_keyboard_listener(rx)
    try:
        rx.run_file_source(source, max_chunks=args.max_chunks,
                           input_filter=input_filter)
    finally:
        if assist:
            rx.checkpoint(assist)
        if telecmd is not None:
            telecmd.close()
        outputs.close()
        rx.close()

    n = len(rx.fixes)
    print(f"processed: {rx._sample_base} samples, {n} PVT fixes")
    print(f"tracked PRNs: {sorted(rx.tracked_prns())}; tracking_dispatches="
          f"{rx.tracking_dispatches} " + _launch_counts())
    if input_filter is not None:
        print(f"input filter: {input_filter.name} {input_filter.calls} "
              f"blocks, {input_filter.seconds:.3f} s on the host")
    if supl_assist is not None:
        print(f"supl: {len(supl_assist.ephemerides)} ephemerides, "
              f"{len(supl_assist.almanacs)} almanacs, "
              f"{len(supl_assist.acq)} acquisition hints")
    if n:
        print(f"first fix: tow={rx.fixes[0].tow_s:.3f} s")
        _print_fix(rx.fixes[-1])
    rtk = getattr(outputs, "rtk_engine", None)
    if rtk is not None:
        print(f"rtk solutions: {len(rtk.solutions)} "
              f"({sum(bool(s.fixed) for s in rtk.solutions)} fixed)")
    # the reset telecommand requests a full receiver restart; the harness
    # script relaunches on this exit code (exit 42 = restart)
    return 42 if rx.restart_requested else 0


if __name__ == "__main__":
    sys.exit(main())
