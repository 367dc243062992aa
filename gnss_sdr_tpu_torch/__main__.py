"""CLI entry point: ``python -m gnss_sdr_tpu_torch -c receiver.conf``.

Port of gnss_sdr_tpu/__main__.py (reference analog: ``src/main/main.cc``):
the same arguments and flow — INI configuration with CLI overrides, the
assistance file, the output products, the telecommand server, the keyboard
listener, the summary lines and exit code 42 on a ``reset`` telecommand.

The receiver runs on ``cuda:0`` unless ``--platform cpu`` is given; without
a card the CLI fails (no fallback to the CPU). Not ported yet, each raising
``NotImplementedError``: multi-source confs, ``--devices`` > 1, SUPL
assistance (``GNSS-SDR.SUPL_*``).
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


def _supl_enabled(conf) -> list[str]:
    """The GNSS-SDR.SUPL_*_enabled keys that are on."""
    return [k for k in conf.keys_with_prefix("GNSS-SDR.SUPL_")
            if k.endswith("_enabled") and conf.property(k, False)]


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=args.log_level,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    log = logging.getLogger("gnss_sdr_tpu_torch")
    from gnss_sdr_tpu_torch.config import ini, registry
    from gnss_sdr_tpu_torch.ops import correlator, tracking_kernel
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

    ini.multisource_from_ini(conf)       # raises for multi-source confs
    rcfg = ini.receiver_config_from_ini(conf)
    registry.check_ported(conf, rcfg.signal_plan)
    if args.devices is not None:
        # more than one device raises in Receiver (n_mesh_devices)
        rcfg = dataclasses.replace(rcfg, n_mesh_devices=args.devices)
    source = ini.source_from_ini(conf)
    if abs(source.fs - rcfg.fs) > 1.0:
        log.info("conditioning %.0f sps -> %.0f sps", source.fs, rcfg.fs)
    ini.input_filter_from_ini(conf)      # raises for unported filters
    rx = Receiver(rcfg, device=device)
    # warm/hot-start state (ephemerides + almanac + last position/time),
    # reloaded at start and refreshed at exit
    assist = str(conf.property("GNSS-SDR.assistance_file", "")).strip()
    if assist:
        rx.restore(assist)
    supl = _supl_enabled(conf)
    if supl:
        raise NotImplementedError(
            f"{supl[0]}=true: SUPL assistance is not ported yet")
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
        rx.run_file_source(source, max_chunks=args.max_chunks)
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
          f"{rx.tracking_dispatches} tracking_kernel_launches="
          f"{tracking_kernel.launches} multicorrelator_launches="
          f"{correlator.launches} tracking_kernel_kf_launches="
          f"{tracking_kernel.kf_launches}")
    if n:
        f = rx.fixes[-1]
        print(f"last fix: lat={f.lat_rad*57.29577951308232:.6f} "
              f"lon={f.lon_rad*57.29577951308232:.6f} h={f.height_m:.1f} m "
              f"({f.n_sats} sats, pdop {f.pdop:.2f})")
    # the reset telecommand requests a full receiver restart; the harness
    # script relaunches on this exit code (exit 42 = restart)
    return 42 if rx.restart_requested else 0


if __name__ == "__main__":
    sys.exit(main())
