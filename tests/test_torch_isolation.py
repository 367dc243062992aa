"""The port stands alone: in a fresh interpreter, importing every module of
gnss_sdr_tpu_torch and loading chip_smoke.py (without running it) imports
neither JAX nor any module of the JAX package."""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, importlib.util, pathlib, pkgutil, sys
root = pathlib.Path(sys.argv[1])
sys.path.insert(0, str(root))
import gnss_sdr_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gnss_sdr_tpu_torch.__path__,
                                               "gnss_sdr_tpu_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke",
                                              root / "chip_smoke.py")
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m.startswith("jaxlib.") or m == "gnss_sdr_tpu"
             or m.startswith("gnss_sdr_tpu."))
print(len(names))
print(",".join(bad))
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT)],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert int(lines[0]) >= 25, out.stdout
    assert lines[1] == "", f"port imported {lines[1]}"


def test_port_sources_name_no_jax_import():
    import re
    pat = re.compile(r"^\s*(import|from) (jax|gnss_sdr_tpu)([ .]|$)", re.M)
    files = sorted((ROOT / "gnss_sdr_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    hits = [str(f) for f in files if pat.search(f.read_text())]
    assert not hits, hits


# the CLI slice's modules: the probe above imports each of them
CLI_MODULES = (
    "gnss_sdr_tpu_torch.__main__", "gnss_sdr_tpu_torch.config.ini",
    "gnss_sdr_tpu_torch.config.registry", "gnss_sdr_tpu_torch.ops.fir",
    "gnss_sdr_tpu_torch.receiver.pvt.gpstime",
    "gnss_sdr_tpu_torch.receiver.pvt.nmea",
    "gnss_sdr_tpu_torch.receiver.pvt.tracks",
    "gnss_sdr_tpu_torch.receiver.pvt.rinex",
    "gnss_sdr_tpu_torch.models.nav.fec",
    "gnss_sdr_tpu_torch.receiver.pvt.rtcm", "gnss_sdr_tpu_torch.io.monitor",
    "gnss_sdr_tpu_torch.io.monitor_pb2", "gnss_sdr_tpu_torch.receiver.control",
    "gnss_sdr_tpu_torch.receiver.outputs")


def test_cli_modules_are_walked():
    import pkgutil

    import gnss_sdr_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(gnss_sdr_tpu_torch.__path__,
                                                   "gnss_sdr_tpu_torch.")}
    assert set(CLI_MODULES) <= names, set(CLI_MODULES) - names


# the signal slices' host modules (GPS L5 / L2C CNAV, Galileo F/NAV, BeiDou
# D1 / D2, GLONASS GNAV, SBAS, the almanacs, the Kalman filter): the probe
# above imports each of them
SIGNAL_MODULES = (
    "gnss_sdr_tpu_torch.models.nav.gps_cnav",
    "gnss_sdr_tpu_torch.models.nav.galileo_fnav",
    "gnss_sdr_tpu_torch.models.nav.beidou_d1",
    "gnss_sdr_tpu_torch.models.nav.beidou_d2",
    "gnss_sdr_tpu_torch.models.nav.glonass_gnav",
    "gnss_sdr_tpu_torch.models.nav.sbas",
    "gnss_sdr_tpu_torch.models.almanac",
    "gnss_sdr_tpu_torch.ops.kalman",
    "gnss_sdr_tpu_torch.receiver.telemetry",
    "gnss_sdr_tpu_torch.utils.scenario")


def test_signal_modules_are_walked():
    import pkgutil

    import gnss_sdr_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(gnss_sdr_tpu_torch.__path__,
                                                   "gnss_sdr_tpu_torch.")}
    assert set(SIGNAL_MODULES) <= names, set(SIGNAL_MODULES) - names


def test_icd_table_copies_equal_jax():
    """Each of the port's ``data/icd_tables_*.json`` holds entries of the
    JAX package's ``data/icd_tables.json``, unchanged: the B3I G2 seeds
    and the GNAV Hamming index sets among them."""
    import json

    jax_tables = json.loads((ROOT / "gnss_sdr_tpu" / "data"
                             / "icd_tables.json").read_text())
    seen = set()
    for path in sorted((ROOT / "gnss_sdr_tpu_torch" / "data").glob(
            "icd_tables_*.json")):
        part = json.loads(path.read_text())
        for key, value in part.items():
            assert value == jax_tables[key], (path.name, key)
        seen |= set(part)
    assert {"beidou_b3i_g2_init", "glonass_gnav_crc_q"} <= seen
