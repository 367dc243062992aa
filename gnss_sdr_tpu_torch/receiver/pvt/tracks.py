"""Position track writers: KML, GPX, GeoJSON; a copy of
gnss_sdr_tpu/receiver/pvt/tracks.py.

Reference analogs: ``Kml_Printer``, ``Gpx_Printer``, ``GeoJSON_Printer``
(``src/algorithms/PVT/libs/``)."""

from __future__ import annotations

import json
import math
import pathlib

from gnss_sdr_tpu_torch.receiver.pvt.gpstime import gps_to_datetime


class KmlPrinter:
    def __init__(self, path):
        self.path = pathlib.Path(path)
        self.points: list[tuple[float, float, float]] = []

    def push(self, sol) -> None:
        if sol.valid:
            self.points.append((math.degrees(sol.lon_rad),
                                math.degrees(sol.lat_rad), sol.height_m))

    def close(self) -> None:
        coords = "\n".join(f"{lo:.9f},{la:.9f},{h:.3f}"
                           for lo, la, h in self.points)
        self.path.write_text(f"""<?xml version="1.0" encoding="UTF-8"?>
<kml xmlns="http://www.opengis.net/kml/2.2">
<Document>
<name>gnss_sdr_tpu track</name>
<Placemark>
<name>Receiver track</name>
<LineString>
<altitudeMode>absolute</altitudeMode>
<coordinates>
{coords}
</coordinates>
</LineString>
</Placemark>
</Document>
</kml>
""")


class GpxPrinter:
    def __init__(self, path):
        self.path = pathlib.Path(path)
        self.points: list[str] = []

    def push(self, sol) -> None:
        if not sol.valid:
            return
        t = gps_to_datetime(sol.week, sol.tow_s)
        self.points.append(
            f'<trkpt lat="{math.degrees(sol.lat_rad):.9f}" '
            f'lon="{math.degrees(sol.lon_rad):.9f}">'
            f"<ele>{sol.height_m:.3f}</ele>"
            f"<time>{t:%Y-%m-%dT%H:%M:%S}Z</time>"
            f"<pdop>{sol.pdop:.2f}</pdop></trkpt>")

    def close(self) -> None:
        pts = "\n".join(self.points)
        self.path.write_text(f"""<?xml version="1.0" encoding="UTF-8"?>
<gpx version="1.1" creator="gnss_sdr_tpu" xmlns="http://www.topografix.com/GPX/1/1">
<trk><name>Receiver track</name><trkseg>
{pts}
</trkseg></trk>
</gpx>
""")


class GeoJsonPrinter:
    def __init__(self, path):
        self.path = pathlib.Path(path)
        self.coords: list[list[float]] = []

    def push(self, sol) -> None:
        if sol.valid:
            self.coords.append([math.degrees(sol.lon_rad),
                                math.degrees(sol.lat_rad),
                                round(sol.height_m, 3)])

    def close(self) -> None:
        gj = {
            "type": "Feature",
            "properties": {"name": "gnss_sdr_tpu track"},
            "geometry": {"type": "LineString", "coordinates": self.coords},
        }
        self.path.write_text(json.dumps(gj, indent=1))
