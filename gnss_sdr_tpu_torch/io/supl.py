"""SUPL 1.0 A-GNSS client (OMA ULP over TCP + 3GPP RRLP assistance).

Port of gnss_sdr_tpu/io/supl.py (host code, copied with its imports
rewritten to this package).

Analog of the reference's ``gnss_sdr_supl_client.{h,cc}`` +
``src/core/libs/supl/supl.c`` (itself wrapping ~81 k lines of
asn1c-generated code for the OMA-TS-ULP-V1_0 and 3GPP TS 44.031 ASN.1
modules).  Here the same two protocols are expressed as declarative UPER
schemas over :mod:`gnss_sdr_tpu_torch.io.uper` — the schema definitions below
transcribe the published ASN.1 modules (``asn/supl-*.asn``,
``asn/rrlp-*.asn``: public OMA/3GPP specifications), not the generated C.

Message flow (reference ``supl_get_assist``, supl.c:913-1050):

  SET->SLP  SUPL START    (capabilities, cell-based LocationId)
  SLP->SET  SUPL RESPONSE (posMethod, slpSessionID)
  SET->SLP  SUPL POS INIT (RequestedAssistData flags)
  SLP->SET  SUPL POS      (RRLP assistanceData / msrPositionReq payload)
  SET->SLP  SUPL POS      (RRLP assistanceDataAck)   [while more data]
  SLP->SET  SUPL END

Collected assistance (ephemeris / almanac / iono / UTC / reference
time+location / acquisition assistance) converts into the repo's warm-start
``Assistance`` record with IS-GPS-200 LNAV scale factors, exactly as
``gnss_sdr_supl_client.cc:227-340`` converts into ``Gps_Ephemeris`` et al.

``SuplServer`` is a test/QA SLP serving canned assistance — the role the
live supl.google.com plays for the reference (this environment has no
network egress; the wire bytes are identical either way).
"""

from __future__ import annotations

import dataclasses
import logging
import socket
import threading

import numpy as np

from gnss_sdr_tpu_torch.io.uper import (
    BITSTR, BOOL, CHARSTR, CHOICE, ENUM, F, INT, NULL, OCTETS, SEQ, SEQ_OF,
    decode, encode,
)

log = logging.getLogger(__name__)

PI = 3.1415926535898          # IS-GPS-200 semicircle constant

# =========================================================================
# ULP schemas (OMA-TS-ULP-V1_0; asn/supl-common.asn, supl-*.asn)
# =========================================================================

Version = SEQ(F("maj", INT(0, 255)), F("min", INT(0, 255)),
              F("servind", INT(0, 255)))

IPAddress = CHOICE(("ipv4Address", OCTETS(fixed=4)),
                   ("ipv6Address", OCTETS(fixed=16)))

FQDN = CHARSTR(1, 255, alphabet=(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789.-"))

SLPAddress = CHOICE(("iPAddress", IPAddress), ("fQDN", FQDN), ext=True)

SETId = CHOICE(
    ("msisdn", OCTETS(fixed=8)), ("mdn", OCTETS(fixed=8)),
    ("min", BITSTR(34)), ("imsi", OCTETS(fixed=8)),
    ("nai", CHARSTR(1, 1000)), ("iPAddress", IPAddress), ext=True)

SetSessionID = SEQ(F("sessionId", INT(0, 65535)), F("setId", SETId))
SlpSessionID = SEQ(F("sessionID", OCTETS(fixed=4)), F("slpId", SLPAddress))
SessionID = SEQ(F("setSessionID", SetSessionID, optional=True),
                F("slpSessionID", SlpSessionID, optional=True))

NMRelement = SEQ(F("aRFCN", INT(0, 1023)), F("bSIC", INT(0, 63)),
                 F("rxLev", INT(0, 63)), ext=True)

GsmCellInformation = SEQ(
    F("refMCC", INT(0, 999)), F("refMNC", INT(0, 999)),
    F("refLAC", INT(0, 65535)), F("refCI", INT(0, 65535)),
    F("nMR", SEQ_OF(NMRelement, 1, 15), optional=True),
    F("tA", INT(0, 255), optional=True), ext=True)

UARFCN = INT(0, 16383)
FrequencyInfoFDD = SEQ(F("uarfcn-UL", UARFCN, optional=True),
                       F("uarfcn-DL", UARFCN), ext=True)
FrequencyInfoTDD = SEQ(F("uarfcn-Nt", UARFCN), ext=True)
FrequencyInfo = SEQ(
    F("fmodeSpecificInfo", CHOICE(("fdd", FrequencyInfoFDD),
                                  ("tdd", FrequencyInfoTDD), ext=True)),
    ext=True)

PrimaryCPICH_Info = SEQ(F("primaryScramblingCode", INT(0, 511)))
CellMeasuredResults = SEQ(
    F("cellIdentity", INT(0, 268435455), optional=True),
    F("modeSpecificInfo", CHOICE(
        ("fdd", SEQ(F("primaryCPICH-Info", PrimaryCPICH_Info),
                    F("cpich-Ec-N0", INT(0, 63), optional=True),
                    F("cpich-RSCP", INT(0, 127), optional=True),
                    F("pathloss", INT(46, 173), optional=True))),
        ("tdd", SEQ(F("cellParametersID", INT(0, 127)),
                    F("proposedTGSN", INT(0, 14), optional=True),
                    F("primaryCCPCH-RSCP", INT(0, 127), optional=True),
                    F("pathloss", INT(46, 173), optional=True),
                    F("timeslotISCP-List",
                      SEQ_OF(INT(0, 127), 1, 14), optional=True))))))

MeasuredResults = SEQ(
    F("frequencyInfo", FrequencyInfo, optional=True),
    F("utra-CarrierRSSI", INT(0, 127), optional=True),
    F("cellMeasuredResultsList",
      SEQ_OF(CellMeasuredResults, 1, 32), optional=True))

WcdmaCellInformation = SEQ(
    F("refMCC", INT(0, 999)), F("refMNC", INT(0, 999)),
    F("refUC", INT(0, 268435455)),
    F("frequencyInfo", FrequencyInfo, optional=True),
    F("primaryScramblingCode", INT(0, 511), optional=True),
    F("measuredResultsList", SEQ_OF(MeasuredResults, 1, 8), optional=True),
    ext=True)

CdmaCellInformation = SEQ(
    F("refNID", INT(0, 65535)), F("refSID", INT(0, 32767)),
    F("refBASEID", INT(0, 65535)), F("refBASELAT", INT(0, 4194303)),
    F("reBASELONG", INT(0, 8388607)), F("refREFPN", INT(0, 511)),
    F("refWeekNumber", INT(0, 65535)), F("refSeconds", INT(0, 4194303)),
    ext=True)

CellInfo = CHOICE(("gsmCell", GsmCellInformation),
                  ("wcdmaCell", WcdmaCellInformation),
                  ("cdmaCell", CdmaCellInformation), ext=True)

Status = ENUM(("stale", "current", "unknown"), ext=True)
LocationId = SEQ(F("cellInfo", CellInfo), F("status", Status), ext=True)

AltitudeInfo = SEQ(F("altitudeDirection", ENUM(("height", "depth"))),
                   F("altitude", INT(0, 32767)),
                   F("altUncertainty", INT(0, 127)), ext=True)

PositionEstimate = SEQ(
    F("latitudeSign", ENUM(("north", "south"))),
    F("latitude", INT(0, 8388607)), F("longitude", INT(-8388608, 8388607)),
    F("uncertainty", SEQ(F("uncertaintySemiMajor", INT(0, 127)),
                         F("uncertaintySemiMinor", INT(0, 127)),
                         F("orientationMajorAxis", INT(0, 180))),
      optional=True),
    F("confidence", INT(0, 100), optional=True),
    F("altitudeInfo", AltitudeInfo, optional=True), ext=True)

Velocity = CHOICE(
    ("horvel", SEQ(F("bearing", BITSTR(9)), F("horspeed", BITSTR(16)),
                   ext=True)),
    ("horandvervel", SEQ(F("verdirect", BITSTR(1)), F("bearing", BITSTR(9)),
                         F("horspeed", BITSTR(16)), F("verspeed", BITSTR(8)),
                         ext=True)),
    ("horveluncert", SEQ(F("bearing", BITSTR(9)), F("horspeed", BITSTR(16)),
                         F("uncertspeed", BITSTR(8)), ext=True)),
    ("horandveruncert", SEQ(
        F("verdirect", BITSTR(1)), F("bearing", BITSTR(9)),
        F("horspeed", BITSTR(16)), F("verspeed", BITSTR(8)),
        F("horuncertspeed", BITSTR(8)), F("veruncertspeed", BITSTR(8)),
        ext=True)), ext=True)

Position = SEQ(F("timestamp", CHARSTR()),     # UTCTime as VisibleString
               F("positionEstimate", PositionEstimate),
               F("velocity", Velocity, optional=True), ext=True)

QoP = SEQ(F("horacc", INT(0, 127)), F("veracc", INT(0, 127), optional=True),
          F("maxLocAge", INT(0, 65535), optional=True),
          F("delay", INT(0, 7), optional=True), ext=True)

StatusCode = ENUM((
    "unspecified", "systemFailure", "unexpectedMessage", "protocolError",
    "dataMissing", "unexpectedDataValue", "posMethodFailure",
    "posMethodMismatch", "posProtocolMismatch", "targetSETnotReachable",
    "versionNotSupported", "resourceShortage", "invalidSessionId",
    "nonProxyModeNotSupported", "proxyModeNotSupported",
    "positioningNotPermitted", "authNetFailure", "authSuplinitFailure",
    "consentDeniedByUser", "consentGrantedByUser"), ext=True)

PosMethod = ENUM((
    "agpsSETassisted", "agpsSETbased", "agpsSETassistedpref",
    "agpsSETbasedpref", "autonomousGPS", "aFLT", "eCID", "eOTD", "oTDOA",
    "noPosition"), ext=True)

PosTechnology = SEQ(
    F("agpsSETassisted", BOOL()), F("agpsSETBased", BOOL()),
    F("autonomousGPS", BOOL()), F("aFLT", BOOL()), F("eCID", BOOL()),
    F("eOTD", BOOL()), F("oTDOA", BOOL()), ext=True)

PrefMethod = ENUM(("agpsSETassistedPreferred", "agpsSETBasedPreferred",
                   "noPreference"))

PosProtocol = SEQ(F("tia801", BOOL()), F("rrlp", BOOL()), F("rrc", BOOL()),
                  ext=True)

SETCapabilities = SEQ(F("posTechnology", PosTechnology),
                      F("prefMethod", PrefMethod),
                      F("posProtocol", PosProtocol), ext=True)

SUPLSTART = SEQ(F("sETCapabilities", SETCapabilities),
                F("locationId", LocationId),
                F("qoP", QoP, optional=True), ext=True)

SETAuthKey = CHOICE(("shortKey", BITSTR(128)), ("longKey", BITSTR(256)),
                    ext=True)

SUPLRESPONSE = SEQ(F("posMethod", PosMethod),
                   F("sLPAddress", SLPAddress, optional=True),
                   F("sETAuthKey", SETAuthKey, optional=True),
                   F("keyIdentity4", BITSTR(128), optional=True), ext=True)

SatelliteInfoElement = SEQ(F("satId", INT(0, 63)), F("iODE", INT(0, 255)),
                           ext=True)
XNavigationModel = SEQ(
    F("gpsWeek", INT(0, 1023)), F("gpsToe", INT(0, 167)),
    F("nSAT", INT(0, 31)), F("toeLimit", INT(0, 10)),
    F("satInfo", SEQ_OF(SatelliteInfoElement, 1, 31), optional=True),
    ext=True)

RequestedAssistData = SEQ(
    F("almanacRequested", BOOL()), F("utcModelRequested", BOOL()),
    F("ionosphericModelRequested", BOOL()),
    F("dgpsCorrectionsRequested", BOOL()),
    F("referenceLocationRequested", BOOL()),
    F("referenceTimeRequested", BOOL()),
    F("acquisitionAssistanceRequested", BOOL()),
    F("realTimeIntegrityRequested", BOOL()),
    F("navigationModelRequested", BOOL()),
    F("navigationModelData", XNavigationModel, optional=True), ext=True)

PosPayLoad = CHOICE(("tia801payload", OCTETS(1, 8192)),
                    ("rrcPayload", OCTETS(1, 8192)),
                    ("rrlpPayload", OCTETS(1, 8192)), ext=True)

SUPLPOS = SEQ(F("posPayLoad", PosPayLoad),
              F("velocity", Velocity, optional=True), ext=True)

SUPLPOSINIT = SEQ(
    F("sETCapabilities", SETCapabilities),
    F("requestedAssistData", RequestedAssistData, optional=True),
    F("locationId", LocationId), F("position", Position, optional=True),
    F("sUPLPOS", SUPLPOS, optional=True),
    F("ver", BITSTR(64), optional=True), ext=True)

SUPLEND = SEQ(F("position", Position, optional=True),
              F("statusCode", StatusCode, optional=True),
              F("ver", BITSTR(64), optional=True), ext=True)

Notification = SEQ(
    F("notificationType", ENUM((
        "noNotificationNoVerification", "notificationOnly",
        "notificationAndVerficationAllowedNA",
        "notificationAndVerficationDeniedNA", "privacyOverride"), ext=True)),
    F("encodingType", ENUM(("ucs2", "gsmDefault", "utf8"), ext=True),
      optional=True),
    F("requestorId", OCTETS(1, 50), optional=True),
    F("requestorIdType", ENUM((
        "logicalName", "e-mailAddress", "msisdn", "url", "sipUrl", "min",
        "mdn", "imsPublicIdentity"), ext=True), optional=True),
    F("clientName", OCTETS(1, 50), optional=True),
    F("clientNameType", ENUM((
        "logicalName", "e-mailAddress", "msisdn", "url", "sipUrl", "min",
        "mdn", "imsPublicIdentity"), ext=True), optional=True), ext=True)

SUPLINIT = SEQ(
    F("posMethod", PosMethod),
    F("notification", Notification, optional=True),
    F("sLPAddress", SLPAddress, optional=True),
    F("qoP", QoP, optional=True),
    F("sLPMode", ENUM(("proxy", "nonProxy"))),
    F("mAC", BITSTR(64), optional=True),
    F("keyIdentity", BITSTR(128), optional=True), ext=True)

UlpMessage = CHOICE(
    ("msSUPLINIT", SUPLINIT), ("msSUPLSTART", SUPLSTART),
    ("msSUPLRESPONSE", SUPLRESPONSE), ("msSUPLPOSINIT", SUPLPOSINIT),
    ("msSUPLPOS", SUPLPOS), ("msSUPLEND", SUPLEND),
    ("msDUMMY2", INT()), ("msDUMMY3", INT()), ext=True)

ULP_PDU = SEQ(F("length", INT(0, 65535)), F("version", Version),
              F("sessionID", SessionID), F("message", UlpMessage))


def encode_ulp(session_id: dict, message: tuple) -> bytes:
    """Encode one ULP PDU, patching the leading length field with the
    actual encoded byte count (the reference does the same double pass,
    supl.c pdu_ulp_len)."""
    raw = bytearray(encode(ULP_PDU, {
        "length": 0, "version": {"maj": 1, "min": 0, "servind": 0},
        "sessionID": session_id, "message": message}))
    raw[0:2] = len(raw).to_bytes(2, "big")
    return bytes(raw)


def decode_ulp(data: bytes) -> dict:
    return decode(ULP_PDU, data)


def recv_ulp(sock: socket.socket) -> dict:
    """Read one length-framed ULP PDU from a socket."""
    hdr = _recv_exact(sock, 2)
    total = int.from_bytes(hdr, "big")
    if not 2 <= total <= 65535:
        raise ValueError(f"SUPL: bad PDU length {total}")
    return decode_ulp(hdr + _recv_exact(sock, total - 2))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            raise ConnectionError("SUPL peer closed the connection")
        buf += part
    return buf


# =========================================================================
# RRLP schemas (3GPP TS 44.031; asn/rrlp-messages.asn, rrlp-components.asn)
# =========================================================================

SatelliteID = INT(0, 63)

GPSTime = SEQ(F("gpsTOW23b", INT(0, 7559999)), F("gpsWeek", INT(0, 1023)))
GSMTime = SEQ(F("bcchCarrier", INT(0, 1023)), F("bsic", INT(0, 63)),
              F("frameNumber", INT(0, 2097151)), F("timeSlot", INT(0, 7)),
              F("bitNumber", INT(0, 156)))
GPSTOWAssistElement = SEQ(
    F("satelliteID", SatelliteID), F("tlmWord", INT(0, 16383)),
    F("antiSpoof", INT(0, 1)), F("alert", INT(0, 1)),
    F("tlmRsvdBits", INT(0, 3)))
ReferenceTime = SEQ(
    F("gpsTime", GPSTime), F("gsmTime", GSMTime, optional=True),
    F("gpsTowAssist", SEQ_OF(GPSTOWAssistElement, 1, 12), optional=True))

RefLocation = SEQ(F("threeDLocation", OCTETS(1, 20)))

SatElement = SEQ(
    F("satelliteID", SatelliteID), F("iode", INT(0, 239)),
    F("udre", INT(0, 3)), F("pseudoRangeCor", INT(-2047, 2047)),
    F("rangeRateCor", INT(-127, 127)),
    F("deltaPseudoRangeCor2", INT(-127, 127)),
    F("deltaRangeRateCor2", INT(-7, 7)),
    F("deltaPseudoRangeCor3", INT(-127, 127)),
    F("deltaRangeRateCor3", INT(-7, 7)))
DGPSCorrections = SEQ(F("gpsTOW", INT(0, 604799)), F("status", INT(0, 7)),
                      F("satList", SEQ_OF(SatElement, 1, 16)))

EphemerisSubframe1Reserved = SEQ(
    F("reserved1", INT(0, 8388607)), F("reserved2", INT(0, 16777215)),
    F("reserved3", INT(0, 16777215)), F("reserved4", INT(0, 65535)))

UncompressedEphemeris = SEQ(
    F("ephemCodeOnL2", INT(0, 3)), F("ephemURA", INT(0, 15)),
    F("ephemSVhealth", INT(0, 63)), F("ephemIODC", INT(0, 1023)),
    F("ephemL2Pflag", INT(0, 1)),
    F("ephemSF1Rsvd", EphemerisSubframe1Reserved),
    F("ephemTgd", INT(-128, 127)), F("ephemToc", INT(0, 37799)),
    F("ephemAF2", INT(-128, 127)), F("ephemAF1", INT(-32768, 32767)),
    F("ephemAF0", INT(-2097152, 2097151)),
    F("ephemCrs", INT(-32768, 32767)), F("ephemDeltaN", INT(-32768, 32767)),
    F("ephemM0", INT(-2147483648, 2147483647)),
    F("ephemCuc", INT(-32768, 32767)), F("ephemE", INT(0, 4294967295)),
    F("ephemCus", INT(-32768, 32767)),
    F("ephemAPowerHalf", INT(0, 4294967295)),
    F("ephemToe", INT(0, 37799)), F("ephemFitFlag", INT(0, 1)),
    F("ephemAODA", INT(0, 31)), F("ephemCic", INT(-32768, 32767)),
    F("ephemOmegaA0", INT(-2147483648, 2147483647)),
    F("ephemCis", INT(-32768, 32767)),
    F("ephemI0", INT(-2147483648, 2147483647)),
    F("ephemCrc", INT(-32768, 32767)),
    F("ephemW", INT(-2147483648, 2147483647)),
    F("ephemOmegaADot", INT(-8388608, 8388607)),
    F("ephemIDot", INT(-8192, 8191)))

SatStatus = CHOICE(("newSatelliteAndModelUC", UncompressedEphemeris),
                   ("oldSatelliteAndModel", NULL()),
                   ("newNaviModelUC", UncompressedEphemeris), ext=True)
NavModelElement = SEQ(F("satelliteID", SatelliteID),
                      F("satStatus", SatStatus))
NavigationModel = SEQ(F("navModelList", SEQ_OF(NavModelElement, 1, 16)))

IonosphericModel = SEQ(*[F(n, INT(-128, 127)) for n in (
    "alfa0", "alfa1", "alfa2", "alfa3", "beta0", "beta1", "beta2", "beta3")])

UTCModel = SEQ(
    F("utcA1", INT(-8388608, 8388607)),
    F("utcA0", INT(-2147483648, 2147483647)), F("utcTot", INT(0, 255)),
    F("utcWNt", INT(0, 255)), F("utcDeltaTls", INT(-128, 127)),
    F("utcWNlsf", INT(0, 255)), F("utcDN", INT(-128, 127)),
    F("utcDeltaTlsf", INT(-128, 127)))

AlmanacElement = SEQ(
    F("satelliteID", SatelliteID), F("almanacE", INT(0, 65535)),
    F("alamanacToa", INT(0, 255)), F("almanacKsii", INT(-32768, 32767)),
    F("almanacOmegaDot", INT(-32768, 32767)),
    F("almanacSVhealth", INT(0, 255)),
    F("almanacAPowerHalf", INT(0, 16777215)),
    F("almanacOmega0", INT(-8388608, 8388607)),
    F("almanacW", INT(-8388608, 8388607)),
    F("almanacM0", INT(-8388608, 8388607)),
    F("almanacAF0", INT(-1024, 1023)), F("almanacAF1", INT(-1024, 1023)))
Almanac = SEQ(F("alamanacWNa", INT(0, 255)),
              F("almanacList", SEQ_OF(AlmanacElement, 1, 64)))

AddionalDopplerFields = SEQ(F("doppler1", INT(0, 63)),
                            F("dopplerUncertainty", INT(0, 7)))
AddionalAngleFields = SEQ(F("azimuth", INT(0, 31)), F("elevation", INT(0, 7)))
AcquisElement = SEQ(
    F("svid", SatelliteID), F("doppler0", INT(-2048, 2047)),
    F("addionalDoppler", AddionalDopplerFields, optional=True),
    F("codePhase", INT(0, 1022)), F("intCodePhase", INT(0, 19)),
    F("gpsBitNumber", INT(0, 3)), F("codePhaseSearchWindow", INT(0, 15)),
    F("addionalAngle", AddionalAngleFields, optional=True))
TimeRelation = SEQ(F("gpsTOW", INT(0, 7559999)),
                   F("gsmTime", GSMTime, optional=True))
AcquisAssist = SEQ(F("timeRelation", TimeRelation),
                   F("acquisList", SEQ_OF(AcquisElement, 1, 16)))

ControlHeader = SEQ(
    F("referenceTime", ReferenceTime, optional=True),
    F("refLocation", RefLocation, optional=True),
    F("dgpsCorrections", DGPSCorrections, optional=True),
    F("navigationModel", NavigationModel, optional=True),
    F("ionosphericModel", IonosphericModel, optional=True),
    F("utcModel", UTCModel, optional=True),
    F("almanac", Almanac, optional=True),
    F("acquisAssist", AcquisAssist, optional=True),
    F("realTimeIntegrity", SEQ_OF(SatelliteID, 1, 16), optional=True))

GPS_AssistData = SEQ(F("controlHeader", ControlHeader))

MoreAssDataToBeSent = ENUM(("noMoreMessages", "moreMessagesOnTheWay"))

MethodType = CHOICE(
    ("msAssisted", SEQ(F("accuracy", INT(0, 127), optional=True))),
    ("msBased", INT(0, 127)), ("msBasedPref", INT(0, 127)),
    ("msAssistedPref", INT(0, 127)))
PositionInstruct = SEQ(
    F("methodType", MethodType),
    F("positionMethod", ENUM(("eotd", "gps", "gpsOrEOTD"))),
    F("measureResponseTime", INT(0, 7)),
    F("useMultipleSets", ENUM(("multipleSets", "oneSet"))),
    F("environmentCharacter",
      ENUM(("badArea", "notBadArea", "mixedArea"), ext=True), optional=True))

TimeSlotScheme = ENUM(("equalLength", "variousLength"))
ReferenceAssistData = SEQ(
    F("bcchCarrier", INT(0, 1023)), F("bsic", INT(0, 63)),
    F("timeSlotScheme", TimeSlotScheme),
    F("btsPosition", OCTETS(1, 20), optional=True))

MsrAssistBTS = SEQ(
    F("bcchCarrier", INT(0, 1023)), F("bsic", INT(0, 63)),
    F("multiFrameOffset", INT(0, 51)), F("timeSlotScheme", TimeSlotScheme),
    F("roughRTD", INT(0, 1250)))
MsrAssistData = SEQ(F("msrAssistList", SEQ_OF(MsrAssistBTS, 1, 15)))

ReferenceWGS84 = SEQ(F("relativeNorth", INT(-200000, 200000)),
                     F("relativeEast", INT(-200000, 200000)),
                     F("relativeAlt", INT(-4000, 4000), optional=True))
CalcAssistanceBTS = SEQ(F("fineRTD", INT(0, 255)),
                        F("referenceWGS84", ReferenceWGS84))
AssistBTSData = SEQ(
    F("bcchCarrier", INT(0, 1023)), F("bsic", INT(0, 63)),
    F("multiFrameOffset", INT(0, 51)), F("timeSlotScheme", TimeSlotScheme),
    F("roughRTD", INT(0, 1250)),
    F("calcAssistanceBTS", CalcAssistanceBTS, optional=True))
SystemInfoAssistBTS = CHOICE(("notPresent", NULL()),
                             ("present", AssistBTSData), ext=True)
SystemInfoAssistData = SEQ(
    F("systemInfoAssistList", SEQ_OF(SystemInfoAssistBTS, 1, 32)))

AssistanceData = SEQ(
    F("referenceAssistData", ReferenceAssistData, optional=True),
    F("msrAssistData", MsrAssistData, optional=True),
    F("systemInfoAssistData", SystemInfoAssistData, optional=True),
    F("gps-AssistData", GPS_AssistData, optional=True),
    F("moreAssDataToBeSent", MoreAssDataToBeSent, optional=True),
    F("extensionContainer", INT(), optional=True), ext=True)

MsrPosition_Req = SEQ(
    F("positionInstruct", PositionInstruct),
    F("referenceAssistData", ReferenceAssistData, optional=True),
    F("msrAssistData", MsrAssistData, optional=True),
    F("systemInfoAssistData", SystemInfoAssistData, optional=True),
    F("gps-AssistData", GPS_AssistData, optional=True),
    F("extensionContainer", INT(), optional=True), ext=True)

# SET->SMLC response subset: locationInfo/locationError are what a
# SET-based A-GPS session reports back (measure-info IEs omitted: a
# GNSS receiver SET never produces E-OTD measurements)
LocationInfo = SEQ(F("refFrame", INT(0, 65535)),
                   F("gpsTOW", INT(0, 14399999), optional=True),
                   F("fixType", INT(0, 1)),
                   F("posEstimate", OCTETS(1, 20)))
LocationError = SEQ(
    F("locErrorReason", ENUM((
        "unDefined", "notEnoughBTSs", "notEnoughSats",
        "eotdLocCalAssDataMissing", "eotdAssDataMissing",
        "gpsLocCalAssDataMissing", "gpsAssDataMissing", "methodNotSupported",
        "notProcessed", "refBTSForGPSNotServingBTS",
        "refBTSForEOTDNotServingBTS"), ext=True)),
    F("additionalAssistanceData", SEQ(
        F("gpsAssistanceData", OCTETS(1, 40), optional=True),
        F("extensionContainer", INT(), optional=True), ext=True),
      optional=True), ext=True)
MsrPosition_Rsp = SEQ(
    F("multipleSets", INT(), optional=True),        # not produced by a SET
    F("referenceIdentity", INT(), optional=True),   # (placeholders keep the
    F("otd-MeasureInfo", INT(), optional=True),     # presence-bit layout)
    F("locationInfo", LocationInfo, optional=True),
    F("gps-MeasureInfo", INT(), optional=True),
    F("locationError", LocationError, optional=True),
    F("extensionContainer", INT(), optional=True), ext=True)

ProtocolError = SEQ(
    F("errorCause", ENUM((
        "unDefined", "missingComponet", "incorrectData",
        "missingIEorComponentElement", "messageTooShort",
        "unknowReferenceNumber"), ext=True)),
    F("extensionContainer", INT(), optional=True), ext=True)

RRLP_Component = CHOICE(
    ("msrPositionReq", MsrPosition_Req), ("msrPositionRsp", MsrPosition_Rsp),
    ("assistanceData", AssistanceData), ("assistanceDataAck", NULL()),
    ("protocolError", ProtocolError), ext=True)

RRLP_PDU = SEQ(F("referenceNumber", INT(0, 7)),
               F("component", RRLP_Component))


# =========================================================================
# Assistance collection + conversion (gnss_sdr_supl_client.cc:227-340)
# =========================================================================

@dataclasses.dataclass
class SuplAssist:
    """Raw collected RRLP assistance (reference ``supl_assist_t``)."""

    gps_week: int | None = None
    gps_tow: float | None = None          # [s], 0.08 s resolution
    ref_lat: float | None = None          # [deg]
    ref_lon: float | None = None
    ref_uncert_m: float | None = None
    iono: dict | None = None
    utc: dict | None = None
    ephemerides: list = dataclasses.field(default_factory=list)
    almanacs: list = dataclasses.field(default_factory=list)
    almanac_wna: int = 0
    acq_tow: float | None = None
    acq_assist: list = dataclasses.field(default_factory=list)


def collect_rrlp(assist: SuplAssist, rrlp: dict) -> bool:
    """Harvest one RRLP PDU into ``assist`` (reference supl_collect_rrlp);
    returns True when the server flags more assistance on the way."""
    kind, comp = rrlp["component"]
    hdr = None
    more = False
    if kind == "assistanceData":
        gps = comp.get("gps-AssistData")
        hdr = gps["controlHeader"] if gps else None
        more = comp.get("moreAssDataToBeSent") == "moreMessagesOnTheWay"
    elif kind == "msrPositionReq":
        gps = comp.get("gps-AssistData")
        hdr = gps["controlHeader"] if gps else None
    if hdr is None:
        return more
    if hdr.get("referenceTime"):
        t = hdr["referenceTime"]["gpsTime"]
        assist.gps_tow = t["gpsTOW23b"] * 0.08
        assist.gps_week = t["gpsWeek"]
    if hdr.get("refLocation"):
        gad = hdr["refLocation"]["threeDLocation"]
        # 3GPP TS 23.032 ellipsoid point with altitude + uncertainty
        # ellipsoid (shape 0x90), the only shape SLPs emit (supl.c:680)
        if len(gad) == 14 and gad[0] == 0x90:
            lat = ((gad[1] & 0x7F) << 16 | gad[2] << 8 | gad[3])
            assist.ref_lat = (90.0 / (1 << 23)) * (
                -lat if gad[1] & 0x80 else lat)
            lon = gad[4] << 16 | gad[5] << 8 | gad[6]
            if lon >= 1 << 23:
                lon -= 1 << 24
            assist.ref_lon = (360.0 / (1 << 24)) * lon
            k = max(gad[9] & 0x7F, gad[10] & 0x7F)
            assist.ref_uncert_m = 10.0 * (1.1 ** k - 1.0)
    if hdr.get("ionosphericModel"):
        assist.iono = hdr["ionosphericModel"]
    if hdr.get("utcModel"):
        assist.utc = hdr["utcModel"]
    if hdr.get("navigationModel"):
        for el in hdr["navigationModel"]["navModelList"]:
            skind, sval = el["satStatus"]
            if skind in ("newSatelliteAndModelUC", "newNaviModelUC"):
                assist.ephemerides.append(
                    (el["satelliteID"] + 1, sval))    # satelliteID = PRN-1
    if hdr.get("almanac"):
        assist.almanac_wna = hdr["almanac"]["alamanacWNa"]
        for el in hdr["almanac"]["almanacList"]:
            assist.almanacs.append(el)
    if hdr.get("acquisAssist"):
        assist.acq_tow = hdr["acquisAssist"]["timeRelation"]["gpsTOW"] * 0.08
        for el in hdr["acquisAssist"]["acquisList"]:
            assist.acq_assist.append(el)
    return more


def eph_from_rrlp(prn: int, ue: dict):
    """RRLP UncompressedEphemeris -> KeplerEphemeris with IS-GPS-200 LNAV
    scale factors (reference gnss_sdr_supl_client.cc:300-340)."""
    from gnss_sdr_tpu_torch.models.ephemeris import KeplerEphemeris
    return KeplerEphemeris(
        prn=prn,
        toc=ue["ephemToc"] * 16.0, af0=ue["ephemAF0"] * 2.0 ** -31,
        af1=ue["ephemAF1"] * 2.0 ** -43, af2=ue["ephemAF2"] * 2.0 ** -55,
        tgd=ue["ephemTgd"] * 2.0 ** -31,
        toe=ue["ephemToe"] * 16.0,
        sqrt_a=ue["ephemAPowerHalf"] * 2.0 ** -19,
        e=ue["ephemE"] * 2.0 ** -33,
        m0=ue["ephemM0"] * 2.0 ** -31 * PI,
        delta_n=ue["ephemDeltaN"] * 2.0 ** -43 * PI,
        omega0=ue["ephemOmegaA0"] * 2.0 ** -31 * PI,
        omega_dot=ue["ephemOmegaADot"] * 2.0 ** -43 * PI,
        omega=ue["ephemW"] * 2.0 ** -31 * PI,
        i0=ue["ephemI0"] * 2.0 ** -31 * PI,
        idot=ue["ephemIDot"] * 2.0 ** -43 * PI,
        cuc=ue["ephemCuc"] * 2.0 ** -29, cus=ue["ephemCus"] * 2.0 ** -29,
        crc=ue["ephemCrc"] * 2.0 ** -5, crs=ue["ephemCrs"] * 2.0 ** -5,
        cic=ue["ephemCic"] * 2.0 ** -29, cis=ue["ephemCis"] * 2.0 ** -29,
        iode=ue["ephemIODC"] & 0xFF, iodc=ue["ephemIODC"],
        health=ue["ephemSVhealth"], ura=ue["ephemURA"])


def eph_to_rrlp(eph) -> dict:
    """Inverse of :func:`eph_from_rrlp` (the SLP side; used by the QA
    server and the round-trip tests)."""
    def q(v, lsb, signed=True):
        return int(round(v / lsb))
    return {
        "ephemCodeOnL2": 1, "ephemURA": int(eph.ura),
        "ephemSVhealth": int(eph.health), "ephemIODC": int(eph.iodc),
        "ephemL2Pflag": 0,
        "ephemSF1Rsvd": {"reserved1": 0, "reserved2": 0, "reserved3": 0,
                         "reserved4": 0},
        "ephemTgd": q(eph.tgd, 2.0 ** -31), "ephemToc": int(eph.toc / 16),
        "ephemAF2": q(eph.af2, 2.0 ** -55), "ephemAF1": q(eph.af1, 2.0 ** -43),
        "ephemAF0": q(eph.af0, 2.0 ** -31), "ephemCrs": q(eph.crs, 2.0 ** -5),
        "ephemDeltaN": q(eph.delta_n, 2.0 ** -43 * PI),
        "ephemM0": q(eph.m0, 2.0 ** -31 * PI),
        "ephemCuc": q(eph.cuc, 2.0 ** -29),
        "ephemE": q(eph.e, 2.0 ** -33, signed=False),
        "ephemCus": q(eph.cus, 2.0 ** -29),
        "ephemAPowerHalf": q(eph.sqrt_a, 2.0 ** -19, signed=False),
        "ephemToe": int(eph.toe / 16), "ephemFitFlag": 0, "ephemAODA": 0,
        "ephemCic": q(eph.cic, 2.0 ** -29),
        "ephemOmegaA0": q(eph.omega0, 2.0 ** -31 * PI),
        "ephemCis": q(eph.cis, 2.0 ** -29),
        "ephemI0": q(eph.i0, 2.0 ** -31 * PI),
        "ephemCrc": q(eph.crc, 2.0 ** -5),
        "ephemW": q(eph.omega, 2.0 ** -31 * PI),
        "ephemOmegaADot": q(eph.omega_dot, 2.0 ** -43 * PI),
        "ephemIDot": q(eph.idot, 2.0 ** -43 * PI)}


def alm_from_rrlp(el: dict, wna: int):
    """RRLP AlmanacElement -> GpsAlmanac (radians; reference
    gnss_sdr_supl_client.cc:266-280 keeps semicircles — the repo's almanac
    model matches models/nav/gps_lnav.py and is in radians)."""
    from gnss_sdr_tpu_torch.models.almanac import GpsAlmanac
    return GpsAlmanac(
        prn=el["satelliteID"] + 1,
        e=el["almanacE"] * 2.0 ** -21, toa=el["alamanacToa"] * 4096.0,
        delta_i=el["almanacKsii"] * 2.0 ** -19 * PI,
        omega_dot=el["almanacOmegaDot"] * 2.0 ** -38 * PI,
        sqrt_a=el["almanacAPowerHalf"] * 2.0 ** -11,
        omega0=el["almanacOmega0"] * 2.0 ** -23 * PI,
        omega=el["almanacW"] * 2.0 ** -23 * PI,
        m0=el["almanacM0"] * 2.0 ** -23 * PI,
        af0=el["almanacAF0"] * 2.0 ** -20,
        af1=el["almanacAF1"] * 2.0 ** -38,
        health=el["almanacSVhealth"], wna=wna)


def alm_to_rrlp(alm) -> dict:
    return {
        "satelliteID": alm.prn - 1,
        "almanacE": int(round(alm.e / 2.0 ** -21)),
        "alamanacToa": int(round(alm.toa / 4096.0)),
        "almanacKsii": int(round(alm.delta_i / (2.0 ** -19 * PI))),
        "almanacOmegaDot": int(round(alm.omega_dot / (2.0 ** -38 * PI))),
        "almanacSVhealth": int(alm.health),
        "almanacAPowerHalf": int(round(alm.sqrt_a / 2.0 ** -11)),
        "almanacOmega0": int(round(alm.omega0 / (2.0 ** -23 * PI))),
        "almanacW": int(round(alm.omega / (2.0 ** -23 * PI))),
        "almanacM0": int(round(alm.m0 / (2.0 ** -23 * PI))),
        "almanacAF0": int(round(alm.af0 / 2.0 ** -20)),
        "almanacAF1": int(round(alm.af1 / 2.0 ** -38))}


def to_assistance(assist: SuplAssist):
    """SuplAssist -> the repo's warm-start Assistance record (reference:
    ControlThread::assist_GNSS pushing Gps_Ephemeris/Almanac/Iono/Utc into
    the flowgraph + agnss ref time/location, control_thread.cc:692-800)."""
    from gnss_sdr_tpu_torch.models.ephemeris import IonoParams, UtcParams
    from gnss_sdr_tpu_torch.receiver.control import Assistance
    from gnss_sdr_tpu_torch.receiver.pvt.geodesy import geodetic_to_ecef
    ephs = {("G", prn): eph_from_rrlp(prn, ue)
            for prn, ue in assist.ephemerides}
    alms = {}
    for el in assist.almanacs:
        a = alm_from_rrlp(el, assist.almanac_wna)
        alms[("G", a.prn)] = a
    iono = None
    if assist.iono:
        d = assist.iono
        iono = IonoParams(
            alpha=(d["alfa0"] * 2.0 ** -30, d["alfa1"] * 2.0 ** -27,
                   d["alfa2"] * 2.0 ** -24, d["alfa3"] * 2.0 ** -24),
            beta=(d["beta0"] * 2.0 ** 11, d["beta1"] * 2.0 ** 14,
                  d["beta2"] * 2.0 ** 16, d["beta3"] * 2.0 ** 16),
            valid=True)
    utc = None
    if assist.utc:
        d = assist.utc
        utc = UtcParams(a0=d["utcA0"] * 2.0 ** -30,
                        a1=d["utcA1"] * 2.0 ** -50,
                        tot=d["utcTot"] * 4096.0, wnt=d["utcWNt"],
                        delta_t_ls=d["utcDeltaTls"], valid=True)
    pos = None
    if assist.ref_lat is not None:
        pos = np.asarray(geodetic_to_ecef(
            np.radians(assist.ref_lat), np.radians(assist.ref_lon), 0.0))
    return Assistance(ephemerides=ephs, almanacs=alms, iono=iono, utc=utc,
                      position_ecef=pos, tow_s=assist.gps_tow,
                      acq=acq_hints(assist))


def acq_hints(assist: SuplAssist) -> dict:
    """RRLP AcquisAssist -> per-satellite Doppler/code-phase hints with
    ICD scalings (3GPP TS 44.031: doppler0 in 2.5 Hz units, doppler1 as
    -42 + raw at 1/42 Hz/s). The reference narrows the acquisition
    Doppler window to these (pcps_assisted_acquisition_cc.cc:180-186)."""
    out = {}
    for el in assist.acq_assist:
        d1 = el.get("addionalDoppler")
        out[("G", el["svid"] + 1)] = {
            "doppler_hz": el["doppler0"] * 2.5,
            "doppler_rate_hz_s": ((d1["doppler1"] - 42) / 42.0
                                  if d1 else 0.0),
            "doppler_uncert_hz": ({0: 12.5, 1: 25.0, 2: 50.0, 3: 100.0,
                                   4: 200.0}.get(d1["dopplerUncertainty"],
                                                 200.0) if d1 else 1000.0),
            "code_phase_chips": float(el["codePhase"]),
            "code_phase_int_ms": int(el["intCodePhase"]),
            "tow_s": assist.acq_tow}
    return out


# =========================================================================
# Client (reference supl_get_assist + gnss_sdr_supl_client)
# =========================================================================

_CAPABILITIES = {
    "posTechnology": {"agpsSETassisted": False, "agpsSETBased": True,
                      "autonomousGPS": False, "aFLT": False, "eCID": False,
                      "eOTD": False, "oTDOA": False},
    "prefMethod": "agpsSETBasedPreferred",
    "posProtocol": {"tia801": False, "rrlp": True, "rrc": False}}

# reference supl.c:918 hard-codes this BCD msisdn as the SET identity
_MSISDN = bytes.fromhex("ffff919448458398")

REQUEST_EPHEMERIS = 1      # reference supl_client request=1: eph+reftime
REQUEST_ALMANAC = 0        # request=0: almanac/iono/UTC/ref loc+time
REQUEST_ACQUISITION = 2    # request=2: acquisition assistance


def _requested_assist(request: int) -> dict:
    """RequestedAssistData flag sets per request mode (reference
    pdu_make_ulp_pos_init, supl.c:470-518)."""
    flags = {k: False for k in (
        "almanacRequested", "utcModelRequested", "ionosphericModelRequested",
        "dgpsCorrectionsRequested", "referenceLocationRequested",
        "referenceTimeRequested", "acquisitionAssistanceRequested",
        "realTimeIntegrityRequested", "navigationModelRequested")}
    if request == REQUEST_EPHEMERIS:
        flags["navigationModelRequested"] = True
        flags["referenceTimeRequested"] = True
    elif request == REQUEST_ACQUISITION:
        flags["acquisitionAssistanceRequested"] = True
        flags["referenceTimeRequested"] = True
        flags["referenceLocationRequested"] = True
    else:
        flags["almanacRequested"] = True
        flags["utcModelRequested"] = True
        flags["ionosphericModelRequested"] = True
        flags["referenceLocationRequested"] = True
        flags["referenceTimeRequested"] = True
    return flags


class SuplClient:
    """SET-side SUPL 1.0 session (reference Gnss_Sdr_Supl_Client)."""

    def __init__(self, server: str, port: int = 7275, *,
                 mcc: int = 244, mnc: int = 5, lac: int = 0x59E2,
                 ci: int = 0x31B0, timeout_s: float = 20.0):
        self.server, self.port = server, int(port)
        self.cell = {"refMCC": mcc, "refMNC": mnc, "refLAC": lac,
                     "refCI": ci}
        self.timeout_s = timeout_s

    def _location_id(self) -> dict:
        return {"cellInfo": ("gsmCell", dict(self.cell)),
                "status": "current"}

    def get_assist(self, request: int = REQUEST_EPHEMERIS) -> SuplAssist:
        """Run one full SUPL session; returns the collected assistance.
        Raises on protocol violations (reference returns E_SUPL_* codes)."""
        sock = socket.create_connection((self.server, self.port),
                                        timeout=self.timeout_s)
        try:
            return self._session(sock, request)
        finally:
            sock.close()

    def _session(self, sock: socket.socket, request: int) -> SuplAssist:
        set_sid = {"sessionId": 1, "setId": ("msisdn", _MSISDN)}
        sock.sendall(encode_ulp(
            {"setSessionID": set_sid},
            ("msSUPLSTART", {"sETCapabilities": _CAPABILITIES,
                             "locationId": self._location_id(),
                             "qoP": {"horacc": 0}})))
        pdu = recv_ulp(sock)
        kind, _resp = pdu["message"]
        if kind != "msSUPLRESPONSE":
            raise ValueError(f"SUPL: expected SUPLRESPONSE, got {kind}")
        # echo the server-allocated slpSessionID on every later PDU
        # (reference supl_response_harvest)
        session = {"setSessionID": set_sid,
                   "slpSessionID": pdu["sessionID"].get("slpSessionID")}
        sock.sendall(encode_ulp(session, ("msSUPLPOSINIT", {
            "sETCapabilities": _CAPABILITIES,
            "requestedAssistData": _requested_assist(request),
            "locationId": self._location_id()})))
        assist = SuplAssist()
        while True:
            pdu = recv_ulp(sock)
            kind, msg = pdu["message"]
            if kind == "msSUPLEND":
                break
            if kind != "msSUPLPOS":
                raise ValueError(f"SUPL: expected SUPLPOS, got {kind}")
            pkind, payload = msg["posPayLoad"]
            if pkind != "rrlpPayload":
                raise ValueError(f"SUPL: non-RRLP payload {pkind}")
            rrlp = decode(RRLP_PDU, payload)
            more = collect_rrlp(assist, rrlp)
            if not more:
                break
            # ack so the SLP sends the next batch (pdu_make_ulp_rrlp_ack)
            ack = encode(RRLP_PDU, {
                "referenceNumber": rrlp["referenceNumber"],
                "component": ("assistanceDataAck", None)})
            sock.sendall(encode_ulp(
                session, ("msSUPLPOS",
                          {"posPayLoad": ("rrlpPayload", ack)})))
        try:
            sock.sendall(encode_ulp(session, ("msSUPLEND", {})))
        except OSError:
            pass
        return assist


def fetch_supl_assistance(conf) -> "object | None":
    """Read the reference's GNSS-SDR.SUPL_* INI keys, run the eph + almanac
    requests, and return a merged Assistance (ControlThread::assist_GNSS).
    Returns None when SUPL is disabled or the server is unreachable."""
    if not conf.property("GNSS-SDR.SUPL_gps_enabled", False):
        return None
    server = str(conf.property("GNSS-SDR.SUPL_gps_ephemeris_server",
                               "supl.google.com"))
    port = int(conf.property("GNSS-SDR.SUPL_gps_ephemeris_port", 7275))
    mcc = int(conf.property("GNSS-SDR.SUPL_MCC", 244))
    mnc = int(conf.property("GNSS-SDR.SUPL_MNC", 5))
    lac = int(str(conf.property("GNSS-SDR.SUPL_LAC", "0x59e2")), 0)
    ci = int(str(conf.property("GNSS-SDR.SUPL_CI", "0x31b0")), 0)
    client = SuplClient(server, port, mcc=mcc, mnc=mnc, lac=lac, ci=ci)
    try:
        assist = client.get_assist(REQUEST_EPHEMERIS)
        alm = client.get_assist(REQUEST_ALMANAC)
    except (OSError, ValueError) as e:
        log.warning("SUPL: assistance request to %s:%d failed: %s",
                    server, port, e)
        return None
    # merge: request=1 carries ephemerides+reftime, request=0 the rest
    assist.almanacs = alm.almanacs
    assist.almanac_wna = alm.almanac_wna
    assist.iono = assist.iono or alm.iono
    assist.utc = assist.utc or alm.utc
    if assist.ref_lat is None:
        assist.ref_lat, assist.ref_lon = alm.ref_lat, alm.ref_lon
        assist.ref_uncert_m = alm.ref_uncert_m
    # third session against the (possibly distinct) acquisition server
    # (reference supl_client_acquisition_, request=2)
    acq_server = str(conf.property("GNSS-SDR.SUPL_gps_acquisition_server",
                                   server))
    acq_port = int(conf.property("GNSS-SDR.SUPL_gps_acquisition_port",
                                 port))
    try:
        acq = SuplClient(acq_server, acq_port, mcc=mcc, mnc=mnc,
                         lac=lac, ci=ci).get_assist(REQUEST_ACQUISITION)
        assist.acq_assist = acq.acq_assist
        assist.acq_tow = acq.acq_tow
        if assist.ref_lat is None:
            assist.ref_lat, assist.ref_lon = acq.ref_lat, acq.ref_lon
    except (OSError, ValueError) as e:
        log.warning("SUPL: acquisition-assist request failed: %s", e)
    log.info("SUPL: %d ephemerides, %d almanacs, %d acq hints from %s",
             len(assist.ephemerides), len(assist.almanacs),
             len(assist.acq_assist), server)
    return to_assistance(assist)


# =========================================================================
# QA server (the SLP side — supl.google.com's role in the reference docs)
# =========================================================================

def gad_point_alt_uncert(lat_deg: float, lon_deg: float,
                         alt_m: float = 0.0, uncert_code: int = 10) -> bytes:
    """3GPP TS 23.032 'ellipsoid point with altitude and uncertainty
    ellipsoid' (shape 9, 14 octets) — the GAD shape SLPs send and
    supl.c:680 decodes."""
    lat = int(round(abs(lat_deg) * (1 << 23) / 90.0))
    buf = bytearray(14)
    buf[0] = 0x90
    buf[1] = (0x80 if lat_deg < 0 else 0) | ((lat >> 16) & 0x7F)
    buf[2], buf[3] = (lat >> 8) & 0xFF, lat & 0xFF
    lon = int(round(lon_deg * (1 << 24) / 360.0)) & 0xFFFFFF
    buf[4], buf[5], buf[6] = lon >> 16, (lon >> 8) & 0xFF, lon & 0xFF
    alt = min(max(int(round(alt_m)), -32767), 32767)
    buf[7] = (0x80 if alt < 0 else 0) | ((abs(alt) >> 8) & 0x7F)
    buf[8] = abs(alt) & 0xFF
    buf[9] = buf[10] = uncert_code & 0x7F
    return bytes(buf)


class SuplServer(threading.Thread):
    """Single-session SLP for QA: answers one SET with canned assistance,
    split over ``n_batches`` RRLP AssistanceData PDUs to exercise the
    moreAssDataToBeSent ack loop."""

    def __init__(self, *, ephemerides=(), almanacs=(), wna: int = 0,
                 iono=None, utc=None, ref_llh=None, gps_week: int = 0,
                 gps_tow: float = 0.0, n_batches: int = 2,
                 port: int = 0, n_sessions: int = 1, acq_assist=()):
        super().__init__(daemon=True)
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", port))
        self._srv.listen(1)
        self.port = self._srv.getsockname()[1]
        self.ephemerides = list(ephemerides)
        self.almanacs = list(almanacs)
        self.wna = wna
        self.iono, self.utc = iono, utc
        self.ref_llh = ref_llh
        self.gps_week, self.gps_tow = gps_week, gps_tow
        self.n_batches = max(1, n_batches)
        self.n_sessions = max(1, n_sessions)
        # (prn, doppler_hz, code_phase_chips) acquisition-assist entries
        self.acq_assist = list(acq_assist)
        self.error: Exception | None = None
        self.got_start: dict | None = None
        self.got_posinit: dict | None = None
        self.n_acks = 0

    def run(self) -> None:
        try:
            for _ in range(self.n_sessions):
                self._serve()
        except Exception as e:
            self.error = e
        finally:
            self._srv.close()

    def _control_headers(self, req: dict) -> list[dict]:
        """Build the assistance batches the SET asked for."""
        hdr: dict = {}
        if req.get("referenceTimeRequested"):
            hdr["referenceTime"] = {"gpsTime": {
                "gpsTOW23b": int(self.gps_tow / 0.08),
                "gpsWeek": self.gps_week % 1024}}
        if req.get("referenceLocationRequested") and self.ref_llh:
            hdr["refLocation"] = {"threeDLocation": gad_point_alt_uncert(
                self.ref_llh[0], self.ref_llh[1], self.ref_llh[2])}
        if req.get("ionosphericModelRequested") and self.iono is not None:
            a, b = self.iono.alpha, self.iono.beta
            hdr["ionosphericModel"] = {
                "alfa0": int(round(a[0] / 2.0 ** -30)),
                "alfa1": int(round(a[1] / 2.0 ** -27)),
                "alfa2": int(round(a[2] / 2.0 ** -24)),
                "alfa3": int(round(a[3] / 2.0 ** -24)),
                "beta0": int(round(b[0] / 2.0 ** 11)),
                "beta1": int(round(b[1] / 2.0 ** 14)),
                "beta2": int(round(b[2] / 2.0 ** 16)),
                "beta3": int(round(b[3] / 2.0 ** 16))}
        if req.get("utcModelRequested") and self.utc is not None:
            u = self.utc
            hdr["utcModel"] = {
                "utcA1": int(round(u.a1 / 2.0 ** -50)),
                "utcA0": int(round(u.a0 / 2.0 ** -30)),
                "utcTot": int(u.tot / 4096.0), "utcWNt": u.wnt % 256,
                "utcDeltaTls": int(u.delta_t_ls), "utcWNlsf": u.wnt % 256,
                "utcDN": 7, "utcDeltaTlsf": int(u.delta_t_ls)}
        if req.get("almanacRequested") and self.almanacs:
            hdr["almanac"] = {
                "alamanacWNa": self.wna % 256,
                "almanacList": [alm_to_rrlp(a) for a in self.almanacs]}
        if req.get("acquisitionAssistanceRequested") and self.acq_assist:
            hdr["acquisAssist"] = {
                "timeRelation": {"gpsTOW": int(self.gps_tow / 0.08)},
                "acquisList": [
                    {"svid": prn - 1,
                     "doppler0": int(round(fd / 2.5)),
                     "addionalDoppler": {"doppler1": 42,   # 0 Hz/s
                                         "dopplerUncertainty": 4},
                     "codePhase": int(cp) % 1023,
                     "intCodePhase": 0, "gpsBitNumber": 0,
                     "codePhaseSearchWindow": 15}
                    for prn, fd, cp in self.acq_assist]}
        headers = [dict(hdr)] if hdr else []
        if req.get("navigationModelRequested") and self.ephemerides:
            # split the ephemeris set over the remaining batches the way
            # live SLPs page navigation models
            per = max(1, -(-len(self.ephemerides) // self.n_batches))
            for i in range(0, len(self.ephemerides), per):
                headers.append({"navigationModel": {"navModelList": [
                    {"satelliteID": e.prn - 1,
                     "satStatus": ("newSatelliteAndModelUC", eph_to_rrlp(e))}
                    for e in self.ephemerides[i: i + per]]}})
        return headers or [{}]

    def _serve(self) -> None:
        self._srv.settimeout(30.0)
        conn, _peer = self._srv.accept()
        conn.settimeout(30.0)
        try:
            pdu = recv_ulp(conn)
            kind, start = pdu["message"]
            assert kind == "msSUPLSTART", kind
            self.got_start = start
            set_sid = pdu["sessionID"]["setSessionID"]
            session = {"setSessionID": set_sid,
                       "slpSessionID": {
                           "sessionID": b"\x00\x00\x00\x01",
                           "slpId": ("iPAddress",
                                     ("ipv4Address", b"\x7f\x00\x00\x01"))}}
            conn.sendall(encode_ulp(
                session, ("msSUPLRESPONSE", {"posMethod": "agpsSETbased"})))
            pdu = recv_ulp(conn)
            kind, posinit = pdu["message"]
            assert kind == "msSUPLPOSINIT", kind
            self.got_posinit = posinit
            req = posinit.get("requestedAssistData") or {}
            headers = self._control_headers(req)
            for i, hdr in enumerate(headers):
                last = i == len(headers) - 1
                rrlp = encode(RRLP_PDU, {
                    "referenceNumber": i % 8,
                    "component": ("assistanceData", {
                        "gps-AssistData": {"controlHeader": hdr},
                        "moreAssDataToBeSent": (
                            "noMoreMessages" if last
                            else "moreMessagesOnTheWay")})})
                conn.sendall(encode_ulp(
                    session, ("msSUPLPOS",
                              {"posPayLoad": ("rrlpPayload", rrlp)})))
                if not last:
                    ack_pdu = recv_ulp(conn)
                    akind, ack = ack_pdu["message"]
                    assert akind == "msSUPLPOS", akind
                    ckind, _ = decode(
                        RRLP_PDU, ack["posPayLoad"][1])["component"]
                    assert ckind == "assistanceDataAck", ckind
                    self.n_acks += 1
            conn.sendall(encode_ulp(session, ("msSUPLEND", {})))
        finally:
            conn.close()
