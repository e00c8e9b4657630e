"""WGS84 geodesy: ECEF <-> LLA <-> ENU, GPS time helpers (port of
``toyslam_tpu/core/geodesy.py``).

The reference's ``CoordinateConverter`` (``gnssSpp.cpp:225-322``), the
flat-earth GPS->ENU of the batch node (``uwb_imu_batch_node.cpp:
2182-2213``) and GPS<->Unix time (``:2216-2252``, ``gnssSpp.cpp:211-222``).
Every function is elementwise over leading dimensions and runs where its
tensors lie, in their dtype. Use float64 wherever ECEF coordinates appear:
in float32 a coordinate of ~6.4e6 m rounds to ~0.5 m.
"""

from __future__ import annotations

import torch

SPEED_OF_LIGHT = 299792458.0  # m/s
GPS_L1_FREQ = 1575.42e6  # Hz
GPS_L1_WAVELENGTH = SPEED_OF_LIGHT / GPS_L1_FREQ
EARTH_ROTATION_RATE = 7.2921151467e-5  # rad/s
WGS84_A = 6378137.0
WGS84_B = 6356752.31424518
WGS84_E_SQ = 1.0 - (WGS84_B * WGS84_B) / (WGS84_A * WGS84_A)
MU_GPS = 3.9860050e14  # m^3/s^2 (GPS ICD value, gnssSpp.cpp:38)
GPS_SECONDS_PER_WEEK = 604800.0
GPS_LEAP_SECONDS = 18.0
GPS_UNIX_EPOCH_OFFSET = 315964800.0  # Unix time of GPS epoch 1980-01-06


def _tensor(x):
    """Numbers as float64 host tensors; tensors as they are."""
    return x if torch.is_tensor(x) else torch.as_tensor(x, dtype=torch.float64)


def lla_to_ecef(lat, lon, alt):
    """Geodetic (rad, rad, m) -> ECEF [..., 3] (``gnssSpp.cpp:255-261``)."""
    lat, lon, alt = _tensor(lat), _tensor(lon), _tensor(alt)
    sin_lat = torch.sin(lat)
    N = WGS84_A / torch.sqrt(1.0 - WGS84_E_SQ * sin_lat * sin_lat)
    x = (N + alt) * torch.cos(lat) * torch.cos(lon)
    y = (N + alt) * torch.cos(lat) * torch.sin(lon)
    z = (N * (1.0 - WGS84_E_SQ) + alt) * sin_lat
    return torch.stack(torch.broadcast_tensors(x, y, z), -1)


def ecef_to_lla(ecef, iterations: int = 5):
    """ECEF [..., 3] -> (lat, lon, h) [..., 3] by a fixed number of
    fixed-point steps (``gnssSpp.cpp:228-252``)."""
    x, y, z = ecef[..., 0], ecef[..., 1], ecef[..., 2]
    lon = torch.atan2(y, x)
    p = torch.sqrt(x * x + y * y)
    lat = torch.atan2(z, p * (1.0 - WGS84_E_SQ))
    h = torch.zeros_like(lat)
    for _ in range(iterations):
        sin_lat = torch.sin(lat)
        N = WGS84_A / torch.sqrt(1.0 - WGS84_E_SQ * sin_lat * sin_lat)
        h = p / torch.cos(lat) - N
        lat = torch.atan2(z, p * (1.0 - WGS84_E_SQ * N / (N + h)))
    return torch.stack([lat, lon, h], -1)


def ecef_to_enu_rotation(lat, lon):
    """[..., 3, 3] whose rows are the e, n, u unit vectors in ECEF
    (``gnssSpp.cpp:264-287``)."""
    lat, lon = _tensor(lat), _tensor(lon)
    sl, cl = torch.sin(lat), torch.cos(lat)
    so, co = torch.sin(lon), torch.cos(lon)
    zero = torch.zeros_like(sl * so)
    return torch.stack([
        torch.stack([-so + zero, co + zero, zero], -1),
        torch.stack([-sl * co, -sl * so, cl + zero], -1),
        torch.stack([cl * co, cl * so, sl + zero], -1),
    ], -2)


def _rotate(R, v):
    """R [..., 3, 3] @ v [..., 3], elementwise products summed (exact in
    the inputs' dtype on any device)."""
    return (R * v[..., None, :]).sum(-1)


def ecef_to_enu(point_ecef, ref_ecef, ref_lla=None):
    if ref_lla is None:
        ref_lla = ecef_to_lla(ref_ecef)
    R = ecef_to_enu_rotation(ref_lla[..., 0], ref_lla[..., 1])
    return _rotate(R, point_ecef - ref_ecef)


def enu_to_ecef(enu, ref_ecef, ref_lla=None):
    if ref_lla is None:
        ref_lla = ecef_to_lla(ref_ecef)
    R = ecef_to_enu_rotation(ref_lla[..., 0], ref_lla[..., 1])
    return ref_ecef + _rotate(R.transpose(-1, -2), enu)


def ecef_velocity_to_enu(vel_ecef, lat, lon):
    return _rotate(ecef_to_enu_rotation(lat, lon), vel_ecef)


def gps_to_unix_time(gps_week, gps_tow):
    """GPS week/TOW -> Unix seconds (``uwb_imu_batch_node.cpp:2216-2252``),
    with the microsecond autodetect: a TOW above 1e6 but below one week of
    microseconds is rescaled (``:2221-2227``; some receivers publish TOW in
    us)."""
    gps_week, gps_tow = _tensor(gps_week), _tensor(gps_tow)
    is_usec = (gps_tow > 1.0e6) & (gps_tow < GPS_SECONDS_PER_WEEK * 1.0e6)
    gps_tow = torch.where(is_usec, gps_tow / 1.0e6, gps_tow)
    return (GPS_UNIX_EPOCH_OFFSET + gps_week * GPS_SECONDS_PER_WEEK + gps_tow
            - GPS_LEAP_SECONDS)


def unix_to_gps_time(unix_time):
    gps_sec = _tensor(unix_time) - GPS_UNIX_EPOCH_OFFSET + GPS_LEAP_SECONDS
    week = torch.floor(gps_sec / GPS_SECONDS_PER_WEEK)
    tow = gps_sec - week * GPS_SECONDS_PER_WEEK
    return week, tow


def adjust_time_within_week(t, t_ref):
    """t - t_ref wrapped into [-302400, 302400] (half a GPS week)."""
    dt = t - t_ref
    dt = torch.where(dt > GPS_SECONDS_PER_WEEK / 2,
                     dt - GPS_SECONDS_PER_WEEK, dt)
    return torch.where(dt < -GPS_SECONDS_PER_WEEK / 2,
                       dt + GPS_SECONDS_PER_WEEK, dt)


def flat_earth_gps_to_enu(lat, lon, alt, ref_lat, ref_lon, ref_alt):
    """The batch node's small-area equirectangular GPS->ENU
    (``uwb_imu_batch_node.cpp:2182-2213``). Radians in."""
    lat, lon, alt = _tensor(lat), _tensor(lon), _tensor(alt)
    n = (lat - ref_lat) * WGS84_A
    e = (lon - ref_lon) * WGS84_A * torch.cos(_tensor(ref_lat))
    u = alt - ref_alt
    return torch.stack(torch.broadcast_tensors(e, n, u), -1)


def flat_earth_enu_to_gps(enu, ref_lat, ref_lon, ref_alt):
    """Exact inverse of ``flat_earth_gps_to_enu`` (radians out)."""
    lat = ref_lat + enu[..., 1] / WGS84_A
    lon = ref_lon + enu[..., 0] / (WGS84_A * torch.cos(_tensor(ref_lat)))
    alt = ref_alt + enu[..., 2]
    return lat, lon, alt
