"""Minimal ROS1 bag (format 2.0) reader, writer and sensor codecs (the
port's copy of ``toyslam_tpu/runtime/rosbag.py``; numpy, ``struct`` and
``bz2`` on the host).

The reference's bag replay (``ndt_rosbag_mapping_node.cpp:27-78``:
``rosbag::View`` over ``/velodyne_points`` + ``pcl::fromROSMsg``) without
ROS: the record structure (op 0x03 bag header, 0x07 connection, 0x05
chunk with none/bz2/lz4 compression, 0x02 message data, 0x04/0x06 index
and chunk info skipped), and the message types the pipelines consume:

- ``sensor_msgs/PointCloud2`` -> float32 [n, 4] xyzi
  (``ndt_rosbag_mapping_node.cpp:50`` ``pcl::fromROSMsg``)
- ``sensor_msgs/Imu`` -> (stamp, gyro[3], accel[3])
  (``uwb_imu_batch_node.cpp:3027`` ``imuCallback``)
- ``sensor_msgs/NavSatFix`` -> (stamp, lat, lon, alt, cov[9])
- NovAtel ``novatel_msgs/INSPVAX`` -> (gps week/ms, lla, vel, rpy)
  (``uwb_imu_batch_node.cpp:2284`` ``gpsCallback``)
- ``gnss_comm/GnssMeasMsg`` -> per-satellite observations
  (``gnssSpp.cpp:827`` ``rawMeasCallback``)

lz4 chunks use the LZ4 Frame format rosbag's roslz4 writes (``runtime/
lz4f``). ``pack_bag_scans`` parses a bag straight into the padded scan
stack through the C reader of ``csrc/host/bagpack.c`` (``native=True``,
the default) or through the Python reader here (``native=False``); the
two give byte-equal stacks. The writer (none/bz2/lz4 chunks) and the
encoders give the JAX package's bytes for the same input.
"""

from __future__ import annotations

import bz2
import struct
from pathlib import Path

import numpy as np

from toyslam_tpu_torch.runtime import lz4f

_MAGIC = b"#ROSBAG V2.0\n"


def _parse_header(data: bytes) -> dict:
    fields = {}
    pos = 0
    while pos < len(data):
        (flen,) = struct.unpack_from("<I", data, pos)
        pos += 4
        entry = data[pos:pos + flen]
        pos += flen
        key, _, value = entry.partition(b"=")
        fields[key.decode()] = value
    return fields


def _read_record(buf: bytes, pos: int):
    (hlen,) = struct.unpack_from("<I", buf, pos)
    header = _parse_header(buf[pos + 4: pos + 4 + hlen])
    pos += 4 + hlen
    (dlen,) = struct.unpack_from("<I", buf, pos)
    data = buf[pos + 4: pos + 4 + dlen]
    return header, data, pos + 4 + dlen


def read_messages(path: str | Path, topics=None):
    """Yield (topic, time_sec, datatype, raw_message_bytes) from a bag."""
    buf = Path(path).read_bytes()
    if not buf.startswith(_MAGIC):
        raise ValueError("not a ROS bag v2.0 file")
    pos = len(_MAGIC)
    connections = {}

    def handle_stream(stream: bytes):
        p = 0
        while p < len(stream):
            h, d, p = _read_record(stream, p)
            op = h.get("op", b"")[0] if h.get("op") else None
            if op == 0x07:  # connection
                (conn,) = struct.unpack("<I", h["conn"])
                conn_fields = _parse_header(d)
                connections[conn] = {
                    "topic": h["topic"].decode(),
                    "type": conn_fields.get("type", b"").decode(),
                }
            elif op == 0x02:  # message data
                (conn,) = struct.unpack("<I", h["conn"])
                # bag 2.0 `time` field is secs (u32 LE) then nsecs (u32 LE),
                # so secs land in the LOW 32 bits of the little-endian u64.
                sec, nsec = struct.unpack("<II", h["time"])
                info = connections.get(conn, {"topic": "?", "type": "?"})
                t_sec = sec + nsec * 1e-9
                yield info["topic"], t_sec, info["type"], d

    while pos < len(buf):
        header, data, pos = _read_record(buf, pos)
        op = header.get("op", b"")[0] if header.get("op") else None
        if op == 0x05:  # chunk
            compression = header.get("compression", b"none").decode()
            if compression == "bz2":
                payload = bz2.decompress(data)
            elif compression == "lz4":
                payload = lz4f.decompress(data)
            elif compression == "none":
                payload = data
            else:
                raise ValueError(f"unsupported chunk compression: {compression}")
            for item in handle_stream(payload):
                topic = item[0]
                if topics is None or topic in topics:
                    yield item
        elif op in (0x03, 0x04, 0x06, 0x07, 0x02):
            # bag header / index / chunk info / stray records outside chunks
            if op == 0x07:
                (conn,) = struct.unpack("<I", header["conn"])
                conn_fields = _parse_header(data)
                connections[conn] = {
                    "topic": header["topic"].decode(),
                    "type": conn_fields.get("type", b"").decode(),
                }


def decode_pointcloud2(raw: bytes) -> np.ndarray:
    """sensor_msgs/PointCloud2 -> float32 [n, 4] xyzi.

    Serialized layout: std_msgs/Header (seq u32, stamp 2xu32, frame_id
    string), height u32, width u32, fields[], is_bigendian u8, point_step
    u32, row_step u32, data[], is_dense u8.
    """
    pos = 0
    pos += 4 + 8  # seq + stamp
    (flen,) = struct.unpack_from("<I", raw, pos)
    pos += 4 + flen  # frame_id
    height, width = struct.unpack_from("<II", raw, pos)
    pos += 8
    (n_fields,) = struct.unpack_from("<I", raw, pos)
    pos += 4
    fields = {}
    for _ in range(n_fields):
        (nlen,) = struct.unpack_from("<I", raw, pos)
        pos += 4
        name = raw[pos:pos + nlen].decode()
        pos += nlen
        offset, datatype, count = struct.unpack_from("<IBI", raw, pos)
        pos += 9
        fields[name] = (offset, datatype, count)
    is_bigendian = raw[pos]
    pos += 1
    (point_step,) = struct.unpack_from("<I", raw, pos)
    pos += 4
    (row_step,) = struct.unpack_from("<I", raw, pos)
    pos += 4
    (dlen,) = struct.unpack_from("<I", raw, pos)
    pos += 4
    data = raw[pos:pos + dlen]

    n = height * width
    if is_bigendian:
        raise ValueError("big-endian PointCloud2 not supported")

    def col(name):
        if name not in fields:
            return None
        offset, datatype, _ = fields[name]
        if datatype != 7:  # FLOAT32
            raise ValueError(f"field {name}: only FLOAT32 supported")
        return np.ndarray((n,), np.float32, data, offset, (point_step,)).copy()

    x, y, z = col("x"), col("y"), col("z")
    i = col("intensity")
    if i is None:
        i = np.zeros_like(x)
    return np.stack([x, y, z, i], 1).astype(np.float32)


# ---------------------------------------------------------------------------
# Sensor message decoders beyond PointCloud2 (real-data ingestion for the
# fusion/GNSS branches; reference callbacks cited per type)
# ---------------------------------------------------------------------------


def _read_std_header(raw: bytes, pos: int):
    """std_msgs/Header (seq u32, stamp 2xu32, frame_id string) ->
    (stamp_sec, new_pos)."""
    _seq, sec, nsec = struct.unpack_from("<III", raw, pos)
    pos += 12
    (flen,) = struct.unpack_from("<I", raw, pos)
    pos += 4 + flen
    return sec + nsec * 1e-9, pos


def decode_imu(raw: bytes) -> dict:
    """sensor_msgs/Imu -> dict(stamp, quat[4] xyzw, gyro[3], accel[3]).

    Wire layout: Header, orientation (4 f64), orientation_covariance
    (9 f64), angular_velocity (3 f64), its covariance (9 f64),
    linear_acceleration (3 f64), its covariance (9 f64). The reference
    consumes angular_velocity + linear_acceleration per message
    (``uwb_imu_batch_node.cpp:3027`` ``imuCallback``).
    """
    stamp, pos = _read_std_header(raw, 0)
    quat = np.frombuffer(raw, np.float64, 4, pos)
    pos += 4 * 8 + 9 * 8
    gyro = np.frombuffer(raw, np.float64, 3, pos)
    pos += 3 * 8 + 9 * 8
    accel = np.frombuffer(raw, np.float64, 3, pos)
    return {"stamp": stamp, "quat": quat.copy(), "gyro": gyro.copy(),
            "accel": accel.copy()}


def encode_imu(stamp_sec: float, gyro, accel, quat=None,
               frame_id: str = "imu") -> bytes:
    sec = int(stamp_sec)
    nsec = int(round((stamp_sec - sec) * 1e9))
    fid = frame_id.encode()
    out = struct.pack("<III", 0, sec, nsec)
    out += struct.pack("<I", len(fid)) + fid
    q = np.asarray(quat if quat is not None else [0, 0, 0, 1], np.float64)
    cov = np.zeros(9, np.float64)
    out += q.tobytes() + cov.tobytes()
    out += np.asarray(gyro, np.float64).tobytes() + cov.tobytes()
    out += np.asarray(accel, np.float64).tobytes() + cov.tobytes()
    return out


def decode_navsatfix(raw: bytes) -> dict:
    """sensor_msgs/NavSatFix -> dict(stamp, status, lat, lon, alt, cov[9]).

    Wire layout: Header, NavSatStatus (int8 status, uint16 service),
    latitude/longitude/altitude (3 f64), position_covariance (9 f64),
    position_covariance_type (u8). Degrees/meters, WGS84.
    """
    stamp, pos = _read_std_header(raw, 0)
    status, _service = struct.unpack_from("<bH", raw, pos)
    pos += 3
    lat, lon, alt = struct.unpack_from("<ddd", raw, pos)
    pos += 24
    cov = np.frombuffer(raw, np.float64, 9, pos).copy()
    return {"stamp": stamp, "status": status, "lat": lat, "lon": lon,
            "alt": alt, "cov": cov}


def encode_navsatfix(stamp_sec: float, lat: float, lon: float, alt: float,
                     status: int = 0, frame_id: str = "gps") -> bytes:
    sec = int(stamp_sec)
    nsec = int(round((stamp_sec - sec) * 1e9))
    fid = frame_id.encode()
    out = struct.pack("<III", 0, sec, nsec)
    out += struct.pack("<I", len(fid)) + fid
    out += struct.pack("<bH", status, 1)
    out += struct.pack("<ddd", lat, lon, alt)
    out += np.zeros(9, np.float64).tobytes()
    out += struct.pack("<B", 0)
    return out


# novatel_msgs/INSPVAX (novatel_span_driver): CommonHeader mirrors the
# NovAtel binary log header — message_id u16, message_type u8,
# port_address u8, message_length u16, sequence u16, idle_time u8,
# time_status u8, gps_week u16, gps_week_seconds u32 (milliseconds into
# the week, despite the name — the reference divides by 1000,
# ``uwb_imu_batch_node.cpp:2289``), receiver_status u32, reserved u16,
# software_version u16.
_INSPVAX_HDR = "<HBBHHBBHIIHH"
# Body: ins_status u32, position_type u32, lat/lon/alt f64, undulation
# f32, north/east/up velocity f64, roll/pitch/azimuth f64 (degrees),
# 9 x f32 stds, extended_status u32, seconds_since_update u16.
_INSPVAX_BODY = "<IIdddfddddddfffffffffIH"


def decode_inspvax(raw: bytes) -> dict:
    """novatel_msgs/INSPVAX -> the fields the reference's ``gpsCallback``
    consumes (``uwb_imu_batch_node.cpp:2284-2360``): GPS week + ms, LLA,
    ENU velocity (NovAtel reports up_velocity with the sign the reference
    negates — returned raw here), roll/pitch/azimuth in degrees."""
    n = struct.calcsize(_INSPVAX_HDR)
    (_mid, _mtype, _port, _mlen, _seq, _idle, _tstat, gps_week,
     gps_week_ms, _rstat, _res, _ver) = struct.unpack_from(
        _INSPVAX_HDR, raw, 0)
    (_ins_status, _pos_type, lat, lon, alt, _und,
     vn, ve, vu, roll, pitch, azimuth,
     _s1, _s2, _s3, _s4, _s5, _s6, _s7, _s8, _s9,
     _ext, _ssu) = struct.unpack_from(_INSPVAX_BODY, raw, n)
    return {
        "gps_week": gps_week, "gps_week_ms": gps_week_ms,
        "lat": lat, "lon": lon, "alt": alt,
        "north_velocity": vn, "east_velocity": ve, "up_velocity": vu,
        "roll": roll, "pitch": pitch, "azimuth": azimuth,
    }


def encode_inspvax(gps_week: int, gps_week_ms: int, lat: float, lon: float,
                   alt: float, vn: float = 0.0, ve: float = 0.0,
                   vu: float = 0.0, roll: float = 0.0, pitch: float = 0.0,
                   azimuth: float = 0.0) -> bytes:
    hdr = struct.pack(_INSPVAX_HDR, 1465, 0, 0, 0, 0, 0, 0,
                      gps_week, gps_week_ms, 0, 0, 0)
    body = struct.pack(_INSPVAX_BODY, 3, 56, lat, lon, alt, 0.0,
                       vn, ve, vu, roll, pitch, azimuth,
                       *([0.0] * 9), 0, 0)
    return hdr + body


def decode_gnss_obs(raw: bytes, pos: int = 0):
    """One gnss_comm/GnssObsMsg -> (dict, new_pos).

    Wire layout (gnss_comm): GnssTimeMsg time (u32 week, f64 tow),
    uint32 sat, then variable-length arrays freqs/CN0 (f64), LLI/code
    (u8), psr/psr_std/cp/cp_std/dopp/dopp_std (f64), status (u8) — each
    prefixed by a u32 count. The reference consumes sat, psr[0], CN0[0],
    dopp[0] (``gnssSpp.cpp:895-922,1175-1212``)."""
    week, tow = struct.unpack_from("<Id", raw, pos)
    pos += 12
    (sat,) = struct.unpack_from("<I", raw, pos)
    pos += 4
    out = {"week": week, "tow": tow, "sat": sat}

    def arr(dtype, width):
        nonlocal pos
        (cnt,) = struct.unpack_from("<I", raw, pos)
        pos += 4
        if cnt > len(raw):
            raise ValueError("corrupt GnssObsMsg array count")
        v = np.frombuffer(raw, dtype, cnt, pos).copy()
        pos += cnt * width
        return v

    for name in ("freqs", "CN0"):
        out[name] = arr(np.float64, 8)
    for name in ("LLI", "code"):
        out[name] = arr(np.uint8, 1)
    for name in ("psr", "psr_std", "cp", "cp_std", "dopp", "dopp_std"):
        out[name] = arr(np.float64, 8)
    out["status"] = arr(np.uint8, 1)
    return out, pos


def decode_gnss_meas(raw: bytes) -> list[dict]:
    """gnss_comm/GnssMeasMsg (Header + GnssObsMsg[]) -> list of per-sat
    observation dicts (``gnssSpp.cpp:827`` ``rawMeasCallback``)."""
    _stamp, pos = _read_std_header(raw, 0)
    (n_obs,) = struct.unpack_from("<I", raw, pos)
    pos += 4
    if n_obs > len(raw):
        raise ValueError("corrupt GnssMeasMsg observation count")
    obs = []
    for _ in range(n_obs):
        o, pos = decode_gnss_obs(raw, pos)
        obs.append(o)
    return obs


def encode_gnss_meas(week: int, tow: float, sats, psr, cn0=None, dopp=None,
                     freqs=None, stamp_sec: float = 0.0) -> bytes:
    """Assemble a gnss_comm/GnssMeasMsg for the given epoch (one L1
    observation per satellite)."""
    sats = np.asarray(sats)
    n = len(sats)
    cn0 = np.asarray(cn0 if cn0 is not None else np.full(n, 45.0))
    dopp = np.asarray(dopp if dopp is not None else np.zeros(n))
    freqs = np.asarray(freqs if freqs is not None else
                       np.full(n, 1575.42e6))
    sec = int(stamp_sec)
    nsec = int(round((stamp_sec - sec) * 1e9))
    out = struct.pack("<III", 0, sec, nsec) + struct.pack("<I", 0)
    out += struct.pack("<I", n)
    for i in range(n):
        out += struct.pack("<Id", week, tow)
        out += struct.pack("<I", int(sats[i]))

        def farr(vals):
            v = np.asarray(vals, np.float64)
            return struct.pack("<I", len(v)) + v.tobytes()

        def barr(vals):
            v = np.asarray(vals, np.uint8)
            return struct.pack("<I", len(v)) + v.tobytes()

        out += farr([freqs[i]]) + farr([cn0[i]])
        out += barr([0]) + barr([1])
        out += farr([psr[i]]) + farr([1.0]) + farr([0.0]) + farr([0.0])
        out += farr([dopp[i]]) + farr([0.1])
        out += barr([1])
    return out


def read_pointclouds(path: str | Path, topic: str = "/velodyne_points"):
    """Yield (time_sec, xyzi [n, 4]) for every PointCloud2 on a topic
    (the reference's rosbag::View loop, ``ndt_rosbag_mapping_node.cpp:
    42-50``)."""
    for tpc, t, typ, raw in read_messages(path, topics={topic}):
        if "PointCloud2" in typ or typ == "?":
            yield t, decode_pointcloud2(raw)


def pack_bag_scans(path: str | Path, topic: str = "/velodyne_points",
                   capacity: int = 131072, max_scans: int | None = None,
                   native: bool = True):
    """One-pass bag -> packed layout: every PointCloud2 on ``topic`` into
    the fixed-capacity xyzi [S, capacity, 4] f32 + mask [S, capacity]
    stack the pipelines consume, with the message times [S] f64 and the
    raw point counts [S] i64 (the reference's rosbag::View +
    pcl::fromROSMsg ingestion, ``ndt_rosbag_mapping_node.cpp:27-78``).

    ``native=True`` parses with the C reader (``csrc/host/bagpack.c``);
    with ``max_scans=None`` a count-only C pass sizes the buffers first.
    ``native=False`` runs the Python reader; both give byte-equal results.
    """
    from toyslam_tpu_torch.runtime import loader

    if native:
        from toyslam_tpu_torch.runtime import native as host

        buf = Path(path).read_bytes()
        if max_scans is None:
            max_scans = host.bag_count_scans(buf, topic)
        xyzi, mask, times, counts, n = host.bag_pack_scans(
            buf, topic, max_scans, capacity)
        return xyzi[:n], mask[:n], times[:n], counts[:n]
    if max_scans is None:
        max_scans = sum(1 for _, _, typ, _ in read_messages(path,
                                                            topics={topic})
                        if "PointCloud2" in typ or typ == "?")
    xyzi = np.full((max_scans, capacity, 4), loader.PAD_COORD, np.float32)
    xyzi[..., 3] = 0.0
    mask = np.zeros((max_scans, capacity), bool)
    times = np.zeros((max_scans,), np.float64)
    counts = np.zeros((max_scans,), np.int64)
    n = 0
    for t, pts in read_pointclouds(path, topic):
        if n >= max_scans:
            break
        xyzi[n], mask[n] = loader.pack_scan(pts, capacity)
        times[n] = t
        counts[n] = min(len(pts), capacity)
        n += 1
    return xyzi[:n], mask[:n], times[:n], counts[:n]


# ---------------------------------------------------------------------------
# Minimal writer (tests, demos, dataset repacking)
# ---------------------------------------------------------------------------


def _header_bytes(fields: dict) -> bytes:
    out = b""
    for k, v in fields.items():
        entry = k.encode() + b"=" + v
        out += struct.pack("<I", len(entry)) + entry
    return out


def _record(fields: dict, data: bytes) -> bytes:
    h = _header_bytes(fields)
    return struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data


def encode_pointcloud2(xyzi: np.ndarray, stamp_sec: float = 0.0,
                       frame_id: str = "velodyne") -> bytes:
    xyzi = np.ascontiguousarray(xyzi, np.float32)
    n = len(xyzi)
    out = b""
    sec = int(stamp_sec)
    nsec = int((stamp_sec - sec) * 1e9)
    out += struct.pack("<III", 0, sec, nsec)
    fid = frame_id.encode()
    out += struct.pack("<I", len(fid)) + fid
    out += struct.pack("<II", 1, n)  # height, width
    names = ["x", "y", "z", "intensity"]
    out += struct.pack("<I", len(names))
    for k, name in enumerate(names):
        nb = name.encode()
        out += struct.pack("<I", len(nb)) + nb
        out += struct.pack("<IBI", 4 * k, 7, 1)
    out += struct.pack("<B", 0)  # little endian
    out += struct.pack("<I", 16)  # point_step
    out += struct.pack("<I", 16 * n)  # row_step
    body = xyzi.tobytes()
    out += struct.pack("<I", len(body)) + body
    out += struct.pack("<B", 1)  # is_dense
    return out


def write_mixed_bag(path: str | Path, records,
                    compression: str = "none") -> None:
    """Write a multi-topic bag.

    ``records``: iterable of (topic, datatype, time_sec, raw_message_bytes)
    — one connection per distinct topic, messages in iteration order
    inside one chunk (none/bz2/lz4). This is the test/demo counterpart of
    the mixed-topic bags the reference subscribes to (scans + IMU + GPS +
    raw GNSS on one bag, ``launch/uwb_imu_batch.launch``).
    """
    conns: dict[str, int] = {}
    conn_recs = b""
    msg_recs = b""
    for topic, datatype, t_sec, raw in records:
        if topic not in conns:
            cid = len(conns)
            conns[topic] = cid
            conn_fields = _header_bytes({
                "topic": topic.encode(), "type": datatype.encode(),
                "md5sum": b"0" * 32, "message_definition": b"",
            })
            conn_recs += _record(
                {"op": b"\x07", "conn": struct.pack("<I", cid),
                 "topic": topic.encode()}, conn_fields)
        sec = int(t_sec)
        nsec = int((t_sec - sec) * 1e9)
        t_field = struct.pack("<II", sec, nsec)  # secs low, nsecs high
        msg_recs += _record(
            {"op": b"\x02", "conn": struct.pack("<I", conns[topic]),
             "time": t_field}, raw)
    chunk_payload = conn_recs + msg_recs
    if compression == "bz2":
        chunk_data = bz2.compress(chunk_payload)
    elif compression == "lz4":
        chunk_data = lz4f.compress(chunk_payload)
    elif compression == "none":
        chunk_data = chunk_payload
    else:
        raise ValueError(f"unsupported compression: {compression}")
    chunk = _record({"op": b"\x05", "compression": compression.encode(),
                     "size": struct.pack("<I", len(chunk_payload))},
                    chunk_data)
    bag_header = _record(
        {"op": b"\x03", "index_pos": struct.pack("<Q", 0),
         "conn_count": struct.pack("<I", len(conns)),
         "chunk_count": struct.pack("<I", 1)},
        b" " * 4096,  # reference tools pad the header record
    )
    Path(path).write_bytes(_MAGIC + bag_header + chunk)


def write_bag(path: str | Path, messages, topic: str = "/velodyne_points",
              datatype: str = "sensor_msgs/PointCloud2",
              compression: str = "none") -> None:
    """Write (time_sec, xyzi) pairs as a minimal bag (none/bz2/lz4
    chunks)."""
    write_mixed_bag(
        path,
        ((topic, datatype, t, encode_pointcloud2(xyzi, t))
         for t, xyzi in messages),
        compression=compression)


# ---------------------------------------------------------------------------
# One-pass sensor ingestion: bag -> packed numpy arrays for the estimators
# ---------------------------------------------------------------------------


def pack_bag_imu(path: str | Path, topic: str = "/imu/data"):
    """Bag -> (times [T] f64, acc [T, 3] f32, gyro [T, 3] f32, dt [T] f32).

    The packed tensor layout the fusion pipelines consume
    (``estimators/preintegration``, ``pipelines/fusion``); dt[i] is the
    gap to the previous message (dt[0] repeats dt[1], matching the
    reference's first-sample handling)."""
    times, acc, gyro = [], [], []
    for _, t, typ, raw in read_messages(path, topics={topic}):
        if "Imu" not in typ and typ != "?":
            continue
        m = decode_imu(raw)
        times.append(m["stamp"] if m["stamp"] > 0 else t)
        acc.append(m["accel"])
        gyro.append(m["gyro"])
    times = np.asarray(times, np.float64)
    acc = np.asarray(acc, np.float32).reshape(-1, 3)
    gyro = np.asarray(gyro, np.float32).reshape(-1, 3)
    dt = np.zeros(len(times), np.float32)
    if len(times) > 1:
        dt[1:] = np.diff(times)
        dt[0] = dt[1]
    return times, acc, gyro, dt


def pack_bag_gps(path: str | Path, topic: str = "/novatel_data/inspvax"):
    """Bag -> GPS fix arrays from INSPVAX or NavSatFix messages.

    Returns (times [G] f64 unix seconds, lla [G, 3] f64, vel_enu [G, 3]
    f64 — zeros for NavSatFix, which carries no velocity). INSPVAX times
    come from GPS week/ms exactly as the reference converts them
    (``uwb_imu_batch_node.cpp:2289`` via ``geodesy.gps_to_unix_time``);
    the ENU velocity applies the reference's up-sign convention
    (east, north, -up, ``:2340``)."""
    from toyslam_tpu_torch.core import geodesy

    times, lla, vel = [], [], []
    for _, t, typ, raw in read_messages(path, topics={topic}):
        if "INSPVAX" in typ:
            m = decode_inspvax(raw)
            ts = float(geodesy.gps_to_unix_time(
                m["gps_week"], m["gps_week_ms"] / 1000.0))
            times.append(ts)
            lla.append([m["lat"], m["lon"], m["alt"]])
            vel.append([m["east_velocity"], m["north_velocity"],
                        -m["up_velocity"]])
        elif "NavSatFix" in typ or typ == "?":
            m = decode_navsatfix(raw)
            times.append(m["stamp"] if m["stamp"] > 0 else t)
            lla.append([m["lat"], m["lon"], m["alt"]])
            vel.append([0.0, 0.0, 0.0])
    return (np.asarray(times, np.float64),
            np.asarray(lla, np.float64).reshape(-1, 3),
            np.asarray(vel, np.float64).reshape(-1, 3))


def pack_bag_gnss_meas(path: str | Path, topic: str = "/ublox_driver/range_meas"):
    """Bag -> list of epochs, each a dict of per-satellite arrays
    (week, tow, sats [n] i32, psr/cn0/dopp [n] f64) — the input layout
    ``gnss.pipeline`` consumes (reference: ``gnssSpp.cpp:827``)."""
    epochs = []
    for _, _t, typ, raw in read_messages(path, topics={topic}):
        if "GnssMeas" not in typ and typ != "?":
            continue
        obs = decode_gnss_meas(raw)
        if not obs:
            continue
        epochs.append({
            "week": obs[0]["week"],
            "tow": obs[0]["tow"],
            "sats": np.asarray([o["sat"] for o in obs], np.int32),
            "psr": np.asarray([o["psr"][0] if len(o["psr"]) else np.nan
                               for o in obs]),
            "cn0": np.asarray([o["CN0"][0] if len(o["CN0"]) else np.nan
                               for o in obs]),
            "dopp": np.asarray([o["dopp"][0] if len(o["dopp"]) else np.nan
                                for o in obs]),
        })
    return epochs
