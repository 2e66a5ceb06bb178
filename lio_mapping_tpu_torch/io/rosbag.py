"""Pure-Python rosbag (v2.0 disk format) reader — no ROS required (copy of
lio_mapping_tpu.io.rosbag; ``convert_bag`` writes through the port's ``native``).

Parity target: the reference's entire input path is ROS bag replay
(`rosbag play fast1.bag`, README.md:31-36) into subscribers of
``sensor_msgs/PointCloud2`` (processor_node.cc) and ``sensor_msgs/Imu``
(MeasurementManager.cc:40-49). This module lets a reference user bring the
exact same ``.bag`` files: it parses the rosbag container and deserializes
the two message types natively, and ``convert_bag`` repacks a bag into the
engine's binary sequence log (``native.SequenceLog``).

Format: http://wiki.ros.org/Bags/Format/2.0 — records of
``<u32 header_len><header><u32 data_len><data>`` where a header is a list
of ``<u32 len>name=value`` fields; chunk records (op 0x05) hold nested
connection/message records, optionally bz2/lz4-compressed. Only a linear
streaming pass is needed: rosbag writers emit each connection record
inside a chunk before the first message that uses it.

A minimal ``BagWriter`` (uncompressed or bz2 chunks, correct bag header /
connection / chunk-info records) is included for tests and for exporting
sequences back to ROS tooling.
"""

from __future__ import annotations

import bz2
import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

MAGIC = b"#ROSBAG V2.0\n"

OP_MSG_DATA = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX_DATA = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07

# sensor_msgs/PointField datatype codes
_PF_DTYPES = {
    1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
    5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64,
}


def _parse_header(buf: bytes) -> Dict[bytes, bytes]:
    fields = {}
    off = 0
    while off < len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        item = buf[off:off + flen]
        off += flen
        eq = item.index(b"=")
        fields[item[:eq]] = item[eq + 1:]
    return fields


def _read_record(f) -> Optional[Tuple[Dict[bytes, bytes], bytes]]:
    raw = f.read(4)
    if len(raw) < 4:
        return None
    (hlen,) = struct.unpack("<I", raw)
    header = _parse_header(f.read(hlen))
    (dlen,) = struct.unpack("<I", f.read(4))
    data = f.read(dlen)
    return header, data


def _iter_subrecords(buf: bytes):
    off = 0
    n = len(buf)
    while off < n:
        (hlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        header = _parse_header(buf[off:off + hlen])
        off += hlen
        (dlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        yield header, buf[off:off + dlen]
        off += dlen


@dataclass
class Connection:
    conn_id: int
    topic: str
    msg_type: str
    md5sum: str = ""
    message_definition: str = ""


@dataclass
class BagMessage:
    topic: str
    msg_type: str
    time: float       # record receipt time (bag time), seconds
    raw: bytes        # serialized message body


class BagReader:
    """Streaming reader over all messages of a bag, chunk by chunk."""

    def __init__(self, path: str):
        self.path = Path(path)
        self.connections: Dict[int, Connection] = {}

    def __iter__(self) -> Iterator[BagMessage]:
        with open(self.path, "rb") as f:
            magic = f.read(len(MAGIC))
            if magic != MAGIC:
                raise IOError(
                    f"{self.path}: not a rosbag 2.0 file (magic {magic!r}); "
                    "rosbag 1.x or compressed-whole files are not supported")
            while True:
                rec = _read_record(f)
                if rec is None:
                    return
                header, data = rec
                op = header[b"op"][0]
                if op == OP_CHUNK:
                    comp = header.get(b"compression", b"none").decode()
                    if comp == "none":
                        payload = data
                    elif comp == "bz2":
                        payload = bz2.decompress(data)
                    elif comp == "lz4":
                        try:
                            import lz4.frame  # optional, not baked in
                        except ImportError as e:
                            raise IOError(
                                "bag uses lz4 chunk compression; re-record "
                                "with bz2/none (rosbag compress --bz2)") from e
                        payload = lz4.frame.decompress(data)
                    else:
                        raise IOError(f"unknown chunk compression {comp!r}")
                    yield from self._handle_records(_iter_subrecords(payload))
                elif op == OP_CONNECTION:
                    self._add_connection(header, data)
                # bag header / index / chunk-info records need no action:
                # the linear chunk scan visits every message exactly once

    def _handle_records(self, records) -> Iterator[BagMessage]:
        for header, data in records:
            op = header[b"op"][0]
            if op == OP_CONNECTION:
                self._add_connection(header, data)
            elif op == OP_MSG_DATA:
                (conn_id,) = struct.unpack("<I", header[b"conn"])
                secs, nsecs = struct.unpack("<II", header[b"time"])
                conn = self.connections.get(conn_id)
                if conn is None:
                    raise IOError(
                        f"message on undeclared connection {conn_id} "
                        "(non-standard bag; connection records must precede "
                        "their messages)")
                yield BagMessage(
                    topic=conn.topic, msg_type=conn.msg_type,
                    time=secs + 1e-9 * nsecs, raw=data)

    def _add_connection(self, header: Dict[bytes, bytes], data: bytes):
        (conn_id,) = struct.unpack("<I", header[b"conn"])
        if conn_id in self.connections:
            return
        chdr = _parse_header(data)
        self.connections[conn_id] = Connection(
            conn_id=conn_id,
            topic=header[b"topic"].decode(),
            msg_type=chdr.get(b"type", b"").decode(),
            md5sum=chdr.get(b"md5sum", b"").decode(),
            message_definition=chdr.get(b"message_definition", b"").decode(),
        )

    def topics(self) -> Dict[str, Tuple[str, int]]:
        """One full pass: {topic: (msg_type, message_count)}."""
        counts: Dict[str, int] = {}
        for msg in self:
            counts[msg.topic] = counts.get(msg.topic, 0) + 1
        return {c.topic: (c.msg_type, counts.get(c.topic, 0))
                for c in self.connections.values()}


# ---------------------------------------------------------------------------
# Message deserialization (little-endian ROS serialization)
# ---------------------------------------------------------------------------


def _read_string(buf: bytes, off: int) -> Tuple[str, int]:
    (n,) = struct.unpack_from("<I", buf, off)
    off += 4
    return buf[off:off + n].decode(errors="replace"), off + n


def _read_ros_header(buf: bytes, off: int) -> Tuple[float, str, int]:
    (_seq, secs, nsecs) = struct.unpack_from("<III", buf, off)
    off += 12
    frame_id, off = _read_string(buf, off)
    return secs + 1e-9 * nsecs, frame_id, off


@dataclass
class PointCloud2:
    stamp: float
    frame_id: str
    height: int
    width: int
    fields: List[Tuple[str, int, int, int]]  # (name, offset, datatype, count)
    is_bigendian: bool
    point_step: int
    row_step: int
    data: bytes
    is_dense: bool

    def field_array(self, name: str) -> Optional[np.ndarray]:
        """Extract one per-point field column as a flat (N,) array."""
        for fname, offset, datatype, count in self.fields:
            if fname == name:
                dt = _PF_DTYPES[datatype]
                n = self.height * self.width
                raw = np.frombuffer(self.data, np.uint8)
                raw = raw[:n * self.point_step].reshape(n, self.point_step)
                width = np.dtype(dt).itemsize * count
                col = raw[:, offset:offset + width].copy().view(dt)
                if self.is_bigendian:
                    col = col.byteswap()
                return col[:, 0] if count == 1 else col
        return None

    def xyz(self) -> np.ndarray:
        x = self.field_array("x")
        y = self.field_array("y")
        z = self.field_array("z")
        if x is None or y is None or z is None:
            raise IOError("PointCloud2 lacks x/y/z fields")
        return np.stack([x, y, z], axis=-1).astype(np.float32)


def parse_pointcloud2(raw: bytes) -> PointCloud2:
    """Deserialize sensor_msgs/PointCloud2 (the reference's sweep input)."""
    stamp, frame_id, off = _read_ros_header(raw, 0)
    height, width = struct.unpack_from("<II", raw, off)
    off += 8
    (n_fields,) = struct.unpack_from("<I", raw, off)
    off += 4
    fields = []
    for _ in range(n_fields):
        name, off = _read_string(raw, off)
        f_off, datatype, count = struct.unpack_from("<IBI", raw, off)
        off += 9
        fields.append((name, f_off, datatype, count))
    (is_bigendian,) = struct.unpack_from("<B", raw, off)
    off += 1
    point_step, row_step = struct.unpack_from("<II", raw, off)
    off += 8
    (dlen,) = struct.unpack_from("<I", raw, off)
    off += 4
    data = raw[off:off + dlen]
    off += dlen
    (is_dense,) = struct.unpack_from("<B", raw, off)
    return PointCloud2(stamp, frame_id, height, width, fields,
                       bool(is_bigendian), point_step, row_step, data,
                       bool(is_dense))


@dataclass
class ImuMsg:
    stamp: float
    frame_id: str
    orientation: np.ndarray          # (4,) wxyz
    angular_velocity: np.ndarray     # (3,)
    linear_acceleration: np.ndarray  # (3,)


def parse_imu(raw: bytes) -> ImuMsg:
    """Deserialize sensor_msgs/Imu (MeasurementManager's input)."""
    stamp, frame_id, off = _read_ros_header(raw, 0)
    ox, oy, oz, ow = struct.unpack_from("<4d", raw, off)
    off += 32 + 72  # orientation + its covariance
    wx, wy, wz = struct.unpack_from("<3d", raw, off)
    off += 24 + 72
    ax, ay, az = struct.unpack_from("<3d", raw, off)
    return ImuMsg(stamp, frame_id,
                  np.asarray([ow, ox, oy, oz]),
                  np.asarray([wx, wy, wz]),
                  np.asarray([ax, ay, az]))


# ---------------------------------------------------------------------------
# Bag -> sequence log conversion
# ---------------------------------------------------------------------------


def _relative_times(cloud: PointCloud2, scan_period: float) -> Optional[np.ndarray]:
    """Per-point relative time in [0, scan_period] when the cloud carries a
    time channel (Velodyne ``time``/``t``, Ouster ``t`` in ns, Hesai
    ``timestamp`` absolute f64); None otherwise (the point processor then
    reconstructs it from azimuth, PointProcessor.cc:393-423)."""
    for name in ("time", "t", "timestamp", "time_offset"):
        col = cloud.field_array(name)
        if col is None:
            continue
        col = col.astype(np.float64)
        if col.size == 0:
            return None
        col = col - col.min()
        if col.max() > 1e6:      # nanoseconds (Ouster u32)
            col *= 1e-9
        elif col.max() > 100.0:  # microseconds
            col *= 1e-6
        if col.max() > 10.0 * scan_period:
            continue             # absolute stamps that didn't normalize
        return col.astype(np.float32)
    return None


def detect_topics(path: str) -> Tuple[Optional[str], Optional[str]]:
    """First PointCloud2 + Imu topics in the bag (by message count)."""
    info = BagReader(path).topics()
    clouds = [(n, t) for t, (ty, n) in info.items()
              if ty == "sensor_msgs/PointCloud2"]
    imus = [(n, t) for t, (ty, n) in info.items() if ty == "sensor_msgs/Imu"]
    cloud_topic = max(clouds)[1] if clouds else None
    imu_topic = max(imus)[1] if imus else None
    return cloud_topic, imu_topic


def convert_bag(
    bag_path: str,
    out_path: str,
    points_topic: Optional[str] = None,
    imu_topic: Optional[str] = None,
    scan_period: float = 0.1,
    min_range: float = 0.0,
) -> Tuple[int, int]:
    """Repack a rosbag into a SequenceLog. Returns (n_sweeps, n_imu).

    Equivalent to the reference's live graph boundary: what
    processor_node + MeasurementManager consumed from the ROS transport
    now lands in the binary log the CLI replays.
    """
    from .. import native

    if points_topic is None or imu_topic is None:
        auto_cloud, auto_imu = detect_topics(bag_path)
        points_topic = points_topic or auto_cloud
        imu_topic = imu_topic or auto_imu
    if points_topic is None:
        raise IOError(f"{bag_path}: no sensor_msgs/PointCloud2 topic found")

    log = native.SequenceLog(out_path, write=True)
    n_sweeps = n_imu = 0
    try:
        for msg in BagReader(bag_path):
            if msg.topic == points_topic:
                cloud = parse_pointcloud2(msg.raw)
                xyz = cloud.xyz()
                finite = np.isfinite(xyz).all(axis=-1)
                if min_range > 0.0:
                    finite &= (xyz * xyz).sum(-1) > min_range * min_range
                rel = _relative_times(cloud, scan_period)
                rel = rel[finite] if rel is not None else None
                # per-point ring annotation (Velodyne/RoboSense driver
                # `ring` u16 PointField — the reference's PointXYZIR input,
                # point_types.h:37-44): carried into the .liol v2 log so
                # the `uneven` sensor mode can consume it
                ring = cloud.field_array("ring")
                ring = ring[finite].astype(np.uint16) \
                    if ring is not None else None
                stamp = cloud.stamp if cloud.stamp > 0 else msg.time
                log.write_sweep(stamp, xyz[finite], rel, ring=ring)
                n_sweeps += 1
            elif msg.topic == imu_topic:
                imu = parse_imu(msg.raw)
                stamp = imu.stamp if imu.stamp > 0 else msg.time
                log.write_imu(stamp, imu.linear_acceleration.astype(np.float32),
                              imu.angular_velocity.astype(np.float32))
                n_imu += 1
    finally:
        log.close()
    return n_sweeps, n_imu


# ---------------------------------------------------------------------------
# Minimal writer (tests + exporting sequences back to ROS tooling)
# ---------------------------------------------------------------------------


def _make_header(fields: Dict[bytes, bytes]) -> bytes:
    out = b""
    for k, v in fields.items():
        item = k + b"=" + v
        out += struct.pack("<I", len(item)) + item
    return out


def _make_record(fields: Dict[bytes, bytes], data: bytes) -> bytes:
    h = _make_header(fields)
    return struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data


def _time_bytes(t: float) -> bytes:
    secs = int(t)
    nsecs = int(round((t - secs) * 1e9))
    if nsecs >= 1_000_000_000:
        secs, nsecs = secs + 1, nsecs - 1_000_000_000
    return struct.pack("<II", secs, nsecs)


def serialize_imu(stamp: float, acc, gyr, frame_id: str = "imu") -> bytes:
    fid = frame_id.encode()
    out = struct.pack("<III", 0, int(stamp), int(round((stamp % 1.0) * 1e9)))
    out += struct.pack("<I", len(fid)) + fid
    out += struct.pack("<4d", 0.0, 0.0, 0.0, 1.0)   # orientation xyzw
    out += struct.pack("<9d", *([0.0] * 9))
    out += struct.pack("<3d", *[float(v) for v in gyr])
    out += struct.pack("<9d", *([0.0] * 9))
    out += struct.pack("<3d", *[float(v) for v in acc])
    out += struct.pack("<9d", *([0.0] * 9))
    return out


def serialize_pointcloud2(
    stamp: float, xyz: np.ndarray, rel_time: Optional[np.ndarray] = None,
    ring: Optional[np.ndarray] = None, frame_id: str = "velodyne",
) -> bytes:
    """Serialize a PointXYZI(+time)(+ring) cloud, Velodyne-driver layout."""
    n = len(xyz)
    fields = [(b"x", 0, 7, 1), (b"y", 4, 7, 1), (b"z", 8, 7, 1),
              (b"intensity", 12, 7, 1)]
    step = 16
    if ring is not None:
        fields.append((b"ring", step, 4, 1))
        step += 2
    if rel_time is not None:
        fields.append((b"time", step, 7, 1))
        step += 4
    buf = np.zeros((n, step), np.uint8)
    buf[:, 0:12] = np.ascontiguousarray(xyz, np.float32).view(np.uint8)
    off = 16
    if ring is not None:
        buf[:, off:off + 2] = np.ascontiguousarray(
            ring, np.uint16).reshape(n, 1).view(np.uint8)
        off += 2
    if rel_time is not None:
        buf[:, off:off + 4] = np.ascontiguousarray(
            rel_time, np.float32).reshape(n, 1).view(np.uint8)

    fid = frame_id.encode()
    out = struct.pack("<III", 0, int(stamp), int(round((stamp % 1.0) * 1e9)))
    out += struct.pack("<I", len(fid)) + fid
    out += struct.pack("<II", 1, n)                 # height, width
    out += struct.pack("<I", len(fields))
    for name, f_off, dtype, count in fields:
        out += struct.pack("<I", len(name)) + name
        out += struct.pack("<IBI", f_off, dtype, count)
    out += struct.pack("<B", 0)                      # is_bigendian
    out += struct.pack("<II", step, step * n)        # point_step, row_step
    data = buf.tobytes()
    out += struct.pack("<I", len(data)) + data
    out += struct.pack("<B", 1)                      # is_dense
    return out


class BagWriter:
    """Write a standard-structure bag: header record, chunks with inline
    connection records, connection + chunk-info records at the index."""

    MSG_TYPES = {
        "sensor_msgs/PointCloud2": (
            "1158d486dd51d683ce2f1be655c3c181",
            "# abbreviated definition\n"),
        "sensor_msgs/Imu": (
            "6a62c6daae103f4ff57a132d6f95cec2",
            "# abbreviated definition\n"),
    }

    def __init__(self, path: str, compression: str = "none",
                 chunk_size: int = 768 * 1024):
        assert compression in ("none", "bz2")
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        self._compression = compression
        self._chunk_threshold = chunk_size
        self._topics: Dict[str, int] = {}
        self._conn_records: List[bytes] = []
        self._chunk_buf = b""
        self._chunk_conns: set = set()
        self._chunk_count = 0
        self._chunk_infos: List[bytes] = []
        self._chunk_t0: Optional[float] = None
        self._chunk_t1: Optional[float] = None
        # placeholder bag header; rewritten on close
        self._header_pos = self._f.tell()
        self._write_bag_header(0, 0, 0)

    def _write_bag_header(self, index_pos: int, conn_count: int,
                          chunk_count: int):
        fields = {
            b"op": bytes([OP_BAG_HEADER]),
            b"index_pos": struct.pack("<Q", index_pos),
            b"conn_count": struct.pack("<I", conn_count),
            b"chunk_count": struct.pack("<I", chunk_count),
        }
        h = _make_header(fields)
        pad = 4096 - 8 - len(h)
        rec = struct.pack("<I", len(h)) + h + struct.pack("<I", pad) + b" " * pad
        self._f.write(rec)

    def _connection_record(self, conn_id: int, topic: str, msg_type: str) -> bytes:
        md5, definition = self.MSG_TYPES.get(msg_type, ("*", ""))
        conn_header = _make_header({
            b"topic": topic.encode(),
            b"type": msg_type.encode(),
            b"md5sum": md5.encode(),
            b"message_definition": definition.encode(),
        })
        return _make_record(
            {b"op": bytes([OP_CONNECTION]),
             b"conn": struct.pack("<I", conn_id),
             b"topic": topic.encode()},
            conn_header)

    def write(self, topic: str, msg_type: str, t: float, raw: bytes):
        if topic not in self._topics:
            conn_id = len(self._topics)
            self._topics[topic] = conn_id
            self._conn_records.append(
                self._connection_record(conn_id, topic, msg_type))
        conn_id = self._topics[topic]
        if conn_id not in self._chunk_conns:
            self._chunk_buf += self._conn_records[conn_id]
            self._chunk_conns.add(conn_id)
        self._chunk_buf += _make_record(
            {b"op": bytes([OP_MSG_DATA]),
             b"conn": struct.pack("<I", conn_id),
             b"time": _time_bytes(t)},
            raw)
        self._chunk_t0 = t if self._chunk_t0 is None else min(self._chunk_t0, t)
        self._chunk_t1 = t if self._chunk_t1 is None else max(self._chunk_t1, t)
        if len(self._chunk_buf) >= self._chunk_threshold:
            self._flush_chunk()

    def _flush_chunk(self):
        if not self._chunk_buf:
            return
        payload = self._chunk_buf
        if self._compression == "bz2":
            data = bz2.compress(payload)
        else:
            data = payload
        chunk_pos = self._f.tell()
        self._f.write(_make_record(
            {b"op": bytes([OP_CHUNK]),
             b"compression": self._compression.encode(),
             b"size": struct.pack("<I", len(payload))},
            data))
        self._chunk_infos.append(_make_record(
            {b"op": bytes([OP_CHUNK_INFO]),
             b"ver": struct.pack("<I", 1),
             b"chunk_pos": struct.pack("<Q", chunk_pos),
             b"start_time": _time_bytes(self._chunk_t0 or 0.0),
             b"end_time": _time_bytes(self._chunk_t1 or 0.0),
             b"count": struct.pack("<I", len(self._chunk_conns))},
            b""))
        self._chunk_buf = b""
        self._chunk_conns = set()
        self._chunk_t0 = self._chunk_t1 = None
        self._chunk_count += 1

    def close(self):
        if self._f.closed:
            return
        self._flush_chunk()
        index_pos = self._f.tell()
        for rec in self._conn_records:
            self._f.write(rec)
        for rec in self._chunk_infos:
            self._f.write(rec)
        self._f.seek(self._header_pos)
        self._write_bag_header(index_pos, len(self._conn_records),
                               self._chunk_count)
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
