"""rosbag2 (sqlite3 storage) reader + minimal CDR deserialization.

The reference consumes recorded data through `lego_loam_bag_node`
(`lego_loam_bor/src/lego_loam_bag_node.cpp`: paced rosbag2 playback) and
ships a real bag for the odom_3d demo
(`src/dddmr_odom_3d/bag_files/rosbag2_odom2d_imu/`). This module reads
that on-disk format directly — a rosbag2 directory is a sqlite3 database
(`topics` + `messages` tables) of CDR-encoded ROS 2 messages — with a
hand-rolled XCDR1 decoder for the message types the stack needs:

  * nav_msgs/msg/Odometry
  * sensor_msgs/msg/Imu
  * sensor_msgs/msg/PointCloud2 (x/y/z[/intensity] float32 fields)

Pure stdlib (sqlite3, struct) + NumPy; no ROS installation required.

The port's own copy of ``dddmr_navigation_tpu/io/rosbag.py`` (the standard
library and numpy); ``tests/test_torch_runtime_io.py`` holds it to the
original.
"""
from __future__ import annotations

import os
import sqlite3
import struct
from typing import Iterator, Optional

import numpy as np


class CdrReader:
    """Cursor over one CDR payload (XCDR1). Alignment is relative to the
    byte after the 4-byte encapsulation header; supports both little- and
    big-endian encapsulations (LE is what ROS 2 writes in practice)."""

    def __init__(self, buf: bytes):
        if len(buf) < 4:
            raise ValueError("CDR payload too short")
        # encapsulation: {0x00,0x00}=BE, {0x00,0x01}=LE (+2 options bytes)
        self.le = buf[1] & 0x01 == 1
        self.buf = buf
        self.off = 4

    def _align(self, n: int):
        rel = self.off - 4
        pad = (-rel) % n
        self.off += pad

    def _unpack(self, fmt_char: str, size: int):
        self._align(size)
        fmt = ("<" if self.le else ">") + fmt_char
        (v,) = struct.unpack_from(fmt, self.buf, self.off)
        self.off += size
        return v

    def uint8(self):
        v = self.buf[self.off]
        self.off += 1
        return v

    def int32(self):
        return self._unpack("i", 4)

    def uint32(self):
        return self._unpack("I", 4)

    def float32(self):
        return self._unpack("f", 4)

    def float64(self):
        return self._unpack("d", 8)

    def string(self) -> str:
        n = self.uint32()           # length INCLUDING the trailing NUL
        raw = self.buf[self.off:self.off + n]
        self.off += n
        return raw.rstrip(b"\x00").decode("utf-8", errors="replace")

    def float64_array(self, n: int) -> np.ndarray:
        self._align(8)
        out = np.frombuffer(self.buf, dtype="<f8" if self.le else ">f8",
                            count=n, offset=self.off)
        self.off += 8 * n
        return out

    def bytes_seq(self) -> bytes:
        n = self.uint32()
        raw = self.buf[self.off:self.off + n]
        self.off += n
        return raw

    # -- common compound fields ------------------------------------------
    def header(self):
        sec = self.int32()
        nsec = self.uint32()
        frame = self.string()
        return sec + nsec * 1e-9, frame

    def vector3(self):
        return np.array([self.float64(), self.float64(), self.float64()])

    def quaternion(self):
        return np.array([self.float64(), self.float64(), self.float64(),
                         self.float64()])


def parse_odometry(buf: bytes) -> dict:
    """nav_msgs/msg/Odometry."""
    r = CdrReader(buf)
    stamp, frame = r.header()
    child = r.string()
    pos = r.vector3()
    quat = r.quaternion()
    pose_cov = r.float64_array(36)
    lin = r.vector3()
    ang = r.vector3()
    twist_cov = r.float64_array(36)
    return {"stamp": stamp, "frame_id": frame, "child_frame_id": child,
            "position": pos, "orientation": quat, "pose_cov": pose_cov,
            "linear": lin, "angular": ang, "twist_cov": twist_cov}


def parse_imu(buf: bytes) -> dict:
    """sensor_msgs/msg/Imu."""
    r = CdrReader(buf)
    stamp, frame = r.header()
    quat = r.quaternion()
    ori_cov = r.float64_array(9)
    ang = r.vector3()
    ang_cov = r.float64_array(9)
    acc = r.vector3()
    acc_cov = r.float64_array(9)
    return {"stamp": stamp, "frame_id": frame, "orientation": quat,
            "orientation_cov": ori_cov, "angular_velocity": ang,
            "linear_acceleration": acc}


def parse_pointcloud2(buf: bytes) -> dict:
    """sensor_msgs/msg/PointCloud2 → (N, F) float32 of x/y/z[/intensity]."""
    r = CdrReader(buf)
    stamp, frame = r.header()
    height = r.uint32()
    width = r.uint32()
    n_fields = r.uint32()
    fields = []
    for _ in range(n_fields):
        name = r.string()
        offset = r.uint32()
        datatype = r.uint8()
        count = r.uint32()
        fields.append((name, offset, datatype, count))
    is_bigendian = r.uint8() != 0
    point_step = r.uint32()
    row_step = r.uint32()
    data = r.bytes_seq()
    n = height * width
    out_cols = []
    names = []
    dt = np.dtype(">f4" if is_bigendian else "<f4")
    arr = np.frombuffer(data, dtype=np.uint8)[:n * point_step]
    arr = arr.reshape(n, point_step)
    for (name, off, datatype, count) in fields:
        if name in ("x", "y", "z", "intensity") and datatype == 7:  # FLOAT32
            col = arr[:, off:off + 4].copy().view(dt)[:, 0]
            out_cols.append(col.astype(np.float32))
            names.append(name)
    pts = (np.stack(out_cols, axis=1) if out_cols
           else np.zeros((0, 0), np.float32))
    return {"stamp": stamp, "frame_id": frame, "points": pts,
            "field_names": names, "height": height, "width": width}


_PARSERS = {
    "nav_msgs/msg/Odometry": parse_odometry,
    "sensor_msgs/msg/Imu": parse_imu,
    "sensor_msgs/msg/PointCloud2": parse_pointcloud2,
}


class BagReader:
    """Open a rosbag2 directory (or .db3 file) and iterate messages."""

    def __init__(self, path: str):
        if os.path.isdir(path):
            db3 = [f for f in sorted(os.listdir(path)) if f.endswith(".db3")]
            if not db3:
                raise FileNotFoundError(f"no .db3 files under {path}")
            path = os.path.join(path, db3[0])
        self.db = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
        rows = self.db.execute("SELECT id, name, type FROM topics").fetchall()
        self.topics = {name: {"id": tid, "type": typ}
                       for tid, name, typ in rows}
        self._by_id = {v["id"]: (k, v["type"]) for k, v in self.topics.items()}

    def count(self, topic: Optional[str] = None) -> int:
        if topic is None:
            return self.db.execute(
                "SELECT COUNT(*) FROM messages").fetchone()[0]
        tid = self.topics[topic]["id"]
        return self.db.execute(
            "SELECT COUNT(*) FROM messages WHERE topic_id=?",
            (tid,)).fetchone()[0]

    def raw_messages(self, topic: Optional[str] = None
                     ) -> Iterator[tuple[int, str, bytes]]:
        """Yields (timestamp_ns, topic_name, raw_cdr) in time order."""
        if topic is None:
            q = self.db.execute(
                "SELECT timestamp, topic_id, data FROM messages "
                "ORDER BY timestamp")
            for ts, tid, data in q:
                name, _ = self._by_id[tid]
                yield ts, name, data
        else:
            tid = self.topics[topic]["id"]
            q = self.db.execute(
                "SELECT timestamp, data FROM messages WHERE topic_id=? "
                "ORDER BY timestamp", (tid,))
            for ts, data in q:
                yield ts, topic, data

    def messages(self, topic: Optional[str] = None) -> Iterator[tuple]:
        """Yields (timestamp_ns, topic_name, parsed_dict); topics without a
        registered parser are skipped."""
        for ts, name, data in self.raw_messages(topic):
            typ = self.topics[name]["type"]
            parser = _PARSERS.get(typ)
            if parser is not None:
                yield ts, name, parser(data)

    def close(self):
        self.db.close()
