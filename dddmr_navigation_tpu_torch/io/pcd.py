"""Minimal PCD (Point Cloud Data) reader/writer.

The port's own copy of ``dddmr_navigation_tpu/io/pcd.py``, whole
(numpy only): ``lzf_decompress``, ``lzf_compress``, ``read_pcd``,
``write_pcd``.

Supports the subset the reference stack produces/consumes (PCL `pcd` v0.7:
ascii and binary encodings, xyz / xyzi float fields) so that maps and pose
graphs saved by the reference's pcdSaver (`mapOptimization.h:91`) can be
loaded directly. Pure NumPy on the host — point clouds enter device memory
as padded tensors downstream.
"""
from __future__ import annotations

import struct

import numpy as np


# ---------------------------------------------------------------------------
# LZF (libLZF) codec — PCL's binary_compressed encoding. Pure Python: maps
# load once at startup, so the byte loop is acceptable and keeps the reader
# dependency-free (the `lzf` wheel is not in the image).
# ---------------------------------------------------------------------------

def lzf_decompress(data: bytes, expected_size: int) -> bytes:
    """Decompress a libLZF stream (the format `pcl::lzfDecompress` reads)."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        ctrl = data[i]
        i += 1
        if ctrl < 32:                      # literal run of ctrl+1 bytes
            run = ctrl + 1
            out += data[i:i + run]
            i += run
        else:                              # back-reference
            length = ctrl >> 5
            if length == 7:
                length += data[i]
                i += 1
            ref = len(out) - ((ctrl & 0x1F) << 8) - data[i] - 1
            i += 1
            for _ in range(length + 2):    # may overlap: copy byte-wise
                out.append(out[ref])
                ref += 1
    if len(out) != expected_size:
        raise ValueError(
            f"LZF stream decompressed to {len(out)} bytes, "
            f"header promised {expected_size}")
    return bytes(out)


def lzf_compress(data: bytes) -> bytes:
    """Greedy hash-table LZF compressor (`pcl::lzfCompress`-compatible
    output; any conformant decompressor reads it)."""
    out = bytearray()
    i, n = 0, len(data)
    table = {}
    lit_start = 0

    def flush_literals(end):
        j = lit_start
        while j < end:
            run = min(32, end - j)
            out.append(run - 1)
            out.extend(data[j:j + run])
            j += run

    while i < n - 2:
        key = data[i:i + 3]
        ref = table.get(key, -1)
        table[key] = i
        off = i - ref - 1
        if ref >= 0 and off < 8192:
            # extend the match
            length = 3
            maxlen = min(n - i, 264)
            while length < maxlen and data[ref + length] == data[i + length]:
                length += 1
            flush_literals(i)
            l_enc = length - 2
            if l_enc < 7:
                out.append((l_enc << 5) | (off >> 8))
            else:
                out.append((7 << 5) | (off >> 8))
                out.append(l_enc - 7)
            out.append(off & 0xFF)
            i += length
            lit_start = i
        else:
            i += 1
    flush_literals(n)
    return bytes(out)


def read_pcd(path: str) -> np.ndarray:
    """Read a PCD file, returning an (N, F) float32 array with columns in
    header FIELDS order (typically x, y, z[, intensity])."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if line.startswith("#") or not line:
                continue
            key, _, value = line.partition(" ")
            header[key] = value
            if key == "DATA":
                break
        fields = header.get("FIELDS", "x y z").split()
        sizes = [int(s) for s in header.get("SIZE", "4 4 4").split()]
        types = header.get("TYPE", "F F F").split()
        counts = [int(c) for c in header.get("COUNT", " ".join(["1"] * len(fields))).split()]
        n_points = int(header.get("POINTS", header.get("WIDTH", "0")))
        data_kind = header["DATA"]

        np_types = []
        for t, s in zip(types, sizes):
            np_types.append({"F": f"f{s}", "I": f"i{s}", "U": f"u{s}"}[t])

        if n_points == 0:        # empty cloud (e.g. a featureless keyframe)
            width = int(sum(counts))
            return np.zeros((0, width), np.float32)

        if data_kind == "ascii":
            raw = np.loadtxt(f, dtype=np.float64, max_rows=n_points)
            raw = np.atleast_2d(raw)
            return raw.astype(np.float32)
        elif data_kind == "binary":
            dtype = np.dtype({
                "names": [f"f{i}" for i in range(len(fields))],
                "formats": [f"{c}{t}" if c > 1 else t for c, t in zip(counts, np_types)],
            })
            buf = f.read(dtype.itemsize * n_points)
            rec = np.frombuffer(buf, dtype=dtype, count=n_points)
            cols = [rec[f"f{i}"].reshape(n_points, -1).astype(np.float32)
                    for i in range(len(fields))]
            return np.concatenate(cols, axis=1)
        elif data_kind == "binary_compressed":
            # PCL layout: u32 compressed size, u32 uncompressed size, LZF
            # blob of the SOA (field-major) point data
            comp_size, uncomp_size = struct.unpack("<II", f.read(8))
            raw = lzf_decompress(f.read(comp_size), uncomp_size)
            cols = []
            off = 0
            for c, t, sz in zip(counts, np_types, sizes):
                nbytes = n_points * c * sz
                arr = np.frombuffer(raw, dtype=t, count=n_points * c,
                                    offset=off).reshape(n_points, c)
                cols.append(arr.astype(np.float32))
                off += nbytes
            return np.concatenate(cols, axis=1)
        else:
            raise ValueError(f"unknown PCD DATA kind: {data_kind}")


def write_pcd(path: str, points: np.ndarray, fields=("x", "y", "z"),
              binary: bool = True, compressed: bool = False) -> None:
    """Write an (N, F) array as PCD v0.7 (float32 fields). ``compressed``
    emits PCL's binary_compressed (LZF over field-major data)."""
    points = np.asarray(points, dtype=np.float32)
    n, f_count = points.shape
    assert f_count == len(fields)
    kind = "binary_compressed" if compressed else (
        "binary" if binary else "ascii")
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {' '.join(fields)}\n"
        f"SIZE {' '.join(['4'] * f_count)}\n"
        f"TYPE {' '.join(['F'] * f_count)}\n"
        f"COUNT {' '.join(['1'] * f_count)}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        f"DATA {kind}\n"
    )
    with open(path, "wb") as fh:
        fh.write(header.encode("ascii"))
        if compressed:
            soa = np.ascontiguousarray(points.T).tobytes()   # field-major
            blob = lzf_compress(soa)
            fh.write(struct.pack("<II", len(blob), len(soa)))
            fh.write(blob)
        elif binary:
            fh.write(np.ascontiguousarray(points).tobytes())
        else:
            np.savetxt(fh, points, fmt="%.6f")
