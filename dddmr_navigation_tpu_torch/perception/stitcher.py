"""The port's own copy of ``dddmr_navigation_tpu/perception/stitcher.py``
(numpy only).

Lidar scan stitching (`multilayer_spinning_lidar.cpp:177-201`,
``stitcher_num``): sparse spinning lidars accumulate the last N raw sweeps
(in the SENSOR frame, like the reference — stitching across robot motion is
accepted blur) and the concatenation feeds marking/clearing as one denser
cloud. ``stitcher_num <= 0`` is a passthrough, saving the copy.

Output shape is FIXED at ``pad_to`` points (oldest points drop first when
over budget) so the jitted perception program compiles once."""
from __future__ import annotations

from collections import deque

import numpy as np


class ScanStitcher:
    def __init__(self, stitcher_num: int = 0, pad_to: int = 8192):
        self.num = int(stitcher_num)
        self.pad_to = int(pad_to)
        self._ring: deque = deque(maxlen=max(self.num, 1))

    def push(self, pts: np.ndarray, mask: np.ndarray):
        """Add one sweep; returns the stitched (pts (pad_to,3), mask)."""
        if self.num <= 0:
            return pts, mask
        self._ring.append(np.asarray(pts[mask], np.float32))
        cat = (np.concatenate(list(self._ring)) if self._ring
               else np.zeros((0, 3), np.float32))
        if len(cat) > self.pad_to:
            cat = cat[-self.pad_to:]          # newest points win
        out = np.zeros((self.pad_to, 3), np.float32)
        out[:len(cat)] = cat
        m = np.zeros((self.pad_to,), bool)
        m[:len(cat)] = True
        return out, m

    def clear(self):
        self._ring.clear()
