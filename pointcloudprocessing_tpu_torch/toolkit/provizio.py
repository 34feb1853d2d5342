"""Provizio radar MCAP reader (``pointcloudprocessing_tpu/toolkit/provizio.py``;
API parity: utils/Provizio.py:6-146).

``ROS`` maps ROS2 PointField datatypes to numpy dtypes with endianness
(:11-75); ``Provizio.parse_mcap`` iterates decoded messages on the radar
topic and builds the per-sequence frame dict with a zero-copy structured
``np.frombuffer`` view (:84-124); ``to_aftr_frame`` writes the AftrBurner
text format (:126-146, shared with data.frames.write_aftr_frame).

The mcap/mcap-ros2 dependency is optional: constructing ``Provizio`` works
without it; ``parse_mcap`` reports a clear advisory instead of crashing.
"""

from __future__ import annotations

from collections import deque
from datetime import datetime, timezone
from typing import Callable

import os

import numpy as np

from pointcloudprocessing_tpu_torch.data.frames import write_aftr_frame
from pointcloudprocessing_tpu_torch.toolkit.tqdm_capture import TQDMCapture


# copied from pointcloudprocessing_tpu/toolkit/provizio.py::ROS
class ROS:
    def __init__(self, print_func: Callable[[str], None] = print):
        self._print = print_func
        # ROS2 sensor_msgs/PointField datatype codes -> numpy dtype letters
        self._datatypes = {
            "PointField": {
                1: {"dtype": np.int8, "bytes": 1, "le": "<i1", "be": ">i1"},
                2: {"dtype": np.uint8, "bytes": 1, "le": "<u1", "be": ">u1"},
                3: {"dtype": np.int16, "bytes": 2, "le": "<i2", "be": ">i2"},
                4: {"dtype": np.uint16, "bytes": 2, "le": "<u2", "be": ">u2"},
                5: {"dtype": np.int32, "bytes": 4, "le": "<i4", "be": ">i4"},
                6: {"dtype": np.uint32, "bytes": 4, "le": "<u4", "be": ">u4"},
                7: {"dtype": np.float32, "bytes": 4, "le": "<f4", "be": ">f4"},
                8: {"dtype": np.float64, "bytes": 8, "le": "<f8", "be": ">f8"},
            }
        }

    def create_np_dtype_from(self, ros2_fields: list, is_bigendian: bool) -> np.dtype:
        """Structured dtype ordered by field offset (multi-count fields are
        not supported — same restriction as the reference, :70)."""
        dtype_unordered = {}
        for field in ros2_fields:
            if "PointField" in str(field) or hasattr(field, "datatype"):
                if getattr(field, "count", 1) != 1:
                    raise ValueError(
                        "Error in PointField parsing - multiple values not currently handled."
                    )
                dtype_unordered[field.offset] = (
                    field.name,
                    self._datatypes["PointField"][int(field.datatype)][
                        "be" if is_bigendian else "le"
                    ],
                )
        ordered = [dtype_unordered[key] for key in sorted(dtype_unordered)]
        return np.dtype(ordered)


# copied from pointcloudprocessing_tpu/toolkit/provizio.py::Provizio
class Provizio:
    def __init__(
        self,
        topics: list[str] | None = None,
        print_func: Callable[[str], None] = print,
    ):
        self._print = print_func
        self._topics = topics if topics is not None else ["rt/provizio_radar_point_cloud"]
        self._ROS = ROS(print_func)

    def parse_mcap(self, path: str, progress_capture: TQDMCapture | None = None) -> dict:
        try:
            from mcap.reader import make_reader
            from mcap_ros2.decoder import DecoderFactory
            from tqdm import tqdm
        except ImportError:
            self._print(
                "Provizio:  mcap / mcap-ros2 are not installed — "
                "install them to parse MCAP radar logs."
            )
            return {}

        if not os.path.isfile(path):
            self._print(f"File {path} does not exist.")
            return {}

        frames: dict = {}
        with open(path, "rb") as f:
            reader = make_reader(f, decoder_factories=[DecoderFactory()])
            try:
                for schema, channel, message, ros_msg in tqdm(
                    reader.iter_decoded_messages(topics=self._topics),
                    file=progress_capture,
                ):
                    msg = {k: getattr(ros_msg, k) for k in ros_msg.__slots__}
                    dtype = self._ROS.create_np_dtype_from(
                        msg["fields"], msg["is_bigendian"]
                    )
                    frames[message.sequence] = {
                        "name": schema.name,
                        "encoding": schema.encoding,
                        "topic": channel.topic,
                        "metadata": channel.metadata,
                        "channel_id": channel.id,
                        "log_time": datetime.fromtimestamp(
                            message.log_time / 1e9, tz=timezone.utc
                        ),
                        "publish_time": datetime.fromtimestamp(
                            message.publish_time / 1e9, tz=timezone.utc
                        ),
                        "sequence": message.sequence,
                        "height": msg["height"],
                        "width": msg["width"],
                        "point_step": msg["point_step"],
                        "row_step": msg["row_step"],
                        "is_dense": msg["is_dense"],
                        "is_bigendian": msg["is_bigendian"],
                        "fields": deque([field.name for field in msg["fields"]]),
                        "data": np.frombuffer(msg["data"], dtype),
                        "dtype": dtype,
                    }
            except Exception as e:
                self._print(f"Unable to parse MCAP data -> {type(e)}: {e}")
        return frames

    def to_aftr_frame(
        self, path: str, points: np.ndarray, labels: np.ndarray = np.array([])
    ) -> None:
        write_aftr_frame(path, points, labels, self._print)
