"""Host-side data handling of the port: AftrBurner frames and pose logs,
the TFRecord codec, ``PointCloudSet`` and the batch loaders."""

from pointcloudprocessing_tpu_torch.data.tfrecord import (
    TFRecordWriter,
    read_tfrecord_file,
    encode_example,
    decode_example,
)
from pointcloudprocessing_tpu_torch.data.frames import (
    parse_frame_text,
    parse_frame_file,
    parse_state_info,
    write_aftr_frame,
    get_dir_contents,
)
from pointcloudprocessing_tpu_torch.data.pointcloudset import (
    PointCloudSet,
    load_from_file,
)
from pointcloudprocessing_tpu_torch.data.loader import DeviceLoader

__all__ = [
    "TFRecordWriter",
    "read_tfrecord_file",
    "encode_example",
    "decode_example",
    "parse_frame_text",
    "parse_frame_file",
    "parse_state_info",
    "write_aftr_frame",
    "get_dir_contents",
    "PointCloudSet",
    "load_from_file",
    "DeviceLoader",
]
