"""PointCloudSet: dataset manager with train/val/test TFRecord splits
(``pointcloudprocessing_tpu/data/pointcloudset.py``, copied).

Ingests AftrBurner collects (``Lidar/frame_N.txt`` plus a
``_palindrome_state__*.log`` pose log) into ceil-based test/val/train
TFRecord splits, keeps a class and part census, and persists itself to
``pc_set.joblib``. Given the same frames and ``rand_seed`` it writes the same TFRecord
bytes as the JAX package (the one-pass C++ ingest when the native library
builds, else the threaded Python chain; both give the same bytes).

``get_*_set`` return the port's loaders (``data/loader.py``): a host-array
:class:`DeviceLoader`, or a :class:`StreamingLoader` when a split's files
exceed ``max_in_memory_bytes``. A set pickled by the JAX package names the
JAX class and is not read here; rebuild it from its collects.

The file is written with the standard library's ``pickle``, which
``joblib.load`` reads too, so the port needs no joblib.
"""

from __future__ import annotations

import os
import pickle
from typing import Callable

import numpy as np

from pointcloudprocessing_tpu_torch.data import tfrecord
from pointcloudprocessing_tpu_torch.data.frames import (
    FrameError,
    get_dir_contents,
    parse_frame_file,
    parse_state_info,
)
from pointcloudprocessing_tpu_torch.data.loader import DeviceLoader, StreamingLoader
from pointcloudprocessing_tpu_torch.ops.resample import adjust_to_input_width_np
from pointcloudprocessing_tpu_torch.utils import native


# copied from pointcloudprocessing_tpu/data/pointcloudset.py::PointCloudSet
# (the loaders are the port's; see data/loader.py)
class PointCloudSet:
    def __init__(
        self,
        name: str,
        class_labels: list[str],
        part_labels: list[str],
        network_input_width: int,
        jitter_stdev_m: np.ndarray = np.array([0, 0, 0]),
        val: float = 0.15,
        test: float = 0.10,
        batch_size: int = 32,
        rand_seed=None,
        description: str = "",
        print_func: Callable[[str], None] = print,
        data_path: str = "",
    ):
        self._description = description
        self._batch_size = batch_size
        self._name = name
        self._class_labels = {label: i for i, label in enumerate(class_labels)}
        self._class_str = {i: label for i, label in enumerate(class_labels)}
        self._part_labels = {label: i for i, label in enumerate(part_labels)}
        self._part_str = {i: label for i, label in enumerate(part_labels)}
        self._network_input_width = network_input_width
        self._jitter_stdev_m = np.asarray(jitter_stdev_m, dtype=np.float32)
        self._print = print_func
        self._data_path = data_path
        self._sets_added = 0
        self._data_size = {
            split: {"count": 0, "class_count": {}, "part_count": {}}
            for split in ("train", "val", "test")
        }

        if isinstance(rand_seed, int):
            self._random_seed = rand_seed
        else:
            self._random_seed = None
        self._rng = np.random.default_rng(self._random_seed)

        if val < 1.0 and test < 1.0 and 1.0 - (val + test) < 1.0:
            self._train_amt = 1.0 - (val + test)
            self._val_amt = val
            self._test_amt = test
        else:
            self._train_amt, self._val_amt, self._test_amt = 0.75, 0.15, 0.10
            self._print(
                "PointCloudSet:  train_val_test_split incorrect format - set to default 75% / 15% / 10%"
            )

        os.makedirs(self._set_dir, exist_ok=True)
        self.save()

    # -- paths ------------------------------------------------------------

    @property
    def _set_dir(self) -> str:
        return f"{self._data_path}{self._name}"

    @property
    def network_input_width(self) -> int:
        return self._network_input_width

    @property
    def jitter_stdev_m(self) -> np.ndarray:
        return self._jitter_stdev_m

    @property
    def batch_size(self) -> int:
        return self._batch_size

    def split_count(self, split: str) -> int:
        return self._data_size[split]["count"]

    # -- persistence ------------------------------------------------------

    def save(self) -> None:
        # __getstate__ strips the (possibly logger-bound) print_func
        with open(f"{self._set_dir}/pc_set.joblib", "wb") as jl:
            pickle.dump(self, jl)

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_print"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        if self._print is None:
            self._print = print

    # -- ingest -----------------------------------------------------------

    def add_from_aftr_output(self, dir_path: str, shuffle_points: bool = True) -> bool:
        """Parse a SensorDatumLogger collect directory.

        Layout (reference docstring, PointCloudSet.py:116-131): Lidar/ with
        frame_N.txt files plus a ``_palindrome_state__*.log`` pose log at the
        collect root.
        """
        collect_contents = get_dir_contents(dir_path, self._print)
        lidar_dir = f"{dir_path}/Lidar"
        lidar_contents = get_dir_contents(lidar_dir, self._print)

        pose_logs = [i for i in collect_contents if "_palindrome_state" in i]
        if len(pose_logs) != 1:
            raise Exception(f"No state info found in {dir_path}")
        state_info = parse_state_info(f"{dir_path}/{pose_logs[0]}")

        self._print(f"Parsing frames in {dir_path}...")

        # per-frame seed base: an unseeded dataset (rand_seed=None) draws a
        # fresh entropy base per ingest — default_rng(None) semantics —
        # while a seeded one stays deterministic; SeedSequence rejects None
        # inside a list, so the base must be resolved up front
        base_seed = self._random_seed
        if base_seed is None:
            base_seed = int(np.random.SeedSequence().entropy) & (2**63 - 1)

        set_name = dir_path.rstrip("/").split("/")[-1]
        if native.native_available():
            # one-pass C++ ingest: parse -> finite filter -> seeded
            # resample -> Example encode -> TFRecord framing in one native
            # call per frame; bytes are identical to the Python chain below
            # (including the resample draws — the native side carries a
            # numpy-parity SeedSequence+PCG64)
            self._ingest_native(
                lidar_dir, len(lidar_contents), state_info, base_seed,
                set_name, shuffle_points,
            )
            return True

        def load_frame(i: int):
            frame_path = f"{lidar_dir}/frame_{i}.txt"
            # pose lookup FIRST: a missing pose entry must skip the frame
            # before any parallel-list append (alignment invariant)
            se = state_info[i]["tanker_in_sensor_frame"][:3, :3]
            obs, cls, parts = parse_frame_file(
                frame_path, self._class_labels, self._part_labels
            )
            # per-frame generator seeded on (dataset seed, frame index):
            # deterministic AND order-independent, so the threaded ingest
            # below reproduces the same resample draws at any worker count
            frame_rng = np.random.default_rng([base_seed, i])
            obs, parts = adjust_to_input_width_np(
                obs, parts, self._network_input_width, frame_rng
            )
            return obs, cls, parts, se

        # threaded ingest: file reads and the ctypes frame scanner release
        # the GIL, so the host-side parse scales across cores (the
        # reference's pure-Python loop is its slowest stage — ~4 min per
        # 5000-frame collect, SURVEY §3.1)
        import concurrent.futures as _cf
        import os as _os

        workers = min(8, _os.cpu_count() or 1)
        observations, class_labels, part_labels, se3 = [], [], [], []
        with _cf.ThreadPoolExecutor(max_workers=workers) as pool:
            futures = [
                pool.submit(load_frame, i) for i in range(len(lidar_contents))
            ]
            for i, fut in enumerate(futures):
                frame_path = f"{lidar_dir}/frame_{i}.txt"
                try:
                    obs, cls, parts, se = fut.result()
                    if not np.isfinite(obs).all():
                        self._print(
                            f"Per-line check failed - frame_{i} discarded after detecting non-finite value."
                        )
                        continue
                    observations.append(obs)
                    class_labels.append(cls)
                    part_labels.append(parts)
                    se3.append(se)
                except (FrameError, FileNotFoundError, KeyError) as e:
                    self._print(
                        f"Failed to add file {frame_path}:\n\t{type(e).__name__} : {e}"
                    )

        self.add_data(
            set_name,
            np.array(observations, dtype=np.float32),
            np.array(class_labels, dtype=np.int64),
            np.array(part_labels, dtype=np.int64),
            np.array(se3, dtype=np.float32),
            shuffle_points,
        )
        return True

    def _ingest_native(
        self,
        lidar_dir: str,
        n_frames: int,
        state_info: dict,
        base_seed: int,
        set_name: str,
        shuffle_points: bool,
    ) -> None:
        """Whole-collect ingest through pcp_ingest_frame (one native call
        per frame), accumulating framed records + census and writing splits
        via :meth:`_add_encoded`. Output files are byte-identical to the
        Python chain (threaded-parse -> add_data)."""
        width = self._network_input_width
        class_vocab = list(self._class_labels.keys())
        part_vocab = list(self._part_labels.keys())

        def load_frame(i: int):
            frame_path = f"{lidar_dir}/frame_{i}.txt"
            se = state_info[i]["tanker_in_sensor_frame"][:3, :3]
            with open(frame_path, "rb") as f:
                raw = f.read()
            res = native.ingest_frame_native(
                raw, class_vocab, part_vocab, width, (base_seed, i), se
            )
            if res is None:
                # native call could not complete (allocation): fall back to
                # the per-frame Python chain — bytes are identical
                obs, cls, parts = parse_frame_file(
                    frame_path, self._class_labels, self._part_labels
                )
                frame_rng = np.random.default_rng([base_seed, i])
                obs, parts = adjust_to_input_width_np(obs, parts, width, frame_rng)
                record = tfrecord.frame_record(
                    tfrecord.encode_example(
                        obs, int(cls), parts, se.astype(np.float32)
                    )
                )
                hist = np.bincount(parts, minlength=len(part_vocab)).astype(
                    np.int64
                )
                return record, int(cls), hist
            status, record, cls_id, hist = res
            if status:
                raise FrameError(native.INGEST_STATUS_MESSAGES[status])
            return record, cls_id, hist

        records: list = []
        class_ids: list[int] = []
        part_hists: list[np.ndarray] = []

        def consume(i: int, result_or_exc) -> None:
            frame_path = f"{lidar_dir}/frame_{i}.txt"
            if isinstance(result_or_exc, Exception):
                e = result_or_exc
                self._print(
                    f"Failed to add file {frame_path}:\n\t{type(e).__name__} : {e}"
                )
                return
            record, cls_id, hist = result_or_exc
            records.append(record)
            class_ids.append(cls_id)
            part_hists.append(hist)

        def guarded(i: int):
            try:
                return load_frame(i)
            except (FrameError, FileNotFoundError, KeyError) as e:
                return e

        # chunked batch calls: one native call reads + ingests a few hundred
        # frames (per-frame Python overhead was ~1/3 of the warm loop);
        # frames the batch flags are replayed through the per-frame path so
        # error messages and exception semantics stay exact
        CHUNK = 256
        for start in range(0, n_frames, CHUNK):
            idxs = list(range(start, min(start + CHUNK, n_frames)))
            pose_ok = np.array(
                [i in state_info for i in idxs], dtype=np.uint8
            )
            se3s = np.zeros((len(idxs), 9), np.float32)
            for k, i in enumerate(idxs):
                if pose_ok[k]:
                    se3s[k] = (
                        state_info[i]["tanker_in_sensor_frame"][:3, :3]
                        .astype(np.float32)
                        .ravel()
                    )
            batch = native.ingest_frames_native(
                [f"{lidar_dir}/frame_{i}.txt" for i in idxs],
                class_vocab,
                part_vocab,
                width,
                base_seed,
                start,
                pose_ok,
                se3s,
            )
            if batch is None:
                for i in idxs:
                    consume(i, guarded(i))
                continue
            arena, offsets, cids, hists, statuses = batch
            for k, i in enumerate(idxs):
                if statuses[k] == 0:
                    records.append(arena[int(offsets[k]) : int(offsets[k + 1])])
                    class_ids.append(int(cids[k]))
                    part_hists.append(hists[k])
                else:
                    consume(i, guarded(i))

        self._add_encoded(
            set_name,
            records,
            np.asarray(class_ids, dtype=np.int64),
            part_hists,
            shuffle_points,
        )

    def _split_bounds(self, num: int) -> dict:
        """Ceil-based test/val/train boundaries in that order
        (PointCloudSet.py:245-247) — the ONE definition shared by both
        writers (add_data and the native-ingest _add_encoded), so the split
        rule cannot drift between the Python and native dataset paths."""
        n_test = int(np.ceil(num * self._test_amt))
        n_val = int(np.ceil(num * self._val_amt))
        return {
            "test": (0, min(n_test, num)),
            "val": (min(n_test, num), min(n_test + n_val, num)),
            "train": (min(n_test + n_val, num), num),
        }

    def _census_record(self, census: dict, class_id: int, part_counts) -> None:
        """One record's census bookkeeping (shared by both writers).
        ``part_counts``: iterable of (label, count); zero counts still
        create the label key (reference census format)."""
        cls_name = self._class_str[int(class_id)]
        census["class_count"][cls_name] = (
            census["class_count"].get(cls_name, 0) + 1
        )
        for lbl, cnt in part_counts:
            census["part_count"][lbl] = census["part_count"].get(lbl, 0) + int(cnt)
        census["count"] += 1

    def _add_encoded(
        self,
        set_name: str,
        records: list[bytes],
        class_ids: np.ndarray,
        part_hists: list[np.ndarray],
        shuffle_points: bool = True,
    ) -> None:
        """Split pre-framed TFRecord records into test/val/train files —
        same shuffle draw, split boundaries, census bookkeeping, and output
        bytes as :meth:`add_data`, without re-encoding."""
        num = len(records)
        order = np.arange(num)
        if shuffle_points and num:
            order = self._rng.permutation(num)

        splits = self._split_bounds(num)

        os.makedirs(f"{self._set_dir}/{set_name}", exist_ok=True)

        part_names = list(self._part_labels.keys())
        for split, (start, end) in splits.items():
            path = f"{self._set_dir}/{set_name}/{split}_{self._sets_added}.tfrecord"
            census = self._data_size[split]
            with open(path, "wb") as f:
                for i in range(start, end):
                    j = int(order[i])
                    hist = part_hists[j]
                    self._census_record(
                        census,
                        class_ids[j],
                        ((lbl, hist[k]) for k, lbl in enumerate(part_names)),
                    )
                    f.write(records[j])

        self._sets_added += 1
        self.save()

    def add_data(
        self,
        set_name: str,
        observations: np.ndarray,
        class_labels: np.ndarray,
        part_labels: np.ndarray,
        se3: np.ndarray,
        shuffle_points: bool = True,
    ) -> None:
        """Split new samples into test/val/train TFRecords (ceil-based split
        boundaries in test, val, train order — PointCloudSet.py:245-247)."""
        num = observations.shape[0]
        if shuffle_points and num:
            indices = self._rng.permutation(num)
            observations = observations[indices]
            class_labels = class_labels[indices]
            part_labels = part_labels[indices]
            se3 = se3[indices]

        splits = self._split_bounds(num)

        os.makedirs(f"{self._set_dir}/{set_name}", exist_ok=True)

        for split, (start, end) in splits.items():
            path = f"{self._set_dir}/{set_name}/{split}_{self._sets_added}.tfrecord"
            with tfrecord.TFRecordWriter(path) as writer:
                for i in range(start, end):
                    self._census_record(
                        self._data_size[split],
                        class_labels[i],
                        (
                            (lbl, np.count_nonzero(part_labels[i] == lbl_idx))
                            for lbl, lbl_idx in self._part_labels.items()
                        ),
                    )
                    writer.write(
                        tfrecord.encode_example(
                            observations[i], int(class_labels[i]), part_labels[i], se3[i]
                        )
                    )

        self._sets_added += 1
        self.save()

    # -- read path --------------------------------------------------------

    def _split_files(self, split: str) -> list[str]:
        import glob

        return sorted(glob.glob(f"{self._set_dir}/*/{split}_*.tfrecord"))

    def load_split_arrays(self, split: str) -> dict[str, np.ndarray]:
        """Decode a whole split into dense arrays (observations (m, n, 3),
        class_label (m,), part_labels (m, n), se3 (m, 3, 3)). Uses the C++
        record reader when available (~30x the Python decoder)."""
        width = self._network_input_width
        # per-file dense chunks, concatenated once (no per-record Python lists)
        obs_chunks, cls_chunks, part_chunks, se3_chunks = [], [], [], []
        for path in self._split_files(split):
            # a record is at least ~13 bytes/point (12B float xyz + 1B label)
            cap = os.path.getsize(path) // max(width * 12, 1) + 8
            native_arrays = native.read_tfrecord_file_native(path, width, cap)
            if native_arrays is not None:
                f_obs, f_cls, f_parts, f_se3 = native_arrays
            else:
                obs, cls, parts, se3 = [], [], [], []
                for record in tfrecord.read_tfrecord_file(path):
                    ex = tfrecord.decode_example(record)
                    obs.append(ex["observations"].reshape(width, 3))
                    cls.append(int(ex["class_label"][0]))
                    parts.append(ex["part_labels"])
                    se3.append(ex["se3"].reshape(3, 3))
                if not obs:
                    continue
                f_obs = np.stack(obs)
                f_cls = np.asarray(cls, dtype=np.int64)
                f_parts = np.stack(parts)
                f_se3 = np.stack(se3)
            obs_chunks.append(f_obs)
            cls_chunks.append(f_cls)
            part_chunks.append(f_parts)
            se3_chunks.append(f_se3)

        if not obs_chunks:
            return {
                "observations": np.zeros((0, width, 3), np.float32),
                "class_label": np.zeros((0,), np.int32),
                "part_labels": np.zeros((0, width), np.int32),
                "se3": np.zeros((0, 3, 3), np.float32),
            }
        return {
            "observations": np.concatenate(obs_chunks),
            "class_label": np.concatenate(cls_chunks).astype(np.int32),
            "part_labels": np.concatenate(part_chunks).astype(np.int32),
            "se3": np.concatenate(se3_chunks),
        }

    # splits whose TFRecords exceed this are streamed (windowed shuffle,
    # bounded RSS) instead of decoded into RAM; override per instance
    max_in_memory_bytes: int = 4 << 30

    def _split_bytes(self, split: str) -> int:
        return sum(os.path.getsize(p) for p in self._split_files(split))

    def _make_loader(self, split: str, streaming: bool | None):
        if self.split_count(split) > 0 and not self._split_files(split):
            # the census says records exist but the TFRecords are not where
            # _set_dir points. Classic cause: the set pickles a RELATIVE
            # data path (reference parity, PointCloudSet.py:111-114) and was
            # reloaded from a different working directory — without this
            # guard the trainer would silently run zero-batch epochs with
            # loss 0.0.
            raise FileNotFoundError(
                f"PointCloudSet split '{split}' has "
                f"{self.split_count(split)} records in its census but no "
                f"{split}_*.tfrecord files under '{self._set_dir}' "
                f"(cwd: {os.getcwd()}). The set stores a relative data "
                "path — run from the directory it was built in, or "
                "rebuild with an absolute data_path."
            )
        if streaming is None:
            streaming = self._split_bytes(split) > getattr(
                self, "max_in_memory_bytes", PointCloudSet.max_in_memory_bytes
            )
        if streaming:
            return StreamingLoader(
                self._split_files(split),
                width=self._network_input_width,
                batch_size=self._batch_size,
                count=self.split_count(split),
                seed=self._random_seed,
            )
        return DeviceLoader(
            self.load_split_arrays(split),
            batch_size=self._batch_size,
            shuffle=True,
            seed=self._random_seed,
        )

    def get_train_set(self, streaming: bool | None = None):
        """Loader for the train split. ``streaming=None`` auto-selects the
        out-of-core StreamingLoader when the split exceeds
        ``max_in_memory_bytes`` (reference analogue: the tf.data pipeline
        never materializes a split, PointCloudSet.py:347-363)."""
        return self._make_loader("train", streaming)

    def get_val_set(self, streaming: bool | None = None):
        return self._make_loader("val", streaming)

    def get_test_set(self, streaming: bool | None = None):
        return self._make_loader("test", streaming)

    # -- reports ----------------------------------------------------------

    def get_description(self) -> str:
        return self._description

    def get_info(self) -> str:
        """Split/class/part census report; same layout as the reference's
        get_info (PointCloudSet.py:396-441)."""
        out = f"{self._description}\n"
        out += (
            f"Random seed: {self._random_seed}\n"
            if isinstance(self._random_seed, int)
            else "Is not seeded\n"
        )
        out += f"Class labels: {self._class_labels.keys()}\n"
        out += f"Part labels: {self._part_labels.keys()}\n"

        total = sum(self._data_size[s]["count"] for s in ("train", "val", "test"))
        titles = {"train": "Train Set", "val": "Validation Set", "test": "Test Set"}
        amounts = {"train": self._train_amt, "val": self._val_amt, "test": self._test_amt}
        for split in ("train", "val", "test"):
            size = self._data_size[split]
            out += f"\n--- {titles[split]} ---\n"
            out += f"Specified proportion:  {amounts[split]}\n"
            out += f"Actual proportion: {size['count'] / total if total else 0}\n"
            out += f"Total count: {size['count']}\n"
            out += "Class count:\n"
            for label in self._class_labels:
                if label in size["class_count"]:
                    out += f"\t{label}: {size['class_count'][label]}\n"
            out += "Part count:\n"
            for label in self._part_labels:
                if label in size["part_count"]:
                    out += f"\t{label}: {size['part_count'][label]}\n"
        return out


# copied from pointcloudprocessing_tpu/data/pointcloudset.py::load_from_file
def load_from_file(joblib_file: str) -> PointCloudSet:
    """Load a pickled PointCloudSet (reference: PointCloudSet.py:512-521).

    A set that the JAX package pickled names the JAX class; unpickling it
    would import that package, so the unpickler refuses any class of it
    before it is imported (rebuild such a set from its collects with the
    port)."""
    with open(joblib_file, "rb") as pf:
        return _PortUnpickler(pf, joblib_file).load()


class _PortUnpickler(pickle.Unpickler):
    """Refuses the classes of the JAX package (and joblib's array wrapper,
    which only a JAX-written file holds) by their module."""

    def __init__(self, file, path: str):
        super().__init__(file)
        self._path = path

    def find_class(self, module: str, name: str):
        if module.split(".")[0] in ("pointcloudprocessing_tpu", "joblib"):
            raise ValueError(
                f"{self._path} was written by the JAX package's PointCloudSet "
                f"({module}.{name}); remove its directory and ingest the "
                "collects again with the port"
            )
        return super().find_class(module, name)
