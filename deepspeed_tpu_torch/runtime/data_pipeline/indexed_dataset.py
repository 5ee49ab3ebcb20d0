"""Binary indexed dataset — Megatron ``MMapIndexedDataset`` compatible (copy
of deepspeed_tpu/runtime/data_pipeline/indexed_dataset.py for the PyTorch
port: the same on-disk format, so a file either package writes, the other
reads).

Reference analog: ``runtime/data_pipeline/data_sampling/indexed_dataset.py``
(617 LoC, vendored Megatron format): token sequences stored contiguously in
a ``.bin`` file, with a ``.idx`` sidecar holding dtype, per-sequence sizes,
byte pointers, and document boundaries.  Binary compatibility means corpora
tokenized by Megatron/DeepSpeed tooling load directly.

Format (.idx): magic ``MMIDIDX\\x00\\x00`` | uint64 version=1 | uint8 dtype
code | int64 num_sequences | int64 num_documents | int32 sizes[num_seq] |
int64 pointers[num_seq] | int64 doc_idx[num_docs].
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional, Sequence

import numpy as np

_MAGIC = b"MMIDIDX\x00\x00"
_VERSION = 1

_DTYPES = {1: np.uint8, 2: np.int8, 3: np.int16, 4: np.int32, 5: np.int64,
           6: np.float64, 7: np.float32, 8: np.uint16}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def data_file_path(prefix: str) -> str:
    return prefix + ".bin"


def index_file_path(prefix: str) -> str:
    return prefix + ".idx"


class MMapIndexedDatasetBuilder:
    def __init__(self, out_prefix: str, dtype=np.int32):
        self._prefix = out_prefix
        self._dtype = np.dtype(dtype)
        assert self._dtype in _DTYPE_CODES, f"unsupported dtype {dtype}"
        self._bin = open(data_file_path(out_prefix), "wb")
        self._sizes: List[int] = []
        self._doc_idx: List[int] = [0]

    def add_item(self, tokens: Sequence[int]) -> None:
        arr = np.asarray(tokens, dtype=self._dtype)
        self._bin.write(arr.tobytes(order="C"))
        self._sizes.append(arr.size)

    def end_document(self) -> None:
        self._doc_idx.append(len(self._sizes))

    def finalize(self) -> None:
        self._bin.close()
        if self._doc_idx[-1] != len(self._sizes):
            self._doc_idx.append(len(self._sizes))
        sizes = np.asarray(self._sizes, np.int32)
        itemsize = self._dtype.itemsize
        pointers = np.zeros(len(sizes), np.int64)
        # accumulate in int64: int32 math wraps past 2 GiB of token data
        np.cumsum(sizes[:-1].astype(np.int64) * itemsize, out=pointers[1:])
        with open(index_file_path(self._prefix), "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<Q", _VERSION))
            f.write(struct.pack("<B", _DTYPE_CODES[self._dtype]))
            f.write(struct.pack("<q", len(sizes)))
            f.write(struct.pack("<q", len(self._doc_idx)))
            f.write(sizes.tobytes(order="C"))
            f.write(pointers.tobytes(order="C"))
            f.write(np.asarray(self._doc_idx, np.int64).tobytes(order="C"))


class MMapIndexedDataset:
    """Zero-copy reads via np.memmap (reference MMapIndexedDataset)."""

    def __init__(self, prefix: str):
        idx_path = index_file_path(prefix)
        with open(idx_path, "rb") as f:
            magic = f.read(len(_MAGIC))
            if magic != _MAGIC:
                raise ValueError(f"{idx_path}: bad magic {magic!r} — not an "
                                 f"MMapIndexedDataset index")
            version, = struct.unpack("<Q", f.read(8))
            if version != _VERSION:
                raise ValueError(f"{idx_path}: unsupported version {version}")
            code, = struct.unpack("<B", f.read(1))
            self._dtype = np.dtype(_DTYPES[code])
            n_seq, = struct.unpack("<q", f.read(8))
            n_doc, = struct.unpack("<q", f.read(8))
            offset = f.tell()
        idx_buf = np.memmap(idx_path, mode="r", order="C")
        self._sizes = np.frombuffer(idx_buf, np.int32, count=n_seq,
                                    offset=offset)
        offset += n_seq * 4
        self._pointers = np.frombuffer(idx_buf, np.int64, count=n_seq,
                                       offset=offset)
        offset += n_seq * 8
        self._doc_idx = np.frombuffer(idx_buf, np.int64, count=n_doc,
                                      offset=offset)
        self._data = np.memmap(data_file_path(prefix), mode="r", order="C")

    def __len__(self) -> int:
        return len(self._sizes)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        size = int(self._sizes[i])
        ptr = int(self._pointers[i])
        return np.frombuffer(self._data, self._dtype, count=size, offset=ptr)

    def get(self, i: int, offset: int = 0, length: Optional[int] = None):
        """Sub-sequence read without loading the whole item (reference
        MMapIndexedDataset.get)."""
        size = int(self._sizes[i])
        if not 0 <= offset <= size:
            raise IndexError(f"offset {offset} out of range for sequence {i} "
                             f"of size {size}")
        length = size - offset if length is None else length
        if length < 0 or offset + length > size:
            # a negative frombuffer count means "read to EOF" — would leak
            # other sequences' tokens
            raise IndexError(f"length {length} at offset {offset} exceeds "
                             f"sequence {i} of size {size}")
        ptr = int(self._pointers[i]) + offset * self._dtype.itemsize
        return np.frombuffer(self._data, self._dtype, count=length, offset=ptr)

    @property
    def sizes(self) -> np.ndarray:
        return self._sizes

    @property
    def doc_idx(self) -> np.ndarray:
        return self._doc_idx

    @property
    def dtype(self):
        return self._dtype

    @staticmethod
    def exists(prefix: str) -> bool:
        return os.path.exists(index_file_path(prefix)) and \
            os.path.exists(data_file_path(prefix))
