"""Block payload storage backends for the capacity tiers
(``dynamo_tpu/blocks/storage.py`` less ``RemoteStorage``, the G4 medium,
which needs the object store).

A payload is the pair of numpy arrays (k, v) for one page across all layers:
shape [num_layers, page_size, W] each, the page's bytes in the cache's layout
as an unsigned-integer view of the cache dtype (numpy has neither bf16 nor
e4m3; ``TorchModelRunner.read_pages``). Backends only store/retrieve
bytes-like payloads; capacity policy lives in TierPool.
"""

from __future__ import annotations

import abc
import pathlib
import shutil

import numpy as np

Payload = tuple[np.ndarray, np.ndarray]  # (k, v) for one page


class BlockStorage(abc.ABC):
    @abc.abstractmethod
    def write(self, block_hash: int, payload: Payload) -> None: ...

    @abc.abstractmethod
    def read(self, block_hash: int) -> Payload | None: ...

    @abc.abstractmethod
    def delete(self, block_hash: int) -> None: ...

    def exists(self, block_hash: int) -> bool:
        """Cheap membership probe; backends override when read() is costly."""
        return self.read(block_hash) is not None

    def close(self) -> None:
        pass


class HostStorage(BlockStorage):
    """Host-RAM storage (the G2 medium)."""

    def __init__(self) -> None:
        self._data: dict[int, Payload] = {}

    def write(self, block_hash: int, payload: Payload) -> None:
        k, v = payload
        self._data[block_hash] = (np.ascontiguousarray(k), np.ascontiguousarray(v))

    def read(self, block_hash: int) -> Payload | None:
        return self._data.get(block_hash)

    def delete(self, block_hash: int) -> None:
        self._data.pop(block_hash, None)

    def __len__(self) -> int:
        return len(self._data)


class DiskStorage(BlockStorage):
    """Disk storage, one .npz file per block (the G3 medium)."""

    def __init__(self, root: str | pathlib.Path) -> None:
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, block_hash: int) -> pathlib.Path:
        return self.root / f"{block_hash:016x}.npz"

    def write(self, block_hash: int, payload: Payload) -> None:
        k, v = payload
        tmp = self._path(block_hash).with_suffix(".tmp")
        with tmp.open("wb") as fh:
            np.savez(fh, k=k, v=v)
        tmp.rename(self._path(block_hash))  # atomic publish

    def read(self, block_hash: int) -> Payload | None:
        p = self._path(block_hash)
        if not p.exists():
            return None
        with np.load(p) as z:
            return z["k"], z["v"]

    def delete(self, block_hash: int) -> None:
        self._path(block_hash).unlink(missing_ok=True)

    def close(self) -> None:
        pass

    def destroy(self) -> None:
        shutil.rmtree(self.root, ignore_errors=True)


class NullStorage(BlockStorage):
    """Metadata-only backend: remembers which hashes exist, stores no data.

    Lets capacity/eviction/ordering logic run in CI without payload memory —
    ``read`` returns None, so onboarding treats blocks as instantly lost.
    """

    def __init__(self) -> None:
        self.hashes: set[int] = set()

    def write(self, block_hash: int, payload: Payload) -> None:
        self.hashes.add(block_hash)

    def read(self, block_hash: int) -> Payload | None:
        return None

    def delete(self, block_hash: int) -> None:
        self.hashes.discard(block_hash)
