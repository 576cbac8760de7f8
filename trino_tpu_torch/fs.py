"""Filesystem abstraction for file-backed connectors (counterpart of
``trino_tpu/fs.py``: the same code; it imports neither jax nor torch).

Reference: lib/trino-filesystem (TrinoFileSystem.java:60 — newInputFile /
newOutputFile / listFiles / deleteDirectory over hdfs/s3/gcs/azure/local
backends).  The engine's file connectors (hive/delta/iceberg/parquet)
take a FileSystem so tests can run against an in-memory tree and a future
object-store backend slots in without touching connector code.  Local paths
stay plain strings — pyarrow consumes them natively."""

from __future__ import annotations

import io
import os

__all__ = ["FileSystem", "LocalFileSystem", "MemoryFileSystem"]


class FileSystem:
    """Minimal surface the connectors need (TrinoFileSystem subset)."""

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def is_dir(self, path: str) -> bool:
        raise NotImplementedError

    def list_dir(self, path: str) -> list:
        """Immediate child names (not paths), sorted."""
        raise NotImplementedError

    def open_read(self, path: str):
        """Binary file-like for reading."""
        raise NotImplementedError

    def read_text(self, path: str) -> str:
        with self.open_read(path) as f:
            return f.read().decode()

    def write_bytes(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    def mkdirs(self, path: str) -> None:
        raise NotImplementedError

    def delete_dir(self, path: str) -> None:
        """Recursively delete a directory tree (TrinoFileSystem.deleteDirectory)."""
        raise NotImplementedError


class LocalFileSystem(FileSystem):
    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def is_dir(self, path: str) -> bool:
        return os.path.isdir(path)

    def list_dir(self, path: str) -> list:
        return sorted(os.listdir(path))

    def open_read(self, path: str):
        return open(path, "rb")

    def write_bytes(self, path: str, data: bytes) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)

    def mkdirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def delete_dir(self, path: str) -> None:
        import shutil

        shutil.rmtree(path, ignore_errors=True)


class MemoryFileSystem(FileSystem):
    """In-memory tree for tests (the reference's TrackingFileSystemFactory /
    memory file system used by connector unit tests)."""

    def __init__(self):
        self._files: dict = {}  # path -> bytes

    def _norm(self, path: str) -> str:
        return path.rstrip("/")

    def exists(self, path: str) -> bool:
        p = self._norm(path)
        return p in self._files or self.is_dir(p)

    def is_dir(self, path: str) -> bool:
        prefix = self._norm(path) + "/"
        return any(f.startswith(prefix) for f in self._files)

    def list_dir(self, path: str) -> list:
        prefix = self._norm(path) + "/"
        names = {f[len(prefix):].split("/", 1)[0]
                 for f in self._files if f.startswith(prefix)}
        return sorted(names)

    def open_read(self, path: str):
        p = self._norm(path)
        if p not in self._files:
            raise FileNotFoundError(path)
        return io.BytesIO(self._files[p])

    def write_bytes(self, path: str, data: bytes) -> None:
        self._files[self._norm(path)] = bytes(data)

    def mkdirs(self, path: str) -> None:
        pass  # directories are implicit

    def delete_dir(self, path: str) -> None:
        prefix = self._norm(path) + "/"
        for f in [f for f in self._files if f.startswith(prefix)]:
            del self._files[f]
