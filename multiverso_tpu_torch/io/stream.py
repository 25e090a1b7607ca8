"""Stream abstraction — reference ``io/io.h`` (`Stream`, `StreamFactory`,
`LocalStream`, `HDFSStream`; SURVEY.md §2.27).

Chaos seam: every LocalStream read/write passes ``fault.inject`` (sites
``io.read`` / ``io.write``) so the chaos suite can script transient IO
failures that the checkpoint layer's RetryPolicy must absorb.  With the
injector disarmed (the default) the seam is a single bool check.

Observability: LocalStream counts bytes moved into the metrics registry
(``io.bytes{dir=read|write}``), so checkpoint/trace IO volume shows up
in ``metrics.snapshot()`` next to the op latencies
(docs/observability.md).
"""

from __future__ import annotations

import os
from typing import BinaryIO

from .. import fault, metrics

__all__ = ["Stream", "LocalStream", "HDFSStream", "StreamFactory"]

# Looked up per call (a dict hit under the registry lock — noise next to
# the file IO itself) so a metrics.reset() mid-run re-mints live series
# instead of feeding detached ones.
_READ_LABELS = {"dir": "read"}
_WRITE_LABELS = {"dir": "write"}


class Stream:
    """Sequential byte stream with the reference's Read/Write surface."""

    def write(self, data: bytes) -> int:
        raise NotImplementedError

    def read(self, size: int = -1) -> bytes:
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass

    # Python file-object compat so numpy/np.savez can write through us.
    def readable(self) -> bool:
        return True

    def writable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return False

    def abort(self) -> None:
        """Discard the stream without committing (atomic writers only)."""
        self.close()

    def __enter__(self) -> "Stream":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        # A body that raised must not commit a half-written atomic file
        # over a previous good one.
        if exc_type is not None:
            self.abort()
        else:
            self.close()


class LocalStream(Stream):
    """Local-filesystem stream (reference ``LocalStream``).

    ``atomic=True`` (write modes) writes to a ``.tmp.<pid>`` sibling and
    renames into place on close — a crash mid-write never leaves a
    truncated file at the final path.
    """

    def __init__(self, path: str, mode: str = "rb", atomic: bool = False):
        if "b" not in mode:
            mode += "b"
        parent = os.path.dirname(os.path.abspath(path))
        if "w" in mode or "a" in mode:
            os.makedirs(parent, exist_ok=True)
        self.path = path
        self._atomic = atomic and "w" in mode
        self._write_path = (f"{path}.tmp.{os.getpid()}" if self._atomic
                            else path)
        self._f: BinaryIO = open(self._write_path, mode)

    def write(self, data: bytes) -> int:
        fault.inject("io.write")
        n = self._f.write(data)
        metrics.counter("io.bytes", _WRITE_LABELS).inc(n)
        return n

    def read(self, size: int = -1) -> bytes:
        fault.inject("io.read")
        data = self._f.read(size)
        metrics.counter("io.bytes", _READ_LABELS).inc(len(data))
        return data

    def seek(self, pos: int, whence: int = 0) -> int:
        return self._f.seek(pos, whence)

    def tell(self) -> int:
        return self._f.tell()

    def seekable(self) -> bool:
        return self._f.seekable()

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()
            if self._atomic:
                os.replace(self._write_path, self.path)

    def abort(self) -> None:
        if not self._f.closed:
            self._f.close()
            if self._atomic:
                try:
                    os.unlink(self._write_path)
                except OSError:
                    pass


class FsspecStream(Stream):
    """Remote stream over any `fsspec`_ filesystem (reference HDFS-stream
    generalized: one backend covers hdfs/s3/gcs/memory/... whenever the
    matching fsspec driver is installed).

    .. _fsspec: https://filesystem-spec.readthedocs.io
    """

    def __init__(self, path: str, mode: str = "rb",
                 scheme: str = "memory", atomic: bool = False):
        if "b" not in mode:
            mode += "b"
        try:
            import fsspec
        except ImportError as e:   # pragma: no cover - fsspec is baked in
            raise NotImplementedError(
                f"'{scheme}://' streams need the fsspec package: {e}")
        self._atomic = atomic and "w" in mode
        self._final_path = path
        self._write_path = (f"{path}.tmp.{os.getpid()}" if self._atomic
                            else path)
        try:
            of = fsspec.open(f"{scheme}://{self._write_path}", mode)
            self._fs = of.fs
            self._f = of.open()
        except (FileNotFoundError, PermissionError, IsADirectoryError):
            raise                  # real path errors, not driver problems
        except (ImportError, ValueError, OSError) as e:
            # ImportError: no fsspec driver for the scheme (e.g. s3fs);
            # OSError: driver present but its native client is not
            # (pyarrow's hdfs needs libjvm/libhdfs).
            raise NotImplementedError(
                f"fsspec cannot serve '{scheme}://' here (missing driver "
                f"or native client for that scheme, e.g. hadoop client "
                f"for hdfs): {e}")
        self.path = f"{scheme}://{path}"

    def write(self, data: bytes) -> int:
        return self._f.write(data)

    def read(self, size: int = -1) -> bytes:
        return self._f.read(size)

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()
            if self._atomic:
                self._fs.mv(self._write_path, self._final_path)

    def abort(self) -> None:
        if not self._f.closed:
            self._f.close()
            if self._atomic:
                try:
                    self._fs.rm(self._write_path)
                except OSError:
                    pass


class HDFSStream(FsspecStream):
    """HDFS stream (reference ``HDFSStream`` over libhdfs).

    Served through pyarrow/fsspec's hadoop driver when the deployment has
    one; without a hadoop client it raises NotImplementedError with the
    integration contract instead of failing obscurely.
    """

    def __init__(self, path: str, mode: str = "rb", atomic: bool = False):
        super().__init__(path, mode, scheme="hdfs", atomic=atomic)


class StreamFactory:
    """Scheme-dispatched opener (reference ``StreamFactory::GetStream``).

    Unregistered schemes fall back to the fsspec backend, so any
    installed fsspec driver (s3, gcs, memory, ...) works unregistered.
    """

    _schemes = {}

    @classmethod
    def register(cls, scheme: str, ctor) -> None:
        cls._schemes[scheme] = ctor

    @classmethod
    def open(cls, uri: str, mode: str = "rb",
             atomic: bool = False) -> Stream:
        if "://" in uri:
            scheme, path = uri.split("://", 1)
        else:
            scheme, path = "file", uri
        ctor = cls._schemes.get(scheme)
        if ctor is None:
            return FsspecStream(path, mode, scheme=scheme, atomic=atomic)
        if atomic:
            # Custom schemes registered with the documented (path, mode)
            # contract keep working; atomic is best-effort for them.
            try:
                return ctor(path, mode, atomic=True)
            except TypeError:
                pass
        return ctor(path, mode)


StreamFactory.register("file", LocalStream)
StreamFactory.register("hdfs", HDFSStream)
