"""Byte-stream IO (reference ``include/multiverso/io/``; SURVEY.md §2.27).

The reference abstracts checkpoint bytes behind ``Stream``/``StreamFactory``
with local-FS and HDFS flavors.  Kept here as the seam the checkpoint module
writes through, so remote filesystems can slot in without touching table
code.  HDFS is stubbed (no hadoop in the image; the class documents the
contract and raises a clear error).
"""

from .stream import HDFSStream, LocalStream, Stream, StreamFactory

__all__ = ["Stream", "LocalStream", "HDFSStream", "StreamFactory"]
