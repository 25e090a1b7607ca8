"""Host network helpers (reference ``util/net_util.h``; SURVEY.md §2.25).

The reference enumerates local IPs to match hosts against ``-machine_file``
entries for the ZMQ transport.  The TPU framework's data plane needs no
machine files (ICI/DCN topology comes from the runtime), but the helpers
stay for operational parity: launcher scripts use them to identify hosts.
"""

from __future__ import annotations

import socket
from typing import List

__all__ = ["get_local_ips", "get_host_name", "match_machine_file"]


def get_host_name() -> str:
    return socket.gethostname()


def get_local_ips() -> List[str]:
    """Best-effort list of this host's IPv4 addresses (loopback last)."""
    ips: List[str] = []
    try:
        infos = socket.getaddrinfo(socket.gethostname(), None,
                                   socket.AF_INET)
        ips = sorted({i[4][0] for i in infos})
    except socket.gaierror:
        pass
    # UDP-connect trick finds the primary outbound interface without traffic
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect(("10.255.255.255", 1))
            primary = s.getsockname()[0]
            if primary not in ips:
                ips.insert(0, primary)
        finally:
            s.close()
    except OSError:  # mvlint: MV015-exempt(interface-discovery probe, not a delivery path)
        # probe, not a delivery path: no route just means the loopback
        # fallback below is the answer.
        pass
    if "127.0.0.1" not in ips:
        ips.append("127.0.0.1")
    return ips


def match_machine_file(machines: List[str]) -> int:
    """Rank of this host in a machine list, -1 if absent (reference
    machine-file semantics: the line index is the node rank)."""
    local = set(get_local_ips()) | {get_host_name()}
    for rank, m in enumerate(machines):
        if m.strip() in local:
            return rank
    return -1
