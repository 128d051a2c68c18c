"""Multicast socket setup (setup_mcast, multicast.c:136-237).

Same target syntax ("name:port,iface"), same socket options (REUSEPORT/
REUSEADDR, TTL, loopback enabled, EF DSCP), and the same IGMP-snooping
workaround: senders also JOIN the group they transmit to
(multicast.c:208-217), so dumb switches don't flood or drop the stream.

Dual-stack like the reference (hints.ai_family = PF_UNSPEC,
multicast.c:160): getaddrinfo results are tried in order and the first
family that creates + connects/binds wins, with per-family socket
options (IP_* vs IPV6_*) and joins (ip_mreqn vs ipv6_mreq).  IPv6
literal targets use the bracketed form "[ff05::114]:5004" or, with no
port, the bare literal; link-local (ff02::/16) groups additionally need
an interface — ",eth0" or the RFC 4007 "%eth0" zone suffix — because
the kernel refuses an unscoped link-local bind (EINVAL), which we
surface loudly with the fix in the message.
"""

from __future__ import annotations

import ipaddress
import socket
import struct
import sys

__all__ = ["setup_mcast", "DEFAULT_MCAST_PORT", "DEFAULT_RTCP_PORT"]

DEFAULT_MCAST_PORT = 5004   # multicast.c:133
DEFAULT_RTCP_PORT = 5005
EF_TOS = 0x2E               # expedited forwarding (multicast.c:15)


def _parse_target(target: str) -> tuple[str, int, str | None]:
    iface = None
    if "," in target:
        target, iface = target.rsplit(",", 1)
    if target.startswith("["):              # [v6literal]:port
        host, _, rest = target[1:].partition("]")
        port = int(rest[1:]) if rest.startswith(":") else DEFAULT_MCAST_PORT
    elif target.count(":") >= 2:            # bare v6 literal, default port
        host, port = target, DEFAULT_MCAST_PORT
        # 'ff05::114:5006' meaning group ff05::114 port 5006 is
        # indistinguishable from the (valid) v6 address ff05::114:5006 —
        # the reference's own strrchr(':') syntax cannot express
        # literal-v6-plus-port at all (PARITY #14).  When the trailing
        # hextet also reads as a plausible port and the prefix is still
        # a valid literal, say which reading we took.
        head, _, tail = target.rpartition(":")
        if (tail.isdigit() and 1 <= int(tail) <= 65535
                and not head.endswith(":")):
            try:
                ipaddress.ip_address(head)
                print(f"multicast: treating {target!r} as a bare IPv6 "
                      f"group on port {DEFAULT_MCAST_PORT}; for group "
                      f"{head!r} port {tail} write '[{head}]:{tail}'",
                      file=sys.stderr)
            except ValueError:
                pass
    elif ":" in target:
        host, port_s = target.rsplit(":", 1)
        port = int(port_s)
    else:
        host, port = target, DEFAULT_MCAST_PORT
    return host, port, iface


def _is_multicast(host: str) -> bool:
    try:
        return ipaddress.ip_address(host.split("%", 1)[0]).is_multicast
    except ValueError:
        return False


def _set_options(fd: socket.socket, family: int, output: bool, ttl: int):
    """soptions (multicast.c:18-48), per family."""
    fd.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    if not output:
        # Deep receive buffer: the block pipeline can stall the reader for
        # a couple of seconds on a first kernel build; at 6.5 Mb/s that's ~2 MB of
        # I/Q that must queue in the kernel instead of dropping.
        try:
            fd.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 8 << 20)
        except OSError:
            pass
    try:
        fd.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    except (AttributeError, OSError):
        pass
    if family == socket.AF_INET6:
        fd.setsockopt(socket.IPPROTO_IPV6, socket.IPV6_MULTICAST_HOPS, ttl)
        fd.setsockopt(socket.IPPROTO_IPV6, socket.IPV6_MULTICAST_LOOP, 1)
        try:
            fd.setsockopt(socket.IPPROTO_IPV6, socket.IPV6_TCLASS,
                          EF_TOS << 2)
        except OSError:
            pass
    else:
        fd.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL, ttl)
        fd.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_LOOP, 1)
        try:
            fd.setsockopt(socket.IPPROTO_IP, socket.IP_TOS, EF_TOS << 2)
        except OSError:
            pass


def _join(fd: socket.socket, family: int, group: str, ifidx: int):
    """IGMP/MLD-snooping workaround join, both directions
    (multicast.c:208-217)."""
    if family == socket.AF_INET6:
        mreq = (socket.inet_pton(socket.AF_INET6, group.split("%", 1)[0])
                + struct.pack("@I", ifidx))
        fd.setsockopt(socket.IPPROTO_IPV6, socket.IPV6_JOIN_GROUP, mreq)
    else:
        mreq = (socket.inet_aton(group) + socket.inet_aton("0.0.0.0")
                + struct.pack("@i", ifidx))
        fd.setsockopt(socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP, mreq)


def setup_mcast(
    target: str,
    output: bool,
    ttl: int = 1,
    offset: int = 0,
) -> socket.socket:
    """Create a multicast UDP socket (setup_mcast, multicast.c:143-237).

    output=True: connect() to the group so plain send() works.
    output=False: bind() to the group to receive.
    offset is added to the port (status/command = data port + 2;
    RTCP = +1).  Returns the configured socket.
    """
    host, port, iface = _parse_target(target)
    port += offset
    try:
        ifidx = socket.if_nametoindex(iface) if iface else 0
    except OSError:
        print(f"multicast: unknown interface {iface!r}; joining on "
              "the default interface", file=sys.stderr)
        ifidx = 0

    # Link-local v6 groups must carry a zone for bind(); fold a ",iface"
    # into the RFC 4007 suffix so getaddrinfo fills sin6_scope_id.
    if ifidx and ":" in host and "%" not in host:
        host = f"{host}%{iface}"

    infos = socket.getaddrinfo(
        host, port, socket.AF_UNSPEC, socket.SOCK_DGRAM, socket.IPPROTO_UDP
    )
    last_err: OSError | None = None
    # Try each result in order, first success wins (multicast.c:173-201).
    for family, socktype, proto, _cname, addr in infos:
        fd = socket.socket(family, socktype, proto)
        try:
            _set_options(fd, family, output, ttl)
            if family == socket.AF_INET6 and ifidx:
                fd.setsockopt(socket.IPPROTO_IPV6,
                              socket.IPV6_MULTICAST_IF, ifidx)
            elif family == socket.AF_INET and ifidx and output:
                # Pin the v4 egress interface too (symmetry with the v6
                # branch above; the reference leaves v4 sends on the
                # routing default — ADVICE r4).  struct ip_mreqn:
                # imr_multiaddr, imr_address, imr_ifindex.
                fd.setsockopt(
                    socket.IPPROTO_IP, socket.IP_MULTICAST_IF,
                    socket.inet_aton("0.0.0.0") * 2
                    + struct.pack("@i", ifidx))
            if output:
                fd.connect(addr)
            else:
                # Bind to the group address itself (as the reference does,
                # multicast.c:197 binds resp->ai_addr): an INADDR_ANY bind
                # would also deliver datagrams addressed to OTHER groups on
                # the same port — e.g. a receiver's own output-status
                # stream arriving on its front-end-status socket.  Fail
                # loudly instead of silently widening to the wildcard.
                fd.bind(addr)
            if _is_multicast(addr[0]):
                scope = addr[3] if family == socket.AF_INET6 else ifidx
                try:
                    _join(fd, family, addr[0], scope or ifidx)
                except OSError as e:
                    # a receiver that can't join is silently deaf on a
                    # snooping switch — say so like the reference's perror
                    print(f"multicast: join {addr[0]} failed: {e}",
                          file=sys.stderr)
            return fd
        except OSError as e:
            last_err = e
            fd.close()

    hint = ""
    if host.count(":") >= 2 and host.split("%")[0].lower().startswith("ff02")\
            and "%" not in host and not iface:
        hint = (" (link-local IPv6 group needs an interface: append "
                "',eth0' or use 'group%eth0')")
    raise OSError(
        f"cannot {'connect' if output else 'bind'} multicast socket to "
        f"{host}:{port} (target {target!r}){hint}: {last_err}"
    ) from last_err
