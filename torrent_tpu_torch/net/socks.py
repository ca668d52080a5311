"""SOCKS5 client (RFC 1928/1929) for proxied peer and tracker traffic.

The reference dials everything directly; real deployments routinely
need outbound TCP routed through a proxy (privacy networks, egress
policies). This is a minimal async CONNECT client: greeting with
no-auth or username/password, then CONNECT with a literal v4/v6 or
domain address. TLS (https trackers) is started inside the tunnel via
``loop.start_tls``.

Policy for what a configured proxy covers lives in the session layer:
TCP peer dials, HTTP(S) trackers, and metadata fetches go through it;
UDP paths (UDP trackers, uTP, DHT) cannot ride a CONNECT tunnel and
are disabled or skipped rather than silently leaking around the proxy.
"""

from __future__ import annotations

import asyncio
import ipaddress
from dataclasses import dataclass
from urllib.parse import unquote, urlsplit

__all__ = ["ProxyError", "ProxySpec", "open_connection"]


class ProxyError(OSError):
    """Proxy unreachable, authentication failed, or CONNECT refused."""


@dataclass(frozen=True)
class ProxySpec:
    host: str
    port: int
    username: str | None = None
    password: str | None = None

    @classmethod
    def parse(cls, url: str) -> "ProxySpec":
        """``socks5://[user:pass@]host:port`` (socks5h is accepted as an
        alias — hostnames are ALWAYS resolved by the proxy here)."""
        parts = urlsplit(url)
        if parts.scheme not in ("socks5", "socks5h"):
            raise ValueError(f"unsupported proxy scheme {parts.scheme!r}")
        if not parts.hostname or not parts.port:
            raise ValueError(f"proxy URL needs host:port, got {url!r}")
        return cls(
            host=parts.hostname,
            port=parts.port,
            username=unquote(parts.username) if parts.username else None,
            password=unquote(parts.password) if parts.password else None,
        )


def _connect_request(host: str, port: int) -> bytes:
    try:
        ip = ipaddress.ip_address(host)
        addr = (b"\x01" if ip.version == 4 else b"\x04") + ip.packed
    except ValueError:
        try:
            raw = host.encode("idna")
        except UnicodeError as e:
            # UnicodeError is a ValueError, not an OSError: it would
            # escape every caller's dial error handling and kill
            # announce/dial tasks (the proxyless path fails the same
            # name as a catchable gaierror)
            raise ProxyError(f"hostname not encodable for SOCKS5: {host!r}") from e
        if len(raw) > 255:
            raise ProxyError(f"hostname too long for SOCKS5: {host!r}")
        addr = b"\x03" + bytes([len(raw)]) + raw
    return b"\x05\x01\x00" + addr + port.to_bytes(2, "big")


_REPLY_TEXT = {
    1: "general failure",
    2: "connection not allowed by ruleset",
    3: "network unreachable",
    4: "host unreachable",
    5: "connection refused",
    6: "TTL expired",
    7: "command not supported",
    8: "address type not supported",
}


async def open_connection(
    proxy: ProxySpec,
    host: str,
    port: int,
    ssl=None,
    server_hostname: str | None = None,
):
    """TCP connection to ``host:port`` tunneled through ``proxy``.

    Returns ``(reader, writer)`` like ``asyncio.open_connection``. With
    ``ssl``, TLS is negotiated inside the tunnel (``server_hostname``
    defaults to ``host``). Raises ProxyError (an OSError) on any proxy-
    level failure so callers' existing OSError handling applies.
    """
    reader, writer = await asyncio.open_connection(proxy.host, proxy.port)
    try:
        if proxy.username is not None:
            writer.write(b"\x05\x02\x00\x02")  # no-auth or user/pass
        else:
            writer.write(b"\x05\x01\x00")
        await writer.drain()
        ver, method = await reader.readexactly(2)
        if ver != 5:
            raise ProxyError(f"not a SOCKS5 proxy (version {ver})")
        if method == 0x02:
            if proxy.username is None:
                raise ProxyError("proxy demands credentials but none configured")
            u = proxy.username.encode()
            p = (proxy.password or "").encode()
            if len(u) > 255 or len(p) > 255:
                raise ProxyError("SOCKS5 credentials too long")
            writer.write(b"\x01" + bytes([len(u)]) + u + bytes([len(p)]) + p)
            await writer.drain()
            _, status = await reader.readexactly(2)
            if status != 0:
                raise ProxyError("proxy rejected credentials")
        elif method != 0x00:
            raise ProxyError(f"proxy offered no acceptable auth method ({method:#x})")

        writer.write(_connect_request(host, port))
        await writer.drain()
        ver, reply, _rsv, atyp = await reader.readexactly(4)
        if ver != 5:
            raise ProxyError("malformed CONNECT reply")
        # bound address: 4/16 bytes or length-prefixed domain, then port
        if atyp == 0x01:
            await reader.readexactly(4 + 2)
        elif atyp == 0x04:
            await reader.readexactly(16 + 2)
        elif atyp == 0x03:
            n = (await reader.readexactly(1))[0]
            await reader.readexactly(n + 2)
        else:
            raise ProxyError(f"malformed CONNECT reply (atyp {atyp:#x})")
        if reply != 0:
            raise ProxyError(
                f"CONNECT to {host}:{port} refused: "
                f"{_REPLY_TEXT.get(reply, f'code {reply}')}"
            )
        if ssl is not None:
            transport = await asyncio.get_running_loop().start_tls(
                writer.transport,
                writer.transport.get_protocol(),
                ssl,
                server_hostname=server_hostname or host,
            )
            # rebind the stream pair over the TLS transport
            writer._transport = transport  # noqa: SLF001 — asyncio has no
            # public way to swap a StreamWriter's transport post-start_tls
        return reader, writer
    except (asyncio.IncompleteReadError, ConnectionError) as e:
        writer.close()
        raise ProxyError(f"proxy handshake failed: {e}") from e
    except BaseException:
        writer.close()
        raise
