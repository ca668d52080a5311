"""UPnP IGD port mapping + external IP discovery (ref: upnp.ts, 160 LoC).

SSDP M-SEARCH multicast → gateway description fetch → WANIPConnection
control URL → SOAP ``GetExternalIPAddress`` / ``AddPortMapping``
(upnp.ts:14-147). Feature-flagged off by default in ClientConfig — LAN
multicast is environment-dependent and useless in containers.

Fixes vs the reference (SURVEY §8.7): the lease duration is an honest
parameter (the reference commented "30min" but sent 60 s), and the debug
console.log is a logger call.
"""

from __future__ import annotations

import asyncio
import re
import socket
from dataclasses import dataclass
from urllib.parse import urlsplit

from torrent_tpu_torch.net.tracker import _http_get
from torrent_tpu_torch.utils.log import get_logger

log = get_logger("net.upnp")

SSDP_ADDR = ("239.255.255.250", 1900)
SSDP_SEARCH = (
    "M-SEARCH * HTTP/1.1\r\n"
    f"HOST: {SSDP_ADDR[0]}:{SSDP_ADDR[1]}\r\n"
    'MAN: "ssdp:discover"\r\n'
    "MX: 2\r\n"
    "ST: urn:schemas-upnp-org:device:InternetGatewayDevice:1\r\n\r\n"
)
WAN_SERVICE = "urn:schemas-upnp-org:service:WANIPConnection:1"


@dataclass
class UpnpAddrs:
    internal_ip: str
    external_ip: str | None
    mapped_port: int | None


class UpnpError(Exception):
    pass


# ------------------------------------------------------------------ SSDP


async def discover_gateway(timeout: float = 3.0) -> str:
    """M-SEARCH for an IGD; returns its description URL (upnp.ts:14-31)."""
    loop = asyncio.get_running_loop()
    fut: asyncio.Future[str] = loop.create_future()

    class _Proto(asyncio.DatagramProtocol):
        def datagram_received(self, data, addr):
            m = re.search(rb"(?im)^location:\s*(\S+)", data)
            if m and not fut.done():
                fut.set_result(m.group(1).decode("latin-1"))

    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL, 2)
    sock.bind(("", 0))
    transport, _ = await loop.create_datagram_endpoint(_Proto, sock=sock)
    try:
        transport.sendto(SSDP_SEARCH.encode("latin-1"), SSDP_ADDR)
        return await asyncio.wait_for(fut, timeout)
    except asyncio.TimeoutError:
        raise UpnpError("no UPnP gateway responded")
    finally:
        transport.close()


def extract_control_url(description_xml: bytes, base_url: str) -> str:
    """Find the WANIPConnection controlURL in the device description
    (upnp.ts:33-61 — same regex-over-XML approach; a full XML parser buys
    nothing for one tag)."""
    svc_idx = description_xml.find(WAN_SERVICE.encode())
    if svc_idx < 0:
        raise UpnpError("gateway has no WANIPConnection service")
    m = re.search(rb"<controlURL>([^<]+)</controlURL>", description_xml[svc_idx:])
    if not m:
        raise UpnpError("WANIPConnection service has no controlURL")
    control = m.group(1).decode("latin-1")
    if control.startswith("http://") or control.startswith("https://"):
        return control
    parts = urlsplit(base_url)
    return f"{parts.scheme}://{parts.netloc}{control if control.startswith('/') else '/' + control}"


# ------------------------------------------------------------------ SOAP


def soap_envelope(action: str, args: dict[str, str]) -> bytes:
    """Build the SOAP action body (upnp.ts:63-87)."""
    fields = "".join(f"<New{k}>{v}</New{k}>" for k, v in args.items())
    return (
        '<?xml version="1.0"?>'
        '<s:Envelope xmlns:s="http://schemas.xmlsoap.org/soap/envelope/" '
        's:encodingStyle="http://schemas.xmlsoap.org/soap/encoding/">'
        f'<s:Body><u:{action} xmlns:u="{WAN_SERVICE}">{fields}</u:{action}></s:Body>'
        "</s:Envelope>"
    ).encode("utf-8")


async def _soap_call(
    control_url: str, action: str, args: dict[str, str], timeout: float = 10.0
) -> bytes:
    parts = urlsplit(control_url)
    host = parts.hostname or ""
    port = parts.port or 80
    body = soap_envelope(action, args)

    async def go() -> bytes:
        reader, writer = await asyncio.open_connection(host, port)
        try:
            head = (
                f"POST {parts.path or '/'} HTTP/1.1\r\nHost: {host}:{port}\r\n"
                f'SOAPAction: "{WAN_SERVICE}#{action}"\r\n'
                "Content-Type: text/xml\r\n"
                f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n"
            )
            writer.write(head.encode("latin-1") + body)
            await writer.drain()
            response = await reader.read()
            if b"200" not in response.split(b"\r\n", 1)[0]:
                raise UpnpError(f"SOAP {action} failed: {response[:200]!r}")
            return response
        finally:
            writer.close()

    try:
        # half-broken router firmware loves accepting connections and
        # never answering; a stalled gateway must not hang Client.start()
        return await asyncio.wait_for(go(), timeout)
    except asyncio.TimeoutError:
        raise UpnpError(f"SOAP {action} timed out after {timeout}s")


def get_internal_ip(probe_host: str = "8.8.8.8") -> str:
    """Local address of a connected UDP socket (upnp.ts:89-100)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect((probe_host, 80))
        return s.getsockname()[0]
    finally:
        s.close()


async def get_external_ip(control_url: str) -> str:
    """(upnp.ts:102-122)."""
    resp = await _soap_call(control_url, "GetExternalIPAddress", {})
    m = re.search(rb"<NewExternalIPAddress>([^<]+)</NewExternalIPAddress>", resp)
    if not m:
        raise UpnpError("no external IP in SOAP response")
    return m.group(1).decode("latin-1")


async def add_port_mapping(
    control_url: str, internal_ip: str, port: int, lease_seconds: int = 3600
) -> None:
    """TCP port mapping with an honest lease (upnp.ts:124-147, §8.7 fixed)."""
    await _soap_call(
        control_url,
        "AddPortMapping",
        {
            "RemoteHost": "",
            "ExternalPort": str(port),
            "Protocol": "TCP",
            "InternalPort": str(port),
            "InternalClient": internal_ip,
            "Enabled": "1",
            "PortMappingDescription": "torrent-tpu",
            "LeaseDuration": str(lease_seconds),
        },
    )


async def get_ip_addrs_and_map_port(port: int, lease_seconds: int = 3600) -> UpnpAddrs:
    """Orchestrator (upnp.ts:149-160): discover → describe → map + query."""
    location = await discover_gateway()
    description = await _http_get(location, timeout=5)
    control_url = extract_control_url(description, location)
    internal_ip = get_internal_ip()
    external_ip, _ = await asyncio.gather(
        get_external_ip(control_url),
        add_port_mapping(control_url, internal_ip, port, lease_seconds),
    )
    log.info("UPnP mapped port %d (external ip %s)", port, external_ip)
    return UpnpAddrs(internal_ip=internal_ip, external_ip=external_ip, mapped_port=port)
