"""Protocol tunables (reference: constants.ts, 18 LoC)."""

# Announce defaults (constants.ts:3-4)
DEFAULT_NUM_WANT = 50
DEFAULT_ANNOUNCE_INTERVAL = 600  # seconds

# UDP tracker protocol, BEP 15 (constants.ts:6-16)
UDP_CONNECT_MAGIC = 0x41727101980
UDP_MAX_ATTEMPTS = 8
UDP_BACKOFF_BASE = 15  # timeout for attempt n is 15 * 2**n seconds
UDP_CONNECTION_ID_TTL = 60  # seconds a connection id may be reused
UDP_MIN_CONNECT_RESP = 16
UDP_MIN_ANNOUNCE_RESP = 20
UDP_MIN_SCRAPE_RESP = 8
UDP_MIN_ERROR_RESP = 8

# HTTP tracker (constants.ts:18)
HTTP_TIMEOUT = 10  # seconds

# Peer wire protocol
HANDSHAKE_LEN = 68
PROTOCOL_STRING = b"BitTorrent protocol"
