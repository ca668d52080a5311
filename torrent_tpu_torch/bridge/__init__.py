from torrent_tpu_torch.bridge.service import BridgeServer, serve_bridge

__all__ = ["BridgeServer", "serve_bridge"]
