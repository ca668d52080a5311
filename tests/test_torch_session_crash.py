"""Crash consistency: SIGKILL a real download process mid-transfer.

Cooperative stop/restart is covered in test_resume.py; this is the
uncooperative case — the process dies with no teardown, and the next
session must (a) find a usable periodic checkpoint on disk and (b)
finish the download from wherever it actually got to.
"""

import asyncio
import os
import signal
import subprocess
import sys
import time

import numpy as np

from torrent_tpu_torch.codec.metainfo import parse_metainfo
from torrent_tpu_torch.session.client import Client, ClientConfig
from torrent_tpu_torch.session.resume import ResumeData

from tests.test_torch_session import build_torrent_bytes, fast_config, start_tracker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# A download in a process of its own (the port has no CLI yet): one
# client, the torrent file and the directory from argv, exit 0 once the
# torrent completes.
_DOWNLOAD = """
import asyncio, sys
from torrent_tpu_torch.codec.metainfo import parse_metainfo
from torrent_tpu_torch.session.client import Client, ClientConfig

async def main(tfile, out):
    meta = parse_metainfo(open(tfile, "rb").read())
    async with Client(ClientConfig(host="127.0.0.1", hasher="cpu")) as client:
        torrent = await client.add(meta, out)
        await torrent.on_complete.wait()

asyncio.run(main(sys.argv[1], sys.argv[2]))
"""


def run(coro, timeout=180):
    return asyncio.run(asyncio.wait_for(coro, timeout))


class TestSigkillMidDownload:
    def test_checkpoint_survives_and_restart_completes(self, tmp_path):
        async def go():
            rng = np.random.default_rng(9)
            payload = rng.integers(0, 256, size=2 * 1024 * 1024, dtype=np.uint8).tobytes()
            server, pump, announce_url = await start_tracker()
            meta_bytes = build_torrent_bytes(
                payload, 32768, announce_url.encode(), name=b"crash.bin"
            )
            meta = parse_metainfo(meta_bytes)
            tfile = tmp_path / "crash.torrent"
            tfile.write_bytes(meta_bytes)
            dl = tmp_path / "dl"
            dl.mkdir()

            # throttled seed: the whole payload takes ~6 s, so a kill at
            # ~2.5 s lands mid-transfer with ≥1 periodic checkpoint
            # (every 16 pieces of the 64) already on disk
            seed = Client(
                ClientConfig(hasher="cpu",
                    host="127.0.0.1", enable_upnp=False, max_upload_bps=384 * 1024
                )
            )
            seed.config.torrent = fast_config()
            await seed.start()
            proc = None
            try:
                (tmp_path / "seeddata").mkdir()
                (tmp_path / "seeddata" / "crash.bin").write_bytes(payload)
                ts = await seed.add(meta, str(tmp_path / "seeddata"))
                assert ts.bitfield.complete

                proc = subprocess.Popen(
                    [sys.executable, "-c", _DOWNLOAD, str(tfile), str(dl)],
                    cwd=REPO,
                    stdout=subprocess.DEVNULL,
                    stderr=subprocess.DEVNULL,
                )
                resume_path = dl / f".{meta.info_hash.hex()}.resume"
                # wait until at least one checkpoint lands (first one is
                # 16 pieces = 512 KiB ≈ 1.5 s at the cap)
                deadline = time.monotonic() + 30
                rd = None
                while time.monotonic() < deadline:
                    if resume_path.exists():
                        rd = ResumeData.decode(resume_path.read_bytes())
                        if rd is not None and any(rd.bitfield):
                            break
                    await asyncio.sleep(0.1)
                assert rd is not None and any(rd.bitfield), "no checkpoint before kill"
                proc.send_signal(signal.SIGKILL)  # no teardown of any kind
                proc.wait(timeout=10)

                # the checkpoint on disk must still decode (atomicity of
                # the .resume write) and claim only verified pieces
                rd = ResumeData.decode(resume_path.read_bytes())
                assert rd is not None
                claimed = sum(
                    1
                    for i in range(meta.info.num_pieces)
                    if rd.bitfield[i // 8] & (0x80 >> (i % 8))
                )
                assert 0 < claimed < meta.info.num_pieces

                # second session: uncap the seed so completion is fast.
                # to_thread: a blocking subprocess.run would freeze the
                # event loop the in-process seed serves from
                seed.upload_bucket.rate = 0
                r = await asyncio.to_thread(
                    subprocess.run,
                    [sys.executable, "-c", _DOWNLOAD, str(tfile), str(dl)],
                    cwd=REPO,
                    capture_output=True,
                    text=True,
                    timeout=120,
                )
                assert r.returncode == 0, r.stderr[-2000:]
                assert (dl / "crash.bin").read_bytes() == payload
            finally:
                if proc is not None and proc.poll() is None:
                    proc.kill()
                await seed.close()
                server.close()
                pump.cancel()

        run(go())
