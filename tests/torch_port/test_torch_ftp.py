"""The port's FTP gateway (``server/ftp_server.py``) against the JAX
package's.

- Every case of the reference's ``tests/test_ftp.py``, replayed against the
  port's ``FtpServer`` over a port filer, volume server and master
  (``gateway_pair.replay``), through the stdlib ``ftplib``.
- The control-channel transcript of one scripted session (login refused
  and accepted, SYST, FEAT, MKD, CWD, STOR, APPE, SIZE, MDTM, NLST, LIST,
  RETR, RNFR/RNTO, DELE, RMD, CDUP, TYPE, an unknown verb, QUIT) through
  both packages' gateways, each over a port filer of its own, is equal
  line for line once the PASV/EPSV ports and the ``MDTM`` times are
  normalized; the data channel's bytes (NLST, RETR; LIST with its times
  normalized) are equal too.
- Files stored through one package's gateway are retrieved through the
  other's, over one filer, byte for byte.
"""

from __future__ import annotations

import ftplib
import io
import random
import re

import pytest

from seaweedfs_tpu.server.ftp_server import FtpServer as JFtpServer
from seaweedfs_tpu_torch.server.ftp_server import FtpServer as PFtpServer

import gateway_pair
from gateway_pair import PORT_FILER, Stack, free_port

REF = gateway_pair.ref_module("test_ftp")
GATEWAY = {"jax": JFtpServer, "port": PFtpServer}
USERS = {"weed": "haystack"}


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    s = Stack("port", tmp_path_factory.mktemp("ftp"), max_volume_count=10)
    s.ftp = PFtpServer(port=free_port(), filer_url=s.url, users=dict(USERS)).start()
    s.extra.append(s.ftp)
    yield s
    s.stop()


@pytest.fixture(scope="module")
def pair(stack):
    """Both packages' gateways, each over a port filer of its own."""
    out = {}
    for kind, cls in GATEWAY.items():
        filer = PORT_FILER(port=free_port(), master_url=stack.master.url).start()
        out[kind] = cls(port=free_port(), filer_url=filer.url, users=dict(USERS)).start()
        stack.extra[:0] = [out[kind], filer]
    return out


@pytest.mark.parametrize("case", gateway_pair.cases(REF))
def test_reference_case(case, stack, tmp_path):
    gateway_pair.replay(REF, case, cluster=stack.ftp, tmp_path=tmp_path)


class RecordingFTP(ftplib.FTP):
    """``ftplib.FTP`` that keeps the control channel: ``> `` lines sent,
    the rest received."""

    def __init__(self):
        super().__init__()
        self.transcript: list[str] = []

    def putcmd(self, line):
        self.transcript.append("> " + line)
        super().putcmd(line)

    def getline(self):
        line = super().getline()
        self.transcript.append(line)
        return line


_PASV = re.compile(r"\((\d+,){5}\d+\)")
_EPSV = re.compile(r"\(\|\|\|\d+\|\)")
_LIST_TIME = re.compile(r" [A-Z][a-z]{2} \d\d \d\d:\d\d ")


def _normalized(transcript: list[str]) -> list[str]:
    out, last = [], ""
    for line in transcript:
        line = _EPSV.sub("(|||PORT|)", _PASV.sub("(PORT)", line))
        if last.startswith("> MDTM") and line.startswith("213 "):
            line = "213 TIME" if re.fullmatch(r"213 \d{14}", line) else line
        out.append(line)
        last = line
    return out


def _session(srv) -> tuple[list[str], list]:
    rng = random.Random(959)
    big = rng.randbytes(300_000)
    data = []
    ftp = RecordingFTP()
    ftp.connect(srv.host, srv.port, timeout=15)
    with pytest.raises(ftplib.error_perm):
        ftp.login("weed", "wrong")
    ftp.login("weed", "haystack")
    for cmd in ("SYST", "FEAT", "PWD", "MKD /t", "CWD /t", "PWD", "TYPE I"):
        ftp.sendcmd(cmd)
    ftp.storbinary("STOR a.txt", io.BytesIO(b"one\n"))
    ftp.storbinary("APPE a.txt", io.BytesIO(b"two\n"))
    ftp.storbinary("STOR big.bin", io.BytesIO(big))
    ftp.mkd("sub")
    ftp.storbinary("STOR sub/c.txt", io.BytesIO(b"nested"))
    for cmd in ("SIZE a.txt", "SIZE big.bin", "MDTM a.txt", "NOOP"):
        ftp.sendcmd(cmd)
    data.append(sorted(ftp.nlst()))
    listing: list = []
    ftp.retrlines("LIST", listing.append)
    data.append(sorted(_LIST_TIME.sub(" TIME ", ln) for ln in listing))
    for name in ("a.txt", "big.bin", "sub/c.txt"):
        got = io.BytesIO()
        ftp.retrbinary(f"RETR {name}", got.write)
        data.append(got.getvalue())
    ftp.rename("a.txt", "b.txt")
    for cmd in ("SIZE a.txt", "DELE /t", "RETR /nope", "XYZ", "RNTO x"):
        with pytest.raises((ftplib.error_perm, ftplib.error_temp)):
            ftp.sendcmd(cmd)
    ftp.delete("b.txt")
    ftp.sendcmd("CDUP")
    ftp.sendcmd("PWD")
    ftp.rmd("/t")
    with pytest.raises(ftplib.error_perm):
        ftp.cwd("/t")
    ftp.quit()
    return _normalized(ftp.transcript), data


def test_scripted_session_transcripts_equal(pair):
    got = {kind: _session(srv) for kind, srv in pair.items()}
    transcript, data = got["port"]
    assert len(transcript) > 60 and data[2] == b"one\ntwo\n"
    for i, (j, p) in enumerate(zip(got["jax"][0], transcript)):
        assert j == p, (i, j, p)
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_files_read_back_through_the_other_gateway(pair, writer):
    reader = "port" if writer == "jax" else "jax"
    w = pair[writer]
    r = GATEWAY[reader](port=free_port(), filer_url=w.client.base.split("//", 1)[1],
                        users=dict(USERS)).start()
    rng = random.Random(len(writer))
    files = {f"/x-{writer}/f{i}.bin": rng.randbytes(rng.randrange(1, 400_000)) for i in range(5)}
    try:
        for srv, store in ((w, True), (r, False)):
            ftp = ftplib.FTP()
            ftp.connect(srv.host, srv.port, timeout=15)
            ftp.login("weed", "haystack")
            for path, data in files.items():
                if store:
                    ftp.storbinary(f"STOR {path}", io.BytesIO(data))
                else:
                    got = io.BytesIO()
                    ftp.retrbinary(f"RETR {path}", got.write)
                    assert got.getvalue() == data, path
            ftp.quit()
    finally:
        r.stop()
