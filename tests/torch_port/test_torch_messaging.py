"""The port's message broker (``messaging/``) against the JAX package's.

- Every case of the reference's ``tests/test_messaging.py``, replayed on the
  port: its log buffer, ring, broker and client over a port filer (64 KiB
  chunks), volume server and master (``gateway_pair.replay``). The
  reference's process-stability case checks the port's ``partition_for_key``
  against the JAX package's in fresh interpreters; one more case checks the
  port's own in fresh interpreters.
- ``encode_message`` byte-equal on 1 000 seeded messages, and
  ``decode_messages`` equal on their frames.
- ``partition_for_key`` equal on 10 000 keys and 1–16 partitions.
- With ``time.time_ns`` pinned in both packages' log buffers, the same
  publishes through each package's broker (each over a port filer of its
  own) leave byte-equal ``.seg`` files under the same names, and replay
  equal.
"""

from __future__ import annotations

import itertools
import os
import random
import subprocess
import sys
import types

import pytest

import seaweedfs_tpu.messaging.client as j_client
import seaweedfs_tpu.messaging.log_buffer as j_lb
import seaweedfs_tpu_torch.messaging.client as p_client
import seaweedfs_tpu_torch.messaging.log_buffer as p_lb
from seaweedfs_tpu.messaging import Broker as JBroker
from seaweedfs_tpu_torch.filer.client import FilerClient
from seaweedfs_tpu_torch.messaging import Broker as PBroker
from seaweedfs_tpu_torch.messaging import MessagingClient

import gateway_pair
from gateway_pair import PORT_FILER, Stack, free_port

REF = gateway_pair.ref_module("test_messaging")


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    s = Stack("port", tmp_path_factory.mktemp("msg"), chunk_size=64 * 1024)
    s.brokers = [PBroker(port=free_port(), filer_url=s.url).start() for _ in range(2)]
    s.extra += s.brokers
    yield s
    s.stop()


@pytest.mark.parametrize("case", gateway_pair.cases(REF))
def test_reference_case(case, stack):
    gateway_pair.replay(REF, case, stack=(stack.brokers, stack.filer))


def test_port_partition_for_key_is_process_stable():
    code = ("from seaweedfs_tpu_torch.messaging.client import partition_for_key;"
            "print([partition_for_key(b'user-%d' % i, 7) for i in range(50)])")
    want = str([p_client.partition_for_key(b"user-%d" % i, 7) for i in range(50)])
    for seed in ("0", "12345"):
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             timeout=60, env={"PYTHONHASHSEED": seed,
                                              "PATH": os.environ.get("PATH", ""),
                                              "PYTHONPATH": gateway_pair.REPO})
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == want


def _messages(seed: int, n: int):
    rng = random.Random(seed)
    return [(rng.randrange(1 << 63), rng.randbytes(rng.randrange(0, 64)),
             rng.randbytes(rng.randrange(0, 2048))) for _ in range(n)]


def test_frames_byte_equal():
    msgs = _messages(1000, 1000)
    frames = [j_lb.encode_message(*m) for m in msgs]
    assert frames == [p_lb.encode_message(*m) for m in msgs]
    blob = b"".join(frames)
    assert p_lb.decode_messages(blob) == j_lb.decode_messages(blob) == msgs
    cut = blob[: len(blob) - 7]  # a torn tail decodes alike
    assert p_lb.decode_messages(cut) == j_lb.decode_messages(cut)


def test_partition_for_key_equal():
    rng = random.Random(10_000)
    keys = [rng.randbytes(rng.randrange(1, 40)) for _ in range(10_000)]
    for n in range(1, 17):
        assert [p_client.partition_for_key(k, n) for k in keys] == \
            [j_client.partition_for_key(k, n) for k in keys], n


class _PinnedClock:
    """``time`` for a log buffer: ``time_ns`` counts from a fixed start,
    ``monotonic`` stands still (so the flush ticker never seals)."""

    def __init__(self, start: int = 1_760_000_000_000_000_000):
        self._next = itertools.count(start, 1000)

    def time_ns(self) -> int:
        return next(self._next)

    @staticmethod
    def monotonic() -> float:
        return 0.0


def test_segments_byte_equal_with_a_pinned_clock(stack):
    rng = random.Random(1024)
    publishes = [(i % 3, rng.randbytes(rng.randrange(0, 16)),
                  rng.randbytes(rng.randrange(4096, 8192))) for i in range(1200)]
    segs, replays = {}, {}
    for kind, cls in (("jax", JBroker), ("port", PBroker)):
        filer = PORT_FILER(port=free_port(), master_url=stack.master.url,
                           chunk_size=64 * 1024).start()
        clock = _PinnedClock()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr({"jax": j_lb, "port": p_lb}[kind], "time",
                       types.SimpleNamespace(time_ns=clock.time_ns, monotonic=clock.monotonic))
            broker = cls(port=free_port(), filer_url=filer.url).start()
            try:
                mc = MessagingClient([broker.url])
                mc.create_topic("pin", "t", partitions=3)
                for part, key, value in publishes:
                    mc.publish("pin", "t", value, key=key, partition=part)
                broker.topics.close()  # seals every partition
                for tp in broker.topics._partitions.values():
                    for t in tp.buffer._flushers:
                        t.join(timeout=30)
                fc = FilerClient(filer.url)
                segs[kind] = {}
                for part in range(3):
                    d = f"/topics/pin/t/{part:02d}"
                    for e in fc.list(d, limit=1000):
                        status, blob, _ = fc.get_object(f"{d}/{e['name']}")
                        assert status == 200
                        segs[kind][f"{d}/{e['name']}"] = blob
                replays[kind] = [mc.fetch("pin", "t", part, limit=5000)[0] for part in range(3)]
            finally:
                broker.stop()
                filer.stop()
    assert len(segs["port"]) >= 6  # at least one size-sealed segment a partition
    assert sorted(segs["port"]) == sorted(segs["jax"])
    assert segs["port"] == segs["jax"]
    assert replays["port"] == replays["jax"]
    assert [len(r) for r in replays["port"]] == [400, 400, 400]
