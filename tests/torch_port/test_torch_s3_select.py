"""SelectObjectContent through the port's S3 gateway, against the JAX
package's, over one port cluster.

The cluster cases of the reference's ``tests/test_s3_select.py`` run on both
gateways (``s3_pair.Stack``, the filers at the reference's 8 KiB chunk size
and ``query_backend="cpu"``), with the reference's own assertions, and the
replies each run received must be equal: the framed event stream byte for
byte, and every error's status and XML. The reference's framing cases
without a cluster are held by ``test_torch_select.py``; its shell ``query``
case is not carried over (the port's shell has no ``query`` yet). Then the
mapping the gateway owes a filer that cannot scan: with the filer's scans
on a card that is not there, SelectObjectContent answers the filer's 500 as
``InternalError`` through both gateways, naming the device.
"""

import pytest

from seaweedfs_tpu.s3api.xml_util import find_text, parse_xml

import s3_pair
from s3_pair import KINDS, Stack

ref = s3_pair.ref_module("test_s3_select")
NOT_CARRIED = ("test_shell_query_command", "test_event_roundtrip_and_crc_detection",
               "test_records_split_at_frame_cap")


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    st = Stack(tmp_path_factory.mktemp("s3select"), ref.IDENTITIES, chunk_size=8 * 1024)
    st.clients = {}
    for kind in KINDS:
        c = st.clients[kind] = ref.S3Client(f"http://{st.apis[kind].url}", "AKIAADMIN",
                                            "adminsecret")
        assert c.create_bucket("sel")[0] == 200
        assert c.put_object("sel", "t.csv", ref.CSV)[0] == 200
        # one scan on each side before any case: the reference's counter
        # case reads what its earlier cases' scans left, and a case may run
        # alone or first on its worker
        assert ref._select_raw(c, "t.csv", ref._req_xml("SELECT * FROM s3object"))[0] == 200
    yield st
    st.stop()


@pytest.mark.parametrize("case", s3_pair.cases(ref, skip=NOT_CARRIED))
def test_reference_case(case, stack):
    got = {}
    for kind in KINDS:
        cluster = {"client": stack.clients[kind], "filer": stack.filers[kind],
                   "master": stack.master, "api": stack.apis[kind]}
        got[kind] = stack.replay(ref, case, kind, cluster=cluster)
    assert got["port"] == got["jax"]


def test_no_card_answers_internal_error(stack, monkeypatch):
    """A filer whose scans run on ``cuda`` with no card answers /_select
    with a 500 naming the device; both gateways map it to InternalError
    (``_err(err.get("error_code") or "InternalError", ...)``)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda scan would run")
    replies = {}
    for kind in KINDS:
        monkeypatch.setattr(stack.filers[kind], "query_backend", "cuda")
        status, body, _ = ref._select_raw(stack.clients[kind], "t.csv",
                                          ref._req_xml("SELECT * FROM s3object"))
        replies[kind] = (status, find_text(parse_xml(body), "Code"),
                         find_text(parse_xml(body), "Message"))
    assert replies["port"] == replies["jax"]
    assert replies["port"][:2] == (500, "InternalError")
    assert "cuda" in replies["port"][2].lower() or "device" in replies["port"][2].lower()
