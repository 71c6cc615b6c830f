"""Bucket policies and browser POST policies on the port's S3 gateway,
against the JAX package's, over one port cluster.

Every case of the reference's ``tests/test_s3_policy.py`` runs on both
gateways (``s3_pair.Stack``), with the reference's own assertions; the
port's run uses the port's ``policy_engine`` and ``post_policy`` where the
case calls them directly. The replies each run received must be equal:
status, headers and body bytes, with only ``Date``, ``Last-Modified``,
``X-Sweed-Trace-Id``, timestamps and upload ids left out.
"""

import pytest

import s3_pair
from s3_pair import KINDS, Stack

ref = s3_pair.ref_module("test_s3_policy")


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    st = Stack(tmp_path_factory.mktemp("s3policy"), ref.IDENTITIES)
    yield st
    st.stop()


@pytest.mark.parametrize("case", s3_pair.cases(ref))
def test_reference_case(case, stack):
    got = {}
    for kind in KINDS:
        api = stack.apis[kind]
        admin = ref.S3Client(f"http://{api.url}", "AKIAADMIN", "adminsecret")
        got[kind] = stack.replay(ref, case, kind, s3=api, admin=admin)
    assert got["port"] == got["jax"]
