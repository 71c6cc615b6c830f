"""The port's fsspec adapter (``seaweedfs_tpu_torch.client``) against the JAX
package's, over one port cluster.

Every case of the reference's ``tests/test_client_fsspec.py`` runs with each
package's ``SeaweedFileSystem`` (registered for the ``seaweedfs`` protocol
while its case runs), each over its own port filer of one port master and
volume server (``s3_pair.Stack`` without gateways), with the reference's
own assertions. A file written through one package's adapter reads back
equal, with the same chunk layout, through the other's.
"""

import sys

import pytest

fsspec = pytest.importorskip("fsspec")

import seaweedfs_tpu.client as j_client  # noqa: E402
import seaweedfs_tpu_torch.client as p_client  # noqa: E402
from seaweedfs_tpu_torch.server.filer_server import FilerServer  # noqa: E402
from seaweedfs_tpu_torch.server.http_util import http_json  # noqa: E402

import s3_pair  # noqa: E402
from s3_pair import KINDS, Stack  # noqa: E402

ref = s3_pair.ref_module("test_client_fsspec")
CLIENT = {"jax": j_client, "port": p_client}


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    st = Stack(tmp_path_factory.mktemp("fsspec"), gateways=False)
    yield st
    st.stop()


@pytest.fixture
def registered(request):
    """Put back the JAX package's registration after a case."""
    yield
    j_client.register()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", s3_pair.cases(ref))
def test_reference_case(case, kind, stack, tmp_path, monkeypatch, registered):
    client = CLIENT[kind]
    client.register()
    # the reference's servers are the port's, whichever adapter runs
    monkeypatch.setattr(ref, "FilerServer", FilerServer)
    filer = stack.filers[kind]
    fs = client.SeaweedFileSystem(filer=filer.url, skip_instance_cache=True)
    fn = getattr(ref, case)
    fixtures = {"fs": fs, "cluster": (stack.master, stack.volumes[0], filer),
                "tmp_path": tmp_path}
    fn(**{n: fixtures[n] for n in fn.__code__.co_varnames[:fn.__code__.co_argcount]})


def test_no_fsspec_at_import():
    """Importing the port's client package loads no fsspec: the adapter's
    classes are built on first use."""
    import subprocess

    code = ("import sys; import seaweedfs_tpu_torch.client as c; "
            "assert 'fsspec' not in sys.modules; c.SeaweedFileSystem; "
            "assert 'fsspec' in sys.modules")
    r = subprocess.run([sys.executable, "-c", code], cwd=s3_pair.REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("writer", KINDS)
def test_interchange(stack, writer):
    reader = "port" if writer == "jax" else "jax"
    url = stack.filers["port"].url
    w = CLIENT[writer].SeaweedFileSystem(filer=url, chunk_size=64 * 1024,
                                         skip_instance_cache=True)
    r = CLIENT[reader].SeaweedFileSystem(filer=url, skip_instance_cache=True)
    payload = bytes(range(256)) * 1000 + writer.encode()
    w.pipe_file(f"/xchg/{writer}.bin", payload)
    assert r.cat_file(f"/xchg/{writer}.bin") == payload
    assert r.info(f"/xchg/{writer}.bin") == w.info(f"/xchg/{writer}.bin")
    meta = http_json("GET", f"http://{url}/xchg/{writer}.bin?meta=true")
    assert [c["size"] for c in meta["chunks"]] == [65536] * 3 + [len(payload) - 3 * 65536]
