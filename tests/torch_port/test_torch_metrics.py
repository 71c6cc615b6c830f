"""``/metrics`` and ``/ui`` of the port's daemons against the JAX package's.

After the same traffic on both clusters, the families the port exposes and
their label sets are the JAX package's, for the volume server and the
master. The JAX process registry also holds families of subsystems the port
has not got yet (the lock sanitizer, the QoS governor, hedged reads and
deadlines, the lifecycle autopilot, tracing): those are the
only names the port may lack, and the port exposes no name the JAX package
does not. ``/ui`` renders an HTML page on both daemons of the port.
"""

import re

from seaweedfs_tpu_torch.stats.metrics import Gauge, Registry, default_registry
from serving_pair import both, pair, request

# the families of the subsystems the port has: every one of these that the
# JAX page shows, the port's shows too (the JAX process registry also holds
# whatever else its process imported: the lock sanitizer, QoS, hedging,
# deadlines, the lifecycle autopilot, ...)
PORTED = re.compile(r"^(volume_server_|fleet_job_|sweed_(ncache|heat|scrub|query|fleet|sync)_|"
                    r"sweed_serving_(inflight|admission|keepalive|loop_lag|request_p99|"
                    r"reaped|native))")


def _families(text: str) -> dict:
    """{family name: set of label-name tuples} from a Prometheus text page."""
    fams: dict = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            fams.setdefault(line.split()[2], set())
        elif line and not line.startswith("#"):
            m = re.match(r"([a-zA-Z_:][a-zA-Z0-9_:]*)(\{([^}]*)\})? ", line)
            name = re.sub(r"_(bucket|sum|count)$", "", m.group(1))
            labels = tuple(sorted(p.split("=")[0] for p in m.group(3).split(",")
                                  if p)) if m.group(3) else ()
            fams.setdefault(name, set()).add(tuple(x for x in labels if x != "le"))
    return fams


# the port's families that the JAX page lacks on purpose: its master's own
# assign histogram, and where its scans' structural index ran (card / host)
PORT_FAMILIES = {"master_assign_seconds", "sweed_query_index_segments_total"}

# the port's label sets where it departs from the JAX package on purpose:
# its rows decided by the scan's kernels are counted by device, as its
# scans are
PORT_LABELS = {"sweed_query_rows_kernel_total": {("backend",)}}


def _compare(jax_text: str, port_text: str):
    """The port exposes no family the JAX page lacks (``PORT_FAMILIES``
    aside), every ported family the JAX page shows, and the same label sets
    in each (``PORT_LABELS`` aside)."""
    j, p = _families(jax_text), _families(port_text)
    extra = sorted(set(p) - set(j) - PORT_FAMILIES)
    assert extra == [], extra
    missing = sorted(n for n in set(j) - set(p) if PORTED.match(n))
    assert missing == [], missing
    for name in set(p) & set(j):
        # a family with no sample yet shows no label names; the registries
        # are process-wide, so what other tests of this process did counts
        if p[name] and j[name]:
            assert p[name] == PORT_LABELS.get(name, j[name]), (name, p[name], j[name])


def test_volume_and_master_metrics_match_the_reference(tmp_path_factory):
    with pair(tmp_path_factory) as nodes:
        for key in range(1, 6):
            fid = f"3,{key:x}00001234"
            both(nodes, "POST", "/" + fid, b"m" * (100 * key))
            both(nodes, "GET", "/" + fid)
        both(nodes, "GET", "/3,ff00001234")
        # a TTL write and a manifest-control read are proxied to Python, so
        # both daemons' own request histograms have samples too
        both(nodes, "POST", "/3,a00001234?ttl=3m", b"t" * 10)
        both(nodes, "GET", "/3,a00001234?cm=false")
        both(nodes, "DELETE", "/3,100001234")
        both(nodes, "GET", "/status")
        for n in nodes.values():  # an assign, so the master's histogram has data
            request(n.master.url, "GET", "/dir/assign")
        vol = {k: request(n.url, "GET", "/metrics") for k, n in nodes.items()}
        assert vol["port"][0] == vol["jax"][0] == 200
        _compare(vol["jax"][2].decode(), vol["port"][2].decode())
        text = vol["port"][2].decode()
        for fam in ("volume_server_turbo_requests_total", "sweed_serving_inflight",
                    "sweed_ncache_hits_total", "sweed_heat_read",
                    "sweed_scrub_needles_checked_total", "sweed_query_scans_total",
                    "sweed_fleet_jobs_done_total"):
            assert fam in text, fam
        mst = {k: request(n.master.url, "GET", "/metrics") for k, n in nodes.items()}
        assert mst["port"][0] == mst["jax"][0] == 200
        assert dict(mst["port"][1])["Content-Type"] == "text/plain; version=0.0.4"
        _compare(mst["jax"][2].decode(), mst["port"][2].decode())
        assert 'master_assign_seconds_count{op="assign"}' in mst["port"][2].decode()
        # the Python daemon's request counters do not see what the engine
        # served: the engine's tallies say it
        assert 'volume_server_turbo_requests_total{op="post"} 5' in text
        for url in (nodes["port"].url, nodes["port"].master.url):
            st, hdrs, page = request(url, "GET", "/ui")
            assert st == 200 and dict(hdrs)["Content-Type"] == "text/html; charset=utf-8"
            assert page.startswith(b"<!doctype html>") and b"</html>" in page
        page = request(nodes["port"].url, "GET", "/ui")[2]
        assert b"Turbo" in page and b"Volumes" in page
        assert b"Topology" in request(nodes["port"].master.url, "GET", "/ui")[2]


def test_registry_exposition_matches_the_reference_format():
    from seaweedfs_tpu.stats.metrics import Registry as JRegistry

    out = {}
    for name, cls in (("port", Registry), ("jax", JRegistry)):
        reg = cls()
        c = reg.counter("t_requests_total", "requests")
        c.inc(op="get")
        c.inc(2, op="put")
        g = reg.gauge("t_depth", "depth")
        g.set(3, q='a"b')
        g.set_function(lambda: 7.5, q="fn")
        h = reg.histogram("t_seconds", "latency")
        for v in (0.0002, 0.03, 4.0, 11.0):
            h.observe(v, op="get")
        out[name] = reg.expose()
    assert out["port"] == out["jax"]
    assert isinstance(default_registry.gauge("sweed_serving_inflight"), Gauge)
