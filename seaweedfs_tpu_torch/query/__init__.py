"""S3-Select-ish content query engine (reference `weed/server/
volume_grpc_query.go:12` + `weed/query/json`): server-side filtering and
projection of CSV / JSON-lines object content.

Three layers:

* ``engine``: row-at-a-time evaluator; the semantic oracle.
* ``sql``: the SQL front-end, compiling to the engine's filter dicts.
* ``scan``: columnar plans compiling the same filter dicts into a predicate
  tree of tensor ops on the GPU (or on the CPU, for the tests),
  byte-identical to the engine on every input.
"""

from typing import Optional

from ..util.parsers import tolerant_uint
from .engine import run_query  # noqa: F401
from .scan import ScanPlan, compile_plan, get_kernels, run_scan  # noqa: F401
from .sql import SqlError, parse_sql, run_sql  # noqa: F401


def scan_request(chunks, req: dict, backend: Optional[str] = None) -> tuple[int, dict]:
    """Run one query request dict against a byte-chunk stream ->
    (status, payload). ``backend`` picks the plan's device (``cuda`` or
    ``cpu``; None: ``$SWEED_QUERY_BACKEND``, else ``cuda``).

    Output is byte-identical to engine.run_query on the concatenated
    stream."""
    if req.get("sql"):
        try:
            select, where, limit = parse_sql(req["sql"])
        except SqlError as e:
            return 400, {"error": f"bad sql: {e}"}
    else:
        select = req.get("select")
        where = req.get("where")
        # strict ascii-digit parse with negative/garbage clamped to the
        # unlimited default: '+5', ' 5 ' and '-5' must not pick rows by
        # accident (and ?limit=-5 would slice from the tail)
        limit = tolerant_uint(req.get("limit", 0), 0)
    plan = ScanPlan(
        select=select, where=where, limit=limit,
        input_format=req.get("input", "json"), backend=backend,
    )
    rows = [r for batch in plan.scan_iter(chunks) for r in batch]
    return 200, {"rows": rows, "count": len(rows)}


def execute_request(data: bytes, req: dict, backend: Optional[str] = None) -> tuple[int, dict]:
    """Buffered variant of scan_request: the volume server's data-local
    /_query hands in the whole needle's bytes."""
    return scan_request(iter((data,)), req, backend)
