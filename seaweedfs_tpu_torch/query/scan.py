"""Vectorized S3-Select scan engine: fused filter+project plans over
uint8 byte batches, with the predicate tree evaluated by PyTorch on the GPU.

``engine.py`` evaluates one document at a time: csv.DictReader, a dict per
row, a Python filter walk per row. This module compiles the same filter
dicts that ``sql.py`` emits into columnar plans: stage bytes -> structural
index -> device batches -> predicate tree -> stream matched rows out.

Pipeline per CSV batch (the columnar format; the one the tree covers):

1. **Staging**: the segment's bytes go to the device once (``stage``).
2. **Structural indexing**: the non-blank rows' bounds and each referenced
   column's ``(start, len, present)`` as ``[fields, 3, rows]``, with each
   batch's field widths. On a CUDA device, for a plan with a tree, the
   hand-written kernel ``csrc/csv_index.cu`` (``csv_index.py``) builds them
   from the staged bytes: one wait for the card a segment, the vectors stay
   there, the rows' bounds come back once. Otherwise (the ``cpu`` backend,
   plans without a tree, bodies past int32) the host does it with numpy
   (``_host_index``, ``_field_vectors``): newline and delimiter positions
   via dense byte compares + ``flatnonzero``/``searchsorted``, and per batch
   one vectors array staged. ``sweed_query_index_segments_total{where}``
   counts which.
3. **Predicate evaluation** on the device: each referenced column becomes a
   ``[rows, width]`` uint8 matrix by one gather from the staged bytes, so
   the byte matrices never exist on the host. The whole WHERE tree (numeric
   compares, equality, lexicographic ordering, contains / starts_with) runs
   as tensor ops, and only two bool masks come back (``to_host``).

Each step runs under a span of its layer (``stats/trace.py``): the
structural index and the field vectors under ``query.index`` (rows,
batch_rows; on the card the kernels and their one wait, and each batch's
rows taken from the copy), the staging, the tree and ``to_host`` under
``query.device`` (bytes staged), and the exact lane and the row building
under ``query.rows`` (rows in and out).

Backends: ``cuda`` (the default) and ``cpu``, the same tensor graph on CPU
tensors, which the tests use. ``$SWEED_QUERY_BACKEND`` overrides the
default. A ``cuda`` plan on a machine without a card raises an error that
names the device; nothing falls back to the CPU.

Byte-identity with ``engine.run_query`` on EVERY input is the contract. The
tree therefore computes a *validity* mask alongside the match mask: any row
whose bytes it cannot decide with engine-exact semantics (quoted CSV fields,
``\\r`` line endings, non-ASCII bytes, numeric strings outside the simple
``-?\\d+(\\.\\d+)?``/15-digit exact-float domain, fields longer than the
width cap, general LIKE patterns) is re-evaluated through
``engine._matches`` in a row-at-a-time exact lane. JSON input takes the
exact lane entirely; a JSON array document degenerates to the engine. The
kernel/fallback split is observable: ``sweed_query_*`` counters in
``stats/metrics.py``.

Exactness notes (why the kernel domain is what it is):

- Numeric parse folds <=15 digits into a float64 mantissa (<= 2^53, every
  intermediate exact, so the sum is exact in any order) and divides by an
  exact power of ten. IEEE division rounds correctly, so the result equals
  ``float(s)``. The divisor is a tensor, never a Python number: PyTorch's
  CUDA division by a host scalar multiplies by its reciprocal, which can be
  off by one bit. Anything float() might also accept ("+5", "1e3", "nan",
  "1_0", padded whitespace) is detected by charset and routed exact.
- UTF-8 is order-preserving, so lexicographic *byte* compare equals
  Python's codepoint compare for valid UTF-8; rows with any byte >= 0x80 go
  exact instead of proving validity.
- A double quote anywhere makes newlines untrustworthy as record breaks, so
  scanning switches to the exact csv parser from the first line containing
  one; records terminated before the first quote stay vectorized.

Device notes: every constant the tree needs (needles, the power-of-ten and
charset tables) goes to the device once when the plan is built, and the
tree never branches on a device value, so a batch's tensor ops queue
without a host sync until its masks are read back.
"""

from __future__ import annotations

import csv
import functools
import io
import json
import os
from typing import Any, Iterable, Iterator, Optional

import numpy as np
import torch

from ..stats import trace as _trace
from ..stats.metrics import QUERY_COUNTERS
from . import csv_index
from . import engine as _engine

_MAX_FIELD_W = 512  # fields longer than this go to the exact lane
_ROW_BATCH = 1 << 17  # rows per device batch
_CMP_OPS = ("=", "!=", "<", "<=", ">", ">=")

# bytes float() could possibly accept somewhere in a number:
# digits, sign/exponent/dot/underscore, inf/nan letters, ascii whitespace
_FLOATISH = np.zeros(256, dtype=bool)
for _b in b"0123456789eE+-._ \t\n\r\x0b\x0cinfatyINFATY":
    _FLOATISH[_b] = True

# exact powers of ten for the <=15-digit mantissa domain
_TEN_POWS = [10.0 ** k for k in range(16)]


def _pow2(n: int) -> int:
    """The field-width bucket: the least power of two >= n, at least 8."""
    v = 8
    while v < n:
        v <<= 1
    return v


def _want_float(want: Any) -> Optional[float]:
    """float(want) under engine._coerce_pair rules (bools are not
    numbers), or None when the engine would fall back to strings."""
    if isinstance(want, bool):
        return None
    try:
        return float(want)
    except (TypeError, ValueError):
        return None


# --------------------------------------------------------------------------
# primitives: mat is a uint8 [rows, width] field matrix, lens its int
# lengths, both on the plan's device
# --------------------------------------------------------------------------


def _colmask(w: int, lens: torch.Tensor) -> torch.Tensor:
    return torch.arange(w, device=lens.device)[None, :] < lens[:, None]


def _ascii_ok(mat, lens):
    return ~((mat >= 128) & _colmask(mat.shape[1], lens)).any(dim=1)


def _numeric(mat, lens, ten_pows, floatish):
    """-> (vals float64, simple, def_not_float): exact float values where
    the field matches the simple-number domain; a proof that float() must
    fail where the charset says so; everything else is neither and belongs
    to the exact lane. ``ten_pows`` (float64[16]) and ``floatish``
    (bool[256]) are the module's tables on the device."""
    n, w = mat.shape
    col = torch.arange(w, device=mat.device)[None, :]
    cm = col < lens[:, None]
    isdig = (mat >= 48) & (mat <= 57) & cm
    isdot = (mat == 46) & cm
    neg = (lens > 0) & (mat[:, 0] == 45)
    body0 = neg.long()
    bodymask = cm & (col >= body0[:, None])
    digits = isdig.sum(dim=1)
    dots = isdot.sum(dim=1)
    pattern = (isdig | isdot | ~bodymask).all(dim=1)
    first_ix = body0.clamp(max=w - 1)
    last_ix = (lens.long() - 1).clamp(min=0)
    first_dig = isdig.gather(1, first_ix[:, None])[:, 0]
    last_dig = isdig.gather(1, last_ix[:, None])[:, 0]
    simple = (
        pattern
        & (dots <= 1)
        & (digits >= 1)
        & (digits <= 15)
        & first_dig
        & last_dig
        & (lens > body0)
    )
    # positional digit sum: weight each digit by 10^(digits to its right).
    # Every term and every partial sum is an integer <= 10^15 < 2^53, so
    # the float64 sum is exact in any order. (No negative-step slice in
    # torch: flip; no bool subtraction: long.)
    dig = isdig.long()
    right = torch.flip(torch.flip(dig, [1]).cumsum(dim=1), [1]) - dig
    weight = ten_pows[right.clamp(0, 15)]
    digval = torch.where(isdig, (mat & 0x0F).double(), 0.0)
    val = (digval * weight).sum(dim=1)
    # argmax takes no bool, and returns the FIRST maximal index
    dotpos = isdot.to(torch.uint8).argmax(dim=1)
    frac = torch.where(dots > 0, lens - 1 - dotpos, 0)
    scale = ten_pows[frac.clamp(0, 15)]
    vals = torch.where(neg, -val, val) / scale  # tensor divisor: IEEE division
    # a uint8 index would be read as a mask: index the table with int64
    charset_ok = floatish[mat.long()] | ~cm
    def_not_float = (lens == 0) | ~charset_ok.all(dim=1)
    return vals, simple, def_not_float


def _eq_bytes(mat, lens, needle):
    m = needle.numel()
    if m > mat.shape[1]:
        return torch.zeros(mat.shape[0], dtype=torch.bool, device=mat.device)
    return (lens == m) & (mat[:, :m] == needle[None, :]).all(dim=1)


def _lex_lt_eq(mat, lens, needle):
    """(field < needle, field == needle) by byte order: equals Python str
    ordering for valid UTF-8 on both sides."""
    m = needle.numel()
    n, w = mat.shape
    if m == 0:
        return torch.zeros(n, dtype=torch.bool, device=mat.device), lens == 0
    L = min(w, m)
    needle = needle[:L]
    validj = torch.arange(L, device=mat.device)[None, :] < lens.clamp(max=m)[:, None]
    mm = validj & (mat[:, :L] != needle[None, :])
    has = mm.any(dim=1)
    ix = mm.to(torch.uint8).argmax(dim=1)  # the first mismatch
    fb = mat[:, :L].gather(1, ix[:, None])[:, 0]
    lt = torch.where(has, fb < needle[ix], lens < m)
    eq = ~has & (lens == m)
    return lt, eq


def _prefix(mat, lens, needle):
    m = needle.numel()
    if m > mat.shape[1]:
        return torch.zeros(mat.shape[0], dtype=torch.bool, device=mat.device)
    return (lens >= m) & (mat[:, :m] == needle[None, :]).all(dim=1)


def _substr(mat, lens, nb: bytes):
    """Does the field contain ``nb``? hit[r, o] starts as "the field reaches
    offset o + m" and is ANDed with one byte compare per needle byte, so
    the passes number m (not w - m + 1) and the largest intermediate is
    [rows, w - m + 1]."""
    m = len(nb)
    n, w = mat.shape
    if m > w:
        return torch.zeros(n, dtype=torch.bool, device=mat.device)
    offs = w - m + 1
    hit = lens[:, None] >= torch.arange(m, w + 1, device=mat.device)[None, :]
    for j, b in enumerate(nb):
        hit &= mat[:, j: j + offs] == b
    return hit.any(dim=1)


# --------------------------------------------------------------------------
# predicate-tree compiler: filter dict -> fn(env, n) -> (match, valid), env
# holding one (mat, lens, present) per referenced field
# --------------------------------------------------------------------------


def _build_node(flt, index, kern):
    dev = kern.device

    def ones(n):
        return torch.ones(n, dtype=torch.bool, device=dev)

    if not flt:
        return lambda env, n: (ones(n), ones(n))
    # key precedence mirrors engine._matches exactly
    if "and" in flt:
        kids = [_build_node(f, index, kern) for f in flt["and"]]

        def f_and(env, n):
            if not kids:
                return ones(n), ones(n)
            ms, vs = zip(*[k(env, n) for k in kids])
            all_valid = vs[0]
            definite_false = vs[0] & ~ms[0]
            match = ms[0]
            for mm, vv in zip(ms[1:], vs[1:]):
                all_valid = all_valid & vv
                definite_false = definite_false | (vv & ~mm)
                match = match & mm
            return match & all_valid, all_valid | definite_false

        return f_and
    if "or" in flt:
        kids = [_build_node(f, index, kern) for f in flt["or"]]

        def f_or(env, n):
            if not kids:
                return torch.zeros(n, dtype=torch.bool, device=dev), ones(n)
            ms, vs = zip(*[k(env, n) for k in kids])
            all_valid = vs[0]
            definite_true = vs[0] & ms[0]
            for mm, vv in zip(ms[1:], vs[1:]):
                all_valid = all_valid & vv
                definite_true = definite_true | (vv & mm)
            return definite_true, all_valid | definite_true

        return f_or
    if "not" in flt:
        kid = _build_node(flt["not"], index, kern)

        def f_not(env, n):
            mm, vv = kid(env, n)
            return ~mm & vv, vv

        return f_not
    return _build_leaf(flt, index, kern)


def _build_leaf(flt, index, kern):
    op = flt.get("op", "=")
    field = flt.get("field", "")
    want = flt.get("value")
    fi = index[field]

    if op in ("contains", "starts_with"):
        wb = str(want or "").encode("utf-8")
        if not wb:
            # '' is a substring/prefix of everything, missing fields
            # included (str(got or "") == "")
            return lambda env, n: (
                torch.ones(n, dtype=torch.bool, device=kern.device),
                torch.ones(n, dtype=torch.bool, device=kern.device),
            )
        needle = kern.needle(wb)

        def f_str(env, n):
            mat, lens, present = env[fi]
            hit = _substr(mat, lens, wb) if op == "contains" else _prefix(mat, lens, needle)
            # missing rows have lens 0 -> no match for a nonempty needle,
            # which is definitive; high-byte rows go exact
            return hit, _ascii_ok(mat, lens) | ~present

        return f_str

    if op in _CMP_OPS:
        wf = _want_float(want)
        needle = kern.needle(str(want).encode("utf-8"))

        def str_cmp(mat, lens):
            # =/!= only need byte equality; the first-difference compare
            # (argmax + gather) is for the orderings
            if op in ("=", "!="):
                eq = _eq_bytes(mat, lens, needle)
                return eq if op == "=" else ~eq
            lt, eq = _lex_lt_eq(mat, lens, needle)
            return _pick_cmp(op, lt, eq)

        def f_cmp(env, n):
            mat, lens, present = env[fi]
            ascii_ok = _ascii_ok(mat, lens)
            if wf is None:
                return str_cmp(mat, lens) & present, ascii_ok | ~present
            vals, simple, not_float = _numeric(mat, lens, kern.ten_pows, kern.floatish)
            # string-compare rows (engine: float(got) raised, str-vs-str
            # ordering applies) are the valid & ~simple & present ones. The
            # reference skips the string compare when a batch has none (a
            # device-side cond); here it always runs and where() takes it:
            # a branch on the device's answer would sync the host per leaf.
            # On rows that are neither simple nor valid the two differ, and
            # no caller reads match where valid is false.
            match = torch.where(simple, _num_cmp(op, vals, wf), str_cmp(mat, lens))
            valid = simple | (not_float & ascii_ok)
            # engine: got is None -> False before any coercion
            return match & present, valid | ~present

        return f_cmp

    # "like" and unknown ops: every PRESENT row goes to the exact lane
    # (engine raises ValueError there for unknown ops, exactly as run_query
    # would); missing rows are a definitive False, since the engine's
    # `got is None` check fires before op dispatch.
    def f_exact(env, n):
        _, _, present = env[fi]
        return torch.zeros(n, dtype=torch.bool, device=kern.device), ~present

    return f_exact


def _pick_cmp(op, lt, eq):
    if op == "=":
        return eq
    if op == "!=":
        return ~eq
    if op == "<":
        return lt
    if op == "<=":
        return lt | eq
    if op == ">":
        return ~(lt | eq)
    return ~lt  # >=


def _num_cmp(op, vals, wf):
    if op == "=":
        return vals == wf
    if op == "!=":
        return vals != wf
    if op == "<":
        return vals < wf
    if op == "<=":
        return vals <= wf
    if op == ">":
        return vals > wf
    return vals >= wf


def _leaf_fields(flt, out):
    if not flt:
        return out
    if "and" in flt:
        for f in flt["and"]:
            _leaf_fields(f, out)
    elif "or" in flt:
        for f in flt["or"]:
            _leaf_fields(f, out)
    elif "not" in flt:
        _leaf_fields(flt["not"], out)
    else:
        out.append(flt.get("field", ""))
    return out


# --------------------------------------------------------------------------
# backend
# --------------------------------------------------------------------------


class TorchKernels:
    """Runs a plan's predicate tree on one device: ``cuda``, or ``cpu``
    (the same tensor graph on CPU tensors: the plain version the tests
    use). ``sweed_query_rows_kernel_total`` counts the rows its tree
    decided, by device name (``backend``)."""

    def __init__(self, device: str):
        if device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "query backend 'cuda': no CUDA device (torch.cuda.is_available() "
                "is false); pass backend='cpu' for the plain PyTorch version")
        self.name = device
        self.device = torch.device(device)
        self.ten_pows = torch.tensor(_TEN_POWS, dtype=torch.float64, device=self.device)
        self.floatish = torch.from_numpy(_FLOATISH).to(self.device)

    def needle(self, nb: bytes) -> torch.Tensor:
        """A byte string the tree compares against, on the device."""
        return torch.tensor(list(nb), dtype=torch.uint8, device=self.device)

    def stage(self, buf: np.ndarray) -> torch.Tensor:
        """Copy a host array (a segment's padded bytes, a batch's field
        vectors) to the device."""
        return torch.from_numpy(buf).to(self.device)

    def evaluate(self, tree, pad, vecs, widths) -> torch.Tensor:
        """One batch through the tree -> bool [2, rows]: match, valid."""
        return torch.stack(tree(pad, vecs, widths))

    def to_host(self, x: torch.Tensor) -> np.ndarray:
        return x.cpu().numpy()


_BACKENDS = ("cuda", "cpu")


def get_kernels(backend: Optional[str] = None) -> TorchKernels:
    """SWEED_QUERY_BACKEND=cuda|cpu overrides; the default is cuda, with no
    fallback when there is no card."""
    if backend is None:
        backend = os.environ.get("SWEED_QUERY_BACKEND", "")
    backend = (backend or "").strip().lower() or "cuda"
    if backend not in _BACKENDS:
        raise ValueError(
            f"unknown query backend {backend!r} (want one of {sorted(_BACKENDS)})")
    return TorchKernels(backend)


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------


class ScanPlan:
    """One compiled filter+project plan. Thread-compatible, not
    thread-safe: run one scan at a time per plan (each daemon request
    builds its own; building is cheap next to the scan)."""

    def __init__(
        self,
        select: Optional[list] = None,
        where: Optional[dict] = None,
        limit: int = 0,
        input_format: str = "json",
        backend: Optional[str] = None,
    ):
        self.select = select
        self.where = where
        self.limit = int(limit or 0)
        self.input_format = input_format
        self.kernels = get_kernels(backend)
        self.stats = {"rows_scanned": 0, "rows_kernel": 0,
                      "rows_fallback": 0, "bytes_scanned": 0}
        self._fields = sorted(set(_leaf_fields(where, [])))
        self._index = {f: i for i, f in enumerate(self._fields)}
        # select-list columns need spans for projection but no field matrices
        self._proj_fields = (
            list(dict.fromkeys(select))
            if select and select != ["*"] else None
        )
        if self._fields and input_format == "csv":
            node = _build_node(where, self._index, self.kernels)

            def tree(pad, vecs, widths):
                # field gather on the device: row r of the [len - w + 1, w]
                # window view is pad[r : r + w], so one index_select of the
                # starts builds the [rows, w] matrix
                env = [
                    (pad.unfold(0, w, 1).index_select(0, vecs[f, 0]), vecs[f, 1],
                     vecs[f, 2] != 0)
                    for f, w in enumerate(widths)
                ]
                return node(env, vecs.shape[2])

            self._tree = tree
        else:
            self._tree = None

    # -- public API ---------------------------------------------------------

    def execute(self, data: bytes) -> list[dict]:
        """Byte-identical to engine.run_query(data, ...) for this plan."""
        out: list[dict] = []
        for batch in self.scan_iter(iter((data,))):
            out.extend(batch)
        return out

    def scan_iter(self, chunks: Iterable[bytes]) -> Iterator[list[dict]]:
        """Streaming core: consume byte chunks (any split points), yield
        batches of matched+projected rows. Stops consuming as soon as the
        LIMIT is reached, so a prefetching producer gets closed early
        instead of staging the whole object."""
        self.stats = {"rows_scanned": 0, "rows_kernel": 0,
                      "rows_fallback": 0, "bytes_scanned": 0}
        QUERY_COUNTERS["scans"].inc(backend=self.kernels.name)
        if self.input_format == "csv":
            yield from self._scan_csv(chunks)
        else:
            yield from self._scan_json(chunks)

    # -- CSV ----------------------------------------------------------------

    def _scan_csv(self, chunks) -> Iterator[list[dict]]:
        emitted = 0
        header: Optional[list] = None
        carry = b""
        exact_tail: list[bytes] = []  # doc-mode remainder (quotes / \r)
        done = False

        def room() -> int:
            return (self.limit - emitted) if self.limit else -1

        for chunk in chunks:
            self._count_bytes(len(chunk))
            if exact_tail:
                exact_tail.append(chunk)
                continue
            data = carry + chunk if carry else chunk
            cut = data.rfind(b"\n")
            if cut < 0:
                carry = data
                continue
            seg, carry = data[: cut + 1], data[cut + 1:]
            header, rows, tail = self._csv_segment(seg, header, room())
            if rows:
                emitted += len(rows)
                yield rows
                if self.limit and emitted >= self.limit:
                    # break now, not at the top of the next iteration: the
                    # for-loop would pull (and discard) one more chunk from
                    # the source, skewing upstream byte counters
                    done = True
                    break
            if tail is not None:
                exact_tail.append(tail)
                if carry:
                    # keep byte order: the unterminated carry precedes any
                    # chunks appended on later iterations
                    exact_tail.append(carry)
                    carry = b""
        if done:
            return
        if exact_tail:
            exact_tail.append(carry)
            rows = self._csv_exact(b"".join(exact_tail), header, room())
            if rows:
                yield rows
            return
        if carry:
            # final unterminated line
            header, rows, tail = self._csv_segment(carry, header, room())
            if tail is not None:
                rows = rows + self._csv_exact(tail, header, room() - len(rows)
                                              if self.limit else -1)
            if rows:
                yield rows

    def _count_bytes(self, n: int) -> None:
        self.stats["bytes_scanned"] += n
        QUERY_COUNTERS["bytes"].inc(n)

    def _count_rows(self, kernel: int, fallback: int) -> None:
        self.stats["rows_scanned"] += kernel + fallback
        self.stats["rows_kernel"] += kernel
        self.stats["rows_fallback"] += fallback
        if kernel:
            QUERY_COUNTERS["rows"].inc(kernel)
            QUERY_COUNTERS["kernel"].inc(kernel, backend=self.kernels.name)
        if fallback:
            QUERY_COUNTERS["rows"].inc(fallback)
            QUERY_COUNTERS["fallback"].inc(fallback)

    def _csv_segment(self, seg, header, room):
        """Vectorized scan of one run of complete lines. Returns (header,
        matched_rows, exact_tail_bytes_or_None); the tail is everything from
        the first line containing a quote or CR onward, bytes the newline
        index cannot be trusted for. Byte accounting happens once per
        incoming chunk in _scan_csv, not here. The body (``seg`` past the
        header) is a view: rows are decoded from it one by one."""
        tail = None
        rows: list[dict] = []
        with _trace.start_span("query.index", service="query") as ix:
            q1, q2 = seg.find(b'"'), seg.find(b"\r")
            q = min(x for x in (q1, q2) if x >= 0) if max(q1, q2) >= 0 else -1
            if q >= 0:
                ls = seg.rfind(b"\n", 0, q) + 1
                seg, tail = seg[:ls], seg[ls:]
            consumed = 0
            if header is None and seg:
                nl = seg.find(b"\n")
                first = seg if nl < 0 else seg[:nl]
                consumed = len(seg) if nl < 0 else nl + 1
                got = list(csv.reader([first.decode("utf-8", errors="replace")]))
                header = got[0] if got else []
            if header is None:
                # no complete line yet and a quote in the header region
                return header, rows, tail
            body = memoryview(seg)[consumed:]
            if not body:
                return header, rows, tail
            arr = np.frombuffer(seg, np.uint8, offset=consumed)
            on_card = self._indexes_on_card(len(arr))
            if not on_card:
                starts, ends, commas, ci0, ci1 = self._host_index(arr, header)
                if ix is not None:
                    ix.tags.update(rows=len(starts), bytes=len(arr))
        QUERY_COUNTERS["index_segments"].inc(where="card" if on_card else "host")
        staged = None
        if self._tree is not None:
            with _trace.start_span("query.device", service="query") as dv:
                # pad once so field gathers need no per-batch clamping: any
                # in-bounds span plus the width overhang lands in the pad.
                # Only the overhang window needs zeroing: every read past a
                # field's length is masked by lens/colmask
                pad = np.empty(len(arr) + _MAX_FIELD_W + 8, dtype=np.uint8)
                pad[: len(arr)] = arr
                pad[len(arr):] = 0
                staged = self.kernels.stage(pad)
                if dv is not None:
                    dv.tags["bytes"] = pad.nbytes
        if on_card:
            with _trace.start_span("query.index", service="query") as ix:
                index = self._card_index(staged, len(arr), header)
                if ix is not None:
                    ix.tags.update(rows=index.nrows, bytes=len(arr))
            nrows = index.nrows
        else:
            nrows = len(starts)
        for b, lo in enumerate(range(0, nrows, _ROW_BATCH)):
            if room >= 0 and len(rows) >= room:
                break
            hi = min(lo + _ROW_BATCH, nrows)
            vecs = widths = None
            with _trace.start_span("query.index", service="query") as ix:
                if on_card:
                    # the vectors stay on the card; the rows' bounds are
                    # read after the masks, whose wait covers their copy
                    vecs = index.vecs[:, :, lo:hi]
                    widths = tuple(_pow2(min(int(w), _MAX_FIELD_W) or 1)
                                   for w in index.widths[b])
                    bounds = functools.partial(index.rows, lo, hi)
                else:
                    exact = np.zeros(hi - lo, dtype=bool)
                    if self._tree is not None:
                        vecs, widths = self._field_vectors(starts[lo:hi], ends[lo:hi], commas,
                                                           ci0[lo:hi], ci1[lo:hi], header,
                                                           exact)
                    bounds = functools.partial(tuple, (starts[lo:hi], ends[lo:hi], exact))
                if ix is not None:
                    ix.tags["batch_rows"] = hi - lo
            rows.extend(self._csv_batch(body, staged, vecs, widths, bounds, header,
                                        -1 if room < 0 else room - len(rows)))
        return header, rows, tail

    def _indexes_on_card(self, n: int) -> bool:
        """Does the card index a body of ``n`` bytes? Yes for a plan with a
        tree on a CUDA device (the body is staged there for the tree
        anyway) whose offsets fit the kernel's int32 and whose fields its
        parameter block holds. Tree-less plans need only the newline pass
        and stage nothing; the ``cpu`` backend runs the numpy index."""
        return (self._tree is not None and self.kernels.device.type == "cuda"
                and n <= csv_index.MAX_BYTES and len(self._fields) <= csv_index.MAX_FIELDS)

    def _card_index(self, staged, n, header) -> csv_index.CardIndex:
        """The card's index of the staged body's first ``n`` bytes."""
        return csv_index.index(staged, n, self._columns(header), _ROW_BATCH)

    def _columns(self, header) -> list[int]:
        """Each referenced field's header column under last-dup header
        semantics (DictReader's dict(zip(...))), -1 where the header lacks
        it (or the name is dotted: CSV fields are never nested)."""
        return [len(header) - 1 - header[::-1].index(f) if "." not in f and f in header else -1
                for f in self._fields]

    def _host_index(self, arr, header):
        """The numpy index of a body: the non-blank rows' starts and ends,
        and with a tree the comma positions and each row's first and
        one-past-last comma index (ci0, ci1), for ``_field_vectors``."""
        idt = np.int32 if len(arr) < 2**31 - 2 * _MAX_FIELD_W else np.int64
        nls = np.flatnonzero(arr == 10).astype(idt)
        starts = np.empty(len(nls) + 1, dtype=idt)
        starts[0] = 0
        np.add(nls, 1, out=starts[1:])
        ends = np.empty(len(nls) + 1, dtype=idt)
        ends[: len(nls)] = nls
        ends[-1] = len(arr)
        keep = ends > starts  # DictReader skips blank rows
        allkeep = bool(keep.all())
        if self._tree is not None:
            # sentinel commas (== len(arr), pointing at the pad) make
            # out-of-row column indices safe without clamping
            nsent = len(header) + 2
            real = np.flatnonzero(arr == 44)
            commas = np.empty(len(real) + nsent, dtype=idt)
            commas[: len(real)] = real
            commas[len(real):] = len(arr)
            # first-comma index per line, once per segment: the gap
            # between a line's end and the next line's start is just the
            # newline byte, so ci1 is ci0 shifted
            ci0 = np.searchsorted(commas[: len(real)], starts).astype(idt)
            ci1 = np.empty_like(ci0)
            ci1[:-1] = ci0[1:]
            ci1[-1] = len(real)
            if not allkeep:
                ci0, ci1 = ci0[keep], ci1[keep]
        else:
            commas, ci0, ci1 = None, None, None
        if not allkeep:
            starts, ends = starts[keep], ends[keep]
        return starts, ends, commas, ci0, ci1

    def _field_vectors(self, starts, ends, commas, ci0, ci1, header, exact):
        """-> (vecs [fields, 3, rows] of (start, len, present), widths): each
        referenced column under last-dup header semantics (DictReader
        dict(zip(...)) + restval fill). Non-present rows keep
        garbage-but-in-pad starts and length 0; the tree masks by both.
        Rows with a field over the width cap are marked in ``exact``."""
        n = len(starts)
        ncols = (ci1 - ci0) + 1
        vecs = np.zeros((len(self._fields), 3, n), dtype=starts.dtype)
        widths = []
        for i, c in enumerate(self._columns(header)):
            if c >= 0:
                present = c < ncols
                fs = starts if c == 0 else commas[ci0 + c - 1] + 1
                fe = np.where(c < ncols - 1, commas[ci0 + c], ends)
                fl = np.where(present, fe - fs, 0)
                too_long = fl > _MAX_FIELD_W
                if too_long.any():
                    exact |= too_long & present
                    fl = np.where(too_long, 0, fl)
                    present = present & ~too_long
                vecs[i, 0], vecs[i, 1], vecs[i, 2] = fs, fl, present
            widths.append(_pow2(min(int(vecs[i, 1].max()), _MAX_FIELD_W) or 1))
        return vecs, tuple(widths)

    def _csv_batch(self, body, staged, vecs, widths, bounds, header, room):
        """One batch of a segment: the tree over its field vectors (host
        arrays are staged first; the card's index leaves them on the card),
        then its rows. ``bounds()`` gives the batch's (starts, ends, exact)."""
        masks = None
        if self._tree is not None:
            with _trace.start_span("query.device", service="query") as dv:
                if isinstance(vecs, np.ndarray):
                    if dv is not None:
                        dv.tags["bytes"] = vecs.nbytes
                    vecs = self.kernels.stage(vecs)
                masks = self.kernels.to_host(self.kernels.evaluate(
                    self._tree, staged, vecs, widths))
        with _trace.start_span("query.rows", service="query") as rs:
            starts, ends, exact = bounds()
            out = self._batch_rows(body, starts, ends, header, room, exact, masks)
            if rs is not None:
                rs.tags.update(rows_in=len(starts), rows_out=len(out))
        return out

    def _batch_rows(self, body, starts, ends, header, room, exact, masks):
        """The rows of one batch that the WHERE keeps, projected: the tree's
        masks where it decided, the exact lane where it did not."""
        n = len(starts)
        if masks is not None:
            match, valid = masks[0], masks[1]
            sel = match & valid & ~exact
            exact |= ~valid
        elif self.where:
            # filter references no fields at all ({"and": []} ...): its
            # value is document-independent
            sel = np.full(n, _engine._matches({}, self.where))
        else:
            sel = np.ones(n, dtype=bool)

        need_exact = np.flatnonzero(exact)
        if len(need_exact):
            sel = sel.copy()
            for i in need_exact:
                doc = self._csv_doc(body, int(starts[i]), int(ends[i]), header)
                sel[i] = _engine._matches(doc, self.where)
        self._count_rows(n - len(need_exact), len(need_exact))

        proj_cols = None
        if self._proj_fields is not None:
            proj_cols = [
                (f,
                 len(header) - 1 - header[::-1].index(f)
                 if "." not in f and f in header else -1)
                for f in self._proj_fields
            ]
        out = []
        for i in np.flatnonzero(sel):
            if room >= 0 and len(out) >= room:
                break
            if proj_cols is not None:
                fields = str(body[int(starts[i]): int(ends[i])], "utf-8",
                             "replace").split(",")
                # value = col if the row reaches the column's LAST dup
                # index, else None: exactly DictReader's zip + restval
                # overwrite behavior
                out.append({
                    f: fields[c] if 0 <= c < len(fields) else None
                    for f, c in proj_cols
                })
            else:
                out.append(
                    self._csv_doc(body, int(starts[i]), int(ends[i]), header)
                )
        return out

    @staticmethod
    def _csv_doc(body, s, e, header):
        """Replicate DictReader's dict building for one quote-free line
        (restkey None for long rows, restval None fill for short, and the
        fill OVERWRITES duplicated trailing names, same as the stdlib)."""
        fields = str(body[s:e], "utf-8", "replace").split(",")
        d = dict(zip(header, fields))
        lf, lr = len(header), len(fields)
        if lf < lr:
            d[None] = fields[lf:]
        elif lf > lr:
            for key in header[lr:]:
                d[key] = None
        return d

    def _csv_exact(self, data, header, room) -> list[dict]:
        """Exact lane for quoted / CR-bearing regions: the stdlib csv parser
        resumed at a record boundary with the header captured by the
        vectorized prefix."""
        with _trace.start_span("query.rows", service="query") as rs:
            text = data.decode("utf-8", errors="replace")
            if header is None:
                reader = csv.DictReader(io.StringIO(text))
            else:
                reader = csv.DictReader(io.StringIO(text), fieldnames=header)
            out = []
            nrows = 0
            for doc in reader:
                nrows += 1
                if _engine._matches(doc, self.where):
                    out.append(_engine._project(doc, self.select))
                    if room >= 0 and len(out) >= room:
                        break
            self._count_rows(0, nrows)
            if rs is not None:
                rs.tags.update(rows_in=nrows, rows_out=len(out))
        return out

    # -- JSON ---------------------------------------------------------------

    def _scan_json(self, chunks) -> Iterator[list[dict]]:
        """JSON-lines stream through the exact lane (structural newline
        segmentation is the only vectorizable part); a JSON array document
        buffers and degenerates to the engine."""
        emitted = 0
        carry = b""
        mode = None  # None -> undecided, "lines", "doc"
        doc_buf: list[bytes] = []
        for chunk in chunks:
            self._count_bytes(len(chunk))
            if mode == "doc":
                doc_buf.append(chunk)
                continue
            carry += chunk
            if mode is None:
                probe = carry.decode("utf-8", errors="replace").lstrip()
                if not probe:
                    continue  # pure whitespace so far; keep buffering
                mode = "doc" if probe.startswith("[") else "lines"
                if mode == "doc":
                    doc_buf.append(carry)
                    carry = b""
                    continue
            cut = carry.rfind(b"\n")
            if cut < 0:
                continue
            seg, carry = carry[: cut + 1], carry[cut + 1:]
            rows, emitted = self._json_lines(seg, emitted)
            if rows:
                yield rows
            if self.limit and emitted >= self.limit:
                return
        if mode == "doc":
            data = b"".join(doc_buf)
            docs = list(_engine._iter_docs(data, "json"))
            self._count_rows(0, len(docs))
            out = []
            for doc in docs:
                if _engine._matches(doc, self.where):
                    out.append(_engine._project(doc, self.select))
                    if self.limit and len(out) >= self.limit:
                        break
            if out:
                yield out
        elif carry:
            rows, emitted = self._json_lines(carry, emitted)
            if rows:
                yield rows

    def _json_lines(self, seg: bytes, emitted: int):
        out = []
        nrows = 0
        for line in seg.decode("utf-8", errors="replace").splitlines():
            line = line.strip()
            if not line:
                continue
            doc = json.loads(line)
            nrows += 1
            if _engine._matches(doc, self.where):
                out.append(_engine._project(doc, self.select))
                emitted += 1
                if self.limit and emitted >= self.limit:
                    break
        self._count_rows(0, nrows)
        return out, emitted


def compile_plan(
    select: Optional[list] = None,
    where: Optional[dict] = None,
    limit: int = 0,
    input_format: str = "json",
    backend: Optional[str] = None,
) -> ScanPlan:
    return ScanPlan(select, where, limit, input_format, backend)


def run_scan(
    data: bytes,
    input_format: str = "json",
    select: Optional[list] = None,
    where: Optional[dict] = None,
    limit: int = 0,
    backend: Optional[str] = None,
) -> list[dict]:
    """Drop-in vectorized twin of engine.run_query."""
    return compile_plan(select, where, limit, input_format, backend).execute(data)
