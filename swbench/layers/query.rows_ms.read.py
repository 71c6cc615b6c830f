"""``query.rows_ms.read``: the exact lane and the row building or projection
(``query.rows``), as the mean self time per query answered in the window
(its span's time less its children's), from the program's spans
(``swbench/spans.py``)."""

from swbench import spans


def read(run):
    return spans.query_self_ms(run, "query.rows")
