"""``daemon.needle_read_ms.read``: the needle read of ``_h_query``
(``daemon.needle_read``), as the mean self time per query answered in the
window (its span's time less its children's), from the program's spans
(``swbench/spans.py``)."""

from swbench import spans


def read(run):
    return spans.query_self_ms(run, "daemon.needle_read")
