"""``daemon.reply_ms.read``: the encoding and writing of the JSON reply
(``daemon.reply``), as the mean self time per query answered in the window
(its span's time less its children's), from the program's spans
(``swbench/spans.py``)."""

from swbench import spans


def read(run):
    return spans.query_self_ms(run, "daemon.reply")
