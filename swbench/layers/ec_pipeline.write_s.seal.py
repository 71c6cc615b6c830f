"""``ec_pipeline.write_s.seal``: the encoder pipeline's shard writes
(``ec.write``), in seconds per cycle: the summed spans under the window's
generate and rebuild server spans over the generates that ended in the
window, from the program's spans (``swbench/spans.py``)."""

from swbench import spans


def read(run):
    return spans.seal_s_per_cycle(run, "ec.write")
