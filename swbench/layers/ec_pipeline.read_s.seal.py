"""``ec_pipeline.read_s.seal``: the encoder pipeline's reader leg
(``ec.read``), in seconds per cycle: the summed spans under the window's
generate and rebuild server spans over the generates that ended in the
window, from the program's spans (``swbench/spans.py``)."""

from swbench import spans


def read(run):
    return spans.seal_s_per_cycle(run, "ec.read")
