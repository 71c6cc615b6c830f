"""``engine.proxy_wait_ms.read``: the mean time, per query answered in the
window, from the native engine's stamp on a ``/_query`` it proxies
(``X-Sweed-Engine-Ns``, set when its proxy began) to the start of the
daemon's server span of it: the wait behind the engine's proxy, from the
program's spans (``swbench/spans.py``)."""

from swbench import spans


def read(run):
    return spans.proxy_wait_ms(run)
