"""``SWEED_HEAT_HALFLIFE`` in the port's heat counters, held against the JAX
package's.

Both packages read the variable once, at import, through
``tolerant_ufloat``: garbage, negative, non-finite and zero values keep the
60 s default. Each case loads a fresh copy of both ``stats/heat.py`` modules
with the variable set, runs the same marks on the same fake clock, and
requires the same half-life and the same decayed value.
"""

import importlib.util
import math
import os

import pytest

import seaweedfs_tpu.stats.heat as j_heat
import seaweedfs_tpu_torch.stats.heat as p_heat
from seaweedfs_tpu.util.parsers import tolerant_ufloat as j_tolerant_ufloat
from seaweedfs_tpu_torch.util.parsers import tolerant_ufloat


class FakeClock:
    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


def _fresh(module, monkeypatch, clock):
    """A new copy of ``module`` (its import-time constants read again), in
    the module's package so that its relative imports resolve."""
    name = module.__name__ + "_probe"
    spec = importlib.util.spec_from_file_location(name, module.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "time", clock)
    return mod


@pytest.mark.parametrize("raw,halflife", [
    ("30", 30.0), ("2.5", 2.5), ("600", 600.0), (None, 60.0), ("", 60.0),
    ("garbage", 60.0), ("-5", 60.0), ("nan", 60.0), ("inf", 60.0),
    ("0", 60.0),
])
def test_halflife_env_matches_reference(raw, halflife, monkeypatch):
    if raw is None:
        monkeypatch.delenv("SWEED_HEAT_HALFLIFE", raising=False)
    else:
        monkeypatch.setenv("SWEED_HEAT_HALFLIFE", raw)
    clock = FakeClock()
    mods = [_fresh(m, monkeypatch, clock) for m in (j_heat, p_heat)]
    assert [m.HEAT_HALFLIFE_SECONDS for m in mods] == [halflife, halflife]
    heats = [m.EwmaHeat() for m in mods]
    for h in heats:
        assert h.halflife == halflife
    for dt, n in [(0.0, 4.0), (1.5, 1.0), (halflife, 2.0), (0.25, 1.0)]:
        clock.now += dt
        for h in heats:
            h.mark(n)
    clock.now += 2 * halflife
    want, got = (h.value() for h in heats)
    assert got == want
    # the decay the half-life names: 8.0 marked now weighs 2.0 two half-lives on
    assert math.isclose(got, (((4.0 * 0.5 ** (1.5 / halflife) + 1.0) * 0.5 + 2.0)
                              * 0.5 ** (0.25 / halflife) + 1.0) * 0.25)


@pytest.mark.parametrize("raw", [
    "1", "0", "0.5", "-1", "nan", "-inf", "inf", "1e3", " 7 ", "x", "", None, 3, -2.0,
])
def test_tolerant_ufloat_matches_reference(raw):
    assert tolerant_ufloat(raw, 9.5) == j_tolerant_ufloat(raw, 9.5)


def test_default_module_reads_the_environment_at_import():
    want = j_tolerant_ufloat(os.environ.get("SWEED_HEAT_HALFLIFE", ""), 60.0) or 60.0
    assert p_heat.HEAT_HALFLIFE_SECONDS == want == j_heat.HEAT_HALFLIFE_SECONDS
