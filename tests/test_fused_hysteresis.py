"""Abort hysteresis of the fused-segment dispatch loop.

An aborted fused segment throws away its whole device dispatch, so after an
abort ``GPLEDriver.run`` probes with ONE-period segments and only restores
the full segment length after two clean passes.  Exactly two distinct
segment lengths may ever be requested -- each distinct length is a separate
XLA program and its own compile.

This scripts ``_advance_fused`` outcomes on a stub driver (no physics) and
asserts the requested (tick, length) sequence.  The reference has no fused
path at all -- its loop is strictly tick-by-tick (main.cpp:135-202).
"""

from types import SimpleNamespace

from gple_tpu.config import GPLEConfig
from gple_tpu.driver import GPLEDriver


class _ScriptedDriver(GPLEDriver):
    """GPLEDriver with all physics stubbed out; only run()'s control flow
    executes.  ``aborts`` maps a start tick to the event tick reported back
    (the fused path's ``fused_block_until``)."""

    def __init__(self, cfg, aborts):
        # deliberately skip GPLEDriver.__init__ (MC selection, GP fits)
        self.cfg = cfg
        self.profile_dir = None
        self.writers = None
        self.verbose = False
        self.history = []
        self.phase_times = {"init": 0.0, "output": 0.0}
        self.opt_result = SimpleNamespace(opt_type="moment")
        self.aborts = dict(aborts)
        self.calls = []
        self._event_ticks = set()

    def _log(self, msg):
        pass

    def initialize(self):
        pass

    def step(self, tick):
        return "none"

    def _advance_chunk(self, n_ticks):
        return True

    def observe(self, tick, opt_type):
        # never trips the leave-region stop (x_average << -x0)
        return SimpleNamespace(time=float(tick), x_average=-1e9)

    def _advance_fused(self, start_tick, n, callback=None):
        self.calls.append((start_tick, n))
        if start_tick in self.aborts:
            return False, self.aborts.pop(start_tick)
        return True, False


def _cfg():
    # dt=1, reopt_time=output_time=5 -> reopt_freq=output_freq=5;
    # fused_chunk=20 -> full segments of 4 periods
    return GPLEConfig(
        model="SAC", mass=2000.0, x0=-10.0, p0=20.0, sigma_p0=1.0,
        output_time=5.0, reopt_time=5.0, dt=1.0, num_points=8,
        fused_chunk=20,
    )


def test_abort_drops_to_one_period_then_restores():
    cfg = _cfg()
    assert cfg.reopt_freq == 5 and cfg.output_freq == 5
    # first full segment aborts on an event at tick 3; the replayed chunked
    # period ends at tick 5, then fused resumes with one-period probes
    drv = _ScriptedDriver(cfg, aborts={1: 3})
    drv.run(max_ticks=55)
    assert drv.calls == [
        (1, 20),   # full segment, aborted (event at tick 3)
        (6, 5),    # probe 1 (clean)
        (11, 5),   # probe 2 (clean) -> restore full length
        (16, 20),
        (36, 20),
    ]


def test_abort_during_probe_keeps_probing():
    cfg = _cfg()
    drv = _ScriptedDriver(cfg, aborts={1: 3, 11: 12})
    drv.run(max_ticks=55)
    assert drv.calls == [
        (1, 20),
        (6, 5),    # clean (streak 1)
        (11, 5),   # aborted -> streak resets, stay at one period
        (16, 5),
        (21, 5),   # two clean probes -> restore
        (26, 20),
        # 46+20-1 > 55: the restored full segment no longer fits, so the
        # tail replays on the chunked path (no further fused calls)
    ]


def test_no_abort_uses_full_segments_only():
    cfg = _cfg()
    drv = _ScriptedDriver(cfg, aborts={})
    drv.run(max_ticks=40)
    assert drv.calls == [(1, 20), (21, 20)]
    # one distinct length -> one XLA program
    assert {n for _, n in drv.calls} == {20}
