"""The readers of the port's span log (``utils.profiling.DEFAULT_TIMERS``):
their arithmetic on a fabricated log of two global BAs, with spans of
other requests beside them, which the readers leave out."""

import pytest

from portbench import harness

READERS = ("gba_assemble_ms", "gba_transfer_ms", "gba_apply_ms",
           "lm_linearize_ms", "lm_schur_ms", "lm_update_ms", "pcg_iter_ms")
TRACE = dict(busy_s=4.0, window_s=5.0, launches=1, kernels={})


def _reader(name):
    return harness.load_module(harness.data_path("metrics", f"{name}.py"),
                               "span_" + name)


class _Log:
    """Builds spans: ``add(name, parent, host_ms, device_ms, counts)``;
    a span without a parent starts a request."""

    def __init__(self, timers_cls, span_cls):
        self.timers = timers_cls()
        self.span = span_cls
        self.next_id = 1

    def add(self, name, parent=None, host_ms=0.0, device_ms=None, **counts):
        sid = self.next_id
        self.next_id += 1
        s = self.span(name, sid, None if parent is None else parent.id,
                      sid if parent is None else parent.request, self.timers)
        s.t0, s.t1 = 10.0, 10.0 + host_ms / 1e3
        s.device_ms = device_ms
        s.counts = {k.replace("__", "/"): v for k, v in counts.items()}
        self.timers.spans.append(s)
        return s


def _gba(log, lin, schur, upd, loop, steps=2):
    """One gba/call with ``steps`` LM steps of (lin, schur, upd, loop) device ms
    each, 3 of host ms in assemble, 1 + 2 in the copies, 4 in apply."""
    call = log.add("gba/call", host_ms=100.0, device_ms=90.0)
    log.add("gba/assemble", call, 3.0, 0.0)
    log.add("gba/upload", call, 1.0, 0.5)
    solve = log.add("ba/solve", call, 80.0, 80.0)
    log.add("ba/setup", solve, 1.0, 1.0)
    for _ in range(steps):
        it = log.add("ba/lm_iter", solve, 20.0, lin + schur + upd,
                     ba__lm_steps=1)
        log.add("ba/linearize", it, 1.0, lin)
        sch = log.add("ba/schur", it, 1.0, schur)
        log.add("ba/pcg_setup", sch, 1.0, schur - loop)
        log.add("ba/pcg_loop", sch, 1.0, loop, ba__cg_iters=60)
        log.add("ba/update", it, 1.0, upd)
    log.add("ba/final", solve, 1.0, 1.0)
    log.add("gba/download", call, 2.0, 0.5)
    apply = log.add("gba/apply", call, 4.0, 0.0)
    log.add("gba/cull", apply, 1.0, 0.0)


@pytest.fixture
def log(monkeypatch):
    from orb_slam3_study_kr_tpu_torch.utils import profiling
    lg = _Log(profiling.StageTimers, profiling.Span)
    monkeypatch.setattr(profiling, "DEFAULT_TIMERS", lg.timers)
    return lg


def _read_all(ctx):
    return {name: _reader(name).read(ctx) for name in READERS}


def test_readers_arithmetic_over_two_solves(log):
    _gba(log, lin=10.0, schur=200.0, upd=20.0, loop=180.0)
    _gba(log, lin=12.0, schur=220.0, upd=22.0, loop=200.0)
    got = _read_all(dict(trace=TRACE))
    assert got["gba_assemble_ms"] == pytest.approx(3.0)
    assert got["gba_transfer_ms"] == pytest.approx(3.0)
    assert got["gba_apply_ms"] == pytest.approx(4.0)
    assert got["lm_linearize_ms"] == pytest.approx((2 * 10 + 2 * 12) / 4)
    assert got["lm_schur_ms"] == pytest.approx((2 * 200 + 2 * 220) / 4)
    assert got["lm_update_ms"] == pytest.approx((2 * 20 + 2 * 22) / 4)
    assert got["pcg_iter_ms"] == pytest.approx((2 * 180 + 2 * 200) / 240)


def test_spans_outside_a_gba_request_are_left_out(log):
    _gba(log, lin=10.0, schur=200.0, upd=20.0, loop=180.0, steps=2)
    # A local BA (a bare ba/solve request) and a request of another name
    # holding gba/ spans: neither counts.
    solve = log.add("ba/solve", None, 500.0, 500.0)
    it = log.add("ba/lm_iter", solve, 50.0, 50.0, ba__lm_steps=1)
    log.add("ba/linearize", it, 1.0, 1000.0)
    log.add("ba/schur", it, 1.0, 1000.0)
    log.add("ba/pcg_loop", it, 1.0, 1000.0, ba__cg_iters=1)
    log.add("ba/update", it, 1.0, 1000.0)
    other = log.add("loop/correct", None, 900.0)
    log.add("gba/assemble", other, 900.0)
    log.add("gba/upload", other, 900.0)
    log.add("gba/download", other, 900.0)
    log.add("gba/apply", other, 900.0)
    got = _read_all(dict(trace=TRACE))
    assert got == pytest.approx(dict(
        gba_assemble_ms=3.0, gba_transfer_ms=3.0, gba_apply_ms=4.0,
        lm_linearize_ms=10.0, lm_schur_ms=200.0, lm_update_ms=20.0,
        pcg_iter_ms=180.0 / 60))


def test_no_trace_or_no_gba_reads_nothing(log):
    _gba(log, lin=10.0, schur=200.0, upd=20.0, loop=180.0, steps=2)
    assert set(_read_all({}).values()) == {None}
    assert set(_read_all(dict(trace=None)).values()) == {None}
    log.timers.spans.clear()
    log.add("ba/solve", None, 5.0, 5.0, ba__lm_steps=1)
    assert set(_read_all(dict(trace=TRACE)).values()) == {None}


def test_host_only_spans_give_no_device_metrics(log):
    """Off the card the spans carry no device time: the device readers
    read nothing, the host readers still read."""
    _gba(log, lin=10.0, schur=200.0, upd=20.0, loop=180.0, steps=3)
    for s in log.timers.spans:
        s.device_ms = None
    got = _read_all(dict(trace=TRACE))
    assert got["gba_assemble_ms"] == pytest.approx(3.0)
    assert got["gba_transfer_ms"] == pytest.approx(3.0)
    assert got["gba_apply_ms"] == pytest.approx(4.0)
    for name in ("lm_linearize_ms", "lm_schur_ms", "lm_update_ms",
                 "pcg_iter_ms"):
        assert got[name] is None


def test_a_port_without_the_span_log_reads_nothing(monkeypatch):
    from orb_slam3_study_kr_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "DEFAULT_TIMERS")
    assert set(_read_all(dict(trace=TRACE)).values()) == {None}
