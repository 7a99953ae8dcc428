"""The port's lock sanitizer (``utils/locksan.py``) against the reference's
cases, and every port ``LOCK_ORDER`` table against its reference
counterpart's.

Disarmed, ``named_lock`` is a plain ``threading.Lock``.  Armed
(``CST_LOCK_SANITIZER=1`` when the lock is created): a declared order
passes and records its edges; an inverted edge and an undeclared edge
each write the receipt (``CST_LOCK_SANITIZER_RECEIPT``) and raise before
blocking, as the reference's do on the same nestings.
"""

import json
import threading

import pytest

from cst_captioning_tpu.utils import locksan as ref_locksan
from cst_captioning_tpu_torch.utils import locksan
from cst_captioning_tpu_torch.utils.locksan import (LockOrderViolation,
                                                    declare_order,
                                                    named_lock)


@pytest.fixture(autouse=True)
def _armed(monkeypatch, tmp_path):
    receipt = tmp_path / "locksan_violation.json"
    monkeypatch.setenv(locksan.ENV_FLAG, "1")
    monkeypatch.setenv(locksan.ENV_RECEIPT, str(receipt))
    locksan.reset_observed()
    ref_locksan.reset_observed()
    yield receipt
    locksan.reset_observed()
    ref_locksan.reset_observed()


def test_names_and_schema_are_the_references():
    for name in ("ENV_FLAG", "ENV_RECEIPT", "DEFAULT_RECEIPT",
                 "LOCKSAN_SCHEMA"):
        assert getattr(locksan, name) == getattr(ref_locksan, name), name


def test_disarmed_factory_returns_a_plain_lock(monkeypatch):
    monkeypatch.delenv(locksan.ENV_FLAG, raising=False)
    assert isinstance(named_lock("pls.plain"), type(threading.Lock()))
    monkeypatch.setenv(locksan.ENV_FLAG, "0")
    assert not locksan.enabled()


def test_armed_factory_returns_a_sanitized_lock():
    lk = named_lock("pls.sanitized")
    assert lk.__class__.__name__ == "_SanitizedLock"
    assert "pls.sanitized" in repr(lk)
    with lk:
        assert lk.locked()
    assert not lk.locked()
    assert lk.acquire(blocking=False)
    lk.release()


def test_declared_order_passes_and_records_edges():
    declare_order("pls.ok.a", "pls.ok.b", "pls.ok.c")
    a, b, c = (named_lock(f"pls.ok.{x}") for x in "abc")
    with a:
        with c:           # transitively covered: a before c
            pass
        with b:
            with c:
                pass
    assert locksan.violations() == []


def _violation(mod, receipt, tables, outer, inner):
    """Nest ``outer`` -> ``inner`` under ``mod``'s sanitizer with
    ``tables`` declared -> (the exception text, the receipt)."""
    for t in tables:
        mod.declare_order(*t)
    a, b = mod.named_lock(outer), mod.named_lock(inner)
    with pytest.raises(mod.LockOrderViolation) as e:
        with a:
            with b:
                pass
    doc = json.loads(receipt.read_text())
    receipt.unlink()
    return str(e.value), doc


@pytest.mark.parametrize("case", ["inverted", "undeclared"])
def test_violations_write_the_references_receipt(_armed, case):
    """The same nesting under both sanitizers: the same message and the
    same receipt (kind, edge, holder's stack, the declared table)."""
    out = []
    for mod, prefix in ((ref_locksan, "rls"), (locksan, "pls")):
        tables = ([(f"{prefix}.{case}.b", f"{prefix}.{case}.a")]
                  if case == "inverted" else [])
        msg, doc = _violation(mod, _armed, tables, f"{prefix}.{case}.a",
                              f"{prefix}.{case}.b")
        out.append((msg.replace(prefix, "X"), doc))
        assert mod.violations()[-1]["kind"] == doc["kind"]
    (ref_msg, ref_doc), (msg, doc) = out
    # The same message, less the reference's pointer to its lint rule.
    assert msg.split(" table")[0] == ref_msg.split(" table")[0]
    assert doc["kind"] == ref_doc["kind"] == (
        "inverted-order" if case == "inverted" else "undeclared-edge")
    assert doc["schema"] == ref_doc["schema"] == locksan.LOCKSAN_SCHEMA
    assert doc["edge"] == [f"pls.{case}.a", f"pls.{case}.b"]
    assert f"pls.{case}.a" in doc["held_stack"]
    assert set(doc) == set(ref_doc)
    if case == "inverted":
        assert [f"pls.{case}.b", f"pls.{case}.a"] in doc["declared_tables"]


def test_contradictory_tables_fail_both_ways_across_threads():
    declare_order("pls.cyc.x", "pls.cyc.y")
    declare_order("pls.cyc.y", "pls.cyc.x")
    x, y = named_lock("pls.cyc.x"), named_lock("pls.cyc.y")
    caught = []

    def nest_xy():
        try:
            with x:
                with y:
                    pass
        except LockOrderViolation as e:
            caught.append(e)

    t = threading.Thread(target=nest_xy, name="locksan-xy", daemon=True)
    t.start()
    t.join(timeout=10.0)
    assert not t.is_alive() and len(caught) == 1
    with pytest.raises(LockOrderViolation):
        with y:
            with x:
                pass
    # Neither lock is left held by the refused acquisitions' threads.
    assert not x.locked() and not y.locked()


def test_release_out_of_lifo_order_is_legal():
    declare_order("pls.fifo.a", "pls.fifo.b")
    a, b = named_lock("pls.fifo.a"), named_lock("pls.fifo.b")
    a.acquire()
    b.acquire()
    a.release()
    b.release()
    assert locksan.violations() == []


def test_path_exists_equals_the_references():
    edges = {("a", "b"), ("b", "c"), ("d", "e")}
    for src, dst in (("a", "c"), ("c", "a"), ("a", "e"), ("d", "e"),
                     ("x", "x")):
        assert locksan.path_exists(edges, src, dst) == \
            ref_locksan.path_exists(edges, src, dst)


def test_lock_order_tables_equal_the_references():
    from cst_captioning_tpu.data import loader as ref_loader
    from cst_captioning_tpu.serving import fleet as ref_fleet
    from cst_captioning_tpu.serving import server as ref_server
    from cst_captioning_tpu.telemetry import lifecycle as ref_lifecycle
    from cst_captioning_tpu_torch.data import loader
    from cst_captioning_tpu_torch.serving import fleet, server
    from cst_captioning_tpu_torch.telemetry import lifecycle

    for ours, ref in ((server, ref_server), (loader, ref_loader),
                      (fleet, ref_fleet), (lifecycle, ref_lifecycle)):
        assert ours.LOCK_ORDER == ref.LOCK_ORDER, ours.__name__
        assert tuple(ours.LOCK_ORDER) in locksan._declared_tables


def test_port_locks_carry_the_references_names():
    """Every port lock made by ``named_lock``, under the reference's name
    where the reference has the lock."""
    from cst_captioning_tpu_torch.serving.cache import ResultCache
    from cst_captioning_tpu_torch.telemetry.registry import MetricsRegistry
    from cst_captioning_tpu_torch.telemetry.spans import SpanTracer
    from cst_captioning_tpu_torch.telemetry.lifecycle import LifecycleTracer

    assert MetricsRegistry()._lock.name == "telemetry.registry"
    assert ResultCache(2)._lock.name == "serving.result_cache"
    assert LifecycleTracer()._lock.name == "telemetry.lifecycle"
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        assert SpanTracer(d)._lock.name == "telemetry.spans"
    # Module-level locks are made at import time, disarmed: a plain Lock
    # unless the process started armed; the names are in the source.
    import inspect

    from cst_captioning_tpu_torch import native
    from cst_captioning_tpu_torch.data import loader
    from cst_captioning_tpu_torch.ops import _cuda
    from cst_captioning_tpu_torch.serving import server

    assert 'named_lock("native.build")' in inspect.getsource(native)
    assert 'named_lock("ops.cuda.build")' in inspect.getsource(_cuda)
    src = inspect.getsource(loader)
    assert 'named_lock("data.loader.plan")' in src
    assert 'named_lock("data.loader.queue")' in src
    src = inspect.getsource(server)
    assert 'named_lock("serving.server.write")' in src
    assert 'named_lock("serving.server.conn")' in src


def test_server_nesting_passes_armed(tmp_path):
    """The server's write lock held into a connection lock, as
    ``run_socket`` nests them, passes the declared order."""
    from cst_captioning_tpu_torch.serving import server  # noqa: F401

    write, conn = (named_lock("serving.server.write"),
                   named_lock("serving.server.conn"))
    with write:
        with conn:
            pass
    reg, health = (named_lock("telemetry.registry"),
                   named_lock("serving.fleet.health"))
    from cst_captioning_tpu_torch.serving import fleet  # noqa: F401
    with health:
        with reg:
            pass
    assert locksan.violations() == []
    with pytest.raises(LockOrderViolation, match="inverts"):
        with reg:
            with health:
                pass
